"""DART, random forest and refit in the port against the JAX package,
on the CPU.

- DART (``boosting/dart.py``): the drop sets of every iteration equal
  the reference's for the same ``drop_seed`` (level a: the same
  ``np.random.RandomState`` draws in the same order), in the normal and
  ``xgboost_dart_mode`` normalizations, with ``uniform_drop``,
  ``max_drop`` and ``skip_drop``; the trees make the reference's splits
  with its leaf counts, and predictions agree within rtol 1e-5 (level
  b: leaf values within a few f32 ulps, scaled by the drop weights and
  summed).
- RF (``boosting/rf.py``): binary and multiclass trees at level (b),
  predictions within rtol 1e-5; ``average_output`` in the model text, and the
  loaded model and the stacked forest equal the host walk byte for
  byte.
- Refit (``Booster.refit``, ``boosting/refit.py``, ``ops/refit.py``):
  the leaf values equal the reference's device refit within 1e-6
  absolute (f32 per-leaf sums on both sides; the reference's jitted
  step may fuse the decay mix), binary and multiclass, with weights and
  a decay rate.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as ref_lgb

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.boosting import DART, GBDT, RF, create_boosting
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)


def _data(seed=0, n=2000, K=1):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 10)
    X[rng.rand(n) < 0.1, 2] = np.nan
    # noisy labels: with noise-free ones a pure leaf's best split has a
    # gain of f32 rounding residue (~1e-5), a tie by construction
    noise = 0.3 * rng.randn(n)
    if K > 1:
        return X, np.digitize(X[:, 0] + 0.5 * X[:, 1] + noise,
                              [-0.5, 0.5]).astype(float)
    return X, (X[:, 0] + X[:, 1] + noise > 0).astype(float)


def _splits(tree):
    ni = tree.num_internal
    return (tree.num_leaves, tree.split_feature[:ni].tolist(),
            tree.threshold[:ni].tolist(),
            tree.leaf_count[:tree.num_leaves].tolist())


def _boosters(params, X, y, rounds):
    """Reference and port boosters stepped together; the drop set of
    each iteration (DART) recorded on both."""
    ref = ref_lgb.Booster(params, ref_lgb.Dataset(X, label=y))
    port = lgb.Booster(dict(params, device_type="cpu"),
                       lgb.Dataset(X, label=y))
    drops = []
    for _ in range(rounds):
        ref.update()
        port.update()
        drops.append((list(getattr(ref.inner, "drop_index", [])),
                      list(getattr(port.inner, "drop_index", []))))
    return ref, port, drops


def _same_trees(ref, port, X):
    assert len(ref.inner.models) == len(port.inner.models)
    for i, (a, b) in enumerate(zip(ref.inner.models, port.inner.models)):
        assert _splits(a) == _splits(b), "tree %d differs" % i
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-5,
                               atol=1e-6)


DART_CASES = {
    "default": {},
    "xgboost_mode": {"xgboost_dart_mode": True},
    "uniform_drop": {"uniform_drop": True, "drop_rate": 0.3},
    "max_drop": {"drop_rate": 0.6, "max_drop": 2, "skip_drop": 0.0},
    "skip_drop": {"skip_drop": 0.7, "drop_rate": 0.4, "drop_seed": 11},
    "multiclass": {"objective": "multiclass", "num_class": 3,
                   "skip_drop": 0.0},
}


@pytest.mark.parametrize("case", sorted(DART_CASES))
def test_dart_matches_reference(case):
    params = dict({"objective": "binary", "boosting": "dart",
                   "num_leaves": 15, "verbose": -1, "drop_rate": 0.5},
                  **DART_CASES[case])
    X, y = _data(K=params.get("num_class", 1))
    ref, port, drops = _boosters(params, X, y, rounds=10)
    assert isinstance(port.inner, DART)
    for it, (a, b) in enumerate(drops):
        assert a == b, "drop set of iteration %d" % it
    assert any(a for a, _ in drops), "the case must drop some trees"
    assert port.inner.tree_weight == pytest.approx(ref.inner.tree_weight,
                                                   rel=0, abs=0)
    _same_trees(ref, port, X)


@pytest.mark.parametrize("K", [1, 3])
def test_rf_matches_reference(K):
    params = {"objective": "binary" if K == 1 else "multiclass",
              "boosting": "rf", "num_leaves": 15, "verbose": -1,
              "bagging_fraction": 0.632, "bagging_freq": 1,
              "feature_fraction": 0.9}
    if K > 1:
        params["num_class"] = K
    X, y = _data(K=K)
    ref, port, _ = _boosters(params, X, y, rounds=6)
    assert isinstance(port.inner, RF) and port.inner.average_output
    _same_trees(ref, port, X)
    text = port.model_to_string()
    assert "\naverage_output\n" in text
    assert text.split("feature_names")[0] == \
        ref.model_to_string().split("feature_names")[0]
    host = port.predict(X, predict_on_device=False)
    np.testing.assert_array_equal(port.predict(X, predict_on_device=True),
                                  host)
    np.testing.assert_array_equal(
        port.predict(X, raw_score=True, predict_on_device=True),
        port.predict(X, raw_score=True, predict_on_device=False))
    again = lgb.Booster(model_str=text, params={"device_type": "cpu"})
    assert again.inner.average_output
    np.testing.assert_array_equal(again.predict(X), host)
    assert port.dump_model()["average_output"] is True


def test_dart_model_round_trips():
    X, y = _data()
    bst = lgb.train({"objective": "binary", "boosting": "dart",
                     "num_leaves": 15, "verbose": -1, "device_type": "cpu",
                     "drop_rate": 0.5, "skip_drop": 0.0},
                    lgb.Dataset(X, label=y), num_boost_round=6)
    again = lgb.Booster(model_str=bst.model_to_string(),
                        params={"device_type": "cpu"})
    np.testing.assert_array_equal(again.predict(X), bst.predict(X))
    np.testing.assert_array_equal(bst.predict(X, predict_on_device=True),
                                  bst.predict(X, predict_on_device=False))


@pytest.mark.parametrize("case", ["binary", "weighted_decay",
                                  "multiclass"])
def test_refit_matches_reference(case):
    K = 3 if case == "multiclass" else 1
    params = {"objective": "binary" if K == 1 else "multiclass",
              "num_leaves": 15, "verbose": -1, "lambda_l1": 0.1}
    if K > 1:
        params["num_class"] = K
    X, y = _data(K=K)
    X2, y2 = _data(seed=3, n=1500, K=K)
    y2 = y2[::-1].copy() if K == 1 else y2
    kw = {}
    if case == "weighted_decay":
        kw = {"weight": np.random.RandomState(4).rand(1500) + 0.5,
              "decay_rate": 0.5}
    ref = ref_lgb.train(params, ref_lgb.Dataset(X, label=y),
                        num_boost_round=5)
    port = lgb.train(dict(params, device_type="cpu"),
                     lgb.Dataset(X, label=y), num_boost_round=5)
    before = [t.leaf_value[:t.num_leaves].copy() for t in port.inner.models]
    assert port.refit(X2, y2, **kw) is port
    ref.refit(X2, y2, **kw)
    moved = False
    for a, b, old in zip(ref.inner.models, port.inner.models, before):
        np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                   a.leaf_value[:a.num_leaves], rtol=0,
                                   atol=1e-6)
        moved |= not np.array_equal(b.leaf_value[:b.num_leaves], old)
    assert moved
    # the stacked predict cache re-keys on the new leaf values
    np.testing.assert_array_equal(port.predict(X2, predict_on_device=True),
                                  port.predict(X2, predict_on_device=False))


def test_create_boosting_and_rf_needs_sampling():
    X, y = _data()
    ds = lgb.Dataset(X, label=y).construct().handle
    for name, cls in (("gbdt", GBDT), ("gbrt", GBDT), ("dart", DART),
                      ("random_forest", RF)):
        cfg = Config.from_params({"boosting": name, "verbose": -1,
                                  "bagging_fraction": 0.5,
                                  "bagging_freq": 1})
        assert type(create_boosting(cfg, ds, torch.device("cpu"))) is cls
    with pytest.raises(LightGBMError, match="Random forest needs"):
        lgb.train({"boosting": "rf", "objective": "binary", "verbose": -1,
                   "device_type": "cpu"}, lgb.Dataset(X, label=y),
                  num_boost_round=1)
    with pytest.raises(LightGBMError, match="external gradients"):
        bst = lgb.Booster({"boosting": "rf", "objective": "binary",
                           "verbose": -1, "device_type": "cpu",
                           "bagging_fraction": 0.5, "bagging_freq": 1},
                          lgb.Dataset(X, label=y))
        bst.update(fobj=lambda p, d: (p - y, np.ones_like(p)))
