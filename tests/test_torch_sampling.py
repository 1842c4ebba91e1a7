"""Row and column sampling of the port against the JAX package's, on the
CPU: GOSS, ``feature_fraction`` and ``extra_trees``.

- The GOSS draw (scaled gradient, scaled hessian, bag) equals the
  reference's ``GOSSStrategy`` byte for byte (level a) at [N] and
  [N, 3], with rows tied at the threshold; the warm-up, the live
  learning rate of ``refresh_config``, the bagging fatal and
  ``boosting=goss`` behave as the reference's.
- Each tree's feature mask over 6 trees (binary, and multiclass with 3
  trees per iteration) equals the reference learner's
  ``_sample_features`` (level a): one host RNG, one draw per tree.
- ``make_rand_bins`` equals the reference's for several keys and node
  ids at a padded feature count with categorical features (level a).
- Trees of every setting make the reference's splits, thresholds and
  leaf counts, leaf values within 1e-4 (level b); with extra_trees the
  same random threshold wins.
- With feature_fraction + extra_trees + GOSS the whole-tree loop gives
  the per-split loop's trees, text for text.
- The config fields of these settings, their aliases included, parse
  to the reference's values field by field.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as ref_lgb
import lightgbm_tpu_torch as lgb
from lightgbm_tpu.boosting import sample_strategy as RSS
from lightgbm_tpu.config import Config as RefConfig
from lightgbm_tpu.ops import split as RS
from lightgbm_tpu.treelearner import serial as ref_serial
from lightgbm_tpu_torch.boosting import sample_strategy as SS
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops import split as S
from lightgbm_tpu_torch.treelearner import serial
from lightgbm_tpu_torch.utils import prng
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 15, "verbose": -1}


def _data(n=2000, seed=0, F=10):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    y = (X[:, 0] + X[:, 1] + 0.5 * X[:, 2] * X[:, 3] > 0).astype(float)
    return X, y


def _splits(tree):
    ni = tree.num_internal
    return (tree.num_leaves, tree.split_feature[:ni].tolist(),
            tree.threshold[:ni].tolist(),
            tree.leaf_count[:tree.num_leaves].tolist())


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


# ----------------------------------------------------------------------
# GOSS
# ----------------------------------------------------------------------
def _goss_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    g = rng.randn(*shape).astype(np.float32)
    h = (rng.rand(*shape) + 0.1).astype(np.float32)
    # 60 rows share one weight: ties at the threshold take every equal row
    g[:60] = 1.5
    h[:60] = 0.5
    return g, h


@pytest.mark.parametrize("shape", [(2000,), (2000, 3)], ids=["N", "Nx3"])
@pytest.mark.parametrize("rates", [(0.2, 0.1), (0.03, 0.5)])
def test_goss_draw_byte_equal(shape, rates):
    g, h = _goss_inputs(shape, seed=len(shape))
    params = {"data_sample_strategy": "goss", "learning_rate": 0.5,
              "top_rate": rates[0], "other_rate": rates[1],
              "bagging_seed": 11, "verbose": -1}
    ref = RSS.GOSSStrategy(RefConfig.from_params(params), shape[0], 1)
    port = SS.GOSSStrategy(Config.from_params(params), shape[0],
                           torch.device("cpu"))
    assert (port.top_k, port.other_k, port.warmup) == \
        (ref.top_k, ref.other_k, ref.warmup)
    w = np.abs(g * h).reshape(shape[0], -1).sum(axis=1)
    for it in (2, 3, 7):
        want = ref.bagging(it, jnp.asarray(g), jnp.asarray(h))
        got = port.bagging(it, torch.from_numpy(g), torch.from_numpy(h))
        for a, b in zip(want, got):
            assert np.array_equal(_bits(a), _bits(b.numpy()))
        bag = got[2].numpy()
        assert bag.sum() >= port.top_k
        if rates == (0.2, 0.1):
            # the tied block sits at or above the threshold: all in bag
            assert bag[:60].all() == (np.sort(w)[-port.top_k] <= w[0])


def test_goss_warmup_and_refresh():
    params = {"boosting": "goss", "learning_rate": 0.25, "verbose": -1}
    port = SS.create_sample_strategy(Config.from_params(params), 500,
                                     torch.device("cpu"))
    ref = RSS.create_sample_strategy(RefConfig.from_params(params), 500, 1)
    assert isinstance(port, SS.GOSSStrategy)
    assert isinstance(ref, RSS.GOSSStrategy)
    g, h = _goss_inputs((500,), seed=5)
    tg, th = torch.from_numpy(g), torch.from_numpy(h)
    assert port.warmup == ref.warmup == 4
    for it in range(4):
        assert port.bagging(it, tg, th)[2] is None
        assert ref.bagging(it, jnp.asarray(g), jnp.asarray(h))[2] is None
    assert port.bagging(4, tg, th)[2] is not None
    # the warm-up reads the live learning rate
    cfg = Config.from_params(dict(params, learning_rate=0.1))
    port.refresh_config(cfg)
    ref.refresh_config(RefConfig.from_params(dict(params,
                                                  learning_rate=0.1)))
    assert port.warmup == ref.warmup == 10
    assert port.bagging(9, tg, th)[2] is None
    # the rates keep their first values, as in the reference
    port.refresh_config(Config.from_params(dict(params, top_rate=0.4)))
    ref.refresh_config(RefConfig.from_params(dict(params, top_rate=0.4)))
    assert (port.top_k, port.other_k) == (ref.top_k, ref.other_k) \
        == (100, 50)
    assert port.bagging(10, tg, th)[2].sum() >= 100


@pytest.mark.parametrize("params,match", [
    ({"bagging_fraction": 0.5, "bagging_freq": 1}, "bagging in GOSS"),
    ({"top_rate": 0.0}, "positive"),
    ({"other_rate": -0.1}, "positive"),
    ({"top_rate": 0.7, "other_rate": 0.5}, "top_rate"),
])
def test_goss_fatal_settings(params, match):
    X, y = _data(n=300)
    with pytest.raises(LightGBMError, match=match):
        lgb.train(dict(BASE, device_type="cpu", boosting="goss", **params),
                  lgb.Dataset(X, label=y), num_boost_round=1)


def test_goss_is_picked_by_either_spelling():
    for params in ({"boosting": "goss"}, {"data_sample_strategy": "goss"}):
        cfg = Config.from_params(params)
        assert (cfg.boosting, cfg.data_sample_strategy) == ("gbdt", "goss")
        assert isinstance(SS.create_sample_strategy(cfg, 100,
                                                    torch.device("cpu")),
                          SS.GOSSStrategy)


# ----------------------------------------------------------------------
# per-tree feature masks
# ----------------------------------------------------------------------
def _record_masks(learner_cls, monkeypatch):
    seen = []
    orig = learner_cls._sample_features

    def record(self):
        mask = orig(self)
        seen.append(np.asarray(mask).copy())
        return mask
    monkeypatch.setattr(learner_cls, "_sample_features", record)
    return seen


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_tree_masks_byte_equal(objective, monkeypatch):
    X, y = _data(n=600, F=13)
    rounds = 6
    params = dict(BASE, objective=objective, feature_fraction=0.6,
                  feature_fraction_seed=9, num_leaves=4)
    if objective == "multiclass":
        y = np.digitize(X[:, 0] + X[:, 1], [-0.5, 0.5]).astype(float)
        params["num_class"] = 3
        rounds = 2
    want = _record_masks(ref_serial.SerialTreeLearner, monkeypatch)
    ref_lgb.train(params, ref_lgb.Dataset(X, label=y),
                  num_boost_round=rounds)
    got = _record_masks(serial.SerialTreeLearner, monkeypatch)
    bst = lgb.train(dict(params, device_type="cpu"),
                    lgb.Dataset(X, label=y), num_boost_round=rounds)
    assert len(want) == len(got) == 6
    assert all(np.array_equal(a, b) for a, b in zip(want, got))
    assert all(m.sum() == round(13 * 0.6) for m in got)
    # the learner's mask tensor holds the last tree's
    assert np.array_equal(bst.inner.learner.feature_mask.numpy(), got[-1])
    for t, m in zip(bst.inner.models, got):
        inner = t.split_feature_inner[:t.num_internal]
        assert m[inner].all()


# ----------------------------------------------------------------------
# extra_trees thresholds
# ----------------------------------------------------------------------
def _cat_data(n=1500, seed=3):
    X, y = _data(n, seed, F=9)
    rng = np.random.RandomState(seed)
    X[:, 7] = rng.randint(0, 30, n)          # sorted-subset mode
    X[:, 8] = rng.randint(0, 3, n)           # one-hot mode
    return X, y


@pytest.fixture(scope="module")
def metas():
    X, y = _cat_data()
    params = {"max_cat_threshold": 6, "verbose": -1,
              "categorical_feature": "7,8"}
    rd = ref_lgb.Dataset(X, label=y, params=params).construct().handle
    pd = lgb.Dataset(X, label=y, params=params).construct().handle
    F, Fp = rd.num_features, -(-rd.num_features // 8) * 8
    assert Fp > F
    ref_meta = RS.pad_feature_meta(RS.FeatureMeta.from_dataset(rd, 4),
                                   Fp - F)
    port_meta = S.pad_feature_meta(
        S.FeatureMeta.from_dataset(pd, torch.device("cpu"), 4), Fp - F)
    ref_params = RS.SplitParams.from_config(RefConfig.from_params(params))
    port_params = S.SplitParams.from_config(Config.from_params(params),
                                            torch.device("cpu"))
    assert port_meta.is_categorical[7:9].all()
    return ref_meta, ref_params, port_meta, port_params


@pytest.mark.parametrize("seed", [6, 7925, 2 ** 31 - 1])
def test_make_rand_bins_byte_equal(metas, seed):
    import jax
    ref_meta, ref_params, port_meta, port_params = metas
    node_ids = [0, 1, 2, 29, 30]
    base = prng.PRNGKey(seed)
    # one node at a time, and the nodes batched in one call
    batched = S.make_rand_bins(
        prng.fold_in(base, torch.tensor(node_ids)),
        port_meta, port_params)
    for i, node in enumerate(node_ids):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), node)
        want = RS.make_rand_bins(key, ref_meta, ref_params)
        got = S.make_rand_bins(prng.fold_in(base, node), port_meta,
                               port_params)
        for a, b, c in zip(want, got, batched):
            assert np.array_equal(np.asarray(a), b.numpy())
            assert np.array_equal(np.asarray(a), c[i].numpy())


# ----------------------------------------------------------------------
# trees against the reference
# ----------------------------------------------------------------------
TREE_CASES = {
    "feature_fraction": {"feature_fraction": 0.5},
    "extra_trees": {"extra_trees": True, "extra_seed": 12},
    "ff_extra_trees": {"feature_fraction": 0.7, "extra_trees": True},
    "goss": {"boosting": "goss", "learning_rate": 0.5},
    "goss_quantized8": {"data_sample_strategy": "goss",
                        "learning_rate": 0.5, "use_quantized_grad": True},
    "extra_trees_categorical": {"extra_trees": True, "data": "categorical",
                                "max_cat_threshold": 6},
    "ff_multiclass": {"feature_fraction": 0.6, "objective": "multiclass",
                      "num_class": 3},
}


def _train_both(extra, rounds=3):
    params = dict(BASE, **extra)
    data = params.pop("data", None)
    X, y = _cat_data() if data else _data()
    if params["objective"] == "multiclass":
        y = np.digitize(X[:, 0] + X[:, 1], [-0.5, 0.5]).astype(float)
        rounds = 2
    if data:
        params["categorical_feature"] = "7,8"
    ref = ref_lgb.train(params, ref_lgb.Dataset(X, label=y),
                        num_boost_round=rounds)
    port = lgb.train(dict(params, device_type="cpu"),
                     lgb.Dataset(X, label=y), num_boost_round=rounds)
    return ref, port


@pytest.mark.parametrize("case", sorted(TREE_CASES))
def test_trees_match_reference(case):
    ref, port = _train_both(TREE_CASES[case])
    assert len(ref.inner.models) == len(port.inner.models)
    for i, (a, b) in enumerate(zip(ref.inner.models, port.inner.models)):
        assert _splits(a) == _splits(b), "tree %d differs" % i
        np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                   a.leaf_value[:a.num_leaves],
                                   rtol=1e-4, atol=1e-6)
    if "categorical" in case:
        assert any(t.num_cat > 0 for t in port.inner.models)


def test_extra_trees_changes_the_trees():
    """The random thresholds are not the greedy ones."""
    X, y = _data()
    runs = [lgb.train(dict(BASE, device_type="cpu", extra_trees=e),
                      lgb.Dataset(X, label=y), num_boost_round=1)
            for e in (False, True)]
    assert _splits(runs[0].inner.models[0]) != \
        _splits(runs[1].inner.models[0])


def test_whole_tree_equals_per_split_with_sampling():
    X, y = _data()
    params = dict(BASE, device_type="cpu", feature_fraction=0.7,
                  extra_trees=True, boosting="goss", learning_rate=0.5)
    runs = [lgb.train(dict(params, tpu_fused_tree=fused),
                      lgb.Dataset(X, label=y), num_boost_round=4)
            for fused in (True, False)]
    assert runs[0].inner.learner.grow_stats["record_reads"] == 4
    assert runs[1].inner.learner.grow_stats["record_reads"] == 0
    assert [t.to_string() for t in runs[0].inner.models] == \
        [t.to_string() for t in runs[1].inner.models]
    assert torch.equal(runs[0].inner.train_score.view(torch.int32),
                       runs[1].inner.train_score.view(torch.int32))


def test_reset_parameter_reaches_the_sampling():
    """feature_fraction set between iterations takes effect at the next
    tree; extra_trees, top_rate and other_rate keep their first values,
    as in the reference: after one GOSS round and a reset, both
    packages grow the same two trees (level b; the last one a GOSS
    tree)."""
    X, y = _data()
    params = dict(BASE, boosting="goss", learning_rate=0.5)
    ref = ref_lgb.train(params, ref_lgb.Dataset(X, label=y),
                        num_boost_round=1)
    port = lgb.train(dict(params, device_type="cpu"),
                     lgb.Dataset(X, label=y), num_boost_round=1)
    for b in (ref, port):
        b.reset_parameter({"feature_fraction": 0.2, "extra_trees": True,
                           "top_rate": 0.3})
        b.update()
        b.update()
    learner = port.inner.learner
    assert not learner._extra_trees and learner._graph is None
    goss = port.inner.sample_strategy
    assert (goss.top_k, goss.other_k, goss.warmup) == \
        (ref.inner.sample_strategy.top_k, ref.inner.sample_strategy.other_k,
         2)
    mask = learner.feature_mask.numpy()
    assert mask.sum() == 2
    last = port.inner.models[-1]
    assert mask[last.split_feature_inner[:last.num_internal]].all()
    assert len(ref.inner.models) == len(port.inner.models) == 3
    for i, (a, b) in enumerate(zip(ref.inner.models, port.inner.models)):
        assert _splits(a) == _splits(b), "tree %d differs" % i
        np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                   a.leaf_value[:a.num_leaves],
                                   rtol=1e-4, atol=1e-6)


# ----------------------------------------------------------------------
# config fields against the reference
# ----------------------------------------------------------------------
CONFIG_CASES = [
    {"feature_fraction": 0.5},
    {"colsample_bytree": 0.3},
    {"sub_feature": 0.4, "feature_fraction_seed": 21},
    {"feature_fraction_bynode": 0.5},
    {"sub_feature_bynode": 0.25},
    {"colsample_bynode": 0.75},
    {"extra_trees": True, "extra_seed": 17},
    {"extra_tree": "true"},
    {"top_rate": 0.3, "other_rate": 0.2},
    {"bagging_seed": 99},
    {"bagging_fraction_seed": 5},
    {"data_sample_strategy": "goss"},
    {"boosting": "goss"},
    {"boosting_type": "goss", "learning_rate": 0.3},
    {"interaction_constraints": [[0, 1], [2, 3]]},
    {"cegb_tradeoff": 0.5, "cegb_penalty_split": 0.1},
    {"cegb_penalty_feature_coupled": [1.0, 2.0],
     "cegb_penalty_feature_lazy": "0.5,0.25"},
    {"monotone_constraints": [1, -1, 0]},
    {"mc": "1,0,-1"},
    {"monotone_constraint": [0, 1]},
    {"monotonic_cst": "-1,1"},
    {"monotone_constraints_method": "intermediate"},
    {"monotone_constraining_method": "advanced"},
    {"monotone_constraints_method": "precise"},
    {"monotone_penalty": 2.0},
    {"ms_penalty": 1.5},
    {"monotone_splits_penalty": 0.5},
    {"forcedsplits_filename": "forced.json"},
    {"fs": "splits.json"},
    {"forced_splits": "a.json"},
    {"linear_tree": True, "linear_lambda": 0.1},
    {"linear_trees": "true"},
]


@pytest.mark.parametrize("params", CONFIG_CASES,
                         ids=lambda p: ",".join(sorted(p)))
def test_config_fields_match_reference(params):
    ref = RefConfig.from_params(dict(params))
    port = Config.from_params(dict(params))
    ref_fields = {f.name for f in dataclasses.fields(ref)}
    for f in dataclasses.fields(port):
        if f.name in ("raw_params", "device_type") or \
                f.name not in ref_fields:
            continue
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
