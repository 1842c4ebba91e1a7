"""The port's training slice against the JAX package's, on the CPU.

- The verify-skill flow (2000 x 10, binary, 15 leaves, 20 rounds): every
  tree makes the same splits with the same leaf counts (level b) and the
  AUC agrees within 1e-6 (level c).
- An l2 run with boost_from_average=false and labels on a power-of-two
  grid has exact f32 sums in any order: the first tree's text is
  byte-equal (level a) except ``split_gain``, held at level (b) — the
  reference's XLA CPU build rounds part of the gain arithmetic through
  fused multiply-adds (ROADMAP queue 3).
- Models carried across (``convert.trees_from_numpy``, or the reference's
  model text) predict exactly what the reference's host walk predicts.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as ref_lgb
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.convert import trees_from_numpy
from lightgbm_tpu_torch.metric import weighted_auc

torch.set_num_threads(1)


def _verify_data(seed=0, n=2000, nan=False):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 10)
    y = (X[:, 0] + X[:, 1] > 0).astype(float)
    if nan:
        X[rng.rand(n) < 0.1, 0] = np.nan
        X[rng.rand(n) < 0.1, 3] = np.nan
    return X, y


def _splits(tree):
    ni = tree.num_internal
    return (tree.num_leaves, tree.split_feature[:ni].tolist(),
            tree.threshold[:ni].tolist(),
            tree.leaf_count[:tree.num_leaves].tolist())


CASES = {
    "verify": ({"num_leaves": 15}, False),
    "nan_depth_l1l2": ({"num_leaves": 15, "max_depth": 4, "lambda_l1": 0.5,
                        "lambda_l2": 1.0, "min_data_in_leaf": 30}, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_binary_flow_matches_reference(case):
    extra, nan = CASES[case]
    X, y = _verify_data(nan=nan)
    Xv, yv = _verify_data(seed=1, n=1000, nan=nan)
    params = dict(extra, objective="binary", metric="auc", verbose=-1)
    ref_hist, port_hist = {}, {}
    rd = ref_lgb.Dataset(X, label=y)
    ref = ref_lgb.train(params, rd, num_boost_round=20,
                        valid_sets=[ref_lgb.Dataset(Xv, label=yv,
                                                    reference=rd)],
                        callbacks=[ref_lgb.record_evaluation(ref_hist)])
    pd = lgb.Dataset(X, label=y)
    port = lgb.train(dict(params, device_type="cpu"), pd,
                     num_boost_round=20,
                     valid_sets=[lgb.Dataset(Xv, label=yv, reference=pd)],
                     callbacks=[lgb.record_evaluation(port_hist)])
    assert len(port.inner.models) == len(ref.inner.models) == 20
    for i, (a, b) in enumerate(zip(ref.inner.models, port.inner.models)):
        assert _splits(a) == _splits(b), "tree %d differs" % i
        np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                   a.leaf_value[:a.num_leaves],
                                   rtol=1e-4, atol=1e-6)
    ref_pred, port_pred = ref.predict(X), port.predict(X)
    assert abs(weighted_auc(y, port_pred, None)
               - weighted_auc(y, ref_pred, None)) <= 1e-6
    # per-round held-out AUC: the first round scores with 15 distinct
    # values, and two leaf values within f32 rounding of each other can
    # swap order, so each round is held to 1e-4
    np.testing.assert_allclose(port_hist["valid_0"]["auc"],
                               ref_hist["valid_0"]["auc"], rtol=0,
                               atol=1e-4)


def test_l2_first_tree_text_byte_equal():
    rng = np.random.RandomState(3)
    X = rng.randn(3000, 6)
    y = np.round((X[:, 0] * 2 + X[:, 1] + rng.randn(3000) * 0.3) * 4) / 4
    params = {"objective": "regression", "num_leaves": 31,
              "boost_from_average": False, "verbose": -1}
    ref = ref_lgb.train(params, ref_lgb.Dataset(X, label=y),
                        num_boost_round=1)
    port = lgb.train(dict(params, device_type="cpu"),
                     lgb.Dataset(X, label=y), num_boost_round=1)
    ref_lines = ref.inner.models[0].to_string().splitlines()
    port_lines = port.inner.models[0].to_string().splitlines()
    assert len(ref_lines) == len(port_lines)
    for a, b in zip(ref_lines, port_lines):
        if a.startswith("split_gain="):
            # a gain is a difference of leaf gains of up to ~1e4 here:
            # f32 rounding of those terms is ~1e-3 absolute
            np.testing.assert_allclose(
                np.array(b.split("=")[1].split(), dtype=float),
                np.array(a.split("=")[1].split(), dtype=float), rtol=1e-5,
                atol=1e-3)
        else:
            assert a == b


def _reference_model(seed=5):
    X, y = _verify_data(seed=seed, nan=True)
    ref = ref_lgb.train({"objective": "binary", "num_leaves": 15,
                         "verbose": -1}, ref_lgb.Dataset(X, label=y),
                        num_boost_round=8)
    Xq, _ = _verify_data(seed=seed + 1, n=500, nan=True)
    Xq[::7, 2] = np.nan
    return ref, Xq


def test_trees_from_numpy_predict_like_the_reference():
    ref, Xq = _reference_model()
    fields = ("split_feature", "split_feature_inner", "threshold_in_bin",
              "threshold", "decision_type", "split_gain", "left_child",
              "right_child", "leaf_value", "leaf_weight", "leaf_count",
              "internal_value", "internal_weight", "internal_count",
              "leaf_parent", "leaf_depth")
    dicts = [dict({f: getattr(t, f) for f in fields},
                  num_leaves=t.num_leaves, shrinkage=t.shrinkage)
             for t in ref.inner.models]
    trees = trees_from_numpy(dicts)
    raw = sum(t.predict(Xq) for t in trees)
    np.testing.assert_array_equal(raw, ref.inner.predict_raw(Xq))
    for a, b in zip(ref.inner.models, trees):
        assert a.to_string() == b.to_string()


def test_reference_model_text_predicts_identically():
    ref, Xq = _reference_model(seed=7)
    text = ref.model_to_string()
    port = lgb.Booster(model_str=text, params={"device_type": "cpu"})
    np.testing.assert_array_equal(port.predict(Xq), ref.inner.predict(Xq))
    np.testing.assert_array_equal(port.predict(Xq, raw_score=True),
                                  ref.inner.predict_raw(Xq))
    np.testing.assert_array_equal(port.predict(Xq, pred_leaf=True),
                                  ref.inner.predict_leaf_index(Xq))
    early = dict(pred_early_stop=True, pred_early_stop_freq=2,
                 pred_early_stop_margin=1.0)
    np.testing.assert_array_equal(port.predict(Xq, **early),
                                  ref.inner.predict(Xq, **early))
    with pytest.raises(ValueError, match="number of features"):
        port.predict(Xq[:, :5])
    # the port's own text round-trips
    again = lgb.Booster(model_str=port.model_to_string(),
                        params={"device_type": "cpu"})
    np.testing.assert_array_equal(again.predict(Xq), port.predict(Xq))


def test_model_file_round_trip_and_early_stopping(tmp_path):
    X, y = _verify_data(seed=2)
    Xv, yv = _verify_data(seed=3, n=600)
    yv = np.where(np.random.RandomState(4).rand(600) < 0.4, 1 - yv, yv)
    ds = lgb.Dataset(X, label=y)
    bst = lgb.train({"objective": "binary", "metric": "binary_logloss",
                     "num_leaves": 31, "early_stopping_round": 3,
                     "device_type": "cpu", "verbose": -1}, ds,
                    num_boost_round=60,
                    valid_sets=[lgb.Dataset(Xv, label=yv, reference=ds)])
    assert 0 < bst.best_iteration < 60
    assert len(bst.inner.models) <= bst.best_iteration + 3
    path = tmp_path / "model.txt"
    bst.save_model(str(path))
    loaded = lgb.Booster(model_file=str(path),
                         params={"device_type": "cpu"})
    np.testing.assert_array_equal(
        loaded.predict(X, num_iteration=bst.best_iteration),
        bst.predict(X))
