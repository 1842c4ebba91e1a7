"""Prediction through the stacked forest: the port against the JAX
package's ``serve.StackedForest`` and against the host walk, on the CPU.

Trees come from reference boosters (``lightgbm_tpu``), carried across
with ``convert.trees_from_numpy`` or through the model text, and both
packages pack them into a ``StackedForest``. Levels (ROADMAP):

- (a) byte-equal: leaf ids, ``value`` and ``raw`` outputs (f32 and
  double-double rows), the quantized bins, ``round_down_f32`` /
  ``_dd_pair``, the one-tree binned walk, and ``predict_raw_device``
  against the reference's Kahan sum (f32 adds and subtracts only, in the
  same order);
- the 512-stump Kahan sum within 2 f32 ulp of the f64 sum (the
  reference's bound, tests/test_serve.py).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as ref_lgb
from lightgbm_tpu.ops import predict as ref_ops
from lightgbm_tpu.serve import BucketedPredictor as RefBucketed
from lightgbm_tpu.serve import StackedForest as RefForest
from lightgbm_tpu.serve.forest import _dd_pair as ref_dd_pair
from lightgbm_tpu.serve.forest import round_down_f32 as ref_round_down

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.convert import trees_from_numpy
from lightgbm_tpu_torch.models.linear import fit_linear_leaves
from lightgbm_tpu_torch.models.tree import Tree
from lightgbm_tpu_torch.obs.registry import registry
from lightgbm_tpu_torch.ops import predict as P
from lightgbm_tpu_torch.serve import (BucketedPredictor, StackedForest,
                                      round_down_f32)
from lightgbm_tpu_torch.serve.cache import kDDBucketCap
from lightgbm_tpu_torch.serve.forest import _dd_pair
from lightgbm_tpu_torch.utils import log as plog
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

_FIELDS = ("split_feature", "split_feature_inner", "threshold_in_bin",
           "threshold", "decision_type", "split_gain", "left_child",
           "right_child", "leaf_value", "leaf_weight", "leaf_count",
           "internal_value", "internal_weight", "internal_count",
           "leaf_parent", "leaf_depth")


def _data(n=400, seed=0, nan=True):
    """f32-representable rows (the f32 serving contract) with NaNs."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32).astype(np.float64)
    if nan:
        X[rng.rand(n) < 0.15, 2] = np.nan
    y = (X[:, 0] + 0.5 * np.nan_to_num(X[:, 2]) - 0.3 * X[:, 4]
         > 0.2).astype(float)
    return X, y


def _ref_train(objective, X, y, rounds=6, **extra):
    params = dict({"objective": objective, "num_leaves": 15,
                   "verbosity": -1, "min_data_in_leaf": 5,
                   "max_bin": 63}, **extra)
    return ref_lgb.train(params, ref_lgb.Dataset(X, label=y),
                         num_boost_round=rounds)


def _carried(ref):
    """The reference booster's trees as port Trees."""
    return trees_from_numpy([
        dict({f: getattr(t, f) for f in _FIELDS},
             num_leaves=t.num_leaves, shrinkage=t.shrinkage)
        for t in ref.inner.models])


def _port_booster(ref):
    """The reference model's text loaded into a CPU port Booster."""
    return lgb.Booster(model_str=ref.model_to_string(),
                       params={"device_type": "cpu"})


@pytest.fixture(scope="module")
def shared():
    """(X, reference booster, port booster, host value) of one 640-row
    12-round binary model with NaNs, shared by most tests."""
    X, y = _data(n=640, seed=11)
    ref = _ref_train("binary", X, y, rounds=12)
    port = _port_booster(ref)
    return X, ref, port, port.predict(X, predict_on_device=False)


# ----------------------------------------------------------------------
# StackedForest against the reference's and the host walk (level a)
# ----------------------------------------------------------------------
def test_stacked_forest_byte_equal_binary(shared):
    X, ref, port, host = shared
    ref_forest = RefForest.from_gbdt(ref)
    forest = StackedForest(_carried(ref), 1, X.shape[1])
    leaves = forest.leaves(X)
    assert leaves.dtype == np.int32 and leaves.shape == (640, 12)
    np.testing.assert_array_equal(leaves, ref_forest.leaves(X))
    np.testing.assert_array_equal(
        leaves, port.predict(X, pred_leaf=True, predict_on_device=False))
    raw = forest.predict_raw(X)
    np.testing.assert_array_equal(raw, ref_forest.predict_raw(X))
    np.testing.assert_array_equal(
        raw, port.predict(X, raw_score=True, predict_on_device=False))
    value = StackedForest.from_gbdt(port).predict(X)
    np.testing.assert_array_equal(value, host)
    np.testing.assert_array_equal(value, ref_forest.predict(X))


def test_quantized_bins_equal_the_reference(shared):
    X, ref, _, _ = shared
    ref_forest = RefForest.from_gbdt(ref)
    forest = StackedForest(_carried(ref), 1, X.shape[1])
    X32 = X.astype(np.float32)
    got = P._quantize_rows_impl(torch.from_numpy(X32), forest._qt)
    want = np.asarray(ref_ops._quantize_rows_impl(X32, ref_forest._qt))
    np.testing.assert_array_equal(got.numpy().T, want)
    assert (got == P.kNanBin).any()
    hi, lo = forest.encode_dd(X)
    rhi, rlo = ref_forest.encode_dd(X)
    np.testing.assert_array_equal(hi, rhi)
    np.testing.assert_array_equal(lo, rlo)
    got = P._quantize_rows_dd_impl(torch.from_numpy(hi),
                                   torch.from_numpy(lo), forest._qt_dd)
    want = np.asarray(ref_ops._quantize_rows_dd_impl(hi, lo,
                                                     ref_forest._qt_dd))
    np.testing.assert_array_equal(got.numpy().T, want)


def test_predict_raw_device_equals_the_reference_kahan_sum(shared):
    X, ref, _, host = shared
    ref_forest = RefForest.from_gbdt(ref)
    forest = StackedForest(_carried(ref), 1, X.shape[1])
    X32 = X.astype(np.float32)
    got = forest.predict_raw_device(X32)
    assert got.dtype == torch.float32 and got.shape == (640, 1)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_forest.predict_raw_device(X32)))


@pytest.mark.parametrize("objective,extra", [
    ("regression", {}),
    ("poisson", {}),
    ("multiclass", {"num_class": 3, "num_leaves": 7}),
])
def test_stacked_forest_byte_equal_other_objectives(objective, extra):
    X, _ = _data()
    label = {"regression": X[:, 0] + np.nan_to_num(X[:, 2]),
             "poisson": np.floor(np.exp(0.5 * X[:, 0])),
             "multiclass": (np.abs(X[:, 4] * 3).astype(int) % 3
                            ).astype(float)}[objective]
    ref = _ref_train(objective, X, label, **extra)
    port = _port_booster(ref)
    forest = StackedForest.from_gbdt(port)
    ref_forest = RefForest.from_gbdt(ref)
    for raw in (False, True):
        host = port.predict(X, raw_score=raw, predict_on_device=False)
        got = forest.predict(X, raw_score=raw)
        np.testing.assert_array_equal(got, host)
        np.testing.assert_array_equal(got, ref_forest.predict(
            X, raw_score=raw))
    np.testing.assert_array_equal(
        forest.predict_raw_device(X.astype(np.float32)).numpy(),
        np.asarray(ref_forest.predict_raw_device(X.astype(np.float32))))


def test_stacked_forest_zero_as_missing_byte_equal():
    rng = np.random.RandomState(3)
    X, y = _data(seed=3, nan=False)
    X = np.where(rng.rand(*X.shape) < 0.4, 0.0, X)
    ref = _ref_train("binary", X, y, rounds=5, zero_as_missing=True)
    port = _port_booster(ref)
    host = port.predict(X, predict_on_device=False)
    forest = StackedForest.from_gbdt(port)
    assert forest._qt.zero_feat.any()
    np.testing.assert_array_equal(forest.predict(X), host)
    np.testing.assert_array_equal(forest.leaves(X),
                                  RefForest.from_gbdt(ref).leaves(X))
    # f64 rows near zero take the dd path's exact zero test
    X64 = X + np.where(X == 0.0, 1e-40, 1e-12)
    np.testing.assert_array_equal(
        forest.predict(X64), port.predict(X64, predict_on_device=False))


def test_stacked_forest_of_the_port_text_round_trip(shared):
    X, _, port, host = shared
    again = lgb.Booster(model_str=port.model_to_string(),
                        params={"device_type": "cpu"})
    np.testing.assert_array_equal(StackedForest.from_gbdt(again).predict(X),
                                  host)


def test_stacked_forest_start_num_iteration_slice(shared):
    X, ref, port, _ = shared
    host = port.predict(X, start_iteration=3, num_iteration=5,
                        predict_on_device=False)
    forest = StackedForest.from_gbdt(port, start_iteration=3,
                                     num_iteration=5)
    assert forest.num_trees == 5
    np.testing.assert_array_equal(forest.predict(X), host)
    np.testing.assert_array_equal(
        port.predict(X, start_iteration=3, num_iteration=5,
                     predict_on_device=True), host)
    np.testing.assert_array_equal(
        forest.leaves(X),
        RefForest.from_gbdt(ref, start_iteration=3,
                            num_iteration=5).leaves(X))


def test_round_down_f32_and_dd_pair_equal_the_reference():
    vals = np.array([1e-35, 0.1, -0.1, 3.5, 1e300, -1e300, 7.0, 0.0,
                     -0.0, np.inf, -np.inf, np.nan, 1.0 + 2 ** -40])
    rd = round_down_f32(vals)
    assert rd.dtype == np.float32
    fin = np.isfinite(vals)
    assert np.all(rd[fin].astype(np.float64) <= vals[fin])
    with np.errstate(over="ignore"):
        nxt = np.nextafter(rd[fin], np.float32(np.inf))
    assert np.all(nxt.astype(np.float64) > vals[fin])
    np.testing.assert_array_equal(rd, ref_round_down(vals))
    hi, lo = _dd_pair(vals)
    rhi, rlo = ref_dd_pair(vals)
    np.testing.assert_array_equal(hi, rhi)
    np.testing.assert_array_equal(lo, rlo)


def test_f64_rows_take_the_dd_path_byte_equal(shared):
    X, ref, port, _ = shared
    X64 = X + np.random.RandomState(13).randn(*X.shape) * 1e-12
    host = port.predict(X64, predict_on_device=False)
    port._stacked_cache = None
    got = port.predict(X64, predict_on_device=True)
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, RefForest.from_gbdt(ref).predict(X64))
    predictor = port._stacked_cache[1]
    assert any(len(k) == 4 and k[3] == "dd" for k in predictor.entries)
    np.testing.assert_array_equal(
        port.predict(X64, pred_leaf=True, predict_on_device=True),
        port.predict(X64, pred_leaf=True, predict_on_device=False))


# ----------------------------------------------------------------------
# the one-tree binned walk (validation scores, init_model replay)
# ----------------------------------------------------------------------
def test_device_tree_walk_equals_the_reference(shared):
    _, ref, _, _ = shared
    inner = ref.inner
    bins = np.asarray(inner.train_data.bins)
    meta = tuple(np.asarray(m) for m in inner._bin_meta)
    B = max(int(inner.train_data.max_num_bin), 2)
    for rt, pt in zip(inner.models, _carried(ref)):
        dt = P.build_device_tree(pt, meta, torch.device("cpu"))
        rdt = ref_ops.build_device_tree(rt, inner._bin_meta, B)
        if rdt is None:
            assert dt is None
            continue
        np.testing.assert_array_equal(
            P.predict_leaf_on_device(torch.from_numpy(bins), dt).numpy(),
            np.asarray(ref_ops.predict_leaf_on_device(bins, rdt)))
        np.testing.assert_array_equal(
            P.tree_output_on_device(torch.from_numpy(bins), dt).numpy(),
            np.asarray(ref_ops.tree_output_on_device(bins, rdt)))


# ----------------------------------------------------------------------
# the bucket policy
# ----------------------------------------------------------------------
def test_bucket_policy_and_chunking(shared):
    X, ref, port, host = shared
    # the bucket counts live in the metrics registry, process-wide
    registry.reset()
    pred = BucketedPredictor(StackedForest.from_gbdt(port),
                             model_version="v", min_bucket=16,
                             max_bucket=256)
    ref_pred = RefBucketed(RefForest.from_gbdt(ref), model_version="v",
                           min_bucket=16, max_bucket=256)
    for n in (1, 17, 256, 10_000):
        assert pred.bucket_for(n) == ref_pred.bucket_for(n)
    assert [pred.bucket_for(n) for n in (1, 17, 256, 10_000)] == \
        [16, 32, 256, 256]
    # 640 rows stream as 256 + 256 + 128-row chunks through two buckets
    np.testing.assert_array_equal(pred.predict(X), host)
    ref_pred.predict(X)
    assert pred.entries == ref_pred.entries == {
        ("v", 256, "value"): 2, ("v", 128, "value"): 1}
    np.testing.assert_array_equal(pred.predict(X[:90]), host[:90])
    assert pred.entries[("v", 128, "value")] == 2
    assert pred.stats["hits"] == 2 and pred.stats["compiles"] == 2
    assert registry.gauges["serve/compile_cache_size"] == 2
    pred.swap(pred.forest, "w")
    assert pred.entries == {}


def test_dd_batches_chunk_at_the_dd_cap(shared):
    X, _, port, _ = shared
    pred = BucketedPredictor(StackedForest.from_gbdt(port), min_bucket=16)
    X64 = np.tile(X, (8, 1))[:kDDBucketCap + 100] + 1e-12
    got = pred.predict(X64, output_kind="raw")
    assert set(pred.entries) == {(0, kDDBucketCap, "raw", "dd"),
                                 (0, 128, "raw", "dd")}
    np.testing.assert_array_equal(
        got, port.predict(X64, raw_score=True, predict_on_device=False))


def test_every_output_kind(shared):
    X, ref, port, _ = shared
    pred = BucketedPredictor(StackedForest.from_gbdt(port), min_bucket=32)
    ref_pred = RefBucketed(RefForest.from_gbdt(ref), min_bucket=32)
    n = 50
    host_raw = port.predict(X[:n], raw_score=True, predict_on_device=False)
    np.testing.assert_array_equal(pred.predict(X[:n], output_kind="raw"),
                                  host_raw)
    np.testing.assert_array_equal(
        pred.predict(X[:n], output_kind="leaf"),
        port.predict(X[:n], pred_leaf=True, predict_on_device=False))
    np.testing.assert_array_equal(
        pred.predict(X[:n], output_kind="value"),
        port.predict(X[:n], predict_on_device=False))
    fast = pred.predict(X[:n], output_kind="raw_device")
    assert fast.dtype == np.float32 and fast.shape == (n, 1)
    np.testing.assert_array_equal(
        fast, ref_pred.predict(X[:n], output_kind="raw_device"))
    np.testing.assert_allclose(fast[:, 0], host_raw, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="output_kind"):
        pred.predict(X[:n], output_kind="contrib")


def test_deep_forest_device_sum_kahan_tight():
    """512 stumps make the sum the only source of error: the Kahan sum
    lands within 2 f32 ulp of the f64 sum, and equals the reference's."""
    from lightgbm_tpu.models.tree import Tree as RefTree
    rng = np.random.RandomState(0)
    values = rng.rand(512)
    models, ref_models = [], []
    for v in values:
        t, rt = Tree(1), RefTree(1)
        t.leaf_value[0] = rt.leaf_value[0] = v
        models.append(t)
        ref_models.append(rt)
    forest = StackedForest(models, num_tree_per_iteration=1, num_features=1)
    X = np.zeros((4, 1), dtype=np.float32)
    dev = forest.predict_raw_device(X).numpy()[:, 0]
    exact = values.sum()
    ulp = float(np.spacing(np.float32(exact)))
    assert abs(float(dev[0]) - exact) <= 2 * ulp
    np.testing.assert_array_equal(
        dev, np.asarray(RefForest(ref_models, 1, 1).predict_raw_device(X))
        [:, 0])
    in_order = 0.0                  # the host walk's adds, tree by tree
    for v in values:
        in_order += v
    np.testing.assert_array_equal(forest.predict_raw(X),
                                  np.full(4, in_order))


# ----------------------------------------------------------------------
# Booster.predict's decision rules, and what the port does not stack
# ----------------------------------------------------------------------
def test_booster_predict_modes(shared, capsys):
    X, _, port, host = shared
    plog.set_verbosity(0)
    port._stacked_cache = None
    # auto mode on a CPU booster: the host walk
    np.testing.assert_array_equal(port.predict(X), host)
    assert getattr(port, "_stacked_cache", None) is None
    np.testing.assert_array_equal(port.predict(X, predict_on_device=True),
                                  host)
    assert port._stacked_cache[1].entries
    # a forced request that cannot stack says so, then walks the host
    early = dict(pred_early_stop=True, pred_early_stop_freq=2,
                 pred_early_stop_margin=1.0)
    capsys.readouterr()
    got = port.predict(X, predict_on_device=True, **early)
    assert "pred_early_stop" in capsys.readouterr().err
    np.testing.assert_array_equal(got, port.predict(
        X, predict_on_device=False, **early))


def test_text_loaded_booster_asks_for_the_card(shared):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    X, ref, _, _ = shared
    bst = lgb.Booster(model_str=ref.model_to_string())
    np.testing.assert_array_equal(bst.predict(X[:100]),
                                  ref.predict(X[:100]))
    with pytest.raises(LightGBMError, match="no CUDA device"):
        bst.predict(X)


def test_what_does_not_stack_raises_naming_its_item(shared):
    """The LUT-node encoding, categorical nodes and linear leaves stack
    now (their parity is in ``tests/test_torch_efb.py`` and
    ``tests/test_torch_forced_linear.py``); what still cannot stack
    raises: a feature that no single quantizer can serve
    (``ValueError``, the caller's cue for the host walk). average_output
    (item 16) stacks, byte-equal to the reference's
    forest."""
    X, ref, _, _ = shared
    trees = _carried(ref)
    lut = StackedForest(trees, 1, 6, lut=True)
    assert lut.lut_nodes
    np.testing.assert_array_equal(lut.leaves(X[:300]),
                                  StackedForest(trees, 1, 6,
                                                lut=False).leaves(X[:300]))
    # average_output (random forest, item 16) stacks: the
    # raw sums over the number of iterations, byte-equal to the
    # reference's forest
    avg = StackedForest(trees, 1, 6, average_output=True)
    ref_avg = RefForest(ref.inner.models, 1, 6, average_output=True)
    np.testing.assert_array_equal(avg.predict_raw(X), ref_avg.predict_raw(X))
    np.testing.assert_array_equal(
        avg.predict_raw(X),
        StackedForest(trees, 1, 6).predict_raw(X) / len(trees))
    cat = _carried(ref)
    f = cat[0].split_feature[0]
    assert any(t.split_feature[j] == f for t in cat[1:]
               for j in range(t.num_internal))
    cat[0].decision_type[0] = 1
    cat[0].threshold_in_bin[0] = 0
    cat[0].num_cat, cat[0].cat_boundaries, cat[0].cat_threshold = \
        1, [0, 1], [0b101]
    with pytest.raises(ValueError, match="numerical and categorical"):
        StackedForest(cat, 1, 6)
    lin = _carried(ref)
    rng = np.random.RandomState(3)
    t = torch.from_numpy
    fit_linear_leaves(lin[0], t(X), t(rng.randn(len(X))),
                      t(rng.rand(len(X)) + 0.5),
                      t(lin[0].predict_leaf_index(X)), 0.1)
    assert any(lin[0].leaf_features[:lin[0].num_leaves])
    host = sum(t.predict(X[:300]) for t in lin)
    np.testing.assert_array_equal(StackedForest(lin, 1, 6).predict_raw(
        X[:300]), host)
    mixed = _carried(ref)
    f = mixed[0].split_feature[0]
    t, j = next((t, j) for t in mixed[1:] for j in range(t.num_internal)
                if t.split_feature[j] == f)
    m = (int(t.decision_type[j]) >> 2) & 3
    t.decision_type[j] = (int(t.decision_type[j]) & ~12) | \
        ((0 if m == 1 else 1) << 2)
    with pytest.raises(ValueError, match="mixes missing types"):
        StackedForest(mixed, 1, 6)
