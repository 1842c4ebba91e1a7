"""Forced splits and linear trees of the port against the JAX package's,
on the CPU.

- Forced splits (a forced root, a chain, a node whose one side is empty,
  a missing file) through the whole-tree and the per-split loop, in f32
  and with 8-bit gradients: the reference's splits, thresholds and leaf
  counts, leaf values within 1e-4 (level b); every tree starts with the
  forced nodes; the two loops give the same trees, text for text;
  forced splits with per-node masks warn and run without the masks.
- ``fit_linear_leaves`` (run on CPU tensors, with and without a bag)
  gives the reference's coefficients within rtol 1e-9, and a leaf whose
  path column is constant keeps its constant in both.
- A reference linear model's text loads into the port and is written
  back byte for byte; linear training makes the reference's trees
  (level b) and metric (level c); the stacked forest's predict equals
  the host walk; ``convert.trees_from_numpy`` carries linear trees;
  sparse input with ``keep_raw_data`` is the reference's fatal.

The card-only cases (the captured monotone step against the eager one,
the device linear fit against the CPU's) are in tests/test_torch_cuda.py,
which the card runs without the JAX package.
"""
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as ref_lgb
from lightgbm_tpu.config import Config as RefConfig
from lightgbm_tpu.io.dataset import BinnedDataset as RefBinned
from lightgbm_tpu.models import linear as ref_linear

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import trees_from_numpy
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.models import linear
from lightgbm_tpu_torch.models.tree import Tree
from lightgbm_tpu_torch.serve import BucketedPredictor, StackedForest
from lightgbm_tpu_torch.utils import log
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

BASE = {"objective": "regression", "num_leaves": 15, "verbose": -1}


def _data(n=1500, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[rng.rand(n) < 0.1, 3] = np.nan
    y = (X[:, 0] + np.sin(3 * X[:, 1]) - 0.5 * X[:, 2]
         + 0.4 * np.nan_to_num(X[:, 3]) + 0.1 * rng.randn(n))
    return X, y


def _splits(tree):
    ni = tree.num_internal
    return (tree.num_leaves, tree.split_feature[:ni].tolist(),
            tree.threshold[:ni].tolist(),
            tree.leaf_count[:tree.num_leaves].tolist())


def _assert_level_b(ref, port):
    assert len(ref.inner.models) == len(port.inner.models)
    for i, (a, b) in enumerate(zip(ref.inner.models, port.inner.models)):
        assert _splits(a) == _splits(b), "tree %d differs" % i
        np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                   a.leaf_value[:a.num_leaves],
                                   rtol=1e-4, atol=1e-6)


def _train_both(params, rounds=3, X=None, y=None):
    if X is None:
        X, y = _data()
    ref = ref_lgb.train(params, ref_lgb.Dataset(X, label=y),
                        num_boost_round=rounds)
    port = lgb.train(dict(params, device_type="cpu"),
                     lgb.Dataset(X, label=y), num_boost_round=rounds)
    return ref, port


# ----------------------------------------------------------------------
# forced splits
# ----------------------------------------------------------------------
FORCED = {
    "root": {"feature": 2, "threshold": 0.3},
    "chain": {"feature": 3, "threshold": 0.2,
              "left": {"feature": 1, "threshold": -0.5},
              "right": {"feature": 4, "threshold": 0.0,
                        "left": {"feature": 0, "threshold": 0.1}}},
    # the right child's split sends every row left: skipped, and with it
    # its subtree
    "empty_side": {"feature": 0, "threshold": 0.0,
                   "right": {"feature": 5, "threshold": 1e9,
                             "left": {"feature": 1, "threshold": 0.0}},
                   "left": {"feature": 2, "threshold": -0.3}},
}
# the forced (feature, threshold) of each tree's first nodes, in order
FIRST_NODES = {"root": [(2, 0.3)], "chain": [(3, 0.2), (1, -0.5),
                                             (4, 0.0), (0, 0.1)],
               "empty_side": [(0, 0.0), (2, -0.3)]}


def _forced_file(tmp_path, case):
    path = tmp_path / ("%s.json" % case)
    if case != "missing_file":
        path.write_text(json.dumps(FORCED[case]))
    return str(path)


@pytest.mark.parametrize("bits", ["f32", "8bit"])
@pytest.mark.parametrize("loop", ["whole_tree", "per_split"])
@pytest.mark.parametrize("case", ["root", "chain", "empty_side",
                                  "missing_file"])
def test_forced_trees_match_reference(tmp_path, monkeypatch, case, loop,
                                      bits):
    warned = []
    monkeypatch.setattr(log, "warning",
                        lambda msg, *a: warned.append(msg % a if a else msg))
    params = dict(BASE, forcedsplits_filename=_forced_file(tmp_path, case),
                  tpu_fused_tree=loop == "whole_tree",
                  use_quantized_grad=bits == "8bit")
    ref, port = _train_both(params, rounds=2)
    _assert_level_b(ref, port)
    if case == "missing_file":
        assert port.inner.learner._forced is None
        assert any("Cannot load forced splits" in m for m in warned)
        return
    if case == "empty_side":
        assert any("leaves an empty side" in m for m in warned)
    mappers = port.inner.train_data.bin_mappers
    for tree in port.inner.models:
        for node, (f, thr) in enumerate(FIRST_NODES[case]):
            assert tree.split_feature[node] == f
            assert tree.split_gain[node] == 0.0
            tbin = mappers[f].value_to_bin(np.asarray([thr]))[0]
            assert tree.threshold_in_bin[node] == tbin


@pytest.mark.parametrize("bits", ["f32", "8bit"])
def test_forced_whole_tree_equals_per_split(tmp_path, bits):
    X, y = _data()
    params = dict(BASE, device_type="cpu",
                  forcedsplits_filename=_forced_file(tmp_path, "chain"),
                  use_quantized_grad=bits == "8bit",
                  monotone_constraints=[1, 0, -1, 0, 0, 0])
    runs = [lgb.train(dict(params, tpu_fused_tree=fused),
                      lgb.Dataset(X, label=y), num_boost_round=3)
            for fused in (True, False)]
    assert runs[0].inner.learner.grow_stats["record_reads"] == 3
    assert [t.to_string() for t in runs[0].inner.models] == \
        [t.to_string() for t in runs[1].inner.models]
    assert torch.equal(runs[0].inner.train_score.view(torch.int32),
                       runs[1].inner.train_score.view(torch.int32))


def test_forced_with_bynode_warns_and_drops_the_masks(tmp_path,
                                                      monkeypatch):
    warned = []
    monkeypatch.setattr(log, "warning",
                        lambda msg, *a: warned.append(msg % a if a else msg))
    params = dict(BASE, forcedsplits_filename=_forced_file(tmp_path,
                                                           "chain"),
                  feature_fraction_bynode=0.5)
    ref, port = _train_both(params, rounds=2)
    assert any("without the per-node masks" in m for m in warned)
    assert port.inner.learner.grow_stats["record_reads"] == 2
    _assert_level_b(ref, port)


# ----------------------------------------------------------------------
# the linear fit
# ----------------------------------------------------------------------
def _linear_case(seed, lam):
    """A reference tree over rows whose column 0 is 0 on about half of
    them (a leaf of ``x0 <= 0`` sees a constant path column)."""
    rng = np.random.RandomState(seed)
    n = 2000
    X = rng.randn(n, 5)
    X[:, 0] = np.maximum(X[:, 0], 0.0)
    X[rng.rand(n) < 0.05, 2] = np.nan
    y = 3.0 * (X[:, 0] > 0) + X[:, 1] + 0.5 * X[:, 0] * X[:, 3] \
        + 0.1 * rng.randn(n)
    ref = ref_lgb.train(dict(BASE, num_leaves=8, min_data_in_leaf=30),
                        ref_lgb.Dataset(X, label=y), num_boost_round=1)
    tree = ref.inner.models[0]
    leaf = tree.predict_leaf_index(X)
    grad = rng.randn(n)
    hess = rng.rand(n) + 0.5
    mask = rng.rand(n) < 0.9
    return X, tree, leaf, grad, hess, mask, lam


@pytest.mark.parametrize("lam", [0.0, 0.1, 5.0])
@pytest.mark.parametrize("bagged", [True, False], ids=["bag", "no_bag"])
def test_fit_linear_leaves_equals_reference(bagged, lam):
    X, rtree, leaf, grad, hess, mask, lam = _linear_case(4, lam)
    mask = mask if bagged else None
    ref_linear.fit_linear_leaves(rtree, X, grad, hess, leaf, lam, mask)
    tree = Tree.from_string(rtree.to_string().replace("is_linear=1",
                                                      "is_linear=0"))
    t = torch.from_numpy
    linear.fit_linear_leaves(tree, t(X), t(grad), t(hess), t(leaf), lam,
                             None if mask is None else t(mask))
    nl = rtree.num_leaves
    assert tree.leaf_features[:nl] == rtree.leaf_features[:nl]
    for lf in range(nl):
        np.testing.assert_allclose(tree.leaf_coeff[lf], rtree.leaf_coeff[lf],
                                   rtol=1e-9, atol=0)
    np.testing.assert_allclose(tree.leaf_const[:nl], rtree.leaf_const[:nl],
                               rtol=1e-9, atol=1e-12)
    fitted = [lf for lf in range(nl) if rtree.leaf_features[lf]]
    assert fitted
    if lam == 0.0:
        # the leaf of x0 <= 0: its path column 0 is constant, the system
        # singular, so it keeps its constant output
        lone = [lf for lf in range(nl) if 0 in linear._leaf_paths(
            tree)[lf] and np.all(X[leaf == lf, 0] == 0.0)]
        assert lone and all(not tree.leaf_features[lf] for lf in lone)
        assert all(tree.leaf_const[lf] == tree.leaf_value[lf]
                   for lf in lone)


def _linear_booster(objective="regression", rounds=3, **extra):
    X, y = _data()
    if objective == "binary":
        y = (y > 0).astype(float)
    params = dict(BASE, objective=objective, linear_tree=True,
                  linear_lambda=0.1, metric="l2" if objective ==
                  "regression" else "binary_logloss", **extra)
    evals = ({}, {})
    Xv, yv = _data(n=500, seed=9)
    if objective == "binary":
        yv = (yv > 0).astype(float)
    ref_ds = ref_lgb.Dataset(X, label=y, params=params)
    ref = ref_lgb.train(params, ref_ds, num_boost_round=rounds,
                        valid_sets=[ref_lgb.Dataset(Xv, label=yv,
                                                    reference=ref_ds,
                                                    params=params)],
                        valid_names=["v"],
                        callbacks=[ref_lgb.record_evaluation(evals[0])])
    pparams = dict(params, device_type="cpu")
    ds = lgb.Dataset(X, label=y, params=pparams)
    port = lgb.train(pparams, ds, num_boost_round=rounds,
                     valid_sets=[ds.create_valid(Xv, label=yv)],
                     valid_names=["v"],
                     callbacks=[lgb.record_evaluation(evals[1])])
    return ref, port, evals, X


@pytest.mark.parametrize("objective,extra", [
    ("regression", {}),
    ("binary", {}),
    ("regression", {"bagging_fraction": 0.7, "bagging_freq": 1}),
], ids=["regression", "binary", "bagging"])
def test_linear_training_matches_reference(objective, extra):
    ref, port, evals, X = _linear_booster(objective, **extra)
    _assert_level_b(ref, port)
    for a, b in zip(ref.inner.models, port.inner.models):
        assert b.is_linear
        assert a.leaf_features[:a.num_leaves] == \
            b.leaf_features[:b.num_leaves]
        np.testing.assert_allclose(b.leaf_const[:b.num_leaves],
                                   a.leaf_const[:a.num_leaves], rtol=1e-4,
                                   atol=1e-6)
    name = "l2" if objective == "regression" else "binary_logloss"
    np.testing.assert_allclose(evals[1]["v"][name], evals[0]["v"][name],
                               rtol=1e-6)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-5,
                               atol=1e-6)


def test_linear_text_round_trip_and_stacked_predict():
    ref, port, _, X = _linear_booster(rounds=2)
    text = ref.model_to_string()

    def trees_of(s):
        return s[s.index("Tree=0"):s.index("end of trees")]
    loaded = lgb.Booster(model_str=text, params={"device_type": "cpu"})
    assert all(t.is_linear for t in loaded.inner.models)
    assert trees_of(loaded.model_to_string()) == trees_of(text)
    # the reference adds a leaf's products by a BLAS product, the port
    # row by row in feature order: equal up to the last bits
    np.testing.assert_allclose(loaded.predict(X, predict_on_device=False),
                               ref.predict(X), rtol=1e-12, atol=1e-15)
    # the stacked forest: leaf ids on the device, linear values summed
    # on the host in tree order, byte-equal to the host walk
    Xf = X.astype(np.float32).astype(np.float64)
    for b in (loaded, port):
        host = b.predict(Xf, raw_score=True, predict_on_device=False)
        np.testing.assert_array_equal(
            b.predict(Xf, raw_score=True, predict_on_device=True), host)
    forest = StackedForest.from_gbdt(port)
    raw32 = forest.predict_raw_device(Xf).numpy()[:, 0]
    vals = forest.tree_values_device(Xf).numpy().astype(np.float64)
    # Kahan's bound: 2 f32 ulp of the sum of the terms' magnitudes
    bound = 2 * np.finfo(np.float32).eps * np.abs(vals).sum(axis=0)
    assert np.all(np.abs(raw32 - vals.sum(axis=0)) <= bound)
    np.testing.assert_allclose(raw32, port.predict(Xf, raw_score=True,
                                                   predict_on_device=False),
                               rtol=1e-4, atol=1e-4)
    assert "leaf_coeff=" in port.model_to_string()
    dump = port.dump_model()["tree_info"][0]["tree_structure"]
    while "left_child" in dump:
        dump = dump["left_child"]
    assert {"leaf_const", "leaf_features", "leaf_coeff"} <= set(dump)


def test_convert_carries_a_linear_booster():
    ref, _, _, X = _linear_booster(rounds=2)
    fields = ("split_feature", "threshold", "decision_type", "left_child",
              "right_child", "leaf_value", "leaf_count", "num_leaves",
              "shrinkage", "is_linear", "leaf_const", "leaf_features",
              "leaf_coeff")
    dicts = [{k: getattr(t, k) for k in fields} for t in ref.inner.models]
    trees = trees_from_numpy(dicts)
    assert all(t.is_linear for t in trees)
    got = sum(t.predict(X) for t in trees)
    want = sum(t.predict(X) for t in ref.inner.models)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    forest = StackedForest(trees, 1, X.shape[1])
    Xf = X.astype(np.float32).astype(np.float64)
    # in chunks, padded: the same bytes as the host walk
    np.testing.assert_array_equal(
        BucketedPredictor(forest, min_bucket=256, max_bucket=512).predict(
            Xf, "raw"), sum(t.predict(Xf) for t in trees))


def test_sparse_input_with_raw_data_is_fatal():
    X, y = _data(n=300)
    Xs = sp.csr_matrix(np.nan_to_num(X))
    with pytest.raises(Exception, match="requires dense input"):
        RefBinned.from_matrix(Xs, RefConfig.from_params({"verbose": -1}),
                              label=y, keep_raw_data=True)
    with pytest.raises(LightGBMError, match="requires dense input"):
        BinnedDataset.from_matrix(Xs, Config.from_params({"verbose": -1}),
                                  label=y, keep_raw_data=True)
    # through Dataset both packages densify the rows for linear trees
    params = dict(BASE, linear_tree=True)
    ref, port = _train_both(params, rounds=1, X=Xs, y=y)
    assert port.inner.train_data.raw_data is not None
    _assert_level_b(ref, port)
