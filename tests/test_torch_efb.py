"""EFB bundles, sparse input and the stacked forest's categorical and LUT
nodes in the port against the JAX package, on the CPU.

The same seeded numpy inputs go to ``lightgbm_tpu`` and to
``lightgbm_tpu_torch`` (``device_type="cpu"``). Levels (ROADMAP):

- (a) byte-equal: ``find_groups``, ``build_layout`` and the bundled bins
  on block-one-hot data (``tests/test_efb.py``'s ``_sparse_onehot_data``);
  a CSR or CSC matrix bins to the dense matrix's bytes (implicit zeros,
  the sample pass, zero_as_missing); a layout and mappers carried across
  (``convert``) bin to the reference's bytes; the integer unpack of a
  bundle histogram; stacked-forest leaf ids and values against the host
  walk and the reference's ``StackedForest``;
- (b) the f32 unpack (its zero bin is an f32 cancellation: within 1e-5
  of the magnitudes); bundled trees against the reference's bundled
  trees (same splits and leaf counts, leaf values within rtol 1e-4);
- the port bundled against the port unbundled: predictions within rtol
  1e-4 (the reference's own contract,
  ``tests/test_efb.py::test_bundled_matches_unbundled_predictions``).
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import lightgbm_tpu as ref_lgb
import lightgbm_tpu.config as ref_config
import lightgbm_tpu.io.dataset as ref_dataset
import lightgbm_tpu.io.efb as ref_efb
import lightgbm_tpu.ops.histogram as ref_hist
from lightgbm_tpu.serve.forest import StackedForest as RefForest
import lightgbm_tpu_torch as lgb
import lightgbm_tpu_torch.config as port_config
import lightgbm_tpu_torch.io.dataset as port_dataset
import lightgbm_tpu_torch.io.efb as port_efb
from lightgbm_tpu_torch.convert import (bin_mappers_from_numpy,
                                        bundle_layout_from_numpy)
from lightgbm_tpu_torch.ops.histogram import unpack_bundle_histogram
from lightgbm_tpu_torch.serve import StackedForest

torch.set_num_threads(1)


def _sparse_onehot_data(n=2000, n_blocks=6, block=8, seed=0):
    """``tests/test_efb.py``'s data: blocks of mutually exclusive sparse
    columns, plus two dense informative ones."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 2 + n_blocks * block))
    X[:, 0] = rng.randn(n)
    X[:, 1] = rng.randn(n)
    for b in range(n_blocks):
        choice = rng.randint(0, block, n)
        X[np.arange(n), 2 + b * block + choice] = rng.rand(n) + 0.5
    logit = X[:, 0] + 0.8 * (X[:, 2] > 0) - 0.6 * (X[:, 10] > 0)
    y = (logit + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, y


def _both(X, params, y=None):
    label = np.zeros(X.shape[0]) if y is None else y
    ref = ref_dataset.BinnedDataset.from_matrix(
        X, ref_config.Config.from_params(dict(params, verbose=-1)),
        label=label)
    port = port_dataset.BinnedDataset.from_matrix(
        X, port_config.Config.from_params(dict(params, verbose=-1,
                                               device_type="cpu")),
        label=label)
    return ref, port


def _layouts_equal(a, b):
    assert a.groups == b.groups
    for name in ("group_of", "member", "unmap", "needs_zero_fix", "gidx_g",
                 "gidx_b"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.num_bundled_bins == b.num_bundled_bins


# ----------------------------------------------------------------------
# layout and bins (level a)
# ----------------------------------------------------------------------
def test_find_groups_and_build_layout_equal_the_reference():
    rng = np.random.RandomState(4)
    n = 600
    masks, num_bins = [], []
    for k in range(10):
        m = np.zeros(n, dtype=bool)
        m[k::10] = True
        if k == 3:
            m[:40] = True                       # conflicts with the rest
        masks.append(m)
        num_bins.append(rng.randint(2, 40))
    masks[7] = None                              # dense: a singleton
    num_bins = np.asarray(num_bins, dtype=np.int32)
    for budget in (256, 60):
        got = port_efb.find_groups(masks, num_bins, n, budget)
        assert got == ref_efb.find_groups(masks, num_bins, n, budget)
        zero_bins = rng.randint(0, 2, len(num_bins)).astype(np.int32)
        _layouts_equal(
            port_efb.build_layout(got, num_bins, zero_bins, 64),
            ref_efb.build_layout(got, num_bins, zero_bins, 64))


@pytest.mark.parametrize("kind", ["plain", "small_blocks", "sampled",
                                  "zero_as_missing", "min_data_in_bin_20"])
def test_bundled_bins_byte_equal(kind):
    n_blocks, block, params = 6, 8, {}
    if kind == "small_blocks":
        n_blocks, block = 8, 6
    if kind == "sampled":
        params["bin_construct_sample_cnt"] = 700
    if kind == "zero_as_missing":
        params["zero_as_missing"] = True
    if kind == "min_data_in_bin_20":
        params["min_data_in_bin"] = 20      # fewer bins: more per bundle
    X, _ = _sparse_onehot_data(n_blocks=n_blocks, block=block)
    ref, port = _both(X, params)
    assert ref.bundle is not None and port.bundle is not None
    assert port.bundle.num_groups < port.num_features
    _layouts_equal(port.bundle, ref.bundle)
    assert port.bins.dtype == np.uint8
    assert port.bins.tobytes() == np.asarray(ref.bins).tobytes()
    for j in range(port.num_features):
        np.testing.assert_array_equal(port.feature_bin_column(j),
                                      ref.feature_bin_column(j))
    np.testing.assert_array_equal(port.feature_bins(), ref.feature_bins())


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo"])
@pytest.mark.parametrize("params", [{}, {"zero_as_missing": True},
                                    {"bin_construct_sample_cnt": 700},
                                    {"enable_bundle": False}],
                         ids=["default", "zero_as_missing", "sampled",
                              "unbundled"])
def test_sparse_bins_equal_dense(fmt, params):
    """Level (a): a scipy matrix bins (O(nnz) per column, implicit zeros
    at the zero bin) to the dense matrix's bytes, in the port and in the
    reference; duplicate entries of a COO matrix sum."""
    X, _ = _sparse_onehot_data(seed=2)
    X[::17, 0] = 0.0
    dense = port_dataset.BinnedDataset.from_matrix(
        X, port_config.Config.from_params(dict(params, device_type="cpu")))
    Xs = getattr(sp, fmt + "_matrix")(X)
    if fmt == "coo":
        # the same values split into two entries each
        Xs = sp.coo_matrix((np.concatenate([Xs.data * 0.5, Xs.data * 0.5]),
                            (np.concatenate([Xs.row, Xs.row]),
                             np.concatenate([Xs.col, Xs.col]))),
                           shape=X.shape)
    port = port_dataset.BinnedDataset.from_matrix(
        Xs, port_config.Config.from_params(dict(params, device_type="cpu")))
    assert port.bins.tobytes() == dense.bins.tobytes()
    ref = ref_dataset.BinnedDataset.from_matrix(
        getattr(sp, fmt + "_matrix")(X), ref_config.Config.from_params(
            dict(params, verbose=-1)))
    assert port.bins.tobytes() == np.asarray(ref.bins).tobytes()


def test_layout_and_mappers_carried_across():
    """``convert.bundle_layout_from_numpy`` beside
    ``bin_mappers_from_numpy``: the reference's layout and mappers give
    its bundled bins byte for byte."""
    X, _ = _sparse_onehot_data(seed=5)
    ref, _ = _both(X, {})
    dicts = [None] * X.shape[1]
    for j, f in enumerate(ref.used_feature_map):
        dicts[f] = ref.bin_mappers[j].to_dict()
    port = port_dataset.BinnedDataset.from_matrix(
        X, port_config.Config.from_params({"device_type": "cpu"}),
        mappers=bin_mappers_from_numpy(dicts),
        bundle=bundle_layout_from_numpy(ref.bundle))
    assert port.bins.tobytes() == np.asarray(ref.bins).tobytes()
    _layouts_equal(port.bundle, ref.bundle)


# ----------------------------------------------------------------------
# the unpack of a bundle histogram
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_unpack_bundle_histogram(dtype):
    """Integer: byte-equal to the reference (level a). f32: the zero bin
    is a cancellation total - sum(other bins); held within 1e-5 of the
    magnitudes it cancels (level b)."""
    X, _ = _sparse_onehot_data(seed=1)
    _, port = _both(X, {})
    lay = port.bundle
    rng = np.random.RandomState(0)
    n = X.shape[0]
    if dtype == "int32":
        gh = rng.randint(-60, 60, (n, 4)).astype(np.int32)
    else:
        gh = np.stack([rng.randn(n), rng.rand(n), np.ones(n), np.ones(n)],
                      axis=1).astype(np.float32)
    G, Bg = lay.num_groups, lay.num_bundled_bins
    bhist = np.zeros((G, Bg, 4), dtype=gh.dtype)
    for g in range(G):
        np.add.at(bhist[g], port.bins[:, g].astype(np.int64), gh)
    totals = gh.sum(axis=0, dtype=gh.dtype)
    zero_bins = np.asarray([m.default_bin for m in port.bin_mappers],
                           dtype=np.int32)
    got = unpack_bundle_histogram(
        torch.from_numpy(bhist), torch.from_numpy(lay.gidx_g),
        torch.from_numpy(lay.gidx_b), torch.from_numpy(lay.needs_zero_fix),
        torch.from_numpy(zero_bins), torch.from_numpy(totals)).numpy()
    want = np.asarray(ref_hist.unpack_bundle_histogram(
        jnp.asarray(bhist), jnp.asarray(lay.gidx_g), jnp.asarray(lay.gidx_b),
        jnp.asarray(lay.needs_zero_fix), jnp.asarray(zero_bins),
        jnp.asarray(totals)))
    if dtype == "int32":
        assert got.dtype == np.int32
        assert got.tobytes() == want.tobytes()
    else:
        mag = np.abs(gh).sum(axis=0)[None, None, :]
        assert np.all(np.abs(got - want) <= 1e-5 * mag)
    # each feature's histogram holds every row once
    exact = np.zeros_like(got, dtype=np.float64)
    fb = port.feature_bins()
    for j in range(port.num_features):
        np.add.at(exact[j], fb[:, j].astype(np.int64), gh.astype(np.float64))
    np.testing.assert_allclose(got, exact, rtol=0,
                               atol=1e-4 * float(np.abs(gh).sum()))


# ----------------------------------------------------------------------
# training on bundles
# ----------------------------------------------------------------------
def _splits(tree):
    ni = tree.num_internal
    return (tree.num_leaves, tree.split_feature[:ni].tolist(),
            tree.threshold[:ni].tolist(),
            tree.leaf_count[:tree.num_leaves].tolist())


BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
        "verbose": -1}


@pytest.mark.parametrize("extra", [{}, {"use_quantized_grad": True}],
                         ids=["f32", "quantized8"])
def test_bundled_trees_match_reference(extra):
    """Level (b) against the reference's bundled trees; level (a)
    between the port's two loops and between dense and CSR input."""
    X, y = _sparse_onehot_data()
    params = dict(BASE, **extra)
    rd = ref_lgb.Dataset(X, label=y)
    ref = ref_lgb.train(params, rd, num_boost_round=4)
    assert rd.handle.bundle is not None
    runs = {}
    for name, data, fused in (("dense", X, True), ("csr", sp.csr_matrix(X),
                                                   True),
                              ("per_split", X, False)):
        pd = lgb.Dataset(data, label=y)
        runs[name] = lgb.train(dict(params, device_type="cpu",
                                    tpu_fused_tree=fused), pd,
                               num_boost_round=4)
        assert pd.handle.bundle is not None
        assert runs[name].inner.learner._bundled
    port = runs["dense"]
    for i, (a, b) in enumerate(zip(ref.inner.models, port.inner.models)):
        assert _splits(a) == _splits(b), "tree %d differs" % i
        np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                   a.leaf_value[:a.num_leaves],
                                   rtol=1e-4, atol=1e-6)
    text = [t.to_string() for t in port.inner.models]
    for name in ("csr", "per_split"):
        assert [t.to_string() for t in runs[name].inner.models] == text


def test_bundled_matches_unbundled_predictions():
    X, y = _sparse_onehot_data()
    p = {}
    for bundle in (True, False):
        bst = lgb.train(dict(BASE, device_type="cpu", enable_bundle=bundle,
                             metric="auc"), lgb.Dataset(X, label=y),
                        num_boost_round=8)
        assert bst.inner.learner._bundled == bundle
        p[bundle] = bst.predict(X)
    np.testing.assert_allclose(p[True], p[False], rtol=1e-4, atol=1e-5)


def test_valid_set_alignment_with_bundles():
    """A validation set with ``reference=`` reuses the training set's
    layout: its device scores (the binned walk over bundle columns)
    equal a fresh host-walk prediction, and the reference's own run's
    metric within 1e-4."""
    X, y = _sparse_onehot_data()
    Xv, yv = _sparse_onehot_data(seed=7)
    params = dict(BASE, metric="binary_logloss")
    rec, ref_rec = {}, {}
    train = lgb.Dataset(X, label=y)
    valid = lgb.Dataset(Xv, label=yv, reference=train)
    bst = lgb.train(dict(params, device_type="cpu"), train,
                    num_boost_round=6, valid_sets=[valid],
                    callbacks=[lgb.record_evaluation(rec)])
    assert valid.handle.bundle is train.handle.bundle
    raw = bst.predict(Xv, raw_score=True, predict_on_device=False)
    np.testing.assert_allclose(bst.inner.valid_data[0].scores[:, 0], raw,
                               rtol=0, atol=1e-5)
    rt = ref_lgb.Dataset(X, label=y)
    ref_lgb.train(params, rt, num_boost_round=6,
                  valid_sets=[ref_lgb.Dataset(Xv, label=yv, reference=rt)],
                  callbacks=[ref_lgb.record_evaluation(ref_rec)])
    np.testing.assert_allclose(rec["valid_0"]["binary_logloss"],
                               ref_rec["valid_0"]["binary_logloss"],
                               rtol=0, atol=1e-4)


def test_bundled_rollback_and_init_model():
    """The binned walks over bundle columns: a rollback takes exactly
    the trees' outputs off, and a continued run replays the text-loaded
    trees onto the bundled rows like the trained ones."""
    X, y = _sparse_onehot_data(seed=3)
    params = dict(BASE, device_type="cpu")
    bst = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=3)
    score = bst.inner.train_score.clone()
    bst.update()
    bst.rollback_one_iter()
    np.testing.assert_allclose(bst.inner.train_score.numpy(),
                               score.numpy(), rtol=0, atol=1e-6)
    cont = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=1,
                     init_model=bst)
    np.testing.assert_allclose(
        cont.predict(X, raw_score=True, num_iteration=3),
        bst.predict(X, raw_score=True), rtol=1e-12)


# ----------------------------------------------------------------------
# the stacked forest: categorical nodes and the LUT-node encoding
# ----------------------------------------------------------------------
def _cat_sparse_model():
    """A reference model with categorical and numerical nodes over a wide
    sparse matrix (most of its 50 columns never split on)."""
    X, y = _sparse_onehot_data(seed=9)
    rng = np.random.RandomState(9)
    cat = rng.randint(0, 40, len(y)).astype(np.float64)
    cat[rng.rand(len(y)) < 0.05] = np.nan
    y = ((y > 0) ^ (np.isin(cat, [3, 5, 7, 11, 33]))).astype(np.float64)
    X = np.column_stack([cat, X])
    ref = ref_lgb.train(dict(BASE, num_leaves=31),
                        ref_lgb.Dataset(X, label=y,
                                        categorical_feature=[0]),
                        num_boost_round=6)
    assert any(t.num_cat > 0 for t in ref.inner.models)
    return X, ref


def _queries(X):
    rng = np.random.RandomState(2)
    Xq = X[rng.randint(0, len(X), 600)].copy()
    Xq[:40, 0] = np.nan
    Xq[40:80, 0] = -2.0
    Xq[80:120, 0] = 95.0           # unseen, past the LUT
    Xq[120:160, 0] = 36.0          # unseen, inside the bitset words
    Xq[160:200, 0] = 5.9           # truncated to 5
    return Xq


@pytest.mark.parametrize("lut", [False, True, "default"])
def test_stacked_forest_categorical_and_lut(lut):
    X, ref = _cat_sparse_model()
    Xq = _queries(X)
    port = lgb.Booster(model_str=ref.model_to_string(),
                       params={"device_type": "cpu"})
    if lut == "default":
        # the port builds the compare encoding unless asked; the JAX
        # package's "auto" rule (F >= 32 and 2 U <= F) picks LUT nodes
        # for this model's first tree, which splits on few columns
        forest = StackedForest.from_gbdt(port)
        ref_forest = RefForest.from_gbdt(ref, lut="auto")
        assert not forest.lut_nodes
        assert RefForest.from_gbdt(ref, num_iteration=1, lut="auto").lut_nodes
        assert not StackedForest.from_gbdt(port, num_iteration=1).lut_nodes
        with pytest.raises(ValueError, match="lut must be True or False"):
            StackedForest.from_gbdt(port, lut="auto")
    else:
        forest = StackedForest.from_gbdt(port, lut=lut)
        ref_forest = RefForest.from_gbdt(ref, lut=lut)
        assert forest.lut_nodes == ref_forest.lut_nodes == lut
    host_leaves = port.predict(Xq, pred_leaf=True, predict_on_device=False)
    np.testing.assert_array_equal(forest.leaves(Xq), host_leaves)
    np.testing.assert_array_equal(ref_forest.leaves(Xq), host_leaves)
    host = port.predict(Xq, raw_score=True, predict_on_device=False)
    np.testing.assert_array_equal(forest.predict_raw(Xq), host)
    np.testing.assert_array_equal(forest.predict(Xq),
                                  port.predict(Xq, predict_on_device=False))
    np.testing.assert_array_equal(host, ref.predict(Xq, raw_score=True))
    # f64 rows the f32 grid cannot hold take the double-double path
    X64 = Xq.copy()
    X64[:, 1] += 1e-9
    np.testing.assert_array_equal(
        forest.leaves(X64),
        port.predict(X64, pred_leaf=True, predict_on_device=False))
    dev = forest.predict_raw_device(Xq).numpy()[:, 0]
    np.testing.assert_allclose(dev, host, rtol=0, atol=1e-5)


def test_booster_predicts_sparse_input():
    X, y = _sparse_onehot_data()
    bst = lgb.train(dict(BASE, device_type="cpu"),
                    lgb.Dataset(sp.csr_matrix(X), label=y),
                    num_boost_round=3)
    np.testing.assert_array_equal(bst.predict(sp.csr_matrix(X[:300])),
                                  bst.predict(X[:300]))
