"""Wide bins (``max_bin`` > 255: uint16 bin matrices and histograms of
B = 512 to 4096 bins) in the port against the JAX package, on the CPU.

- Level (a): bin mappers (upper bounds, missing types, default bins)
  and the uint16 bin matrix byte-equal at ``max_bin`` 511 and 1023, for
  NaN, zero-as-missing and categorical columns, for CSR input and for
  ``max_bin_by_feature`` with entries above 255; uint16 bundle columns
  (an EFB bundle of more than 256 bins) byte-equal; the reference's
  mappers and bundle layout carried across (``convert.py``) give the
  same bytes; integer histograms over uint16 bins equal the reference's
  ``build_histogram``; the TPU kernel's int8 body at B = 512 over uint16 bins
  (``pl.pallas_call(..., interpret=True)``) equals the port's plain
  version byte for byte, its f32 body within 1e-5.
- Level (b): trees at ``max_bin`` 1023 (f32, 8-bit, bundled) make the
  reference's splits with its leaf counts, and the held-out AUC agrees
  within 1e-4 every round. The rows are 10,000, about 10 to a bin: at
  3,000 (3 to a bin) two adjacent thresholds of one feature tie within
  the f32 rounding of the gain. With the reference's gradients as
  ``fobj`` the bundled trees are the same (the ``exp`` fact of ROADMAP
  queue 3), and where the 8-bit trees part, the reference's own scan
  run eagerly on the port's histogram gives the port's split bit for
  bit, and jitted the reference's (the FMA fact).
- Round trips: model text and the stacked forest of a wide-bin model
  equal the host walk byte for byte.
- The kernel's launch plan (plain Python) for uint16 bins: every
  (feature, slab) pair in exactly one group (256-bin slabs for float
  rows, whole features where they fit for integer rows), every shape in
  shared memory.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.experimental import pallas as pl

import lightgbm_tpu as ref_lgb
import lightgbm_tpu.config as ref_config
import lightgbm_tpu.io.dataset as ref_dataset
import lightgbm_tpu.objective as ref_objective
from lightgbm_tpu.ops import quantize as RQ
from lightgbm_tpu.ops import split as ref_split
from lightgbm_tpu.ops.histogram import _hist_kernel_body
from lightgbm_tpu.ops.histogram import build_histogram as ref_histogram

import lightgbm_tpu_torch as lgb
import lightgbm_tpu_torch.config as port_config
import lightgbm_tpu_torch.io.dataset as port_dataset
import lightgbm_tpu_torch.treelearner.serial as serial
from lightgbm_tpu_torch.convert import (bin_mappers_from_numpy,
                                        bundle_layout_from_numpy)
from lightgbm_tpu_torch.ops import histogram as H
from lightgbm_tpu_torch.ops import split as S
from lightgbm_tpu_torch.serve import StackedForest, cache
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)


def _columns(seed=0, n=4000):
    """Five columns: > 1023 distinct values (with NaN), many zeros,
    positive only, 400 categories, few distinct values."""
    rng = np.random.RandomState(seed)
    X = np.empty((n, 5))
    X[:, 0] = rng.randn(n)
    X[rng.rand(n) < 0.1, 0] = np.nan
    X[:, 1] = np.round(rng.randn(n) * 200)
    X[:, 2] = rng.exponential(size=n)
    X[:, 3] = rng.randint(0, 400, size=n)
    X[:, 4] = rng.randint(0, 40, size=n) / 4.0
    return X


def _both(X, params, **kw):
    ref = ref_dataset.BinnedDataset.from_matrix(
        X, ref_config.Config.from_params(params), label=np.zeros(X.shape[0]),
        **kw)
    port = port_dataset.BinnedDataset.from_matrix(
        X, port_config.Config.from_params(dict(params, device_type="cpu")),
        label=np.zeros(X.shape[0]), **kw)
    return ref, port


def _same_bins(ref, port):
    assert ref.used_feature_map == port.used_feature_map
    for a, b in zip(ref.bin_mappers, port.bin_mappers):
        assert a.num_bin == b.num_bin
        assert a.missing_type == b.missing_type
        assert a.default_bin == b.default_bin
        assert a.bin_upper_bound.tobytes() == b.bin_upper_bound.tobytes()
        assert a.feature_info() == b.feature_info()
    assert ref.bins.dtype == port.bins.dtype
    assert ref.bins.tobytes() == port.bins.tobytes()


@pytest.mark.parametrize("kind", ["nan", "zero_as_missing", "categorical"])
@pytest.mark.parametrize("max_bin", [511, 1023])
def test_wide_bins_byte_equal(max_bin, kind):
    X = _columns()
    params = {"verbose": -1, "enable_bundle": False, "max_bin": max_bin,
              "min_data_in_bin": 1}
    kw = {}
    if kind == "zero_as_missing":
        params["zero_as_missing"] = True
    if kind == "categorical":
        kw["categorical_feature"] = [3]
    ref, port = _both(X, params, **kw)
    _same_bins(ref, port)
    assert port.bins.dtype == np.uint16 and port.max_num_bin > 256


@pytest.mark.parametrize("max_bin", [511, 1023])
def test_sparse_wide_bins_equal_dense(max_bin):
    X = _columns(seed=1)
    X[np.random.RandomState(2).rand(*X.shape) < 0.5] = 0.0
    params = {"verbose": -1, "enable_bundle": False, "max_bin": max_bin,
              "min_data_in_bin": 1}
    ref, port = _both(X, params)
    _, sparse = _both(sp.csr_matrix(X), params)
    _same_bins(ref, port)
    assert sparse.bins.tobytes() == port.bins.tobytes()


def test_max_bin_by_feature_above_255():
    X = _columns(seed=3)
    params = {"verbose": -1, "enable_bundle": False, "min_data_in_bin": 1,
              "max_bin_by_feature": [1023, 300, 255, 511, 63]}
    ref, port = _both(X, params)
    _same_bins(ref, port)
    assert [m.num_bin for m in port.bin_mappers][:2] == \
        [m.num_bin for m in ref.bin_mappers][:2]
    assert port.bins.dtype == np.uint16


def _bundle_columns(seed=4, n=3000):
    """A dense 400-value column and two mutually exclusive sparse columns
    of 150 values each: at max_bin 511 they bundle into one column of
    299 bins."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 3))
    X[:150, 0] = np.arange(1, 151)
    X[150:300, 1] = np.arange(1, 151)
    X[:, 2] = rng.randint(0, 400, n)
    return X


def test_uint16_bundle_columns_and_carried_layout():
    X = _bundle_columns()
    params = {"verbose": -1, "max_bin": 511, "min_data_in_bin": 1}
    ref, port = _both(X, params)
    assert port.bundle.groups == ref.bundle.groups
    assert port.bundle.num_bundled_bins == ref.bundle.num_bundled_bins > 256
    _same_bins(ref, port)
    # the reference's mappers and layout carried across bin to its bytes
    dicts = [None] * X.shape[1]
    for j, f in enumerate(ref.used_feature_map):
        dicts[f] = ref.bin_mappers[j].to_dict()
    carried = port_dataset.BinnedDataset.from_matrix(
        X, port_config.Config.from_params(dict(params, device_type="cpu")),
        mappers=bin_mappers_from_numpy(dicts),
        bundle=bundle_layout_from_numpy(ref.bundle))
    assert carried.bins.dtype == np.uint16
    assert carried.bins.tobytes() == ref.bins.tobytes()


@pytest.mark.parametrize("bits", [8, 16])
def test_integer_histogram_on_uint16_bins_equals_reference(bits):
    rng = np.random.RandomState(5)
    S, F, B = 3000, 8, 1024
    bins = rng.randint(0, B, size=(S, F)).astype(np.uint16)
    g = rng.randn(S).astype(np.float32)
    h = rng.rand(S).astype(np.float32)
    ind = np.ones(S, dtype=np.float32)
    qmax = RQ.effective_quant_max(bits, S)
    gh, _ = RQ.quantize_gh(jnp.asarray(g), jnp.asarray(h), jnp.asarray(ind),
                           jax.random.PRNGKey(3), qmax, RQ.quant_dtype(bits))
    gh = np.asarray(gh)
    ref = np.asarray(ref_histogram(jnp.asarray(bins), jnp.asarray(gh), B))
    got = H.build_histogram(torch.from_numpy(bins), torch.from_numpy(gh), B)
    assert got.dtype == torch.int32 and ref.dtype == np.int32
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kind", ["int8", "f32"])
def test_pallas_body_on_uint16_bins_interpret(kind):
    """The TPU kernel (``_hist_kernel_body``) at B = 512 over uint16 bins,
    in interpret mode: int8 rows byte-equal to the port's plain version,
    f32 rows within 1e-5 absolute (the body sums each tile as a matmul,
    in another order)."""
    S, F, B, C, T = 4096, 8, 512, 4, 2048
    H_ = -(-B // 16)
    rng = np.random.RandomState(6)
    bins = rng.randint(0, B, size=(S, F)).astype(np.uint16)
    if kind == "int8":
        gh = rng.randint(-127, 128, size=(S, C)).astype(np.int8)
        out_dtype = jnp.int32
    else:
        gh = rng.randn(S, C).astype(np.float32)
        out_dtype = jnp.float32
    kernel = functools.partial(_hist_kernel_body, T, F, H_, C)
    out = pl.pallas_call(
        kernel, grid=(S // T,),
        in_specs=[pl.BlockSpec((T, F), lambda i: (i, 0)),
                  pl.BlockSpec((T, C), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((F * H_, 16 * C), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((F * H_, 16 * C), out_dtype),
        interpret=True)(jnp.asarray(bins), jnp.asarray(gh))
    ref = np.asarray(out).reshape(F, H_ * 16, C)[:, :B, :]
    got = H.build_histogram(torch.from_numpy(bins), torch.from_numpy(gh), B)
    if kind == "int8":
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def _train_data(seed=0, n=3000):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    X[rng.rand(n) < 0.1, 2] = np.nan
    y = (X[:, 0] + 0.7 * X[:, 1] + 0.3 * rng.randn(n) > 0).astype(float)
    return X, y


def _bundled_train_data(seed=0, n=3000):
    """_train_data() plus 12 mutually exclusive sparse columns of 51
    values each: at max_bin 1023 they bundle into a column of more than
    256 bins."""
    X, _ = _train_data(seed, n)
    rng = np.random.RandomState(seed + 200)
    sparse = np.zeros((n, 12))
    choice = rng.randint(0, 16, n)
    rows = np.nonzero(choice < 12)[0]
    sparse[rows, choice[rows]] = np.round(rng.rand(len(rows)) * 50) / 50 \
        + 0.5
    logit = (X[:, 0] + 0.8 * (sparse[:, 0] > 0) - 0.6 * (sparse[:, 5] > 0)
             + 0.3 * rng.randn(n))
    return np.column_stack([X, sparse]), (logit > 0).astype(float)


def _splits(tree):
    ni = tree.num_internal
    return (tree.num_leaves, tree.split_feature[:ni].tolist(),
            tree.threshold[:ni].tolist(),
            tree.leaf_count[:tree.num_leaves].tolist())


WIDE = {
    "f32": {},
    "quant8": {"use_quantized_grad": True},
    "bundled": {"data": "bundled"},
    "max_bin_by_feature": {"max_bin_by_feature": [1023, 300, 255, 511,
                                                  63, 255, 255, 255]},
}


@pytest.mark.parametrize("case", sorted(WIDE))
def test_wide_bin_trees_match_reference(case):
    params = dict(WIDE[case])
    data = _bundled_train_data if params.pop("data", None) else _train_data
    X, y = data(n=10_000)
    Xv, yv = data(seed=1, n=1500)
    params = dict(params, objective="binary", metric="auc", num_leaves=15,
                  max_bin=1023, min_data_in_bin=1, verbose=-1)
    ref_hist, port_hist = {}, {}
    rd = ref_lgb.Dataset(X, label=y)
    ref = ref_lgb.train(params, rd, num_boost_round=10,
                        valid_sets=[ref_lgb.Dataset(Xv, label=yv,
                                                    reference=rd)],
                        callbacks=[ref_lgb.record_evaluation(ref_hist)])
    pd = lgb.Dataset(X, label=y)
    port = lgb.train(dict(params, device_type="cpu"), pd,
                     num_boost_round=10,
                     valid_sets=[lgb.Dataset(Xv, label=yv, reference=pd)],
                     callbacks=[lgb.record_evaluation(port_hist)])
    learner = port.inner.learner
    assert learner.bins.dtype == torch.uint16
    assert learner._bundled == (case == "bundled")
    assert (learner.Bg if learner._bundled else learner.B) > 256
    for i, (a, b) in enumerate(zip(ref.inner.models, port.inner.models)):
        assert _splits(a) == _splits(b), "tree %d differs" % i
    np.testing.assert_allclose(port_hist["valid_0"]["auc"],
                               ref_hist["valid_0"]["auc"], rtol=0,
                               atol=1e-4)


def _reference_gradients(y):
    """fobj giving the reference's own binary gradients (its objective,
    its ``exp``) at the scores it is handed: the same numbers for both
    packages."""
    cfg = ref_config.Config.from_params({"objective": "binary"})
    obj = ref_objective.create_objective("binary", cfg)
    md = ref_dataset.Metadata(len(y))
    md.set_label(y)
    obj.init(md, len(y))

    def fobj(preds, _):
        g, h = obj.get_gradients(jnp.asarray(np.asarray(preds, np.float32)))
        return np.asarray(g, np.float32), np.asarray(h, np.float32)
    return fobj


@pytest.mark.parametrize("case", ["bundled", "quant8"])
def test_wide_bin_ties_at_3000_rows_are_the_references(case, monkeypatch):
    """At 3,000 rows (3 to a bin) the two packages' trees differ at
    near-ties (ROADMAP queue 3). With the reference's gradients passed
    as ``fobj`` to both packages:

    - bundled f32: the trees are the same: the difference came from
      the gradients (XLA's ``exp``, the fact of queue 3);
    - 8-bit: the trees may still part at a split whose two best
      thresholds tie within f32 rounding. There, the port's scan record
      equals the reference's own ``find_best_split`` run eagerly on the
      port's leaf histogram, bit for bit; the reference's training step
      runs the scan jitted (XLA fuses the gain into FMAs, the fact of
      queue 3), and jitted it takes the other threshold, at a gain
      within 1e-6 relative."""
    params = dict(WIDE[case])
    data = _bundled_train_data if params.pop("data", None) else _train_data
    X, y = data(n=3000)
    params = dict(params, objective="none", num_leaves=15, max_bin=1023,
                  min_data_in_bin=1, verbose=-1)
    scans = []
    real = serial.find_best_split

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        scans[-1].append((args, out.clone()))
        return out
    monkeypatch.setattr(serial, "find_best_split", spy)
    ref = ref_lgb.Booster(params, ref_lgb.Dataset(X, label=y))
    port = lgb.Booster(dict(params, device_type="cpu",
                            tpu_fused_tree=False), lgb.Dataset(X, label=y))
    fr, fp = _reference_gradients(y), _reference_gradients(y)
    for it in range(10):
        scans.append([])
        ref.update(fobj=fr)
        port.update(fobj=fp)
        a, b = ref.inner.models[it], port.inner.models[it]
        if _splits(a) == _splits(b):
            continue
        assert case == "quant8", "tree %d differs" % it
        k = next(k for k in range(min(a.num_internal, b.num_internal))
                 if (a.split_feature[k], a.threshold[k])
                 != (b.split_feature[k], b.threshold[k]))
        # the port's scan of that split, and the reference's scan of
        # the same histogram, eager and jitted
        args, rec = next(
            (args, rec) for args, rec in scans[it]
            if int(rec[S.FEATURE]) == int(b.split_feature[k])
            and np.float32(float(rec[S.GAIN])) == np.float32(
                b.split_gain[k]))
        hist, sg, sh, sc, stc, meta, _, mask, parent, qscale = args[:10]
        F = len(meta.num_bin)
        rmeta = ref_split.FeatureMeta(
            num_bin=jnp.asarray(meta.num_bin.numpy()),
            missing_type=jnp.asarray(meta.missing_type.numpy()),
            zero_bin=jnp.asarray(meta.zero_bin.numpy()),
            is_categorical=jnp.zeros(F, bool),
            use_onehot=jnp.zeros(F, bool), monotone=jnp.zeros(F, jnp.int8))
        rp = ref_split.SplitParams.from_config(
            ref_config.Config.from_params(dict(params, objective="binary")))

        def scan(h, g, hs, c, t, m, po, q):
            return ref_split.find_best_split(
                h, g, hs, c, t, rmeta, rp, m, parent_output=po,
                has_categorical=False, hist_scale=q)
        inputs = (jnp.asarray(hist.numpy()),
                  *[jnp.float32(float(v)) for v in (sg, sh, sc, stc)],
                  jnp.asarray(mask.numpy()), jnp.float32(float(parent)),
                  jnp.asarray(qscale.numpy()))
        eager, jitted = scan(*inputs), jax.jit(scan)(*inputs)
        assert int(eager.feature) == int(rec[S.FEATURE])
        assert int(eager.threshold_bin) == int(rec[S.THRESHOLD_BIN])
        assert np.float32(eager.gain) == np.float32(float(rec[S.GAIN]))
        assert int(jitted.feature) == int(a.split_feature[k])
        assert np.float32(jitted.gain) == np.float32(a.split_gain[k])
        assert abs(int(jitted.threshold_bin) - int(eager.threshold_bin)) == 1
        assert abs(float(jitted.gain) - float(eager.gain)) <= \
            1e-6 * abs(float(eager.gain))
        return


def test_wide_bin_model_round_trips(monkeypatch):
    """The text of a max_bin 1023 model loads to the same predictions,
    and its stacked forest (raw rows quantized against the model's
    thresholds) equals the host walk byte for byte, f64 rows too (the
    double-double compare, in chunks cut so that the [rows, features,
    thresholds] compare stays under its cap however many thresholds a
    wide-bin model has)."""
    X, y = _train_data()
    bst = lgb.train({"objective": "binary", "num_leaves": 31,
                     "max_bin": 1023, "verbose": -1, "device_type": "cpu"},
                    lgb.Dataset(X, label=y), num_boost_round=5)
    host = bst.predict(X, predict_on_device=False)
    np.testing.assert_array_equal(bst.predict(X, predict_on_device=True),
                                  host)
    np.testing.assert_array_equal(
        bst.predict(X, pred_leaf=True, predict_on_device=True),
        bst.predict(X, pred_leaf=True, predict_on_device=False))
    again = lgb.Booster(model_str=bst.model_to_string(),
                        params={"device_type": "cpu"})
    np.testing.assert_array_equal(again.predict(X), host)
    forest = StackedForest.from_gbdt(bst)
    used, most = forest._qt_dd.thr_hi.shape
    assert cache.dd_chunk_rows(forest) == cache.kDDBucketCap
    monkeypatch.setattr(cache, "kDDCompareCap", used * most * 100)
    assert cache.dd_chunk_rows(forest) == 64
    X64 = X + 1e-12
    pred = cache.BucketedPredictor(forest)
    np.testing.assert_array_equal(pred.predict(X64, output_kind="raw"),
                                  bst.predict(X64, raw_score=True,
                                              predict_on_device=False))
    assert pred.entries == {(0, 64, "raw", "dd"): -(-len(X) // 64)}


@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("gh_dtype", [torch.float32, torch.int8,
                                      torch.int16])
def test_launch_plan_covers_every_slab_once(gh_dtype, f64):
    """uint16 bins: each (feature, slab) pair lies in exactly one group,
    each group's features fit the staged tile row, every shape fits a
    block's shared memory, but f64 sums of more than 6 stat columns (16
    pairs of 256 f64 bins of 7 columns need 224 KB beside the tiles; the
    learner's rows have 4), which the plan refuses. Float rows take
    256-bin slabs in groups of 16 or 32 pairs; integer rows a whole
    feature per pair at every B here (one feature's [C, B] int32 fits at
    C <= 8 up to B = 4096), in groups of 1 to 32 pairs."""
    elt = torch.empty((), dtype=gh_dtype).element_size()
    for B in (257, 300, 512, 700, 1024, 2048, 4096):
        for Fp in (8, 32, 40, 136):
            for C in (1, 4, 8):
                if f64 and gh_dtype.is_floating_point and C > 6:
                    with pytest.raises(LightGBMError, match="does not fit"):
                        H.launch_plan(1000, Fp, B, C, gh_dtype, 132,
                                      torch.uint16, f64)
                    continue
                p = H.launch_plan(10_500_000, Fp, B, C, gh_dtype, 132,
                                  torch.uint16, f64)
                sb, slabs = p.slab_bins, p.slabs
                floating = gh_dtype.is_floating_point
                assert sb == (min(B, 256) if floating else B)
                assert slabs == -(-B // sb)
                fg = p.features_per_group
                assert fg in (H.GROUP_FEATURES if floating
                              else H.WHOLE_FEATURE_GROUPS)
                assert p.groups == -(-Fp * slabs // fg)
                pairs = [q for g in range(p.groups)
                         for q in range(g * fg, min((g + 1) * fg,
                                                    Fp * slabs))]
                assert pairs == list(range(Fp * slabs))
                for a, b in p.feature_ranges(Fp):
                    assert 0 < b - a <= p.stage_features
                acc = 8 if f64 and floating else 4
                # float rows take slab queues (64 4-byte entries a pair);
                # the accumulators are rounded up to 16 bytes (an odd
                # whole-feature SB in a group of fewer than 16 pairs)
                assert p.smem_bytes == -(-fg * sb * C * acc // 16) * 16 \
                    + 2 * p.tile_rows * (p.stage_features * 2 + C * elt) + (
                        fg * H.QUEUE_ENTRIES * 4 if floating else 0) \
                    <= H.MAX_SMEM
                assert p.tile_rows % 32 == 0
                assert H.MIN_TILE_ROWS <= p.tile_rows <= H.MAX_TILE_ROWS
                assert p.blocks * p.groups <= 132 or p.blocks == 1


@pytest.mark.parametrize("gh_dtype", [torch.int8, torch.int16])
def test_integer_plan_takes_whole_features(gh_dtype):
    """Integer rows over uint16 bins: one slab per feature wherever one
    feature's [C, B] int32 fits beside two tiles of ``MIN_TILE_ROWS``
    rows (B <= 8192 at C = 4, B <= 4096 at C = 8), else the largest
    power of two that fits; groups of 1, 2, 4, 8, 16 or
    32 pairs, each pair in exactly one group; at most 232,448 bytes a
    block by the kernel's formula; tile rows a multiple of 32 and at
    least ``MIN_TILE_ROWS``; row blocks of at least 256 rows, and the
    device-count entry plans the host's row blocks."""
    elt = torch.empty((), dtype=gh_dtype).element_size()
    for B in (257, 300, 512, 700, 1024, 2048, 4096, 8192, 16384, 65536):
        for Fp in (8, 32, 40, 136):
            for C in (1, 4, 8):
                p = H.launch_plan(10_500_000, Fp, B, C, gh_dtype, 132,
                                  torch.uint16)
                sb, fg = p.slab_bins, p.features_per_group
                tiles = 2 * H.MIN_TILE_ROWS * (2 + C * elt)

                def fits(n):
                    return -(-n * C * 4 // 16) * 16 + tiles <= H.MAX_SMEM
                if fits(B):
                    assert sb == B and p.slabs == 1
                else:
                    assert sb & (sb - 1) == 0 and sb < B
                    assert fits(sb) and not fits(2 * sb)
                    assert p.slabs == -(-B // sb)
                if C == 4:
                    assert (sb == B) == (B <= 8192)
                if C == 8:
                    assert (sb == B) == (B <= 4096)
                assert fg in (1, 2, 4, 8, 16, 32)
                assert p.groups == -(-Fp * p.slabs // fg)
                pairs = [q for g in range(p.groups)
                         for q in range(g * fg, min((g + 1) * fg,
                                                    Fp * p.slabs))]
                assert pairs == list(range(Fp * p.slabs))
                for a, b in p.feature_ranges(Fp):
                    assert 0 < b - a <= p.stage_features
                assert p.smem_bytes == -(-fg * sb * C * 4 // 16) * 16 \
                    + 2 * p.tile_rows * (p.stage_features * 2 + C * elt) \
                    <= H.MAX_SMEM == 232448
                assert p.tile_rows % 32 == 0
                assert H.MIN_TILE_ROWS <= p.tile_rows <= H.MAX_TILE_ROWS
                assert p.min_rows == H.MIN_ROWS_PER_BLOCK_WIDE == 256
                for n in (1, 257, 10_000, 100_000, 1_000_000):
                    q = H.launch_plan(n, Fp, B, C, gh_dtype, 132,
                                      torch.uint16)
                    assert q.blocks * q.rows_per_block >= n > \
                        (q.blocks - 1) * q.rows_per_block
                    assert H.device_plan(n, 132, q.groups, q.min_rows) == \
                        (q.blocks, q.rows_per_block)
    # the main path's shape: 8 whole features of 1024 bins a group, 4
    # groups at Fp = 32, as many as 256-bin slabs took
    p = H.launch_plan(10_500_000, 32, 1024, 4, gh_dtype, 132, torch.uint16)
    assert (p.groups, p.features_per_group, p.slabs) == (4, 8, 1)


@pytest.mark.parametrize("bins_dtype,f64", [(torch.uint16, False),
                                            (torch.uint16, True),
                                            (torch.uint8, True)])
def test_redesigned_plan_at_every_learner_shape(bins_dtype, f64):
    """The instances redesigned in slice 11 (f32 and f64 sums over uint16
    bins: slab queues; f64 sums over uint8 bins: 256-row blocks) at the
    learner's bin counts (powers of two) and the port's widths: every
    (feature, slab) pair in exactly one group, at most 232,448 bytes a
    block (with a slab queue of 64 4-byte entries per pair over uint16
    bins), at least ``MIN_TILE_ROWS`` tile rows of a multiple of 32 (a
    queued row offset fits its 16 bits), and row blocks at most one per
    SM across the groups, of at least 256 rows; the device-count entry
    plans the same blocks as the host."""
    Bs = (2, 16, 64, 256) if bins_dtype == torch.uint8 else \
        (512, 1024, 2048, 4096, 16384, 65536)
    for B in Bs:
        for Fp in (8, 16, 32, 40, 56, 136, 256):
            for C in (1, 4, 6):
                p = H.launch_plan(10_500_000, Fp, B, C, torch.float32, 132,
                                  bins_dtype, f64)
                fg, slabs = p.features_per_group, p.slabs
                pairs = [q for g in range(p.groups)
                         for q in range(g * fg, min((g + 1) * fg,
                                                    Fp * slabs))]
                assert pairs == list(range(Fp * slabs))
                queue = fg * H.QUEUE_ENTRIES * 4 \
                    if bins_dtype == torch.uint16 else 0
                assert p.smem_bytes == fg * p.slab_bins * C * (
                    8 if f64 else 4) + queue + 2 * p.tile_rows * (
                    p.stage_features * bins_dtype.itemsize + 4 * C)
                assert p.smem_bytes <= H.MAX_SMEM == 232448
                assert p.tile_rows % 32 == 0
                assert H.MIN_TILE_ROWS <= p.tile_rows <= H.MAX_TILE_ROWS \
                    < 1 << 16
                assert p.blocks * p.groups <= 132 or p.blocks == 1
                assert p.min_rows == H.MIN_ROWS_PER_BLOCK_WIDE == 256
                for n in (1, 257, 1025, 10_000, 100_000, 1_000_000):
                    q = H.launch_plan(n, Fp, B, C, torch.float32, 132,
                                      bins_dtype, f64)
                    assert q.blocks <= max(1, min(132 // q.groups,
                                                  -(-n // 256)))
                    assert q.blocks * q.rows_per_block >= n > \
                        (q.blocks - 1) * q.rows_per_block
                    assert H.device_plan(n, 132, q.groups, q.min_rows) == \
                        (q.blocks, q.rows_per_block)


@pytest.mark.parametrize("args,match", [
    ((100, 32, 1024, 7, torch.float32, 132, torch.uint16, True),
     "does not fit"),
    ((100, 32, 256, 7, torch.float32, 132, torch.uint8, True),
     "does not fit"),
    ((100, 32, 65537, 4, torch.float32, 132, torch.uint16, False),
     "at most 65536 bins"),
    ((100, 12, 1024, 4, torch.float32, 132, torch.uint16, True),
     "multiple of 8"),
    ((100, 32, 1024, 4, torch.float64, 132, torch.uint16, True),
     "float32 or int8")])
def test_redesigned_plan_rejects_bad_shapes(args, match):
    with pytest.raises(LightGBMError, match=match):
        H.launch_plan(*args)


def test_wide_kernel_argument_checks():
    """uint16 bins take up to 65536 bins, uint8 up to 256; other bin
    dtypes are refused before any launch (checked on CPU tensors)."""
    gh = torch.zeros((64, 4), dtype=torch.float32)
    wide = torch.zeros((64, 8), dtype=torch.int32).to(torch.uint16)
    H._check_cuda_args(wide, gh, 65536, None)
    with pytest.raises(LightGBMError, match="at most 65536 bins"):
        H._check_cuda_args(wide, gh, 65537, None)
    with pytest.raises(LightGBMError, match="at most 256 bins"):
        H._check_cuda_args(torch.zeros((64, 8), dtype=torch.uint8), gh, 512,
                           None)
    with pytest.raises(LightGBMError, match="uint8 or uint16"):
        H._check_cuda_args(torch.zeros((64, 8), dtype=torch.int32), gh, 64,
                           None)
