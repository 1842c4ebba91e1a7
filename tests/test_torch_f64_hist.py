"""f64 histograms (``tpu_use_f64_hist``, or ``gpu_use_dp``) in the port
against the JAX package, on the CPU.

The reference sums f32 rows in f64 and rounds the histogram once to f32
(``lightgbm_tpu/ops/histogram.py::build_histogram`` and
``_segment_histogram``, which need ``jax_enable_x64``; the reference
runs here inside ``jax.enable_x64(True)``); the learner then works in
f32. The port does the same with torch's f64 (no switch needed).

- Level (a): the f64-summed histogram is byte-equal to the reference's
  over uint8 and uint16 bins, with and without a row-index list (both
  add in row order in f64 and round once).
- Level (b): trees with f64 histograms make the reference's splits with
  its leaf counts (plain, EFB-bundled, ``max_bin`` 1023, multiclass),
  and the held-out metric agrees within 1e-4 every round.
- The setting: ``gpu_use_dp`` asks for the same; both are ignored, with
  the reference's warning, under quantized gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as ref_lgb
from lightgbm_tpu.ops.histogram import _segment_histogram

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops import histogram as H

torch.set_num_threads(1)


@pytest.mark.parametrize("with_idx", [False, True])
@pytest.mark.parametrize("B,dtype", [(64, np.uint8), (256, np.uint8),
                                     (1024, np.uint16)])
def test_f64_histogram_byte_equal_to_reference(B, dtype, with_idx):
    rng = np.random.RandomState(B)
    S, F = 5000, 8
    bins = rng.randint(0, B, size=(S, F)).astype(dtype)
    gh = np.stack([rng.randn(S) * 1e3, rng.rand(S), np.ones(S), np.ones(S)],
                  axis=1).astype(np.float32)
    idx = np.sort(rng.permutation(S)[:S // 3]).astype(np.int32)
    rb, rg = (bins[idx], gh[idx]) if with_idx else (bins, gh)
    with jax.enable_x64(True):
        ref = np.asarray(_segment_histogram(
            jnp.asarray(rb), jnp.asarray(rg).astype(jnp.float64), B))
    got = H.build_histogram(torch.from_numpy(bins), torch.from_numpy(gh), B,
                            torch.from_numpy(idx) if with_idx else None,
                            f64=True)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert np.array_equal(got.numpy().view(np.int32), ref.view(np.int32))
    # it is the f64 sum rounded once, which the f32 sum is not always
    f32 = H.build_histogram(torch.from_numpy(bins), torch.from_numpy(gh), B,
                            torch.from_numpy(idx) if with_idx else None)
    exact = H.histogram_plain(torch.from_numpy(bins),
                              torch.from_numpy(gh).double(), B,
                              torch.from_numpy(idx) if with_idx else None)
    assert torch.equal(got, exact.float())
    assert not torch.equal(f32, got)


def _data(seed=0, n=3000):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    X[rng.rand(n) < 0.1, 2] = np.nan
    X[rng.rand(n) < 0.3, 3] = 0.0
    y = (X[:, 0] + 0.7 * X[:, 1] + 0.3 * rng.randn(n) > 0).astype(float)
    return X, y


def _bundled(seed=0, n=3000):
    X, _ = _data(seed, n)
    rng = np.random.RandomState(seed + 200)
    sparse = np.zeros((n, 12))
    choice = rng.randint(0, 16, n)
    rows = np.nonzero(choice < 12)[0]
    sparse[rows, choice[rows]] = rng.rand(len(rows)) + 0.5
    logit = (X[:, 0] + 0.8 * (sparse[:, 0] > 0) - 0.6 * (sparse[:, 5] > 0)
             + 0.3 * rng.randn(n))
    return np.column_stack([X, sparse]), (logit > 0).astype(float)


def _multiclass(seed=0, n=3000):
    X, _ = _data(seed, n)
    return X, np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.5, 0.5]).astype(
        float)


def _splits(tree):
    ni = tree.num_internal
    return (tree.num_leaves, tree.split_feature[:ni].tolist(),
            tree.threshold[:ni].tolist(),
            tree.leaf_count[:tree.num_leaves].tolist())


CASES = {
    "binary": (_data, {"objective": "binary", "metric": "auc"}),
    "bundled": (_bundled, {"objective": "binary", "metric": "auc"}),
    "wide1023": (_data, {"objective": "binary", "metric": "auc",
                         "max_bin": 1023}),
    "multiclass": (_multiclass, {"objective": "multiclass", "num_class": 3,
                                 "metric": "multi_logloss"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_f64_trees_match_reference(case):
    data, params = CASES[case]
    X, y = data()
    Xv, yv = data(seed=1, n=1500)
    params = dict(params, num_leaves=15, verbose=-1, tpu_use_f64_hist=True)
    metric = params["metric"]
    ref_hist, port_hist = {}, {}
    with jax.enable_x64(True):
        rd = ref_lgb.Dataset(X, label=y)
        ref = ref_lgb.train(params, rd, num_boost_round=8,
                            valid_sets=[ref_lgb.Dataset(Xv, label=yv,
                                                        reference=rd)],
                            callbacks=[ref_lgb.record_evaluation(ref_hist)])
    pd = lgb.Dataset(X, label=y)
    port = lgb.train(dict(params, device_type="cpu"), pd, num_boost_round=8,
                     valid_sets=[lgb.Dataset(Xv, label=yv, reference=pd)],
                     callbacks=[lgb.record_evaluation(port_hist)])
    assert port.inner.learner._f64
    assert port.inner.learner._bundled == (case == "bundled")
    for i, (a, b) in enumerate(zip(ref.inner.models, port.inner.models)):
        assert _splits(a) == _splits(b), "tree %d differs" % i
    np.testing.assert_allclose(port_hist["valid_0"][metric],
                               ref_hist["valid_0"][metric], rtol=0,
                               atol=1e-4)


def test_gpu_use_dp_asks_for_f64_and_quantized_ignores_both(capsys):
    assert Config.from_params({"gpu_use_dp": True}).f64_histograms
    assert Config.from_params({"tpu_use_f64_hist": True}).f64_histograms
    assert not Config.from_params({}).f64_histograms
    X, y = _data()
    for key in ("gpu_use_dp", "tpu_use_f64_hist"):
        capsys.readouterr()
        bst = lgb.train({"objective": "binary", "num_leaves": 7,
                         "verbose": 0, "device_type": "cpu", key: True,
                         "use_quantized_grad": True},
                        lgb.Dataset(X, label=y), num_boost_round=1)
        assert not bst.inner.learner._f64
        assert "ignored under use_quantized_grad" in capsys.readouterr().err
        dp = lgb.train({"objective": "binary", "num_leaves": 7,
                        "verbose": -1, "device_type": "cpu", key: True},
                       lgb.Dataset(X, label=y), num_boost_round=1)
        assert dp.inner.learner._f64
