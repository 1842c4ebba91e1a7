"""The port's gradient quantizer against the JAX package's.

Parity level (a), byte-equal throughout: ``quantize_gh`` integers and
scales, ``effective_quant_max``, ``dequantize_sums``/``dequantize_hist``,
integer histograms (against the reference's segment-sum and against the
Pallas kernel body's int8 form in interpret mode) and the integer
sibling subtraction. Integer sums do not depend on order, so nothing
here has a tolerance.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lightgbm_tpu.ops import quantize as RQ
from lightgbm_tpu.ops.histogram import _hist_kernel_body, _segment_histogram
from lightgbm_tpu_torch.ops import histogram as H
from lightgbm_tpu_torch.ops import quantize as Q
from lightgbm_tpu_torch.utils import prng

torch.set_num_threads(1)


def _grads(n, seed, zero=False):
    rng = np.random.RandomState(seed)
    g = (rng.randn(n) * rng.exponential(2.0, n)).astype(np.float32)
    h = (rng.rand(n) * 0.25).astype(np.float32)
    ind = (rng.rand(n) < 0.7).astype(np.float32)
    if zero:
        g[:] = 0.0
    return g, h, ind


def _both(g, h, ind, bits, seed=3, tree_no=2):
    n = g.shape[0]
    qmax = RQ.effective_quant_max(bits, n)
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), tree_no)
    ref_gh, ref_qs = RQ.quantize_gh(jnp.asarray(g), jnp.asarray(h),
                                    jnp.asarray(ind), kj, qmax,
                                    RQ.quant_dtype(bits))
    kt = Q.tree_key(prng.PRNGKey(seed), tree_no)
    gh, qs = Q.quantize_gh(torch.from_numpy(g), torch.from_numpy(h),
                           torch.from_numpy(ind), kt, qmax,
                           Q.quant_dtype(bits))
    return (np.asarray(ref_gh), np.asarray(ref_qs)), (gh.numpy(), qs.numpy())


@pytest.mark.parametrize("n", [1, 1000, 4099])
@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_gh_byte_equal(bits, n):
    (ref_gh, ref_qs), (gh, qs) = _both(*_grads(n, seed=n), bits)
    assert gh.dtype == ref_gh.dtype and gh.shape == (n, 4)
    assert np.array_equal(gh, ref_gh)
    assert np.array_equal(qs.view(np.int32), ref_qs.view(np.int32))


def test_quantize_gh_zero_gradients():
    """All-zero gradients: the scale floors at 1e-30 / qmax and every
    row quantizes to 0 or 1 from the draw alone, as in the reference."""
    (ref_gh, ref_qs), (gh, qs) = _both(*_grads(500, seed=2, zero=True), 8)
    assert np.array_equal(gh, ref_gh)
    assert np.array_equal(qs.view(np.int32), ref_qs.view(np.int32))


@pytest.mark.parametrize("bits", [8, 16])
def test_effective_quant_max_grid(bits):
    rows = [1, 1000, 65535, 65536, 65537, 200_000, 10_500_000,
            16_909_320, 16_909_321, 2 ** 31, 2 ** 40]
    for n in rows:
        assert Q.effective_quant_max(bits, n) == \
            RQ.effective_quant_max(bits, n), n
    assert Q.effective_quant_max(16, 10_500_000) == 204
    assert Q.quant_dtype(bits) == (torch.int8 if bits == 8 else torch.int16)
    assert Q.acc_dtype(Q.quant_dtype(bits)) == torch.int32
    assert RQ.acc_dtype(RQ.quant_dtype(bits)) == jnp.int32


def test_dequantize_sums_and_hist_byte_equal():
    rng = np.random.RandomState(4)
    hist = rng.randint(-10 ** 8, 10 ** 8, size=(6, 32, 4)).astype(np.int32)
    sums = hist.sum(axis=(0, 1), dtype=np.int32)
    qs = np.array([3.1e-3, 7.7e-5], dtype=np.float32)
    got_h = Q.dequantize_hist(torch.from_numpy(hist), torch.from_numpy(qs))
    want_h = np.asarray(RQ.dequantize_hist(jnp.asarray(hist),
                                           jnp.asarray(qs)))
    assert got_h.dtype == torch.float32
    assert np.array_equal(got_h.numpy().view(np.int32),
                          want_h.view(np.int32))
    got_s = Q.dequantize_sums(torch.from_numpy(sums), torch.from_numpy(qs))
    want_s = np.asarray(RQ.dequantize_sums(jnp.asarray(sums),
                                           jnp.asarray(qs)))
    assert np.array_equal(got_s.numpy().view(np.int32),
                          want_s.view(np.int32))
    f = torch.from_numpy(hist.astype(np.float32))
    assert Q.dequantize_hist(f, torch.from_numpy(qs)) is f


@pytest.mark.parametrize("bits", [8, 16])
def test_integer_histogram_byte_equal_to_segment_sum(bits):
    """int8 and int16 rows accumulate into int32 on both sides (the
    reference's default, x64 off)."""
    g, h, ind = _grads(3000, seed=5)
    _, (gh, _) = _both(g, h, ind, bits)
    bins = np.random.RandomState(6).randint(0, 64, size=(3000, 8)).astype(
        np.uint8)
    ref = np.asarray(_segment_histogram(jnp.asarray(bins), jnp.asarray(gh),
                                        64))
    got = H.build_histogram(torch.from_numpy(bins), torch.from_numpy(gh), 64)
    assert got.dtype == torch.int32 and ref.dtype == np.int32
    assert np.array_equal(got.numpy(), ref)


def test_int8_pallas_body_interpret_byte_equal():
    """The TPU kernel's int8 form (``_hist_kernel_body``, int8 x int8
    into int32) run by ``pl.pallas_call(..., interpret=True)`` equals the
    port's plain int8 histogram byte for byte."""
    S, F, B, C, T = 4096, 8, 256, 4, 2048
    H_ = -(-B // 16)
    g, h, ind = _grads(S, seed=7)
    _, (gh, _) = _both(g, h, ind, 8)
    bins = np.random.RandomState(8).randint(0, B, size=(S, F)).astype(
        np.uint8)
    kernel = functools.partial(_hist_kernel_body, T, F, H_, C)
    out = pl.pallas_call(
        kernel, grid=(S // T,),
        in_specs=[pl.BlockSpec((T, F), lambda i: (i, 0)),
                  pl.BlockSpec((T, C), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((F * H_, 16 * C), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((F * H_, 16 * C), jnp.int32),
        interpret=True)(jnp.asarray(bins), jnp.asarray(gh))
    ref = np.asarray(out).reshape(F, H_ * 16, C)[:, :B, :]
    got = H.build_histogram(torch.from_numpy(bins), torch.from_numpy(gh), B)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("bits", [8, 16])
def test_integer_sibling_subtraction_exact(bits):
    g, h, ind = _grads(2500, seed=9)
    _, (gh, _) = _both(g, h, ind, bits)
    bins = np.random.RandomState(10).randint(0, 32, size=(2500, 8)).astype(
        np.uint8)
    tb, tg = torch.from_numpy(bins), torch.from_numpy(gh)
    left = np.random.RandomState(11).rand(2500) < 0.3
    idx = torch.from_numpy(np.nonzero(left)[0].astype(np.int32))
    parent = H.build_histogram(tb, tg, 32)
    small = H.build_histogram(tb, tg, 32, idx)
    right = H.build_histogram(tb[~torch.from_numpy(left)],
                              tg[~torch.from_numpy(left)], 32)
    assert torch.equal(H.subtract_histogram(parent, small), right)
    assert torch.equal(Q.sum_gh(tg), parent[0].sum(dim=0))
