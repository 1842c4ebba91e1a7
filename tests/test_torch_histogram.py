"""The port's histogram op against the JAX package's.

``lightgbm_tpu_torch.ops.histogram`` sends CPU tensors to its plain
version (one flat ``index_add_``). Here it is held against
``lightgbm_tpu.ops.histogram._segment_histogram`` and against the Pallas
kernel body itself, run in interpret mode on the CPU. The CUDA kernel
runs only on a GPU (tests/test_torch_cuda.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lightgbm_tpu.ops.histogram import _hist_kernel_body, _segment_histogram
from lightgbm_tpu_torch.ops import histogram as H
from lightgbm_tpu_torch.ops.quantize import sum_gh
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)


def _inputs(S, F, B, C, seed, gh_dtype=np.float32):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(S, F)).astype(np.uint8)
    if gh_dtype == np.int8:
        gh = rng.randint(-127, 128, size=(S, C)).astype(np.int8)
    else:
        gh = rng.randn(S, C).astype(np.float32)
        gh[:, C - 1] = 1.0
    return bins, gh


@pytest.mark.parametrize("S,F,B,C", [(4096, 8, 256, 4), (1000, 5, 37, 3),
                                     (777, 16, 64, 8)])
def test_plain_matches_segment_histogram_f32(S, F, B, C):
    """f32: within 1e-6 relative (both sum rows in row order, so in
    practice bit-equal)."""
    bins, gh = _inputs(S, F, B, C, seed=S)
    ref = np.asarray(_segment_histogram(jnp.asarray(bins), jnp.asarray(gh),
                                        B))
    got = H.build_histogram(torch.from_numpy(bins), torch.from_numpy(gh), B)
    assert got.dtype == torch.float32 and got.shape == (F, B, C)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("S,F,B", [(4096, 8, 256), (513, 3, 16)])
def test_plain_matches_segment_histogram_int8(S, F, B):
    """int8 rows accumulate into int32: integer sums, byte-equal."""
    bins, gh = _inputs(S, F, B, 4, seed=S + 1, gh_dtype=np.int8)
    ref = np.asarray(_segment_histogram(jnp.asarray(bins), jnp.asarray(gh),
                                        B))
    got = H.build_histogram(torch.from_numpy(bins), torch.from_numpy(gh), B)
    assert got.dtype == torch.int32 and ref.dtype == np.int32
    assert np.array_equal(got.numpy(), ref)


def test_plain_matches_pallas_body_interpret():
    """Against the TPU kernel's own body (``_hist_kernel_body``) run by
    ``pl.pallas_call(..., interpret=True)``: within 1e-5 absolute (the
    Pallas body sums each row tile as a matmul, in another order)."""
    S, F, B, C, T = 4096, 8, 256, 4, 2048
    H_ = -(-B // 16)
    bins, gh = _inputs(S, F, B, C, seed=11)
    kernel = functools.partial(_hist_kernel_body, T, F, H_, C)
    out = pl.pallas_call(
        kernel, grid=(S // T,),
        in_specs=[pl.BlockSpec((T, F), lambda i: (i, 0)),
                  pl.BlockSpec((T, C), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((F * H_, 16 * C), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((F * H_, 16 * C), jnp.float32),
        interpret=True)(jnp.asarray(bins), jnp.asarray(gh))
    ref = np.asarray(out).reshape(F, H_ * 16, C)[:, :B, :]
    got = H.build_histogram(torch.from_numpy(bins), torch.from_numpy(gh), B)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("gh_dtype", [np.float32, np.int8])
def test_row_index_list_equals_gathered_rows(gh_dtype):
    """The row-index variant sums exactly the listed rows."""
    S, F, B = 3000, 8, 128
    bins, gh = _inputs(S, F, B, 4, seed=5, gh_dtype=gh_dtype)
    idx = np.sort(np.random.RandomState(6).choice(S, 1234, replace=False))
    tb, tg = torch.from_numpy(bins), torch.from_numpy(gh)
    got = H.build_histogram(tb, tg, B,
                            torch.from_numpy(idx.astype(np.int32)))
    want = H.build_histogram(tb[idx], tg[idx], B)
    assert torch.equal(got, want)


def test_zero_gh_padding_rows_vanish():
    S, F, B = 2000, 8, 64
    bins, gh = _inputs(S, F, B, 4, seed=8)
    pad_bins = np.random.RandomState(9).randint(0, B, size=(500, F)).astype(
        np.uint8)
    base = H.build_histogram(torch.from_numpy(bins), torch.from_numpy(gh), B)
    padded = H.build_histogram(
        torch.from_numpy(np.concatenate([bins, pad_bins])),
        torch.from_numpy(np.concatenate([gh, np.zeros((500, 4),
                                                      np.float32)])), B)
    assert torch.equal(base, padded)


def test_cpu_tensors_never_launch_the_kernel():
    bins, gh = _inputs(256, 8, 16, 4, seed=1)
    H.reset_launch_counts()
    H.build_histogram(torch.from_numpy(bins), torch.from_numpy(gh), 16)
    H.build_histogram(torch.from_numpy(bins),
                      torch.from_numpy(gh).to(torch.int16), 16)
    assert H.launch_counts == {"histogram_f32": 0, "histogram_i8": 0,
                               "histogram_i16": 0}


def test_other_devices_raise_instead_of_falling_back():
    bins = torch.zeros((16, 8), dtype=torch.uint8, device="meta")
    gh = torch.zeros((16, 4), dtype=torch.float32, device="meta")
    with pytest.raises(LightGBMError, match="no histogram kernel"):
        H.build_histogram(bins, gh, 16)


@pytest.mark.parametrize("case,match", [
    ("features", "multiple of 8"), ("columns", "stat columns"),
    ("bins", "at most 256 bins"), ("dtype", "float32 or int8"),
    ("idx", "int32"), ("contiguous", "contiguous")])
def test_kernel_argument_checks(case, match):
    """The CUDA wrapper refuses what the kernel does not take, before
    any launch (checked here on CPU tensors)."""
    bins = torch.zeros((64, 8), dtype=torch.uint8)
    gh = torch.zeros((64, 4), dtype=torch.float32)
    idx, B = None, 64
    if case == "features":
        bins = torch.zeros((64, 6), dtype=torch.uint8)
    elif case == "columns":
        gh = torch.zeros((64, 9), dtype=torch.float32)
    elif case == "bins":
        B = 257
    elif case == "dtype":
        gh = gh.double()
    elif case == "idx":
        idx = torch.arange(8)
    elif case == "contiguous":
        gh = torch.zeros((4, 64), dtype=torch.float32).t()
    with pytest.raises(LightGBMError, match=match):
        H._check_cuda_args(bins, gh, B, idx)


def test_subtract_and_sum_gh():
    bins, gh = _inputs(900, 8, 32, 4, seed=3)
    tb, tg = torch.from_numpy(bins), torch.from_numpy(gh)
    parent = H.build_histogram(tb, tg, 32)
    left = H.build_histogram(tb[:400], tg[:400], 32)
    right = H.build_histogram(tb[400:], tg[400:], 32)
    np.testing.assert_allclose(H.subtract_histogram(parent, left).numpy(),
                               right.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(sum_gh(tg).numpy(), gh.sum(0), rtol=1e-5)
    g8 = torch.from_numpy(_inputs(900, 8, 32, 4, 4, np.int8)[1])
    assert sum_gh(g8).dtype == torch.int32


@pytest.mark.parametrize("gh_dtype", [torch.float32, torch.int8,
                                      torch.int16])
def test_launch_plan_fits_every_learner_shape(gh_dtype):
    """Every shape the learner can ask for (Fp a multiple of 8, B a power
    of two up to 256, C <= 8) fits in a block's shared memory, and the
    feature groups cover each feature exactly once; the row blocks cover
    the rows, at most one per SM across the groups."""
    for Fp in range(8, 257, 8):
        for B in (2, 4, 8, 16, 32, 64, 128, 256):
            for C in range(1, 9):
                for S in (1, 31, 1000, 100_000, 10_500_000):
                    p = H.launch_plan(S, Fp, B, C, gh_dtype, 132)
                    assert p.smem_bytes <= H.MAX_SMEM == 232448
                    fg = p.features_per_group
                    assert fg in H.GROUP_FEATURES
                    covered = [f for a, b in p.feature_ranges(Fp)
                               for f in range(a, b)]
                    assert covered == list(range(Fp))
                    assert all(b > a for a, b in p.feature_ranges(Fp))
                    assert p.tile_rows % 32 == 0
                    assert H.MIN_TILE_ROWS <= p.tile_rows <= H.MAX_TILE_ROWS
                    assert p.smem_bytes == fg * B * C * 4 + 2 * p.tile_rows \
                        * (fg + C * torch.empty((), dtype=gh_dtype)
                           .element_size())
                    assert p.blocks * p.rows_per_block >= S
                    assert (p.blocks - 1) * p.rows_per_block < S
                    assert p.blocks == 1 or p.blocks * p.groups <= 132
                    assert p.scratch_shape == (
                        None if p.blocks == 1 else (p.blocks, Fp, B, C))


@pytest.mark.parametrize("S,blocks,scratch", [
    (1, 1, None), (31, 1, None), (1000, 1, None),
    (10_000, 10, (10, 32, 256, 4)), (1_000_000, 132, (132, 32, 256, 4)),
    (10_500_000, 132, (132, 32, 256, 4))])
def test_launch_plan_main_path(S, blocks, scratch):
    """The main path's shape (Fp 32, B 256, C 4, f32): one feature group,
    128 KB of accumulators and two 1024-row tiles of 48 bytes a row; a
    child below MIN_ROWS_PER_BLOCK rows takes one block and no scratch."""
    p = H.launch_plan(S, 32, 256, 4, torch.float32, 132)
    assert (p.groups, p.features_per_group, p.warps, p.tile_rows) == \
        (1, 32, 16, 1024)
    assert p.smem_bytes == 32 * 256 * 4 * 4 + 2 * 1024 * 48
    assert p.blocks == blocks and p.scratch_shape == scratch


def test_launch_plan_splits_wide_rows_into_groups():
    p = H.launch_plan(10_500_000, 64, 256, 4, torch.float32, 132)
    assert p.groups == 2 and p.feature_ranges(64) == [(0, 32), (32, 64)]
    assert p.blocks == 66


@pytest.mark.parametrize("args,match", [
    ((100, 12, 256, 4, torch.float32), "multiple of 8"),
    ((100, 32, 257, 4, torch.float32), "at most 256 bins"),
    ((100, 32, 0, 4, torch.float32), "at most 256 bins"),
    ((100, 32, 256, 9, torch.float32), "stat columns"),
    ((100, 32, 256, 4, torch.float64), "float32 or int8"),
    ((0, 32, 256, 4, torch.float32), "needs rows")])
def test_launch_plan_rejects_what_the_kernel_does_not_take(args, match):
    with pytest.raises(LightGBMError, match=match):
        H.launch_plan(*args, num_sms=132)
