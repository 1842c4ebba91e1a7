"""The CUDA histogram kernel and the slice on the card.

These need an NVIDIA GPU and nvcc; elsewhere they skip. Run them on the
card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.ops import histogram as H
from lightgbm_tpu_torch.ops import quantize as Q
from lightgbm_tpu_torch.utils import prng

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(S, F, B, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    bins = torch.randint(0, B, (S, F), generator=g, device="cuda",
                         dtype=torch.int32).to(torch.uint8)
    gh = torch.randn(S, 4, generator=g, device="cuda")
    gh[:, 2:] = 1.0
    gh8 = torch.randint(-127, 128, (S, 4), generator=g, device="cuda",
                        dtype=torch.int32).to(torch.int8)
    idx = torch.randperm(S, generator=g, device="cuda")[:S // 3]
    return bins, gh, gh8, idx.sort().values.to(torch.int32)


@pytest.mark.parametrize("with_idx", [False, True])
def test_f32_kernel_matches_plain_sum(cuda, with_idx):
    """Counts exact; grad/hess within 1e-5 x the bin's sum of |x| (the
    kernel adds f32 values in its own fixed order, not row order)."""
    bins, gh, _, idx = _inputs(1 << 16, 16, 256, seed=1)
    idx = idx if with_idx else None
    H.reset_launch_counts()
    got = H.build_histogram(bins, gh, 256, idx).double()
    assert H.launch_counts["histogram_f32"] == 1
    ref = H.histogram_plain(bins, gh.double(), 256, idx)
    mag = H.histogram_plain(bins, gh.double().abs(), 256, idx)
    assert torch.equal(got[..., 2:], ref[..., 2:])
    assert bool(((got - ref).abs() <= 1e-5 * mag).all())


@pytest.mark.parametrize("with_idx", [False, True])
def test_int8_kernel_byte_equal(cuda, with_idx):
    bins, _, gh8, idx = _inputs(1 << 16, 24, 100, seed=2)
    idx = idx if with_idx else None
    got = H.build_histogram(bins, gh8, 100, idx)
    assert got.dtype == torch.int32
    assert torch.equal(got, H.histogram_plain(bins, gh8, 100, idx))


def test_training_on_cuda_goes_through_the_kernel(cuda):
    rng = np.random.RandomState(0)
    X = rng.randn(20000, 12)
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2 + rng.randn(20000) * 0.3 > 0.5)
    params = {"objective": "binary", "num_leaves": 31, "verbose": -1}
    H.reset_launch_counts()
    gpu = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=3)
    launches = H.launch_counts["histogram_f32"]
    cpu = lgb.train(dict(params, device_type="cpu"),
                    lgb.Dataset(X, label=y), num_boost_round=3)
    trees = gpu.inner.models
    assert launches == sum(t.num_leaves for t in trees)
    a, b = trees[0], cpu.inner.models[0]
    ni = a.num_internal
    assert a.num_leaves == b.num_leaves
    assert a.split_feature[:ni].tolist() == b.split_feature[:ni].tolist()
    assert a.threshold[:ni].tolist() == b.threshold[:ni].tolist()


@pytest.mark.parametrize("with_idx", [False, True])
def test_int16_kernel_byte_equal(cuda, with_idx):
    """int16 rows -> int32, |q| at the 16-bit cap for S rows."""
    S = 1 << 16
    bins, _, _, idx = _inputs(S, 16, 256, seed=3)
    q = (2 ** 31 - 1) // S
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    gh16 = torch.randint(-q, q + 1, (S, 4), generator=g, device="cuda",
                         dtype=torch.int32).to(torch.int16)
    idx = idx if with_idx else None
    H.reset_launch_counts()
    got = H.build_histogram(bins, gh16, 256, idx)
    assert H.launch_counts["histogram_i16"] == 1
    assert got.dtype == torch.int32
    assert torch.equal(got, H.histogram_plain(bins, gh16, 256, idx))


@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_gh_card_equals_cpu(cuda, bits):
    """Integer threefry and IEEE f32 division are exact on both devices:
    the quantized rows and scales are byte-equal."""
    rng = np.random.RandomState(5)
    n = 100_003
    host = [(rng.randn(n) * 0.4).astype(np.float32),
            (rng.rand(n) * 0.25).astype(np.float32),
            (rng.rand(n) < 0.8).astype(np.float32)]
    qmax = Q.effective_quant_max(bits, n)
    out = []
    for dev in ("cuda", "cpu"):
        key = Q.tree_key(prng.PRNGKey(17, dev), 3)
        gh, qs = Q.quantize_gh(*[torch.from_numpy(a).to(dev) for a in host],
                               key, qmax, Q.quant_dtype(bits))
        out.append((gh.cpu(), qs.cpu().view(torch.int32),
                    prng.uniform(key, (n, 2)).cpu().view(torch.int32)))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_quantized_training_on_cuda_is_repeatable(cuda):
    """Integer histograms are exact in any order: two quantized runs on
    the card give the same model text, every
    histogram through the int8 instance."""
    rng = np.random.RandomState(6)
    X = rng.randn(30000, 12)
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2 + rng.randn(30000) * 0.3 > 0.5)
    params = {"objective": "binary", "num_leaves": 31, "verbose": -1,
              "use_quantized_grad": True, "bagging_fraction": 0.8,
              "bagging_freq": 1}
    H.reset_launch_counts()
    a = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=4)
    assert H.launch_counts["histogram_i8"] == sum(
        t.num_leaves for t in a.inner.models)
    assert H.launch_counts["histogram_f32"] == 0
    b = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=4)
    assert a.model_to_string() == b.model_to_string()


def test_f32_kernel_is_deterministic(cuda):
    """Lanes, rows, tiles and blocks are added in a fixed order: two
    calls on the same inputs give the same bytes, dense and through a
    row-index list."""
    bins, gh, _, idx = _inputs(1 << 18, 32, 256, seed=7)
    for use_idx in (None, idx):
        a = H.build_histogram(bins, gh, 256, use_idx)
        b = H.build_histogram(bins, gh, 256, use_idx)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_hot_bin_every_row_in_one_bin(cuda, dtype):
    """Every row in one bin of every feature: one 32-lane group per
    __match_any_sync and every row on one address."""
    bins, gh, gh8, idx = _inputs(1 << 18, 16, 256, seed=8)
    bins = torch.full_like(bins, 200)
    rows = gh if dtype == "f32" else gh8
    for use_idx in (None, idx):
        got = H.build_histogram(bins, rows, 256, use_idx)
        if dtype == "int8":
            assert torch.equal(got, H.histogram_plain(bins, rows, 256,
                                                      use_idx))
            continue
        ref = H.histogram_plain(bins, rows.double(), 256, use_idx)
        mag = H.histogram_plain(bins, rows.double().abs(), 256, use_idx)
        got = got.double()
        assert torch.equal(got[..., 2:], ref[..., 2:])
        assert bool(((got - ref).abs() <= 1e-5 * mag).all())


@pytest.mark.parametrize("n", [1, 2, 31, 33, 1023, 1025])
def test_tiny_children(cuda, n):
    """Row-index lists around a warp's 32 rows and the one-block limit
    (MIN_ROWS_PER_BLOCK): counts exact, f32 sums within tolerance, int8
    byte-equal."""
    bins, gh, gh8, _ = _inputs(1 << 14, 24, 128, seed=9)
    g = torch.Generator(device="cuda")
    g.manual_seed(n)
    idx = torch.randperm(1 << 14, generator=g, device="cuda")[:n]
    idx = idx.sort().values.to(torch.int32)
    got = H.build_histogram(bins, gh, 128, idx).double()
    ref = H.histogram_plain(bins, gh.double(), 128, idx)
    mag = H.histogram_plain(bins, gh.double().abs(), 128, idx)
    assert torch.equal(got[..., 2:], ref[..., 2:])
    assert bool(((got - ref).abs() <= 1e-5 * mag).all())
    assert torch.equal(H.build_histogram(bins, gh8, 128, idx),
                       H.histogram_plain(bins, gh8, 128, idx))


def _first_tree_splits(booster):
    t = booster.inner.models[0]
    ni = t.num_internal
    return (t.num_leaves, t.split_feature[:ni].tolist(),
            t.threshold[:ni].tolist())


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_multiclass_on_cuda_launches_k_per_split(cuda, objective):
    """K trees per iteration through the kernel: launches == K x (1 +
    splits) per iteration; tree 1 (class 0) makes the CPU run's
    splits."""
    rng = np.random.RandomState(1)
    X = rng.randn(20000, 12)
    f = X[:, 0] + 0.7 * X[:, 1] - 0.5 * X[:, 2] ** 2
    y = np.digitize(f + 0.3 * rng.randn(20000), [-0.5, 0.5])
    params = {"objective": objective, "num_class": 3, "num_leaves": 31,
              "verbose": -1}
    H.reset_launch_counts()
    gpu = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=2)
    launches = dict(H.launch_counts)
    cpu = lgb.train(dict(params, device_type="cpu"),
                    lgb.Dataset(X, label=y), num_boost_round=1)
    trees = gpu.inner.models
    assert len(trees) == 6
    assert launches["histogram_f32"] == sum(t.num_leaves for t in trees)
    assert launches["histogram_f32"] == sum(launches.values())
    assert _first_tree_splits(gpu) == _first_tree_splits(cpu)
    assert gpu.predict(X[:100]).shape == (100, 3)


def test_lambdarank_on_cuda_tree1_equals_cpu(cuda):
    rng = np.random.RandomState(2)
    group = rng.randint(2, 120, size=400)
    n = int(group.sum())
    X = rng.randn(n, 16)
    y = np.clip(np.floor(X[:, 0] + 0.5 * X[:, 1] + rng.randn(n) * 0.5
                         + 1.5), 0, 4)
    params = {"objective": "lambdarank", "num_leaves": 31, "verbose": -1,
              "eval_at": "1,3,5"}
    H.reset_launch_counts()
    gpu = lgb.train(params, lgb.Dataset(X, label=y, group=group),
                    num_boost_round=2)
    assert H.launch_counts["histogram_f32"] == sum(
        t.num_leaves for t in gpu.inner.models)
    cpu = lgb.train(dict(params, device_type="cpu"),
                    lgb.Dataset(X, label=y, group=group),
                    num_boost_round=1)
    assert _first_tree_splits(gpu) == _first_tree_splits(cpu)
