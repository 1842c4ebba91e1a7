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


def _launches_cover_every_split(booster, launches):
    """The kernel's device counter holds one launch per root and per
    split step (the whole-tree loop may run a few steps past a tree's
    end; they launch with no rows), and every split had its step."""
    stats = booster.inner.learner.grow_stats
    assert launches == stats["roots"] + stats["steps"]
    assert stats["roots"] == len(booster.inner.models)
    assert stats["steps"] >= sum(t.num_leaves - 1
                                 for t in booster.inner.models)


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
    launches = H.device_launch_counts()["histogram_f32"]
    cpu = lgb.train(dict(params, device_type="cpu"),
                    lgb.Dataset(X, label=y), num_boost_round=3)
    trees = gpu.inner.models
    _launches_cover_every_split(gpu, launches)
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
    dev = H.device_launch_counts()
    _launches_cover_every_split(a, dev["histogram_i8"])
    assert dev["histogram_f32"] == 0
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
    """K trees per iteration through the kernel: one launch per root
    and per split step of each of the K trees; tree 1 (class 0) makes
    the CPU run's splits."""
    rng = np.random.RandomState(1)
    X = rng.randn(20000, 12)
    f = X[:, 0] + 0.7 * X[:, 1] - 0.5 * X[:, 2] ** 2
    y = np.digitize(f + 0.3 * rng.randn(20000), [-0.5, 0.5])
    params = {"objective": objective, "num_class": 3, "num_leaves": 31,
              "verbose": -1}
    H.reset_launch_counts()
    gpu = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=2)
    launches = H.device_launch_counts()
    cpu = lgb.train(dict(params, device_type="cpu"),
                    lgb.Dataset(X, label=y), num_boost_round=1)
    trees = gpu.inner.models
    assert len(trees) == 6
    _launches_cover_every_split(gpu, launches["histogram_f32"])
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
    _launches_cover_every_split(
        gpu, H.device_launch_counts()["histogram_f32"])
    cpu = lgb.train(dict(params, device_type="cpu"),
                    lgb.Dataset(X, label=y, group=group),
                    num_boost_round=1)
    assert _first_tree_splits(gpu) == _first_tree_splits(cpu)


@pytest.mark.parametrize("gh_dtype", ["f32", "int8", "int16"])
@pytest.mark.parametrize("F", [32, 136])
def test_device_count_entry_equals_host_count_launch(cuda, gh_dtype, F):
    """The device-count entry (row count read from device memory, blocks
    planned there) gives the host-count launch's bytes over the same
    sorted row list, for every n across the block-count boundaries; n =
    0 gives zeros."""
    S = 1 << 20
    bins, gh, gh8, _ = _inputs(S, F, 256, seed=11)
    q = (2 ** 31 - 1) // S
    rows = {"f32": gh, "int8": gh8,
            "int16": torch.randint(-q, q + 1, (S, 4), device="cuda",
                                   dtype=torch.int32).to(torch.int16)}[
        gh_dtype]
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    perm = torch.randperm(S, generator=g, device="cuda")
    for n in (0, 1, 1023, 1024, 1025, 10_000, 100_000, 1_000_000, S):
        idx = perm[:n].sort().values.to(torch.int32)
        buf = torch.full((S + 1,), S, dtype=torch.int32, device="cuda")
        buf[:n] = idx
        count = torch.tensor([n], dtype=torch.int32, device="cuda")
        got = H.build_histogram(bins, rows, 256, buf, count)
        want = H.build_histogram(bins, rows, 256, idx)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), n


def _train_pair(params, X, y, rounds=3):
    out = []
    for fused in (True, False):
        H.reset_launch_counts()
        b = lgb.train(dict(params, tpu_fused_tree=fused),
                      lgb.Dataset(X, label=y), num_boost_round=rounds)
        out.append((b, H.device_launch_counts()))
    return out


@pytest.mark.parametrize("extra", [{}, {"use_quantized_grad": True},
                                   {"use_quantized_grad": True,
                                    "quant_grad_bits": 16,
                                    "bagging_fraction": 0.8,
                                    "bagging_freq": 1}])
def test_whole_tree_equals_per_split_on_cuda(cuda, extra):
    """The graph-replayed whole-tree loop gives the per-split loop's
    trees and train-score bits on the card; the device counter holds
    one launch per root and per step, and the graph ran every step but
    the first (the warm-up before capture)."""
    rng = np.random.RandomState(7)
    X = rng.randn(30000, 12)
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2 + rng.randn(30000) * 0.3 > 0.5)
    params = dict({"objective": "binary", "num_leaves": 63,
                   "min_data_in_leaf": 50, "verbose": -1}, **extra)
    (fused, dev_f), (stepped, dev_s) = _train_pair(params, X, y)
    assert [t.to_string() for t in fused.inner.models] == \
        [t.to_string() for t in stepped.inner.models]
    assert torch.equal(fused.inner.train_score.view(torch.int32),
                       stepped.inner.train_score.view(torch.int32))
    stats = fused.inner.learner.grow_stats
    splits = sum(t.num_leaves - 1 for t in fused.inner.models)
    assert stats["captures"] == 1
    assert stats["replays"] == stats["steps"] - 1
    assert stats["steps"] >= splits
    assert sum(dev_f.values()) == stats["roots"] + stats["steps"]
    assert sum(dev_s.values()) == len(stepped.inner.models) + splits


def test_split_step_makes_no_sync(cuda):
    """A warmed eager step raises nothing under
    ``torch.cuda.set_sync_debug_mode("error")``: it holds no host read."""
    rng = np.random.RandomState(8)
    X = rng.randn(20000, 12)
    y = (X[:, 0] + rng.randn(20000) * 0.3 > 0).astype(float)
    booster = lgb.Booster({"objective": "binary", "num_leaves": 31,
                           "verbose": -1}, lgb.Dataset(X, label=y))
    learner = booster.inner.learner
    g = torch.from_numpy((rng.rand(20000) - y).astype(np.float32)).cuda()
    gh = torch.stack([g, torch.full_like(g, 0.25), torch.ones_like(g),
                      torch.ones_like(g)], dim=1)
    buf = learner._fused_buffers(gh)
    learner._root(buf.state)
    learner._step(buf)                    # warm: kernels built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            learner._step(buf)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(buf.state.step) == 6


def test_device_counter_counts_replays(cuda):
    """Graph replays launch the kernel without the wrapper: the host
    count holds the capture once, the device counter every replay."""
    rng = np.random.RandomState(9)
    X = rng.randn(20000, 12)
    y = (X[:, 0] + rng.randn(20000) * 0.3 > 0).astype(float)
    H.reset_launch_counts()
    b = lgb.train({"objective": "binary", "num_leaves": 31, "verbose": -1},
                  lgb.Dataset(X, label=y), num_boost_round=2)
    stats = b.inner.learner.grow_stats
    dev = H.device_launch_counts()["histogram_f32"]
    # roots and the warm-up step through the wrapper, plus the capture
    assert H.launch_counts["histogram_f32"] == stats["roots"] + 2
    assert dev == stats["roots"] + 1 + stats["replays"]
    assert stats["replays"] >= sum(t.num_leaves - 1
                                   for t in b.inner.models) - 1
