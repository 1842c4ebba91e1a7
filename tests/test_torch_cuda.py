"""The CUDA histogram kernel and the slice on the card.

These need an NVIDIA GPU and nvcc; elsewhere they skip. Run them on the
card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import json
import warnings

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


@pytest.mark.parametrize("gh_dtype", ["f32", "int8", "int16"])
def test_bundled_device_count_entry_equals_host_count_launch(cuda, gh_dtype):
    """EFB: the kernel runs over the bundle matrix [N, Gp] at Bg bins
    (Bg < B here, and not a multiple of 32); its device-count entry gives
    the host-count launch's bytes, and the host-count launch the plain
    version's (exactly for integer rows)."""
    S, Gp, Bg = 1 << 19, 16, 72
    bins, gh, gh8, _ = _inputs(S, Gp, Bg, seed=13)
    rows = {"f32": gh, "int8": gh8,
            "int16": gh8.to(torch.int16) * 100}[gh_dtype]
    g = torch.Generator(device="cuda")
    g.manual_seed(14)
    perm = torch.randperm(S, generator=g, device="cuda")
    for n in (0, 1, 1025, 100_000, S):
        idx = perm[:n].sort().values.to(torch.int32)
        buf = torch.full((S + 1,), S, dtype=torch.int32, device="cuda")
        buf[:n] = idx
        count = torch.tensor([n], dtype=torch.int32, device="cuda")
        got = H.build_histogram(bins, rows, Bg, buf, count)
        want = H.build_histogram(bins, rows, Bg, idx)
        assert got.shape == (Gp, Bg, 4)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), n
        if gh_dtype != "f32":
            assert torch.equal(want, H.histogram_plain(bins, rows, Bg, idx))


def _train_pair(params, X, y, rounds=3, categorical_feature=None):
    out = []
    for fused in (True, False):
        H.reset_launch_counts()
        b = lgb.train(dict(params, tpu_fused_tree=fused),
                      lgb.Dataset(X, label=y,
                                  categorical_feature=categorical_feature),
                      num_boost_round=rounds)
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


@pytest.mark.parametrize("kind", ["categorical", "bundled",
                                  "bundled_quantized8"])
def test_categorical_and_bundled_graph_trees_equal_per_split(cuda, kind):
    """A categorical (both scan modes, NaN and negative categories) and
    an EFB-bundled model on the card: the graph-replayed whole-tree loop
    gives the per-split loop's trees, every histogram went through the
    kernel (the bundled ones at the bundle width), and the stacked
    predict equals the host walk."""
    rng = np.random.RandomState(15)
    n = 40000
    X = rng.randn(n, 8)
    extra, cats = {}, None
    if kind == "categorical":
        c1 = rng.randint(0, 30, n).astype(float)
        c2 = rng.randint(0, 3, n).astype(float)
        eff = rng.randn(30)
        y = X[:, 0] + eff[c1.astype(int)] + 0.8 * (c2 == 1) > 0
        c1[rng.rand(n) < 0.05] = np.nan
        c1[rng.rand(n) < 0.03] = -1
        X = np.column_stack([X, c1, c2])
        cats = [8, 9]
    else:
        sparse = np.zeros((n, 24))
        choice = rng.randint(0, 30, n)
        hit = np.nonzero(choice < 24)[0]
        # three values a column: few bins, so all 24 share one bundle
        sparse[hit, choice[hit]] = rng.randint(1, 4, len(hit))
        y = X[:, 0] + 0.8 * (sparse[:, 0] > 0) - 0.6 * (sparse[:, 5] > 0) > 0
        X = np.column_stack([X, sparse])
        if kind == "bundled_quantized8":
            extra = {"use_quantized_grad": True}
    params = dict({"objective": "binary", "num_leaves": 63,
                   "min_data_in_leaf": 50, "verbose": -1}, **extra)
    (fused, dev_f), (stepped, dev_s) = _train_pair(
        params, X, y.astype(float), categorical_feature=cats)
    learner = fused.inner.learner
    assert learner._has_cat == (kind == "categorical")
    assert learner._bundled == (kind != "categorical")
    if learner._bundled:
        assert learner.bins.shape[1] == learner.Gp < learner.Fp
    else:
        assert any(t.num_cat > 0 for t in fused.inner.models)
    assert [t.to_string() for t in fused.inner.models] == \
        [t.to_string() for t in stepped.inner.models]
    stats = learner.grow_stats
    assert stats["captures"] == 1
    assert sum(dev_f.values()) == stats["roots"] + stats["steps"]
    splits = sum(t.num_leaves - 1 for t in stepped.inner.models)
    assert sum(dev_s.values()) == len(stepped.inner.models) + splits
    np.testing.assert_array_equal(fused.predict(X[:5000]),
                                  fused.predict(X[:5000],
                                                predict_on_device=False))
    assert fused._stacked_cache[1].entries


@pytest.mark.parametrize("extra", [{}, {"max_bin": 1023},
                                   {"tpu_use_f64_hist": True}])
def test_split_step_makes_no_sync(cuda, extra):
    """A warmed eager step raises nothing under
    ``torch.cuda.set_sync_debug_mode("error")``: it holds no host read
    (with uint16 bins and f64 sums too)."""
    rng = np.random.RandomState(8)
    X = rng.randn(20000, 12)
    y = (X[:, 0] + rng.randn(20000) * 0.3 > 0).astype(float)
    booster = lgb.Booster(dict({"objective": "binary", "num_leaves": 31,
                                "verbose": -1}, **extra),
                          lgb.Dataset(X, label=y))
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


@pytest.mark.parametrize("objective,extra", [
    ("binary", {}), ("multiclass", {"num_class": 3})])
def test_stacked_predict_on_card_equals_host_walk(cuda, objective, extra):
    """Auto mode on a card booster sends 256+ rows through the stacked
    forest; leaves, values and raw scores are byte-equal to the host
    walk, f64 rows (the dd path) too; the Kahan f32 sum stays within
    2e-5 of the f64 one."""
    rng = np.random.RandomState(10)
    X = rng.randn(6000, 8).astype(np.float32).astype(np.float64)
    X[rng.rand(6000) < 0.1, 3] = np.nan
    y = ((X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5)
         if objective == "multiclass" else X[:, 0] + X[:, 1] > 0)
    b = lgb.train(dict(extra, objective=objective, num_leaves=31,
                       verbose=-1), lgb.Dataset(X, label=y.astype(float)),
                  num_boost_round=5)
    got = b.predict(X)
    assert b._stacked_cache[1].entries, "auto mode did not dispatch"
    np.testing.assert_array_equal(got, b.predict(X,
                                                 predict_on_device=False))
    for kw in ({"raw_score": True}, {"pred_leaf": True}):
        np.testing.assert_array_equal(
            b.predict(X, **kw), b.predict(X, predict_on_device=False, **kw))
    X64 = X[:4096] + 1e-12
    np.testing.assert_array_equal(b.predict(X64),
                                  b.predict(X64, predict_on_device=False))
    assert any(k[-1] == "dd" for k in b._stacked_cache[1].entries)
    from lightgbm_tpu_torch.serve import StackedForest
    forest = StackedForest.from_gbdt(b).place("cuda")
    fast = forest.predict_raw_device(X.astype(np.float32)).cpu().numpy()
    host = b.predict(X, raw_score=True, predict_on_device=False)
    np.testing.assert_allclose(fast.reshape(host.shape), host, rtol=2e-5,
                               atol=2e-5)


def test_reset_parameter_recaptures_the_step_on_card(cuda):
    """A reset drops the captured split step (it holds the old split
    parameters and depth limit); the next tree captures it again and
    grows the tree the per-split loop grows with the same schedule."""
    rng = np.random.RandomState(11)
    X = rng.randn(20000, 10)
    y = X[:, 0] * 2 + np.sin(X[:, 1]) + 0.1 * rng.randn(20000)
    texts = []
    for fused in (True, False):
        b = lgb.train({"objective": "regression", "num_leaves": 31,
                       "verbose": -1, "tpu_fused_tree": fused},
                      lgb.Dataset(X, label=y), num_boost_round=2)
        b.reset_parameter({"learning_rate": 0.5, "max_depth": 2,
                           "lambda_l2": 3.0})
        b.update()
        if fused:
            assert b.inner.learner.grow_stats["captures"] == 2
        last = b.inner.models[-1]
        assert last.structure_depth() <= 2 and last.shrinkage == 0.5
        texts.append([t.to_string() for t in b.inner.models])
    assert texts[0] == texts[1]


def test_histogram_launches_on_the_tensors_card():
    """With two or more cards, the kernel runs on the card its tensors
    lie on, whatever the current device is (the launch is guarded and
    the shared-memory attribute is set per device)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    bins, gh, _, idx = _inputs(1 << 15, 16, 256, seed=12)
    want = H.build_histogram(bins, gh, 256, idx)
    d1 = torch.device("cuda", 1)
    got = H.build_histogram(bins.to(d1), gh.to(d1), 256, idx.to(d1))
    assert got.device == d1
    assert torch.equal(got.cpu(), want.cpu())      # deterministic f32
    rng = np.random.RandomState(12)
    X = rng.randn(5000, 8)
    y = (X[:, 0] > 0).astype(float)
    b = lgb.train({"objective": "binary", "num_leaves": 15, "verbose": -1,
                   "gpu_device_id": 1}, lgb.Dataset(X, label=y),
                  num_boost_round=2)
    assert b.inner.learner.bins.device == d1
    c = lgb.train({"objective": "binary", "num_leaves": 15, "verbose": -1},
                  lgb.Dataset(X, label=y), num_boost_round=2)
    assert [t.to_string() for t in b.inner.models] == \
        [t.to_string() for t in c.inner.models]


# ----------------------------------------------------------------------
# sampling: GOSS, feature_fraction, extra_trees
# ----------------------------------------------------------------------
@pytest.mark.parametrize("K", [1, 3])
def test_goss_draw_card_equals_cpu(cuda, K):
    from lightgbm_tpu_torch.boosting.sample_strategy import goss_draw
    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    n = 300_000
    shape = (n,) if K == 1 else (n, K)
    grad = torch.randn(shape, generator=g, device="cuda")
    hess = torch.rand(shape, generator=g, device="cuda") + 0.05
    grad[:5000] = 0.75                    # a block tied at one weight
    hess[:5000] = 0.5
    key = prng.PRNGKey(3, "cuda")
    card = goss_draw(grad, hess, key, 7, n // 5, n // 10)
    cpu = goss_draw(grad.cpu(), hess.cpu(), key.cpu(), 7, n // 5, n // 10)
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


def test_make_rand_bins_card_equals_cpu(cuda):
    from lightgbm_tpu_torch.ops import split as S
    rng = np.random.RandomState(14)
    nb = rng.randint(1, 256, 40).astype(np.int32)

    def meta(dev):
        t = torch.from_numpy(nb).to(dev)
        return S.FeatureMeta(num_bin=t, missing_type=torch.zeros_like(t),
                             zero_bin=torch.zeros_like(t))
    params = S.SplitParams(*([None] * 10), max_cat_threshold=32,
                           cegb_tradeoff=None, cegb_penalty_split=None,
                           monotone_penalty=None)
    for seed in (6, 2 ** 31 - 1):
        ids = torch.tensor([0, 1, 2, 509, 510])
        keys = prng.fold_in(prng.PRNGKey(seed), ids)
        cpu = S.make_rand_bins(keys, meta("cpu"), params)
        card = S.make_rand_bins(keys.cuda(), meta("cuda"), params)
        for a, b in zip(card, cpu):
            assert torch.equal(a.cpu(), b)


def _sampling_learner(extra, seed=15):
    rng = np.random.RandomState(seed)
    X = rng.randn(30000, 12)
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2 + rng.randn(30000) * 0.3 > 0.5)
    params = dict({"objective": "binary", "num_leaves": 63,
                   "min_data_in_leaf": 50, "verbose": -1}, **extra)
    b = lgb.train(params, lgb.Dataset(X, label=y.astype(float)),
                  num_boost_round=1)
    learner = b.inner.learner
    assert learner._graph is not None
    g = torch.from_numpy((rng.rand(30000) - y).astype(np.float32)).cuda()
    gh = torch.stack([g, torch.full_like(g, 0.25), torch.ones_like(g),
                      torch.ones_like(g)], dim=1)
    return learner, gh


def test_extra_trees_replays_equal_eager_steps(cuda):
    """The captured extra_trees step (its node keys folded from the
    device's new_leaf) replays the eager steps' records byte for byte,
    and the per-split loop grows the same tree."""
    learner, gh = _sampling_learner({"extra_trees": True,
                                     "feature_fraction": 0.8})
    learner._extra_key[1].fill_(4242)
    tree_graph, st = learner._grow_fused(gh)
    replayed = st.records.clone()
    assert learner.grow_stats["replays"] > 0
    buf = learner._fused_buffers(gh)
    learner._root(buf.state)
    for _ in range(learner.L - 1):
        learner._step(buf)
    assert torch.equal(buf.state.records.view(torch.int32),
                       replayed.view(torch.int32))
    tree_stepped, _ = learner._grow_stepped(gh)
    assert tree_graph.to_string() == tree_stepped.to_string()


def test_tree_mask_reaches_the_replayed_graph(cuda):
    """A mask copied into ``feature_mask`` between two trees steers the
    replayed step: the copy lands in the storage the graph was captured
    with (a new tensor bound to the attribute would be ignored by every
    replay)."""
    learner, gh = _sampling_learner({})
    ptr = learner.feature_mask.data_ptr()
    for features in ([3, 7, 9], [0, 1, 2, 4]):
        allowed = np.zeros(learner.Fp, dtype=bool)
        allowed[features] = True
        learner._set_tree_mask(allowed)
        assert learner.feature_mask.data_ptr() == ptr
        tree, _ = learner._grow_fused(gh)
        used = set(tree.split_feature_inner[:tree.num_internal].tolist())
        assert tree.num_leaves > 8 and used <= set(features)
        assert learner.grow_stats["captures"] == 1


def test_monotone_graph_replays_equal_eager_steps(cuda):
    """The captured step of a monotone learner (bounds read from the
    candidate rows on the card, the depth penalty from the device depth)
    replays the eager steps' records byte for byte, and the per-split
    loop grows the same tree."""
    rng = np.random.RandomState(5)
    X = rng.randn(30000, 10)
    y = X[:, 0] + np.sin(2 * X[:, 1]) - X[:, 2] + 0.3 * rng.randn(30000)
    params = {"objective": "regression", "num_leaves": 63,
              "min_data_in_leaf": 50, "verbose": -1,
              "monotone_constraints": [1, -1, -1] + [0] * 7,
              "monotone_penalty": 1.0}
    b = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=1)
    learner = b.inner.learner
    assert learner._graph is not None and learner._has_mono
    g = torch.from_numpy((rng.rand(30000) - 0.5).astype(np.float32)).cuda()
    gh = torch.stack([g, torch.full_like(g, 0.25), torch.ones_like(g),
                      torch.ones_like(g)], dim=1)
    tree_graph, st = learner._grow_fused(gh)
    replayed = st.records.clone()
    assert learner.grow_stats["replays"] > 0
    buf = learner._fused_buffers(gh)
    learner._root(buf.state)
    for _ in range(learner.L - 1):
        learner._step(buf)
    assert torch.equal(buf.state.records.view(torch.int32),
                       replayed.view(torch.int32))
    tree_stepped, _ = learner._grow_stepped(gh)
    assert tree_graph.to_string() == tree_stepped.to_string()


def test_forced_split_makes_two_syncs(cuda, tmp_path):
    """Each forced split on the card waits for it twice: the read of its
    record and the partition's ``nonzero`` (sync debug mode, after a
    warm tree). chip_smoke.py bounds a whole-tree tree's syncs by this."""
    rng = np.random.RandomState(12)
    X = rng.randn(20000, 6)
    y = (X[:, 0] + X[:, 3] + rng.randn(20000) * 0.3 > 0).astype(float)
    spec = tmp_path / "forced.json"
    spec.write_text(json.dumps({
        "feature": 0, "threshold": 0.0,
        "left": {"feature": 1, "threshold": 0.2},
        "right": {"feature": 2, "threshold": -0.2}}))
    booster = lgb.Booster({"objective": "binary", "num_leaves": 31,
                           "verbose": -1,
                           "forcedsplits_filename": str(spec)},
                          lgb.Dataset(X, label=y))
    booster.update()                      # warm: the capture, the kernels
    learner = booster.inner.learner
    apply, counts = learner._apply_forced, []

    def counted(tree, state):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                n = apply(tree, state)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.append((n, sum("synchroniz" in str(w.message)
                              for w in caught)))
        return n
    learner._apply_forced = counted
    booster.update()
    assert counts == [(3, 6)]


def test_device_linear_fit_equals_cpu(cuda):
    """The linear fit on the card (cuBLAS products, a cuSOLVER batched
    solve) gives the CPU's coefficients within rtol 1e-9 on the same
    tree, rows and gradients; the leaf whose path column is constant
    keeps its constant on both."""
    from lightgbm_tpu_torch.models import linear
    from lightgbm_tpu_torch.models.tree import Tree
    rng = np.random.RandomState(6)
    n = 20000
    X = rng.randn(n, 5)
    X[:, 0] = np.maximum(X[:, 0], 0.0)
    X[rng.rand(n) < 0.05, 2] = np.nan
    y = 3.0 * (X[:, 0] > 0) + X[:, 1] + 0.5 * X[:, 0] * X[:, 3]
    b = lgb.train({"objective": "regression", "num_leaves": 8,
                   "verbose": -1, "device_type": "cpu"},
                  lgb.Dataset(X, label=y), num_boost_round=1)
    text = b.inner.models[0].to_string()
    leaf = b.inner.models[0].predict_leaf_index(X)
    grad, hess = rng.randn(n), rng.rand(n) + 0.5
    mask = rng.rand(n) < 0.9
    for lam in (0.0, 0.1):
        fits = []
        for dev in ("cpu", "cuda"):
            tree = Tree.from_string(text)
            t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
            linear.fit_linear_leaves(tree, t(X), t(grad), t(hess),
                                     t(leaf), lam, t(mask))
            fits.append(tree)
        a, c = fits
        nl = a.num_leaves
        assert a.leaf_features[:nl] == c.leaf_features[:nl]
        assert any(a.leaf_features[:nl])
        for lf in range(nl):
            np.testing.assert_allclose(c.leaf_coeff[lf], a.leaf_coeff[lf],
                                       rtol=1e-9, atol=0)
        np.testing.assert_allclose(c.leaf_const[:nl], a.leaf_const[:nl],
                                   rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# wide bins (uint16, B > 256) and f64 sums
# ---------------------------------------------------------------------------
def _wide_inputs(S, F, B, seed, dtype=torch.uint16):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    bins = torch.randint(0, B, (S, F), generator=g, device="cuda",
                         dtype=torch.int32)
    bins = (bins.to(torch.int16).view(torch.uint16)
            if dtype == torch.uint16 else bins.to(torch.uint8))
    gh = torch.randn(S, 4, generator=g, device="cuda")
    gh[:, 2:] = 1.0
    q = (2 ** 31 - 1) // S
    rows = {"f32": gh, "f64": gh,
            "int8": torch.randint(-127, 128, (S, 4), generator=g,
                                  device="cuda", dtype=torch.int32
                                  ).to(torch.int8),
            "int16": torch.randint(-q, q + 1, (S, 4), generator=g,
                                   device="cuda", dtype=torch.int32
                                   ).to(torch.int16)}
    idx = torch.randperm(S, generator=g, device="cuda")[:S // 3]
    return bins, rows, idx.sort().values.to(torch.int32)


def _check_against_plain(bins, rows, B, idx, kind):
    """f32: counts exact, grad/hess within 1e-5 x the bin's sum of |x|;
    f64 sums rounded once to f32 (:func:`_check_against_plain`'s
    midpoint rule); int8 and int16: byte-equal to the plain version."""
    f64 = kind == "f64"
    got = H.build_histogram(bins, rows, B, idx, f64=f64)
    if kind == "f32":
        got = got.double()
        ref = H.histogram_plain(bins, rows.double(), B, idx)
        mag = H.histogram_plain(bins, rows.double().abs(), B, idx)
        assert torch.equal(got[..., 2:], ref[..., 2:])
        assert bool(((got - ref).abs() <= 1e-5 * mag).all())
    elif f64:
        # the f64 sum rounded once to f32: the plain version's rounding,
        # but where the f64 sum lies at a rounding midpoint (within
        # 1e-11 x sum|x|, past any f64 order's error)
        ref = H.histogram_plain(bins, rows.double(), B, idx)
        mag = H.histogram_plain(bins, rows.double().abs(), B, idx)
        assert got.dtype == torch.float32
        off = got != ref.float()
        a, r = got[off], ref[off]
        toward = torch.where(r > a.double(), float("inf"), float("-inf"))
        mid = (a.double() + torch.nextafter(a, toward.float()).double()) / 2
        assert bool(((r - mid).abs() <= 1e-11 * mag[off]).all())
    else:
        want = H.histogram_plain(bins, rows, B, idx)
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["f32", "f64", "int8", "int16"])
@pytest.mark.parametrize("B", [512, 1024, 4096])
def test_wide_kernel_instances_match_plain(cuda, B, kind):
    """uint16 bins at B > 256: every instance against its plain version,
    all rows and a row-index list, each through its own instance."""
    bins, rows, idx = _wide_inputs(1 << 16, 40, B, seed=B)
    name = "histogram_u16_" + {"int8": "i8", "int16": "i16"}.get(kind, kind)
    H.reset_launch_counts()
    for i in (None, idx):
        _check_against_plain(bins, rows[kind], B, i, kind)
    assert H.launch_counts[name] == 2
    assert sum(H.launch_counts.values()) == 2


@pytest.mark.parametrize("kind", ["f32", "f64", "int8", "int16"])
def test_wide_kernel_adversarial_rows(cuda, kind):
    """Every row in the last slab's last bin, every row in one bin of
    the first slab, bin values that skip whole slabs, every row of every
    tile in one slab (the second), every row outside every slab (bins in
    [B, 2B), skipped: a zero histogram), and bins >= B beside bins below
    it in a B that is no multiple of 256; all rows (a ragged last tile:
    S is no multiple of 32) and row lists of 1, 31, 33 and 1025 rows;
    Fp 8 and 136; uint16 bins at B <= 256 too."""
    S, B = (1 << 15) + 37, 1024
    bins, rows, idx = _wide_inputs(S, 136, B, seed=21)
    raw = bins.view(torch.int16)
    wide = raw.long() & 0xFFFF
    lists = (None, idx, idx[:1], idx[:31], idx[:33], idx[:1025])
    for b in (torch.full_like(raw, B - 1).view(torch.uint16),
              torch.full_like(raw, 3).view(torch.uint16),
              (raw % 4 * 256 + raw % 3).view(torch.uint16),
              ((wide & 0xFF) + 256).to(torch.int16).view(torch.uint16),
              (wide + B).to(torch.int16).view(torch.uint16)):
        for i in lists:
            _check_against_plain(b, rows[kind], B, i, kind)
    outside = H.build_histogram((wide + B).to(torch.int16).view(
        torch.uint16), rows[kind], B, idx, f64=kind == "f64")
    assert not outside.any()
    # B = 700: slabs of 256, 256 and 188 bins; bins up to 767 (>= B
    # inside the last slab's 256-bin range are skipped)
    part = (wide % 768).to(torch.int16).view(torch.uint16)
    for i in lists:
        _check_against_plain(part, rows[kind], 700, i, kind)
    narrow, nrows, nidx = _wide_inputs(S, 8, 64, seed=22)
    for i in (None, nidx):
        _check_against_plain(narrow, nrows[kind], 64, i, kind)


@pytest.mark.parametrize("kind", ["int8", "int16"])
@pytest.mark.parametrize("B,F", [(257, 136), (700, 8), (1024, 32),
                                 (1024, 136), (4096, 32), (8192, 8),
                                 (16384, 8)])
def test_wide_integer_kernels_whole_features(cuda, kind, B, F):
    """The integer instances over uint16 bins take a whole feature per
    pair where it fits (B <= 8192 at C = 4), and 16 / Fg warps share a
    pair at Fg < 16: byte-equal to the plain version on random bins,
    every row in one bin (the sharing warps flush into one bin), 70% of
    the rows in one bin, bins >= B beside bins below it, and every row
    outside every slab (bins in [B, 2B): a zero histogram); all rows (a
    ragged last tile) and row lists of 1, 31, 33 and 1025 rows; the
    device-count entry byte-equal to the host-count launch."""
    S = (1 << 15) + 37
    bins, rows, idx = _wide_inputs(S, F, B, seed=B + F)
    p = H.launch_plan(S, F, B, 4, rows[kind].dtype, 132, torch.uint16)
    assert (p.slabs == 1) == (B <= 8192)
    raw = bins.view(torch.int16)
    wide = raw.long() & 0xFFFF
    g = torch.Generator(device="cuda")
    g.manual_seed(B)
    hot = torch.where(torch.rand(raw.shape, generator=g, device="cuda")
                      < 0.7, B // 3, wide)
    cases = [bins, torch.full_like(raw, B - 1).view(torch.uint16),
             hot.to(torch.int16).view(torch.uint16),
             (wide * 3 // 2).to(torch.int16).view(torch.uint16),
             (wide + B).to(torch.int16).view(torch.uint16)]
    for b in cases:
        for i in (None, idx, idx[:1], idx[:31], idx[:33], idx[:1025]):
            _check_against_plain(b, rows[kind], B, i, kind)
    outside = H.build_histogram(cases[-1], rows[kind], B, idx)
    assert not outside.any()
    for b in cases[:3]:
        for n in (0, 1, 1025, S // 3):
            buf = torch.full((S + 1,), S, dtype=torch.int32, device="cuda")
            buf[:n] = idx[:n]
            count = torch.tensor([n], dtype=torch.int32, device="cuda")
            got = H.build_histogram(b, rows[kind], B, buf, count)
            want = H.build_histogram(b, rows[kind], B, idx[:n])
            assert torch.equal(got, want), n


@pytest.mark.parametrize("with_idx", [False, True])
def test_f64_instance_on_uint8_bins(cuda, with_idx):
    """f64 sums over uint8 bins (two groups at Fp 32, nine at Fp 136;
    row blocks of 256 rows at least): random bins, every row in one bin,
    bins >= B (B = 200) skipped, all rows (a ragged last tile) or row
    lists of 1, 31, 33, 1025 and a third of the rows."""
    S = (1 << 17) + 37
    bins, rows, idx = _wide_inputs(S, 32, 256, seed=23, dtype=torch.uint8)
    wide, wrows, widx = _wide_inputs(S, 136, 256, seed=27,
                                     dtype=torch.uint8)
    H.reset_launch_counts()
    lists = [idx, idx[:1], idx[:31], idx[:33], idx[:1025]] if with_idx \
        else [None]
    for i in lists:
        _check_against_plain(bins, rows["f64"], 256, i, "f64")
        _check_against_plain(torch.full_like(bins, 9), rows["f64"], 256, i,
                             "f64")
        _check_against_plain(bins, rows["f64"], 200, i, "f64")
    for i in ([widx, widx[:33]] if with_idx else [None]):
        _check_against_plain(wide, wrows["f64"], 256, i, "f64")
    assert H.launch_counts["histogram_f64"] == 3 * len(lists) + (
        2 if with_idx else 1)


@pytest.mark.parametrize("kind", ["f32", "f64", "f64 uint8"])
def test_wide_float_instances_are_deterministic(cuda, kind):
    """Two calls on the same inputs give the same bytes: f32 and f64
    sums over uint16 bins (B 1024), f64 sums over uint8 bins (B 256)."""
    narrow = kind == "f64 uint8"
    B = 256 if narrow else 1024
    bins, rows, idx = _wide_inputs(1 << 20, 32, B, seed=24,
                                   dtype=torch.uint8 if narrow
                                   else torch.uint16)
    for i in (None, idx):
        a = H.build_histogram(bins, rows[kind[:3]], B, i,
                              f64=kind != "f32")
        b = H.build_histogram(bins, rows[kind[:3]], B, i,
                              f64=kind != "f32")
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("kind", ["f32", "f64", "int8", "int16"])
@pytest.mark.parametrize("B", [1024, 4096])
def test_wide_device_count_entry_equals_host_count_launch(cuda, kind, B):
    S = 1 << 19
    bins, rows, _ = _wide_inputs(S, 32, B, seed=25)
    g = torch.Generator(device="cuda")
    g.manual_seed(26)
    perm = torch.randperm(S, generator=g, device="cuda")
    for n in (0, 1, 1025, 100_000, S):
        idx = perm[:n].sort().values.to(torch.int32)
        buf = torch.full((S + 1,), S, dtype=torch.int32, device="cuda")
        buf[:n] = idx
        count = torch.tensor([n], dtype=torch.int32, device="cuda")
        got = H.build_histogram(bins, rows[kind], B, buf, count,
                                f64=kind == "f64")
        want = H.build_histogram(bins, rows[kind], B, idx,
                                 f64=kind == "f64")
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), n


@pytest.mark.parametrize("extra,kernel", [
    ({}, "histogram_u16_f32"),
    ({"tpu_use_f64_hist": True}, "histogram_u16_f64"),
    ({"use_quantized_grad": True}, "histogram_u16_i8")])
def test_wide_bin_training_on_cuda(cuda, extra, kernel):
    """max_bin 1023 on the card: every histogram through the uint16
    instance (device launches == roots + steps, no other instance), the
    graph trees equal the per-split loop's, tree 1 equal to the CPU's,
    stacked predict equal to the host walk."""
    rng = np.random.RandomState(27)
    X = rng.randn(30000, 12)
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2 + rng.randn(30000) * 0.3 > 0.5)
    params = dict({"objective": "binary", "num_leaves": 31,
                   "max_bin": 1023, "verbose": -1}, **extra)
    (fused, n1), (stepped, _) = _train_pair(params, X, y)
    assert fused.inner.learner.bins.dtype == torch.uint16
    assert [t.to_string() for t in fused.inner.models] == \
        [t.to_string() for t in stepped.inner.models]
    _launches_cover_every_split(fused, n1[kernel])
    assert sum(n1.values()) == n1[kernel]
    cpu = lgb.train(dict(params, device_type="cpu"),
                    lgb.Dataset(X, label=y), num_boost_round=1)
    assert _first_tree_splits(fused) == _first_tree_splits(cpu)
    host = fused.predict(X[:4096], predict_on_device=False)
    card = fused.predict(X[:4096], predict_on_device=True)
    assert np.array_equal(host, card)


def test_dart_rf_and_refit_on_cuda(cuda):
    """DART's drop sets and tree weights on the card equal the CPU's for
    the same seed, and its tree 1 too; an RF model predicts through the
    stacked forest byte-equal to the host walk; a refit on the card
    gives the CPU's leaf values within 1e-5 (f32 per-leaf sums in
    another order)."""
    rng = np.random.RandomState(31)
    X = rng.randn(30000, 12)
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2 + rng.randn(30000) * 0.3 > 0.5)
    base = {"objective": "binary", "num_leaves": 31, "verbose": -1}
    dart = dict(base, boosting="dart", drop_rate=0.3, skip_drop=0.0)
    runs = [lgb.train(dict(dart, device_type=d), lgb.Dataset(X, label=y),
                      num_boost_round=6) for d in ("cuda", "cpu")]
    assert runs[0].inner.tree_weight == runs[1].inner.tree_weight
    assert _first_tree_splits(runs[0]) == _first_tree_splits(runs[1])
    rf = lgb.train(dict(base, boosting="rf", bagging_fraction=0.6,
                        bagging_freq=1), lgb.Dataset(X, label=y),
                   num_boost_round=4)
    assert np.array_equal(rf.predict(X[:4096], predict_on_device=True),
                          rf.predict(X[:4096], predict_on_device=False))
    model = lgb.train(base, lgb.Dataset(X, label=y),
                      num_boost_round=5).model_to_string()
    card = lgb.Booster(model_str=model)
    cpu = lgb.Booster(model_str=model, params={"device_type": "cpu"})
    X2 = rng.randn(20000, 12)
    y2 = (X2[:, 1] > 0).astype(float)
    card.refit(X2, y2)
    cpu.refit(X2, y2)
    for a, b in zip(card.inner.models, cpu.inner.models):
        np.testing.assert_allclose(a.leaf_value[:a.num_leaves],
                                   b.leaf_value[:b.num_leaves], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("extra,kernel", [
    ({}, "histogram_f32"),
    ({"use_quantized_grad": True, "bagging_fraction": 0.7,
      "bagging_freq": 1}, "histogram_i8")], ids=["f32", "int8-bagging"])
def test_batched_iterations_on_cuda(cuda, extra, kernel):
    """Six batched iterations on the card give the looped trees text for
    text and the same training score bytes; the batch reads its records
    once and never reads the step counter, runs with no host sync until
    that read, and every histogram of it is a launch of the kernel
    (device launches == roots + steps)."""
    rng = np.random.RandomState(41)
    X = rng.randn(30000, 12)
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2 + rng.randn(30000) * 0.3 > 0.5)
    params = dict({"objective": "binary", "num_leaves": 31,
                   "verbose": -1}, **extra)
    a = lgb.Booster(params=params, train_set=lgb.Dataset(X, label=y))
    b = lgb.Booster(params=params, train_set=lgb.Dataset(X, label=y))
    a.update()
    b.update()
    assert a.inner.can_train_batched()
    stats = dict(a.inner.learner.grow_stats)
    H.reset_launch_counts()
    a.inner.train_batch(6)
    launches = H.device_launch_counts()
    for _ in range(6):
        b.update()
    after = a.inner.learner.grow_stats
    assert after["record_reads"] - stats["record_reads"] == 1
    assert after["flag_reads"] == stats["flag_reads"]
    assert launches[kernel] == (after["roots"] - stats["roots"]
                                + after["steps"] - stats["steps"])
    assert sum(launches.values()) == launches[kernel]
    assert [t.to_string() for t in a.inner.models] == \
        [t.to_string() for t in b.inner.models]
    assert torch.equal(a.inner.train_score, b.inner.train_score)
    # everything up to the record read runs with no host sync
    inner = a.inner
    torch.cuda.set_sync_debug_mode("error")
    try:
        inner.learner._train_many_on_device(
            inner.objective.get_gradients, inner.sample_strategy,
            inner.train_score.clone(), [7, 8], inner.shrinkage_rate)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_pred_contrib_of_a_card_model_equals_cpu(cuda):
    """SHAP values of a card-trained model equal the CPU booster's on the
    same text, and add up to the raw scores."""
    rng = np.random.RandomState(43)
    X = rng.randn(20000, 8)
    y = (X[:, 0] - X[:, 2] + rng.randn(20000) * 0.3 > 0).astype(float)
    bst = lgb.train({"objective": "binary", "num_leaves": 31,
                     "verbose": -1}, lgb.Dataset(X, label=y),
                    num_boost_round=4)
    cpu = lgb.Booster(model_str=bst.model_to_string(),
                      params={"device_type": "cpu"})
    got = bst.predict(X[:64], pred_contrib=True)
    np.testing.assert_array_equal(got, cpu.predict(X[:64],
                                                   pred_contrib=True))
    np.testing.assert_allclose(got.sum(axis=1),
                               bst.predict(X[:64], raw_score=True,
                                           predict_on_device=False),
                               rtol=0, atol=1e-9)


# ----------------------------------------------------------------------
# telemetry and checkpoints on the card (obs/, ft/checkpoint.py)
# ----------------------------------------------------------------------

def _syncs_of_one_update(booster):
    """Host syncs of one boosting iteration, counted by the sync debug
    mode's warnings (the registry's drainer threads included)."""
    from lightgbm_tpu_torch.obs.registry import registry
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            booster.update()
            assert registry.drain_ready(timeout=60)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def test_sample_mode_adds_no_host_sync_on_card(cuda):
    """Sample mode records a CUDA event after each watched stage and a
    drainer thread polls it: an iteration makes exactly the syncs it
    makes with telemetry off (the loop's own record and flag reads), and
    every watched stage lands its ``::ready`` time."""
    from lightgbm_tpu_torch.obs.registry import registry
    rng = np.random.RandomState(51)
    X = rng.randn(50000, 10)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.randn(50000) * 0.3 > 0)
    booster = lgb.Booster({"objective": "binary", "num_leaves": 63,
                           "verbose": -1}, lgb.Dataset(X, label=y))
    booster.update()                      # warm: the capture, the kernels
    off = _syncs_of_one_update(booster)
    registry.reset()
    registry.enable(sampling=True)
    try:
        on = _syncs_of_one_update(booster)
        phases = registry.phases()
    finally:
        registry.disable()
        registry.timer.sampling = False
    assert on == off
    for stage in ("gbdt::gradients", "tree::stage_gh",
                  "tree::root_histogram", "gbdt::score_update"):
        assert phases[stage + "::ready"]["calls"] == 1, stage
    assert registry.gauges["device/peak_bytes_in_use"] > 0


def test_trace_readiness_lane_on_card(cuda, tmp_path):
    """A traced run on the card: one ``::ready`` span per watched stage
    and tree, on the readiness lane, parented to the stage that
    submitted it."""
    from lightgbm_tpu_torch.obs import trace
    from lightgbm_tpu_torch.obs.registry import registry
    rng = np.random.RandomState(52)
    X = rng.randn(20000, 8)
    y = (X[:, 0] - X[:, 3] + rng.randn(20000) * 0.3 > 0)
    path = str(tmp_path / "trace.json")
    registry.reset()
    registry.enable(sampling=True)
    trace.configure(path)
    try:
        lgb.train({"objective": "binary", "num_leaves": 31, "verbose": -1},
                  lgb.Dataset(X, label=y), num_boost_round=3)
        assert registry.drain_ready(timeout=60)
        trace.flush()
    finally:
        trace.configure(None)
        registry.disable()
        registry.timer.sampling = False
    doc = json.load(open(path))
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    by_id = {e["args"].get("span_id"): e for e in spans}
    for stage in ("gbdt::gradients", "tree::stage_gh",
                  "tree::root_histogram", "gbdt::score_update"):
        ready = [e for e in spans if e["name"] == stage + "::ready"]
        assert 1 <= len(ready) <= 3, (stage, len(ready))
        assert all(by_id[e["args"]["parent_span_id"]]["name"] == stage
                   for e in ready), stage
    caps = [e for e in spans if e["name"] == "capture::serial.split_step"]
    assert len(caps) == 1


@pytest.mark.parametrize("extra", [
    {}, {"use_quantized_grad": True, "bagging_fraction": 0.7,
         "bagging_freq": 1}], ids=["f32", "int8-bagging"])
def test_checkpoint_resume_on_card_is_the_uninterrupted_run(cuda, extra,
                                                            tmp_path):
    """Cut after the 4-round checkpoint of a 6-round run and resumed: the
    uninterrupted model text and score bits; the resumed learner
    captures its step again."""
    from lightgbm_tpu_torch.obs import compile as obs_compile
    rng = np.random.RandomState(53)
    X = rng.randn(30000, 10)
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2 + rng.randn(30000) * 0.3 > 0.5)
    params = dict({"objective": "binary", "num_leaves": 31,
                   "verbose": -1}, **extra)
    full = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=6)
    d = str(tmp_path / "ck")

    def cut(env):
        if env.iteration == 4:
            raise KeyboardInterrupt
    with pytest.raises(KeyboardInterrupt):
        lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=6,
                  checkpoint_dir=d, checkpoint_freq=2, callbacks=[cut])
    before = obs_compile.capture_count("serial.split_step")
    resumed = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=6,
                        checkpoint_dir=d, checkpoint_freq=2, resume=True)
    assert obs_compile.capture_count("serial.split_step") == before + 1
    assert resumed.model_to_string() == full.model_to_string()
    assert torch.equal(resumed.inner.train_score.view(torch.int32),
                       full.inner.train_score.view(torch.int32))


# ----------------------------------------------------------------------
# serving replicas and the out-of-core path on the card
# ----------------------------------------------------------------------

def _served_model(rows=4000, rounds=10):
    rng = np.random.RandomState(21)
    X = rng.randn(rows, 10).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    bst = lgb.train({"objective": "binary", "num_leaves": 31,
                     "verbose": -1}, lgb.Dataset(X, label=y),
                    num_boost_round=rounds)
    return X, bst


def test_two_replicas_on_one_card_byte_equal_to_one(cuda):
    """Two dispatch workers on one card, each on its own stream, give
    one replica's bytes for single rows, blocks and split requests."""
    from lightgbm_tpu_torch.serve import PredictServer, StackedForest
    X, bst = _served_model()
    forest = StackedForest.from_gbdt(bst)
    got = {}
    for replicas in (1, 2):
        srv = PredictServer(forest, max_batch=64, max_wait_ms=1,
                            replicas=replicas)
        assert [d.type for d in srv._devices] == ["cuda"] * replicas
        futs = [srv.submit(X[i]) for i in range(300)]
        futs += [srv.submit(X[:150]), srv.submit(X)]
        got[replicas] = [np.atleast_1d(f.result(timeout=120)) for f in futs]
        stats = srv.replica_stats()
        srv.stop()
        if replicas == 2:
            assert all(s["dispatches"] > 0 for s in stats.values())
    want = forest.place("cuda").predict(X)
    for a, b in zip(got[1], got[2]):
        assert np.array_equal(a, b)
    assert np.array_equal(got[2][-1], want)
    assert np.array_equal(got[2][-1],
                          bst.predict(X, predict_on_device=False))


def test_shard_prefetcher_stages_through_pinned_memory(cuda, tmp_path):
    """Shards reach the card through pinned host buffers and a copy
    stream: their bytes are the spill's, and the copies run on a stream
    other than the consumer's."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.shards import (ShardedBinnedDataset,
                                              ShardPrefetcher)
    rng = np.random.RandomState(0)
    X = rng.randn(5000, 10)
    y = (X[:, 0] > 0).astype(np.float32)

    def src():
        for lo in range(0, 5000, 1000):
            yield X[lo:lo + 1000], y[lo:lo + 1000]
    ds = ShardedBinnedDataset.from_chunk_source(
        src, Config.from_params({"verbose": -1}), str(tmp_path / "sp"),
        shard_rows=1200, total_rows=5000)
    pf = ShardPrefetcher(ds, pad_cols=16, device=cuda)
    for _ in range(2):
        for k, bins in pf.sweep():
            assert bins.is_cuda and bins.shape == (ds.shard_sizes[k], 16)
            host = bins.cpu().numpy()
            assert np.array_equal(host[:, :ds.num_features],
                                  np.asarray(ds.shard_bins_host(k)))
            assert (host[:, ds.num_features:] == 0).all()
    assert all(b is not None and b.is_pinned() for b in pf._pinned)
    assert pf._copy_stream is not None
    assert pf._copy_stream != torch.cuda.current_stream()
    pf.close()


@pytest.mark.parametrize("extra", [{"use_quantized_grad": True},
                                   {"use_quantized_grad": True,
                                    "quant_grad_bits": 16}],
                         ids=["8bit", "16bit"])
def test_quantized_sharded_trees_text_equal_on_the_card(cuda, tmp_path,
                                                        extra):
    """Integer histograms are exact in any order: sharded trees on the
    card are the in-memory learner's, text for text, and the kernel ran
    once per shard and histogram pass."""
    from lightgbm_tpu_torch.io.streaming import StreamingDataset
    rng = np.random.RandomState(3)
    X = rng.randn(60000, 12)
    y = (X[:, 0] - X[:, 1] + 0.3 * rng.randn(60000) > 0).astype(float)
    params = dict({"objective": "binary", "num_leaves": 63,
                   "min_data_in_leaf": 20, "verbose": -1}, **extra)
    sd = StreamingDataset(12, params=params, chunk_rows=8192,
                          spill_dir=str(tmp_path / "sp"))
    sd.push_rows(X, label=y)
    ds = sd.finalize(shard_rows=16384)
    kernel = ("histogram_i8" if extra.get("quant_grad_bits", 8) == 8
              else "histogram_i16")
    H.reset_launch_counts()
    sh = lgb.train(params, lgb.Dataset(ds), num_boost_round=3)
    n = H.device_launch_counts()[kernel]
    st = sh.inner.learner.grow_stats
    assert n == ds.num_shards * st["hist_passes"] > 0
    mem = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=3)
    assert sh.model_to_string() == mem.model_to_string()


def test_cli_train_and_predict_on_the_card(cuda, tmp_path):
    """``python -m lightgbm_tpu_torch.application`` trains on the card
    by default: its model text (trees and importances) equals
    ``lgb.train`` on the card over the same parsed rows, its own K1
    launches (its ``cli_train_done`` event) == roots + steps, and its
    ``predict`` task equals ``Booster.predict`` within 1e-9."""
    import json
    import os
    import subprocess
    import sys
    from lightgbm_tpu_torch.application import _load_tabular
    from lightgbm_tpu_torch.config import Config
    rng = np.random.RandomState(4)
    X = rng.randn(30000, 10)
    y = (X[:, 0] - X[:, 1] + 0.3 * rng.randn(30000) > 0).astype(float)
    data = str(tmp_path / "train.tsv")
    np.savetxt(data, np.column_stack([y, X]), delimiter="\t", fmt="%.9g")
    model, preds = str(tmp_path / "m.txt"), str(tmp_path / "p.tsv")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    event_log = str(tmp_path / "events.jsonl")
    env = dict(os.environ, PYTHONPATH=root)
    for argv, extra in ((["task=train", "objective=binary", "num_leaves=63",
                          "num_trees=5", "data=" + data,
                          "output_model=" + model],
                         {"LIGHTGBM_TPU_EVENT_LOG": event_log}),
                        (["task=predict", "data=" + data,
                          "input_model=" + model,
                          "output_result=" + preds], {})):
        subprocess.run([sys.executable, "-m",
                        "lightgbm_tpu_torch.application", "verbosity=-1"]
                       + argv, check=True, env=dict(env, **extra),
                       cwd=root, timeout=600)
    with open(event_log) as fh:
        done = [json.loads(ln) for ln in fh if '"cli_train_done"' in ln]
    assert len(done) == 1 and done[0]["trees"] == 5
    assert done[0]["launches"]["histogram_f32"] == \
        done[0]["roots"] + done[0]["steps"] > 0
    Xf, yf, _, _ = _load_tabular(data, Config.from_params({}))
    bst = lgb.train({"objective": "binary", "num_leaves": 63,
                     "verbosity": -1}, lgb.Dataset(Xf, label=yf),
                    num_boost_round=5)
    with open(model) as fh:
        # the trees and importances; the parameters differ (task, data)
        assert fh.read().split("parameters:")[0] == \
            bst.model_to_string().split("parameters:")[0]
    np.testing.assert_allclose(np.loadtxt(preds), bst.predict(Xf),
                               rtol=0, atol=1e-9)


def test_one_refresh_cycle_on_the_card(cuda, tmp_path, monkeypatch):
    """Bootstrap + one clean refresh on the card under live traffic: the
    refresh captures the sharded learner's graph while the server's
    worker and the pumps use the card, and the checkpointed model is
    the uninterrupted training's on the re-attached spill, text for
    text."""
    from lightgbm_tpu_torch.ft import checkpoint as ckpt_mod
    from lightgbm_tpu_torch.io.shards import ShardedBinnedDataset
    from lightgbm_tpu_torch.loop import RefreshController
    monkeypatch.setenv("LIGHTGBM_TPU_WATCH_REFRESH_P99_MS", "5000")
    params = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
              "min_data_in_leaf": 20}

    def data_fn(cycle):
        rng = np.random.default_rng(60 + cycle)
        X = rng.normal(size=(40000, 10))
        return X, (X[:, 0] + 0.5 * X[:, 1] > 0.2).astype(np.float64)

    ctl = RefreshController(params, data_fn, num_features=10,
                            work_dir=str(tmp_path), base_rounds=2,
                            extra_rounds=1, traffic_rows=64,
                            traffic_pool=4, shard_rows=10000, schedule={},
                            use_gateway=False)
    rep = ctl.run(cycles=2)
    assert rep["ok"], rep["problems"]
    assert [c["outcome"] for c in rep["cycles"]] == ["bootstrap",
                                                     "promoted"]
    assert rep["traffic"]["rows_ok"] > 0
    newest = ckpt_mod.list_checkpoints(str(tmp_path / "ckpt"))[0]
    with open(newest[1] + "/model.txt") as fh:
        loop_text = fh.read()
    spill = ShardedBinnedDataset.attach(str(tmp_path / "spill"))
    alone = lgb.train(params, lgb.Dataset(spill), num_boost_round=3)
    assert loop_text == alone.model_to_string()


def test_refit_on_the_card_gives_the_same_bits_every_run(cuda):
    """The refit's per-leaf sums on the card add each leaf's rows in a
    sorted order (``ops/refit.py``): two refits of one model on one
    window give the same text, as a refresh loop's stable version must
    be reproducible from its checkpoint."""
    rng = np.random.RandomState(9)
    X = rng.randn(200000, 10)
    y = (X[:, 0] - X[:, 1] + 0.3 * rng.randn(200000) > 0).astype(float)
    bst = lgb.train({"objective": "binary", "num_leaves": 63,
                     "verbose": -1}, lgb.Dataset(X, label=y),
                    num_boost_round=3)
    text = bst.model_to_string()
    Xr = rng.randn(200000, 10)
    yr = (Xr[:, 0] + 0.3 * rng.randn(200000) > 0).astype(float)
    a = lgb.Booster(model_str=text).refit(Xr, yr).model_to_string()
    b = lgb.Booster(model_str=text).refit(Xr, yr).model_to_string()
    assert a == b and a != text
