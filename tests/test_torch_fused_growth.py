"""The port's whole-tree loop (``tpu_fused_tree=true``, the default)
against its per-split loop and against the JAX package, on the CPU.

Mirrors tests/test_fused_growth.py (TestFusedVsSteppedParity): the
whole-tree loop gives exactly the per-split loop's trees (per-tree
``to_string``) and train-score bits (level a) over exact, 8-bit and
16-bit quantized gradients, plain and balanced bagging, ``max_depth``,
multiclass, lambdarank and l1 with leaf renewal. A tree that ends
before ``num_leaves`` leaves the device state (partition, histograms,
candidates, depths, records) byte-equal to the per-split loop's, the
trees do not depend on the chunk between two counter reads, and the
split step makes no host read. The histogram's device-count plan
mirrors ``launch_plan``, and its plain version with ``(idx, count)``
equals the trimmed list. Against the JAX package's default (fused)
learner the verify flow holds level (b), as in tests/test_torch_train.py.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

import lightgbm_tpu as ref_lgb
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.metric import weighted_auc
from lightgbm_tpu_torch.ops import histogram as H
from lightgbm_tpu_torch.treelearner import serial

torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 15, "verbose": -1,
        "device_type": "cpu"}


def _data(n=2000, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    X[rng.rand(n) < 0.1, 2] = np.nan      # a NaN-missing feature
    X[rng.rand(n) < 0.3, 3] = 0.0         # a column with many zeros
    y = (X[:, 0] + 0.7 * X[:, 1] + 0.3 * rng.randn(n) > 0).astype(float)
    return X, y


def _rank_data(seed=1, num_queries=60):
    rng = np.random.RandomState(seed)
    group = rng.randint(2, 61, size=num_queries)
    n = int(group.sum())
    X = rng.randn(n, 8)
    rel = X[:, 0] + 0.5 * X[:, 1] + 0.5 * rng.randn(n)
    return X, np.clip(np.floor(rel + 1.5), 0, 4), group


def _train(params, rounds=3):
    X, y = _data()
    group = None
    if params.get("objective") == "multiclass":
        y = np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.5, 0.5]).astype(float)
    elif params.get("objective") == "regression_l1":
        y = X[:, 0] + X[:, 1] ** 2
    elif params.get("objective") == "lambdarank":
        X, y, group = _rank_data()
    return lgb.train(params, lgb.Dataset(X, label=y, group=group),
                     num_boost_round=rounds)


def _score_bits(booster):
    return booster.inner.train_score.numpy().view(np.uint32).copy()


PARITY = {
    "exact": {},
    "quantized8": {"use_quantized_grad": True},
    "quantized16": {"use_quantized_grad": True, "quant_grad_bits": 16},
    "bagging": {"bagging_fraction": 0.7, "bagging_freq": 1},
    "balanced_bagging": {"pos_bagging_fraction": 0.6,
                         "neg_bagging_fraction": 0.8, "bagging_freq": 1},
    "max_depth3": {"num_leaves": 31, "max_depth": 3},
    "multiclass3": {"objective": "multiclass", "num_class": 3},
    "lambdarank": {"objective": "lambdarank", "num_leaves": 31,
                   "eval_at": "1,3,5"},
    "regression_l1_renewal": {"objective": "regression_l1",
                              "num_leaves": 31},
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_whole_tree_equals_per_split(case):
    """Level (a): the same tree text, tree by tree, and the same
    train-score bits."""
    params = dict(BASE, **PARITY[case])
    fused = _train(dict(params, tpu_fused_tree=True))
    stepped = _train(dict(params, tpu_fused_tree=False))
    assert fused.inner.learner._fused_growth
    assert not stepped.inner.learner._fused_growth
    assert [t.to_string() for t in fused.inner.models] == \
        [t.to_string() for t in stepped.inner.models]
    assert np.array_equal(_score_bits(fused), _score_bits(stepped))
    stats = fused.inner.learner.grow_stats
    trees = len(fused.inner.models)
    assert stats["roots"] == stats["record_reads"] == trees
    assert stats["steps"] >= sum(t.num_leaves - 1
                                 for t in fused.inner.models)
    assert stepped.inner.learner.grow_stats["steps"] == sum(
        t.num_leaves - 1 for t in stepped.inner.models)


def test_fused_tree_is_the_default():
    assert Config.from_params({}).tpu_fused_tree is True
    booster = _train(dict(BASE), rounds=1)
    learner = booster.inner.learner
    assert learner._fused_growth
    assert learner.grow_stats["record_reads"] == 1
    # one read of the whole tree's records: no per-split read-back
    assert learner.grow_stats["flag_reads"] == 0


def _learner_and_rows(extra, seed=3):
    X, y = _data(seed=seed)
    params = dict(BASE, **extra)
    booster = lgb.Booster(params, lgb.Dataset(X, label=y))
    learner = booster.inner.learner
    g = torch.from_numpy(
        (np.random.RandomState(seed).rand(len(y)) - y).astype(np.float32))
    h = torch.full_like(g, 0.25)
    gh = torch.stack([g, h, torch.ones_like(g), torch.ones_like(g)], dim=1)
    return learner, gh


def _states_equal(a, b):
    for name in ("leaf_of_row", "hists", "cand", "leaf_depth", "step",
                 "records"):
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype.is_floating_point:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), name


@pytest.mark.parametrize("extra", [
    pytest.param({"num_leaves": 31, "min_data_in_leaf": 200},
                 id="min_data"),
    pytest.param({"num_leaves": 31, "max_depth": 2}, id="max_depth2"),
])
def test_early_end_leaves_state_equal(extra):
    """A tree that runs out of valid candidates before num_leaves: the
    steps after its end change nothing, so the final partition,
    histograms, candidates, depths, step counter and records equal the
    per-split loop's byte for byte."""
    learner, gh = _learner_and_rows(extra)
    tree_f, st_f = learner._grow_fused(gh)
    st_f = serial.GrowState(*[t.clone() for t in st_f])
    tree_s, st_s = learner._grow_stepped(gh)
    assert 1 < tree_f.num_leaves < learner.L
    assert tree_f.to_string() == tree_s.to_string()
    assert int(st_f.step) == tree_f.num_leaves - 1
    _states_equal(st_f, st_s)


@pytest.mark.parametrize("chunk", [1, 3, 4])
def test_trees_do_not_depend_on_the_chunk(monkeypatch, chunk):
    """The chunk between two counter reads only decides when the loop
    stops: a tree that ends early stops at the end of its chunk, with
    one counter read per chunk, and gives the same tree."""
    learner, gh = _learner_and_rows({"num_leaves": 31,
                                     "min_data_in_leaf": 200})
    want, _ = learner._grow_stepped(gh)
    monkeypatch.setattr(serial, "FUSED_CHUNK", chunk)
    before = dict(learner.grow_stats)
    got, st = learner._grow_fused(gh)
    assert got.to_string() == want.to_string()
    splits = want.num_leaves - 1
    steps = learner.grow_stats["steps"] - before["steps"]
    reads = learner.grow_stats["flag_reads"] - before["flag_reads"]
    # the loop stops at the first chunk end past the tree's last split
    assert steps == -(-(splits + 1) // chunk) * chunk
    assert reads == steps // chunk


_HOST_READS = ("aten::_local_scalar_dense", "aten::nonzero",
               "aten::masked_select", "aten::is_nonzero", "aten::unique")


class _NoHostRead(TorchDispatchMode):
    """Records every op that reads a tensor back to the host (``.item()``,
    ``int()``/``bool()`` of a tensor, indexing with a 0-d tensor,
    ``nonzero``, boolean-mask indexing)."""

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name()
        if name.startswith(_HOST_READS) or (
                name.startswith(("aten::index.", "aten::index_put"))
                and any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                        for i in (args[1] if len(args) > 1 else ())
                        if i is not None)):
            self.reads.append(name)
        return func(*args, **(kwargs or {}))


def _histogram_outside_mode(monkeypatch):
    """On the card the histogram is the kernel, which reads its row
    count on the device; its plain CPU version trims the list on the
    host, so it runs outside the recording mode."""
    real = serial.build_histogram

    def hist(*args, **kwargs):
        with _disable_current_modes():
            return real(*args, **kwargs)
    monkeypatch.setattr(serial, "build_histogram", hist)


@pytest.mark.parametrize("extra", [
    pytest.param({}, id="exact"),
    pytest.param({"use_quantized_grad": True}, id="quantized8"),
    pytest.param({"num_leaves": 31, "max_depth": 3}, id="max_depth3"),
])
def test_split_step_makes_no_host_read(monkeypatch, extra):
    learner, gh = _learner_and_rows(extra)
    if learner._quantized:
        gh, learner._qscale = learner._quantize_stage(
            gh[:, 0].contiguous(), gh[:, 1].contiguous(), gh[:, 2], 1)
    buf = learner._fused_buffers(gh)
    learner._root(buf.state)
    _histogram_outside_mode(monkeypatch)
    with _NoHostRead() as mode:
        for _ in range(learner.L + 2):   # past the tree's end too
            learner._step(buf)
    assert mode.reads == []
    assert int(buf.state.step) > 0


def test_the_host_read_check_sees_the_per_split_loop(monkeypatch):
    """The check above is not blind: the per-split loop's record
    read-back and ``nonzero`` are host reads."""
    learner, gh = _learner_and_rows({})
    _histogram_outside_mode(monkeypatch)
    with _NoHostRead() as mode:
        learner._grow_stepped(gh)
    assert "aten::nonzero" in mode.reads
    assert "aten::_local_scalar_dense" in mode.reads


def test_whole_tree_port_vs_reference_default_learner():
    """The verify flow (2000 x 10, binary, 15 leaves, 20 rounds) through
    the port's whole-tree loop and the JAX package's default fused
    learner: every tree the same splits and leaf counts, leaf values
    within 1e-4 (level b), AUC within 1e-6 (level c), as
    tests/test_torch_train.py holds them."""
    rng = np.random.RandomState(0)
    X = rng.randn(2000, 10)
    y = (X[:, 0] + X[:, 1] > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "tpu_fused_tree": True}
    ref = ref_lgb.train(params, ref_lgb.Dataset(X, label=y),
                        num_boost_round=20)
    port = lgb.train(dict(params, device_type="cpu"),
                     lgb.Dataset(X, label=y), num_boost_round=20)
    assert ref.inner.learner._fused_growth
    assert port.inner.learner._fused_growth
    assert len(ref.inner.models) == len(port.inner.models) == 20

    def splits(t):
        ni = t.num_internal
        return (t.num_leaves, t.split_feature[:ni].tolist(),
                t.threshold[:ni].tolist(),
                t.leaf_count[:t.num_leaves].tolist())
    for i, (a, b) in enumerate(zip(ref.inner.models, port.inner.models)):
        assert splits(a) == splits(b), "tree %d differs" % i
        np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                   a.leaf_value[:a.num_leaves],
                                   rtol=1e-4, atol=1e-6)
    assert abs(weighted_auc(y, port.predict(X), None)
               - weighted_auc(y, ref.predict(X), None)) <= 1e-6


def _sampled_rows():
    """1 .. 3M: every n up to 2100, the boundaries of every block count
    (multiples of 1024 and of the block counts around them), and a
    random sample above."""
    ns = set(range(1, 2101))
    for b in range(1, 133):
        for base in (1024 * b, 1024 * b * 2, 132 * 1024 * b):
            ns.update(n for n in (base - 1, base, base + 1) if n >= 1)
    ns.update(np.random.RandomState(0).randint(1, 3_000_001, 4000).tolist())
    ns.add(3_000_000)
    return sorted(n for n in ns if n <= 3_000_000)


@pytest.mark.parametrize("Fp", [32, 56, 136])
def test_device_plan_equals_launch_plan(Fp):
    """The device-count entry plans its blocks from n exactly as the
    host plans them: the same blocks and rows per block, so both
    entries sum the same rows in the same blocks."""
    plan = H.launch_plan(1, Fp, 256, 4, torch.float32, 132)
    for n in _sampled_rows():
        host = H.launch_plan(n, Fp, 256, 4, torch.float32, 132)
        assert H.device_plan(n, 132, plan.groups) == \
            (host.blocks, host.rows_per_block), n


def test_device_plan_of_no_rows():
    assert H.device_plan(0, 132, 1) == (1, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8, torch.int16])
def test_plain_histogram_with_count_equals_trimmed_list(dtype):
    rng = np.random.RandomState(4)
    N, F, B = 3000, 16, 64
    bins = torch.from_numpy(rng.randint(0, B, (N, F)).astype(np.uint8))
    if dtype.is_floating_point:
        gh = torch.from_numpy(rng.randn(N, 4).astype(np.float32))
    else:
        gh = torch.from_numpy(rng.randint(-100, 100, (N, 4))).to(dtype)
    rows = np.sort(rng.choice(N, 1200, replace=False)).astype(np.int32)
    buf = torch.full((N + 1,), N, dtype=torch.int32)
    buf[:len(rows)] = torch.from_numpy(rows)
    for n in (0, 1, 31, 1024, 1200):
        got = H.build_histogram(bins, gh, B, buf,
                                torch.tensor([n], dtype=torch.int32))
        want = H.build_histogram(bins, gh, B, buf[:n])
        if dtype.is_floating_point:
            got, want = got.view(torch.int32), want.view(torch.int32)
        assert torch.equal(got, want), n
    assert not H.histogram_plain(bins, gh, B, buf,
                                 torch.tensor([0], dtype=torch.int32)).any()
