#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``lightgbm_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each one fails the run if it fails):
1. print the card and its power limit; build every CUDA kernel of the
   port from ``lightgbm_tpu_torch/csrc`` (one ``nvcc`` per source, all
   started together) and print the build seconds;
2. hold every kernel against its plain PyTorch version on the card
   (f32 histogram with and without a row-index list, int8 -> int32);
3. train the binary slice at a small size on ``cuda`` and on ``cpu`` and
   compare the first tree and the held-out AUC;
4. train the full-size slice (10.5M Higgs-shaped rows x 28 features,
   255 leaves, 5 rounds) through ``lightgbm_tpu_torch.train``, predict a
   500k held-out set, and check that every histogram went through the
   kernel (launches == 1 + splits);
5. time every kernel at the main path's root shape against its plain
   version, one library call and its memory bound;
6. draw the quantized-gradient rows (threefry ``uniform`` and
   ``quantize_gh``) at 10.5M rows on the card and on the CPU from the
   same inputs: they must be byte-equal;
7. train the full-size data of phase 4 with quantized gradients
   (``quant_grad_bits=8``, 5 rounds): every histogram must go through the
   int8 instance (launches == 1 + splits, no f32 launch), the held-out
   AUC must pass 0.7, and a second run of 2 rounds must give the same
   two trees, text for text (integer histograms do not depend on the
   order of the atomics);
8. train 200k rows with ``quant_grad_bits=16`` and bagging on ``cuda``
   and on ``cpu``: tree 1 must make the same splits, through the int16
   instance on the card;

and print one ``{"kernels": [...]}`` line with the launches of each
kernel on the path that runs it (f32: phase 4, int8: phase 7, int16:
phase 8).

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", ...}}``. Without a visible
CUDA device, or without the ``lightgbm_tpu_torch`` package beside this
file, the script exits non-zero and prints no result.
``--phases 1,2`` runs a subset (for development; the full run is the
check).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
F32_OPS_PER_S = 67e12           # H100 SXM float32 rate outside tensor cores
INT8_OPS_PER_S = 1979e12        # H100 SXM int8 rate (the table's int8 row;
#                                 the published table has no other
#                                 integer row, so int16 rows use it too)

# tolerance of the f32 kernel against an f64 plain sum: the kernel adds
# f32 values with atomics in an undefined order. The rounding error of
# an f32 sum in any order is bounded by a multiple of eps * sum(|x|)
# over the summed values, not of |sum(x)| (which cancels for signed
# gradients), so each grad/hess bin is held to REL_TOL times the f64 sum
# of the absolute values of its rows (~170 f32 ulps of that magnitude).
# The count channels are sums of 0/1 below 2^24, exact in any order,
# and must match exactly.
REL_TOL = 1e-5

FULL_ROWS = 10_500_000
HELD_OUT_ROWS = 500_000
SMALL_ROWS = 200_000


def make_higgs_like(n_rows: int, n_features: int = 28, seed: int = 0):
    """Higgs-shaped synthetic data (copied from the reference bench):
    28 standard-normal columns, every 4th heavy-tailed, and a noisy
    linear-plus-interaction logit."""
    rng = np.random.RandomState(seed)
    X = np.empty((n_rows, n_features), dtype=np.float32)
    chunk = 1 << 20
    w = rng.randn(n_features).astype(np.float32) * 0.6
    for lo in range(0, n_rows, chunk):
        hi = min(lo + chunk, n_rows)
        block = rng.randn(hi - lo, n_features).astype(np.float32)
        block[:, ::4] = np.abs(block[:, ::4]) ** 1.5
        X[lo:hi] = block
    logit = np.zeros(n_rows, dtype=np.float32)
    for lo in range(0, n_rows, chunk):
        hi = min(lo + chunk, n_rows)
        logit[lo:hi] = (X[lo:hi] @ w +
                        0.5 * np.sin(X[lo:hi, 0]) * X[lo:hi, 1])
    y = (logit + rng.randn(n_rows).astype(np.float32) * 0.5 > 0).astype(
        np.float64)
    return X, y


def auc(y: np.ndarray, score: np.ndarray) -> float:
    order = np.argsort(score, kind="stable")
    ranks = np.empty(len(score), dtype=np.float64)
    ranks[order] = np.arange(1, len(score) + 1)
    pos = y > 0
    n_pos, n_neg = pos.sum(), (~pos).sum()
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit("FAILED: " + msg)


# ---------------------------------------------------------------------------
# phase 1: card, power limit, kernel builds
# ---------------------------------------------------------------------------
def phase_device_and_build(csrc):
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi unavailable"
    name = torch.cuda.get_device_name(0)
    log("card: %s" % card)
    log("torch %s cuda %s device %s" % (torch.__version__,
                                        torch.version.cuda, name))
    sources = csrc.sources()
    t0 = time.perf_counter()
    outputs = csrc.build(sources, ["-Xptxas", "-v"])
    for src in sources:
        csrc.load(src)
    log("kernel build seconds: %.3f (%s)"
        % (time.perf_counter() - t0, ", ".join(sources)))
    for src, out in outputs.items():
        log("nvcc %s.cu:\n%s" % (src, "\n".join(
            ln for ln in out.splitlines()
            if "registers" in ln or "spill" in ln)))
        log_atomics(csrc, csrc.library_path(src))
    return card, name


def log_atomics(csrc, lib_path: str) -> None:
    """Count the atomic instructions in a built kernel library's SASS:
    shared-memory adds compile to ATOMS.ADD for int32 and to a
    compare-and-swap loop (ATOMS.CAS*) for f32 on this card."""
    cuobjdump = os.path.join(os.path.dirname(csrc._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        log("cuobjdump not found; atomic instructions not counted")
        return
    sass = subprocess.run([cuobjdump, "-sass", lib_path],
                          capture_output=True, text=True, timeout=120).stdout
    counts = {}
    for tok in sass.split():
        if tok.startswith(("ATOMS", "ATOMG", "RED")):
            counts[tok.rstrip(";")] = counts.get(tok.rstrip(";"), 0) + 1
    log("atomic instructions in %s: %s" % (os.path.basename(lib_path),
                                          json.dumps(counts, sort_keys=True)))


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------
def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------
def make_hist_inputs(S: int, Fp: int, B: int, seed: int):
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    bins = torch.randint(0, B, (S, Fp), generator=g, device="cuda",
                         dtype=torch.int32).to(torch.uint8)
    bag = (torch.rand(S, generator=g, device="cuda") < 0.8).float()
    gh = torch.stack([torch.randn(S, generator=g, device="cuda") * bag,
                      torch.rand(S, generator=g, device="cuda") * bag,
                      bag, torch.ones(S, device="cuda")], dim=1)
    gh8 = torch.stack([
        torch.randint(-127, 128, (S,), generator=g, device="cuda"),
        torch.randint(0, 128, (S,), generator=g, device="cuda"),
        bag.long(), torch.ones(S, dtype=torch.long, device="cuda")],
        dim=1).to(torch.int8).contiguous()
    # int16 rows as large as the int32 accumulator allows at S rows
    q16 = (2 ** 31 - 1) // S
    gh16 = torch.stack([
        torch.randint(-q16, q16 + 1, (S,), generator=g, device="cuda"),
        torch.randint(0, q16 + 1, (S,), generator=g, device="cuda"),
        bag.long(), torch.ones(S, dtype=torch.long, device="cuda")],
        dim=1).to(torch.int16).contiguous()
    idx = torch.randperm(S, generator=g, device="cuda")[:S // 2]
    idx = idx.sort().values.to(torch.int32)
    return bins, gh.contiguous(), gh8, gh16, idx


def compare_f32(hist_mod, bins, gh, B, idx):
    """max abs error of the f32 kernel against an f64 plain sum; fails
    on a count-channel mismatch or a grad/hess sum out of tolerance."""
    import torch
    got = hist_mod.build_histogram(bins, gh, B, idx).double()
    torch.cuda.synchronize()
    ref = hist_mod.histogram_plain(bins, gh.double(), B, idx)
    check(torch.equal(got[..., 2:], ref[..., 2:]),
          "count channels of the f32 histogram differ (idx=%s)"
          % (idx is not None))
    err = (got[..., :2] - ref[..., :2]).abs()
    mag = hist_mod.histogram_plain(bins, gh[:, :2].double().abs(), B, idx)
    check(bool((err <= REL_TOL * mag).all()),
          "f32 histogram off its plain f64 sum by %.3g (idx=%s)"
          % (float(err.max()), idx is not None))
    return float(err.max())


def compare_int(hist_mod, bins, gh_int, B, idx):
    """An integer instance (int8 or int16 rows -> int32) must be
    byte-equal to its plain version."""
    import torch
    got = hist_mod.build_histogram(bins, gh_int, B, idx)
    torch.cuda.synchronize()
    ref = hist_mod.histogram_plain(bins, gh_int, B, idx)
    check(got.dtype == torch.int32 and torch.equal(got, ref),
          "%s histogram is not byte-equal to its plain version (idx=%s)"
          % (gh_int.dtype, idx is not None))
    return 0.0


def phase_kernels(hist_mod):
    S, Fp, B = 1 << 20, 32, 256
    bins, gh, gh8, gh16, idx = make_hist_inputs(S, Fp, B, seed=1)
    errs = dict.fromkeys(hist_mod.launch_counts, 0.0)
    for use_idx in (None, idx):
        e = compare_f32(hist_mod, bins, gh, B, use_idx)
        errs["histogram_f32"] = max(errs["histogram_f32"], e)
        compare_int(hist_mod, bins, gh8, B, use_idx)
        compare_int(hist_mod, bins, gh16, B, use_idx)
        log("kernel check S=%d Fp=%d B=%d C=4 idx=%s: f32 max_abs_err "
            "%.3g (tol %.0e x sum|x| per bin, counts exact), int8 and "
            "int16 byte-equal" % (S, Fp, B, use_idx is not None, e,
                                  REL_TOL))
    return errs


# ---------------------------------------------------------------------------
# phase 5: timing at the main path's root shape
# ---------------------------------------------------------------------------
def hist_bound_ms(S: int, Fp: int, B: int, C: int, gh_bytes: int,
                  with_idx: bool):
    moved = S * Fp + S * C * gh_bytes + (4 * S if with_idx else 0) \
        + Fp * B * C * 4
    ops = S * Fp * C
    rate = F32_OPS_PER_S if gh_bytes == 4 else INT8_OPS_PER_S
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_histogram(hist_mod, bins, gh, B, name):
    import torch
    S, Fp = bins.shape
    C = gh.shape[1]
    kernel_ms = cuda_ms(lambda: hist_mod.build_histogram(bins, gh, B))
    plain_ms = cuda_ms(lambda: hist_mod.histogram_plain(bins, gh, B),
                       reps=3, warm=1)
    acc = hist_mod.acc_dtype(gh.dtype)
    flat = (torch.arange(Fp, dtype=torch.int64, device="cuda")[None, :]
            * B + bins.long()).reshape(-1)
    vals = gh.to(acc)[:, None, :].expand(S, Fp, C).reshape(-1, C)
    out = torch.zeros(Fp * B, C, dtype=acc, device="cuda")
    library_ms = cuda_ms(lambda: out.index_add_(0, flat, vals), reps=3,
                         warm=1)
    del flat, vals, out
    bound, by = hist_bound_ms(S, Fp, B, C, gh.element_size(), False)
    log("%s at S=%d Fp=%d B=%d C=%d: kernel %.4f ms, plain %.4f ms, "
        "index_add_ %.4f ms, bound %.4f ms (%s)"
        % (name, S, Fp, B, C, kernel_ms, plain_ms, library_ms, bound, by))
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound, bound_by=by)


def phase_timing(hist_mod, bins, B, errs, launches):
    import torch
    S = bins.shape[0]
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    gh = torch.stack([torch.randn(S, generator=g, device="cuda"),
                      torch.rand(S, generator=g, device="cuda"),
                      torch.ones(S, device="cuda"),
                      torch.ones(S, device="cuda")], dim=1).contiguous()
    gh8 = torch.randint(-127, 128, (S, 4), generator=g, device="cuda",
                        dtype=torch.int32).to(torch.int8)
    q16 = (2 ** 31 - 1) // S          # the learner's 16-bit cap at S rows
    gh16 = torch.randint(-q16, q16 + 1, (S, 4), generator=g, device="cuda",
                         dtype=torch.int32).to(torch.int16)
    # the error at this shape too (f32 against an f64 plain sum)
    errs["histogram_f32"] = max(errs["histogram_f32"],
                                compare_f32(hist_mod, bins, gh, B, None))
    compare_int(hist_mod, bins, gh8, B, None)
    compare_int(hist_mod, bins, gh16, B, None)
    log("kernel check at the root shape S=%d: int8 and int16 (|q| <= %d) "
        "byte-equal" % (S, q16))
    # the int16 instance has no Pallas counterpart: the TPU package sends
    # int16 rows through its einsum (_tile_histogram)
    replaces = {"histogram_f32": "lightgbm_tpu/ops/histogram.py:223",
                "histogram_i8": "lightgbm_tpu/ops/histogram.py:223",
                "histogram_i16": "lightgbm_tpu/ops/histogram.py:202"}
    rows = []
    for name, rows_gh in (("histogram_f32", gh), ("histogram_i8", gh8),
                          ("histogram_i16", gh16)):
        t = time_histogram(hist_mod, bins, rows_gh, B, name)
        rows.append(dict(
            name=name, route="cuda",
            source="lightgbm_tpu_torch/csrc/histogram.cu",
            replaces=replaces[name], launches=launches[name],
            max_abs_err=errs[name], **t))
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4: the slice through the public API
# ---------------------------------------------------------------------------
SLICE_PARAMS = {"objective": "binary", "max_bin": 255,
                "min_data_in_leaf": 100, "learning_rate": 0.1,
                "metric": "auc", "verbosity": -1}


def tree_splits(booster):
    return [(list(t.split_feature[:t.num_internal]),
             list(t.threshold[:t.num_internal]))
            for t in booster.inner.models]


def phase_small(lgb, hist_mod, extra, kernel, auc_tol):
    """Train at 200k rows on cuda and on cpu; tree 1 must make the same
    splits, and the cuda run must go through ``kernel``. The held-out
    AUCs must agree within ``auc_tol`` where that is given (f32 sums run
    in another order on the card, so later trees may fork at
    near-ties)."""
    X, y = make_higgs_like(SMALL_ROWS + 50_000, seed=7)
    Xt, yt, Xv, yv = X[:SMALL_ROWS], y[:SMALL_ROWS], X[SMALL_ROWS:], \
        y[SMALL_ROWS:]
    import torch
    res = {}
    threads = torch.get_num_threads()
    for dev in ("cuda", "cpu"):
        # the CPU run is many small ops: one intra-op thread is fastest
        torch.set_num_threads(1 if dev == "cpu" else threads)
        params = dict(SLICE_PARAMS, num_leaves=63, device_type=dev, **extra)
        ds = lgb.Dataset(Xt, label=yt)
        evals = {}
        hist_mod.reset_launch_counts()
        t0 = time.perf_counter()
        bst = lgb.train(params, ds, num_boost_round=3,
                        valid_sets=[lgb.Dataset(Xv, label=yv, reference=ds)],
                        valid_names=["held_out"],
                        callbacks=[lgb.record_evaluation(evals)])
        log("small slice %s on %s: %.3f s" % (json.dumps(extra), dev,
                                              time.perf_counter() - t0))
        res[dev] = (tree_splits(bst)[0], evals["held_out"]["auc"][-1],
                    dict(hist_mod.launch_counts),
                    sum(t.num_leaves for t in bst.inner.models))
    torch.set_num_threads(threads)
    check(res["cuda"][0] == res["cpu"][0],
          "tree 1 differs between cuda and cpu at %d rows (%s)"
          % (SMALL_ROWS, json.dumps(extra)))
    if auc_tol is not None:
        check(abs(res["cuda"][1] - res["cpu"][1]) <= auc_tol,
              "held-out AUC cuda %.6f vs cpu %.6f" % (res["cuda"][1],
                                                      res["cpu"][1]))
    launches = res["cuda"][2]
    check(launches[kernel] == res["cuda"][3] and
          sum(launches.values()) == launches[kernel],
          "small slice on cuda: launches %s, expected %d of %s only"
          % (launches, res["cuda"][3], kernel))
    check(sum(res["cpu"][2].values()) == 0, "the cpu run launched a kernel")
    log("small slice (%d rows, 63 leaves, 3 rounds, %s): tree 1 splits "
        "equal on cuda and cpu; held-out AUC cuda %.6f cpu %.6f; %d "
        "launches of %s on cuda"
        % (SMALL_ROWS, json.dumps(extra), res["cuda"][1], res["cpu"][1],
           launches[kernel], kernel))
    return launches


class _EventTimer:
    """CUDA events around every call of a function. ``patch`` is a plain
    function, so it can stand in for a module function or, set on a
    class, for a method."""

    def __init__(self, fn):
        self.fn = fn
        self.events = []
        self.patch = lambda *args, **kwargs: self(*args, **kwargs)

    def __call__(self, *args, **kwargs):
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args, **kwargs)
        end.record()
        self.events.append((start, end))
        return out

    def each_ms(self):
        return [a.elapsed_time(b) for a, b in self.events]

    def total_ms(self) -> float:
        return sum(self.each_ms())


def full_data(lgb):
    """The full-size data of phases 4 and 7: 10.5M Higgs-shaped training
    rows binned at max_bin 255, and a 500k held-out set."""
    t0 = time.perf_counter()
    X, y = make_higgs_like(FULL_ROWS + HELD_OUT_ROWS)
    Xt, yt = X[:FULL_ROWS], y[:FULL_ROWS]
    Xv, yv = X[FULL_ROWS:], y[FULL_ROWS:]
    log("full size: generated %d + %d rows x %d in %.1f s"
        % (FULL_ROWS, HELD_OUT_ROWS, X.shape[1], time.perf_counter() - t0))
    t0 = time.perf_counter()
    ds = lgb.Dataset(Xt, label=yt, params=SLICE_PARAMS).construct()
    valid = lgb.Dataset(Xv, label=yv, reference=ds).construct()
    log("binning seconds: %.3f" % (time.perf_counter() - t0))
    return ds, valid, Xv, yv


def train_full(lgb, hist_mod, data, extra, kernel, rounds=5):
    """Train the full-size data through ``lightgbm_tpu_torch.train``
    with the launch counts set to 0 just before and read just after;
    every histogram must go through ``kernel`` (launches == 1 + splits,
    no other instance launched). Returns (booster, launches, held-out
    AUC per round, seconds per iteration, quantize ms per tree)."""
    import torch
    from lightgbm_tpu_torch.treelearner import serial
    ds, valid, _, _ = data
    params = dict(SLICE_PARAMS, num_leaves=255, **extra)
    hist_timer = _EventTimer(serial.build_histogram)
    quant_timer = _EventTimer(serial.SerialTreeLearner._quantize_stage)
    grow = serial.SerialTreeLearner.train
    tree_seconds = []

    def timed_grow(self, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = grow(self, *args)
        torch.cuda.synchronize()
        tree_seconds.append(time.perf_counter() - t)
        return out
    iter_starts = []

    def mark(env):
        torch.cuda.synchronize()
        iter_starts.append(time.perf_counter())
    mark.before_iteration = True
    evals = {}
    serial.build_histogram = hist_timer.patch
    serial.SerialTreeLearner._quantize_stage = quant_timer.patch
    serial.SerialTreeLearner.train = timed_grow
    torch.cuda.reset_peak_memory_stats()
    hist_mod.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        bst = lgb.train(params, ds, num_boost_round=rounds,
                        valid_sets=[valid], valid_names=["held_out"],
                        callbacks=[mark, lgb.record_evaluation(evals)])
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = dict(hist_mod.launch_counts)
    finally:
        serial.build_histogram = hist_timer.fn
        serial.SerialTreeLearner._quantize_stage = quant_timer.fn
        serial.SerialTreeLearner.train = grow
    peak = torch.cuda.max_memory_allocated()
    iter_starts.append(time.perf_counter())
    per_iter = list(np.diff(iter_starts))
    trees = bst.inner.models
    splits = sum(t.num_leaves - 1 for t in trees)
    check(len(trees) == rounds, "expected %d trees, got %d"
          % (rounds, len(trees)))
    check(all(t.num_leaves > 1 for t in trees), "a tree has one leaf")
    check(launches[kernel] == len(trees) + splits,
          "%s launches %d != 1 + splits summed over trees (%d)"
          % (kernel, launches[kernel], len(trees) + splits))
    check(sum(launches.values()) == launches[kernel],
          "another histogram instance was launched: %s" % launches)
    hist_ms = hist_timer.total_ms()
    quant_ms = quant_timer.each_ms()
    log("train %s: %.3f s for %d rounds; seconds per tree: %s; seconds "
        "per iteration (tree + gradients + held-out eval): %s; leaves per "
        "tree: %s" % (json.dumps(extra), t_train, rounds,
                      " ".join("%.3f" % v for v in tree_seconds),
                      " ".join("%.3f" % v for v in per_iter),
                      [t.num_leaves for t in trees]))
    log("histogram kernel time %.1f ms = %.1f%% of tree time (%.3f s); "
        "%d launches of %s (= %d roots + %d splits)%s"
        % (hist_ms, 100.0 * hist_ms / 1e3 / sum(tree_seconds),
           sum(tree_seconds), launches[kernel], kernel, len(trees), splits,
           "; quantize stage ms per tree: " + " ".join(
               "%.3f" % v for v in quant_ms) if quant_ms else ""))
    log("peak torch.cuda.max_memory_allocated: %.3f GiB"
        % (peak / 2 ** 30))
    return bst, launches, evals["held_out"]["auc"], per_iter, quant_ms


def check_predict(bst, data, device_auc):
    """Host-walk predictions of the held-out set: finite, of the right
    shape, AUC > 0.7 and equal to the device valid-score AUC."""
    _, _, Xv, yv = data
    t0 = time.perf_counter()
    pred = bst.predict(Xv)
    t_pred = time.perf_counter() - t0
    check(pred.shape == (HELD_OUT_ROWS,) and bool(np.isfinite(pred).all()),
          "predictions are not finite or of the wrong shape")
    a = auc(yv, pred)
    check(a > 0.7, "held-out AUC %.4f <= 0.7" % a)
    check(abs(a - device_auc[-1]) < 1e-4,
          "host-walk AUC %.6f != device valid-score AUC %.6f"
          % (a, device_auc[-1]))
    log("predict (host walk): %d rows in %.3f s = %.0f rows/s; held-out "
        "AUC %.6f (per round: %s)"
        % (HELD_OUT_ROWS, t_pred, HELD_OUT_ROWS / t_pred, a,
           " ".join("%.6f" % v for v in device_auc)))
    return a


def phase_full(lgb, hist_mod, data):
    """The main path at full size (f32 gradients); returns (booster,
    launches, held-out AUC)."""
    bst, launches, aucs, _, _ = train_full(lgb, hist_mod, data, {},
                                           "histogram_f32")
    return bst, launches, check_predict(bst, data, aucs)


# ---------------------------------------------------------------------------
# phase 6: quantized rows on the card against the CPU
# ---------------------------------------------------------------------------
def phase_quantize():
    """``uniform`` and ``quantize_gh`` at N = 10.5M on cuda and cpu from
    the same inputs and key: byte-equal (integer threefry and IEEE f32
    division are exact on both)."""
    import torch
    from lightgbm_tpu_torch.ops import quantize as Q
    from lightgbm_tpu_torch.utils import prng
    N = FULL_ROWS
    rng = np.random.RandomState(11)
    # binary-objective-like rows: grad = p - y in (-1, 1), hess = p(1-p)
    p = rng.rand(N).astype(np.float32)
    y = (rng.rand(N) < 0.5).astype(np.float32)
    host = {"grad": p - y, "hess": p * (1.0 - p),
            "ind": (rng.rand(N) < 0.8).astype(np.float32)}
    out = {}
    for dev in ("cuda", "cpu"):
        t = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        key = Q.tree_key(prng.PRNGKey(0, dev), 1)
        res = {"u": prng.uniform(key, (N, 2)).view(torch.int32)}
        for bits in (8, 16):
            qmax = Q.effective_quant_max(bits, N)
            gh, qs = Q.quantize_gh(t["grad"], t["hess"], t["ind"], key,
                                   qmax, Q.quant_dtype(bits))
            res["gh%d" % bits] = gh
            res["qscale%d" % bits] = qs.view(torch.int32)
        if dev == "cuda":
            torch.cuda.synchronize()
            ms = {
                "uniform": cuda_ms(lambda: prng.uniform(key, (N, 2)),
                                   reps=5, warm=1),
                "quantize_gh_8": cuda_ms(lambda: Q.quantize_gh(
                    t["grad"], t["hess"], t["ind"], key,
                    Q.effective_quant_max(8, N), torch.int8),
                    reps=5, warm=1)}
        out[dev] = {k: v.cpu() for k, v in res.items()}
    for k in out["cpu"]:
        check(torch.equal(out["cuda"][k], out["cpu"][k]),
              "quantized rows differ between cuda and cpu: %s" % k)
    log("quantize at N=%d: uniform bits, int8 and int16 rows and scales "
        "byte-equal on cuda and cpu (qmax 8-bit %d, 16-bit %d); card "
        "uniform %.3f ms, quantize_gh 8-bit %.3f ms"
        % (N, Q.effective_quant_max(8, N), Q.effective_quant_max(16, N),
           ms["uniform"], ms["quantize_gh_8"]))


# ---------------------------------------------------------------------------
# phase 7: quantized training at full size
# ---------------------------------------------------------------------------
def phase_full_quantized(lgb, hist_mod, data, f32_auc):
    """Quantized-gradient training (8 bits) on the data of phase 4; a
    second run of 2 rounds must give the same first two trees."""
    extra = {"use_quantized_grad": True, "quant_grad_bits": 8}
    bst, launches, aucs, per_iter, quant_ms = train_full(
        lgb, hist_mod, data, extra, "histogram_i8")
    a = check_predict(bst, data, aucs)
    log("quantized (8-bit) vs f32 held-out AUC: %.6f vs %s (gap %s); "
        "mean seconds per iteration %.3f; mean quantize ms per tree %.3f"
        % (a, "%.6f" % f32_auc if f32_auc is not None else "not run",
           "%+.6f" % (a - f32_auc) if f32_auc is not None else "n/a",
           float(np.mean(per_iter)), float(np.mean(quant_ms))))
    again, _, _, _, _ = train_full(lgb, hist_mod, data, extra,
                                   "histogram_i8", rounds=2)
    first = [t.to_string() for t in bst.inner.models[:2]]
    second = [t.to_string() for t in again.inner.models]
    check(first == second, "a second quantized run gave other trees")
    log("quantized rerun (2 rounds): trees 1 and 2 text-equal to the first "
        "run's")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8",
                    help="comma-separated subset of phases to run")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",") if p}

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "lightgbm_tpu_torch")):
        print("chip_smoke: lightgbm_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    from lightgbm_tpu_torch import csrc
    from lightgbm_tpu_torch.ops import histogram as hist_mod

    t_start = time.perf_counter()
    card, name = phase_device_and_build(csrc)
    errs = dict.fromkeys(hist_mod.launch_counts, 0.0)
    if 2 in phases:
        errs = phase_kernels(hist_mod)
    import lightgbm_tpu_torch as lgb
    # launches of each kernel on the path that runs it
    launches = dict.fromkeys(hist_mod.launch_counts, 0)
    if 3 in phases:
        phase_small(lgb, hist_mod, {}, "histogram_f32", 1e-3)
    data = full_data(lgb) if phases & {4, 5, 7} else None
    bins_root, f32_auc = None, None
    if 4 in phases:
        bst, run, f32_auc = phase_full(lgb, hist_mod, data)
        launches["histogram_f32"] = run["histogram_f32"]
        bins_root = bst.inner.learner.bins
        del bst
    rows = None
    if 5 in phases:
        if bins_root is None:
            g = torch.Generator(device="cuda")
            g.manual_seed(3)
            bins_root = torch.randint(0, 255, (FULL_ROWS, 32), generator=g,
                                      device="cuda", dtype=torch.int32
                                      ).to(torch.uint8)
        rows = phase_timing(hist_mod, bins_root, 256, errs, launches)
    del bins_root
    if 6 in phases:
        phase_quantize()
    if 7 in phases:
        run = phase_full_quantized(lgb, hist_mod, data, f32_auc)
        launches["histogram_i8"] = run["histogram_i8"]
    if 8 in phases:
        run = phase_small(lgb, hist_mod,
                          {"use_quantized_grad": True, "quant_grad_bits": 16,
                           "bagging_fraction": 0.8, "bagging_freq": 1},
                          "histogram_i16", None)
        launches["histogram_i16"] = run["histogram_i16"]
    if rows is not None:
        for row in rows:
            row["launches"] = launches[row["name"]]
        log(json.dumps({"kernels": rows}))
    log("chip_smoke seconds: %.1f" % (time.perf_counter() - t_start))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
