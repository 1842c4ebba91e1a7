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
   version, one library call and its memory bound, and print one
   ``{"kernels": [...]}`` line.

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
INT8_OPS_PER_S = 1979e12        # H100 SXM int8 rate (the table's int8 row)

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
    idx = torch.randperm(S, generator=g, device="cuda")[:S // 2]
    idx = idx.sort().values.to(torch.int32)
    return bins, gh.contiguous(), gh8, idx


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


def compare_i8(hist_mod, bins, gh8, B, idx):
    import torch
    got = hist_mod.build_histogram(bins, gh8, B, idx)
    torch.cuda.synchronize()
    ref = hist_mod.histogram_plain(bins, gh8, B, idx)
    check(got.dtype == torch.int32 and torch.equal(got, ref),
          "int8 histogram is not byte-equal to its plain version "
          "(idx=%s)" % (idx is not None))
    return 0.0


def phase_kernels(hist_mod):
    S, Fp, B = 1 << 20, 32, 256
    bins, gh, gh8, idx = make_hist_inputs(S, Fp, B, seed=1)
    errs = {"histogram_f32": 0.0, "histogram_i8": 0.0}
    for use_idx in (None, idx):
        e = compare_f32(hist_mod, bins, gh, B, use_idx)
        errs["histogram_f32"] = max(errs["histogram_f32"], e)
        compare_i8(hist_mod, bins, gh8, B, use_idx)
        log("kernel check S=%d Fp=%d B=%d C=4 idx=%s: f32 max_abs_err "
            "%.3g (tol %.0e x sum|x| per bin, counts exact), int8 "
            "byte-equal" % (S, Fp, B, use_idx is not None, e, REL_TOL))
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
    # the error at this shape too (f32 against an f64 plain sum)
    errs["histogram_f32"] = max(errs["histogram_f32"],
                                compare_f32(hist_mod, bins, gh, B, None))
    compare_i8(hist_mod, bins, gh8, B, None)
    replaces = "lightgbm_tpu/ops/histogram.py:223"
    rows = []
    for name, rows_gh in (("histogram_f32", gh), ("histogram_i8", gh8)):
        t = time_histogram(hist_mod, bins, rows_gh, B, name)
        rows.append(dict(
            name=name, route="cuda",
            source="lightgbm_tpu_torch/csrc/histogram.cu",
            replaces=replaces, launches=launches[name],
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


def phase_small(lgb):
    """Train at 200k rows on cuda and on cpu; tree 1 must make the same
    splits and the held-out AUCs agree within 1e-3 (f32 sums run in
    another order on the card, so later trees may fork at near-ties)."""
    X, y = make_higgs_like(SMALL_ROWS + 50_000, seed=7)
    Xt, yt, Xv, yv = X[:SMALL_ROWS], y[:SMALL_ROWS], X[SMALL_ROWS:], \
        y[SMALL_ROWS:]
    import torch
    res = {}
    threads = torch.get_num_threads()
    for dev in ("cuda", "cpu"):
        # the CPU run is many small ops: one intra-op thread is fastest
        torch.set_num_threads(1 if dev == "cpu" else threads)
        params = dict(SLICE_PARAMS, num_leaves=63, device_type=dev)
        ds = lgb.Dataset(Xt, label=yt)
        evals = {}
        t0 = time.perf_counter()
        bst = lgb.train(params, ds, num_boost_round=3,
                        valid_sets=[lgb.Dataset(Xv, label=yv, reference=ds)],
                        valid_names=["held_out"],
                        callbacks=[lgb.record_evaluation(evals)])
        log("small slice on %s: %.3f s" % (dev, time.perf_counter() - t0))
        res[dev] = (tree_splits(bst)[0], evals["held_out"]["auc"][-1])
    torch.set_num_threads(threads)
    check(res["cuda"][0] == res["cpu"][0],
          "tree 1 differs between cuda and cpu at %d rows" % SMALL_ROWS)
    check(abs(res["cuda"][1] - res["cpu"][1]) <= 1e-3,
          "held-out AUC cuda %.6f vs cpu %.6f" % (res["cuda"][1],
                                                  res["cpu"][1]))
    log("small slice (%d rows, 63 leaves, 3 rounds): tree 1 splits equal "
        "on cuda and cpu; held-out AUC cuda %.6f cpu %.6f"
        % (SMALL_ROWS, res["cuda"][1], res["cpu"][1]))


class _HistTimer:
    """CUDA events around every histogram call of the learner, to give
    the histogram's share of tree time."""

    def __init__(self, fn):
        self.fn = fn
        self.events = []

    def __call__(self, *args, **kwargs):
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args, **kwargs)
        end.record()
        self.events.append((start, end))
        return out

    def total_ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events)


def phase_full(lgb, hist_mod):
    """The main path at full size; returns (booster, launches)."""
    import torch
    from lightgbm_tpu_torch.treelearner import serial
    t0 = time.perf_counter()
    X, y = make_higgs_like(FULL_ROWS + HELD_OUT_ROWS)
    Xt, yt = X[:FULL_ROWS], y[:FULL_ROWS]
    Xv, yv = X[FULL_ROWS:], y[FULL_ROWS:]
    log("full size: generated %d + %d rows x %d in %.1f s"
        % (FULL_ROWS, HELD_OUT_ROWS, X.shape[1], time.perf_counter() - t0))
    params = dict(SLICE_PARAMS, num_leaves=255)
    t0 = time.perf_counter()
    ds = lgb.Dataset(Xt, label=yt, params=params).construct()
    valid = lgb.Dataset(Xv, label=yv, reference=ds).construct()
    log("binning seconds: %.3f" % (time.perf_counter() - t0))

    timer = _HistTimer(serial.build_histogram)
    serial.build_histogram = timer
    grow = serial.SerialTreeLearner.train
    tree_seconds = []

    def timed_grow(self, grad, hess):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = grow(self, grad, hess)
        torch.cuda.synchronize()
        tree_seconds.append(time.perf_counter() - t)
        return out
    serial.SerialTreeLearner.train = timed_grow
    iter_starts = []

    def mark(env):
        torch.cuda.synchronize()
        iter_starts.append(time.perf_counter())
    mark.before_iteration = True
    evals = {}
    torch.cuda.reset_peak_memory_stats()
    hist_mod.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        bst = lgb.train(params, ds, num_boost_round=5, valid_sets=[valid],
                        valid_names=["held_out"],
                        callbacks=[mark, lgb.record_evaluation(evals)])
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
    finally:
        serial.build_histogram = timer.fn
        serial.SerialTreeLearner.train = grow
    launches = dict(hist_mod.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    iter_starts.append(time.perf_counter())
    per_iter = np.diff(iter_starts)
    trees = bst.inner.models
    splits = sum(t.num_leaves - 1 for t in trees)
    check(len(trees) == 5, "expected 5 trees, got %d" % len(trees))
    check(all(t.num_leaves > 1 for t in trees), "a tree has one leaf")
    check(launches["histogram_f32"] == len(trees) + splits,
          "histogram launches %d != 1 + splits summed over trees (%d)"
          % (launches["histogram_f32"], len(trees) + splits))
    hist_ms = timer.total_ms()
    log("train: %.3f s for 5 rounds; seconds per tree: %s; seconds per "
        "iteration (tree + gradients + held-out eval): %s; leaves per "
        "tree: %s" % (t_train, " ".join("%.3f" % v for v in tree_seconds),
                      " ".join("%.3f" % v for v in per_iter),
                      [t.num_leaves for t in trees]))
    log("histogram kernel time %.1f ms = %.1f%% of tree time (%.3f s); "
        "%d launches (= 5 roots + %d splits)"
        % (hist_ms, 100.0 * hist_ms / 1e3 / sum(tree_seconds),
           sum(tree_seconds), launches["histogram_f32"], splits))
    log("peak torch.cuda.max_memory_allocated: %.3f GiB"
        % (peak / 2 ** 30))
    t0 = time.perf_counter()
    pred = bst.predict(Xv)
    t_pred = time.perf_counter() - t0
    check(pred.shape == (HELD_OUT_ROWS,) and bool(np.isfinite(pred).all()),
          "predictions are not finite or of the wrong shape")
    a = auc(yv, pred)
    check(a > 0.7, "held-out AUC %.4f <= 0.7" % a)
    check(abs(a - evals["held_out"]["auc"][-1]) < 1e-4,
          "host-walk AUC %.6f != device valid-score AUC %.6f"
          % (a, evals["held_out"]["auc"][-1]))
    log("predict (host walk): %d rows in %.3f s = %.0f rows/s; held-out "
        "AUC %.6f (per round: %s)"
        % (HELD_OUT_ROWS, t_pred, HELD_OUT_ROWS / t_pred, a,
           " ".join("%.6f" % v for v in evals["held_out"]["auc"])))
    return bst, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5",
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

    card, name = phase_device_and_build(csrc)
    errs = {"histogram_f32": 0.0, "histogram_i8": 0.0}
    if 2 in phases:
        errs = phase_kernels(hist_mod)
    import lightgbm_tpu_torch as lgb
    if 3 in phases:
        phase_small(lgb)
    launches = {k: 0 for k in hist_mod.launch_counts}
    bins_root = None
    if 4 in phases:
        bst, launches = phase_full(lgb, hist_mod)
        bins_root = bst.inner.learner.bins
    if 5 in phases:
        if bins_root is None:
            g = torch.Generator(device="cuda")
            g.manual_seed(3)
            bins_root = torch.randint(0, 255, (FULL_ROWS, 32), generator=g,
                                      device="cuda", dtype=torch.int32
                                      ).to(torch.uint8)
        rows = phase_timing(hist_mod, bins_root, 256, errs, launches)
        log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
