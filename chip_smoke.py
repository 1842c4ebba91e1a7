#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``lightgbm_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each one fails the run if it fails):
1. print the card and its power limit; build every CUDA kernel of the
   port from ``lightgbm_tpu_torch/csrc`` (one ``nvcc`` per source, all
   started together) and print the build seconds; count each kernel's
   atomic instructions in its SASS and fail if the f32 instance holds a
   compare-and-swap;
2. hold every kernel instance (f32, int8 -> int32, int16 -> int32)
   against its plain PyTorch version on the card: random rows with and
   without row-index lists (of half the rows, 1, 31, 1000 and 100k
   rows), every row in one bin of every feature, Fp = 8, 40 and 64
   beside 32, and Fp = 56 and 136 at the root shapes of phases 9 and 10
   with children of 1, 1000 and 100k rows; two f32 calls on the same
   inputs must give the same bytes; the device-count entry (row count
   read from device memory) must give the host-count launch's bytes
   for every instance at n = 0, 1, 1023, 1024, 1025, 10k, 100k, 1M and
   all rows, at Fp = 32 and 136;
3. train the binary slice at a small size on ``cuda`` and on ``cpu`` and
   compare the first tree and the held-out AUC;
4. train the full-size slice (10.5M Higgs-shaped rows x 28 features,
   255 leaves, 5 rounds) through ``lightgbm_tpu_torch.train`` with the
   default whole-tree loop (the split step replayed as a CUDA graph),
   predict a 500k held-out set, and check that every histogram went
   through the kernel (its device counter == roots + split steps, and
   steps >= splits); print ms per split, host syncs per tree, capture
   ms, replays per tree and peak memory; a second run of 2 rounds with
   the per-split loop (``tpu_fused_tree=false``) must give the same two
   trees, text for text (the two loops agree, and f32 histograms and
   scans are deterministic);
5. time every kernel at the main path's root shape, and with row-index
   lists of 10k, 100k and 1M rows (L2 flushed), against its plain
   version, one library call and its memory bound, and its device-count
   entry at the same sizes; time a split scan with its prefix sums in
   the reference's order and with a cumsum;
6. draw the quantized-gradient rows (threefry ``uniform`` and
   ``quantize_gh``) at 10.5M rows on the card and on the CPU from the
   same inputs: they must be byte-equal;
7. train the full-size data of phase 4 with quantized gradients
   (``quant_grad_bits=8``, 5 rounds): every histogram must go through the
   int8 instance (launches == roots + steps, no f32 launch), the
   held-out AUC must pass 0.7, and a per-split rerun of 2 rounds must
   give the same two trees, text for text;
8. train 200k rows with ``quant_grad_bits=16`` and bagging on ``cuda``
   and on ``cpu``: tree 1 must make the same splits, through the int16
   instance on the card;
9. multiclass at UCI Covertype's shape (581,012 rows x 54 columns, 7
   classes, synthetic from a seed; 255 leaves, 5 rounds = 35 trees,
   ``enable_bundle=false``): held-out multi_logloss falls every round,
   multi_error ends below the majority class's 0.512, the device
   validation scores equal the host walk within 1e-4, f32 launches ==
   roots + steps over the 35 trees; a 2-round per-split rerun is
   text-equal; 2
   rounds at 8 bits go through the int8 instance only, and an 8-bit
   tree 1 at 50k rows is the same on cuda and cpu; softmax gradient ms
   and memory;
10. lambdarank at MSLR-WEB30K's shape (2,270,296 rows x 136 in 18,919
   queries of at most 1,251 docs, synthetic from a seed; 255 leaves,
   min_data_in_leaf 100, ndcg@1,3,5 on 2,000 held-out queries, 5
   rounds): ndcg@5 rises, launches == roots + steps, a 2-round
   per-split rerun is text-equal; the gradient stage's ms and memory;
   then a whole-tree and a per-split 2-round rank_xendcg run must give
   the same trees;
11. every other objective (l1, huber, fair, quantile, mape, poisson,
   gamma, tweedie, cross_entropy, cross_entropy_lambda, multiclassova)
   on phase 3's rows, 63 leaves, 3 rounds, cuda vs cpu: tree 1 the same
   tree, renewed leaf values (l1, quantile, mape) equal; renewal ms;

12. prediction through the stacked forest: train binary (255 leaves,
   min_data_in_leaf 100, lr 0.1, 100 rounds) on phase 3's 200k rows;
   predict the reference bench's batch (262,144 rows of
   ``make_higgs_like(seed=1)``) through ``Booster.predict`` in auto
   mode (it must dispatch the stacked path), ``predict_raw_device`` and
   ``pred_leaf``, against the host walk: leaf ids equal, values and raw
   scores byte-equal, the Kahan f32 sum within Kahan's bound of the f64
   sum of the same f32 leaf values (2 f32 ulp of the sum of their
   magnitudes); a 4096-row f64 batch (the dd path)
   byte-equal; rows/s of the host walk, the stacked ``value`` path and
   ``raw_device``, ms per 65,536-row bucket split into quantize, walk
   and sum, bytes each way, peak memory; then continue the model saved
   after 50 rounds for 50 more through ``init_model`` (held-out AUC must
   not fall) and round-trip it through pickle (same predictions).
   Phases 4, 9 and 10 hold the stacked path against the host walk on
   their own boosters and held-out rows too;

then time every instance at Fp = 56 and 136 (the real bins of phases 9
and 10), and print one ``{"kernels": [...]}`` line with the launches of
each kernel on each path that runs it, as its device counter counted
them (graph replays included; ``launches_by_path``; f32: phases 3, 4,
9, 10, 11, 12; int8: phases 7, 9; int16: phase 8). Prediction launches
no hand kernel: the stacked walk is PyTorch ops (the reference's is
``jnp``), so it has no row in that line.

Phases 3, 4 and 7-11 train through the default whole-tree loop; every
per-split (``tpu_fused_tree=false``) rerun must give its whole-tree
run's trees.

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
import math
import os
import subprocess
import sys
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
F32_OPS_PER_S = 67e12           # H100 SXM float32 rate outside tensor cores
INT8_OPS_PER_S = 1979e12        # H100 SXM int8 rate (the table's int8 row;
#                                 the published table has no other
#                                 integer row, so int16 rows use it too)

# tolerance of the f32 kernel against an f64 plain sum: the kernel adds
# f32 values in a fixed order of its own (lanes, rows, blocks), not the
# plain version's row order. The rounding error of
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
# the reference bench's predict batch (bench.py:153, BENCH_PREDICT_ROWS)
PREDICT_ROWS = 1 << 18
# UCI Covertype: 581,012 rows x 54 columns, 7 classes (phase 9)
COVERTYPE_ROWS = 581_012
COVERTYPE_HELD_OUT = 50_000
# Microsoft Learning to Rank, MSLR-WEB30K Fold1 train: 2,270,296 rows x
# 136 features in 18,919 queries of at most 1,251 docs (phase 10)
MSLR_ROWS = 2_270_296
MSLR_QUERIES = 18_919
MSLR_MAX_LEN = 1_251
MSLR_HELD_OUT_QUERIES = 2_000


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
            if "registers" in ln or "spill" in ln or "Compiling" in ln)))
    for src in sources:
        log_atomics(csrc, csrc.library_path(src))
    return card, name


def log_atomics(csrc, lib_path: str) -> None:
    """Count the atomic instructions of each kernel in a built library's
    SASS, and fail if a function of the f32 instance (mangled template
    arguments ``<float, float>`` / ``<float>``) holds a compare-and-swap
    atomic (``ATOMS.CAS*``, ``ATOMS.CAST.SPIN``: the loop an f32 add in
    shared memory compiles to on this card)."""
    cuobjdump = os.path.join(os.path.dirname(csrc._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        log("cuobjdump not found; atomic instructions not counted")
        return
    sass = subprocess.run([cuobjdump, "-sass", lib_path],
                          capture_output=True, text=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {}
            continue
        for tok in line.split():
            tok = tok.rstrip(";")
            if fn is not None and tok.startswith(("ATOM", "RED")):
                counts[fn][tok] = counts[fn].get(tok, 0) + 1
    check(bool(counts), "no kernel function in the SASS of %s" % lib_path)
    for fn, c in sorted(counts.items()):
        log("atomic instructions in %s: %s" % (fn, json.dumps(c,
                                                             sort_keys=True)))
        if "IffE" in fn or "IfE" in fn:
            check(not any(".CAS" in t for t in c),
                  "the f32 instance %s still holds a CAS atomic: %s"
                  % (fn, c))
    log("no compare-and-swap atomic in the f32 instance (%d functions)"
        % len(counts))


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


def cuda_ms_cold(fn, reps: int = 10, warm: int = 1) -> float:
    """Mean ms of ``fn`` with the L2 cache flushed before each call (by
    zeroing 128 MB), as a child's histogram finds it in training; the
    flush is outside the timed events."""
    import torch
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warm):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


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


def sub_index(S: int, n: int, seed: int):
    """A sorted int32 list of n distinct rows of S (a child's rows)."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return torch.randperm(S, generator=g, device="cuda")[:n].sort().values \
        .to(torch.int32)


def phase_kernels(hist_mod):
    """Every instance against its plain version on random and adversarial
    inputs: every row in one bin of every feature (one group of 32
    lanes, every row on one address), row-index lists of 1, 31, 1000 and
    100k rows, Fp = 8, 40 (two groups) and 64 beside the main path's 32,
    and Fp = 56 and 136 at the root shapes of phases 9 and 10 with
    children of 1, 1000 and 100k rows; and two f32 calls on the same
    inputs must give the same bytes."""
    import torch
    S, Fp, B = 1 << 20, 32, 256
    bins, gh, gh8, gh16, idx = make_hist_inputs(S, Fp, B, seed=1)
    hot = torch.full_like(bins, 7)
    cases = [("random", bins, gh, gh8, gh16, B, None),
             ("random, idx S/2", bins, gh, gh8, gh16, B, idx)]
    cases += [("random, idx %d" % n, bins, gh, gh8, gh16, B,
               sub_index(S, n, seed=n)) for n in (1, 31, 1000, 100_000)]
    cases += [("one bin", hot, gh, gh8, gh16, B, None),
              ("one bin, idx S/2", hot, gh, gh8, gh16, B, idx)]
    # Fp = 40: two feature groups of 32 and 8 (the last one narrower)
    for fp, b, seed in ((8, 64, 2), (40, 128, 4), (64, 256, 3)):
        wb, wgh, wgh8, wgh16, widx = make_hist_inputs(S, fp, b, seed=seed)
        cases += [("Fp=%d B=%d" % (fp, b), wb, wgh, wgh8, wgh16, b, None),
                  ("Fp=%d B=%d, idx S/2" % (fp, b), wb, wgh, wgh8, wgh16, b,
                   widx)]
    # the widths of phases 9 and 10 at their root shapes: Fp = 56 (two
    # groups) and Fp = 136 (five groups), and children of 1, 1000 and
    # 100k rows
    for rows, fp, seed in ((COVERTYPE_ROWS, 56, 5), (MSLR_ROWS, 136, 6)):
        wb, wgh, wgh8, wgh16, _ = make_hist_inputs(rows, fp, B, seed=seed)
        cases.append(("Fp=%d root" % fp, wb, wgh, wgh8, wgh16, B, None))
        cases += [("Fp=%d, idx %d" % (fp, n), wb, wgh, wgh8, wgh16, B,
                   sub_index(rows, n, seed=n + fp)) for n in
                  (1, 1000, 100_000)]
    errs = dict.fromkeys(hist_mod.launch_counts, 0.0)
    for label, cb, cgh, cgh8, cgh16, cB, cidx in cases:
        e = compare_f32(hist_mod, cb, cgh, cB, cidx)
        errs["histogram_f32"] = max(errs["histogram_f32"], e)
        compare_int(hist_mod, cb, cgh8, cB, cidx)
        compare_int(hist_mod, cb, cgh16, cB, cidx)
        log("kernel check [%s] S=%d Fp=%d B=%d C=4: f32 max_abs_err %.3g "
            "(tol %.0e x sum|x| per bin, counts exact), int8 and int16 "
            "byte-equal" % (label, cb.shape[0] if cidx is None
                            else cidx.shape[0], cb.shape[1], cB, e,
                            REL_TOL))
    for label, cb, cgh, _, _, cB, cidx in (cases[0], cases[1], cases[6]):
        first = hist_mod.build_histogram(cb, cgh, cB, cidx)
        second = hist_mod.build_histogram(cb, cgh, cB, cidx)
        check(torch.equal(first.view(torch.int32), second.view(torch.int32)),
              "two f32 calls on the same inputs differ [%s]" % label)
    log("f32 determinism: two calls on the same inputs byte-equal [random, "
        "random idx S/2, one bin]")
    return errs


def count_buffer(idx, S: int):
    """The whole-tree loop's row list: ``idx`` in front of an [S + 1]
    buffer filled with the trash slot S, and its length as a [1] int32
    tensor on the card."""
    import torch
    n = idx.shape[0]
    buf = torch.full((S + 1,), S, dtype=torch.int32, device="cuda")
    buf[:n] = idx
    return buf, torch.tensor([n], dtype=torch.int32, device="cuda")


DEVICE_COUNT_ROWS = (0, 1, 1023, 1024, 1025, 10_000, 100_000, 1_000_000)


def phase_device_count_entry(hist_mod):
    """The device-count entry of every instance against the host-count
    launch over the same sorted row list: byte-equal at every n of
    ``DEVICE_COUNT_ROWS`` and all rows, at Fp = 32 (one feature group,
    132 row blocks at most) and Fp = 136 (five groups, 26 row blocks);
    n = 0 must give zeros."""
    import torch
    S, B = 1 << 20, 256
    checked = 0
    for Fp, seed in ((32, 13), (136, 14)):
        bins, gh, gh8, gh16, _ = make_hist_inputs(S, Fp, B, seed=seed)
        for n in DEVICE_COUNT_ROWS + (S,):
            idx = sub_index(S, n, seed=n + Fp) if n < S else torch.arange(
                S, dtype=torch.int32, device="cuda")
            buf, count = count_buffer(idx, S)
            for rows in (gh, gh8, gh16):
                got = hist_mod.build_histogram(bins, rows, B, buf, count)
                want = hist_mod.build_histogram(bins, rows, B, idx)
                torch.cuda.synchronize()
                check(torch.equal(got.view(torch.int32),
                                  want.view(torch.int32)),
                      "device-count entry (%s, Fp=%d, n=%d) differs from "
                      "the host-count launch" % (rows.dtype, Fp, n))
                check(n > 0 or not got.any(),
                      "device-count entry with no rows is not zero")
                checked += 1
    log("device-count entry: byte-equal to the host-count launch in %d "
        "cases (f32, int8, int16; Fp 32 and 136; n = %s and all %d rows)"
        % (checked, ", ".join(str(n) for n in DEVICE_COUNT_ROWS), S))


# ---------------------------------------------------------------------------
# phase 5: timing at the main path's root shape and at child sizes
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


def time_histogram(hist_mod, bins, gh, B, name, idx=None):
    """Kernel, plain and ``index_add_`` ms and the bound of one call:
    all rows (warm repeats; 336 MB of bins exceed the L2 anyway), or a
    child's row-index list with the L2 flushed before each call."""
    import torch
    Fp, C = bins.shape[1], gh.shape[1]
    S = bins.shape[0] if idx is None else idx.shape[0]
    timer = cuda_ms if idx is None else cuda_ms_cold
    kernel_ms = timer(lambda: hist_mod.build_histogram(bins, gh, B, idx))
    plain_ms = timer(lambda: hist_mod.histogram_plain(bins, gh, B, idx),
                     reps=3, warm=1)
    acc = hist_mod.acc_dtype(gh.dtype)
    rb, rg = (bins, gh) if idx is None else (bins[idx.long()],
                                               gh[idx.long()])
    flat = (torch.arange(Fp, dtype=torch.int64, device="cuda")[None, :]
            * B + rb.long()).reshape(-1)
    vals = rg.to(acc)[:, None, :].expand(S, Fp, C).reshape(-1, C)
    out = torch.zeros(Fp * B, C, dtype=acc, device="cuda")
    library_ms = timer(lambda: out.index_add_(0, flat, vals), reps=3,
                       warm=1)
    del flat, vals, out, rb, rg
    bound, by = hist_bound_ms(S, Fp, B, C, gh.element_size(),
                              idx is not None)
    log("%s at S=%d%s Fp=%d B=%d C=%d: kernel %.4f ms, plain %.4f ms, "
        "index_add_ %.4f ms, bound %.4f ms (%s)"
        % (name, S, "" if idx is None else " (row-index list, L2 flushed)",
           Fp, B, C, kernel_ms, plain_ms, library_ms, bound, by))
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound, bound_by=by)


def phase_timing(hist_mod, bins, B, errs):
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
    children = [sub_index(S, n, seed=n) for n in (10_000, 100_000,
                                                   1_000_000)]
    everything = torch.arange(S, dtype=torch.int32, device="cuda")
    for name, rows_gh in (("histogram_f32", gh), ("histogram_i8", gh8),
                          ("histogram_i16", gh16)):
        t = time_histogram(hist_mod, bins, rows_gh, B, name)
        rows.append(dict(
            name=name, route="cuda",
            source="lightgbm_tpu_torch/csrc/histogram.cu",
            replaces=replaces[name], launches=0,
            max_abs_err=errs[name], **t))
        for idx in children:
            time_histogram(hist_mod, bins, rows_gh, B, name, idx)
        rows[-1]["device_count_ms"] = {
            str(idx.shape[0]): time_device_count(hist_mod, bins, rows_gh, B,
                                                 name, idx)
            for idx in [everything] + children}
    return rows


def time_device_count(hist_mod, bins, gh, B, name, idx):
    """ms of the device-count entry over ``idx`` (all rows: warm
    repeats; a child's list: L2 flushed before each call), beside the
    host-count launch over the same list."""
    buf, count = count_buffer(idx, bins.shape[0])
    timer = cuda_ms if idx.shape[0] == bins.shape[0] else cuda_ms_cold
    ms = timer(lambda: hist_mod.build_histogram(bins, gh, B, buf, count))
    host_ms = timer(lambda: hist_mod.build_histogram(bins, gh, B, idx))
    log("%s device-count entry at n=%d (row-index list%s): %.4f ms; "
        "host-count launch over the same list %.4f ms"
        % (name, idx.shape[0], "" if idx.shape[0] == bins.shape[0]
           else ", L2 flushed", ms, host_ms))
    return ms


def time_scan(B: int = 256, Fp: int = 32, calls: int = 200) -> None:
    """Host-clock ms per ``find_best_split`` call on the card (a leaf
    histogram of the main path's shape), with the prefix sums in the
    reference's order (``prefix_sum``, ~35 small ops) and with one
    ``torch.cumsum`` in their place, the order-free way to take them: the scan
    is launch-bound, so this is what the order costs per split step."""
    import torch
    from lightgbm_tpu_torch import config as port_config
    from lightgbm_tpu_torch.ops import split as S
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    hist = torch.stack([torch.randn(Fp, B, generator=g, device="cuda"),
                        torch.rand(Fp, B, generator=g, device="cuda"),
                        torch.randint(0, 50, (Fp, B), generator=g,
                                      device="cuda").float(),
                        torch.randint(0, 50, (Fp, B), generator=g,
                                      device="cuda").float()], dim=2)
    sums = hist[0].sum(dim=0)
    dev = torch.device("cuda")
    meta = S.FeatureMeta(
        num_bin=torch.full((Fp,), B, dtype=torch.int32, device=dev),
        missing_type=torch.zeros(Fp, dtype=torch.int32, device=dev),
        zero_bin=torch.zeros(Fp, dtype=torch.int32, device=dev))
    params = S.SplitParams.from_config(port_config.Config.from_params(
        {"min_data_in_leaf": 100, "verbosity": -1}), dev)
    mask = torch.ones(Fp, dtype=torch.bool, device=dev)
    parent = torch.zeros((), device=dev)

    def per_call_ms():
        for _ in range(5):
            S.find_best_split(hist, *sums, meta, params, mask, parent)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            S.find_best_split(hist, *sums, meta, params, mask, parent)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / calls

    ordered = per_call_ms()
    prefix_sum = S.prefix_sum
    S.prefix_sum = lambda x: torch.cumsum(x, dim=-1)
    try:
        plain = per_call_ms()
    finally:
        S.prefix_sum = prefix_sum
    log("split scan per call (host clock, %d calls, [%d, %d, 4]): %.3f ms "
        "with prefix_sum (the reference's order), %.3f ms with one "
        "torch.cumsum" % (calls, Fp, B, ordered, plain))


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
                    check_device_launches(hist_mod, bst, kernel, dev)
                    if dev == "cuda" else None)
    torch.set_num_threads(threads)
    check(res["cuda"][0] == res["cpu"][0],
          "tree 1 differs between cuda and cpu at %d rows (%s)"
          % (SMALL_ROWS, json.dumps(extra)))
    if auc_tol is not None:
        check(abs(res["cuda"][1] - res["cpu"][1]) <= auc_tol,
              "held-out AUC cuda %.6f vs cpu %.6f" % (res["cuda"][1],
                                                      res["cpu"][1]))
    launches = res["cuda"][3]
    check(sum(res["cpu"][2].values()) == 0, "the cpu run launched a kernel")
    log("small slice (%d rows, 63 leaves, 3 rounds, %s): tree 1 splits "
        "equal on cuda and cpu; held-out AUC cuda %.6f cpu %.6f; %d "
        "launches of %s on cuda"
        % (SMALL_ROWS, json.dumps(extra), res["cuda"][1], res["cpu"][1],
           launches[kernel], kernel))
    return launches


def check_device_launches(hist_mod, bst, kernel, what):
    """Every histogram of a training run went through ``kernel``: its
    device counter (graph replays included) == the learner's roots +
    split steps, one root per tree, a step for every split (the
    whole-tree loop may run a few past a tree's end, with no rows), and
    no other instance launched. Returns the device counts."""
    dev = hist_mod.device_launch_counts()
    stats = bst.inner.learner.grow_stats
    trees = bst.inner.models
    splits = sum(t.num_leaves - 1 for t in trees)
    check(dev[kernel] == stats["roots"] + stats["steps"]
          and stats["roots"] == len(trees) and stats["steps"] >= splits,
          "%s: %s device launches %d, roots %d + steps %d (trees %d, "
          "splits %d)" % (what, kernel, dev[kernel], stats["roots"],
                          stats["steps"], len(trees), splits))
    check(sum(dev.values()) == dev[kernel],
          "%s: another histogram instance was launched: %s" % (what, dev))
    log("%s: %d device launches of %s == %d roots + %d steps (%d graph "
        "replays, %d captures) for %d splits"
        % (what, dev[kernel], kernel, stats["roots"], stats["steps"],
           stats["replays"], stats["captures"], splits))
    return dev


class _EventTimer:
    """CUDA events around every call of a function. ``patch`` is a plain
    function, so it can stand in for a module function or, set on a
    class, for a method. ``size_of(*args)``, where given, records a size
    per call (rows of a histogram)."""

    def __init__(self, fn, size_of=None):
        self.fn = fn
        self.size_of = size_of
        self.events = []
        self.sizes = []
        self.patch = lambda *args, **kwargs: self(*args, **kwargs)

    def __call__(self, *args, **kwargs):
        import torch
        if torch.cuda.is_current_stream_capturing():
            # a graph capture runs the call once and its replays not at
            # all: only eager calls are timed
            return self.fn(*args, **kwargs)
        if self.size_of is not None:
            self.sizes.append(self.size_of(*args, **kwargs))
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


def hist_rows(bins, gh, num_bins, idx=None, count=None):
    """Rows summed by one ``build_histogram`` call; a count on the
    device is kept as a copy (no host read in the call) and read after
    the run."""
    if count is not None:
        return count.clone()
    return bins.shape[0] if idx is None else idx.shape[0]


ROW_BUCKETS = (1_000, 10_000, 100_000, 1_000_000)


def log_launch_sizes(timer: _EventTimer, kernel: str) -> None:
    """Launches and kernel ms summed by rows per launch."""
    edges = (0,) + ROW_BUCKETS + (float("inf"),)
    sizes = [int(n) for n in timer.sizes]
    parts = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        ms = [t for n, t in zip(sizes, timer.each_ms())
              if lo <= n < hi]
        parts.append("[%s, %s): %d launches, %.3f ms"
                     % (lo, "inf" if hi == float("inf") else int(hi),
                        len(ms), sum(ms)))
    log("%s by rows per launch: %s" % (kernel, "; ".join(parts)))


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
    (:func:`train_path`). Returns (booster, launches, held-out AUC per
    round, seconds per iteration, quantize ms per tree)."""
    ds, valid, _, _ = data
    run = train_path(lgb, hist_mod, ds, valid,
                     dict(SLICE_PARAMS, num_leaves=255, **extra), kernel,
                     rounds)
    return (run["booster"], run["launches"], run["evals"]["auc"],
            run["per_iter"], run["quant_ms"])


class _StageTimer(_EventTimer):
    """An :class:`_EventTimer` that also reads the device memory a call
    needs above what was allocated when it started (peak during the
    call, from ``torch.cuda.max_memory_allocated``). The peak counter is
    reset per call, so the caller's own peak is kept in ``outer_peak``."""

    def __init__(self, fn):
        super().__init__(fn)
        self.peaks = []
        self.outer_peak = 0

    def __call__(self, *args, **kwargs):
        import torch
        self.outer_peak = max(self.outer_peak,
                              torch.cuda.max_memory_allocated())
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = super().__call__(*args, **kwargs)
        torch.cuda.synchronize()
        self.peaks.append(torch.cuda.max_memory_allocated() - before)
        return out


def train_path(lgb, hist_mod, ds, valid, params, kernel, rounds,
               grad_cls=None, tag=None):
    """Train through ``lightgbm_tpu_torch.train`` with the launch counts
    set to 0 just before and read just after; every histogram must go
    through ``kernel`` (:func:`check_device_launches`: its device
    counter == roots + split steps summed over all trees, K per
    iteration for multiclass; no other instance launched). Each tree's
    host syncs are counted with ``torch.cuda.set_sync_debug_mode("warn")``
    around the learner's ``train``; in the whole-tree loop they must stay
    within ``ceil((L - 1) / FUSED_CHUNK) + 2``. CUDA events time every
    eager histogram, scan and quantize call (a graph replay runs none of
    them through Python), and, when ``grad_cls`` names the objective's
    class, every gradient call with the device memory it needs. Returns
    a dict of the run's numbers."""
    import torch
    from lightgbm_tpu_torch.treelearner import serial
    tag = tag or json.dumps({k: v for k, v in params.items()
                             if k not in SLICE_PARAMS})
    hist_timer = _EventTimer(serial.build_histogram, hist_rows)
    scan_timer = _EventTimer(serial.find_best_split)
    quant_timer = _EventTimer(serial.SerialTreeLearner._quantize_stage)
    grad_timer = (_StageTimer(grad_cls.get_gradients) if grad_cls
                  else None)
    grow = serial.SerialTreeLearner.train
    tree_seconds, tree_syncs = [], []

    def timed_grow(self, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = grow(self, *args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        tree_seconds.append(time.perf_counter() - t)
        tree_syncs.append(sum("synchroniz" in str(w.message)
                              for w in caught))
        return out
    iter_starts = []

    def mark(env):
        torch.cuda.synchronize()
        iter_starts.append(time.perf_counter())
    mark.before_iteration = True
    evals = {}
    serial.build_histogram = hist_timer.patch
    serial.find_best_split = scan_timer.patch
    serial.SerialTreeLearner._quantize_stage = quant_timer.patch
    serial.SerialTreeLearner.train = timed_grow
    if grad_timer:
        grad_cls.get_gradients = grad_timer.patch
    torch.cuda.reset_peak_memory_stats()
    hist_mod.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        bst = lgb.train(params, ds, num_boost_round=rounds,
                        valid_sets=[valid], valid_names=["held_out"],
                        callbacks=[mark, lgb.record_evaluation(evals)])
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
    finally:
        serial.build_histogram = hist_timer.fn
        serial.find_best_split = scan_timer.fn
        serial.SerialTreeLearner._quantize_stage = quant_timer.fn
        serial.SerialTreeLearner.train = grow
        if grad_timer:
            grad_cls.get_gradients = grad_timer.fn
    peak = max(torch.cuda.max_memory_allocated(),
               grad_timer.outer_peak if grad_timer else 0)
    iter_starts.append(time.perf_counter())
    per_iter = list(np.diff(iter_starts))
    trees = bst.inner.models
    K = bst.inner.num_tree_per_iteration
    splits = sum(t.num_leaves - 1 for t in trees)
    check(len(trees) == rounds * K, "expected %d trees, got %d"
          % (rounds * K, len(trees)))
    check(all(t.num_leaves > 1 for t in trees), "a tree has one leaf")
    launches = check_device_launches(hist_mod, bst, kernel, tag)
    learner = bst.inner.learner
    stats = learner.grow_stats
    fused = learner._fused_growth
    sync_bound = math.ceil((learner.L - 1) / serial.FUSED_CHUNK) + 2
    if fused:
        check(max(tree_syncs) <= sync_bound,
              "%s: %d host syncs in a tree, more than ceil((L-1)/%d) + 2 "
              "= %d" % (tag, max(tree_syncs), serial.FUSED_CHUNK,
                        sync_bound))
    hist_ms = hist_timer.total_ms()
    quant_ms = quant_timer.each_ms()
    log("train %s: %.3f s for %d rounds (%d trees); seconds per tree: %s; "
        "seconds per iteration (trees + gradients + held-out eval): %s; "
        "leaves per tree: %s"
        % (tag, t_train, rounds, len(trees),
           " ".join("%.3f" % v for v in tree_seconds),
           " ".join("%.3f" % v for v in per_iter),
           [t.num_leaves for t in trees]))
    log("%s loop: ms per split (tree seconds / splits): %s; host syncs per "
        "tree: %s (sync debug mode; bound for the whole-tree loop "
        "ceil((L-1)/%d) + 2 = %d); graph captures %d, capture ms %.1f; "
        "replays per tree %.1f; device launches of %s %d == roots %d + "
        "steps %d (replays %d), splits %d; counter reads %d, record "
        "reads %d"
        % ("whole-tree" if fused else "per-split",
           " ".join("%.3f" % (1e3 * s / max(t.num_leaves - 1, 1))
                    for s, t in zip(tree_seconds, trees)),
           " ".join(str(v) for v in tree_syncs), serial.FUSED_CHUNK,
           sync_bound, stats["captures"], stats["capture_ms"],
           stats["replays"] / len(trees), kernel, launches[kernel],
           stats["roots"], stats["steps"], stats["replays"], splits,
           stats["flag_reads"], stats["record_reads"]))
    log("eager histogram calls: %.1f ms = %.1f%% of tree time (%.3f s), "
        "%d calls%s"
        % (hist_ms, 100.0 * hist_ms / 1e3 / sum(tree_seconds),
           sum(tree_seconds), len(hist_timer.events),
           "; quantize stage ms per tree: " + " ".join(
               "%.3f" % v for v in quant_ms) if quant_ms else ""))
    log_launch_sizes(hist_timer, kernel)
    scan_ms = scan_timer.each_ms()
    log("split scan: %d eager calls, %.3f ms each on average (CUDA "
        "events)" % (len(scan_ms), float(np.mean(scan_ms))))
    grad_ms = grad_timer.each_ms() if grad_timer else []
    if grad_timer:
        log("gradient stage (%s.get_gradients, CUDA events) ms per "
            "iteration: %s; device memory it needs above its inputs: "
            "%.3f GiB at most"
            % (grad_cls.__name__, " ".join("%.3f" % v for v in grad_ms),
               max(grad_timer.peaks) / 2 ** 30))
    log("peak torch.cuda.max_memory_allocated: %.3f GiB"
        % (peak / 2 ** 30))
    return dict(booster=bst, launches=launches,
                evals=evals["held_out"], per_iter=per_iter,
                tree_seconds=tree_seconds, quant_ms=quant_ms,
                grad_ms=grad_ms, peak=peak, tree_syncs=tree_syncs,
                splits=splits)


def check_predict(bst, data, device_auc):
    """Host-walk predictions of the held-out set: finite, of the right
    shape, AUC > 0.7 and equal to the device valid-score AUC."""
    _, _, Xv, yv = data
    t0 = time.perf_counter()
    pred = bst.predict(Xv, predict_on_device=False)
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


def check_rerun(lgb, hist_mod, data, extra, kernel, bst, what):
    """A second run of 2 rounds through the per-split loop must give the
    first (whole-tree) run's first two trees, text for text."""
    again, _, _, _, _ = train_full(lgb, hist_mod, data,
                                   dict(extra, tpu_fused_tree=False),
                                   kernel, rounds=2)
    first = [t.to_string() for t in bst.inner.models[:2]]
    second = [t.to_string() for t in again.inner.models]
    check(first == second, "a per-split %s run gave other trees than the "
          "whole-tree run" % what)
    log("%s per-split rerun (2 rounds): trees 1 and 2 text-equal to the "
        "whole-tree run's" % what)


def phase_full(lgb, hist_mod, data):
    """The main path at full size (f32 gradients), and a 2-round rerun
    that must give the same trees (the f32 histograms and scans are
    deterministic); returns (booster, launches, held-out AUC)."""
    bst, launches, aucs, _, _ = train_full(lgb, hist_mod, data, {},
                                           "histogram_f32")
    a = check_predict(bst, data, aucs)
    check_stacked(bst, data[2], "phase 4 higgs")
    check_rerun(lgb, hist_mod, data, {}, "histogram_f32", bst, "f32")
    return bst, launches, a


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
    check_rerun(lgb, hist_mod, data, extra, "histogram_i8", bst,
                "quantized")
    return launches


# ---------------------------------------------------------------------------
# phase 9: multiclass at Covertype's shape
# ---------------------------------------------------------------------------
# Covertype's class shares (classes 1..7 as labels 0..6) and the order of
# the classes along the synthetic elevation-like latent, as the forest
# types lie along elevation: Cottonwood, Ponderosa, Douglas-fir, Aspen,
# Lodgepole, Spruce/Fir, Krummholz
COVERTYPE_SHARES = (0.365, 0.488, 0.062, 0.005, 0.016, 0.030, 0.035)
COVERTYPE_ORDER = (3, 2, 5, 4, 1, 0, 6)


def make_covertype_like(n: int, seed: int):
    """Covertype-shaped synthetic rows: 10 numeric columns (elevation,
    aspect, slope, distances and hillshades), 4 one-hot wilderness
    columns and 40 one-hot soil columns; 7 classes with Covertype's
    shares, cut from a noisy latent of the columns at the shares'
    quantiles."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 54), dtype=np.float32)
    elev = rng.normal(0.0, 1.0, n)
    X[:, 0] = 2960 + 280 * elev                          # elevation
    X[:, 1] = rng.uniform(0, 360, n)                     # aspect
    X[:, 2] = rng.gamma(3.0, 4.5, n)                     # slope
    X[:, 3] = rng.gamma(1.5, 180, n)                     # to hydrology
    X[:, 4] = rng.normal(46, 58, n)                      # vertical
    X[:, 5] = rng.gamma(1.8, 1300, n)                    # to roadways
    X[:, 6] = np.clip(rng.normal(212, 27, n), 0, 254)    # hillshade 9am
    X[:, 7] = np.clip(rng.normal(223, 20, n), 0, 254)    # noon
    X[:, 8] = np.clip(rng.normal(143, 38, n), 0, 254)    # 3pm
    X[:, 9] = rng.gamma(2.0, 1000, n)                    # to fire points
    wild = rng.choice(4, n, p=(0.45, 0.05, 0.44, 0.06))
    soil_p = rng.dirichlet(np.full(40, 0.5))
    soil = rng.choice(40, n, p=soil_p)
    X[np.arange(n), 10 + wild] = 1.0
    X[np.arange(n), 14 + soil] = 1.0
    soil_effect = np.random.RandomState(seed + 1000).normal(0, 0.5, 40)
    latent = (elev + np.array((0.3, -0.4, 0.1, -0.6))[wild]
              + soil_effect[soil] + 0.2 * np.cos(np.radians(X[:, 1]))
              - 0.01 * X[:, 2] + 0.0003 * (X[:, 5] - 2340)
              + 0.4 * rng.randn(n))
    cuts = np.quantile(latent, np.cumsum(
        [COVERTYPE_SHARES[c] for c in COVERTYPE_ORDER])[:-1])
    y = np.asarray(COVERTYPE_ORDER)[np.searchsorted(cuts, latent)]
    return X, y.astype(np.float64)


def phase_covertype(lgb, hist_mod):
    """Multiclass (softmax, 7 classes, K = 7 trees per iteration) at
    Covertype's shape: 581,012 training rows x 54 columns, 255 leaves,
    5 rounds; EFB would bundle the one-hot columns (ROADMAP item 11), so
    ``enable_bundle=false``. Then 2 rounds with 8-bit gradients, and an
    8-bit run on a 50k-row subset on cuda and cpu. Returns the launches
    by instance and the learner's bins for timing."""
    from lightgbm_tpu_torch.objective.multiclass import MulticlassSoftmax
    t0 = time.perf_counter()
    X, y = make_covertype_like(COVERTYPE_ROWS + COVERTYPE_HELD_OUT, seed=9)
    Xt, yt = X[:COVERTYPE_ROWS], y[:COVERTYPE_ROWS]
    Xv, yv = X[COVERTYPE_ROWS:], y[COVERTYPE_ROWS:]
    shares = np.bincount(yt.astype(int), minlength=7) / len(yt)
    params = {"objective": "multiclass", "num_class": 7, "num_leaves": 255,
              "learning_rate": 0.1, "max_bin": 255, "enable_bundle": False,
              "metric": "multi_logloss,multi_error", "verbosity": -1}
    ds = lgb.Dataset(Xt, label=yt, params=params).construct()
    valid = lgb.Dataset(Xv, label=yv, reference=ds).construct()
    log("covertype-like: %d + %d rows x %d, class shares %s; generated "
        "and binned in %.1f s" % (len(yt), len(yv), X.shape[1],
                                  " ".join("%.3f" % v for v in shares),
                                  time.perf_counter() - t0))
    run = train_path(lgb, hist_mod, ds, valid, params, "histogram_f32", 5,
                     grad_cls=MulticlassSoftmax, tag="covertype multiclass")
    bst, evals = run["booster"], run["evals"]
    loss, err = evals["multi_logloss"], evals["multi_error"]
    check(all(b < a for a, b in zip(loss, loss[1:])),
          "held-out multi_logloss did not fall every round: %s" % loss)
    majority_error = 1.0 - max(COVERTYPE_SHARES)
    check(err[-1] < majority_error,
          "held-out multi_error %.4f is not below the majority-class "
          "error %.3f" % (err[-1], majority_error))
    host = bst.predict(Xv, raw_score=True, predict_on_device=False)
    dev = bst.inner.valid_data[0].scores
    check(host.shape == dev.shape == (len(yv), 7)
          and bool(np.isfinite(host).all()),
          "multiclass raw scores are not finite or of the wrong shape")
    gap = float(np.abs(host - dev).max())
    check(gap <= 1e-4, "host-walk scores differ from the device "
          "validation scores by %.3g" % gap)
    prob = bst.predict(Xv, predict_on_device=False)
    check(bool(np.allclose(prob.sum(axis=1), 1.0)),
          "class probabilities do not sum to 1")
    check_stacked(bst, Xv, "phase 9 covertype")
    log("covertype multiclass: held-out multi_logloss %s; multi_error %s "
        "(majority-class error %.3f); host walk vs device scores max "
        "|diff| %.3g; mean seconds per iteration %.3f; softmax gradient "
        "ms per iteration %s"
        % (" ".join("%.6f" % v for v in loss),
           " ".join("%.6f" % v for v in err), majority_error, gap,
           float(np.mean(run["per_iter"])),
           " ".join("%.3f" % v for v in run["grad_ms"])))
    again = train_path(lgb, hist_mod, ds, valid,
                       dict(params, tpu_fused_tree=False), "histogram_f32",
                       2, tag="covertype multiclass per-split rerun")[
        "booster"]
    check([t.to_string() for t in bst.inner.models[:14]]
          == [t.to_string() for t in again.inner.models],
          "a per-split covertype run gave other trees than the whole-tree "
          "run")
    log("covertype per-split rerun (2 rounds): all 14 trees text-equal to "
        "the whole-tree run's")
    launches = {"histogram_f32": run["launches"]["histogram_f32"]}
    bins = bst.inner.learner.bins
    del bst, again
    q8 = dict(params, use_quantized_grad=True, quant_grad_bits=8)
    qrun = train_path(lgb, hist_mod, ds, valid, q8, "histogram_i8", 2,
                      tag="covertype multiclass 8-bit")
    launches["histogram_i8"] = qrun["launches"]["histogram_i8"]
    log("covertype 8-bit: held-out multi_logloss %s (f32 %s)"
        % (" ".join("%.6f" % v for v in qrun["evals"]["multi_logloss"]),
           " ".join("%.6f" % v for v in loss[:2])))
    del qrun
    sub = 50_000
    first = {}
    for dev_type in ("cuda", "cpu"):
        sds = lgb.Dataset(Xt[:sub], label=yt[:sub])
        b = lgb.train(dict(q8, device_type=dev_type), sds,
                      num_boost_round=1)
        first[dev_type] = tree_splits(b)[0]
    check(first["cuda"] == first["cpu"],
          "8-bit covertype tree 1 (class 0) differs between cuda and cpu "
          "at %d rows" % sub)
    log("covertype 8-bit at %d rows: tree 1 (class 0) splits equal on "
        "cuda and cpu (%d splits)" % (sub, len(first["cuda"][0])))
    return launches, bins


# ---------------------------------------------------------------------------
# phase 10: lambdarank at MSLR-WEB30K's shape
# ---------------------------------------------------------------------------
# MSLR-WEB30K's label shares (0..4)
MSLR_SHARES = (0.51, 0.32, 0.13, 0.03, 0.01)
MSLR_RELEVANCE_SEED = 20


def make_mslr_like(num_queries: int, seed: int, total_rows=None):
    """MSLR-WEB30K-shaped synthetic rows: query lengths log-normal with a
    mean near 120, one query of the maximum length 1,251 (and, when
    ``total_rows`` is given, lengths adjusted to sum to it); 136 dense
    features, a third of them constant within a query (query-level
    features); labels 0-4 with MSLR's shares, cut at the shares'
    quantiles of a noisy function of the features."""
    rng = np.random.RandomState(seed)
    lengths = np.clip(np.round(rng.lognormal(np.log(90.0), 0.75,
                                             num_queries)), 1,
                      MSLR_MAX_LEN).astype(np.int64)
    lengths[rng.randint(num_queries)] = MSLR_MAX_LEN
    if total_rows is not None:
        diff = total_rows - int(lengths.sum())
        while diff != 0:
            q = rng.randint(num_queries)
            step = int(np.clip(diff, 1 - lengths[q],
                               MSLR_MAX_LEN - lengths[q]))
            if lengths[q] == MSLR_MAX_LEN and step > 0:
                continue
            lengths[q] += step
            diff -= step
    n = int(lengths.sum())
    qid = np.repeat(np.arange(num_queries), lengths)
    X = np.empty((n, 136), dtype=np.float32)
    chunk = 1 << 19
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        X[lo:hi] = rng.randn(hi - lo, 136)
    qfeat = rng.randn(num_queries, 45).astype(np.float32)
    X[:, 91:] = qfeat[qid]
    X[:, 1:91:3] = np.abs(X[:, 1:91:3]) ** 1.5          # heavy tails
    # one relevance function for the training and the held-out queries
    wrng = np.random.RandomState(MSLR_RELEVANCE_SEED)
    w = np.zeros(136, dtype=np.float32)
    w[wrng.choice(91, 24, replace=False)] = wrng.randn(24) * 0.6
    w[91:96] = wrng.randn(5) * 0.3
    latent = X @ w + rng.randn(n).astype(np.float32) * 0.8
    cuts = np.quantile(latent, np.cumsum(MSLR_SHARES)[:-1])
    y = np.searchsorted(cuts, latent).astype(np.float64)
    return X, y, lengths


def phase_mslr(lgb, hist_mod):
    """lambdarank at MSLR-WEB30K's shape: 2,270,296 rows x 136 features
    in 18,919 queries (at most 1,251 docs), 255 leaves,
    min_data_in_leaf 100, ndcg@1,3,5 on 2,000 held-out queries, 5
    rounds; a 2-round rerun must give the same trees; then 2 rounds of
    rank_xendcg, twice, with equal trees. Returns the f32 launches and
    the learner's bins for timing."""
    from lightgbm_tpu_torch.objective.rank import LambdarankNDCG
    t0 = time.perf_counter()
    X, y, group = make_mslr_like(MSLR_QUERIES, seed=21, total_rows=MSLR_ROWS)
    Xv, yv, gv = make_mslr_like(MSLR_HELD_OUT_QUERIES, seed=22)
    t_gen = time.perf_counter() - t0
    params = {"objective": "lambdarank", "num_leaves": 255,
              "min_data_in_leaf": 100, "learning_rate": 0.1,
              "max_bin": 255, "eval_at": "1,3,5", "metric": "ndcg",
              "verbosity": -1}
    ds = lgb.Dataset(X, label=y, group=group, params=params).construct()
    valid = lgb.Dataset(Xv, label=yv, group=gv, reference=ds).construct()
    del X
    shares = np.bincount(y.astype(int), minlength=5) / len(y)
    log("mslr-like: %d rows x 136 in %d queries (mean %.1f, max %d docs), "
        "held out %d rows in %d queries; label shares %s; generated in "
        "%.1f s, binned in %.1f s"
        % (len(y), len(group), group.mean(), group.max(), len(yv), len(gv),
           " ".join("%.3f" % v for v in shares), t_gen,
           time.perf_counter() - t0 - t_gen))
    run = train_path(lgb, hist_mod, ds, valid, params, "histogram_f32", 5,
                     grad_cls=LambdarankNDCG, tag="mslr lambdarank")
    bst, evals = run["booster"], run["evals"]
    ndcg5 = evals["ndcg@5"]
    check(ndcg5[-1] > ndcg5[0], "held-out ndcg@5 did not rise: %s" % ndcg5)
    check_stacked(bst, Xv, "phase 10 mslr")
    log("mslr lambdarank: held-out ndcg@1 %s; ndcg@3 %s; ndcg@5 %s; mean "
        "seconds per iteration %.3f; lambdarank gradient stage ms per "
        "iteration %s"
        % tuple([" ".join("%.6f" % v for v in evals[k])
                 for k in ("ndcg@1", "ndcg@3", "ndcg@5")]
                + [float(np.mean(run["per_iter"])),
                   " ".join("%.3f" % v for v in run["grad_ms"])]))
    again = train_path(lgb, hist_mod, ds, valid,
                       dict(params, tpu_fused_tree=False), "histogram_f32",
                       2, tag="mslr lambdarank per-split rerun")["booster"]
    check([t.to_string() for t in bst.inner.models[:2]]
          == [t.to_string() for t in again.inner.models],
          "a per-split lambdarank run gave other trees than the whole-tree "
          "run")
    log("mslr lambdarank per-split rerun (2 rounds): trees 1 and 2 "
        "text-equal to the whole-tree run's")
    launches = run["launches"]["histogram_f32"]
    bins = bst.inner.learner.bins
    del bst, again
    xe = dict(params, objective="rank_xendcg")
    from lightgbm_tpu_torch.objective.rank import RankXENDCG
    texts = []
    for fused in (True, False):
        r = train_path(lgb, hist_mod, ds, valid,
                       dict(xe, tpu_fused_tree=fused), "histogram_f32", 2,
                       grad_cls=RankXENDCG,
                       tag="mslr rank_xendcg %s" % ("whole-tree" if fused
                                                    else "per-split"))
        texts.append([t.to_string() for t in r["booster"].inner.models])
        launches += r["launches"]["histogram_f32"]
    check(texts[0] == texts[1], "the per-split rank_xendcg run gave other "
          "trees than the whole-tree run")
    log("mslr rank_xendcg: whole-tree and per-split 2-round runs "
        "text-equal; held-out ndcg@5 %s"
        % " ".join("%.6f" % v for v in r["evals"]["ndcg@5"]))
    return launches, bins


# ---------------------------------------------------------------------------
# phase 11: every other objective, small
# ---------------------------------------------------------------------------
def other_objective_labels(X: np.ndarray, seed: int):
    """Labels for each remaining objective from the Higgs-shaped rows:
    a noisy continuous target, positive ones for poisson, gamma and
    tweedie, [0, 1] ones for the cross-entropies, 3 classes for
    multiclassova."""
    rng = np.random.RandomState(seed)
    n = X.shape[0]
    cont = (0.8 * X[:, 0] + X[:, 1] - 0.5 * X[:, 2] * X[:, 3]
            + 0.3 * rng.randn(n))
    counts = rng.poisson(np.exp(0.3 * cont)).astype(np.float64)
    return {
        "regression_l1": cont, "huber": cont, "fair": cont,
        "quantile": cont, "mape": 10.0 + 3.0 * cont,
        "poisson": counts,
        "gamma": np.exp(0.3 * cont) * rng.gamma(2.0, 0.5, n),
        "tweedie": counts * rng.gamma(2.0, 0.5, n),
        "cross_entropy": 1.0 / (1.0 + np.exp(-cont)),
        "cross_entropy_lambda": 1.0 / (1.0 + np.exp(-cont)),
        "multiclassova": np.digitize(cont, np.quantile(cont, (0.3, 0.7))
                                     ).astype(np.float64),
    }


def phase_other_objectives(lgb, hist_mod):
    """Each remaining objective at phase 3's 200k Higgs-shaped rows
    (binned once), 63 leaves, 3 rounds, on cuda and on cpu: tree 1 must
    have the same structure (:func:`tree_structure`), the cuda run must
    go through the f32 instance only, and for l1, quantile and mape the
    renewed leaf values of tree 1 must be equal. Host-clock ms of each
    renewal (its score-column and partition copies to the host
    included). Returns the f32 launches."""
    import torch
    from lightgbm_tpu_torch.boosting import gbdt
    X, _ = make_higgs_like(SMALL_ROWS, seed=7)
    labels = other_objective_labels(X, seed=8)
    base = {"num_leaves": 63, "min_data_in_leaf": 100,
            "learning_rate": 0.1, "verbosity": -1}
    ds = lgb.Dataset(X, label=labels["regression_l1"],
                     params=base).construct()
    renew = gbdt.GBDT._renew_tree_output
    renew_ms = []

    def timed_renew(self, *args):
        t = time.perf_counter()
        renew(self, *args)
        renew_ms.append(1e3 * (time.perf_counter() - t))
    threads = torch.get_num_threads()
    total = 0
    for name, y in labels.items():
        ds.handle.metadata.set_label(y)
        params = dict(base, objective=name)
        if name == "multiclassova":
            params["num_class"] = 3
        res = {}
        for dev in ("cuda", "cpu"):
            torch.set_num_threads(1 if dev == "cpu" else threads)
            renew_ms.clear()
            gbdt.GBDT._renew_tree_output = timed_renew
            hist_mod.reset_launch_counts()
            try:
                t0 = time.perf_counter()
                b = lgb.train(dict(params, device_type=dev), ds,
                              num_boost_round=3)
                secs = time.perf_counter() - t0
            finally:
                gbdt.GBDT._renew_tree_output = renew
            res[dev] = (b.inner.models,
                        check_device_launches(hist_mod, b, "histogram_f32",
                                              name)
                        if dev == "cuda" else dict(hist_mod.launch_counts),
                        secs, list(renew_ms))
        torch.set_num_threads(threads)
        cuda_trees, launches, secs, rms = res["cuda"]
        a, c = cuda_trees[0], res["cpu"][0][0]
        check(tree_structure(a) == tree_structure(c),
              "%s: tree 1 differs between cuda and cpu" % name)
        same_order = tree_splits_of(a) == tree_splits_of(c)
        check(sum(res["cpu"][1].values()) == 0,
              "%s: the cpu run launched a kernel" % name)
        renewed = b.inner.objective.is_renew_tree_output
        if renewed:
            check(np.array_equal(a.leaf_value[:a.num_leaves],
                                 c.leaf_value[:c.num_leaves]),
                  "%s: renewed leaf values of tree 1 differ between cuda "
                  "and cpu" % name)
        total += launches["histogram_f32"]
        log("objective %s (63 leaves, 3 rounds, %d trees): tree 1 the same "
            "tree on cuda and cpu (%s)%s; cuda %.3f s, cpu %.3f s; %d "
            "launches of histogram_f32%s"
            % (name, len(cuda_trees),
               "splits in the same order" if same_order else
               "the same splits, added in another order",
               ", renewed leaf values equal" if renewed else "", secs,
               res["cpu"][2], launches["histogram_f32"],
               "; renewal ms per tree on cuda (host, copies included): "
               + " ".join("%.2f" % v for v in rms) if rms else ""))
    return total


# ---------------------------------------------------------------------------
# phase 12: prediction through the stacked forest
# ---------------------------------------------------------------------------
def timed(fn):
    """(result, host seconds) of ``fn()``, the card synchronised before
    and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def stacked_predictor(bst):
    """The booster's cached ``BucketedPredictor`` (None before its first
    stacked dispatch)."""
    cached = getattr(bst, "_stacked_cache", None)
    return None if cached is None else cached[1]


def check_stacked(bst, X, what):
    """``Booster.predict`` in auto mode (the stacked forest on the card)
    against the host walk (``predict_on_device=False``) on ``X``: the
    stacked path must dispatch, leaf ids must be equal and raw scores and
    values byte-equal. Returns the host-walk and stacked rows/s of the
    raw scores."""
    n = X.shape[0]
    bst._stacked_cache = None
    raw, t_dev = timed(lambda: bst.predict(X, raw_score=True))
    pred = stacked_predictor(bst)
    check(pred is not None and sum(pred.entries.values()) > 0,
          "%s: auto mode did not dispatch the stacked path" % what)
    host, t_host = timed(lambda: bst.predict(X, raw_score=True,
                                             predict_on_device=False))
    check(raw.shape == host.shape and np.array_equal(raw, host),
          "%s: stacked raw scores differ from the host walk (max |diff| "
          "%.3g)" % (what, float(np.nanmax(np.abs(raw - host)))))
    check(np.array_equal(bst.predict(X),
                         bst.predict(X, predict_on_device=False)),
          "%s: stacked values differ from the host walk" % what)
    leaves = bst.predict(X, pred_leaf=True)
    check(np.array_equal(leaves, bst.predict(X, pred_leaf=True,
                                             predict_on_device=False)),
          "%s: stacked leaf ids differ from the host walk" % what)
    log("%s: stacked path == host walk on %d rows x %d trees (leaf ids "
        "equal, raw and values byte-equal); raw scores %.0f rows/s "
        "stacked (the first call packs the forest), %.0f rows/s host "
        "walk; bucket dispatches %s"
        % (what, n, leaves.shape[1], n / t_dev, n / t_host,
           json.dumps({"%s %s" % (k[1], "/".join(k[2:])): v
                       for k, v in sorted(pred.entries.items(),
                                          key=str)})))
    return n / t_host, n / t_dev


def time_dispatch(forest, Xb):
    """CUDA-event ms of one bucket's stages on the card: the rows' copy
    to the card, quantize, the walk of all trees, the f64 tree-order sum
    and the Kahan f32 sum, and the read-back of [n, K] f64."""
    import torch
    from lightgbm_tpu_torch.ops import predict as P
    K = forest.num_classes
    Xd = torch.from_numpy(Xb).cuda()
    bins_t = P._quantize_rows_impl(Xd, forest._qt)
    leaves = P._walk_stacked(bins_t, forest._nodes, forest.trips)
    raw = P._sum_leaf_values_f64(leaves, forest._leaf_f64, K)
    return {
        "copy_in": cuda_ms(lambda: torch.from_numpy(Xb).cuda(), reps=5),
        "quantize": cuda_ms(lambda: P._quantize_rows_impl(Xd, forest._qt),
                            reps=5),
        "walk": cuda_ms(lambda: P._walk_stacked(bins_t, forest._nodes,
                                                forest.trips), reps=5),
        "sum_f64": cuda_ms(lambda: P._sum_leaf_values_f64(
            leaves, forest._leaf_f64, K), reps=5),
        "sum_kahan_f32": cuda_ms(lambda: P._raw_from_leaves(
            leaves, forest._nodes, K), reps=5),
        "copy_out": cuda_ms(lambda: raw.cpu(), reps=5),
    }


def phase_predict(lgb, hist_mod):
    """Train binary (255 leaves, min_data_in_leaf 100, lr 0.1) for 100
    rounds on phase 3's 200k Higgs-shaped rows, predict the reference
    bench's 262,144-row batch three ways against the host walk, time
    the stacked path, then continue the 50-round model for 50 rounds
    through ``init_model`` and round-trip it through pickle. Returns the
    f32 histogram launches of the two training runs."""
    import pickle
    import torch
    X, y = make_higgs_like(SMALL_ROWS + 50_000, seed=7)
    params = dict(SLICE_PARAMS, num_leaves=255)
    ds = lgb.Dataset(X[:SMALL_ROWS], label=y[:SMALL_ROWS],
                     params=params).construct()
    valid = lgb.Dataset(X[SMALL_ROWS:], label=y[SMALL_ROWS:],
                        reference=ds).construct()
    run = train_path(lgb, hist_mod, ds, valid, params, "histogram_f32",
                     100, tag="phase 12 binary, 255 leaves, 100 rounds")
    bst = run["booster"]
    launches = {"phase12_binary_100_rounds": run["launches"]["histogram_f32"]}
    Xp, _ = make_higgs_like(PREDICT_ROWS, seed=1)
    n = PREDICT_ROWS

    # the host walk: raw scores, values, leaf ids
    host_raw, t_host = timed(lambda: bst.predict(
        Xp, raw_score=True, predict_on_device=False))
    # the host walk's values: its raw scores through the objective's
    # convert_output, as GBDT.predict computes them
    host_val = bst.inner.objective.convert_output(host_raw)
    host_leaf = bst.predict(Xp, pred_leaf=True, predict_on_device=False)
    # Booster.predict in auto mode: must take the stacked path
    bst._stacked_cache = None
    bst.predict(Xp[:4096])                 # packs and places the forest
    pred = stacked_predictor(bst)
    check(pred is not None, "auto mode did not dispatch the stacked path")
    forest = pred.forest
    forest.transfer_bytes.update(to_device=0, from_device=0)
    pred.entries.clear()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    val, t_val = timed(lambda: bst.predict(Xp))
    peak = torch.cuda.max_memory_allocated() - base_mem
    moved = dict(forest.transfer_bytes)
    check(pred.entries == {(pred.model_version, 1 << 16, "value"): 4},
          "auto mode dispatched %s, not 4 buckets of 65536 rows"
          % pred.entries)
    check(np.array_equal(val, host_val),
          "stacked values differ from the host walk")
    raw = bst.predict(Xp, raw_score=True)
    check(np.array_equal(raw, host_raw),
          "stacked raw scores differ from the host walk")
    leaf = bst.predict(Xp, pred_leaf=True)
    check(np.array_equal(leaf, host_leaf),
          "stacked leaf ids differ from the host walk")
    # the throughput path: the Kahan f32 sum of the whole batch in one
    # pass, as the reference bench times it
    Xd32 = np.ascontiguousarray(Xp, dtype=np.float32)
    forest.predict_raw_device(Xd32)          # warm
    fast, t_fast = timed(lambda: forest.predict_raw_device(Xd32))
    # Kahan's bound (Higham, Accuracy and Stability, 4.3): the error of
    # the compensated f32 sum of x_1..x_T is at most (2u + O(T u^2)) *
    # sum |x_i|, u = 2^-24, so at most 2 f32 ulp of sum |x_i|; with
    # leaf values of one sign (the reference's 512 positive stumps)
    # that is 2 ulp of the sum itself. x_i are the f32 leaf values the
    # card adds; their exact sum is taken in f64
    leaves_dev = forest.leaves_device(Xd32)
    f32_vals = forest._nodes.leaf_value.gather(1, leaves_dev.long()).double()
    exact = f32_vals.sum(dim=0).cpu().numpy()
    mass = f32_vals.abs().sum(dim=0).cpu().numpy()
    fast = fast[:, 0].cpu().numpy().astype(np.float64)
    err = np.abs(fast - exact)
    gap = err / np.spacing(mass.astype(np.float32)).astype(np.float64)
    check(float(gap.max()) <= 2.0,
          "raw_device is %.3f f32 ulp of sum |leaf values| from the f64 "
          "sum of its leaf values" % float(gap.max()))
    ulp_sum = np.spacing(np.abs(exact).astype(np.float32)).astype(
        np.float64)
    gap_sum = err / ulp_sum
    host_gap = np.abs(fast - host_raw) / ulp_sum
    # f64 rows: the double-double path, byte-equal to the host walk
    X64 = Xp[:4096].astype(np.float64) + 1e-12
    dd = bst.predict(X64)
    check(any(k[-1] == "dd" for k in pred.entries),
          "the f64 batch did not take the dd path")
    check(np.array_equal(dd, bst.predict(X64, predict_on_device=False)),
          "dd values differ from the host walk")
    stages = time_dispatch(forest, Xd32[:1 << 16])
    log("phase 12 predict, %d rows x %d trees (255 leaves, trips %d): "
        "host walk %.0f rows/s (%.3f s raw); stacked value path (auto "
        "mode, 4 buckets of 65536) %.0f rows/s (%.3f s); raw_device (one "
        "pass, Kahan f32) %.0f rows/s (%.3f s); leaf ids equal, value and "
        "raw byte-equal to the host walk; raw_device from the f64 sum of "
        "its f32 leaf values: at most %.3f f32 ulp of sum |leaf values| "
        "(bound 2), in f32 ulp of the sum itself at most %.1f, median "
        "%.3f, %.2f%% of rows within 2; from the host's f64 sum of f64 "
        "leaf values: at most %.1f, median %.3f ulp of the sum; 4096 f64 "
        "rows (dd) byte-equal"
        % (n, forest.num_trees, forest.trips, n / t_host, t_host,
           n / t_val, t_val, n / t_fast, t_fast, float(gap.max()),
           float(gap_sum.max()), float(np.median(gap_sum)),
           100.0 * float(np.mean(gap_sum <= 2.0)), float(host_gap.max()),
           float(np.median(host_gap))))
    log("phase 12 ms per 65536-row bucket on the card (CUDA events): %s; "
        "sum of the value path's stages %.3f ms; bytes to the card %d, "
        "from the card %d for the %d-row value call; peak memory above "
        "the model %.3f GiB"
        % (json.dumps({k: round(v, 4) for k, v in stages.items()}),
           sum(v for k, v in stages.items() if k != "sum_kahan_f32"),
           moved["to_device"], moved["from_device"], n, peak / 2 ** 30))

    # continued training on the card from the model after 50 rounds
    yv = y[SMALL_ROWS:]
    auc50 = auc(yv, bst.predict(X[SMALL_ROWS:], num_iteration=50))
    auc100 = auc(yv, bst.predict(X[SMALL_ROWS:]))
    first50 = lgb.Booster(model_str=bst.model_to_string(num_iteration=50))
    hist_mod.reset_launch_counts()
    cont = lgb.train(params, ds, num_boost_round=50, valid_sets=[valid],
                     valid_names=["held_out"], init_model=first50)
    stats = cont.inner.learner.grow_stats
    dev = hist_mod.device_launch_counts()["histogram_f32"]
    check(cont.num_trees() == 100 and stats["roots"] == 50
          and dev == stats["roots"] + stats["steps"],
          "continued run: %d trees, roots %d, steps %d, launches %d"
          % (cont.num_trees(), stats["roots"], stats["steps"], dev))
    launches["phase12_continued_50_rounds"] = dev
    auc_cont = auc(yv, cont.predict(X[SMALL_ROWS:]))
    check(auc_cont >= auc50, "held-out AUC fell in continued training: "
          "%.6f after 50 rounds, %.6f after 50 more" % (auc50, auc_cont))
    back = pickle.loads(pickle.dumps(cont))
    check(np.array_equal(back.predict(Xp), cont.predict(Xp)),
          "a pickle round trip predicts other values")
    log("phase 12 continued training: held-out AUC %.6f after 50 rounds, "
        "%.6f after 50 more through init_model (%.6f for 100 rounds in "
        "one run); %d launches of histogram_f32 == %d roots + %d steps; "
        "pickle round trip predicts the same %d values"
        % (auc50, auc_cont, auc100, dev, stats["roots"], stats["steps"], n))
    return launches


def tree_splits_of(tree):
    ni = tree.num_internal
    return (tree.num_leaves, list(tree.split_feature[:ni]),
            list(tree.threshold[:ni]))


def tree_structure(tree, node: int = 0):
    """A tree as nested (feature, threshold, default left, left, right)
    with leaves as their row counts: the same splits compare equal
    whatever order the leaf-wise grower added them in (two leaves whose
    best gains tie within f32 rounding may be split in either order)."""
    if tree.num_leaves == 1:
        return int(tree.leaf_count[0])
    if node < 0:
        return int(tree.leaf_count[~node])
    return (int(tree.split_feature[node]), float(tree.threshold[node]),
            int(tree.decision_type[node]),
            tree_structure(tree, int(tree.left_child[node])),
            tree_structure(tree, int(tree.right_child[node])))


def time_widths(hist_mod, widths, rows_out):
    """Every instance at the new widths' root shapes (the real bins of
    phases 9 and 10) and at children of 10k, 100k and 1M rows (fewer
    than the root), each beside its bound, plain and library times;
    appended to each instance's row of the kernels line."""
    import torch
    for label, bins in widths:
        S = bins.shape[0]
        g = torch.Generator(device="cuda")
        g.manual_seed(12)
        gh = torch.stack([torch.randn(S, generator=g, device="cuda"),
                          torch.rand(S, generator=g, device="cuda"),
                          torch.ones(S, device="cuda"),
                          torch.ones(S, device="cuda")], dim=1).contiguous()
        gh8 = torch.randint(-127, 128, (S, 4), generator=g, device="cuda",
                            dtype=torch.int32).to(torch.int8)
        q16 = (2 ** 31 - 1) // S
        gh16 = torch.randint(-q16, q16 + 1, (S, 4), generator=g,
                             device="cuda", dtype=torch.int32).to(
            torch.int16)
        children = [sub_index(S, n, seed=n) for n in (10_000, 100_000,
                                                       1_000_000) if n < S]
        for row, rows_gh in zip(rows_out, (gh, gh8, gh16)):
            times = [dict(width=label, S=S, Fp=bins.shape[1],
                          **time_histogram(hist_mod, bins, rows_gh, 256,
                                           row["name"]))]
            for idx in children:
                times.append(dict(width=label, S=idx.shape[0],
                                  Fp=bins.shape[1], child=True,
                                  **time_histogram(hist_mod, bins, rows_gh,
                                                   256, row["name"], idx)))
            row.setdefault("widths", []).extend(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12",
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
    t_lap = [t_start]

    def lap(label: str) -> None:
        now = time.perf_counter()
        log("%s seconds: %.1f" % (label, now - t_lap[0]))
        t_lap[0] = now
    card, name = phase_device_and_build(csrc)
    lap("phase 1")
    errs = dict.fromkeys(hist_mod.launch_counts, 0.0)
    if 2 in phases:
        errs = phase_kernels(hist_mod)
        phase_device_count_entry(hist_mod)
        lap("phase 2")
    import lightgbm_tpu_torch as lgb
    # launches of each kernel on each path that runs it
    by_path = {k: {} for k in hist_mod.launch_counts}
    if 3 in phases:
        run = phase_small(lgb, hist_mod, {}, "histogram_f32", 1e-3)
        by_path["histogram_f32"]["phase3_small_binary"] = \
            run["histogram_f32"]
        lap("phase 3")
    data = full_data(lgb) if phases & {4, 7} else None
    bins_root, f32_auc = None, None
    if 4 in phases:
        bst, run, f32_auc = phase_full(lgb, hist_mod, data)
        by_path["histogram_f32"]["phase4_higgs_binary"] = \
            run["histogram_f32"]
        bins_root = bst.inner.learner.bins
        del bst
        lap("phase 4 (with the full-size binning)")
    rows = None
    if 5 in phases:
        if bins_root is None:
            g = torch.Generator(device="cuda")
            g.manual_seed(3)
            bins_root = torch.randint(0, 255, (FULL_ROWS, 32), generator=g,
                                      device="cuda", dtype=torch.int32
                                      ).to(torch.uint8)
        rows = phase_timing(hist_mod, bins_root, 256, errs)
        time_scan()
        lap("phase 5")
    del bins_root
    if 6 in phases:
        phase_quantize()
        lap("phase 6")
    if 7 in phases:
        run = phase_full_quantized(lgb, hist_mod, data, f32_auc)
        by_path["histogram_i8"]["phase7_higgs_binary_8bit"] = \
            run["histogram_i8"]
        lap("phase 7")
    del data
    if 8 in phases:
        run = phase_small(lgb, hist_mod,
                          {"use_quantized_grad": True, "quant_grad_bits": 16,
                           "bagging_fraction": 0.8, "bagging_freq": 1},
                          "histogram_i16", None)
        by_path["histogram_i16"]["phase8_small_16bit_bagging"] = \
            run["histogram_i16"]
        lap("phase 8")
    widths = []
    if 9 in phases:
        run, bins = phase_covertype(lgb, hist_mod)
        by_path["histogram_f32"]["phase9_covertype_multiclass"] = \
            run["histogram_f32"]
        by_path["histogram_i8"]["phase9_covertype_multiclass_8bit"] = \
            run["histogram_i8"]
        widths.append(("covertype Fp=56", bins))
        lap("phase 9")
    if 10 in phases:
        n, bins = phase_mslr(lgb, hist_mod)
        by_path["histogram_f32"]["phase10_mslr_lambdarank_xendcg"] = n
        widths.append(("mslr Fp=136", bins))
        lap("phase 10")
    if rows is not None and widths:
        time_widths(hist_mod, widths, rows)
        lap("kernel timing at Fp 56 and 136")
    del widths
    if 11 in phases:
        by_path["histogram_f32"]["phase11_other_objectives"] = \
            phase_other_objectives(lgb, hist_mod)
        lap("phase 11")
    if 12 in phases:
        by_path["histogram_f32"].update(phase_predict(lgb, hist_mod))
        lap("phase 12")
    if rows is not None:
        for row in rows:
            row["launches_by_path"] = by_path[row["name"]]
            row["launches"] = sum(by_path[row["name"]].values())
        log(json.dumps({"kernels": rows}))
    log("chip_smoke seconds: %.1f" % (time.perf_counter() - t_start))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
