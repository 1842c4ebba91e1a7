#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``lightgbm_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each one fails the run if it fails):
1. print the card and its power limit; build every CUDA kernel of the
   port from ``lightgbm_tpu_torch/csrc`` (one ``nvcc`` per source, all
   started together: ``histogram.cu`` for uint8 bins and
   ``histogram_u16.cu`` for uint16 bins) and print the build seconds;
   count each kernel's atomic instructions in its SASS and fail if a
   float instance (f32 or f64 sums) holds a compare-and-swap;
2. hold every kernel instance (f32, f32 rows into f64 sums rounded once
   to f32, int8 -> int32, int16 -> int32; over uint8 and over uint16
   bins) against its plain PyTorch version on the card: random rows with and
   without row-index lists (of half the rows, 1, 31, 33, 1000, 1025 and
   100k rows), every row in one bin of every feature, Fp = 8, 40 and 64
   beside 32, Fp = 56 and 136 at the root shapes of phase 9 unbundled
   and phase 10, and bundle columns (Gp = 16 at Bg = 256, phase 9's
   shape, and at Bg = 72), with children of 1, 1000 and 100k rows; two
   f32 calls on the same inputs must give the same bytes (two f64 calls
   too); the f64 sums must be the plain f64 sums rounded once (a value
   may round the other way only at a rounding midpoint); the uint16
   instances likewise at B = 512 (Fp 40), 1024 (Fp 32 and 136), 4096
   and 16384 (Fp 8), with every row in one bin, 70% of the rows in one
   bin, every row in the last 256 bins, every row in bins 256-511 and
   every row outside every slab (bins in [B, 2B), skipped); the
   device-count entry (row count read from device memory) must give the
   host-count launch's bytes for every instance at n = 0,
   1, 1023, 1024, 1025, 10k, 100k, 1M and all rows, at Fp = 32 and 136
   and at the bundle shape Gp = 16, Bg = 72, and over uint16 bins at
   B = 1024, 4096 and 16384;
3. train the binary slice at a small size on ``cuda`` and on ``cpu`` and
   compare the first tree and the held-out AUC;
4. train the full-size slice (10.5M Higgs-shaped rows x 28 features,
   255 leaves, 5 rounds) through ``lightgbm_tpu_torch.train`` with the
   default whole-tree loop (the split step replayed as a CUDA graph),
   predict a 500k held-out set, and check that every histogram went
   through the kernel (its device counter == roots + split steps, and
   steps >= splits); print ms per split, host syncs per tree, capture
   ms, replays per tree and peak memory; a second run of 1 round with
   the per-split loop (``tpu_fused_tree=false``) must give the same
   trees, text for text (the two loops agree, and f32 histograms and
   scans are deterministic);
5. time every kernel at the main path's root shape, and with row-index
   lists of 10k, 100k and 1M rows (L2 flushed), against its plain
   version, one library call and its memory bound, and its device-count
   entry at the same sizes (the uint16 instances over phase 16's bins);
   time a split scan with its prefix sums in the reference's order and
   with a cumsum;
6. draw the quantized-gradient rows (threefry ``uniform`` and
   ``quantize_gh``) at 10.5M rows on the card and on the CPU from the
   same inputs: they must be byte-equal;
7. train the full-size data of phase 4 with quantized gradients
   (``quant_grad_bits=8``, 5 rounds): every histogram must go through the
   int8 instance (launches == roots + steps, no f32 launch), the
   held-out AUC must pass 0.7, and a per-split rerun of 1 round must
   give the same tree, text for text;
8. train 200k rows with ``quant_grad_bits=16`` and bagging on ``cuda``
   and on ``cpu``: tree 1 must make the same splits, through the int16
   instance on the card;
9. multiclass at UCI Covertype's shape (581,012 rows x 54 columns, 7
   classes, synthetic from a seed; 255 leaves, 5 rounds = 35 trees) with
   EFB at its default: the 44 one-hot columns bundle, and the kernel runs
   over the bundle columns; held-out multi_logloss falls every round,
   multi_error ends below the majority class's 0.512, the device
   validation scores equal the host walk within 1e-4, f32 launches ==
   roots + steps over the 35 trees; 1 round at 63 leaves text-equal
   through both loops; a 2-round unbundled f32 run reaches the held-out loss
   within 1e-4 (its prediction gap and structure-equal trees printed);
   on the same gradients the bundled learner's histograms of the root
   and of the root split's smaller child (unpacked, each shared zero bin
   rebuilt from the totals the learner passes) are held against the f64
   sums over the unbundled bins within the f32 kernel's tolerance, and
   ms per split of both learners are timed in turns;
   the same rows as a scipy CSR matrix bin to the same bytes and train
   2 text-equal rounds; the LUT-node encoding of the stacked forest
   gives the compare encoding's and the host walk's leaves and bytes
   (ms per bucket for both); 1 round at 8 bits goes through the int8
   instance only and equal an unbundled 8-bit run text for text, and
   an 8-bit tree 1 at 50k rows is the same on cuda and cpu; softmax
   gradient ms and memory;
10. lambdarank at MSLR-WEB30K's shape (2,270,296 rows x 136 in 18,919
   queries of at most 1,251 docs, synthetic from a seed; 255 leaves,
   min_data_in_leaf 100, ndcg@1,3,5 on 2,000 held-out queries, 5
   rounds): ndcg@5 rises, launches == roots + steps, a 1-round
   per-split rerun is text-equal; the gradient stage's ms and memory;
   then a whole-tree and a per-split 1-round rank_xendcg run must give
   the same trees;
11. every other objective (l1, huber, fair, quantile, mape, poisson,
   gamma, tweedie, cross_entropy, cross_entropy_lambda, multiclassova)
   on phase 3's rows, 63 leaves, 1 round, cuda vs cpu: tree 1 the same
   tree, renewed leaf values (l1, quantile, mape) equal; renewal ms;

12. prediction through the stacked forest: train binary (255 leaves,
   min_data_in_leaf 100, lr 0.1, 100 rounds) on phase 3's 200k rows;
   predict the reference bench's batch (262,144 rows of
   ``make_higgs_like(seed=1)``) through ``Booster.predict`` in auto
   mode (it must dispatch the stacked path), ``predict_raw_device`` and
   ``pred_leaf``, against the host walk: leaf ids equal (on the first
   65,536 rows), values and raw scores byte-equal (on every row), the
   Kahan f32 sum within Kahan's bound of the f64
   sum of the same f32 leaf values (2 f32 ulp of the sum of their
   magnitudes); a 4096-row f64 batch (the dd path)
   byte-equal; rows/s of the host walk, the stacked ``value`` path and
   ``raw_device``, ms per 65,536-row bucket split into quantize, walk
   and sum, bytes each way, peak memory; then continue the model saved
   after 50 rounds for 50 more through ``init_model`` (held-out AUC must
   not fall) and round-trip it through pickle (same predictions).
   Phases 4, 9 and 10 hold the stacked path against the host walk on
   their own boosters and held-out rows too;

13. Covertype in its categorical form (phase 9's rows with the
   wilderness and soil one-hot columns collapsed into two categorical
   columns: 12 columns, ``categorical_feature=[10, 11]``, 5 rounds):
   phase 9's checks, categorical nodes in the model text, the stacked
   path equal to the host walk on rows with NaN, negative and unseen
   categories, 1 round at 63 leaves text-equal through both loops, 1
   round with ``max_cat_to_onehot: 8`` (wilderness one-hot on the
   card), an 8-bit
   tree 1 at 50k rows the same on cuda and cpu;

14. row and column sampling and the per-node filters on phase 4's data
   (255 leaves, max_bin 255, min_data_in_leaf 100, lr 0.1):
   a. ``feature_fraction 0.9`` + ``extra_trees``, 5 rounds, whole-tree
      loop: launches == roots + steps, held-out AUC > 0.7, every split
      feature of a tree inside that tree's mask, stacked predict == host
      walk, a 1-round per-split rerun text-equal; ms per split beside
      phase 4's, and the kernels and ms of one replayed step with and
      without the extra_trees draws;
   b. GOSS at its default rates, 13 rounds (warm-up 10): each GOSS
      tree's in-bag rows are its top rows (ties included) plus
      ``other_k`` sampled within 1%; held-out AUC > 0.7; the draw at all
      10.5M rows byte-equal on the card and the CPU; its ms and memory,
      and the threshold by ``torch.topk`` and ``torch.kthvalue``;
   c. GOSS with 8-bit gradients, lr 0.5, 4 rounds: the int8 instance
      only, a 3-round per-split rerun text-equal;
   d. ``feature_fraction_bynode 0.5`` + interaction constraints (columns
      0-13 and 14-27), 2 rounds: every root-to-leaf path inside one
      group, one record read per split;
   e. CEGB (split, coupled and lazy penalties; coupled 1e9 on columns
      20-27), 2 rounds: those columns never split, the trees differ from
      a run without penalties, the lazy fetched state after tree 1 marks
      exactly the rows under each feature's nodes;
   then tree 1 on cuda and cpu at phase 3's 200k rows (63 leaves) for
   a, GOSS (lr 2.0: no warm-up), d and e must be the same tree;

15. monotone constraints, forced splits and linear trees on phase 4's
   data (255 leaves): +1 on the 4 columns most positively correlated
   with the label in 100k training rows, -1 on the 2 most negative;
   a. the basic method, 5 rounds through the captured whole-tree step:
      launches == roots + steps, held-out predictions exactly monotone
      along a 64-point grid of each constrained column (stacked path), a
      1-round per-split rerun text-equal;
   b. the intermediate method, 2 rounds, and the advanced method, 1
      round at 63 leaves (the host-tracked per-split loop): AUC >=
      basic's after as many rounds at as many leaves - 0.002, the grid
      check, ms and syncs per split, rescans per tree;
   c. monotone_penalty 2.0: no constrained column at depth 0 or 1;
   d. three forced nodes (the root on column 0, its children on 1 and
      2), 3 rounds in f32 and in 8-bit: every tree starts with them, and
      1-round per-split reruns are text-equal;
   e. linear trees (linear_lambda 0.1) on the first 2,097,152 training
      rows, 3 rounds: the fit's ms per tree, stacked predict == the host
      f64 walk, ``raw_device`` within Kahan's bound of its own terms and
      within the f32 rounding bound of the host f64 walk, the text round
      trip;
   then tree 1 on cuda and cpu at 200k rows (63 leaves) for basic
   (f32), intermediate (8-bit), forced (f32) and linear (f32) must be
   the same tree, and the card's linear fit, run again on the CPU from
   the same inputs, within rtol 1e-9;

16. wide bins: phase 4's rows binned again at max_bin 1023 (uint16
   bins, B = 1024, 255 leaves, min_data_in_leaf 100, lr 0.1): f32 for 5
   rounds through the uint16 f32 instance only (held-out AUC > 0.7 and
   equal to the device scores', stacked predict == host walk, a 2-round
   per-split rerun text-equal; ms per split beside phase 4's), 8-bit for
   3 rounds and 16-bit for 2 through their uint16 instances (1-round
   per-split reruns text-equal), tree 1 at 200k rows the same on cuda
   and cpu in f32, 8-bit and 16-bit;
17. f64 histogram sums (``tpu_use_f64_hist``): phase 4's Dataset for 3
   rounds and phase 16's for 2, through the f64 instances; then phase
   9's Covertype rows bundled and unbundled for 2 rounds each, and
   whether their predictions hold the reference's bundle contract
   (rtol 1e-4) is reported (phase 9 reports the f32 pair);
18. DART (drop_rate 0.1, skip_drop 0) and random forest (bagging 0.632
   every round, feature_fraction 0.9) for 5 rounds each on phase 4's
   Dataset: DART's drop sets and tree weights the same on cuda and on a
   CPU run, ``average_output`` in the RF text, both predicting through
   the stacked path == the host walk; then ``Booster.refit`` of phase
   12's model's first 20 iterations on 200k fresh rows on cuda and cpu,
   leaf values within 1e-5;

then time every instance over the learners' real bins of phases 9 (the
bundle columns at Bg), 13 and 10, and print one ``{"kernels": [...]}``
line with the launches of each kernel on each path that runs it, as its
device counter counted them (graph replays included;
``launches_by_path``; f32: phases 3, 4, 9, 10, 11, 12, 13, 14a, 14b,
14d, 14e, 15a-e, 18; int8: phases 7, 9, 14c, 15d; int16: phase 8;
f64: phase 17; the uint16 instances: phase 16, and f64 phase 17); each
instance must have been timed and launched by some path.
Prediction launches
no hand kernel: the stacked walk is PyTorch ops (the reference's is
``jnp``), so it has no row in that line.

Phases 3, 4, 7-11, 13, 14a-c, 15a, 15c-e and 16-18 train through the
default whole-tree loop (14d, 14e and 15b through the per-split loop, which
per-node masks, CEGB and the intermediate and advanced monotone methods
take); every per-split (``tpu_fused_tree=false``) rerun must give its
whole-tree run's trees.

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
import re
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
F64_OPS_PER_S = 34e12           # H100 SXM float64 rate outside tensor cores
#                                 (NVIDIA's H100 data sheet; the f64 adds
#                                 of the f64-sum instances)

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

#: rounds of each per-split (``tpu_fused_tree=false``) rerun that must
#: give its whole-tree run's trees: one tree holds the two loops to the
#: same splits, and the script stays inside its time (14c keeps 3, its
#: first GOSS tree; phase 16, the wide bins' own path, 2)
RERUN_ROUNDS = 1
#: leaves of the Covertype phases' whole-tree / per-split pairs and of the
#: advanced monotone tree (with a basic one beside it): the per-split
#: loop is host-bound (20-40 ms a split), and those 255-leaf rounds took
#: 30-80 s each of the script's 1200 s; the same checks at a cut depth
CUT_LEAVES = 63

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
    """ROC AUC; tied scores share their mean rank (half credit for a
    tied positive-negative pair, as the library's metric counts it)."""
    order = np.argsort(score, kind="stable")
    s = score[order]
    n = len(s)
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    ends = np.r_[starts[1:], n]
    ranks = np.empty(n, dtype=np.float64)
    ranks[order] = np.repeat((starts + 1 + ends) / 2.0, ends - starts)
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
    SASS, and fail if a function of a float instance (mangled template
    arguments ``<float, float, float, ...>``, ``<float, double, float,
    ...>`` and the sums ``<float, float>``, ``<double, float>``) holds a
    compare-and-swap atomic (``ATOMS.CAS*``, ``ATOMS.CAST.SPIN``: the
    loop a float add in shared memory compiles to on this card), or if
    the library has no float instance to check."""
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
    floats = 0
    for fn, c in sorted(counts.items()):
        log("atomic instructions in %s: %s" % (fn, json.dumps(c,
                                                             sort_keys=True)))
        if re.search(r"hist_(rows|sum)_kernelI(ff|fdf|df)", fn):
            floats += 1
            check(not any(".CAS" in t for t in c),
                  "the float instance %s still holds a CAS atomic: %s"
                  % (fn, c))
    check(floats > 0, "no float instance found in the SASS of %s"
          % lib_path)
    log("no compare-and-swap atomic in the %d functions of the float "
        "instances (f32 and f64 sums; %d functions in all)"
        % (floats, len(counts)))


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
def make_hist_inputs(S: int, Fp: int, B: int, seed: int, low: int = 0):
    """Random rows: bins in [low, B) (uint16 when B > 256, the wide
    bins' dtype), f32 gh with a bag, int8 rows and int16 rows as large
    as the int32 accumulator allows at S rows, and a sorted list of half
    the rows."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    bins = torch.randint(low, B, (S, Fp), generator=g, device="cuda",
                         dtype=torch.int32)
    bins = (bins.to(torch.int16).view(torch.uint16) if B > 256
            else bins.to(torch.uint8))
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


def compare_f64(hist_mod, bins, gh, B, idx):
    """The f64-sum instance (f32 rows, f64 adds, one rounding to f32)
    against the plain version's f64 sum over the same rows: every value
    must be that sum rounded to f32, except where the f64 sum lies so
    close to the midpoint of two f32 values that two f64 orders may round
    it to either neighbour: within 1e-11 of the sum of |x| over the bin's
    rows (an f64 sum in any order is within n eps64 sum|x| of the exact
    one; eps64 = 1.1e-16). Returns (max abs error against the f64 sum,
    values off the plain version's rounding)."""
    import torch
    got = hist_mod.build_histogram(bins, gh, B, idx, f64=True)
    torch.cuda.synchronize()
    ref = hist_mod.histogram_plain(bins, gh.double(), B, idx)
    check(got.dtype == torch.float32, "the f64 instance returned %s"
          % got.dtype)
    off = got != ref.float()
    if bool(off.any()):
        a, r = got[off].double(), ref[off]
        hi = torch.nextafter(a.float(), torch.full_like(a.float(),
                                                        float("inf")))
        lo = torch.nextafter(a.float(), torch.full_like(a.float(),
                                                        float("-inf")))
        other = torch.where(r > a, hi, lo).double()
        mid = (a + other) / 2
        mag = hist_mod.histogram_plain(bins, gh.double().abs(), B, idx)
        near = (r - mid).abs() <= 1e-11 * mag[off]
        check(bool(near.all()),
              "f64 histogram is not the rounded f64 sum: %d values off, "
              "not at a rounding midpoint (idx=%s)"
              % (int((~near).sum()), idx is not None))
    return float((got.double() - ref).abs().max()), int(off.sum())


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
               sub_index(S, n, seed=n)) for n in (1, 31, 33, 1000, 1025,
                                                  100_000)]
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
    # EFB: the kernel over bundle columns [N, Gp] at the bundle width Bg
    # (phase 9's Gp = 16 at Bg = 256, and a Bg of 72 bins, off the
    # per-feature B)
    for rows, gp, bg, seed in ((COVERTYPE_ROWS, 16, 256, 7),
                               (1 << 20, 16, 72, 8)):
        wb, wgh, wgh8, wgh16, _ = make_hist_inputs(rows, gp, bg, seed=seed)
        cases.append(("bundles Gp=%d Bg=%d root" % (gp, bg), wb, wgh, wgh8,
                      wgh16, bg, None))
        cases += [("bundles Gp=%d Bg=%d, idx %d" % (gp, bg, n), wb, wgh,
                   wgh8, wgh16, bg, sub_index(rows, n, seed=n + bg))
                  for n in (1, 1000, 100_000)]
    errs = dict.fromkeys(hist_mod.launch_counts, 0.0)
    check_cases(hist_mod, cases, errs, "")
    return errs


def check_cases(hist_mod, cases, errs, prefix):
    """Every instance of one bin dtype (``prefix`` "" for uint8, "u16_"
    for uint16) on each case against its plain version: f32 within
    REL_TOL x sum|x| per bin (counts exact), the f64 sums rounded once
    (:func:`compare_f64`), int8 and int16 byte-equal; then two f32 and
    two f64 calls on the first, second and seventh case byte-equal."""
    import torch
    for label, cb, cgh, cgh8, cgh16, cB, cidx in cases:
        e = compare_f32(hist_mod, cb, cgh, cB, cidx)
        errs["histogram_%sf32" % prefix] = max(
            errs["histogram_%sf32" % prefix], e)
        e64, off = compare_f64(hist_mod, cb, cgh, cB, cidx)
        errs["histogram_%sf64" % prefix] = max(
            errs["histogram_%sf64" % prefix], e64)
        compare_int(hist_mod, cb, cgh8, cB, cidx)
        compare_int(hist_mod, cb, cgh16, cB, cidx)
        log("kernel check [%s] %s S=%d Fp=%d B=%d C=4: f32 max_abs_err "
            "%.3g (tol %.0e x sum|x| per bin, counts exact); f64 sums "
            "rounded once, max_abs_err %.3g against the f64 sum, %d values "
            "off the plain rounding at a midpoint; int8 and int16 "
            "byte-equal" % (label, cb.dtype, cb.shape[0] if cidx is None
                            else cidx.shape[0], cb.shape[1], cB, e,
                            REL_TOL, e64, off))
    again = [c for c in cases
             if c[0] in ("random", "random, idx S/2", "one bin")]
    for label, cb, cgh, _, _, cB, cidx in again:
        for f64 in (False, True):
            first = hist_mod.build_histogram(cb, cgh, cB, cidx, f64=f64)
            second = hist_mod.build_histogram(cb, cgh, cB, cidx, f64=f64)
            check(torch.equal(first.view(torch.int32),
                              second.view(torch.int32)),
                  "two %s calls on the same inputs differ [%s]"
                  % ("f64" if f64 else "f32", label))
    log("f32 and f64 determinism (%s bins): two calls on the same inputs "
        "byte-equal [%s]" % (cases[0][1].dtype, ", ".join(
            c[0] for c in again)))


#: wide bins: (B, Fp, seed) of the uint16 checks; B = 1024 at Fp = 32 is
#: phase 16's learner shape (max_bin 1023); at B = 16384 the integer
#: instances cut a feature into two slabs of 8192 bins
WIDE_SHAPES = ((512, 40, 31), (1024, 32, 32), (1024, 136, 33),
               (4096, 8, 34), (16384, 8, 35))


def phase_wide_kernels(hist_mod, errs):
    """The uint16 build of every instance (f32, f64, int8, int16) at
    B = 512, 1024, 4096 and 16384 against its plain version: random
    rows, all rows and row-index lists of half the rows, 1, 31, 33,
    1000, 1025 and 100k rows, every row in one bin, 70% of the rows in
    one bin (all and half the rows: lanes of one instruction on one
    address), every row in the last 256-bin slab, every row in the
    second slab, every row outside every slab (bins in [B, 2B),
    skipped), at Fp = 8, 32, 40 and 136 (S = 2^20 rows: the last tile of
    a row block is ragged); two f32 and two f64 calls byte-equal. Adds
    to ``errs``."""
    import torch
    S = 1 << 20
    for B, fp, seed in WIDE_SHAPES:
        bins, gh, gh8, gh16, idx = make_hist_inputs(S, fp, B, seed)
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        hot70 = torch.where(torch.rand(bins.shape, generator=g,
                                       device="cuda") < 0.7, B // 3,
                            bins.view(torch.int16).long() & 0xFFFF).to(
            torch.int16).view(torch.uint16)
        last = make_hist_inputs(S, fp, B, seed + 100, low=B - 256)[0]
        second = ((bins.view(torch.int16).long() & 0xFF) + 256).to(
            torch.int16).view(torch.uint16)
        outside = ((bins.view(torch.int16).long() & 0xFFFF) + B).to(
            torch.int16).view(torch.uint16)
        hot = torch.full_like(bins.view(torch.int16), B - 1).view(
            torch.uint16)
        cases = [("random", bins, gh, gh8, gh16, B, None),
                 ("random, idx S/2", bins, gh, gh8, gh16, B, idx)]
        cases += [("random, idx %d" % n, bins, gh, gh8, gh16, B,
                   sub_index(S, n, seed=n + B)) for n in (1, 31, 33, 1000,
                                                          1025, 100_000)]
        cases += [("one bin", hot, gh, gh8, gh16, B, None),
                  ("70% in one bin", hot70, gh, gh8, gh16, B, None),
                  ("70% in one bin, idx S/2", hot70, gh, gh8, gh16, B, idx),
                  ("last slab", last, gh, gh8, gh16, B, None),
                  ("last slab, idx S/2", last, gh, gh8, gh16, B, idx),
                  ("second slab", second, gh, gh8, gh16, B, None),
                  ("outside every slab", outside, gh, gh8, gh16, B, None),
                  ("outside every slab, idx 1025", outside, gh, gh8, gh16,
                   B, sub_index(S, 1025, seed=B))]
        check_cases(hist_mod, cases, errs, "u16_")
        del bins, gh, gh8, gh16, idx, last, second, outside, hot, hot70
        del cases


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
    132 row blocks at most), Fp = 136 (five groups, 26 row blocks) and
    the bundle shape Gp = 16 at Bg = 72 bins over uint8 bins, and over
    uint16 bins at B = 1024 (Fp = 32: 4 groups), B = 4096 (Fp = 8) and B
    = 16384 (Fp = 8; two 8192-bin slabs a feature for integer rows);
    n = 0 must give zeros."""
    import torch
    S = 1 << 20
    checked = 0
    for Fp, B, seed in ((32, 256, 13), (136, 256, 14), (16, 72, 15),
                        (32, 1024, 16), (8, 4096, 17), (8, 16384, 18)):
        bins, gh, gh8, gh16, _ = make_hist_inputs(S, Fp, B, seed=seed)
        for n in DEVICE_COUNT_ROWS + (S,):
            idx = sub_index(S, n, seed=n + Fp) if n < S else torch.arange(
                S, dtype=torch.int32, device="cuda")
            buf, count = count_buffer(idx, S)
            for rows, f64 in ((gh, False), (gh, True), (gh8, False),
                              (gh16, False)):
                got = hist_mod.build_histogram(bins, rows, B, buf, count,
                                               f64=f64)
                want = hist_mod.build_histogram(bins, rows, B, idx,
                                                f64=f64)
                torch.cuda.synchronize()
                check(torch.equal(got.view(torch.int32),
                                  want.view(torch.int32)),
                      "device-count entry (%s%s, %s bins, Fp=%d, B=%d, "
                      "n=%d) differs from the host-count launch"
                      % (rows.dtype, " f64 sums" if f64 else "",
                         bins.dtype, Fp, B, n))
                check(n > 0 or not got.any(),
                      "device-count entry with no rows is not zero")
                checked += 1
    log("device-count entry: byte-equal to the host-count launch in %d "
        "cases (f32, f64 sums, int8, int16; uint8 bins at Fp 32 and 136 "
        "at B 256 and the bundle shape Gp 16 at Bg 72, uint16 bins at Fp "
        "32, B 1024 and Fp 8, B 4096 and 16384; n = %s and all %d rows)"
        % (checked, ", ".join(str(n) for n in DEVICE_COUNT_ROWS), S))


# ---------------------------------------------------------------------------
# phase 5: timing at the main path's root shape and at child sizes
# ---------------------------------------------------------------------------
def hist_bound_ms(S: int, Fp: int, B: int, C: int, gh_bytes: int,
                  with_idx: bool, bin_bytes: int = 1, f64: bool = False):
    """The least time of one histogram call: its bytes once (bins, gh,
    the row list, the output) at the card's memory rate, or its adds at
    the rate of their type (f32, f64 for the f64 sums, int8 for the
    integer rows), whichever is larger."""
    moved = S * Fp * bin_bytes + S * C * gh_bytes \
        + (4 * S if with_idx else 0) + Fp * B * C * 4
    ops = S * Fp * C
    rate = (F64_OPS_PER_S if f64 else F32_OPS_PER_S) if gh_bytes == 4 \
        else INT8_OPS_PER_S
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_histogram(hist_mod, bins, gh, B, name, idx=None, f64=False):
    """Kernel, plain and ``index_add_`` ms and the bound of one call:
    all rows (warm repeats; 336 MB of bins exceed the L2 anyway), or a
    child's row-index list with the L2 flushed before each call. With
    ``f64`` the f64-sum instance (and an f64 ``index_add_``)."""
    import torch
    Fp, C = bins.shape[1], gh.shape[1]
    S = bins.shape[0] if idx is None else idx.shape[0]
    timer = cuda_ms if idx is None else cuda_ms_cold
    kernel_ms = timer(lambda: hist_mod.build_histogram(bins, gh, B, idx,
                                                       f64=f64))
    plain_ms = timer(lambda: hist_mod.histogram_plain(bins, gh, B, idx,
                                                      f64=f64),
                     reps=3, warm=1)
    acc = hist_mod.acc_dtype(gh.dtype, f64)
    rg = gh if idx is None else gh[idx.long()]
    flat = (torch.arange(Fp, dtype=torch.int64, device="cuda")[None, :]
            * B + hist_mod.bin_values(bins, idx)).reshape(-1)
    vals = rg.to(acc)[:, None, :].expand(S, Fp, C).reshape(-1, C)
    out = torch.zeros(Fp * B, C, dtype=acc, device="cuda")
    library_ms = timer(lambda: out.index_add_(0, flat, vals), reps=3,
                       warm=1)
    del flat, vals, out, rg
    bound, by = hist_bound_ms(S, Fp, B, C, gh.element_size(),
                              idx is not None, bins.element_size(), f64)
    log("%s at S=%d%s Fp=%d B=%d C=%d (%s bins): kernel %.4f ms, plain "
        "%.4f ms, index_add_ %.4f ms, bound %.4f ms (%s)"
        % (name, S, "" if idx is None else " (row-index list, L2 flushed)",
           Fp, B, C, bins.dtype, kernel_ms, plain_ms, library_ms, bound,
           by))
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
    e64, _ = compare_f64(hist_mod, bins, gh, B, None)
    errs["histogram_f64"] = max(errs["histogram_f64"], e64)
    log("kernel check at the root shape S=%d: int8 and int16 (|q| <= %d) "
        "byte-equal, f64 sums rounded once (max_abs_err %.3g)"
        % (S, q16, e64))
    return time_instances(hist_mod, bins, B, gh, gh8, gh16, errs, "")


#: the TPU function each instance replaces. The int16 and f64 instances
#: have no Pallas counterpart: the TPU package sends int16 rows through
#: its einsum (_tile_histogram) and f64 sums through its einsum and
#: segment-sum path (build_histogram)
REPLACES = {"f32": "lightgbm_tpu/ops/histogram.py:223",
            "i8": "lightgbm_tpu/ops/histogram.py:223",
            "i16": "lightgbm_tpu/ops/histogram.py:202",
            "f64": "lightgbm_tpu/ops/histogram.py:387"}


def time_instances(hist_mod, bins, B, gh, gh8, gh16, errs, prefix):
    """One kernels-line row per instance of the bins' dtype (``prefix``
    "" for uint8, "u16_" for uint16): its ms at the root shape beside its
    bound, plain and ``index_add_`` times, at children of 10k, 100k and
    1M rows (logged), and its device-count entry at the root list and
    the children."""
    import torch
    S = bins.shape[0]
    source = ("lightgbm_tpu_torch/csrc/histogram.cu" if not prefix else
              "lightgbm_tpu_torch/csrc/histogram_u16.cu")
    rows = []
    children = [sub_index(S, n, seed=n) for n in (10_000, 100_000,
                                                   1_000_000)]
    everything = torch.arange(S, dtype=torch.int32, device="cuda")
    for tag, rows_gh, f64 in (("f32", gh, False), ("f64", gh, True),
                              ("i8", gh8, False), ("i16", gh16, False)):
        name = "histogram_" + prefix + tag
        t = time_histogram(hist_mod, bins, rows_gh, B, name, f64=f64)
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=REPLACES[tag],
            launches=0, max_abs_err=errs[name], bins=str(bins.dtype), B=B,
            **t))
        rows[-1]["children_ms"] = {
            str(idx.shape[0]): time_histogram(hist_mod, bins, rows_gh, B,
                                              name, idx, f64=f64)["ms"]
            for idx in children}
        rows[-1]["device_count_ms"] = {
            str(idx.shape[0]): time_device_count(hist_mod, bins, rows_gh, B,
                                                 name, idx, f64=f64)
            for idx in [everything] + children}
    return rows


def time_device_count(hist_mod, bins, gh, B, name, idx, f64=False):
    """ms of the device-count entry over ``idx`` (all rows: warm
    repeats; a child's list: L2 flushed before each call), beside the
    host-count launch over the same list."""
    buf, count = count_buffer(idx, bins.shape[0])
    timer = cuda_ms if idx.shape[0] == bins.shape[0] else cuda_ms_cold
    ms = timer(lambda: hist_mod.build_histogram(bins, gh, B, buf, count,
                                                f64=f64))
    host_ms = timer(lambda: hist_mod.build_histogram(bins, gh, B, idx,
                                                     f64=f64))
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


def phase_small(lgb, hist_mod, extra, kernel, auc_tol, rounds=3):
    """Train ``rounds`` rounds at 200k rows on cuda and on cpu; tree 1
    must make the same splits, and the cuda run must go through
    ``kernel``. The held-out AUCs must agree within ``auc_tol`` where
    that is given (f32 sums run in another order on the card, so later
    trees may fork at near-ties)."""
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
        bst = lgb.train(params, ds, num_boost_round=rounds,
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
    log("small slice (%d rows, 63 leaves, %d round(s), %s): tree 1 splits "
        "equal on cuda and cpu; held-out AUC cuda %.6f cpu %.6f; %d "
        "launches of %s on cuda"
        % (SMALL_ROWS, rounds, json.dumps(extra), res["cuda"][1],
           res["cpu"][1], launches[kernel], kernel))
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


def hist_rows(bins, gh, num_bins, idx=None, count=None, f64=False):
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


#: phase 15e's rows: the first LINEAR_ROWS training rows of full_data
LINEAR_ROWS = 1 << 21
HEAD = {}


def full_data(lgb, keep_head=False):
    """The full-size data of phases 4 and 7: 10.5M Higgs-shaped training
    rows binned at max_bin 255, and a 500k held-out set. With
    ``keep_head`` the training rows and labels stay in ``HEAD`` (phase
    15a-c bins them again with monotone constraints), and a copy of the
    first LINEAR_ROWS (phase 15e)."""
    t0 = time.perf_counter()
    X, y = make_higgs_like(FULL_ROWS + HELD_OUT_ROWS)
    Xt, yt = X[:FULL_ROWS], y[:FULL_ROWS]
    Xv, yv = X[FULL_ROWS:], y[FULL_ROWS:]
    if keep_head:
        HEAD["X"] = X[:LINEAR_ROWS].copy()
        HEAD["y"] = y[:LINEAR_ROWS].copy()
        HEAD["Xt"], HEAD["yt"] = Xt, yt
    log("full size: generated %d + %d rows x %d in %.1f s"
        % (FULL_ROWS, HELD_OUT_ROWS, X.shape[1], time.perf_counter() - t0))
    t0 = time.perf_counter()
    ds = lgb.Dataset(Xt, label=yt, params=SLICE_PARAMS).construct()
    valid = lgb.Dataset(Xv, label=yv, reference=ds).construct()
    log("binning seconds: %.3f" % (time.perf_counter() - t0))
    return ds, valid, Xv, yv


def train_full(lgb, hist_mod, data, extra, kernel, rounds=5, tag=None):
    """Train the full-size data through ``lightgbm_tpu_torch.train``
    (:func:`train_path`). Returns (booster, launches, held-out AUC per
    round, seconds per iteration, quantize ms per tree)."""
    ds, valid, _, _ = data
    run = train_path(lgb, hist_mod, ds, valid,
                     dict(SLICE_PARAMS, num_leaves=255, **extra), kernel,
                     rounds, tag=tag)
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
    SPLIT_MS[tag] = 1e3 * sum(tree_seconds) / max(splits, 1)
    check(len(trees) == rounds * K, "expected %d trees, got %d"
          % (rounds * K, len(trees)))
    check(all(t.num_leaves > 1 for t in trees), "a tree has one leaf")
    launches = check_device_launches(hist_mod, bst, kernel, tag)
    learner = bst.inner.learner
    stats = learner.grow_stats
    # the loop the config asks for: per-node masks and CEGB take the
    # per-split loop whatever tpu_fused_tree says. The whole-tree loop
    # reads one record buffer per tree and no split record; the
    # per-split loop one record per split (one more for a tree that ends
    # before num_leaves) and no record buffer
    # (and so do the intermediate and advanced monotone methods, which
    # read one more record after each split's rescans); forced splits
    # read one record each before either loop
    mono = learner._mono_tracker is not None
    fused = (learner._fused_growth and not learner._cegb_enabled
             and not mono and (learner._forced is not None
                               or not learner._needs_per_node_masks()))
    forced = stats["forced_reads"]
    if fused:
        check(stats["split_reads"] == 0
              and stats["record_reads"] == len(trees),
              "%s: the whole-tree loop read %d split records and %d "
              "record buffers for %d trees" % (
                  tag, stats["split_reads"], stats["record_reads"],
                  len(trees)))
    else:
        most = (2 * splits if mono else splits) + len(trees)
        check(stats["record_reads"] == 0
              and splits - forced <= stats["split_reads"] <= most,
              "%s: the per-split loop read %d record buffers and %d split "
              "records for %d splits in %d trees" % (
                  tag, stats["record_reads"], stats["split_reads"], splits,
                  len(trees)))
    # a forced split is a host-stepped split with two host syncs: the
    # read of its record (``tolist``) and the partition's ``nonzero``
    # (SerialTreeLearner._apply_forced and _split)
    sync_bound = (math.ceil((learner.L - 1) / serial.FUSED_CHUNK) + 2
                  + math.ceil(2 * forced / len(trees)))
    if fused:
        check(max(tree_syncs) <= sync_bound,
              "%s: %d host syncs in a tree, more than ceil((L-1)/%d) + 2 "
              "(+ 2 per forced split) = %d"
              % (tag, max(tree_syncs), serial.FUSED_CHUNK, sync_bound))
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
        "ceil((L-1)/%d) + 2, plus 2 per forced split = %d); graph "
        "captures %d, capture ms %.1f; "
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
                splits=splits, fused=fused)


#: mean ms per split of each training run (tree seconds / splits), by tag
SPLIT_MS = {}
#: the tag of phase 4's run
PHASE4_TAG = json.dumps({"num_leaves": 255})


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


def loops_agree(lgb, hist_mod, ds, valid, params, what):
    """``RERUN_ROUNDS`` rounds at ``CUT_LEAVES`` leaves through the
    whole-tree loop and through the per-split loop must give the same
    trees, text for text."""
    cut = dict(params, num_leaves=CUT_LEAVES)
    trees = []
    for fused, loop in ((True, "whole-tree"), (False, "per-split")):
        bst = train_path(lgb, hist_mod, ds, valid,
                         dict(cut, tpu_fused_tree=fused), "histogram_f32",
                         RERUN_ROUNDS, tag="%s %s, %d leaves"
                         % (what, loop, CUT_LEAVES))["booster"]
        trees.append([t.to_string() for t in bst.inner.models])
        del bst
    check(trees[0] == trees[1], "a per-split %s run gave other trees than "
          "the whole-tree run" % what)
    log("%s at %d leaves (%d round(s)): all %d trees text-equal through "
        "the whole-tree and the per-split loop"
        % (what, CUT_LEAVES, RERUN_ROUNDS, len(trees[0])))


def check_rerun(lgb, hist_mod, data, extra, kernel, bst, what,
                rounds=RERUN_ROUNDS):
    """A second run of ``rounds`` rounds through the per-split loop must
    give the first (whole-tree) run's first trees, text for text."""
    again, _, _, _, _ = train_full(lgb, hist_mod, data,
                                   dict(extra, tpu_fused_tree=False),
                                   kernel, rounds=rounds)
    first = [t.to_string() for t in bst.inner.models[:rounds]]
    second = [t.to_string() for t in again.inner.models]
    check(first == second, "a per-split %s run gave other trees than the "
          "whole-tree run" % what)
    log("%s per-split rerun (%d round(s)): the first %d tree(s) text-equal "
        "to the whole-tree run's" % (what, rounds, rounds))


def phase_full(lgb, hist_mod, data):
    """The main path at full size (f32 gradients), and a 1-round rerun
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
    per-split rerun of 1 round must give the same first tree."""
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


def covertype_splits(Xt, yt, Xv, yv, lgb, params):
    """The training and held-out Datasets of a Covertype-shaped run."""
    ds = lgb.Dataset(Xt, label=yt, params=params).construct()
    valid = lgb.Dataset(Xv, label=yv, reference=ds).construct()
    return ds, valid


def check_multiclass(bst, run, Xv, yv, what):
    """The phase 9 checks of a 7-class run: held-out multi_logloss falls
    every round, multi_error ends below the majority class's, the device
    validation scores equal the host walk within 1e-4, the probabilities
    sum to 1, and the stacked path (auto mode) equals the host walk."""
    evals = run["evals"]
    loss, err = evals["multi_logloss"], evals["multi_error"]
    check(all(b < a for a, b in zip(loss, loss[1:])),
          "%s: held-out multi_logloss did not fall every round: %s"
          % (what, loss))
    majority_error = 1.0 - max(COVERTYPE_SHARES)
    check(err[-1] < majority_error,
          "%s: held-out multi_error %.4f is not below the majority-class "
          "error %.3f" % (what, err[-1], majority_error))
    host = bst.predict(Xv, raw_score=True, predict_on_device=False)
    dev = bst.inner.valid_data[0].scores
    check(host.shape == dev.shape == (len(yv), 7)
          and bool(np.isfinite(host).all()),
          "%s: raw scores are not finite or of the wrong shape" % what)
    gap = float(np.abs(host - dev).max())
    check(gap <= 1e-4, "%s: host-walk scores differ from the device "
          "validation scores by %.3g" % (what, gap))
    prob = bst.predict(Xv, predict_on_device=False)
    check(bool(np.allclose(prob.sum(axis=1), 1.0)),
          "%s: class probabilities do not sum to 1" % what)
    check_stacked(bst, Xv, what)
    learner = bst.inner.learner
    log("%s: held-out multi_logloss %s; multi_error %s (majority-class "
        "error %.3f); host walk vs device scores max |diff| %.3g; mean "
        "seconds per iteration %.3f; ms per split (mean over trees) %.3f; "
        "peak memory %.3f GiB; gradient ms per iteration %s"
        % (what, " ".join("%.6f" % v for v in loss),
           " ".join("%.6f" % v for v in err), majority_error, gap,
           float(np.mean(run["per_iter"])),
           1e3 * sum(run["tree_seconds"]) / max(run["splits"], 1),
           run["peak"] / 2 ** 30,
           " ".join("%.3f" % v for v in run["grad_ms"])))
    return learner


def first_tree_cuda_vs_cpu(lgb, Xt, yt, params, what, sub=50_000,
                           categorical_feature=None):
    """Tree 1 (class 0) at ``sub`` rows with 8-bit gradients (integer
    histograms: the same sums in any order) on cuda and on cpu."""
    first = {}
    for dev_type in ("cuda", "cpu"):
        sds = lgb.Dataset(Xt[:sub], label=yt[:sub],
                          categorical_feature=categorical_feature)
        b = lgb.train(dict(params, device_type=dev_type,
                           use_quantized_grad=True, quant_grad_bits=8),
                      sds, num_boost_round=1)
        t = b.inner.models[0]
        first[dev_type] = (tree_splits_of(t), list(t.cat_boundaries),
                           list(t.cat_threshold),
                           list(t.leaf_count[:t.num_leaves]))
    check(first["cuda"] == first["cpu"],
          "%s: 8-bit tree 1 (class 0) differs between cuda and cpu at %d "
          "rows" % (what, sub))
    log("%s 8-bit at %d rows: tree 1 (class 0) makes the same %d splits "
        "(categories and leaf counts too) on cuda and cpu"
        % (what, sub, first["cuda"][0][0] - 1))


def phase_covertype(lgb, hist_mod):
    """Multiclass (softmax, 7 classes, K = 7 trees per iteration) at
    Covertype's shape: 581,012 training rows x 54 columns, 255 leaves,
    5 rounds, with EFB at its default (``enable_bundle=true``): the 44
    one-hot columns bundle and the kernel runs over the bundle columns.
    Then a 2-round unbundled run (held-out loss within 1e-4; the f32
    prediction gap printed), the bundled histograms held against f64
    sums over the unbundled bins and both learners timed on the same
    gradients, the same rows as a scipy CSR matrix (bins byte-equal, 2
    rounds text-equal), the LUT-node encoding of the stacked forest, 2
    rounds with 8-bit gradients bundled and unbundled (text-equal), and
    an 8-bit run on a 50k-row subset on cuda and cpu. Returns the
    launches by path and the learner's bundle columns with their width,
    for timing."""
    import scipy.sparse as sp
    from lightgbm_tpu_torch.objective.multiclass import MulticlassSoftmax
    t0 = time.perf_counter()
    X, y = make_covertype_like(COVERTYPE_ROWS + COVERTYPE_HELD_OUT, seed=9)
    Xt, yt = X[:COVERTYPE_ROWS], y[:COVERTYPE_ROWS]
    Xv, yv = X[COVERTYPE_ROWS:], y[COVERTYPE_ROWS:]
    shares = np.bincount(yt.astype(int), minlength=7) / len(yt)
    params = {"objective": "multiclass", "num_class": 7, "num_leaves": 255,
              "learning_rate": 0.1, "max_bin": 255,
              "metric": "multi_logloss,multi_error", "verbosity": -1}
    t_gen = time.perf_counter() - t0
    ds, valid = covertype_splits(Xt, yt, Xv, yv, lgb, params)
    lay = ds.handle.bundle
    check(lay is not None, "covertype: the one-hot columns did not bundle")
    log("covertype-like: %d + %d rows x %d, class shares %s; generated in "
        "%.1f s, binned in %.1f s; EFB: %d features in %d bundle columns "
        "(%d of them shared: %s), %d bundle bins"
        % (len(yt), len(yv), X.shape[1],
           " ".join("%.3f" % v for v in shares), t_gen,
           time.perf_counter() - t0 - t_gen, ds.handle.num_features,
           lay.num_groups, sum(len(g) > 1 for g in lay.groups),
           [len(g) for g in lay.groups if len(g) > 1],
           lay.num_bundled_bins))
    run = train_path(lgb, hist_mod, ds, valid, params, "histogram_f32", 5,
                     grad_cls=MulticlassSoftmax,
                     tag="covertype multiclass bundled")
    bst = run["booster"]
    learner = check_multiclass(bst, run, Xv, yv, "phase 9 covertype")
    check(learner._bundled and learner.bins.shape[1] == learner.Gp,
          "covertype: the learner does not hold the bundle columns")
    log("phase 9 covertype bundled: G = %d (Gp = %d) bundle columns at "
        "Bg = %d bins, against Fp = %d features at B = %d"
        % (lay.num_groups, learner.Gp, learner.Bg, learner.Fp, learner.B))
    loops_agree(lgb, hist_mod, ds, valid, params, "covertype bundled")
    R = RERUN_ROUNDS
    launches = {"phase9_covertype_bundled": run["launches"]["histogram_f32"]}
    # unbundled, 2 rounds, against the reference's contract for bundles
    # (tests/test_efb.py::test_bundled_matches_unbundled_predictions,
    # rtol 1e-4 at 2,000 rows). In f32 a bundled feature's zero bin is
    # summed from other bins than the unbundled one's rows, and sibling
    # subtraction carries that rounding (an ulp of the root's sums) into
    # small leaves, so the f32 gap is measured and held at level (c):
    # the held-out loss within 1e-4, and the bundled histograms within
    # the f32 tolerance of their f64 sums (check_bundled_histograms);
    # the 8-bit pair below, with exact integer histograms, must be
    # text-equal
    p0 = dict(params, enable_bundle=False)
    ds0, valid0 = covertype_splits(Xt, yt, Xv, yv, lgb, p0)
    unb = train_path(lgb, hist_mod, ds0, valid0, p0, "histogram_f32", 2,
                     tag="covertype unbundled 2 rounds")
    plain = unb["booster"]
    check(not plain.inner.learner._bundled, "enable_bundle=false bundled")
    p_b = bst.predict(Xv, num_iteration=2, predict_on_device=False)
    p_u = plain.predict(Xv, predict_on_device=False)
    same = sum(tree_structure(a) == tree_structure(b)
               for a, b in zip(bst.inner.models[:14], plain.inner.models))
    gap = np.abs(p_b - p_u)
    within = bool(np.allclose(p_b, p_u, rtol=1e-4, atol=1e-5))
    loss_gap = abs(run["evals"]["multi_logloss"][1]
                   - unb["evals"]["multi_logloss"][1])
    log("covertype bundled vs unbundled, f32 (2 rounds): %d of 14 trees "
        "structure-equal; predictions max |diff| %.3g, %.4f%% of values "
        "beyond rtol 1e-4 + atol 1e-5 (all within: %s); held-out "
        "multi_logloss round 2 %.6f vs %.6f"
        % (same, float(gap.max()),
           100.0 * float(np.mean(gap > 1e-5 + 1e-4 * np.abs(p_u))), within,
           run["evals"]["multi_logloss"][1],
           unb["evals"]["multi_logloss"][1]))
    check(loss_gap <= 1e-4, "bundled and unbundled held-out multi_logloss "
          "differ by %.3g" % loss_gap)
    time_bundled_step(bst.inner.learner, plain.inner.learner, hist_mod)
    del plain, unb
    # the same rows as a CSR matrix
    t0 = time.perf_counter()
    Xs = sp.csr_matrix(Xt)
    dss, valids = covertype_splits(Xs, yt, Xv, yv, lgb, params)
    t_sparse = time.perf_counter() - t0
    check(dss.handle.bins.tobytes() == ds.handle.bins.tobytes(),
          "CSR bins differ from the dense bundled bins")
    sparse = train_path(lgb, hist_mod, dss, valids, params, "histogram_f32",
                        R, tag="covertype CSR")["booster"]
    check([t.to_string() for t in bst.inner.models[:7 * R]]
          == [t.to_string() for t in sparse.inner.models],
          "CSR covertype run gave other trees than the dense run")
    log("covertype as a CSR matrix (%d stored values): bins byte-equal to "
        "the dense bundled bins (built in %.1f s); %d round(s) text-equal "
        "to the dense run's" % (Xs.nnz, t_sparse, R))
    del sparse, dss, valids, Xs
    time_lut_encoding(bst, Xv, "phase 9 covertype bundled")
    bins = (learner.bins, learner.Bg)
    del bst, learner
    q8 = dict(params, use_quantized_grad=True, quant_grad_bits=8)
    qrun = train_path(lgb, hist_mod, ds, valid, q8, "histogram_i8", R,
                      tag="covertype multiclass bundled 8-bit")
    launches["phase9_covertype_bundled_8bit"] = \
        qrun["launches"]["histogram_i8"]
    qplain = train_path(lgb, hist_mod, ds0, valid0,
                        dict(q8, enable_bundle=False), "histogram_i8", R,
                        tag="covertype multiclass unbundled 8-bit")
    check([t.to_string() for t in qrun["booster"].inner.models]
          == [t.to_string() for t in qplain["booster"].inner.models],
          "8-bit bundled and unbundled covertype runs gave other trees")
    log("covertype 8-bit: bundled and unbundled %d-round runs text-equal "
        "(all %d trees; integer histograms, exact zero bins); held-out "
        "multi_logloss %s (f32 %s)"
        % (R, 7 * R,
           " ".join("%.6f" % v for v in qrun["evals"]["multi_logloss"]),
           " ".join("%.6f" % v for v in run["evals"]["multi_logloss"][:R])))
    del qrun, qplain, ds0, valid0
    first_tree_cuda_vs_cpu(lgb, Xt, yt, params, "phase 9 covertype")
    return launches, bins


def check_bundled_histograms(bundled, unbundled, gh, hist_mod):
    """The bundled learner's f32 histograms against f64 sums over the
    unbundled learner's bins, on the same rows: the root (totals from
    ``sum_gh``, as ``_root`` passes them) and the smaller child of the
    root's winning split (totals from its record row, as ``_step``
    passes them). Counts must be exact, so totals of other rows than
    the leaf's fail there. A grad/hess bin may be off by ``REL_TOL``
    times the f64 sum of its rows' absolute values (the bound of
    :func:`compare_f32`); a rebuilt zero bin (totals minus the feature's
    other bins) carries the rounding of the totals, which sum every row
    of the leaf at the root and come from the root's histogram for the
    child, so its bound is ``REL_TOL`` times the root's absolute sum.
    The unbundled kernel
    is held to the same per-bin bound, and the largest bundled -
    unbundled difference is printed."""
    import torch
    from lightgbm_tpu_torch.ops import split as S
    from lightgbm_tpu_torch.ops.quantize import sum_gh
    check(bundled.B == unbundled.B and bundled.F == unbundled.F,
          "bundled and unbundled learners differ in shape")
    B, F = bundled.B, bundled.F       # pad features past F hold nothing
    bt = bundled._btab
    zero_at = torch.zeros((bundled.Fp, B), dtype=torch.bool,
                          device=gh.device)
    zero_at[torch.arange(bundled.Fp, device=gh.device),
            bundled.meta.zero_bin.long()] = bt.zero_fix
    zero_at = zero_at[:F]
    state = bundled._new_state(gh)
    bundled._root(state)
    row = state.cand[0]
    check(bool(torch.isfinite(row[S.GAIN])), "covertype root has no split")
    gl = bundled._go_left(row)
    left = bool(row[S.LEFT_TOTAL_COUNT] <= row[S.RIGHT_TOTAL_COUNT])
    side = S.LEFT_SUM_GRAD if left else S.RIGHT_SUM_GRAD
    small = torch.nonzero(gl if left else ~gl).view(-1).to(torch.int32)
    cases = (("root", None, sum_gh(gh, bundled._padded_rows)),
             ("root's smaller child", small, row[side:side + 4]))
    worst, root_mag = {}, None
    for what, idx, totals in cases:
        got = bundled._leaf_histogram(gh, idx, totals=totals)[:F].double()
        flat = unbundled.bins
        ref = hist_mod.histogram_plain(flat, gh.double(), B, idx)[:F]
        mag = hist_mod.histogram_plain(flat, gh[:, :2].double().abs(), B,
                                       idx)[:F]
        if root_mag is None:
            root_mag = mag[0].sum(dim=0)     # [2]: every row in one bin
        bound = REL_TOL * torch.where(zero_at[..., None], root_mag, mag)
        check(torch.equal(got[..., 2:], ref[..., 2:]),
              "bundled %s histogram: count channels differ from the "
              "unbundled bins' counts" % what)
        err = (got[..., :2] - ref[..., :2]).abs()
        check(bool((err <= bound).all()),
              "bundled %s histogram off the f64 sums by %.3g (%.3g of its "
              "bound)" % (what, float(err.max()),
                          float((err / bound.clamp(min=1e-300)).max())))
        flat_got = hist_mod.build_histogram(flat, gh, B, idx)[:F].double()
        ferr = (flat_got[..., :2] - ref[..., :2]).abs()
        check(bool((ferr <= REL_TOL * mag).all()),
              "unbundled %s histogram off the f64 sums by %.3g"
              % (what, float(ferr.max())))
        worst[what] = (float(err.max()), float(ferr.max()),
                       float((got - flat_got).abs().max()),
                       int(zero_at.sum()), len(gh) if idx is None
                       else len(idx))
    log("covertype bundled f32 histograms against f64 sums over the "
        "unbundled bins (%d rebuilt zero bins; bound REL_TOL x abs sum "
        "per bin, the root's for a rebuilt bin): %s"
        % (int(zero_at.sum()), "; ".join(
            "%s (%d rows): max err bundled %.3g, unbundled %.3g, bundled "
            "- unbundled %.3g" % (k, v[4], v[0], v[1], v[2])
            for k, v in worst.items())))


def time_bundled_step(bundled, unbundled, hist_mod, trees: int = 2):
    """The whole-tree loop of a bundled and an unbundled learner on the
    same rows and the same gradients (synthetic, from a seed), in turns
    (unbundled, bundled, bundled, unbundled): ms per split of each, on
    one card in one call. First the bundled histograms on those
    gradients are checked (:func:`check_bundled_histograms`)."""
    import torch
    n, dev = bundled.N, bundled.device
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    grad = torch.rand(n, generator=g, device=dev) - 0.5
    hess = torch.rand(n, generator=g, device=dev) * 0.25
    gh = torch.stack([grad, hess, torch.ones_like(grad),
                      torch.ones_like(grad)], dim=1)
    check_bundled_histograms(bundled, unbundled, gh, hist_mod)
    ms = {"unbundled": [], "bundled": []}
    for name in ("unbundled", "bundled", "bundled", "unbundled"):
        learner = bundled if name == "bundled" else unbundled
        for _ in range(trees):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree, _ = learner._grow_fused(gh)
            torch.cuda.synchronize()
            ms[name].append(1e3 * (time.perf_counter() - t0)
                            / max(tree.num_leaves - 1, 1))
    log("whole-tree loop on the same gradients (covertype, 255 leaves; "
        "in turns): ms per split unbundled %s, bundled %s"
        % (" ".join("%.3f" % v for v in ms["unbundled"]),
           " ".join("%.3f" % v for v in ms["bundled"])))


def time_lut_encoding(bst, X, what):
    """The LUT-node encoding (``lut=True``) of a booster's stacked
    forest against the compare encoding and the host walk (leaf ids
    equal, raw scores byte-equal), and each encoding's ms per
    65,536-row bucket by stage."""
    from lightgbm_tpu_torch.serve import StackedForest
    host_leaf = bst.predict(X, pred_leaf=True, predict_on_device=False)
    host_raw = bst.predict(X, raw_score=True, predict_on_device=False)
    stages = {}
    for lut in (False, True):
        forest = StackedForest.from_gbdt(bst, lut=lut).place("cuda")
        check(forest.lut_nodes == lut, "lut=%s was not built" % lut)
        check(np.array_equal(forest.leaves(X), host_leaf),
              "%s: lut=%s leaf ids differ from the host walk" % (what, lut))
        check(np.array_equal(forest.predict_raw(X), host_raw),
              "%s: lut=%s raw scores differ from the host walk"
              % (what, lut))
        Xb = np.ascontiguousarray(np.resize(X, (1 << 16, X.shape[1])),
                                  dtype=np.float32)
        stages["lut" if lut else "compare"] = time_dispatch(forest, Xb)
    log("%s stacked forest: the LUT-node encoding and the compare encoding "
        "give the host walk's leaf ids and raw bytes on %d rows; ms per "
        "65536-row bucket by stage (CUDA events): %s"
        % (what, X.shape[0], json.dumps({
            k: {s: round(v, 4) for s, v in st.items()}
            for k, st in stages.items()})))


# ---------------------------------------------------------------------------
# phase 13: Covertype in its categorical form
# ---------------------------------------------------------------------------
def make_covertype_categorical(n: int, seed: int):
    """Phase 9's generator with its 4 wilderness and 40 soil one-hot
    columns collapsed into one categorical column each (values 0..3 and
    0..39): 12 columns."""
    X, y = make_covertype_like(n, seed)
    wild = np.argmax(X[:, 10:14], axis=1).astype(np.float32)
    soil = np.argmax(X[:, 14:54], axis=1).astype(np.float32)
    return np.column_stack([X[:, :10], wild, soil]), y


def unusual_categories(Xv: np.ndarray) -> np.ndarray:
    """Held-out rows with NaN, negative, fractional and unseen values in
    the two categorical columns (every 1000-row block one kind)."""
    Xu = Xv.copy()
    for k, (col, val) in enumerate(((10, np.nan), (10, -1.0), (10, 9.0),
                                    (10, 2.5), (11, np.nan), (11, -5.0),
                                    (11, 77.0), (11, 40.0), (11, 31.0))):
        Xu[k * 1000:(k + 1) * 1000, col] = val
    return Xu


def cat_nodes(bst, feature):
    """(category sets of the categorical nodes on ``feature``, count of
    categorical nodes) over the booster's trees."""
    sets, total = [], 0
    for t in bst.inner.models:
        for j in range(t.num_internal):
            if int(t.decision_type[j]) & 1:
                total += 1
                if int(t.split_feature[j]) == feature:
                    sets.append(t._cats_of(int(t.threshold_in_bin[j])))
    return sets, total


def phase_covertype_categorical(lgb, hist_mod):
    """Phase 9's rows in their categorical form: 581,012 + 50,000 held
    out x 12 columns, ``categorical_feature=[10, 11]`` (wilderness: 4
    values, num_bin 5 > max_cat_to_onehot 4, so both columns take the
    sorted subset), 7 classes, 255 leaves, 5 rounds through the
    whole-tree loop; phase 9's checks, categorical nodes in the model
    text, the stacked path (auto mode) on rows with NaN, negative and
    unseen categories, 1 round at ``CUT_LEAVES`` leaves through both
    loops, 1 round with ``max_cat_to_onehot: 8`` (wilderness in one-hot
    mode) and an 8-bit
    tree 1 at 50k rows on cuda and cpu. Returns the launches by path and
    the learner's bins for timing."""
    from lightgbm_tpu_torch.objective.multiclass import MulticlassSoftmax
    t0 = time.perf_counter()
    X, y = make_covertype_categorical(COVERTYPE_ROWS + COVERTYPE_HELD_OUT,
                                      seed=9)
    Xt, yt = X[:COVERTYPE_ROWS], y[:COVERTYPE_ROWS]
    Xv, yv = X[COVERTYPE_ROWS:], y[COVERTYPE_ROWS:]
    params = {"objective": "multiclass", "num_class": 7, "num_leaves": 255,
              "learning_rate": 0.1, "max_bin": 255,
              "categorical_feature": [10, 11],
              "metric": "multi_logloss,multi_error", "verbosity": -1}
    ds, valid = covertype_splits(Xt, yt, Xv, yv, lgb, params)
    mappers = ds.handle.bin_mappers
    nb = [m.num_bin for m in mappers[-2:]]
    # wilderness: 4 categories + bin 0 = 5 bins > max_cat_to_onehot 4,
    # so the sorted subset scans it; soil keeps the categories that
    # cover 99% of the sample (bin.cpp:424-491)
    check([m.bin_type for m in mappers[-2:]] == [1, 1] and nb[0] == 5,
          "covertype categorical: columns 10, 11 are not categorical, "
          "wilderness with 5 bins: %s" % nb)
    log("covertype categorical: %d + %d rows x %d (wilderness %d bins, "
        "soil %d bins); generated and binned in %.1f s"
        % (len(yt), len(yv), X.shape[1], nb[0], nb[1],
           time.perf_counter() - t0))
    run = train_path(lgb, hist_mod, ds, valid, params, "histogram_f32", 5,
                     grad_cls=MulticlassSoftmax,
                     tag="covertype multiclass categorical")
    bst = run["booster"]
    learner = check_multiclass(bst, run, Xv, yv, "phase 13 covertype "
                               "categorical")
    check(learner._has_cat and not learner._bundled,
          "covertype categorical: the learner has no categorical scan")
    text = bst.model_to_string()
    wild_sets, n_cat = cat_nodes(bst, 10)
    soil_sets, _ = cat_nodes(bst, 11)
    check(n_cat > 0 and "cat_threshold=" in text,
          "covertype categorical: no categorical node in the model text")
    log("phase 13 categorical nodes: %d of %d (wilderness %d, soil %d; "
        "soil sets of %s categories)"
        % (n_cat, sum(t.num_internal for t in bst.inner.models),
           len(wild_sets), len(soil_sets),
           sorted({len(c) for c in soil_sets})))
    check_stacked(bst, unusual_categories(Xv),
                  "phase 13 covertype categorical, NaN / negative / "
                  "unseen categories")
    loops_agree(lgb, hist_mod, ds, valid, params, "covertype categorical")
    R = RERUN_ROUNDS
    launches = {"phase13_covertype_categorical":
                run["launches"]["histogram_f32"]}
    bins = (learner.bins, learner.B)
    del bst, learner
    oh = dict(params, max_cat_to_onehot=8)
    ohrun = train_path(lgb, hist_mod, ds, valid, oh, "histogram_f32", R,
                       tag="covertype categorical, wilderness one-hot")
    wild_oh, _ = cat_nodes(ohrun["booster"], 10)
    check(len(wild_oh) > 0 and all(len(c) == 1 for c in wild_oh),
          "max_cat_to_onehot=8: wilderness splits are not one-hot: %s"
          % wild_oh[:5])
    log("covertype categorical, max_cat_to_onehot 8: %d wilderness splits, "
        "each one category (one-hot mode); held-out multi_logloss %s"
        % (len(wild_oh), " ".join(
            "%.6f" % v for v in ohrun["evals"]["multi_logloss"])))
    launches["phase13_covertype_categorical_onehot"] = \
        ohrun["launches"]["histogram_f32"]
    del ohrun
    first_tree_cuda_vs_cpu(lgb, Xt, yt, params, "phase 13 covertype "
                           "categorical")
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
    rounds; a 1-round rerun must give the same tree; then 1 round of
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
    R = RERUN_ROUNDS
    again = train_path(lgb, hist_mod, ds, valid,
                       dict(params, tpu_fused_tree=False), "histogram_f32",
                       R, tag="mslr lambdarank per-split rerun")["booster"]
    check([t.to_string() for t in bst.inner.models[:R]]
          == [t.to_string() for t in again.inner.models],
          "a per-split lambdarank run gave other trees than the whole-tree "
          "run")
    log("mslr lambdarank per-split rerun (%d round(s)): text-equal to the "
        "whole-tree run's first trees" % R)
    launches = run["launches"]["histogram_f32"]
    bins = bst.inner.learner.bins
    del bst, again
    xe = dict(params, objective="rank_xendcg")
    from lightgbm_tpu_torch.objective.rank import RankXENDCG
    texts = []
    for fused in (True, False):
        r = train_path(lgb, hist_mod, ds, valid,
                       dict(xe, tpu_fused_tree=fused), "histogram_f32", R,
                       grad_cls=RankXENDCG,
                       tag="mslr rank_xendcg %s" % ("whole-tree" if fused
                                                    else "per-split"))
        texts.append([t.to_string() for t in r["booster"].inner.models])
        launches += r["launches"]["histogram_f32"]
    check(texts[0] == texts[1], "the per-split rank_xendcg run gave other "
          "trees than the whole-tree run")
    log("mslr rank_xendcg: whole-tree and per-split %d-round runs "
        "text-equal; held-out ndcg@5 %s"
        % (R, " ".join("%.6f" % v for v in r["evals"]["ndcg@5"])))
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
    (binned once), 63 leaves, 1 round, on cuda and on cpu: tree 1 must
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
                              num_boost_round=1)
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
        log("objective %s (63 leaves, 1 round, %d trees): tree 1 the same "
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
    leaves = P._walk_stacked(bins_t, forest._nodes, forest.trips,
                             forest._cat_lut)
    raw = P._sum_leaf_values_f64(leaves, forest._leaf_f64, K)
    return {
        "copy_in": cuda_ms(lambda: torch.from_numpy(Xb).cuda(), reps=5),
        "quantize": cuda_ms(lambda: P._quantize_rows_impl(Xd, forest._qt),
                            reps=5),
        "walk": cuda_ms(lambda: P._walk_stacked(bins_t, forest._nodes,
                                                forest.trips,
                                                forest._cat_lut), reps=5),
        "sum_f64": cuda_ms(lambda: P._sum_leaf_values_f64(
            leaves, forest._leaf_f64, K), reps=5),
        "sum_kahan_f32": cuda_ms(lambda: P._raw_from_leaves(
            P.stacked_leaf_values(Xd, leaves, forest._nodes), K), reps=5),
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
    PHASE12["model"] = bst.model_to_string(num_iteration=REFIT_ITERATIONS)
    launches = {"phase12_binary_100_rounds": run["launches"]["histogram_f32"]}
    Xp, _ = make_higgs_like(PREDICT_ROWS, seed=1)
    n = PREDICT_ROWS

    # the host walk: raw scores, values, leaf ids
    host_raw, t_host = timed(lambda: bst.predict(
        Xp, raw_score=True, predict_on_device=False))
    # the host walk's values: its raw scores through the objective's
    # convert_output, as GBDT.predict computes them
    host_val = bst.inner.objective.convert_output(host_raw)
    # leaf ids on the first bucket (the raw scores of every row are held
    # byte-equal below)
    host_leaf = bst.predict(Xp[:1 << 16], pred_leaf=True,
                            predict_on_device=False)
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
    leaf = bst.predict(Xp[:1 << 16], pred_leaf=True)
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
        "pass, Kahan f32) %.0f rows/s (%.3f s); leaf ids equal (first "
        "65536 rows), value and raw byte-equal to the host walk (every "
        "row); raw_device from the f64 sum of "
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


# ---------------------------------------------------------------------------
# phase 14: row and column sampling and the per-node filters
# ---------------------------------------------------------------------------
# interaction constraint groups of phase 14d: the generator's one
# interaction term, sin(x0) * x1, lies inside the first group
HIGGS_GROUPS = [list(range(14)), list(range(14, 28))]
# phase 14e: CEGB vectors over the 28 columns. A split's gain is at most
# sum over its rows of g^2 / h (Cauchy-Schwarz), about one per row for
# the binary loss near p = 0.5, so ~1e7 at 10.5M rows: a coupled penalty
# of 1e9 on columns 20-27 keeps them out of every tree
CEGB_PARAMS = {"cegb_penalty_split": 1e-5,
               "cegb_penalty_feature_coupled": [100.0] * 20 + [1e9] * 8,
               "cegb_penalty_feature_lazy": [1e-3] * 28}


def _record_tree_masks():
    """Wrap the learner's ``train`` to keep each tree's feature mask as
    the learner copied it to the card (its host copy; no device read).
    Returns (masks, restore)."""
    from lightgbm_tpu_torch.treelearner import serial
    grow = serial.SerialTreeLearner.train
    masks = []

    def train(self, *args):
        out = grow(self, *args)
        masks.append(self._mask_host.copy())
        return out
    serial.SerialTreeLearner.train = train

    def restore():
        serial.SerialTreeLearner.train = grow
    return masks, restore


def kernels_per_replay(learner):
    """Device kernels (copies and fills apart) of one replay of the
    learner's captured step, by torch.profiler, and its ms (CUDA events,
    mean of 20 replays). The step after a tree's end launches every
    kernel of a split and changes nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    buf = learner._fused
    for _ in range(3):
        learner._graph.replay()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        learner._graph.replay()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda
               and not e.name.startswith(("Memcpy", "Memset"))]
    ms = cuda_ms(lambda: learner._graph.replay(), reps=20, warm=2)
    check(int(buf.state.step) <= learner.L - 1, "replays past the tree's "
          "end moved its step counter")
    return len(kernels), ms


def phase14_ff_extra_trees(lgb, hist_mod, data):
    """14a: feature_fraction 0.9 + extra_trees, 5 rounds, whole-tree
    loop."""
    import torch
    extra = {"feature_fraction": 0.9, "extra_trees": True}
    ds, valid, Xv, _ = data
    masks, restore = _record_tree_masks()
    try:
        run = train_path(lgb, hist_mod, ds, valid,
                         dict(SLICE_PARAMS, num_leaves=255, **extra),
                         "histogram_f32", 5, tag="14a ff + extra_trees")
    finally:
        restore()
    bst = run["booster"]
    learner = bst.inner.learner
    check(learner._fused_growth and learner.grow_stats["captures"] == 1,
          "14a did not train through the captured whole-tree step")
    check(len(masks) == 5 and all(m.sum() == round(28 * 0.9) for m in masks),
          "14a: expected 5 tree masks of %d features" % round(28 * 0.9))
    for t, m in zip(bst.inner.models, masks):
        used = t.split_feature_inner[:t.num_internal]
        check(bool(m[used].all()), "14a: a split feature lies outside its "
              "tree's mask")
    check(np.array_equal(learner.feature_mask.cpu().numpy(), masks[-1]),
          "14a: the learner's device mask is not the last tree's")
    a = check_predict(bst, data, run["evals"]["auc"])
    check_stacked(bst, Xv, "phase 14a ff + extra_trees")
    n_et, ms_et = kernels_per_replay(learner)
    # the same learner's step without the extra_trees draws
    learner._extra_trees = False
    learner._graph = None
    learner._capture(learner._fused)
    n_plain, ms_plain = kernels_per_replay(learner)
    log("14a ff 0.9 + extra_trees: held-out AUC %.6f; ms per split %.3f "
        "(phase 4 in this call: %s); one replayed step: %d kernels, %.3f "
        "ms; without the extra_trees draws: %d kernels, %.3f ms (the "
        "threefry draws: %+d kernels, %+.3f ms per split)"
        % (a, SPLIT_MS["14a ff + extra_trees"],
           "%.3f" % SPLIT_MS[PHASE4_TAG] if PHASE4_TAG in SPLIT_MS
           else "not run",
           n_et, ms_et, n_plain, ms_plain, n_et - n_plain,
           ms_et - ms_plain))
    check_rerun(lgb, hist_mod, data, extra, "histogram_f32", bst,
                "ff + extra_trees")
    del bst, learner
    torch.cuda.empty_cache()
    return run["launches"]["histogram_f32"]


def phase14_goss(lgb, hist_mod, data):
    """14b: GOSS at its default rates, lr 0.1, 13 rounds (warm-up 10, so
    trees 11-13 are GOSS trees); the draw on the card against the CPU's
    at all rows; top-k ms by torch.topk and torch.kthvalue."""
    import torch
    from lightgbm_tpu_torch.boosting import sample_strategy as SS
    from lightgbm_tpu_torch.utils.prng import PRNGKey
    extra = {"data_sample_strategy": "goss"}
    ds, valid, _, _ = data
    draw = SS.goss_draw
    draws = []

    def recorded(grad, hess, *args):
        out = draw(grad, hess, *args)
        # top rows: in bag and not scaled (the scale of a sampled row,
        # (n - top_k) / other_k = 8 here, changes every hessian > 0)
        draws.append(torch.stack([out[2].sum(), ((out[2] > 0)
                                                 & (out[1] == hess)).sum()]))
        return out
    SS.goss_draw = recorded
    try:
        run = train_path(lgb, hist_mod, ds, valid,
                         dict(SLICE_PARAMS, num_leaves=255, **extra),
                         "histogram_f32", 13, tag="14b goss")
    finally:
        SS.goss_draw = draw
    bst = run["booster"]
    strat = bst.inner.sample_strategy
    check(isinstance(strat, SS.GOSSStrategy) and strat.warmup == 10,
          "14b: GOSS strategy with warm-up 10 expected")
    n = FULL_ROWS
    in_bag = [int(sum(t.leaf_count[:t.num_leaves]))
              for t in bst.inner.models]
    check(all(v == n for v in in_bag[:10]) and len(draws) == 3,
          "14b: the 10 warm-up trees must take every row, then 3 draws")
    for v, (bag, top) in zip(in_bag[10:], torch.stack(draws).tolist()):
        # rows tied at the threshold are top rows too; each other row is
        # sampled with probability other_k / (n - top_k)
        want = strat.other_k * (n - top) / (n - strat.top_k)
        check(v == bag and top >= strat.top_k
              and abs(bag - top - want) <= 0.01 * strat.other_k,
              "14b: a GOSS tree's %d in-bag rows are not top %d (top_k "
              "%d) + %.0f sampled within 1%% of other_k %d"
              % (v, top, strat.top_k, want, strat.other_k))
    a = check_predict(bst, data, run["evals"]["auc"])
    # the draw on the card and on the CPU from the same gradients
    g, h = bst.inner.objective.get_gradients(bst.inner.train_score[:, 0])
    key = PRNGKey(int(bst.inner.config.bagging_seed) & 0x7FFFFFFF, "cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    card = SS.goss_draw(g, h, key, 12, strat.top_k, strat.other_k)
    end.record()
    torch.cuda.synchronize()
    draw_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() - before
    threads = torch.get_num_threads()
    torch.set_num_threads(max(threads, 8))
    t0 = time.perf_counter()
    cpu = SS.goss_draw(g.cpu(), h.cpu(), key.cpu(), 12, strat.top_k,
                       strat.other_k)
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    for name, x, y in zip(("grad", "hess", "bag"), card, cpu):
        check(torch.equal(x.cpu().view(torch.int32), y.view(torch.int32)),
              "14b: the GOSS %s on the card differs from the CPU's" % name)
    w = torch.abs(g * h)
    k = strat.top_k
    v_topk = torch.topk(w, k).values[-1]
    v_kth = torch.kthvalue(w, n - k + 1).values
    check(bool(v_topk == v_kth) and bool(v_topk == SS.goss_threshold(w, k)),
          "14b: topk and kthvalue disagree")
    topk_ms = cuda_ms(lambda: torch.topk(w, k).values[-1], reps=5)
    kth_ms = cuda_ms(lambda: torch.kthvalue(w, n - k + 1).values, reps=5)
    log("14b GOSS (top_rate 0.2, other_rate 0.1, lr 0.1, 13 rounds): "
        "in-bag rows per GOSS tree %s (top_k %d + other_k %d); held-out AUC "
        "%.6f; the draw at %d rows byte-equal on the card and the CPU "
        "(grad, hess, bag); draw %.3f ms on the card (CPU %.1f s), device "
        "memory it needs above its inputs %.3f GiB; the %d-th largest |g "
        "h| by torch.topk %.3f ms, by torch.kthvalue %.3f ms (the port's "
        "goss_threshold takes topk)"
        % (in_bag[10:], strat.top_k, strat.other_k, a, n, draw_ms, cpu_s,
           peak / 2 ** 30, k, topk_ms, kth_ms))
    del bst, card, cpu, g, h, w
    torch.cuda.empty_cache()
    return run["launches"]["histogram_f32"]


def phase14_goss_quantized(lgb, hist_mod, data):
    """14c: GOSS with 8-bit gradients, lr 0.5 (warm-up 2), 4 rounds:
    every histogram through the int8 instance; a 3-round per-split rerun
    (tree 3 a GOSS tree) is text-equal."""
    extra = {"data_sample_strategy": "goss", "learning_rate": 0.5,
             "use_quantized_grad": True, "quant_grad_bits": 8}
    bst, launches, aucs, _, _ = train_full(lgb, hist_mod, data, extra,
                                           "histogram_i8", rounds=4,
                                           tag="14c goss 8-bit")
    a = check_predict(bst, data, aucs)
    check_rerun(lgb, hist_mod, data, extra, "histogram_i8", bst,
                "GOSS 8-bit", rounds=3)
    log("14c GOSS + 8-bit (lr 0.5, 4 rounds, trees 3-4 GOSS): held-out "
        "AUC %.6f; ms per split %.3f" % (a, SPLIT_MS["14c goss 8-bit"]))
    return launches["histogram_i8"]


def _paths_in_one_group(tree, groups):
    def walk(node, path):
        if node < 0:
            return True
        p = path | {int(tree.split_feature[node])}
        return (any(p <= set(g) for g in groups)
                and walk(int(tree.left_child[node]), p)
                and walk(int(tree.right_child[node]), p))
    return tree.num_leaves == 1 or walk(0, frozenset())


def phase14_node_filters(lgb, hist_mod, data):
    """14d: feature_fraction_bynode 0.5 + interaction constraints (two
    groups of 14 columns), 2 rounds, through the per-split loop."""
    extra = {"feature_fraction_bynode": 0.5,
             "interaction_constraints": HIGGS_GROUPS}
    ds, valid, _, _ = data
    run = train_path(lgb, hist_mod, ds, valid,
                     dict(SLICE_PARAMS, num_leaves=255, **extra),
                     "histogram_f32", 2, tag="14d bynode + constraints")
    bst = run["booster"]
    check(all(_paths_in_one_group(t, HIGGS_GROUPS)
              for t in bst.inner.models),
          "14d: a root-to-leaf path mixes the constraint groups")
    reads = bst.inner.learner.grow_stats["split_reads"]
    a = check_predict(bst, data, run["evals"]["auc"])
    log("14d bynode 0.5 + interaction constraints: every path inside one "
        "group; %d record reads for %d splits; host syncs per tree %s; "
        "ms per split %.3f; held-out AUC %.6f"
        % (reads, run["splits"], run["tree_syncs"],
           SPLIT_MS["14d bynode + constraints"], a))
    return run["launches"]["histogram_f32"]


def _subtree_leaves(tree, node):
    if node < 0:
        return [~node]
    return (_subtree_leaves(tree, int(tree.left_child[node]))
            + _subtree_leaves(tree, int(tree.right_child[node])))


def phase14_cegb(lgb, hist_mod, data):
    """14e: CEGB (split, coupled and lazy penalties), 2 rounds, through
    the per-split loop; the lazy fetched state after tree 1 against the
    tree's own partition."""
    import torch
    from lightgbm_tpu_torch.treelearner import serial
    ds, valid, _, _ = data
    grow = serial.SerialTreeLearner.train
    after_tree1 = {}

    def train(self, *args):
        tree, leaf_of_row = grow(self, *args)
        if not after_tree1:
            after_tree1.update(tree=tree, leaf_of_row=leaf_of_row.clone(),
                               fetched=self._cegb_fetched.clone(),
                               used=self._cegb_used.clone())
        return tree, leaf_of_row
    serial.SerialTreeLearner.train = train
    try:
        run = train_path(lgb, hist_mod, ds, valid,
                         dict(SLICE_PARAMS, num_leaves=255, **CEGB_PARAMS),
                         "histogram_f32", 2, tag="14e cegb")
    finally:
        serial.SerialTreeLearner.train = grow
    bst = run["booster"]
    learner = bst.inner.learner
    reads = bst.inner.learner.grow_stats["split_reads"]
    used = {int(f) for t in bst.inner.models
            for f in t.split_feature[:t.num_internal]}
    check(not used & set(range(20, 28)),
          "14e: a column with coupled penalty 1e9 was split on: %s"
          % sorted(used & set(range(20, 28))))
    plain = train_path(lgb, hist_mod, ds, valid,
                       dict(SLICE_PARAMS, num_leaves=255), "histogram_f32",
                       2, tag="14e without penalties")["booster"]
    check([t.to_string() for t in plain.inner.models]
          != [t.to_string() for t in bst.inner.models],
          "14e: the CEGB trees equal the trees without penalties")
    # tree 1: row r has fetched feature f iff its leaf lies under a node
    # that splits on f; no other feature is fetched
    t1 = after_tree1["tree"]
    leaf_of_row = after_tree1["leaf_of_row"]
    fetched = after_tree1["fetched"]
    nodes = {}
    for node in range(t1.num_internal):
        nodes.setdefault(int(t1.split_feature_inner[node]), []).append(node)
    for f in range(learner.F):
        leaves = [lf for node in nodes.get(f, [])
                  for lf in _subtree_leaves(t1, node)]
        want = torch.isin(leaf_of_row, torch.tensor(
            sorted(set(leaves)), dtype=leaf_of_row.dtype, device="cuda"))
        check(torch.equal(fetched[:, f], want),
              "14e: fetched column %d after tree 1 is not the rows that "
              "passed a node on it" % f)
    check(torch.equal(after_tree1["used"][:learner.F].cpu(),
                      torch.tensor([f in nodes for f in range(learner.F)])),
          "14e: the used-feature vector after tree 1 is not tree 1's "
          "features")
    a = check_predict(bst, data, run["evals"]["auc"])
    log("14e CEGB: columns split on %s (20-27 never); trees differ from "
        "the run without penalties; fetched after tree 1 == the rows "
        "under each feature's nodes for all %d features; fetched state "
        "%d bytes (bool [%d, %d]); %d record reads for %d splits; ms per "
        "split %.3f (without penalties, whole-tree: %.3f); held-out AUC "
        "%.6f"
        % (sorted(used), learner.F, fetched.numel(), fetched.shape[0],
           fetched.shape[1], reads, run["splits"], SPLIT_MS["14e cegb"],
           SPLIT_MS["14e without penalties"], a))
    del bst, plain, after_tree1, fetched, learner
    torch.cuda.empty_cache()
    return run["launches"]["histogram_f32"]


def _split_trace(lgb, params, X, y):
    """Tree 1 of ``params`` with, for each split of the per-split loop in
    the order it was made, the winner (leaf, feature, threshold bin) and
    the candidate table it won from: every leaf's [gain, feature,
    threshold bin], read before the split."""
    from lightgbm_tpu_torch.ops import split as S
    from lightgbm_tpu_torch.treelearner import serial
    split = serial.SerialTreeLearner._split
    cols = [S.GAIN, S.FEATURE, S.THRESHOLD_BIN]
    trace = []

    def traced(self, state, rec, *args):
        trace.append(((rec.leaf, rec.feature, rec.threshold_bin),
                      state.cand[:, cols].cpu().numpy()))
        return split(self, state, rec, *args)
    serial.SerialTreeLearner._split = traced
    try:
        b = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=1)
    finally:
        serial.SerialTreeLearner._split = split
    return b.inner.models[0], trace


def _ulps(a, b) -> float:
    """|a - b| in f32 spacings at the larger magnitude."""
    return abs(float(a) - float(b)) / float(
        np.spacing(np.float32(max(abs(a), abs(b)))))


def phase14_node_filters_f32_order(lgb, X, y, base):
    """14d in f32, tree 1 on cuda against cpu, split by split. Node masks
    are drawn from one host RNG in the order the splits are made, so the
    trees agree as long as the split order does. Up to the first split
    where the winners differ, the winners must agree; at that split the
    candidate tables of both devices must hold the same candidate
    (feature, threshold) in every leaf -- the same masks and partitions
    -- and the two winners must be a near-tie: each device's gap
    between them no larger than the largest cross-device gain difference
    of one candidate in that table (the f32 rounding of the two
    devices' histograms)."""
    import torch
    extra = {"feature_fraction_bynode": 0.5,
             "interaction_constraints": HIGGS_GROUPS}
    threads = torch.get_num_threads()
    res = {}
    for dev in ("cuda", "cpu"):
        torch.set_num_threads(1 if dev == "cpu" else threads)
        res[dev] = _split_trace(lgb, dict(base, device_type=dev, **extra),
                                X, y)
    torch.set_num_threads(threads)
    (t_cuda, tr_cuda), (t_cpu, tr_cpu) = res["cuda"], res["cpu"]
    k = next((i for i, (u, v) in enumerate(zip(tr_cuda, tr_cpu))
              if u[0] != v[0]), None)
    if k is None:
        check(len(tr_cuda) == len(tr_cpu)
              and tree_structure(t_cuda) == tree_structure(t_cpu),
              "14d f32: the same split order, yet tree 1 differs between "
              "cuda and cpu")
        log("14d bynode + constraints, f32 at %d rows: tree 1 the same "
            "tree on cuda and cpu, %d splits in the same order"
            % (SMALL_ROWS, len(tr_cuda)))
        return
    (wa, ca), (wb, cb) = tr_cuda[k], tr_cpu[k]
    live = np.isfinite(ca[:, 0]) & np.isfinite(cb[:, 0])
    same_cands = (np.array_equal(np.isfinite(ca[:, 0]),
                                 np.isfinite(cb[:, 0]))
                  and np.array_equal(ca[live, 1:], cb[live, 1:]))
    diff = np.abs(ca[live, 0].astype(np.float64) - cb[live, 0])
    worst = int(np.flatnonzero(live)[int(np.argmax(diff))])
    rounding = float(diff.max())
    a, b = wa[0], wb[0]
    gap_cuda = float(ca[a, 0]) - float(ca[b, 0])
    gap_cpu = float(cb[b, 0]) - float(cb[a, 0])
    log("14d bynode + constraints, f32 at %d rows: splits 1-%d the same "
        "on cuda and cpu; split %d: cuda splits leaf %d (feature %d, bin "
        "%d), cpu leaf %d (feature %d, bin %d); gains on cuda %.9g vs "
        "%.9g (gap %.3g, %.1f ulp), on cpu %.9g vs %.9g (gap %.3g, %.1f "
        "ulp); the candidate tables hold the same (feature, bin) in "
        "every leaf: %s; largest cross-device gain difference of one "
        "candidate %.3g (%.1f ulp, leaf %d)"
        % (SMALL_ROWS, k, k + 1, a, wa[1], wa[2], b, wb[1], wb[2],
           ca[a, 0], ca[b, 0], gap_cuda, _ulps(ca[a, 0], ca[b, 0]),
           cb[b, 0], cb[a, 0], gap_cpu, _ulps(cb[a, 0], cb[b, 0]),
           same_cands, rounding, _ulps(ca[worst, 0], cb[worst, 0]),
           worst))
    check(same_cands, "14d f32: at split %d the candidate tables of cuda "
          "and cpu differ (masks or partitions differ)" % (k + 1))
    check(a != b and 0.0 <= gap_cuda <= rounding
          and 0.0 <= gap_cpu <= rounding,
          "14d f32: the first differing split %d is not a near-tie "
          "between two leaves" % (k + 1))


def phase14_cuda_vs_cpu(lgb):
    """Tree 1 on cuda and on cpu at phase 3's 200k rows, 63 leaves, for
    14a's, 14d's and 14e's settings and GOSS: the same tree (structure,
    as phase 11 compares). GOSS runs at learning_rate 2.0, whose warm-up
    int(1 / lr) is 0, so that tree 1 is a GOSS tree. 14d's node masks
    are drawn in the order the splits are made, so two leaves whose f32
    gains tie within rounding, split in the other order, re-deal every
    later mask: 14d's whole tree is compared with 8-bit gradients, whose
    integer histograms give both devices the same sums, and in f32 up to
    its first differing split (:func:`phase14_node_filters_f32_order`)."""
    import torch
    X, y = make_higgs_like(SMALL_ROWS, seed=7)
    base = dict(SLICE_PARAMS, num_leaves=63)
    cases = (("14a ff + extra_trees",
              {"feature_fraction": 0.9, "extra_trees": True}),
             ("14b GOSS", {"data_sample_strategy": "goss",
                           "learning_rate": 2.0}),
             ("14d bynode + constraints, 8-bit",
              {"feature_fraction_bynode": 0.5,
               "interaction_constraints": HIGGS_GROUPS,
               "use_quantized_grad": True, "quant_grad_bits": 8}),
             ("14e CEGB", CEGB_PARAMS))
    threads = torch.get_num_threads()
    for what, extra in cases:
        trees = {}
        for dev in ("cuda", "cpu"):
            torch.set_num_threads(1 if dev == "cpu" else threads)
            b = lgb.train(dict(base, device_type=dev, **extra),
                          lgb.Dataset(X, label=y), num_boost_round=1)
            trees[dev] = b.inner.models[0]
        torch.set_num_threads(threads)
        check(tree_structure(trees["cuda"]) == tree_structure(trees["cpu"]),
              "%s: tree 1 differs between cuda and cpu: first splits "
              "(leaves, features, thresholds) %s against %s"
              % (what, [v[:12] if isinstance(v, list) else v
                        for v in tree_splits_of(trees["cuda"])],
                 [v[:12] if isinstance(v, list) else v
                  for v in tree_splits_of(trees["cpu"])]))
        log("%s at %d rows: tree 1 the same tree on cuda and cpu (%s, %d "
            "leaves)" % (what, SMALL_ROWS,
                         "splits in the same order"
                         if tree_splits_of(trees["cuda"])
                         == tree_splits_of(trees["cpu"])
                         else "the same splits, added in another order",
                         trees["cuda"].num_leaves))
    phase14_node_filters_f32_order(lgb, X, y, base)


def phase_sampling(lgb, hist_mod, data):
    """Phase 14: returns the launches of each run by kernel and path."""
    runs = {"histogram_f32": {}, "histogram_i8": {}}
    f32 = runs["histogram_f32"]
    f32["phase14a_higgs_ff_extra_trees"] = phase14_ff_extra_trees(
        lgb, hist_mod, data)
    f32["phase14b_higgs_goss"] = phase14_goss(lgb, hist_mod, data)
    runs["histogram_i8"]["phase14c_higgs_goss_8bit"] = \
        phase14_goss_quantized(lgb, hist_mod, data)
    f32["phase14d_higgs_bynode_constraints"] = phase14_node_filters(
        lgb, hist_mod, data)
    f32["phase14e_higgs_cegb"] = phase14_cegb(lgb, hist_mod, data)
    phase14_cuda_vs_cpu(lgb)
    return runs


# ---------------------------------------------------------------------------
# phase 15: monotone constraints, forced splits, linear trees
# ---------------------------------------------------------------------------
def higgs_constraints(rows: int = 100_000):
    """+1 on the 4 columns most positively correlated with the label in
    the first ``rows`` training rows, -1 on the 2 most negative."""
    X = HEAD["X"][:rows].astype(np.float64)
    y = HEAD["y"][:rows]
    corr = np.array([np.corrcoef(X[:, j], y)[0, 1]
                     for j in range(X.shape[1])])
    order = np.argsort(corr)
    mc = [0] * X.shape[1]
    for j in order[-4:]:
        mc[int(j)] = 1
    for j in order[:2]:
        mc[int(j)] = -1
    check(all(corr[j] > 0 for j in order[-4:])
          and all(corr[j] < 0 for j in order[:2]),
          "15: the constrained columns' correlations have the wrong sign")
    log("15 constraints: +1 on columns %s (corr %s), -1 on %s (corr %s)"
        % ([int(j) for j in order[-4:]],
           " ".join("%.4f" % corr[j] for j in order[-4:]),
           [int(j) for j in order[:2]],
           " ".join("%.4f" % corr[j] for j in order[:2])))
    return mc


def constrained(lgb, data, mc):
    """Phase 4's training rows and held-out set as Datasets with the
    monotone constraints ``mc``, built through the Dataset entry point
    (the 10.5M training rows are binned again)."""
    _, _, Xv, yv = data
    t0 = time.perf_counter()
    dsm = lgb.Dataset(HEAD["Xt"], label=HEAD["yt"],
                      params=dict(SLICE_PARAMS,
                                  monotone_constraints=mc)).construct()
    vm = lgb.Dataset(Xv, label=yv, reference=dsm).construct()
    log("15a-c: the training rows binned again with monotone_constraints "
        "in %.3f s" % (time.perf_counter() - t0))
    return dsm, vm


def check_monotone_grid(bst, Xv, mc, what, rows=1000, points=64):
    """Raw predictions (stacked path) of ``rows`` held-out rows with each
    constrained column set to a 64-point grid over its 1-99% range must
    be monotone in the constraint's direction, exactly."""
    X = Xv[:rows]
    worst = {}
    for j, sign in enumerate(mc):
        if not sign:
            continue
        lo, hi = np.percentile(X[:, j], [1, 99])
        grid = np.linspace(lo, hi, points).astype(np.float32)
        Xg = np.repeat(X[None], points, axis=0)
        Xg[:, :, j] = grid[:, None]
        pred = bst.predict(Xg.reshape(-1, X.shape[1]), raw_score=True)
        d = np.diff(pred.reshape(points, rows), axis=0) * sign
        worst[j] = float(d.min())
        check(worst[j] >= 0.0, "%s: predictions fall along column %d "
              "against its +%d constraint (step %.3g)"
              % (what, j, sign, worst[j]))
    pred = stacked_predictor(bst)
    check(pred is not None and sum(pred.entries.values()) > 0,
          "%s: the grid did not go through the stacked path" % what)
    log("%s: predictions monotone on %d held-out rows x %d grid points in "
        "each constrained column (stacked path; smallest step along the "
        "constraint per column: %s)"
        % (what, rows, points, " ".join("%d: %.3g" % kv
                                         for kv in worst.items())))


def rerun_equal(lgb, hist_mod, ds, valid, params, kernel, bst, what,
                rounds=RERUN_ROUNDS):
    """A per-split run of ``rounds`` rounds must give ``bst``'s first
    trees, text for text."""
    again = train_path(lgb, hist_mod, ds, valid,
                       dict(params, tpu_fused_tree=False), kernel, rounds,
                       tag="%s per-split rerun" % what)["booster"]
    first = [t.to_string() for t in bst.inner.models[:rounds]]
    check(first == [t.to_string() for t in again.inner.models],
          "%s: the per-split rerun gave other trees" % what)
    log("%s per-split rerun (%d rounds): text-equal to the whole-tree "
        "run's first %d trees" % (what, rounds, rounds))


def phase15_basic(lgb, hist_mod, data, mc):
    """15a: basic monotone, 5 rounds through the captured whole-tree
    step; returns the constrained (train, valid) Datasets, the launches
    and the held-out AUC per round."""
    _, _, Xv, _ = data
    dsm, valid = constrained(lgb, data, mc)
    params = dict(SLICE_PARAMS, num_leaves=255, monotone_constraints=mc)
    tag = "15a basic monotone"
    run = train_path(lgb, hist_mod, dsm, valid, params, "histogram_f32", 5,
                     tag=tag)
    bst = run["booster"]
    learner = bst.inner.learner
    check(learner._has_mono and run["fused"]
          and learner.grow_stats["captures"] == 1,
          "15a did not train through the captured whole-tree step")
    a = check_predict(bst, data, run["evals"]["auc"])
    check_monotone_grid(bst, Xv, mc, "15a")
    log("15a basic monotone: s per iteration %s; ms per split %.3f "
        "(phase 4 in this call: %s); host syncs per tree %s; held-out "
        "AUC %.6f"
        % (" ".join("%.3f" % v for v in run["per_iter"]), SPLIT_MS[tag],
           "%.3f" % SPLIT_MS[PHASE4_TAG] if PHASE4_TAG in SPLIT_MS
           else "not run", run["tree_syncs"], a))
    rerun_equal(lgb, hist_mod, dsm, valid, params, "histogram_f32", bst,
                "15a basic monotone")
    del bst, learner
    return (dsm, valid), run["launches"]["histogram_f32"], \
        run["evals"]["auc"]


def phase15_methods(lgb, hist_mod, data, sets, mc, basic_aucs):
    """15b: the intermediate method, 2 rounds, and the advanced method,
    1 round at ``CUT_LEAVES`` leaves beside a basic round at as many (~80
    s a tree at 255 leaves), on the constrained ``sets``."""
    Xv = data[2]
    dsm, valid = sets
    out = {}
    for method, rounds, leaves in (("intermediate", 2, 255),
                                   ("advanced", 1, CUT_LEAVES)):
        tag = "15b %s" % method
        basic_auc = basic_aucs[rounds - 1]
        if leaves != 255:
            base = train_path(lgb, hist_mod, dsm, valid,
                              dict(SLICE_PARAMS, num_leaves=leaves,
                                   monotone_constraints=mc),
                              "histogram_f32", rounds,
                              tag="15b basic, %d leaves" % leaves)
            basic_auc = base["evals"]["auc"][rounds - 1]
            out["phase15b_higgs_basic_%d_leaves" % leaves] = \
                base["launches"]["histogram_f32"]
            del base
        run = train_path(lgb, hist_mod, dsm, valid,
                         dict(SLICE_PARAMS, num_leaves=leaves,
                              monotone_constraints=mc,
                              monotone_constraints_method=method),
                         "histogram_f32", rounds, tag=tag)
        bst = run["booster"]
        learner = bst.inner.learner
        stats = learner.grow_stats
        check(learner._mono_tracker is not None and not run["fused"],
              "%s did not take the host-tracked per-split loop" % tag)
        a = check_predict(bst, data, run["evals"]["auc"])
        check(a >= basic_auc - 0.002, "%s: held-out AUC %.6f below basic's "
              "%.6f - 0.002 after %d rounds" % (tag, a, basic_auc, rounds))
        check_monotone_grid(bst, Xv, mc, tag)
        splits = run["splits"]
        log("%s, %d leaves: ms per split %.3f (tree seconds / splits); "
            "host syncs per split %.2f (%s per tree); record reads per "
            "split %.2f; rescans per tree %.1f; held-out AUC %.6f (basic "
            "after %d rounds at as many leaves %.6f)"
            % (tag, leaves, SPLIT_MS[tag], sum(run["tree_syncs"]) / splits,
               run["tree_syncs"], stats["split_reads"] / splits,
               stats["rescans"] / len(bst.inner.models), a, rounds,
               basic_auc))
        out["phase15b_higgs_%s" % method] = run["launches"]["histogram_f32"]
        del bst, learner
    return out


def _shallow_features(tree, depth: int):
    """The split columns of the nodes at depth <= ``depth``."""
    out, frontier = [], [0] if tree.num_leaves > 1 else []
    for _ in range(depth + 1):
        nxt = []
        for node in frontier:
            out.append(int(tree.split_feature[node]))
            nxt += [int(c) for c in (tree.left_child[node],
                                     tree.right_child[node]) if c >= 0]
        frontier = nxt
    return out


def phase15_penalty(lgb, hist_mod, data, sets, mc):
    """15c: monotone_penalty 2.0 with the basic method, 2 rounds: no
    constrained column splits at depth 0 or 1."""
    dsm, valid = sets
    run = train_path(lgb, hist_mod, dsm, valid,
                     dict(SLICE_PARAMS, num_leaves=255,
                          monotone_constraints=mc, monotone_penalty=2.0),
                     "histogram_f32", 2, tag="15c monotone_penalty 2.0")
    shallow = [_shallow_features(t, 1) for t in run["booster"].inner.models]
    check(all(mc[f] == 0 for fs in shallow for f in fs),
          "15c: a constrained column splits at depth 0 or 1: %s" % shallow)
    log("15c monotone_penalty 2.0: the columns split at depths 0-1 of each "
        "tree: %s (none constrained)" % shallow)
    return run["launches"]["histogram_f32"]


def forced_spec():
    """Three forced nodes: the root on column 0 and its children on
    columns 1 and 2, each at the column's median in the head rows."""
    med = np.median(HEAD["X"][:100_000, :3], axis=0)
    return {"feature": 0, "threshold": float(med[0]),
            "left": {"feature": 1, "threshold": float(med[1])},
            "right": {"feature": 2, "threshold": float(med[2])}}


def phase15_forced(lgb, hist_mod, data, path):
    """15d: forced splits, 3 rounds in f32 and in 8-bit through the
    whole-tree loop; every tree starts with the three forced nodes, and
    1-round per-split reruns are text-equal."""
    ds, valid, _, _ = data
    spec = forced_spec()
    out = {}
    for bits, kernel in (("f32", "histogram_f32"), ("8-bit",
                                                     "histogram_i8")):
        extra = {"forcedsplits_filename": path}
        if bits == "8-bit":
            extra.update(use_quantized_grad=True, quant_grad_bits=8)
        params = dict(SLICE_PARAMS, num_leaves=255, **extra)
        tag = "15d forced %s" % bits
        run = train_path(lgb, hist_mod, ds, valid, params, kernel, 3,
                         tag=tag)
        bst = run["booster"]
        stats = bst.inner.learner.grow_stats
        check(run["fused"] and stats["forced_reads"] == 9,
              "%s: expected the whole-tree loop and 3 forced reads per "
              "tree, got %d reads" % (tag, stats["forced_reads"]))
        mappers = bst.inner.train_data.bin_mappers
        want = [(n["feature"], int(mappers[n["feature"]].value_to_bin(
            np.asarray([n["threshold"]]))[0]))
            for n in (spec, spec["left"], spec["right"])]
        for t in bst.inner.models:
            got = [(int(t.split_feature[i]), int(t.threshold_in_bin[i]))
                   for i in range(3)]
            check(got == want and not t.split_gain[:3].any(),
                  "%s: a tree's first nodes %s are not the forced %s"
                  % (tag, got, want))
        log("%s: every tree's first three nodes are the forced (column, "
            "bin) %s, gain 0; s per iteration %s; ms per split %.3f; "
            "held-out AUC %.6f"
            % (tag, want, " ".join("%.3f" % v for v in run["per_iter"]),
               SPLIT_MS[tag], run["evals"]["auc"][-1]))
        rerun_equal(lgb, hist_mod, ds, valid, params, kernel, bst, tag)
        out[kernel] = run["launches"][kernel]
        del bst
    return out


def linear_f32_bound(trees, X, leaves):
    """[n] bound on |f32 raw_device - f64 host walk| of a linear forest,
    from the host's trees: a leaf with k fitted features gives ``const +
    sum(coeff * x)`` in f32 within (k + 3) f32 ulp of ``m = |const| +
    sum |coeff * x|`` (the constant's and each coefficient's rounding to
    f32, each product, the sum), and the Kahan sum over trees adds 2 ulp
    of each term; so eps32 * sum over trees of (k + 5) * m, with m =
    |leaf_value| at a leaf without a fit or a row with NaN in one of its
    features. ``leaves`` [n, T] are the host walk's leaf ids."""
    X = np.asarray(X, dtype=np.float64)
    out = np.zeros(X.shape[0])
    for t, tree in enumerate(trees):
        nl = tree.num_leaves
        coeff = np.zeros((nl, X.shape[1]))
        used = np.zeros((nl, X.shape[1]), dtype=bool)
        for lf in range(nl):
            feats = tree.leaf_features[lf]
            coeff[lf, feats] = tree.leaf_coeff[lf]
            used[lf, feats] = True
        k = used.sum(axis=1)
        lf = leaves[:, t]
        u = used[lf]
        terms = np.where(u, np.abs(coeff[lf] * X), 0.0)
        lin = np.abs(np.asarray(tree.leaf_const[:nl]))[lf] + terms.sum(1)
        plain = (k[lf] == 0) | (np.isnan(X) & u).any(axis=1)
        m = np.where(plain, np.abs(tree.leaf_value[:nl])[lf], lin)
        out += (k[lf] + 5) * m
    return np.finfo(np.float32).eps * out


def phase15_linear(lgb, hist_mod, data):
    """15e: linear trees (linear_lambda 0.1), 3 rounds on the first
    LINEAR_ROWS training rows."""
    import torch
    from lightgbm_tpu_torch.boosting import gbdt as G
    _, _, Xv, yv = data
    params = dict(SLICE_PARAMS, num_leaves=255, linear_tree=True,
                  linear_lambda=0.1)
    t0 = time.perf_counter()
    dsl = lgb.Dataset(HEAD["X"], label=HEAD["y"], params=params).construct()
    vl = lgb.Dataset(Xv, label=yv, reference=dsl, params=params).construct()
    log("15e linear trees: depth cut to the first %d of the %d training "
        "rows (a Dataset that keeps raw rows bins them again); binning "
        "seconds %.3f" % (LINEAR_ROWS, FULL_ROWS,
                          time.perf_counter() - t0))
    fit = G.fit_linear_leaves
    fit_ms = []

    def timed_fit(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fit(*args, **kwargs)
        torch.cuda.synchronize()
        fit_ms.append(1e3 * (time.perf_counter() - t))
    G.fit_linear_leaves = timed_fit
    try:
        run = train_path(lgb, hist_mod, dsl, vl, params, "histogram_f32", 3,
                         tag="15e linear")
    finally:
        G.fit_linear_leaves = fit
    bst = run["booster"]
    trees = bst.inner.models
    fitted = [sum(bool(f) for f in t.leaf_features[:t.num_leaves])
              for t in trees]
    check(all(t.is_linear for t in trees) and min(fitted) > 0,
          "15e: trees without linear leaves (%s)" % fitted)
    a = check_predict(bst, data, run["evals"]["auc"])
    Xs = Xv[:100_000]
    check_stacked(bst, Xs, "15e linear")
    forest = stacked_predictor(bst).forest
    raw32 = forest.predict_raw_device(Xs)[:, 0].double().cpu().numpy()
    vals = forest.tree_values_device(Xs).double().cpu().numpy()
    bound = 2 * np.finfo(np.float32).eps * np.abs(vals).sum(axis=0)
    err = np.abs(raw32 - vals.sum(axis=0))
    check(bool(np.all(err <= bound)), "15e: raw_device off the f64 sum of "
          "its f32 terms by %.3g, Kahan's bound %.3g"
          % (float(err.max()), float(bound.max())))
    # the card's f32 linear leaves against the host's f64 walk, which
    # shares none of their code
    host = bst.predict(Xs, raw_score=True, predict_on_device=False)
    host_bound = linear_f32_bound(trees, Xs, bst.predict(
        Xs, pred_leaf=True, predict_on_device=False))
    host_err = np.abs(raw32 - host)
    check(bool(np.all(host_err <= host_bound)), "15e: raw_device off the "
          "host f64 walk by %.3g where its f32 rounding bound is %.3g"
          % (float(host_err.max()),
             float(host_bound[int(np.argmax(host_err))])))
    text = bst.model_to_string()
    again = lgb.Booster(model_str=text, params={"device_type": "cpu"})

    def trees_of(s):
        return s[s.index("Tree=0"):s.index("end of trees")]
    check(trees_of(again.model_to_string()) == trees_of(text)
          and np.array_equal(again.predict(Xs[:4096],
                                           predict_on_device=False),
                             bst.predict(Xs[:4096],
                                         predict_on_device=False)),
          "15e: the linear model text does not round-trip")
    log("15e linear: fit ms per tree %s; fitted leaves per tree %s; s per "
        "iteration %s; ms per split %.3f; held-out AUC %.6f; raw_device "
        "within Kahan's bound of its own terms (max err %.3g, bound at that "
        "row %.3g) and within the f32 rounding bound of the host f64 walk "
        "(max err %.3g, bound at that row %.3g); the text round-trips"
        % (" ".join("%.3f" % v for v in fit_ms), fitted,
           " ".join("%.3f" % v for v in run["per_iter"]),
           SPLIT_MS["15e linear"], a, float(err.max()),
           float(bound[int(np.argmax(err))]), float(host_err.max()),
           float(host_bound[int(np.argmax(host_err))])))
    del bst, dsl, vl
    torch.cuda.empty_cache()
    return run["launches"]["histogram_f32"]


def phase15_cuda_vs_cpu(lgb, mc, path):
    """Tree 1 on cuda and on cpu at phase 3's 200k rows (63 leaves):
    basic monotone (f32), intermediate (8-bit), forced (f32) and linear
    (f32) must be the same tree; the linear fit of the card's tree 1,
    run again on the CPU from the same inputs, gives its coefficients
    within rtol 1e-9."""
    import copy
    import torch
    from lightgbm_tpu_torch.boosting import gbdt as G
    X, y = make_higgs_like(SMALL_ROWS, seed=7)
    base = dict(SLICE_PARAMS, num_leaves=63)
    cases = (("15 basic monotone, f32", {"monotone_constraints": mc}),
             ("15 intermediate, 8-bit",
              {"monotone_constraints": mc,
               "monotone_constraints_method": "intermediate",
               "use_quantized_grad": True, "quant_grad_bits": 8}),
             ("15 forced, f32", {"forcedsplits_filename": path}),
             ("15 linear, f32", {"linear_tree": True, "linear_lambda": 0.1}))
    fit = G.fit_linear_leaves
    captured = []

    def capture(tree, *args):
        before = copy.deepcopy(tree)
        fit(tree, *args)
        captured.append((before, args, copy.deepcopy(tree)))
    threads = torch.get_num_threads()
    for what, extra in cases:
        trees = {}
        for dev in ("cuda", "cpu"):
            torch.set_num_threads(1 if dev == "cpu" else threads)
            G.fit_linear_leaves = capture if dev == "cuda" else fit
            try:
                b = lgb.train(dict(base, device_type=dev, **extra),
                              lgb.Dataset(X, label=y), num_boost_round=1)
            finally:
                G.fit_linear_leaves = fit
            trees[dev] = b.inner.models[0]
        torch.set_num_threads(threads)
        check(tree_structure(trees["cuda"]) == tree_structure(trees["cpu"]),
              "%s: tree 1 differs between cuda and cpu: first splits %s "
              "against %s"
              % (what, [v[:12] if isinstance(v, list) else v
                        for v in tree_splits_of(trees["cuda"])],
                 [v[:12] if isinstance(v, list) else v
                  for v in tree_splits_of(trees["cpu"])]))
        note = ""
        if "linear_tree" in extra:
            tree, args, card = captured[-1]
            fit(tree, *[a.cpu() if isinstance(a, torch.Tensor) else a
                        for a in args])
            nl = card.num_leaves
            check(tree.leaf_features[:nl] == card.leaf_features[:nl]
                  and any(card.leaf_features[:nl]),
                  "%s: the CPU refit chose other leaf features" % what)
            rel = max(float(np.max(np.abs(np.subtract(a, b))
                                   / np.maximum(np.abs(a), 1e-300)))
                      for a, b in zip(tree.leaf_coeff[:nl],
                                      card.leaf_coeff[:nl]) if a)
            check(rel <= 1e-9, "%s: the card's fit differs from the CPU's "
                  "on the same inputs by rtol %.3g" % (what, rel))
            cpu_rel = max(float(np.max(np.abs(np.subtract(a, b))
                                       / np.maximum(np.abs(a), 1e-300)))
                          for a, b in zip(trees["cpu"].leaf_coeff[:nl],
                                          trees["cuda"].leaf_coeff[:nl])
                          if a)
            note = ("; coefficients: the card's fit against the CPU's on "
                    "the same inputs rtol %.3g, against the CPU run's "
                    "own tree rtol %.3g" % (rel, cpu_rel))
        log("%s at %d rows: tree 1 the same tree on cuda and cpu (%s, %d "
            "leaves)%s" % (what, SMALL_ROWS,
                           "splits in the same order"
                           if tree_splits_of(trees["cuda"])
                           == tree_splits_of(trees["cpu"])
                           else "the same splits, added in another order",
                           trees["cuda"].num_leaves, note))


def phase_constraints(lgb, hist_mod, data):
    """Phase 15: returns the launches of each run by kernel and path."""
    import tempfile
    import torch
    runs = {"histogram_f32": {}, "histogram_i8": {}}
    f32 = runs["histogram_f32"]
    mc = higgs_constraints()
    sets, f32["phase15a_higgs_monotone_basic"], aucs = phase15_basic(
        lgb, hist_mod, data, mc)
    f32.update(phase15_methods(lgb, hist_mod, data, sets, mc, aucs))
    f32["phase15c_higgs_monotone_penalty"] = phase15_penalty(
        lgb, hist_mod, data, sets, mc)
    del sets
    HEAD.pop("Xt")
    HEAD.pop("yt")
    torch.cuda.empty_cache()
    fd, path = tempfile.mkstemp(suffix=".json")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(forced_spec(), fh)
        forced = phase15_forced(lgb, hist_mod, data, path)
        f32["phase15d_higgs_forced"] = forced["histogram_f32"]
        runs["histogram_i8"]["phase15d_higgs_forced_8bit"] = \
            forced["histogram_i8"]
        f32["phase15e_higgs_linear"] = phase15_linear(lgb, hist_mod, data)
        phase15_cuda_vs_cpu(lgb, mc, path)
    finally:
        os.remove(path)
    return runs


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


# ---------------------------------------------------------------------------
# phase 16: wide bins (max_bin 1023: uint16 bins, B = 1024)
# ---------------------------------------------------------------------------
WIDE_MAX_BIN = 1023
#: phase 12's model text (its first REFIT_ITERATIONS iterations),
#: refit in phase 18
PHASE12 = {}
REFIT_ITERATIONS = 20


def wide_data(lgb, data):
    """Phase 4's 10.5M training rows binned again at max_bin 1023 (uint16
    bins), and the held-out rows aligned to them."""
    _, _, Xv, yv = data
    t0 = time.perf_counter()
    ds = lgb.Dataset(HEAD["Xt"], label=HEAD["yt"],
                     params=dict(SLICE_PARAMS,
                                 max_bin=WIDE_MAX_BIN)).construct()
    valid = lgb.Dataset(Xv, label=yv, reference=ds).construct()
    h = ds.handle
    nb = h.num_bin_per_feature
    check(h.bins.dtype == np.uint16 and h.max_num_bin > 256,
          "max_bin %d binned to %s with at most %d bins"
          % (WIDE_MAX_BIN, h.bins.dtype, h.max_num_bin))
    log("phase 16 binning seconds at max_bin %d: %.3f; bins per feature "
        "%d-%d (uint16 matrix, %d MB)"
        % (WIDE_MAX_BIN, time.perf_counter() - t0, int(nb.min()),
           int(nb.max()), h.bins.nbytes >> 20))
    return ds, valid, Xv, yv


def phase_wide(lgb, hist_mod, data, errs, rows):
    """Training at max_bin 1023 on phase 4's rows: f32 for 5 rounds (held-
    out AUC > 0.7 and equal to the device scores', stacked predict ==
    host walk, a 2-round per-split rerun text-equal), 8-bit for 3 rounds
    and 16-bit for 2 (each a 1-round per-split rerun text-equal), each
    through its uint16 instance only (device launches == roots + steps);
    ms per split and syncs per tree beside phase 4's; tree 1 at 200k
    rows the same on cuda and cpu in f32, 8-bit and 16-bit; then the
    uint16 instances timed over the learner's own bins (appended to
    ``rows`` when phase 5 made them). Returns (launches by kernel and
    path, the binned data)."""
    import torch
    wdata = wide_data(lgb, data)
    extra = {"max_bin": WIDE_MAX_BIN}
    tag = "phase 16 max_bin 1023 f32"
    bst, launches, aucs, _, _ = train_full(lgb, hist_mod, wdata, extra,
                                           "histogram_u16_f32", tag=tag)
    learner = bst.inner.learner
    check(learner.bins.dtype == torch.uint16 and learner.B == 1024,
          "phase 16: the learner holds %s bins at B = %d"
          % (learner.bins.dtype, learner.B))
    a = check_predict(bst, wdata, aucs)
    check_stacked(bst, wdata[2][:100_000], "phase 16 max_bin 1023")
    check_rerun(lgb, hist_mod, wdata, extra, "histogram_u16_f32", bst,
                "max_bin 1023 f32", rounds=2)
    by_path = {"histogram_u16_f32": {
        "phase16_higgs_max_bin_1023": launches["histogram_u16_f32"]}}
    log("phase 16 against phase 4 in this call: ms per split %.3f at "
        "max_bin 1023 (B = 1024, uint16) vs %s at max_bin 255; held-out "
        "AUC %.6f"
        % (SPLIT_MS[tag], "%.3f" % SPLIT_MS[PHASE4_TAG]
           if PHASE4_TAG in SPLIT_MS else "not run", a))
    bins = learner.bins
    del bst, learner
    qtag = "phase 16 max_bin 1023 8-bit"
    q8 = dict(extra, use_quantized_grad=True)
    q, qlaunch, qaucs, _, _ = train_full(
        lgb, hist_mod, wdata, q8, "histogram_u16_i8", rounds=3, tag=qtag)
    check_predict(q, wdata, qaucs)
    check_rerun(lgb, hist_mod, wdata, q8, "histogram_u16_i8", q,
                "max_bin 1023 8-bit")
    by_path["histogram_u16_i8"] = {
        "phase16_higgs_max_bin_1023_8bit": qlaunch["histogram_u16_i8"]}
    del q
    q16p = dict(q8, quant_grad_bits=16)
    q16, q16launch, _, _, _ = train_full(
        lgb, hist_mod, wdata, q16p, "histogram_u16_i16", rounds=2,
        tag="phase 16 max_bin 1023 16-bit")
    check_rerun(lgb, hist_mod, wdata, q16p, "histogram_u16_i16", q16,
                "max_bin 1023 16-bit")
    by_path["histogram_u16_i16"] = {
        "phase16_higgs_max_bin_1023_16bit": q16launch["histogram_u16_i16"]}
    del q16
    small = phase_small(lgb, hist_mod, extra, "histogram_u16_f32", None,
                        rounds=1)
    by_path["histogram_u16_f32"]["phase16_small_max_bin_1023"] = \
        small["histogram_u16_f32"]
    for p, kernel, tag in ((q8, "histogram_u16_i8", "8bit"),
                           (q16p, "histogram_u16_i16", "16bit")):
        small = phase_small(lgb, hist_mod, p, kernel, None, rounds=1)
        by_path[kernel]["phase16_small_max_bin_1023_" + tag] = \
            small[kernel]
    if rows is not None:
        S = bins.shape[0]
        g = torch.Generator(device="cuda")
        g.manual_seed(16)
        gh = torch.stack([torch.randn(S, generator=g, device="cuda"),
                          torch.rand(S, generator=g, device="cuda"),
                          torch.ones(S, device="cuda"),
                          torch.ones(S, device="cuda")], dim=1).contiguous()
        gh8 = torch.randint(-127, 128, (S, 4), generator=g, device="cuda",
                            dtype=torch.int32).to(torch.int8)
        q = (2 ** 31 - 1) // S
        gh16 = torch.randint(-q, q + 1, (S, 4), generator=g, device="cuda",
                             dtype=torch.int32).to(torch.int16)
        errs["histogram_u16_f32"] = max(
            errs["histogram_u16_f32"], compare_f32(hist_mod, bins, gh, 1024,
                                                   None))
        errs["histogram_u16_f64"] = max(
            errs["histogram_u16_f64"],
            compare_f64(hist_mod, bins, gh, 1024, None)[0])
        compare_int(hist_mod, bins, gh8, 1024, None)
        compare_int(hist_mod, bins, gh16, 1024, None)
        rows.extend(time_instances(hist_mod, bins, 1024, gh, gh8, gh16,
                                   errs, "u16_"))
        del gh, gh8, gh16
    del bins
    return by_path, wdata


# ---------------------------------------------------------------------------
# phase 17: f64 histograms
# ---------------------------------------------------------------------------
def phase_f64(lgb, hist_mod, data, wdata):
    """f64 histogram sums (``tpu_use_f64_hist``) on phase 4's Dataset (3
    rounds, uint8 bins) and phase 16's (2 rounds, uint16 bins): every
    histogram through the f64 instance of the bins' dtype, held-out AUC
    > 0.7 and equal to the device scores'. Returns the launches by
    kernel and path."""
    f64 = {"tpu_use_f64_hist": True}
    bst, launches, aucs, _, _ = train_full(lgb, hist_mod, data, f64,
                                           "histogram_f64", rounds=3,
                                           tag="phase 17 f64 sums")
    a = check_predict(bst, data, aucs)
    by_path = {"histogram_f64": {
        "phase17_higgs_f64": launches["histogram_f64"]}}
    del bst
    out = {}
    if wdata is not None:
        wb, wl, waucs, _, _ = train_full(
            lgb, hist_mod, wdata, dict(f64, max_bin=WIDE_MAX_BIN),
            "histogram_u16_f64", rounds=2,
            tag="phase 17 f64 sums max_bin 1023")
        out["wide"] = check_predict(wb, wdata, waucs)
        by_path["histogram_u16_f64"] = {
            "phase17_higgs_max_bin_1023_f64": wl["histogram_u16_f64"]}
        del wb
    log("phase 17 f64 sums: held-out AUC %.6f after 3 rounds (uint8 bins)"
        "%s; ms per split %.3f against phase 4's f32 %s in this call"
        % (a, "; %.6f after 2 rounds at max_bin 1023" % out["wide"]
           if out else "", SPLIT_MS["phase 17 f64 sums"],
           "%.3f" % SPLIT_MS[PHASE4_TAG] if PHASE4_TAG in SPLIT_MS
           else "not run"))
    return by_path


def phase_f64_covertype(lgb, hist_mod):
    """Phase 9's Covertype rows bundled (EFB at its default) and
    unbundled, 2 rounds each with f64 histogram sums: the gap between
    their predictions against the reference's contract for bundles
    (rtol 1e-4; phase 9 logs the f32 gap). A finding: the run reports
    whether the f64 pair holds it and fails only on the launches.
    Returns the f64 launches by path."""
    t0 = time.perf_counter()
    X, y = make_covertype_like(COVERTYPE_ROWS + COVERTYPE_HELD_OUT, seed=9)
    Xt, yt = X[:COVERTYPE_ROWS], y[:COVERTYPE_ROWS]
    Xv, yv = X[COVERTYPE_ROWS:], y[COVERTYPE_ROWS:]
    params = {"objective": "multiclass", "num_class": 7, "num_leaves": 255,
              "learning_rate": 0.1, "max_bin": 255,
              "metric": "multi_logloss,multi_error", "verbosity": -1,
              "tpu_use_f64_hist": True}
    runs = {}
    for bundled in (True, False):
        p = dict(params, enable_bundle=bundled)
        ds, valid = covertype_splits(Xt, yt, Xv, yv, lgb, p)
        run = train_path(lgb, hist_mod, ds, valid, p, "histogram_f64", 2,
                         tag="phase 17 covertype f64 %s"
                         % ("bundled" if bundled else "unbundled"))
        check(run["booster"].inner.learner._bundled == bundled,
              "phase 17 covertype: enable_bundle=%s" % bundled)
        runs[bundled] = run
    b, u = runs[True]["booster"], runs[False]["booster"]
    p_b = b.predict(Xv, predict_on_device=False)
    p_u = u.predict(Xv, predict_on_device=False)
    same = sum(tree_structure(x) == tree_structure(z)
               for x, z in zip(b.inner.models, u.inner.models))
    gap = np.abs(p_b - p_u)
    within = bool(np.allclose(p_b, p_u, rtol=1e-4, atol=1e-5))
    log("phase 17 covertype bundled vs unbundled with f64 sums (2 rounds, "
        "%.1f s): %d of 14 trees structure-equal; predictions max |diff| "
        "%.3g, %.4f%% of values beyond rtol 1e-4 + atol 1e-5; the "
        "reference's bundle contract (rtol 1e-4) holds: %s; held-out "
        "multi_logloss round 2 %.6f vs %.6f"
        % (time.perf_counter() - t0, same, float(gap.max()),
           100.0 * float(np.mean(gap > 1e-5 + 1e-4 * np.abs(p_u))), within,
           runs[True]["evals"]["multi_logloss"][1],
           runs[False]["evals"]["multi_logloss"][1]))
    return {"phase17_covertype_f64_bundled":
            runs[True]["launches"]["histogram_f64"],
            "phase17_covertype_f64_unbundled":
            runs[False]["launches"]["histogram_f64"]}


# ---------------------------------------------------------------------------
# phase 18: DART, random forest and refit
# ---------------------------------------------------------------------------
def _record_drops():
    """Wrap DART's drop selection to keep every iteration's drop set.
    Returns (drops, restore)."""
    from lightgbm_tpu_torch.boosting.dart import DART
    select = DART._select_dropping_trees
    drops = []

    def recorded(self):
        select(self)
        drops.append(list(self.drop_index))
    DART._select_dropping_trees = recorded

    def restore():
        DART._select_dropping_trees = select
    return drops, restore


def phase_boosting(lgb, hist_mod, data):
    """DART (drop_rate 0.1, skip_drop 0, 5 rounds) and RF (bagging 0.632
    every round, feature_fraction 0.9, 5 rounds) on phase 4's Dataset
    through the whole-tree loop: launches == roots + steps, held-out AUC
    > 0.7 and equal to the device scores', stacked predict == host walk;
    ``average_output`` in the RF text; DART's drop sets (and tree
    weights) on the card equal those of a CPU run at 200k rows with the
    same seed (50k rows: the drops depend on the RNG and the tree
    weights only). The stacked checks run on 100k held-out rows. Returns
    the f32 launches by path."""
    import torch
    # skip_drop 0: at its default of 0.5 half the iterations drop
    # nothing, and 5 rounds at drop_rate 0.1 would likely drop no tree
    dart = {"boosting": "dart", "drop_rate": 0.1, "skip_drop": 0.0}
    drops, restore = _record_drops()
    try:
        bst, launches, aucs, _, _ = train_full(
            lgb, hist_mod, data, dart, "histogram_f32",
            tag="phase 18 dart")
        card = (list(drops), list(bst.inner.tree_weight))
        drops.clear()
        # the drops come from the host RNG and the tree weights: any rows
        # that grow a tree each iteration draw them the same
        X, y = make_higgs_like(50_000, seed=7)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            cpu = lgb.train(dict(SLICE_PARAMS, num_leaves=63,
                                 device_type="cpu", **dart),
                            lgb.Dataset(X, label=y), num_boost_round=5)
        finally:
            torch.set_num_threads(threads)
        host = (list(drops), list(cpu.inner.tree_weight))
    finally:
        restore()
    check(card == host, "DART drop sets or tree weights differ between "
          "cuda (%s) and cpu (%s)" % (card, host))
    check(any(card[0]), "DART dropped no tree in 5 rounds")
    a = check_predict(bst, data, aucs)
    check_stacked(bst, data[2][:100_000], "phase 18 dart")
    log("phase 18 DART: drop sets per iteration %s, tree weights %s, the "
        "same on cuda and cpu; held-out AUC %.6f"
        % (card[0], " ".join("%.6f" % w for w in card[1]), a))
    by_path = {"phase18_higgs_dart": launches["histogram_f32"]}
    del bst, cpu
    rf = {"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
          "feature_fraction": 0.9}
    bst, launches, aucs, _, _ = train_full(lgb, hist_mod, data, rf,
                                           "histogram_f32",
                                           tag="phase 18 rf")
    text = bst.model_to_string()
    check("\naverage_output\n" in text and bst.inner.average_output,
          "the RF model text has no average_output line")
    a = check_predict(bst, data, aucs)
    check_stacked(bst, data[2][:100_000], "phase 18 rf")
    again = lgb.Booster(model_str=text)
    check(np.array_equal(again.predict(data[2][:100_000]),
                         bst.predict(data[2][:100_000],
                                     predict_on_device=False)),
          "the RF text round trip predicts other values")
    log("phase 18 RF: average_output in the text, the text round trip "
        "and the stacked path equal the host walk; held-out AUC %.6f" % a)
    by_path["phase18_higgs_rf"] = launches["histogram_f32"]
    return by_path


def phase_refit(lgb):
    """``Booster.refit`` of phase 12's model (255 leaves; its first
    REFIT_ITERATIONS trees, which keeps the CPU refit short; as many
    trees trained at 200k rows when phase 12 did not run) on 200k fresh
    rows, on the card and on the CPU from the same model text: every
    leaf value within 1e-5 absolute (f32 per-leaf sums in another order
    on each device), the refit model's stacked predict == host walk on
    the card."""
    import torch
    model = PHASE12.get("model")
    if model is None:
        X, y = make_higgs_like(SMALL_ROWS, seed=7)
        model = lgb.train(dict(SLICE_PARAMS, num_leaves=255),
                          lgb.Dataset(X, label=y),
                          num_boost_round=REFIT_ITERATIONS).model_to_string()
    Xr, yr = make_higgs_like(SMALL_ROWS, seed=11)
    card = lgb.Booster(model_str=model)
    cpu = lgb.Booster(model_str=model, params={"device_type": "cpu"})
    before = [t.leaf_value[:t.num_leaves].copy() for t in card.inner.models]
    _, t_card = timed(lambda: card.refit(Xr, yr))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.perf_counter()
        cpu.refit(Xr, yr)
        t_cpu = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    gap, moved = 0.0, 0
    for a, b, old in zip(card.inner.models, cpu.inner.models, before):
        va, vb = a.leaf_value[:a.num_leaves], b.leaf_value[:b.num_leaves]
        gap = max(gap, float(np.abs(va - vb).max()))
        moved += int(np.sum(va != old))
    check(gap <= 1e-5, "refit leaf values differ between cuda and cpu by "
          "%.3g" % gap)
    check(moved > 0, "refit changed no leaf value")
    check_stacked(card, Xr[:65_536], "phase 18 refit")
    log("phase 18 refit of a %d-tree model on %d rows: %.3f s on the card "
        "(one stacked leaf walk, per-leaf f32 sums), %.3f s on the cpu; "
        "%d leaf values changed; leaf values cuda vs cpu max |diff| %.3g "
        "(tol 1e-5)" % (len(card.inner.models), SMALL_ROWS, t_card, t_cpu,
                        moved, gap))


def time_widths(hist_mod, widths, rows_out):
    """Every instance at the new widths' root shapes (the real bins of
    phases 9 and 10) and at children of 10k, 100k and 1M rows (fewer
    than the root), each beside its bound, plain and library times;
    appended to each instance's row of the kernels line."""
    import torch
    for label, bins, B in widths:
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
        for row in rows_out:
            tag = row["name"].rsplit("_", 1)[1]
            if row["bins"] != str(bins.dtype):
                continue
            rows_gh = {"f32": gh, "f64": gh, "i8": gh8, "i16": gh16}[tag]
            f64 = tag == "f64"
            times = [dict(width=label, S=S, Fp=bins.shape[1], B=B,
                          **time_histogram(hist_mod, bins, rows_gh, B,
                                           row["name"], f64=f64))]
            for idx in children:
                times.append(dict(width=label, S=idx.shape[0],
                                  Fp=bins.shape[1], B=B, child=True,
                                  **time_histogram(hist_mod, bins, rows_gh,
                                                   B, row["name"], idx,
                                                   f64=f64)))
            row.setdefault("widths", []).extend(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,"
                            "18",
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
        phase_wide_kernels(hist_mod, errs)
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
    data = (full_data(lgb, keep_head=bool(phases & {15, 16}))
            if phases & {4, 7, 14, 15, 16, 17, 18} else None)
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
    # phase 16 bins phase 4's training rows again (phase 15 drops them)
    wdata = None
    if 16 in phases:
        paths, wdata = phase_wide(lgb, hist_mod, data, errs, rows)
        for kernel, counts in paths.items():
            by_path[kernel].update(counts)
        lap("phase 16 (with the max_bin 1023 binning)")
    if 17 in phases:
        for kernel, counts in phase_f64(lgb, hist_mod, data, wdata).items():
            by_path[kernel].update(counts)
        lap("phase 17 (higgs)")
    del wdata
    if 18 in phases:
        by_path["histogram_f32"].update(phase_boosting(lgb, hist_mod, data))
        lap("phase 18 (dart, rf)")
    if 14 in phases:
        for kernel, paths in phase_sampling(lgb, hist_mod, data).items():
            by_path[kernel].update(paths)
        lap("phase 14")
    if 15 in phases:
        for kernel, paths in phase_constraints(lgb, hist_mod, data).items():
            by_path[kernel].update(paths)
        lap("phase 15")
    HEAD.clear()
    del data
    if 8 in phases:
        run = phase_small(lgb, hist_mod,
                          {"use_quantized_grad": True, "quant_grad_bits": 16,
                           "bagging_fraction": 0.8, "bagging_freq": 1},
                          "histogram_i16", None, rounds=1)
        by_path["histogram_i16"]["phase8_small_16bit_bagging"] = \
            run["histogram_i16"]
        lap("phase 8")
    widths = []
    if 9 in phases:
        run, (bins, bg) = phase_covertype(lgb, hist_mod)
        by_path["histogram_f32"]["phase9_covertype_bundled"] = \
            run["phase9_covertype_bundled"]
        by_path["histogram_i8"]["phase9_covertype_bundled_8bit"] = \
            run["phase9_covertype_bundled_8bit"]
        widths.append(("covertype bundles Gp=%d Bg=%d" % (bins.shape[1],
                                                         bg), bins, bg))
        lap("phase 9")
    if 13 in phases:
        run, (bins, b) = phase_covertype_categorical(lgb, hist_mod)
        by_path["histogram_f32"].update(run)
        widths.append(("covertype categorical Fp=%d" % bins.shape[1], bins,
                       b))
        lap("phase 13")
    if 10 in phases:
        n, bins = phase_mslr(lgb, hist_mod)
        by_path["histogram_f32"]["phase10_mslr_lambdarank_xendcg"] = n
        widths.append(("mslr Fp=136", bins, 256))
        lap("phase 10")
    if rows is not None and widths:
        time_widths(hist_mod, widths, rows)
        lap("kernel timing at the widths of phases 9, 10 and 13")
    del widths
    if 11 in phases:
        by_path["histogram_f32"]["phase11_other_objectives"] = \
            phase_other_objectives(lgb, hist_mod)
        lap("phase 11")
    if 12 in phases:
        by_path["histogram_f32"].update(phase_predict(lgb, hist_mod))
        lap("phase 12")
    if 17 in phases:
        by_path["histogram_f64"].update(phase_f64_covertype(lgb, hist_mod))
        lap("phase 17 (covertype)")
    if 18 in phases:
        phase_refit(lgb)
        lap("phase 18 (refit)")
    if rows is not None:
        for row in rows:
            row["launches_by_path"] = by_path[row["name"]]
            row["launches"] = sum(by_path[row["name"]].values())
        if phases >= {2, 4, 5, 16, 17}:
            check(len(rows) == len(hist_mod.launch_counts)
                  and all(row["launches"] > 0 for row in rows),
                  "an instance is not timed or was launched by no path: %s"
                  % {row["name"]: row["launches"] for row in rows})
        log(json.dumps({"kernels": rows}))
    log("chip_smoke seconds: %.1f" % (time.perf_counter() - t_start))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
