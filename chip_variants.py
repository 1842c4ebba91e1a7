#!/usr/bin/env python3
"""What a change to the histogram kernel moved, and where its time goes,
on one NVIDIA H100.

Run from the root of a checkout, on a machine with one H100:

    python3 chip_variants.py --parent REV [--before-slabs REV]

``--parent`` names the commit to compare with; its
``lightgbm_tpu_torch/csrc/histogram.cu`` is read with ``git show`` at run
time, so no copy is kept in the repository. A copy of the repository
without its history takes the file itself: write it first with
``git show REV:lightgbm_tpu_torch/csrc/histogram.cu > FILE`` and pass
``--parent-source FILE`` (and ``--before-slabs-source``). Builds, one
``nvcc`` each, all started together:

- the parent's source and the source as it is, each as the uint8 library
  and as the uint16 build (``histogram_u16.cu`` beside it);
- with ``--before-slabs``, a kernel from before the (feature, slab)
  rewrite (entries without the staged-features argument; uint8 bins,
  f32, int8 and int16 only), to settle whether that rewrite slowed the
  uint8 instances;
- variants of the source as it is, made by text edits at run time: tile
  staging, zeroing, flush and sum pass only (no row work: wrong sums,
  timed only), which splits a small child's time (``VARIANTS`` takes
  more); and the source as it is under other launch plans on the
  children: one
  row block (no partials, no sum pass), and row blocks of at least 1024
  and of at least 256 rows.

Times, with CUDA events, each instance (uint8 bins: f32, int8, int16, f64
sums; uint16 bins: f32, f64 sums at B = 1024; int8 and int16 at B = 1024
and 4096) at the main path's root shape (10.5M rows x 32 features, C =
4; warm repeats), on uniform random bins, on skewed ones (floor(B u^4):
a quarter of the rows in bin 0 at B = 256, 18% at B = 1024, as real
columns pile rows into few bins) and on query runs (a third of the
features constant within MSLR-shaped queries of ~120 rows, as its
query-level features), and over sorted row-index lists of
10k, 100k and 1M rows (the L2 flushed before each call), through the
host-count entry and the device-count entry, in turns: parent, change,
change, parent (so a drift of the card's clock during the run falls on
both). Each launch plan is its own source's (the parent's is rebuilt
here from its arithmetic). The variants are timed at the three roots and at
10k and 100k rows, beside the change in the same turns; the block-order
sum pass alone at the 10k-row plans. Then the width study: f32 and int8
over uint8 bins at the same rows x features as MSLR's 2.27M x 136, at Fp
= 32, 128, 136 and 144 (Fp = 136 stages 8-byte copy units and a fifth
group of 8 features; 128 neither; 144 16-byte units and a fifth group
of 16), on uniform, skewed and query-run bins, parent and change in
turns. Each result is held to the plain version (f32 within 1e-5 x sum
|x|, f64 sums the f64 sum rounded once, integers byte-equal); a variant
that is wrong by design is not. Prints one line per instance and case
and writes them all to ``chiprun_out/chip_variants.json``. Without a
CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "lightgbm_tpu_torch", "csrc")
SOURCE = "lightgbm_tpu_torch/csrc/histogram.cu"
ROOT_ROWS, FP = 10_500_000, 32
CHILD_ROWS = (10_000, 100_000, 1_000_000)

# name -> [(text in the source, replacement)]; "(wrong)" variants give
# wrong sums on purpose and are timed only. Tried on the integer
# instances over uint16 bins in earlier runs of this script (PERF.md
# §6): lost and taken out, folds of the lanes that share a key before
# the shared atomic add (lane 0's key in every mixed chunk; every key by
# __match_any_sync; the two keys of a chunk of exactly two); won and
# taken into the kernel, two pairs a warp, contiguous runs of chunks for
# the sharing warps, and the one-key sums flushed by one reduction per
# channel.
VARIANTS = {
    "staging, zeroing, flush and sum pass only (wrong)": [
        ("    if (npw > 0) {                       // warp-uniform",
         "    if (npw < 0) {")],
}
#: variants of the launch plan alone, on the change's library, timed on
#: the children: every call in one row block (no per-block partials, no
#: sum pass), and row blocks of at least 1024 or 256 rows (fewer blocks
#: for a small child, fewer partials to sum; or more blocks)
PLANS = {"one row block (no sum pass)": None, "1024-row blocks": 1024,
         "256-row blocks": 256}
SUM_ONLY = """
extern "C" int lgbm_sum_only_%s(const void* scratch, void* out, int blocks,
                                long long n, void* stream) {
  hist_sum_kernel<%s, float><<<(unsigned)((n + 255) / 256), 256, 0,
      (cudaStream_t)stream>>>((const %s*)scratch, (float*)out, blocks, n,
                              nullptr, 0, 0);
  return (int)cudaGetLastError();
}
"""
#: (label, bins dtype name, B, gh kind, f64 sums, entry tag)
INSTANCES = (("K1 f32, uint8", "uint8", 256, "f32", False, "f32"),
             ("K2 int8, uint8", "uint8", 256, "i8", False, "i8"),
             ("int16, uint8", "uint8", 256, "i16", False, "i16"),
             ("f64 sums, uint8", "uint8", 256, "f32", True, "f64"),
             ("K1w f32, uint16", "uint16", 1024, "f32", False, "f32"),
             ("f64 sums, uint16", "uint16", 1024, "f32", True, "f64"),
             ("K2w int8, uint16", "uint16", 1024, "i8", False, "i8"),
             ("int16, uint16", "uint16", 1024, "i16", False, "i16"),
             ("K2w int8, uint16, B 4096", "uint16", 4096, "i8", False,
              "i8"),
             ("int16, uint16, B 4096", "uint16", 4096, "i16", False,
              "i16"))
#: the instances redesigned since the first port (slab queues, whole
#: features, 256-row blocks): timed under the variants and launch plans
#: too
REDESIGNED = ("f64 sums, uint8", "K1w f32, uint16", "f64 sums, uint16",
              "K2w int8, uint16", "int16, uint16",
              "K2w int8, uint16, B 4096", "int16, uint16, B 4096")
#: the width study: MSLR's 2.27M rows x 136 features, and the same rows x
#: features at other widths
WIDTH_CELLS = 2_270_296 * 136
WIDTHS = (32, 128, 136, 144)


def read_source(rev, path):
    if path:
        with open(path) as fh:
            return fh.read()
    return subprocess.run(["git", "show", "%s:%s" % (rev, SOURCE)],
                          cwd=HERE, capture_output=True, text=True,
                          check=True).stdout


def build(csrc, out_dir, sources):
    """sources: name -> text of histogram.cu. Each is built as the uint8
    library and (but the pre-slab kernel) the uint16 build, one nvcc per
    library, all started together."""
    u16 = open(os.path.join(CSRC, "histogram_u16.cu")).read()
    procs = {}
    for name, text in sources.items():
        d = os.path.join(out_dir, "s%d" % len(procs))
        os.makedirs(d)
        with open(os.path.join(d, "histogram.cu"), "w") as fh:
            fh.write(text + (SUM_ONLY % ("f32", "float", "float")
                             + SUM_ONLY % ("f64", "double", "double")
                             if "LGBM_BIN_T" in text else ""))
        with open(os.path.join(d, "histogram_u16.cu"), "w") as fh:
            fh.write(u16)
        for bins in ("uint8", "uint16"):
            if bins == "uint16" and "LGBM_BIN_T" not in text:
                continue
            src = os.path.join(d, "histogram.cu" if bins == "uint8"
                               else "histogram_u16.cu")
            lib = os.path.join(d, "lib%s.so" % bins)
            procs[(name, bins)] = (lib, subprocess.Popen(
                [csrc._nvcc()] + csrc.NVCC_FLAGS + ["-o", lib, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit("%s did not build:\n%s" % (key, out))
        libs[key] = ctypes.CDLL(lib)
    return libs


def parent_plan(H, S, Fp, B, C, gh_dtype, num_sms, bins_dtype, f64):
    """The launch plan of the parent kernel: 256-bin slabs for
    every instance over uint16 bins in groups of 16 or 32 pairs, a slab
    queue of 64 4-byte entries per pair for float rows over uint16 bins,
    row blocks of at least 256 rows for those and for f64 sums, else
    1024. Also the plan of the kernel from before the slab rewrite (uint8
    bins, f32 / int8 / int16 rows: one slab, no queue, 1024-row blocks,
    the same arithmetic)."""
    bin_bytes, gh_bytes = bins_dtype.itemsize, C * gh_dtype.itemsize
    floating = gh_dtype.is_floating_point
    acc = 8 if f64 and floating else 4
    sb = min(B, 256)
    slabs = -(-B // sb)
    pairs = Fp * slabs
    queued = floating and bin_bytes == 2

    def staged(fg):
        if slabs == 1:
            return fg
        return max(b - a for a, b in (H._group_features(g, fg, slabs, Fp)
                                      for g in range(-(-pairs // fg))))

    def smem(fg, rows):
        return fg * sb * C * acc + (fg * 64 * 4 if queued else 0) + 2 * \
            rows * (staged(fg) * bin_bytes + gh_bytes)

    fits = [fg for fg in (16, 32) if smem(fg, 128) <= H.MAX_SMEM]
    groups = -(-pairs // fits[-1])
    fg = min(f for f in fits if f * groups >= pairs)
    groups = -(-pairs // fg)
    rows = (H.MAX_SMEM - smem(fg, 0)) // (
        2 * (staged(fg) * bin_bytes + gh_bytes))
    tile = min(H.MAX_TILE_ROWS, rows // 32 * 32)
    min_rows = 256 if floating and (f64 or bin_bytes == 2) else 1024
    cap = max(1, num_sms // groups)
    blocks = max(1, min(cap, -(-S // min_rows)))
    per = -(-S // blocks)
    blocks = -(-S // per)
    return H.LaunchPlan(groups=groups, features_per_group=fg, warps=H.WARPS,
                        tile_rows=tile, blocks=blocks, rows_per_block=per,
                        smem_bytes=smem(fg, tile),
                        scratch_shape=(blocks, Fp, B, C) if blocks > 1
                        else None, slab_bins=sb, slabs=slabs,
                        stage_features=staged(fg), min_rows=min_rows)


class Launcher:
    """One source's entries of one instance, with that source's plan."""

    def __init__(self, torch, H, lib, tag, kind, bins, gh, B, f64):
        self.torch, self.H, self.lib = torch, H, lib
        self.kind, self.bins, self.gh, self.B, self.f64 = (kind, bins, gh, B,
                                                           f64)
        self.symbol = "lgbm_histogram_" + tag
        self.acc = H.acc_dtype(gh.dtype, f64)
        self.out_dtype = torch.int32 if self.acc == torch.int32 \
            else torch.float32
        self.num_sms = H._num_sms(bins.device)

    def plan(self, S):
        """This source's plan; a plan variant's row blocks are one, or
        as many as its least rows per block give."""
        H = self.H
        Fp, C = self.bins.shape[1], self.gh.shape[1]
        args = (S, Fp, self.B, C, self.gh.dtype, self.num_sms,
                self.bins.dtype, self.f64)
        if self.kind in ("parent", "before slabs"):
            return parent_plan(H, *args)
        p = H.launch_plan(*args)
        if self.kind not in PLANS:
            return p
        rows = PLANS[self.kind]
        blocks = 1 if rows is None else max(
            1, min(self.num_sms // p.groups, -(-S // rows)))
        per = -(-S // blocks)
        blocks = -(-S // per)
        return p._replace(blocks=blocks, rows_per_block=per,
                          scratch_shape=(blocks, Fp, self.B, C)
                          if blocks > 1 else None,
                          min_rows=rows or p.min_rows)

    def host(self, idx, bins=None):
        torch, H = self.torch, self.H
        bins = self.bins if bins is None else bins
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = getattr(self.lib, self.symbol)
        pre = self.kind == "before slabs"
        # bins, gh, idx, out, scratch, launches; S; Fp, B, C, Fg, groups,
        # [Fs,] T, blocks; rows_per_block; smem; stream
        fn.argtypes = [vp] * 6 + [i64] + [i32] * (7 if pre else 8) + [
            i64, i32, vp]
        fn.restype = ctypes.c_int
        F, C = bins.shape[1], self.gh.shape[1]
        S = bins.shape[0] if idx is None else idx.shape[0]
        p = self.plan(S)
        out = torch.empty((F, self.B, C), dtype=self.out_dtype,
                          device="cuda")
        scratch = (None if p.scratch_shape is None else
                   torch.empty(p.scratch_shape, dtype=self.acc,
                               device="cuda"))
        stream = torch.cuda.current_stream().cuda_stream
        mid = [p.features_per_group, p.groups] + (
            [] if pre else [p.stage_features]) + [p.tile_rows, p.blocks]
        args = [bins.data_ptr(), self.gh.data_ptr(),
                None if idx is None else idx.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), None, S, F,
                self.B, C] + mid + [p.rows_per_block, p.smem_bytes, stream]

        def run():
            code = fn(*args)
            if code != 0:
                raise SystemExit("%s launch failed: cuda error %d"
                                 % (self.symbol, code))
            return out
        return run, p

    def device(self, buf, count, n):
        torch = self.torch
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn = getattr(self.lib, self.symbol + "_dev")
        fn.argtypes = [vp] * 7 + [i32] * 10 + [vp]
        fn.restype = ctypes.c_int
        F, C = self.bins.shape[1], self.gh.shape[1]
        p = self.plan(max(n, 1))
        max_blocks = max(1, self.num_sms // p.groups)
        out = torch.empty((F, self.B, C), dtype=self.out_dtype,
                          device="cuda")
        scratch = (None if max_blocks == 1 else
                   torch.empty((max_blocks, F, self.B, C), dtype=self.acc,
                               device="cuda"))
        stream = torch.cuda.current_stream().cuda_stream
        args = [self.bins.data_ptr(), self.gh.data_ptr(), buf.data_ptr(),
                count.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), None, F,
                self.B, C, p.features_per_group, p.groups, p.stage_features,
                p.tile_rows, max_blocks, p.min_rows,
                p.smem_bytes, stream]

        def run():
            code = fn(*args)
            if code != 0:
                raise SystemExit("%s_dev launch failed: cuda error %d"
                                 % (self.symbol, code))
            return out
        return run


def timed_ms(torch, run, reps, cold, flush):
    run()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if cold:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def held(smoke, H, torch, got, bins, gh, B, idx, f64):
    """The result against the plain version: the check of chip_smoke.py
    for its instance (compare_f32 / compare_f64 / compare_int), on the
    same rows."""
    real = H.build_histogram

    def fixed(*args, **kwargs):
        return got.clone()
    H.build_histogram = fixed
    try:
        if not gh.dtype.is_floating_point:
            smoke.compare_int(H, bins, gh, B, idx)
        elif f64:
            smoke.compare_f64(H, bins, gh, B, idx)
        else:
            smoke.compare_f32(H, bins, gh, B, idx)
    finally:
        H.build_histogram = real


def held_all(smoke, H, torch, runs, bins, gh, B, idx, f64):
    """Every run's result held to the plain version, but a "(wrong)"
    variant's."""
    for n, (run, _) in runs.items():
        if "(wrong)" not in n:
            held(smoke, H, torch, run(), bins, gh, B, idx, f64)


def width_bins(torch, g, rows, Fp, dist, B=256):
    """Bins [rows, Fp] (uint8 at B <= 256, else uint16): uniform, skewed
    (floor(B u^4)), or query runs (uniform, but the last third of the
    features constant within queries of MSLR's log-normal lengths, mean
    near 120 rows, as its query-level features)."""
    import numpy as np
    u = torch.rand(rows, Fp, generator=g, device="cuda")
    b = ((u.pow(4) if dist == "skewed" else u) * B).to(torch.int32)
    del u
    if dist == "query runs":
        rng = np.random.RandomState(Fp)
        lengths = np.clip(np.round(rng.lognormal(np.log(90.0), 0.75,
                                                 rows // 60 + 1)), 1, 1251)
        qid = np.repeat(np.arange(len(lengths)), lengths.astype(np.int64))
        qid = torch.from_numpy(qid[:rows]).to("cuda")
        k = Fp // 3
        qb = torch.randint(0, B, (len(lengths), k), generator=g,
                           device="cuda", dtype=torch.int32)
        b[:, Fp - k:] = qb[qid]
    b = b.to(torch.uint8) if B <= 256 else b.to(torch.int16).view(
        torch.uint16)
    return b.contiguous()


def timed_turns(torch, runs, reps, cold, flush):
    """ms of each run, in turns: parent, change, the rest, then back."""
    order = ["parent", "change"] + [
        n for n in runs if n not in ("parent", "change")]
    ms = {n: [] for n in runs}
    for turn in order + order[::-1]:
        ms[turn].append(timed_ms(torch, runs[turn][0], reps, cold, flush))
    return {n: sum(v) / len(v) for n, v in ms.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="commit to compare with (git show)")
    ap.add_argument("--parent-source", help="its histogram.cu, as a file")
    ap.add_argument("--before-slabs", help="a commit from before the "
                    "(feature, slab) rewrite (git show)")
    ap.add_argument("--before-slabs-source", help="its histogram.cu")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not (args.parent or args.parent_source):
        ap.error("name the parent: --parent REV or --parent-source FILE")
    import torch
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as smoke
    from lightgbm_tpu_torch import csrc
    from lightgbm_tpu_torch.ops import histogram as H
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print("card: %s" % smi, flush=True)
    t0 = time.perf_counter()
    text = open(os.path.join(CSRC, "histogram.cu")).read()
    sources = {"parent": read_source(args.parent, args.parent_source),
               "change": text}
    if args.before_slabs or args.before_slabs_source:
        sources["before slabs"] = read_source(args.before_slabs,
                                              args.before_slabs_source)
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise SystemExit("variant %r: %r not in the source"
                                 % (name, old))
            src = src.replace(old, new)
        sources[name] = src
    tmp = tempfile.mkdtemp()
    results = []

    def report(line):
        results.append(line)
        print(json.dumps(line), flush=True)
    try:
        libs = build(csrc, tmp, sources)
        print("built %d libraries in %.1f s" % (len(libs),
                                               time.perf_counter() - t0),
              flush=True)
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
        gh = torch.randn(ROOT_ROWS, 4, generator=g, device="cuda")
        gh[:, 2:] = 1.0
        rows = {"f32": gh,
                "i8": torch.randint(-127, 128, (ROOT_ROWS, 4), generator=g,
                                    device="cuda", dtype=torch.int32
                                    ).to(torch.int8),
                "i16": torch.randint(-204, 205, (ROOT_ROWS, 4), generator=g,
                                     device="cuda", dtype=torch.int32
                                     ).to(torch.int16)}
        perm = torch.randperm(ROOT_ROWS, generator=g, device="cuda")
        lists = {n: perm[:n].sort().values.to(torch.int32)
                 for n in CHILD_ROWS}
        lists[ROOT_ROWS] = torch.arange(ROOT_ROWS, dtype=torch.int32,
                                        device="cuda")
        bins_of = {}
        for label, bname, B, kind, f64, tag in INSTANCES:
            if (bname, B) not in bins_of:
                # uniform bins; skewed ones, floor(B u^4): a quarter of the
                # rows in bin 0 at B = 256 (as real columns pile rows into
                # few bins); and query runs (a third of the features
                # constant within MSLR-shaped queries)
                bins_of[(bname, B)] = {
                    dist: width_bins(torch, g, ROOT_ROWS, FP, dist, B)
                    for dist in ("uniform", "skewed", "query runs")}
            bins, rg = bins_of[(bname, B)]["uniform"], rows[kind]
            names = ["parent", "change"] + (
                ["before slabs"] if "before slabs" in sources and
                bname == "uint8" and not f64 else []) + (
                list(VARIANTS) + list(PLANS) if label in REDESIGNED
                or label.startswith("K1 ") else [])
            lau = {n: Launcher(torch, H,
                               libs[("change" if n in PLANS else n,
                                     bname)],
                               ("u16_" if bname == "uint16" else "") + tag,
                               n if n in ("parent", "before slabs")
                               or n in PLANS else "change",
                               bins, rg, B, f64)
                   for n in names}
            roots = {"root": "uniform", "skewed root": "skewed",
                     "query-run root": "query runs"}
            cases = [(case, None, False, args.reps) for case in roots] + [
                ("%dk list" % (n // 1000), lists[n], True, 2 * args.reps)
                for n in CHILD_ROWS]
            for case, idx, cold, reps in cases:
                cb = bins_of[(bname, B)][roots.get(case, "uniform")]
                runs = {n: lau[n].host(idx, cb) for n in names
                        if n in ("parent", "change") or (
                            case in ("10k list", "100k list") if n in PLANS
                            else case in tuple(roots) + ("10k list",
                                                         "100k list"))}
                ms = timed_turns(torch, runs, reps, cold, flush)
                held_all(smoke, H, torch, runs, cb, rg, B, idx, f64)
                report(dict(instance=label, case=case, entry="host", B=B,
                            rows=ROOT_ROWS if idx is None else idx.shape[0],
                            ms=ms,
                            plans={n: dict(groups=p.groups,
                                           blocks=p.blocks,
                                           tile_rows=p.tile_rows)
                                   for n, (run, p) in runs.items()}))
            for n_rows in CHILD_ROWS + (ROOT_ROWS,):
                buf, count = smoke.count_buffer(lists[n_rows], ROOT_ROWS)
                runs = {n: lau[n].device(buf, count, n_rows)
                        for n in ("parent", "change")}
                ms = {n: [] for n in runs}
                cold = n_rows < ROOT_ROWS
                for turn in ("parent", "change", "change", "parent"):
                    ms[turn].append(timed_ms(torch, runs[turn], args.reps,
                                             cold, flush))
                want = runs["change"]().clone()
                host, _ = lau["change"].host(lists[n_rows])
                same = torch.equal(host().view(torch.int32),
                                   want.view(torch.int32))
                if not same:
                    raise SystemExit("%s: the device-count entry differs "
                                     "from the host-count launch at n=%d"
                                     % (label, n_rows))
                report(dict(instance=label, case="%d-row list" % n_rows,
                            entry="device count", B=B, rows=n_rows,
                            ms={n: sum(v) / len(v) for n, v in ms.items()}))
            # the block-order sum pass alone, at the change's 10k plan
            if label in REDESIGNED or label.startswith("K1 "):
                p = lau["change"].plan(CHILD_ROWS[0])
                acc = "f64" if f64 else "f32"
                fn = getattr(libs[("change", bname)], "lgbm_sum_only_" + acc)
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_longlong,
                               ctypes.c_void_p]
                fn.restype = ctypes.c_int
                n = FP * B * 4
                scratch = torch.randn(max(p.blocks, 2), n, device="cuda",
                                      dtype=torch.float64 if f64
                                      else torch.float32)
                out = torch.empty(n, device="cuda")
                stream = torch.cuda.current_stream().cuda_stream
                ms = timed_ms(torch, lambda: fn(
                    scratch.data_ptr(), out.data_ptr(), p.blocks, n, stream),
                    2 * args.reps, True, flush)
                report(dict(instance=label, case="sum pass alone",
                            entry="host", B=B, blocks=p.blocks, ms=ms))
        del bins_of, lists, perm
        # the width study: f32 and int8 over uint8 bins at MSLR's rows x
        # features, cut into other widths
        for Fp in WIDTHS:
            n_rows = -(-WIDTH_CELLS // Fp)
            for dist in ("uniform", "skewed", "query runs"):
                wb = width_bins(torch, g, n_rows, Fp, dist)
                for label, kind in (("K1 f32, uint8", "f32"),
                                    ("K2 int8, uint8", "i8")):
                    rg = rows[kind][:n_rows]
                    names = ["parent", "change"]
                    runs = {n: Launcher(torch, H, libs[(n, "uint8")], kind,
                                        "parent" if n == "parent"
                                        else "change", wb, rg, 256,
                                        False).host(None)
                            for n in names}
                    ms = timed_turns(torch, runs, args.reps, False, flush)
                    held_all(smoke, H, torch, runs, wb, rg, 256, None,
                             False)
                    report(dict(instance=label, case="width %s" % dist,
                                entry="host", B=256, Fp=Fp, rows=n_rows,
                                ms=ms,
                                plans={n: dict(groups=p.groups,
                                               blocks=p.blocks,
                                               tile_rows=p.tile_rows)
                                       for n, (run, p) in runs.items()}))
                del wb
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_variants.json"),
              "w") as fh:
        json.dump(dict(card=smi, results=results), fh, indent=1)
    print("chip_variants seconds: %.1f" % (time.perf_counter() - t0))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
