#!/usr/bin/env python3
"""Where the histogram kernel's time goes, on one NVIDIA H100.

Run from the root of a checkout, on a machine with one H100:

    python3 chip_variants.py

Builds variants of ``lightgbm_tpu_torch/csrc/histogram.cu`` made by text
edits of the source at run time (none is kept in the repository), each
with the package's own launch plan, and times each one's f32 and int8
instances with CUDA events:

- at the main path's root shape, 10.5M rows x 32 features, B = 256,
  C = 4, on uniform random bins and on "padded" bins (28 uniform columns
  and 4 all-zero columns, as the learner pads 28 features to 32);
- with a 100k-row row-index list on the padded bins, the L2 flushed
  before each call;

the kernel as it is also with half the plan's tile rows, and times the
block-order sum pass alone. A variant whose sums are wrong
by design says so; the others must equal the kernel as it is. Prints one
line per variant and instance. Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "lightgbm_tpu_torch", "csrc", "histogram.cu")

# name -> [(text in the source, replacement)]; "wrong" variants give
# wrong sums on purpose and are timed only
VARIANTS = {
    "kernel as it is": [],
    "tile staging, zeroing, flush and sum pass only (wrong)": [
        ("if (nfw > 0) {                       // warp-uniform",
         "if (nfw < 0) {")],
    "int accumulators [Fg, B, C] like the f32 ones": [
        ("constexpr bool kChannelMajor = std::is_same<ACC, int>::value;",
         "constexpr bool kChannelMajor = false;")],
    "no one-bin vote (every chunk takes the mixed path)": [
        ("mixed[j] = !__all_sync(kFull, b[j] == bin);", "mixed[j] = true;")],
    "int instances by the f32 tree instead of atomics": [
        ("if constexpr (std::is_same<ACC, int>::value) {",
         "if constexpr (false) {")],
    "peers by __match_any_sync instead of eight ballots": [
        ("peers[j] = peers_of(b[j], valid_lanes);",
         "peers[j] = __match_any_sync(kFull, b[j]) & valid_lanes;")],
    "no peers: every lane stores its own row (wrong)": [
        ("peers[j] = peers_of(b[j], valid_lanes);",
         "peers[j] = (1u << lane) & valid_lanes;")],
}
SUM_ONLY = """
extern "C" int lgbm_sum_only_f32(const void* scratch, void* out, int blocks,
                                 long long n, void* stream) {
  hist_sum_kernel<float><<<(unsigned)((n + 255) / 256), 256, 0,
      (cudaStream_t)stream>>>((const float*)scratch, (float*)out, blocks, n,
                              nullptr, 0, 0);
  return (int)cudaGetLastError();
}
"""


def build(csrc, out_dir):
    """One nvcc per variant, all started together."""
    text = open(SOURCE).read()
    procs = {}
    for k, (name, edits) in enumerate(VARIANTS.items()):
        src = text
        for old, new in edits:
            if old not in src:
                raise SystemExit("variant %r: %r not in the source"
                                 % (name, old))
            src = src.replace(old, new)
        path = os.path.join(out_dir, "v%d.cu" % k)
        with open(path, "w") as fh:
            fh.write(src + SUM_ONLY)
        lib = os.path.join(out_dir, "libv%d.so" % k)
        procs[name] = (lib, subprocess.Popen(
            [csrc._nvcc()] + csrc.NVCC_FLAGS + ["-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit("variant %r did not build:\n%s" % (name, out))
        libs[name] = ctypes.CDLL(lib)
    return libs


def caller(H, torch, lib, symbol, bins, gh, B, idx):
    fn = getattr(lib, symbol)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # bins, gh, idx, out, scratch, launches; S; Fp, B, C, Fg, groups, T,
    # blocks; rows_per_block; smem; stream (ops/histogram.py::_kernel_fn)
    fn.argtypes = [vp] * 6 + [i64] + [i32] * 7 + [i64, i32, vp]
    fn.restype = ctypes.c_int
    F, C = bins.shape[1], gh.shape[1]
    S = bins.shape[0] if idx is None else idx.shape[0]
    plan = H.launch_plan(S, F, B, C, gh.dtype, H._num_sms(bins.device))
    acc = torch.float32 if gh.dtype == torch.float32 else torch.int32
    out = torch.empty((F, B, C), dtype=acc, device="cuda")
    scratch = (None if plan.scratch_shape is None else
               torch.empty(plan.scratch_shape, dtype=acc, device="cuda"))
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        code = fn(bins.data_ptr(), gh.data_ptr(),
                  None if idx is None else idx.data_ptr(), out.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), None, S,
                  F, B, C, plan.features_per_group, plan.groups,
                  plan.tile_rows,
                  plan.blocks, plan.rows_per_block, plan.smem_bytes, stream)
        if code != 0:
            raise SystemExit("launch failed: cuda error %d" % code)
        return out
    return run


def timed_ms(torch, run, reps, cold):
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from lightgbm_tpu_torch import csrc
    from lightgbm_tpu_torch.ops import histogram as H
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print("card: %s" % smi, flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(csrc, tmp)
        print("built %d variants in %.1f s" % (len(libs),
                                              time.perf_counter() - t0))
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        S, Fp, B = 10_500_000, 32, 256
        uniform = torch.randint(0, 255, (S, Fp), generator=g, device="cuda",
                                dtype=torch.int32).to(torch.uint8)
        padded = uniform.clone()
        padded[:, 28:] = 0
        gh = torch.randn(S, 4, generator=g, device="cuda")
        gh8 = torch.randint(-127, 128, (S, 4), generator=g, device="cuda",
                            dtype=torch.int32).to(torch.int8)
        idx = torch.randperm(S, generator=g, device="cuda")[:100_000]
        idx = idx.sort().values.to(torch.int32)
        cases = (("uniform root", uniform, None, False, 5),
                 ("padded root", padded, None, False, 5),
                 ("padded 100k idx, L2 flushed", padded, idx, True, 20))
        ref = {}
        runs = [(name, lib, H.MAX_TILE_ROWS) for name, lib in libs.items()]
        # the kernel as it is with half the plan's tile rows
        runs.insert(1, ("kernel as it is, %d-row tiles" % (H.MAX_TILE_ROWS
                                                            // 2),
                        runs[0][1], H.MAX_TILE_ROWS // 2))
        tiles = H.MAX_TILE_ROWS
        for name, lib, tile in runs:
            H.MAX_TILE_ROWS = tile
            H._group_plan.cache_clear()
            for symbol, rows in (("lgbm_histogram_f32", gh),
                                 ("lgbm_histogram_i8", gh8)):
                parts = []
                for label, bins, ix, cold, reps in cases:
                    run = caller(H, torch, lib, symbol, bins, rows, B, ix)
                    ms = timed_ms(torch, run, reps, cold)
                    got = run().clone()
                    key = (symbol, label)
                    if key not in ref:
                        ref[key] = got
                        note = ""
                    elif "(wrong)" in name:
                        note = ""
                    else:
                        same = torch.equal(got.view(torch.int32),
                                           ref[key].view(torch.int32))
                        if not same and symbol.endswith("i8"):
                            raise SystemExit("variant %r: int8 sums differ"
                                             % name)
                        note = "" if same else " (other f32 order)"
                    parts.append("%s %.4f ms%s" % (label, ms, note))
                print("%-55s %-5s %s" % (name, symbol.split("_")[-1],
                                         "; ".join(parts)), flush=True)
        H.MAX_TILE_ROWS = tiles
        H._group_plan.cache_clear()
        fn = next(iter(libs.values())).lgbm_sum_only_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream().cuda_stream
        for blocks in (132, 98, 10):
            scratch = torch.randn(blocks, Fp, B, 4, device="cuda")
            out = torch.empty(Fp, B, 4, device="cuda")
            ms = timed_ms(torch, lambda: fn(scratch.data_ptr(),
                                            out.data_ptr(), blocks,
                                            Fp * B * 4, stream), 20, False)
            print("block-order sum pass alone, %d partials: %.4f ms"
                  % (blocks, ms), flush=True)
    print("chip_variants seconds: %.1f" % (time.perf_counter() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
