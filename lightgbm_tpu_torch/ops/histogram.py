"""Histogram construction — the hot op of GBDT training.

Port of ``lightgbm_tpu/ops/histogram.py``. The TPU package runs the
Pallas kernel ``_hist_kernel_body``; here :func:`build_histogram` runs
the hand-written CUDA kernel ``csrc/histogram.cu`` (uint8 bins; its
uint16 build ``csrc/histogram_u16.cu`` for ``max_bin > 255``) on CUDA
tensors and its plain PyTorch version (:func:`histogram_plain`, a flat
``index_add_`` mirroring ``_segment_histogram``) on CPU tensors. Each
bin type has four instances: f32 rows into f32 sums, f32 rows into f64
sums rounded once to f32 (``tpu_use_f64_hist``), and int8 and int16
rows into int32 sums. Which
one runs depends only on where the tensors lie: a CUDA tensor reaches
the kernel or an exception, never the plain version.

    hist[f, b, c] = sum_t [bins[t, f] == b] * gh[t, c]

:func:`launch_plan` sizes the kernel's launch (feature groups, tile rows,
blocks, shared memory, scratch) from the shapes alone, so the CPU tests
can check it.

A row-index list may come with its length as a one-element int32
tensor on the device (``count``): the kernel's device-count entry then
reads the length itself and plans its row blocks on the device
(:func:`device_plan`, the same arithmetic as :func:`launch_plan`), so
the learner's split step launches it without a host read, and a CUDA
graph can replay the step. Both entries give the same bytes for the
same rows.

Launches are counted twice: :data:`launch_counts` on the host, where the
wrapper launches (a graph runs the wrapper once, at capture), and a
device counter per instance that the kernel itself bumps, so that graph
replays count too (:func:`device_launch_counts`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..utils.log import LightGBMError
from .quantize import acc_dtype as quant_acc_dtype

def _instances():
    """The kernel's instances: (bins dtype, gh dtype, f64 sums) ->
    (launch count name, C entry, output dtype, accumulator dtype,
    library); uint16 bins (max_bin > 255) take the library built from
    histogram_u16.cu."""
    out = {}
    for bins, lib, pre in ((torch.uint8, "histogram", ""),
                           (torch.uint16, "histogram_u16", "u16_")):
        for gh, f64, tag, out_dtype, acc in (
                (torch.float32, False, "f32", torch.float32, torch.float32),
                (torch.float32, True, "f64", torch.float32, torch.float64),
                (torch.int8, False, "i8", torch.int32, torch.int32),
                (torch.int16, False, "i16", torch.int32, torch.int32)):
            out[(bins, gh, f64)] = ("histogram_" + pre + tag,
                                    "lgbm_histogram_" + pre + tag,
                                    out_dtype, acc, lib)
    return out


_KERNEL_OF = _instances()

#: kernel launches per instance since the last :func:`reset_launch_counts`
#: (the wrapper adds one exactly where it launches its kernel; a graph
#: capture counts once, its replays not at all)
launch_counts: Dict[str, int] = {v[0]: 0 for v in _KERNEL_OF.values()}
#: the device counters, one uint64 per (instance, device): the kernel adds
#: one on every launch, replays of a captured graph included
_device_counters: Dict[Tuple[str, int], torch.Tensor] = {}

_GH_DTYPES = (torch.float32, torch.int8, torch.int16)
_MAX_C = 8
#: bins per histogram at most, by bin dtype
_MAX_B = {torch.uint8: 256, torch.uint16: 65536}

#: shared memory one block may use on an H100 (bytes)
MAX_SMEM = 232448
#: warps per block (csrc/histogram.cu kWarps); each owns Fg / 16
#: (feature, slab) pairs, or shares them (WHOLE_FEATURE_GROUPS)
WARPS = 16
#: (feature, slab) pairs of one group: the kernel has instances for 1 and
#: 2 pairs per warp
GROUP_FEATURES = (16, 32)
#: the same for the integer instances over uint16 bins (a whole feature
#: per pair): a warp takes two pairs (one at Fg = 1) and
#: 32 / Fg warps share them by runs of 32-row chunks, adding with shared
#: atomics
WHOLE_FEATURE_GROUPS = (1, 2, 4, 8) + GROUP_FEATURES
#: bins per slab at most for float rows over uint16 bins (csrc/histogram.cu
#: kSlab): a feature of B > 256 bins is cut into ceil(B / 256) slabs, each
#: owned by one warp
SLAB_BINS = 256
#: rows staged per tile: at most this, at least MIN_TILE_ROWS
MAX_TILE_ROWS = 1024
MIN_TILE_ROWS = 128
#: a block takes at least this many rows (a child of a few thousand rows
#: gets a few blocks; one block writes the output directly)
MIN_ROWS_PER_BLOCK = 1024
#: the same for every instance over uint16 bins and the f64 sums: a
#: 10k-row child takes 40 blocks, not 10, for up to half its time on an
#: H100 (chip_variants.py)
MIN_ROWS_PER_BLOCK_WIDE = 256
#: entries of a warp's slab queue per pair (csrc/histogram.cu kQueue), 4
#: bytes each: the float instances over uint16 bins
QUEUE_ENTRIES = 64


def device_plan(n: int, num_sms: int, groups: int,
                min_rows: int = MIN_ROWS_PER_BLOCK) -> Tuple[int, int]:
    """(row blocks, rows per block) that the device-count entry derives
    in each block from the row count n read from device memory
    (``csrc/histogram.cu`` ``plan_blocks``, called by ``hist_rows_kernel``
    and ``hist_sum_kernel``): the arithmetic of :func:`launch_plan` over
    a grid of ``num_sms // groups`` row blocks of ``min_rows`` rows at
    least (the plan's); n = 0 gives one block of no rows (a zero
    histogram)."""
    max_blocks = max(1, num_sms // groups)
    if n <= 0:
        return 1, 0
    blocks = max(1, min(max_blocks, -(-n // min_rows)))
    per_block = -(-n // blocks)
    return -(-n // per_block), per_block


class LaunchPlan(NamedTuple):
    """How one call of ``csrc/histogram.cu`` is laid out."""
    groups: int                 # groups of (feature, slab) pairs
    #                             (blockIdx.y)
    features_per_group: int     # Fg, 16 or 32 pairs (also 1, 2, 4 or 8
    #                             for integer rows over uint16 bins); the
    #                             last group may hold fewer (with one
    #                             slab a pair is a feature)
    warps: int                  # warps per block
    tile_rows: int              # rows staged per tile (double-buffered)
    blocks: int                 # row blocks (blockIdx.x)
    rows_per_block: int
    smem_bytes: int             # dynamic shared memory per block
    scratch_shape: Optional[Tuple[int, int, int, int]]  # per-block
    #                             partials [blocks, Fp, B, C]; None for one
    #                             block (it writes the output itself)
    slab_bins: int              # SB bins per slab (_slab_bins)
    slabs: int                  # slabs per feature, ceil(B / SB)
    stage_features: int         # Fs: features staged per tile row
    min_rows: int               # rows a block takes at least

    def feature_ranges(self, Fp: int) -> List[Tuple[int, int]]:
        """[begin, end) of the features each group stages (with one slab,
        its own features; with more, a feature's slabs may span two
        groups)."""
        return [_group_features(k, self.features_per_group, self.slabs, Fp)
                for k in range(self.groups)]


def _group_features(g: int, fg: int, slabs: int, Fp: int) -> Tuple[int, int]:
    """[begin, end) of group g's features (``csrc/histogram.cu``
    ``group_features``)."""
    p0, p1 = g * fg, min((g + 1) * fg, Fp * slabs)
    return p0 // slabs, (p1 - 1) // slabs + 1


def launch_plan(S: int, Fp: int, B: int, C: int, gh_dtype: torch.dtype,
                num_sms: int, bins_dtype: torch.dtype = torch.uint8,
                f64: bool = False) -> LaunchPlan:
    """The kernel's launch for S rows of Fp features, B bins and C stats.

    A feature's B bins are cut into slabs of SB bins (:func:`_slab_bins`:
    ``min(B, 256)`` for float rows over uint16 bins, a whole feature for
    integer rows where it fits); a block holds the [Fg, SB, C]
    accumulators of its group's Fg (feature, slab) pairs (4 bytes each,
    8 with ``f64``; rounded up to 16 bytes) and two tiles of
    ``tile_rows`` rows (the group's features' bins and C gh values each)
    in shared memory, and with float rows over uint16 bins a slab queue
    of ``QUEUE_ENTRIES`` 4-byte entries per pair. Groups are as few as
    fit (one at the main path's Fp = 32, B = 256, C = 4: 128 KB of
    accumulators beside 96 KB of tiles; four at B = 1024 with uint16
    bins: 32 pairs of 256-bin slabs for float rows, 8 whole features for
    integer rows); row blocks are at most one per SM across the groups
    and take at least ``MIN_ROWS_PER_BLOCK`` rows each
    (``MIN_ROWS_PER_BLOCK_WIDE`` over uint16 bins or with f64 sums).
    Raises ``LightGBMError``
    for a shape the kernel does not take (f64 sums at 256-bin slabs fit
    at most 6 stat columns; the learner's rows have 4)."""
    if gh_dtype not in _GH_DTYPES:
        raise LightGBMError("histogram kernel takes float32 or int8/int16 "
                            "gh rows, got %s" % gh_dtype)
    if bins_dtype not in _MAX_B:
        raise LightGBMError("histogram kernel takes uint8 or uint16 bins, "
                            "got %s" % bins_dtype)
    if Fp <= 0 or Fp % 8 != 0:
        raise LightGBMError("histogram kernel needs the feature axis "
                            "padded to a multiple of 8, got %d" % Fp)
    if not (1 <= C <= _MAX_C):
        raise LightGBMError("histogram kernel takes 1..%d stat columns, "
                            "got %d" % (_MAX_C, C))
    if not (1 <= B <= _MAX_B[bins_dtype]):
        raise LightGBMError("histogram kernel takes at most %d bins, got "
                            "%d" % (_MAX_B[bins_dtype], B))
    if S < 1 or num_sms < 1:
        raise LightGBMError("histogram launch plan needs rows and SMs, got "
                            "S=%d num_sms=%d" % (S, num_sms))
    floating = gh_dtype.is_floating_point
    groups, fg, tile, smem, sb, slabs, fs = _group_plan(
        Fp, B, C, C * gh_dtype.itemsize, bins_dtype.itemsize,
        8 if f64 and floating else 4, floating)
    min_rows = (MIN_ROWS_PER_BLOCK_WIDE if bins_dtype == torch.uint16
                or (floating and f64) else MIN_ROWS_PER_BLOCK)
    blocks = max(1, min(num_sms // groups, -(-S // min_rows)))
    per_block = -(-S // blocks)
    blocks = -(-S // per_block)
    return LaunchPlan(groups=groups, features_per_group=fg, warps=WARPS,
                      tile_rows=tile, blocks=blocks,
                      rows_per_block=per_block, smem_bytes=smem,
                      scratch_shape=(blocks, Fp, B, C) if blocks > 1
                      else None, slab_bins=sb, slabs=slabs,
                      stage_features=fs, min_rows=min_rows)


def _round16(n: int) -> int:
    """Accumulator bytes rounded up so that the tiles after them start
    16-byte aligned (``csrc/histogram.cu`` ``acc_bytes_of``)."""
    return -(-n // 16) * 16


def _slab_bins(B: int, C: int, gh_bytes: int, bin_bytes: int,
               floating: bool) -> int:
    """Bins per slab (``csrc/histogram.cu`` ``slab_bins``): B with uint8
    bins; min(B, 256) for float rows over uint16 bins; for integer rows
    over uint16 bins B where one feature's [C, B] int32 fits beside two
    tiles of ``MIN_TILE_ROWS`` rows of it (B <= 8192 at C = 4), else the
    largest power of two that fits."""
    if bin_bytes == 1:
        return B
    if floating:
        return min(B, SLAB_BINS)

    def fits(sb):
        return _round16(sb * C * 4) + 2 * MIN_TILE_ROWS * (
            bin_bytes + gh_bytes) <= MAX_SMEM
    if fits(B):
        return B
    sb = 1
    while 2 * sb < B and fits(2 * sb):
        sb *= 2
    return sb


@functools.lru_cache(maxsize=None)
def _group_plan(Fp: int, B: int, C: int, gh_bytes: int, bin_bytes: int,
                acc_bytes: int, floating: bool):
    """(groups, pairs per group, tile rows, shared bytes, slab bins,
    slabs, staged features) of a shape; the learner asks for one shape
    per training run. Float rows over uint16 bins take slab queues
    (``csrc/histogram.cu`` ``kQueued``); integer rows over uint16 bins a
    whole feature per pair where it fits, and groups of fewer than 16
    pairs (``kWholeFeature``)."""
    sb = _slab_bins(B, C, gh_bytes, bin_bytes, floating)
    slabs = -(-B // sb)
    pairs = Fp * slabs
    per_pair = sb * C * acc_bytes
    queued = floating and bin_bytes == 2
    sizes = (GROUP_FEATURES if floating or bin_bytes == 1
             else WHOLE_FEATURE_GROUPS)

    def staged(fg):
        # the tile row holds the widest group's features; with one slab
        # it is Fg wide (as many as the group may hold)
        if slabs == 1:
            return fg
        groups = -(-pairs // fg)
        return max(b - a for a, b in (_group_features(g, fg, slabs, Fp)
                                      for g in range(groups)))

    def smem(fg, rows):
        return (_round16(fg * per_pair)
                + (fg * QUEUE_ENTRIES * 4 if queued else 0)
                + 2 * rows * (staged(fg) * bin_bytes + gh_bytes))

    fits = [fg for fg in sizes if smem(fg, MIN_TILE_ROWS) <= MAX_SMEM]
    if not fits:
        raise LightGBMError("histogram kernel: B=%d C=%d does not fit in "
                            "shared memory" % (B, C))
    groups = -(-pairs // fits[-1])
    fg = min(f for f in fits if f * groups >= pairs)
    groups = -(-pairs // fg)
    fs = staged(fg)
    rows = (MAX_SMEM - smem(fg, 0)) // (2 * (fs * bin_bytes + gh_bytes))
    tile = min(MAX_TILE_ROWS, rows // 32 * 32)
    return groups, fg, tile, smem(fg, tile), sb, slabs, fs


def reset_launch_counts() -> None:
    """Zero the host counts and every device counter (an in-place fill,
    so a captured graph keeps counting into the same memory)."""
    for k in launch_counts:
        launch_counts[k] = 0
    for t in _device_counters.values():
        t.zero_()


def device_launch_counts() -> Dict[str, int]:
    """Kernel launches per instance since :func:`reset_launch_counts`, as
    the kernels counted them on their devices (graph replays included).
    Reads the counters back: a host sync."""
    out = dict.fromkeys(launch_counts, 0)
    for (name, _), t in _device_counters.items():
        out[name] += int(t.item())
    return out


def _device_counter(name: str, device: torch.device) -> torch.Tensor:
    """The instance's launch counter on ``device``, made at its first
    launch there. It must exist before a graph that launches the
    instance is captured: memory allocated while capturing belongs to
    the graph."""
    key = (name, device.index)
    t = _device_counters.get(key)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise LightGBMError("histogram launch counter of %s made while "
                                "a CUDA graph is captured: launch the "
                                "kernel once before capturing" % name)
        t = torch.zeros(1, dtype=torch.int64, device=device)
        _device_counters[key] = t
    return t


def acc_dtype(gh_dtype: torch.dtype, f64: bool = False) -> torch.dtype:
    """Accumulator per gh dtype: integer rows sum in int32 (the
    reference's default; ops/quantize.py caps the rows so the sums fit),
    floats keep f32 unless they are f64 or ``f64`` sums are asked for
    (``tpu_use_f64_hist``)."""
    if not gh_dtype.is_floating_point:
        return quant_acc_dtype(gh_dtype)
    return torch.float64 if f64 or gh_dtype == torch.float64 \
        else torch.float32


def bin_values(bins: torch.Tensor,
               idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 bin values of ``bins`` (rows ``idx`` where given). uint16
    bins are read through an int16 view (torch's uint16 is a limited
    dtype on the card) and masked back to 0..65535."""
    if bins.dtype == torch.uint16:
        v = bins.view(torch.int16)
        v = v if idx is None else v.index_select(0, idx.long())
        return v.long() & 0xFFFF
    v = bins if idx is None else bins.index_select(0, idx.long())
    return v.long()


def histogram_plain(bins: torch.Tensor, gh: torch.Tensor, num_bins: int,
                    idx: Optional[torch.Tensor] = None,
                    count: Optional[torch.Tensor] = None,
                    f64: bool = False) -> torch.Tensor:
    """Plain PyTorch version: one flat ``(f * B + bin)`` index and one
    ``index_add_``, the analogue of the reference's
    ``_segment_histogram``. Rows are summed in row order, as XLA's CPU
    segment_sum does, so on the CPU f32 results match it bit for bit.
    With ``count`` only the first ``count`` rows of ``idx`` are summed.
    A bin >= ``num_bins`` is skipped, as the kernel skips it. With
    ``f64`` float rows are summed in f64 and rounded to f32 once, as
    the reference does under ``tpu_use_f64_hist`` (integer rows ignore
    it: their sums are exact)."""
    if count is not None:
        idx = idx[:int(count)]
    b = bin_values(bins, idx)
    if idx is not None:
        gh = gh.index_select(0, idx.long())
    S, F = b.shape
    C = gh.shape[1]
    acc = acc_dtype(gh.dtype, f64)
    flat = (torch.arange(F, dtype=torch.int64, device=bins.device)[None, :]
            * num_bins + b)
    # a bin >= num_bins is skipped, as the kernel skips it: its rows go to
    # one trash row past the histogram
    flat = torch.where(b < num_bins, flat, F * num_bins).reshape(-1)
    vals = gh.to(acc)[:, None, :].expand(S, F, C).reshape(-1, C)
    out = torch.zeros(F * num_bins + 1, C, dtype=acc, device=bins.device)
    out.index_add_(0, flat, vals)
    out = out[:-1].view(F, num_bins, C)
    if f64 and gh.dtype == torch.float32:
        out = out.to(torch.float32)
    return out


def _check_cuda_args(bins, gh, num_bins, idx, count=None) -> None:
    if bins.dtype not in _MAX_B:
        raise LightGBMError("histogram kernel takes uint8 or uint16 bins, "
                            "got %s" % bins.dtype)
    if gh.dtype not in _GH_DTYPES:
        raise LightGBMError("histogram kernel takes float32 or int8/int16 "
                            "gh rows, got %s" % gh.dtype)
    if bins.dim() != 2 or gh.dim() != 2 or gh.shape[0] != bins.shape[0]:
        raise LightGBMError("histogram kernel needs bins [N, F] and gh "
                            "[N, C]; got %s and %s"
                            % (tuple(bins.shape), tuple(gh.shape)))
    if bins.shape[1] % 8 != 0:
        raise LightGBMError("histogram kernel needs the feature axis "
                            "padded to a multiple of 8, got %d"
                            % bins.shape[1])
    if not (1 <= gh.shape[1] <= _MAX_C):
        raise LightGBMError("histogram kernel takes 1..%d stat columns, "
                            "got %d" % (_MAX_C, gh.shape[1]))
    if not (1 <= num_bins <= _MAX_B[bins.dtype]):
        raise LightGBMError("histogram kernel takes at most %d bins, got "
                            "%d" % (_MAX_B[bins.dtype], num_bins))
    if count is not None and (idx is None or count.dtype != torch.int32
                              or count.numel() != 1):
        raise LightGBMError("histogram kernel takes a row count as a "
                            "one-element int32 tensor beside a row-index "
                            "list")
    tensors = [bins, gh] + [t for t in (idx, count) if t is not None]
    for t in tensors:
        if t.device != bins.device:
            raise LightGBMError("histogram inputs lie on different "
                                "devices")
        if not t.is_contiguous():
            raise LightGBMError("histogram kernel needs contiguous inputs")
    if bins.data_ptr() % 8 != 0:
        raise LightGBMError("histogram kernel needs 8-byte aligned bins")
    if idx is not None and (idx.dtype != torch.int32 or idx.dim() != 1):
        raise LightGBMError("histogram kernel takes an int32 [S] row "
                            "index list, got %s %s"
                            % (idx.dtype, tuple(idx.shape)))


def histogram_cuda(bins: torch.Tensor, gh: torch.Tensor, num_bins: int,
                   idx: Optional[torch.Tensor] = None,
                   count: Optional[torch.Tensor] = None,
                   f64: bool = False) -> torch.Tensor:
    """Launch ``csrc/histogram.cu`` (uint8 bins) or its uint16 build
    ``csrc/histogram_u16.cu`` on PyTorch's current stream. With a host
    row count (no ``count``) the launch is laid out by
    :func:`launch_plan`; with ``count`` (the length of ``idx``'s list, a
    one-element int32 tensor on the device) the device-count entry plans
    it on the device. The kernel writes the whole output, so it is
    allocated empty, as is the scratch for the per-block partials (of
    the accumulator dtype: f64 with ``f64``)."""
    _check_cuda_args(bins, gh, num_bins, idx, count)
    f64 = bool(f64) and gh.dtype.is_floating_point
    name, symbol, out_dtype, acc, lib = _KERNEL_OF[(bins.dtype, gh.dtype,
                                                    f64)]
    F, C = bins.shape[1], gh.shape[1]
    S = bins.shape[0] if idx is None else idx.shape[0]
    if S == 0:
        return torch.zeros((F, num_bins, C), dtype=out_dtype,
                           device=bins.device)
    num_sms = _num_sms(bins.device)
    plan = launch_plan(S, F, num_bins, C, gh.dtype, num_sms, bins.dtype,
                       f64)
    out = torch.empty((F, num_bins, C), dtype=out_dtype, device=bins.device)
    counter = _device_counter(name, bins.device)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    # the ctypes entries launch on the thread's current device: make it
    # the tensors' one
    with torch.cuda.device(bins.device):
        if count is None:
            scratch = (None if plan.scratch_shape is None else
                       torch.empty(plan.scratch_shape, dtype=acc,
                                   device=bins.device))
            code = _kernel_fn(lib, symbol)(
                bins.data_ptr(), gh.data_ptr(),
                None if idx is None else idx.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                counter.data_ptr(), S, F, num_bins, C,
                plan.features_per_group, plan.groups, plan.stage_features,
                plan.tile_rows, plan.blocks, plan.rows_per_block,
                plan.smem_bytes, stream)
        else:
            max_blocks = max(1, num_sms // plan.groups)
            scratch = (None if max_blocks == 1 else
                       torch.empty((max_blocks, F, num_bins, C),
                                   dtype=acc, device=bins.device))
            code = _kernel_fn(lib, symbol + "_dev")(
                bins.data_ptr(), gh.data_ptr(), idx.data_ptr(),
                count.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                counter.data_ptr(), F, num_bins, C,
                plan.features_per_group, plan.groups, plan.stage_features,
                plan.tile_rows, max_blocks, plan.min_rows,
                plan.smem_bytes, stream)
    launch_counts[name] += 1
    if code != 0:
        raise LightGBMError("histogram kernel launch failed: %s (cuda "
                            "error %d)" % (_error_string(code), code))
    return out


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _kernel_fn(lib_name: str, symbol: str):
    from .. import csrc
    lib = csrc.load(lib_name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if symbol.endswith("_dev"):
            # bins, gh, idx, count, out, scratch, launches; Fp, B, C, Fg,
            # groups, Fs, T, max_blocks, min_rows, smem; stream
            fn.argtypes = [vp] * 7 + [i32] * 10 + [vp]
        else:
            # bins, gh, idx, out, scratch, launches; S; Fp, B, C, Fg,
            # groups, Fs, T, blocks; rows_per_block; smem; stream
            fn.argtypes = [vp] * 6 + [i64] + [i32] * 8 + [i64, i32, vp]
        fn.restype = ctypes.c_int
    return fn


def _error_string(code: int) -> str:
    from .. import csrc
    fn = csrc.load("histogram").lgbm_cuda_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


def build_histogram(bins: torch.Tensor, gh: torch.Tensor, num_bins: int,
                    idx: Optional[torch.Tensor] = None,
                    count: Optional[torch.Tensor] = None,
                    f64: bool = False) -> torch.Tensor:
    """Accumulate (grad, hess, counts) per (feature, bin).

    bins : uint8 or uint16 [N, F] (F a multiple of 8 on CUDA)
    gh : f32, int8 or int16 [N, C], C <= 8
    idx : optional int32 [S] row-index list; only those rows are summed
    count : optional one-element int32 tensor on idx's device: only the
        first ``count`` rows of idx are summed (on CUDA the kernel reads it
        there, so the caller needs no host read)
    f64 : sum f32 rows in f64 and round once to f32 (the reference's
        ``tpu_use_f64_hist``; ignored for integer rows)
    Returns [F, num_bins, C] f32 (int32 for integer gh).
    """
    if bins.device.type == "cpu":
        return histogram_plain(bins, gh, num_bins, idx, count, f64)
    if bins.device.type == "cuda":
        return histogram_cuda(bins, gh, num_bins, idx, count, f64)
    raise LightGBMError("no histogram kernel for device %s" % bins.device)


def subtract_histogram(parent: torch.Tensor,
                       child: torch.Tensor) -> torch.Tensor:
    """Sibling histogram by subtraction (reference:
    serial_tree_learner.cpp ``larger.Subtract(smaller)``)."""
    return parent - child


def unpack_bundle_histogram(bhist: torch.Tensor, gidx_g: torch.Tensor,
                            gidx_b: torch.Tensor, zero_fix: torch.Tensor,
                            zero_bins: torch.Tensor,
                            totals: torch.Tensor) -> torch.Tensor:
    """Bundle histogram [G, Bg, C] -> per-feature histogram [F, B, C]
    (port of the reference's ``unpack_bundle_histogram``; EFB, after
    FixHistogram, src/io/dataset.cpp).

    A feature's bins gather from its bundle sub-range by the static
    tables ``gidx_g`` / ``gidx_b`` ([F, B], -1 = no source); a feature
    of a multi-member bundle (``zero_fix``) gets its zero bin as the
    leaf's totals minus the sum of its other bins. ``totals`` is [C],
    or [F, C] per feature. Integer (quantized) histograms subtract
    exactly in their own dtype; f32 ones subtract in f64 and round once,
    so the result is the same on every device."""
    G, Bg, C = bhist.shape
    has = gidx_g >= 0
    flat = (gidx_g.clamp(min=0).long() * Bg + gidx_b.long()).view(-1)
    hist = bhist.reshape(G * Bg, C).index_select(0, flat).view(
        *gidx_g.shape, C)
    zero = torch.zeros((), dtype=bhist.dtype, device=bhist.device)
    hist = torch.where(has[..., None], hist, zero)
    tot = totals if totals.dim() == 2 else totals[None, :]
    if bhist.dtype.is_floating_point:
        resid = (tot.to(torch.float64)
                 - hist.to(torch.float64).sum(dim=1)).to(bhist.dtype)
    else:
        resid = tot.to(bhist.dtype) - hist.sum(dim=1, dtype=bhist.dtype)
    fix = torch.where(zero_fix[:, None], resid, zero)
    zb = zero_bins.long().view(-1, 1, 1).expand(-1, 1, C)
    return hist.scatter_add(1, zb, fix[:, None, :])
