"""Histogram construction — the hot op of GBDT training.

Port of ``lightgbm_tpu/ops/histogram.py``. The TPU package runs the
Pallas kernel ``_hist_kernel_body``; here :func:`build_histogram` runs
the hand-written CUDA kernel ``csrc/histogram.cu`` on CUDA tensors and
its plain PyTorch version (:func:`histogram_plain`, a flat
``index_add_`` mirroring ``_segment_histogram``) on CPU tensors. Which
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

#: kernel launches per instance since the last :func:`reset_launch_counts`
#: (the wrapper adds one exactly where it launches its kernel; a graph
#: capture counts once, its replays not at all)
launch_counts: Dict[str, int] = {"histogram_f32": 0, "histogram_i8": 0,
                                 "histogram_i16": 0}
#: the device counters, one uint64 per (instance, device): the kernel adds
#: one on every launch, replays of a captured graph included
_device_counters: Dict[Tuple[str, int], torch.Tensor] = {}

_KERNEL_OF = {torch.float32: ("histogram_f32", "lgbm_histogram_f32",
                              torch.float32),
              torch.int8: ("histogram_i8", "lgbm_histogram_i8",
                           torch.int32),
              torch.int16: ("histogram_i16", "lgbm_histogram_i16",
                            torch.int32)}
_MAX_C = 8
_MAX_B = 256

#: shared memory one block may use on an H100 (bytes)
MAX_SMEM = 232448
#: warps per block (csrc/histogram.cu kWarps); each owns Fg / 16 features
WARPS = 16
#: features of one group: the kernel has instances for 1 and 2 features
#: per warp
GROUP_FEATURES = (16, 32)
#: rows staged per tile: at most this, at least MIN_TILE_ROWS
MAX_TILE_ROWS = 1024
MIN_TILE_ROWS = 128
#: a block takes at least this many rows (a child of a few thousand rows
#: gets a few blocks; one block writes the output directly)
MIN_ROWS_PER_BLOCK = 1024


def device_plan(n: int, num_sms: int, groups: int) -> Tuple[int, int]:
    """(row blocks, rows per block) that the device-count entry derives
    in each block from the row count n read from device memory
    (``csrc/histogram.cu`` ``plan_blocks``, called by ``hist_rows_kernel``
    and ``hist_sum_kernel``): the arithmetic of :func:`launch_plan` over
    a grid of ``num_sms // groups`` row blocks; n = 0 gives one block of
    no rows (a zero histogram)."""
    max_blocks = max(1, num_sms // groups)
    if n <= 0:
        return 1, 0
    blocks = max(1, min(max_blocks, -(-n // MIN_ROWS_PER_BLOCK)))
    per_block = -(-n // blocks)
    return -(-n // per_block), per_block


class LaunchPlan(NamedTuple):
    """How one call of ``csrc/histogram.cu`` is laid out."""
    groups: int                 # feature groups (blockIdx.y)
    features_per_group: int     # Fg, 16 or 32; the last group may hold
    #                             fewer features
    warps: int                  # warps per block
    tile_rows: int              # rows staged per tile (double-buffered)
    blocks: int                 # row blocks (blockIdx.x)
    rows_per_block: int
    smem_bytes: int             # dynamic shared memory per block
    scratch_shape: Optional[Tuple[int, int, int, int]]  # per-block
    #                             partials [blocks, Fp, B, C]; None for one
    #                             block (it writes the output itself)

    def feature_ranges(self, Fp: int) -> List[Tuple[int, int]]:
        """[begin, end) of each group's features."""
        g = self.features_per_group
        return [(k * g, min((k + 1) * g, Fp)) for k in range(self.groups)]


def launch_plan(S: int, Fp: int, B: int, C: int, gh_dtype: torch.dtype,
                num_sms: int) -> LaunchPlan:
    """The kernel's launch for S rows of Fp features, B bins and C stats.

    A block holds the [Fg, B, C] 4-byte accumulators of its feature group
    and two tiles of ``tile_rows`` rows (Fg bin bytes and C gh values
    each) in shared memory. Groups are as few as fit (one at the main
    path's Fp = 32, B = 256, C = 4: 128 KB of accumulators beside 96 KB
    of tiles); row blocks are at most one per SM across the groups and
    take at least ``MIN_ROWS_PER_BLOCK`` rows each. Raises
    ``LightGBMError`` for a shape the kernel does not take."""
    if gh_dtype not in _KERNEL_OF:
        raise LightGBMError("histogram kernel takes float32 or int8/int16 "
                            "gh rows, got %s" % gh_dtype)
    if Fp <= 0 or Fp % 8 != 0:
        raise LightGBMError("histogram kernel needs the feature axis "
                            "padded to a multiple of 8, got %d" % Fp)
    if not (1 <= C <= _MAX_C):
        raise LightGBMError("histogram kernel takes 1..%d stat columns, "
                            "got %d" % (_MAX_C, C))
    if not (1 <= B <= _MAX_B):
        raise LightGBMError("histogram kernel takes at most %d bins, got "
                            "%d" % (_MAX_B, B))
    if S < 1 or num_sms < 1:
        raise LightGBMError("histogram launch plan needs rows and SMs, got "
                            "S=%d num_sms=%d" % (S, num_sms))
    groups, fg, tile, smem = _group_plan(Fp, B, C, C * gh_dtype.itemsize)
    blocks = max(1, min(num_sms // groups, -(-S // MIN_ROWS_PER_BLOCK)))
    per_block = -(-S // blocks)
    blocks = -(-S // per_block)
    return LaunchPlan(groups=groups, features_per_group=fg, warps=WARPS,
                      tile_rows=tile, blocks=blocks,
                      rows_per_block=per_block, smem_bytes=smem,
                      scratch_shape=(blocks, Fp, B, C) if blocks > 1
                      else None)


@functools.lru_cache(maxsize=None)
def _group_plan(Fp: int, B: int, C: int, gh_bytes: int):
    """(groups, features per group, tile rows, shared bytes) of a shape;
    the learner asks for one shape per training run."""
    per_feature = B * C * 4

    def smem(fg, rows):
        return fg * per_feature + 2 * rows * (fg + gh_bytes)

    fits = [fg for fg in GROUP_FEATURES
            if smem(fg, MIN_TILE_ROWS) <= MAX_SMEM]
    if not fits:
        raise LightGBMError("histogram kernel: B=%d C=%d does not fit in "
                            "shared memory" % (B, C))
    groups = -(-Fp // fits[-1])
    fg = min(f for f in fits if f * groups >= Fp)
    rows = (MAX_SMEM - fg * per_feature) // (2 * (fg + gh_bytes))
    tile = min(MAX_TILE_ROWS, rows // 32 * 32)
    return groups, fg, tile, smem(fg, tile)


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


def acc_dtype(gh_dtype: torch.dtype) -> torch.dtype:
    """Accumulator per gh dtype: integer rows sum in int32 (the
    reference's default; ops/quantize.py caps the rows so the sums fit),
    floats keep f32 unless they are f64."""
    if not gh_dtype.is_floating_point:
        return quant_acc_dtype(gh_dtype)
    return torch.float64 if gh_dtype == torch.float64 else torch.float32


def histogram_plain(bins: torch.Tensor, gh: torch.Tensor, num_bins: int,
                    idx: Optional[torch.Tensor] = None,
                    count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: one flat ``(f * B + bin)`` index and one
    ``index_add_``, the analogue of the reference's
    ``_segment_histogram``. Rows are summed in row order, as XLA's CPU
    segment_sum does, so on the CPU f32 results match it bit for bit.
    With ``count`` only the first ``count`` rows of ``idx`` are summed."""
    if count is not None:
        idx = idx[:int(count)]
    if idx is not None:
        bins = bins[idx.long()]
        gh = gh[idx.long()]
    S, F = bins.shape
    C = gh.shape[1]
    acc = acc_dtype(gh.dtype)
    flat = (torch.arange(F, dtype=torch.int64, device=bins.device)[None, :]
            * num_bins + bins.long()).reshape(-1)
    vals = gh.to(acc)[:, None, :].expand(S, F, C).reshape(-1, C)
    out = torch.zeros(F * num_bins, C, dtype=acc, device=bins.device)
    out.index_add_(0, flat, vals)
    return out.view(F, num_bins, C)


def _check_cuda_args(bins, gh, num_bins, idx, count=None) -> None:
    if bins.dtype != torch.uint8:
        raise LightGBMError("histogram kernel takes uint8 bins, got %s"
                            % bins.dtype)
    if gh.dtype not in _KERNEL_OF:
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
    if not (1 <= num_bins <= _MAX_B):
        raise LightGBMError("histogram kernel takes at most %d bins, got "
                            "%d" % (_MAX_B, num_bins))
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
                   count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``csrc/histogram.cu`` on PyTorch's current stream. With a
    host row count (no ``count``) the launch is laid out by
    :func:`launch_plan`; with ``count`` (the length of ``idx``'s list,
    a one-element int32 tensor on the device) the device-count entry
    plans it on the device. The kernel writes the whole output, so it is
    allocated empty, as is the scratch for the per-block partials."""
    _check_cuda_args(bins, gh, num_bins, idx, count)
    name, symbol, out_dtype = _KERNEL_OF[gh.dtype]
    F, C = bins.shape[1], gh.shape[1]
    S = bins.shape[0] if idx is None else idx.shape[0]
    if S == 0:
        return torch.zeros((F, num_bins, C), dtype=out_dtype,
                           device=bins.device)
    num_sms = _num_sms(bins.device)
    plan = launch_plan(S, F, num_bins, C, gh.dtype, num_sms)
    out = torch.empty((F, num_bins, C), dtype=out_dtype, device=bins.device)
    counter = _device_counter(name, bins.device)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    if count is None:
        scratch = (None if plan.scratch_shape is None else
                   torch.empty(plan.scratch_shape, dtype=out_dtype,
                               device=bins.device))
        code = _kernel_fn(symbol)(
            bins.data_ptr(), gh.data_ptr(),
            None if idx is None else idx.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            counter.data_ptr(), S, F, num_bins, C, plan.features_per_group,
            plan.groups, plan.tile_rows, plan.blocks, plan.rows_per_block,
            plan.smem_bytes, stream)
    else:
        max_blocks = max(1, num_sms // plan.groups)
        scratch = (None if max_blocks == 1 else
                   torch.empty((max_blocks, F, num_bins, C),
                               dtype=out_dtype, device=bins.device))
        code = _kernel_fn(symbol + "_dev")(
            bins.data_ptr(), gh.data_ptr(), idx.data_ptr(),
            count.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            counter.data_ptr(), F, num_bins, C, plan.features_per_group,
            plan.groups, plan.tile_rows, max_blocks, MIN_ROWS_PER_BLOCK,
            plan.smem_bytes, stream)
    launch_counts[name] += 1
    if code != 0:
        raise LightGBMError("histogram kernel launch failed: %s (cuda "
                            "error %d)" % (_error_string(code), code))
    return out


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _kernel_fn(symbol: str):
    from .. import csrc
    lib = csrc.load("histogram")
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if symbol.endswith("_dev"):
            # bins, gh, idx, count, out, scratch, launches; Fp, B, C, Fg,
            # groups, T, max_blocks, min_rows, smem; stream
            fn.argtypes = [vp] * 7 + [i32] * 9 + [vp]
        else:
            # bins, gh, idx, out, scratch, launches; S; Fp, B, C, Fg,
            # groups, T, blocks; rows_per_block; smem; stream
            fn.argtypes = [vp] * 6 + [i64] + [i32] * 7 + [i64, i32, vp]
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
                    count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Accumulate (grad, hess, counts) per (feature, bin).

    bins : uint8 [N, F] (F a multiple of 8 on CUDA)
    gh : f32, int8 or int16 [N, C], C <= 8
    idx : optional int32 [S] row-index list; only those rows are summed
    count : optional one-element int32 tensor on idx's device: only the
        first ``count`` rows of idx are summed (on CUDA the kernel reads it
        there, so the caller needs no host read)
    Returns [F, num_bins, C] f32 (int32 for integer gh).
    """
    if bins.device.type == "cpu":
        return histogram_plain(bins, gh, num_bins, idx, count)
    if bins.device.type == "cuda":
        return histogram_cuda(bins, gh, num_bins, idx, count)
    raise LightGBMError("no histogram kernel for device %s" % bins.device)


def subtract_histogram(parent: torch.Tensor,
                       child: torch.Tensor) -> torch.Tensor:
    """Sibling histogram by subtraction (reference:
    serial_tree_learner.cpp ``larger.Subtract(smaller)``)."""
    return parent - child
