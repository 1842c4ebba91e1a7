"""Histogram construction — the hot op of GBDT training.

Port of ``lightgbm_tpu/ops/histogram.py``. The TPU package runs the
Pallas kernel ``_hist_kernel_body``; here :func:`build_histogram` runs
the hand-written CUDA kernel ``csrc/histogram.cu`` on CUDA tensors and
its plain PyTorch version (:func:`histogram_plain`, a flat
``index_add_`` mirroring ``_segment_histogram``) on CPU tensors. Which
one runs depends only on where the tensors lie: a CUDA tensor reaches
the kernel or an exception, never the plain version.

    hist[f, b, c] = sum_t [bins[t, f] == b] * gh[t, c]
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ..utils.log import LightGBMError
from .quantize import acc_dtype as quant_acc_dtype

#: kernel launches per instance since the last :func:`reset_launch_counts`
#: (the wrapper adds one exactly where it launches its kernel)
launch_counts: Dict[str, int] = {"histogram_f32": 0, "histogram_i8": 0,
                                 "histogram_i16": 0}

_KERNEL_OF = {torch.float32: ("histogram_f32", "lgbm_histogram_f32",
                              torch.float32),
              torch.int8: ("histogram_i8", "lgbm_histogram_i8",
                           torch.int32),
              torch.int16: ("histogram_i16", "lgbm_histogram_i16",
                            torch.int32)}
_MAX_C = 8
_MAX_B = 256


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def acc_dtype(gh_dtype: torch.dtype) -> torch.dtype:
    """Accumulator per gh dtype: integer rows sum in int32 (the
    reference's default; ops/quantize.py caps the rows so the sums fit),
    floats keep f32 unless they are f64."""
    if not gh_dtype.is_floating_point:
        return quant_acc_dtype(gh_dtype)
    return torch.float64 if gh_dtype == torch.float64 else torch.float32


def histogram_plain(bins: torch.Tensor, gh: torch.Tensor, num_bins: int,
                    idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: one flat ``(f * B + bin)`` index and one
    ``index_add_``, the analogue of the reference's
    ``_segment_histogram``. Rows are summed in row order, as XLA's CPU
    segment_sum does, so on the CPU f32 results match it bit for bit."""
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


def _check_cuda_args(bins, gh, num_bins, idx) -> None:
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
    tensors = [bins, gh] + ([idx] if idx is not None else [])
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
                   idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``csrc/histogram.cu`` on PyTorch's current stream. The
    output is allocated zeroed here (the kernel adds into it)."""
    _check_cuda_args(bins, gh, num_bins, idx)
    name, symbol, out_dtype = _KERNEL_OF[gh.dtype]
    F, C = bins.shape[1], gh.shape[1]
    S = bins.shape[0] if idx is None else idx.shape[0]
    out = torch.zeros((F, num_bins, C), dtype=out_dtype, device=bins.device)
    if S == 0:
        return out
    fn = _kernel_fn(symbol)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    code = fn(bins.data_ptr(), gh.data_ptr(),
              None if idx is None else idx.data_ptr(), out.data_ptr(),
              S, F, num_bins, C, stream)
    launch_counts[name] += 1
    if code != 0:
        raise LightGBMError("histogram kernel launch failed: %s (cuda "
                            "error %d)" % (_error_string(code), code))
    return out


def _kernel_fn(symbol: str):
    from .. import csrc
    lib = csrc.load("histogram")
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return fn


def _error_string(code: int) -> str:
    from .. import csrc
    fn = csrc.load("histogram").lgbm_cuda_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


def build_histogram(bins: torch.Tensor, gh: torch.Tensor, num_bins: int,
                    idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Accumulate (grad, hess, counts) per (feature, bin).

    bins : uint8 [N, F] (F a multiple of 8 on CUDA)
    gh : f32, int8 or int16 [N, C], C <= 8
    idx : optional int32 [S] row-index list; only those rows are summed
    Returns [F, num_bins, C] f32 (int32 for integer gh).
    """
    if bins.device.type == "cpu":
        return histogram_plain(bins, gh, num_bins, idx)
    if bins.device.type == "cuda":
        return histogram_cuda(bins, gh, num_bins, idx)
    raise LightGBMError("no histogram kernel for device %s" % bins.device)


def subtract_histogram(parent: torch.Tensor,
                       child: torch.Tensor) -> torch.Tensor:
    """Sibling histogram by subtraction (reference:
    serial_tree_learner.cpp ``larger.Subtract(smaller)``)."""
    return parent - child
