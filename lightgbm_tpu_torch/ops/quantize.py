"""Gradient discretization for quantized histogram training.

Port of ``lightgbm_tpu/ops/quantize.py`` (reference: LightGBM's
``use_quantized_grad``, src/treelearner/gradient_discretizer.cpp). Per
tree:

- ``g_scale = max(max|g|, 1e-30) / qmax``, ``h_scale`` likewise, over
  the in-bag rows, in f32;
- stochastic rounding ``q = floor(x / scale + u)``, ``u ~ U[0, 1)``,
  clipped to ``[-qmax, qmax]``; the draw is ``uniform(key, (N, 2))`` on
  the unpadded ``N`` rows under the tree's key, with the port's
  threefry (``utils/prng.py``), so the integers equal the reference's
  byte for byte;
- histograms accumulate the integer rows in int32, which makes every
  bin sum order-invariant and the sibling subtraction exact; the split
  scan dequantizes once (``ops/split.py``).

Overflow: a leaf's channel sum is bounded by ``qmax * rows``.
:func:`effective_quant_max` caps ``qmax`` so that bound fits int32. The
reference lifts 16-bit rows to int64 accumulators only under
``jax_enable_x64``, which it runs without; the port keeps that default,
so both widths accumulate in int32 and share the cap.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import log
from ..utils.prng import fold_in, uniform

# avoid a zero divisor when an iteration's gradients are identically 0
kTinyScale = 1e-30

_INT32_MAX = 2 ** 31 - 1


def quant_dtype(bits: int) -> torch.dtype:
    """Row-vector dtype for a quant_grad_bits setting."""
    return torch.int8 if bits <= 8 else torch.int16


def acc_dtype(gh_dtype: torch.dtype) -> torch.dtype:
    """Histogram accumulator of integer gh rows: int32 for both widths
    (the reference's default, x64 off)."""
    return torch.int32


def effective_quant_max(bits: int, max_rows: int) -> int:
    """Largest per-row magnitude such that a sum over ``max_rows`` rows
    cannot overflow the int32 accumulator: ``2^(bits-1) - 1`` capped at
    ``(2^31 - 1) // max_rows``, and at least 1 (8-bit keeps 127 up to
    ~16.9M rows; 16-bit is capped past ~65.5k rows)."""
    qmax = (1 << (bits - 1)) - 1
    cap = _INT32_MAX // max(int(max_rows), 1)
    return max(min(qmax, cap), 1)


def quant_warn_capped(bits: int, qmax: int, max_rows: int) -> None:
    """One warning when the requested width was capped by the int32
    accumulator bound."""
    if qmax < (1 << (bits - 1)) - 1:
        log.warning("quant_grad_bits=%d capped to |q|<=%d for %d rows "
                    "(int32 histogram accumulation)"
                    % (bits, qmax, max_rows))


def quantize_gh(grad: torch.Tensor, hess: torch.Tensor, ind: torch.Tensor,
                key: torch.Tensor, qmax: int, dtype: torch.dtype
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Discretize per-row (grad, hess) to signed integers.

    grad, hess : f32 [N]
    ind : f32 [N] in-bag indicator (0/1)
    key : the tree's PRNG key (``utils/prng.py``)
    qmax : target magnitude (:func:`effective_quant_max`)
    dtype : row dtype (:func:`quant_dtype`)

    Returns (gh int [N, 4] = (q_grad, q_hess, in-bag, 1),
             qscale f32 [2] = (g_scale, h_scale)).
    """
    g = grad * ind
    h = hess * ind
    # every divisor is a tensor on the rows' device: CUDA turns a
    # division by a host scalar into a multiply by its reciprocal,
    # which rounds differently from the reference's f32 division (a
    # fill, not a copy from the host, which would wait for the card)
    qmaxf = torch.full((), float(qmax), dtype=torch.float32,
                       device=grad.device)
    gs = torch.clamp(g.abs().max(), min=kTinyScale) / qmaxf
    hs = torch.clamp(h.abs().max(), min=kTinyScale) / qmaxf
    u = uniform(key, (g.shape[0], 2))
    qg = torch.clamp(torch.floor(g / gs + u[:, 0]), -float(qmax),
                     float(qmax))
    qh = torch.clamp(torch.floor(h / hs + u[:, 1]), -float(qmax),
                     float(qmax))
    gh = torch.stack([qg, qh, ind, torch.ones_like(ind)], dim=1).to(dtype)
    return gh, torch.stack([gs, hs]).to(torch.float32)


def tree_key(base_key: torch.Tensor, tree_no: int) -> torch.Tensor:
    """Stochastic-rounding key of tree ``tree_no`` (1, 2, ...):
    ``fold_in(base, tree_no)``, the reference's counter sequence."""
    return fold_in(base_key, tree_no)


def sum_gh(gh: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    """Channel sums: integer rows sum exactly in int32; float rows in
    their own dtype, in the order of the reference's ``jnp.sum`` over
    its rows padded with zero rows to ``rows`` (:func:`xla_row_sum`)."""
    if not gh.dtype.is_floating_point:
        return gh.sum(dim=0, dtype=acc_dtype(gh.dtype))
    if rows is not None and rows > gh.shape[0]:
        gh = torch.nn.functional.pad(gh, (0, 0, 0, rows - gh.shape[0]))
    return xla_row_sum(gh)


#: rows per window of XLA's CPU TreeReductionRewriter
_XLA_REDUCE_WINDOW = 32


def xla_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of a [N, C] float tensor over its rows, added in the order of
    XLA's CPU build of ``jnp.sum(x, axis=0)``: its TreeReductionRewriter
    pads the rows with zeros to a multiple of 32 (split between the two
    ends, the odd one at the end) and sums each window of 32 consecutive
    rows in order, level by level until at most 32 rows are left, which
    it sums in order."""
    C, w = x.shape[1], _XLA_REDUCE_WINDOW
    while x.shape[0] > w:
        n = x.shape[0]
        m = -(-n // w) * w
        lo = (m - n) // 2
        x = torch.nn.functional.pad(x, (0, 0, lo, m - n - lo)).view(
            m // w, w, C)
        acc = x[:, 0].clone()
        for j in range(1, w):
            acc += x[:, j]
        x = acc
    acc = x[0].clone()
    for i in range(1, x.shape[0]):
        acc += x[i]
    return acc


def scale4(qscale: torch.Tensor) -> torch.Tensor:
    """[4] channel dequantization vector (g_scale, h_scale, 1, 1): the
    count channels are exact integers already."""
    return torch.cat([qscale.to(torch.float32),
                      torch.ones(2, dtype=torch.float32,
                                 device=qscale.device)])


def dequantize_sums(sums: torch.Tensor, qscale: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    """[.., 4] integer channel sums -> f32, one rounding per entry."""
    if sums.dtype.is_floating_point:
        return sums
    return sums.to(torch.float32) * scale4(qscale)


def dequantize_hist(hist: torch.Tensor,
                    qscale: Optional[torch.Tensor]) -> torch.Tensor:
    """[.., 4] histogram -> f32 for a split scan: integer histograms
    scale by (g_scale, h_scale, 1, 1), float histograms pass through
    (``qscale`` is None in exact mode). The reference wraps the product
    in an XLA ``optimization_barrier`` so that no compile contracts the
    scale into the scan's cumsums; eager torch materializes the product
    anyway and needs nothing."""
    if hist.dtype.is_floating_point:
        return hist
    return hist.to(torch.float32) * scale4(qscale)
