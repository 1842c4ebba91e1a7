"""Per-leaf gradient statistics over a frozen forest (refit).

Port of ``lightgbm_tpu/ops/refit.py``, which is ``jnp`` (no Pallas): the
leaf of every row in every tree comes from one walk of the stacked
forest (``serve.StackedForest.leaves_device``), and each tree's per-leaf
gradient and hessian sums are f32 segment sums (``index_add_``; on the
card ``index_put_`` with ``accumulate``, whose sorted adds give the same
bits every run), the counterpart of the reference's
``jax.ops.segment_sum`` (also f32: the reference runs with x64 off). One
tree per call; the scores stay on the device between trees.
"""
from __future__ import annotations

from typing import Tuple

import torch


def refit_tree_step(score: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                    k: int, ti: int, leaf_ids: torch.Tensor,
                    old_vals: torch.Tensor, num_leaves: int,
                    l1: torch.Tensor, l2: torch.Tensor,
                    max_delta: torch.Tensor, shrinkage: torch.Tensor,
                    decay: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tree of the refit (reference ``_refit_tree_step``).

    score [n] (one class) or [n, K] f32 raw scores; g, h the gradients
    at ``score``; k the tree's class column, ti its index into the [T, n]
    int32 ``leaf_ids`` and the [T, NL] f32 ``old_vals``; l1, l2,
    max_delta (+inf when off), shrinkage, decay 0-d f32 tensors.

    Returns (new_vals [NL], score'): the regularized leaf optimum over
    the rows in each leaf, ``decay * old + (1 - decay) * shrinkage *
    optimum`` (reference: feature_histogram.hpp
    CalculateSplittedLeafOutput; config.h:524 refit_decay_rate), an
    empty leaf keeping its old value; the scores plus the tree's new
    values.
    """
    ids = leaf_ids[ti].long()
    old = old_vals[ti]
    gk = g if g.dim() == 1 else g[:, k]
    hk = h if h.dim() == 1 else h[:, k]

    def segment_sum(v):
        out = torch.zeros(num_leaves, dtype=v.dtype, device=v.device)
        if v.is_cuda:
            # sorts the rows by leaf and adds each leaf's run in order:
            # the same bits on every run (index_add_ on the card adds
            # with atomics, in an order that varies between runs)
            return out.index_put_((ids,), v, accumulate=True)
        return out.index_add_(0, ids, v)

    sg, sh = segment_sum(gk), segment_sum(hk)
    cnt = segment_sum(torch.ones_like(gk))
    thresholded = torch.sign(sg) * torch.clamp(sg.abs() - l1, min=0.0)
    out = -thresholded / (sh + l2)
    out = torch.minimum(torch.maximum(out, -max_delta), max_delta)
    mixed = decay * old + (1.0 - decay) * shrinkage * out
    new_vals = torch.where(cnt > 0, mixed, old)
    delta = new_vals.index_select(0, ids)
    if score.dim() == 1:
        score = score + delta
    else:
        score = score.clone()
        score[:, k] += delta
    return new_vals, score
