"""Voting-parallel tree learner: data-parallel with top-k feature voting.

Port of ``lightgbm_tpu/parallel/voting_parallel.py`` (reference:
src/treelearner/voting_parallel_tree_learner.cpp, PV-tree: each rank
proposes its local top-k features, :243-394; a vote over the proposals
picks 2k global features, GlobalVoting :151; only the voted features'
histograms cross the network, CopyLocalHistogram :184).

Rows are sharded as in the data-parallel learner. For each child of a
split, each shard lists the child's rows and launches the histogram
kernel over them (a local partial), takes its local per-feature best
gains from that partial and its local sums, and votes for its ``top_k``
features (a shard whose best gains are all -inf votes for none). The
votes are summed, the ``2 * top_k`` features with the most votes (ties
to the lower feature index, as ``lax.top_k``) are the voted set, and
only the voted [V, B, 4] block of the partials is reduced. The child's
scan reads that block (the other features' rows zero) under its mask
ANDed with the voted set.

As in the reference, both children are histogrammed (different leaves
vote different features, so the subtraction trick does not apply), the
root is reduced in full, there is no per-leaf histogram store
(``_hist_slots = 1``), EFB is unbundled and the intermediate and
advanced monotone methods degrade to basic with the reference's warning
(``_supports_intermediate = False``).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..io.dataset import BinnedDataset
from ..ops.quantize import dequantize_hist, dequantize_sums
from ..ops.split import leaf_gain, prefix_sum
from ..treelearner.serial import GrowState, _FusedBuffers
from .data_parallel import DataParallelTreeLearner, Mesh


def per_feature_best_gain(hist, sum_grad, sum_hess, sum_count, meta, params,
                          feature_mask, hist_scale=None) -> torch.Tensor:
    """[F] best numerical split gain per feature, the voting score
    (reference ``_per_feature_best_gain``, :39): the threshold scan
    reduced over bins only. Integer histograms are dequantized here;
    the sums arrive dequantized."""
    hist = dequantize_hist(hist, hist_scale)
    left_g, left_h, left_c = prefix_sum(hist.permute(2, 0, 1)[:3])
    B = hist.shape[1]
    bin_ids = torch.arange(B, dtype=torch.int32, device=hist.device)[None]
    valid_t = ((bin_ids < meta.num_bin[:, None] - 1)
               & feature_mask[:, None])
    rg, rh, rc = sum_grad - left_g, sum_hess - left_h, sum_count - left_c
    ok = ((left_c >= params.min_data_in_leaf)
          & (rc >= params.min_data_in_leaf)
          & (left_h >= params.min_sum_hessian_in_leaf)
          & (rh >= params.min_sum_hessian_in_leaf))
    gains = (leaf_gain(left_g, left_h, params)
             + leaf_gain(rg, rh, params))
    gains = torch.where(ok & valid_t, gains, float("-inf"))
    return gains.max(dim=1).values


def _top(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest values, ties to the lower index
    (``lax.top_k``'s order)."""
    return torch.sort(values, descending=True, stable=True).indices[:k]


class VotingParallelTreeLearner(DataParallelTreeLearner):
    """Data-parallel learner whose cross-shard histogram traffic is the
    per-child voted [V, B, 4] block."""

    _supports_bundles = False
    _supports_intermediate = False

    def __init__(self, config, dataset: BinnedDataset,
                 device: torch.device, mesh: Mesh):
        super().__init__(config, dataset, device, mesh)
        self.top_k = max(1, min(int(config.top_k), self.F))
        self.n_voted = min(2 * self.top_k, self.F)
        # histograms are voted afresh per leaf: nothing reads a store
        self._hist_slots = 1

    def _voted_histogram(self, parts: List[torch.Tensor],
                         mask: torch.Tensor, qscale
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One child's [Fp, B, 4] histogram reduced on its voted features
        only (the other rows zero) and its scan mask (``mask`` and the
        voted set), from the shards' partials (reference
        ``_voted_reduced_histogram``, :86)."""
        dev, Fp = self.device, self.Fp
        votes = torch.zeros(Fp, dtype=torch.int32, device=dev)
        for p in parts:
            p = p.to(dev)
            s = dequantize_sums(p[0].sum(dim=0, dtype=p.dtype), qscale)
            gains = per_feature_best_gain(p, s[0], s[1], s[2], self.meta,
                                          self.params, mask, qscale)
            top = _top(gains, self.top_k)
            # a shard with no valid local split votes for nothing
            votes.index_add_(0, top, torch.isfinite(
                gains.index_select(0, top)).to(torch.int32))
        voted = _top(votes, self.n_voted)
        block = self._reduce([p.index_select(0, voted.to(p.device))
                              for p in parts])
        full = block.new_zeros((Fp,) + tuple(block.shape[1:]))
        full.index_copy_(0, voted, block)
        vmask = torch.zeros(Fp, dtype=torch.bool, device=dev)
        vmask.index_fill_(0, voted, True)
        return full, mask & vmask

    def _step(self, buf) -> None:
        """The serial step with both children voted and reduced on their
        voted blocks instead of the smaller one and a subtraction."""
        st = buf.state
        row, valid, leaf, new_leaf = self._step_partition(st)
        (hl, ml), (hr, mr) = (
            self._voted_histogram(self._child_parts(buf, child, valid),
                                  self.feature_mask, buf.qscale)
            for child in (leaf, new_leaf))
        self._finish_children(st, leaf, new_leaf, row, hl, hr, valid,
                              buf.qscale, masks=(ml, mr))

    def _split_histograms(self, state: GrowState, rec, row,
                          new_leaf: int, masks: tuple):
        """The per-split loop's children, voted as in :meth:`_step`."""
        dev = self.device
        buf = _FusedBuffers(state, *self._row_list_buffers(), None)
        valid = torch.ones((), dtype=torch.bool, device=dev)
        out = []
        for c, child in enumerate((rec.leaf, new_leaf)):
            mask = self.feature_mask if masks[c] is None else masks[c]
            parts = self._child_parts(
                buf, torch.full((1,), child, dtype=torch.int64, device=dev),
                valid)
            out.append(self._voted_histogram(parts, mask, self._qscale))
        return out[0][0], out[1][0], (out[0][1], out[1][1])

