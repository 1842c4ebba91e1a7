"""Feature-parallel tree learner: features sharded over the mesh.

Port of ``lightgbm_tpu/parallel/feature_parallel.py`` (reference:
src/treelearner/feature_parallel_tree_learner.cpp: every rank holds all
rows but owns a block of the features; each rank finds its own best
split and the ranks agree on the best of them, SyncUpGlobalBestSplit,
parallel_tree_learner.h:190).

The features are padded to a multiple of the mesh size, and shard k
owns the block ``[k * Fs, (k + 1) * Fs)`` of the inner feature order
(``Fs = ceil(F / n)``), its binned rows (all of them) on its device,
the block padded to a multiple of 8 columns as the kernel requires. Pad
features have ``num_bin`` 1, so they never win.

- Histograms stay per shard: each shard's kernel launch sums its block
  over the leaf's rows (the serial learner's row list: rows are
  replicated), and nothing is reduced; the learner keeps the blocks side
  by side in its per-leaf store, in feature order.
- Each shard scans its block; only the best split crosses shards: the
  highest gain, ties broken by the serial scan's flat order (variant,
  then feature, then bin), so the winner is the first maximum in global
  feature order, as the reference's argmax over the feature-sharded
  gains gives it.
- The partition reads the split column of the rows on the learner's
  device (the reference all-gathers that one column).
- EFB is unbundled, as in the reference (``_supports_bundles = False``,
  :38): bundle columns would couple features across shards.

Every feature's sums are the serial learner's (the same adds per
feature), so its trees are held text-equal to the serial learner's on
the CPU, in f32 too.
"""
from __future__ import annotations

from typing import List

import torch

from ..io.dataset import BinnedDataset
from ..ops import split as S
from ..ops.histogram import build_histogram
from ..ops.split import FeatureMeta, find_best_split
from ..treelearner.serial import SerialTreeLearner
from .data_parallel import Mesh, _MeshLearner


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _block(t, a: int, b: int):
    return None if t is None else t[a:b]


class FeatureParallelTreeLearner(_MeshLearner, SerialTreeLearner):
    """The serial learner with its histogram and scan split into feature
    blocks, one per shard, and the best split agreed across them."""

    _supports_bundles = False

    def __init__(self, config, dataset: BinnedDataset,
                 device: torch.device, mesh: Mesh):
        super().__init__(config, dataset, device, mesh)
        Fs = self._fs
        self._metas: List[FeatureMeta] = [
            self._meta_block(k * Fs, (k + 1) * Fs)
            for k in range(mesh.size)]

    def _padded_features(self, F: int) -> int:
        """Fp: the features padded to a multiple of the mesh size, then to
        a multiple of 8 (the learner's own tensors)."""
        self._fs = -(-F // self.mesh.size)
        return _ceil8(self.mesh.size * self._fs)

    def _meta_block(self, a: int, b: int) -> FeatureMeta:
        m = self.meta
        return m._replace(num_bin=m.num_bin[a:b],
                          missing_type=m.missing_type[a:b],
                          zero_bin=m.zero_bin[a:b],
                          is_categorical=_block(m.is_categorical, a, b),
                          use_onehot=_block(m.use_onehot, a, b),
                          monotone=_block(m.monotone, a, b))

    def _stage_bins(self, dataset: BinnedDataset, ncols: int) -> None:
        super()._stage_bins(dataset, ncols)
        Fs = self._fs
        self._blocks = []
        for k, d in enumerate(self.mesh.devices):
            block = torch.zeros((self.N, _ceil8(Fs)), dtype=self.bins.dtype,
                                device=self.device)
            block[:, :Fs] = self.bins[:, k * Fs:(k + 1) * Fs]
            self._blocks.append(block.to(d))

    def _leaf_histogram(self, gh: torch.Tensor, idx=None, count=None,
                        totals=None) -> torch.Tensor:
        """Each shard's [Fs, B, 4] block over the rows (all, or
        ``idx[:count]``), side by side in feature order."""
        Fs, parts = self._fs, []
        for blk in self._blocks:
            d = blk.device
            h = build_histogram(blk, gh.to(d), self.B,
                                None if idx is None else idx.to(d),
                                None if count is None else count.to(d),
                                f64=self._f64)
            parts.append(h[:Fs].to(self.device))
        pad = self.Fp - Fs * len(parts)
        if pad:
            parts.append(parts[0].new_zeros((pad,) + parts[0].shape[1:]))
        return torch.cat(parts)

    def _scan(self, hist, sums, parent_out, qscale, mask=None,
              rand_bins=None, penalty=None, bounds=(None, None),
              depth=None, bound_arrays=None) -> torch.Tensor:
        """Each shard scans its block; the best record wins (its feature
        made global), ties to the first in the serial scan's order."""
        mask = self.feature_mask if mask is None else mask
        Fs, B, Fp = self._fs, self.B, self.Fp
        rows, keys = [], []
        for k, meta in enumerate(self._metas):
            a, b = k * Fs, (k + 1) * Fs
            row, variant = find_best_split(
                hist[a:b], sums[0], sums[1], sums[2], sums[3], meta,
                self.params, mask[a:b], parent_out, qscale, self._has_cat,
                None if rand_bins is None else tuple(r[a:b]
                                                     for r in rand_bins),
                _block(penalty, a, b), self._has_mono, bounds[0], bounds[1],
                depth, None if bound_arrays is None else tuple(
                    x[a:b] for x in bound_arrays), with_variant=True)
            local = row[S.FEATURE]
            row = row.clone()
            row[S.FEATURE] = torch.where(local >= 0, local + a, local)
            keys.append((variant * Fp + a + local.long()) * B
                        + row[S.THRESHOLD_BIN].long())
            rows.append(row)
        rows_t, keys_t = torch.stack(rows), torch.stack(keys)
        gains = rows_t[:, S.GAIN]
        first = torch.where(gains == gains.max(), keys_t,
                            torch.iinfo(torch.int64).max)
        return rows_t.index_select(0, torch.argmin(first).view(1)).view(-1)
