"""Single-device leaf-wise tree learner.

Port of ``lightgbm_tpu/treelearner/serial.py`` (reference:
SerialTreeLearner, src/treelearner/serial_tree_learner.cpp:159): the
binned rows, gradients, per-leaf histograms, per-leaf best-split
candidates and the row->leaf partition live on the learner's device; the
host picks nothing but reads one split record per step and replays it
into the host ``Tree``.

The loop is the reference's stepped loop (``tpu_fused_tree=false``; the
reference pins it bit-identical to its fused whole-tree loop), one split
per host step:

1. the root histogram over all rows and its scan;
2. per step, the leaf with the best candidate (first maximum on ties)
   is split: the partition moves the rows that go right
   (``_go_left_by_bin``), the smaller child's rows are found with
   ``torch.nonzero`` and handed to the histogram kernel as a row-index
   list (``bins[idx]`` is never materialised), the sibling comes from
   subtraction, and both children are scanned.

Each step syncs with the host twice (the record read-back and the
``nonzero``); a device-resident whole-tree loop is a later PR.

Quantized-gradient mode (``use_quantized_grad``; reference:
``CapabilityMixin._init_quantization`` / ``_quantize_stage``,
lightgbm_tpu/treelearner/capabilities.py:109-162) stages each tree's
rows as int8/int16 ``(q_grad, q_hess, in_bag, 1)`` under the tree's
stochastic-rounding key, keeps int32 histograms (the sibling
subtraction is exact), takes exact integer root sums and dequantizes
them once, and hands the tree's scales to every split scan.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..io.binning import MissingType
from ..io.dataset import BinnedDataset
from ..models.tree import Tree
from ..ops import split as S
from ..ops.histogram import build_histogram, subtract_histogram
from ..ops.quantize import (dequantize_sums, effective_quant_max,
                            quant_dtype, quant_warn_capped, quantize_gh,
                            sum_gh, tree_key)
from ..ops.split import (FeatureMeta, SplitParams, calculate_leaf_output,
                         find_best_split, pad_feature_meta)
from ..utils import log, next_pow2
from ..utils.prng import PRNGKey


class SplitRecord(NamedTuple):
    """One winning split, read back to the host (f32 values as floats)."""
    leaf: int
    gain: float
    feature: int
    threshold_bin: int
    default_left: bool
    left_sum_grad: float
    left_sum_hess: float
    left_count: float
    left_total_count: float
    left_output: float
    right_sum_grad: float
    right_sum_hess: float
    right_count: float
    right_total_count: float
    right_output: float

    @classmethod
    def from_row(cls, leaf: int, row: List[float]) -> "SplitRecord":
        return cls(leaf, row[S.GAIN], int(row[S.FEATURE]),
                   int(row[S.THRESHOLD_BIN]), bool(row[S.DEFAULT_LEFT]),
                   *row[S.LEFT_SUM_GRAD:S.RECORD_WIDTH])


class GrowState(NamedTuple):
    """Per-tree device state."""
    leaf_of_row: torch.Tensor     # [N] int32
    gh: torch.Tensor              # [N, 4] (grad, hess, in-bag, total):
    #                               f32, or int8/int16 when quantized
    hists: torch.Tensor           # [L, Fp, B, 4] f32 (int32 quantized)
    cand: torch.Tensor            # [L, RECORD_WIDTH] f32 best candidates


def record_is_valid(rec: SplitRecord) -> bool:
    return (rec.feature >= 0 and np.isfinite(rec.gain)
            and rec.gain > 0.0)


def apply_split_record(tree: Tree, dataset: BinnedDataset,
                       rec: SplitRecord) -> None:
    """Replay one split record into the host Tree (reference: the
    Tree::Split call of SerialTreeLearner::Split,
    serial_tree_learner.cpp:593)."""
    f = rec.feature
    tree.split(
        leaf=rec.leaf, feature=dataset.real_feature_index(f),
        feature_inner=f, threshold_bin=rec.threshold_bin,
        threshold_real=dataset.real_threshold(f, rec.threshold_bin),
        left_value=rec.left_output, right_value=rec.right_output,
        left_count=int(round(rec.left_count)),
        right_count=int(round(rec.right_count)),
        left_weight=rec.left_sum_hess, right_weight=rec.right_sum_hess,
        gain=rec.gain, missing_type=dataset.bin_mappers[f].missing_type,
        default_left=rec.default_left)


def _go_left_by_bin(col: torch.Tensor, tbin: int, default_left: bool,
                    missing_type: int, nan_bin: int,
                    zero_bin: int) -> torch.Tensor:
    """Training-time split direction over bin values (reference:
    DenseBin::Split missing handling, src/io/dense_bin.hpp)."""
    gl = col <= tbin
    if missing_type == MissingType.NAN:
        gl = torch.where(col == nan_bin, default_left, gl)
    elif missing_type == MissingType.ZERO:
        gl = torch.where(col == zero_bin, default_left, gl)
    return gl


class SerialTreeLearner:
    """Leaf-wise grower over a device-resident binned dataset."""

    def __init__(self, config, dataset: BinnedDataset,
                 device: torch.device):
        self.config = config
        self.dataset = dataset
        self.device = device
        N = dataset.num_data
        F = dataset.num_features
        if F == 0:
            log.fatal("Cannot train without features")
        self.N, self.F = N, F
        # histogram width: the max bin count padded to a power of two,
        # as in the reference
        self.B = next_pow2(max(int(dataset.max_num_bin), 2))
        self.L = int(config.num_leaves)
        self.max_depth = int(config.max_depth)
        # features padded to a multiple of 8: the kernel reads 8
        # features of a row with one 8-byte load; pad features have
        # num_bin 1 and never win a split
        self.Fp = -(-F // 8) * 8
        bins = np.zeros((N, self.Fp), dtype=np.uint8)
        bins[:, :F] = dataset.bins
        self.bins = torch.from_numpy(bins).to(device)
        self.meta = pad_feature_meta(FeatureMeta.from_dataset(dataset, device),
                                     self.Fp - F)
        self._meta_host = (np.asarray(dataset.num_bin_per_feature),
                           [m.missing_type for m in dataset.bin_mappers],
                           [m.default_bin for m in dataset.bin_mappers])
        self.params = SplitParams.from_config(config, device)
        mask = torch.zeros(self.Fp, dtype=torch.bool, device=device)
        mask[:F] = True
        self.feature_mask = mask
        self._ones = torch.ones(N, dtype=torch.float32, device=device)
        # the reference pads its rows to a multiple of 4096 above N; its
        # f32 root sums add the zero rows too (ops/quantize.py::sum_gh)
        self._padded_rows = -(-(N + 1) // 4096) * 4096
        self._tree_idx = 0
        self._init_quantization(config)

    def _init_quantization(self, config) -> None:
        """Quantized-gradient state: the per-row magnitude cap (overflow
        discipline against the int32 accumulator), the row dtype, the
        base stochastic-rounding key and the tree counter.
        ``self._qscale`` holds the current tree's (g, h) scales, None in
        exact mode."""
        self._quantized = bool(config.use_quantized_grad)
        self._qscale: Optional[torch.Tensor] = None
        if not self._quantized:
            return
        bits = int(config.quant_grad_bits)
        self._qmax = effective_quant_max(bits, self.N)
        self._qdtype = quant_dtype(bits)
        quant_warn_capped(bits, self._qmax, self.N)
        self._quant_base_key = PRNGKey(int(config.seed) & 0x7FFFFFFF,
                                       self.device)
        self._quant_ctr = 0

    def _quantize_stage(self, grad: torch.Tensor, hess: torch.Tensor,
                        ind: torch.Tensor, tree_no: int):
        """Discretize one tree's rows under ``fold_in(base, tree_no)``.
        The counter advances once per call; the assert pins it to the
        caller's tree numbering (1, 2, ...), since a call off that
        cadence would shift every later stochastic draw."""
        self._quant_ctr += 1
        assert self._quant_ctr == tree_no, \
            "quantize tree counter desynced from tree numbering " \
            "(%d != %d)" % (self._quant_ctr, tree_no)
        return quantize_gh(grad, hess, ind,
                           tree_key(self._quant_base_key, tree_no),
                           self._qmax, self._qdtype)

    def _splittable(self, depth: int) -> bool:
        return self.max_depth <= 0 or depth < self.max_depth

    def _store(self, cand: torch.Tensor, leaf: int, info: torch.Tensor,
               allowed: bool) -> None:
        if not allowed:
            info = info.clone()
            info[S.GAIN] = float("-inf")
        cand[leaf] = info

    def train(self, grad: torch.Tensor, hess: torch.Tensor,
              bag: Optional[torch.Tensor] = None
              ) -> Tuple[Tree, torch.Tensor]:
        """Grow one tree from f32 [N] gradients; ``bag`` is an optional
        f32 [N] in-bag indicator (0/1). Returns the host Tree and the
        final [N] int32 row->leaf partition (on the device) for the
        score update (reference: GBDT::UpdateScore uses the learner's
        partition, gbdt.cpp:475)."""
        ind = self._ones if bag is None else bag
        self._tree_idx += 1
        if self._quantized:
            gh, self._qscale = self._quantize_stage(grad, hess, ind,
                                                    self._tree_idx)
        else:
            gh = torch.stack([grad * ind, hess * ind, ind, self._ones],
                             dim=1)
        state = self._root(gh)
        tree = Tree(self.L)
        for new_leaf in range(1, self.L):
            best = torch.argmax(state.cand[:, S.GAIN])
            # a copy: the children's candidates overwrite cand[leaf]
            row = state.cand[best].clone()
            host = torch.cat([best.to(torch.float32).view(1), row]).tolist()
            rec = SplitRecord.from_row(int(host[0]), host[1:])
            if not record_is_valid(rec):
                break
            apply_split_record(tree, self.dataset, rec)
            self._split(state, rec, row, new_leaf,
                        int(tree.leaf_depth[rec.leaf]))
        return tree, state.leaf_of_row

    def _root(self, gh: torch.Tensor) -> GrowState:
        # exact integer sums in quantized mode, dequantized once
        sums = dequantize_sums(sum_gh(gh, self._padded_rows), self._qscale)
        hist = build_histogram(self.bins, gh, self.B)
        # root "parent" output: its own unsmoothed output (reference:
        # SerialTreeLearner::GetParentOutput)
        parent_out = calculate_leaf_output(sums[0], sums[1], self.params)
        info = find_best_split(hist, sums[0], sums[1], sums[2], sums[3],
                               self.meta, self.params, self.feature_mask,
                               parent_out, self._qscale)
        hists = torch.zeros((self.L, self.Fp, self.B, 4),
                            dtype=hist.dtype, device=self.device)
        hists[0] = hist
        cand = torch.full((self.L, S.RECORD_WIDTH), float("-inf"),
                          dtype=torch.float32, device=self.device)
        cand[:, S.FEATURE] = -1.0
        self._store(cand, 0, info, self._splittable(0))
        leaf_of_row = torch.zeros(self.N, dtype=torch.int32,
                                  device=self.device)
        return GrowState(leaf_of_row, gh, hists, cand)

    def _split(self, state: GrowState, rec: SplitRecord, row: torch.Tensor,
               new_leaf: int, child_depth: int) -> None:
        """Apply ``rec`` (already replayed into the tree; ``row`` is its
        device copy) and scan both children. Updates ``state`` in
        place."""
        leaf, f = rec.leaf, rec.feature
        num_bin, missing, zero_bin = self._meta_host
        col = self.bins[:, f]
        gl = _go_left_by_bin(col, rec.threshold_bin, rec.default_left,
                             missing[f], int(num_bin[f]) - 1, zero_bin[f])
        on_leaf = state.leaf_of_row == leaf
        state.leaf_of_row.masked_fill_(on_leaf & ~gl, new_leaf)

        smaller_is_left = rec.left_total_count <= rec.right_total_count
        small_id = leaf if smaller_is_left else new_leaf
        idx = torch.nonzero(state.leaf_of_row == small_id).view(-1).to(
            torch.int32)
        hist_small = build_histogram(self.bins, state.gh, self.B, idx)
        hist_large = subtract_histogram(state.hists[leaf], hist_small)
        hist_left, hist_right = ((hist_small, hist_large) if smaller_is_left
                                 else (hist_large, hist_small))
        state.hists[leaf] = hist_left
        state.hists[new_leaf] = hist_right

        allowed = self._splittable(child_depth)
        for child, hist, side in ((leaf, hist_left, S.LEFT_SUM_GRAD),
                                  (new_leaf, hist_right, S.RIGHT_SUM_GRAD)):
            info = find_best_split(
                hist, row[side], row[side + 1], row[side + 2],
                row[side + 3], self.meta, self.params, self.feature_mask,
                row[side + 4], self._qscale)
            self._store(state.cand, child, info, allowed)
