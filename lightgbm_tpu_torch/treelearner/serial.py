"""Single-device leaf-wise tree learner.

Port of ``lightgbm_tpu/treelearner/serial.py`` (reference:
SerialTreeLearner, src/treelearner/serial_tree_learner.cpp:159): the
binned rows, gradients, per-leaf histograms, per-leaf best-split
candidates and the row->leaf partition live on the learner's device; the
host picks nothing but reads the split records back and replays them
into the host ``Tree``.

Two loops grow a tree, as in the reference, and give the same trees:

- the whole-tree loop (``tpu_fused_tree=true``, the default; reference
  ``_train_fused``): after the root, every split is one call of
  :meth:`SerialTreeLearner._step`, which makes no host read (ports
  ``_split_body``, ``_finish_split``, ``_store_info`` and ``rec_valid``):
  the leaf with the best candidate (first maximum on ties) is split,
  rows move by a partition read from device values, the smaller child's
  rows are compacted in ascending order into a fixed buffer with their
  count on the device, the histogram kernel's device-count entry sums
  them, the sibling comes from subtraction, both children are scanned,
  and every write is guarded by the step's validity, so steps after the
  tree's end change nothing. On CUDA the step is captured once per
  learner as a CUDA graph and replayed in chunks of
  :data:`FUSED_CHUNK`, with one read of the step counter between chunks
  (to stop early) and one read of the whole tree's records at the end;
  on the CPU the same step runs eagerly. The reference's
  k-splits-per-dispatch schedule (``_train_batched``) is how it feeds
  XLA, not a semantics, and has no counterpart here.
- the per-split loop (``tpu_fused_tree=false``; reference: the stepped
  loop it pins its fused loop to): one host step per split, a record
  read-back and ``torch.nonzero`` of the smaller child (two syncs per
  split). It stays as the parity anchor.

Quantized-gradient mode (``use_quantized_grad``; reference:
``CapabilityMixin._init_quantization`` / ``_quantize_stage``,
lightgbm_tpu/treelearner/capabilities.py:109-162) stages each tree's
rows as int8/int16 ``(q_grad, q_hess, in_bag, 1)`` under the tree's
stochastic-rounding key, keeps int32 histograms (the sibling
subtraction is exact), takes exact integer root sums and dequantizes
them once, and hands the tree's scales to every split scan.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

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
from ..utils.log import LightGBMError
from ..utils.prng import PRNGKey

#: whole-tree loop: split steps per chunk between two reads of the step
#: counter (a tree that ends early stops at the end of its chunk; the
#: steps after its end change nothing, so the trees do not depend on it)
FUSED_CHUNK = 32


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
    """Per-tree device state (the whole-tree loop keeps one set per
    learner, refilled by each tree's root, at fixed addresses for its
    graph)."""
    leaf_of_row: torch.Tensor     # [N] int32
    gh: torch.Tensor              # [N, 4] (grad, hess, in-bag, total):
    #                               f32, or int8/int16 when quantized
    hists: torch.Tensor           # [L, Fp, B, 4] f32 (int32 quantized)
    cand: torch.Tensor            # [L, RECORD_WIDTH] f32 best candidates
    leaf_depth: torch.Tensor      # [L] int32
    step: torch.Tensor            # 0-d int32: splits applied so far
    records: torch.Tensor         # [L - 1, 1 + RECORD_WIDTH] f32: split i's
    #                               leaf, then its record row


def record_is_valid(rec: SplitRecord) -> bool:
    """Host twin of :func:`record_valid` (the two must agree: the device
    leaves the state alone after an invalid record, the host stops
    replaying at it)."""
    return (rec.feature >= 0 and np.isfinite(rec.gain)
            and rec.gain > 0.0)


def record_valid(row: torch.Tensor) -> torch.Tensor:
    """Device twin of :func:`record_is_valid` over a record row
    (reference ``rec_valid``); a 0-d bool tensor."""
    gain = row[S.GAIN]
    return (row[S.FEATURE] >= 0) & torch.isfinite(gain) & (gain > 0.0)


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


def go_left_on_device(col: torch.Tensor, tbin: torch.Tensor,
                      default_left: torch.Tensor, missing_type: torch.Tensor,
                      nan_bin: torch.Tensor,
                      zero_bin: torch.Tensor) -> torch.Tensor:
    """:func:`_go_left_by_bin` with the split's values as device tensors
    (reference ``_go_left_by_bin`` under jit): a NaN-missing feature
    sends its NaN bin, a zero-missing one its zero bin, the default
    way."""
    special = (((missing_type == MissingType.NAN) & (col == nan_bin))
               | ((missing_type == MissingType.ZERO) & (col == zero_bin)))
    return torch.where(special, default_left, col <= tbin)


def _put(dst: torch.Tensor, at: torch.Tensor, new: torch.Tensor,
         valid: torch.Tensor) -> None:
    """``dst[at] = new`` where ``valid``, else unchanged (``at`` a [1]
    int64 tensor): the reference's guarded ``.at[].set(where(valid, new,
    old))``, with no host read."""
    old = dst.index_select(0, at)
    dst.index_copy_(0, at, torch.where(valid, new.unsqueeze(0), old))


class _FusedBuffers(NamedTuple):
    """The whole-tree loop's fixed buffers (one set per learner): the
    state, the smaller child's row list and count, the tree's inputs."""
    state: GrowState
    idx: torch.Tensor             # [N + 1] int32: the row list, then a
    #                               trash slot for the other rows
    rows: torch.Tensor            # [N] int32: 0 .. N-1
    count: torch.Tensor           # [1] int32: the row list's length
    qscale: Optional[torch.Tensor]  # [2] f32 (quantized mode)


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
        self._fused_growth = bool(config.tpu_fused_tree)
        self._fused: Optional[_FusedBuffers] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        #: what the loops did since the learner was made: roots (one per
        #: tree), split steps run (eagerly or replayed), graph replays and
        #: captures, capture ms, host reads of the step counter and of
        #: the records
        self.grow_stats: Dict[str, float] = dict.fromkeys(
            ("roots", "steps", "replays", "captures", "capture_ms",
             "flag_reads", "record_reads"), 0)

    def reset_config(self, config) -> None:
        """New split parameters, depth limit and loop choice between
        trees (reference: ``ops_refresh.refresh_learner_params``). The
        captured step holds the old ones (its parameter tensors and
        ``max_depth``), so the graph is dropped and the next tree
        captures it again."""
        self.config = config
        self.params = SplitParams.from_config(config, self.device)
        self.max_depth = int(config.max_depth)
        self._fused_growth = bool(config.tpu_fused_tree)
        self._graph = None

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
            # the tree's rounding key advances here, before either loop
            gh, self._qscale = self._quantize_stage(grad, hess, ind,
                                                    self._tree_idx)
        else:
            gh = torch.stack([grad * ind, hess * ind, ind, self._ones],
                             dim=1)
        if self._fused_growth:
            tree, state = self._grow_fused(gh)
            # the state's buffers are the next tree's
            return tree, state.leaf_of_row.clone()
        tree, state = self._grow_stepped(gh)
        return tree, state.leaf_of_row

    # ------------------------------------------------------------------
    # the root, shared by both loops
    # ------------------------------------------------------------------
    def _new_state(self, gh: torch.Tensor) -> GrowState:
        L, dev = self.L, self.device
        acc = torch.int32 if not gh.dtype.is_floating_point else gh.dtype
        return GrowState(
            leaf_of_row=torch.empty(self.N, dtype=torch.int32, device=dev),
            gh=gh,
            hists=torch.empty((L, self.Fp, self.B, 4), dtype=acc,
                              device=dev),
            cand=torch.empty((L, S.RECORD_WIDTH), dtype=torch.float32,
                             device=dev),
            leaf_depth=torch.empty(L, dtype=torch.int32, device=dev),
            step=torch.empty((), dtype=torch.int32, device=dev),
            records=torch.empty((max(L - 1, 1), 1 + S.RECORD_WIDTH),
                                dtype=torch.float32, device=dev))

    def _root(self, state: GrowState) -> None:
        """Fill ``state`` in place for a new tree: the root histogram of
        ``state.gh`` over all rows and its scan in slot 0, every other
        slot empty."""
        gh = state.gh
        # exact integer sums in quantized mode, dequantized once
        sums = dequantize_sums(sum_gh(gh, self._padded_rows), self._qscale)
        hist = build_histogram(self.bins, gh, self.B)
        # root "parent" output: its own unsmoothed output (reference:
        # SerialTreeLearner::GetParentOutput)
        parent_out = calculate_leaf_output(sums[0], sums[1], self.params)
        info = find_best_split(hist, sums[0], sums[1], sums[2], sums[3],
                               self.meta, self.params, self.feature_mask,
                               parent_out, self._qscale)
        state.leaf_of_row.zero_()
        state.hists.zero_()
        state.hists[0] = hist
        state.cand.fill_(float("-inf"))
        state.cand[:, S.FEATURE] = -1.0
        self._store(state.cand, 0, info, self._splittable(0))
        state.leaf_depth.zero_()
        state.step.zero_()
        state.records.zero_()
        state.records[:, 1 + S.GAIN] = float("-inf")
        state.records[:, 1 + S.FEATURE] = -1.0
        self.grow_stats["roots"] += 1

    # ------------------------------------------------------------------
    # the per-split loop (tpu_fused_tree=false)
    # ------------------------------------------------------------------
    def _grow_stepped(self, gh: torch.Tensor) -> Tuple[Tree, GrowState]:
        """One host step per split: read the best record back, replay it
        into the tree, then split on the device."""
        state = self._new_state(gh)
        self._root(state)
        tree = Tree(self.L)
        for new_leaf in range(1, self.L):
            best = torch.argmax(state.cand[:, S.GAIN])
            # a copy: the children's candidates overwrite cand[leaf]
            row = state.cand[best].clone()
            packed = torch.cat([best.to(torch.float32).view(1), row])
            host = packed.tolist()
            rec = SplitRecord.from_row(int(host[0]), host[1:])
            if not record_is_valid(rec):
                break
            apply_split_record(tree, self.dataset, rec)
            child_depth = int(tree.leaf_depth[rec.leaf])
            state.records[new_leaf - 1] = packed
            state.step.fill_(new_leaf)
            state.leaf_depth[rec.leaf] = child_depth
            state.leaf_depth[new_leaf] = child_depth
            self._split(state, rec, row, new_leaf, child_depth)
            self.grow_stats["steps"] += 1
        return tree, state

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

    # ------------------------------------------------------------------
    # the whole-tree loop (tpu_fused_tree=true, the default)
    # ------------------------------------------------------------------
    def _fused_buffers(self, gh: torch.Tensor) -> _FusedBuffers:
        """The loop's fixed buffers, made at the first tree; each tree
        copies its rows and scales into them."""
        if self._fused is None:
            dev = self.device
            state = self._new_state(torch.empty_like(gh))
            self._fused = _FusedBuffers(
                state=state,
                idx=torch.zeros(self.N + 1, dtype=torch.int32, device=dev),
                rows=torch.arange(self.N, dtype=torch.int32, device=dev),
                count=torch.zeros(1, dtype=torch.int32, device=dev),
                qscale=(torch.empty(2, dtype=torch.float32, device=dev)
                        if self._quantized else None))
        buf = self._fused
        if gh.shape != buf.state.gh.shape or gh.dtype != buf.state.gh.dtype:
            raise LightGBMError("whole-tree loop: rows of shape %s %s, the "
                                "learner's buffers hold %s %s"
                                % (tuple(gh.shape), gh.dtype,
                                   tuple(buf.state.gh.shape),
                                   buf.state.gh.dtype))
        buf.state.gh.copy_(gh)
        if buf.qscale is not None:
            buf.qscale.copy_(self._qscale)
        return buf

    def _step(self, buf: _FusedBuffers) -> None:
        """One split of the whole tree, on the device with no host read:
        the reference's ``_split_body`` + ``_finish_split`` (unbundled,
        numerical). Every write is guarded by the step's validity
        (a valid best record, and fewer than L - 1 splits so far), so a
        step after the tree's end changes nothing."""
        st, meta, L = buf.state, self.meta, self.L
        i = st.step
        best = torch.argmax(st.cand[:, S.GAIN]).view(1)   # first maximum
        row = st.cand.index_select(0, best).view(-1)      # a copy
        valid = record_valid(row) & (i < L - 1)
        leaf = best
        new_leaf = torch.clamp(i.long() + 1, max=L - 1).view(1)

        # partition (reference _split_body :473-486; _partition_col's
        # unbundled branch): the feature's column and its missing rule
        # by gather from the device meta
        f = torch.clamp(row[S.FEATURE], min=0.0).long().view(1)
        col = self.bins.index_select(1, f).view(-1).to(torch.int32)
        gl = go_left_on_device(
            col, row[S.THRESHOLD_BIN].to(torch.int32),
            row[S.DEFAULT_LEFT] > 0.0, meta.missing_type.index_select(0, f),
            meta.num_bin.index_select(0, f) - 1,
            meta.zero_bin.index_select(0, f))
        move = (st.leaf_of_row == leaf) & ~gl & valid
        st.leaf_of_row.copy_(torch.where(move, new_leaf.to(torch.int32),
                                         st.leaf_of_row))

        # the smaller child's rows, ascending (torch.nonzero's list), into
        # the fixed row list; the others go to its trash slot N
        smaller_is_left = (row[S.LEFT_TOTAL_COUNT]
                           <= row[S.RIGHT_TOTAL_COUNT])
        small_id = torch.where(smaller_is_left, leaf, new_leaf)
        is_small = (st.leaf_of_row == small_id) & valid
        pos = torch.cumsum(is_small, 0, dtype=torch.int32)
        buf.count.copy_(pos[-1:])
        dest = torch.where(is_small, pos - 1, self.N)
        buf.idx.scatter_(0, dest.long(), buf.rows)
        hist_small = build_histogram(self.bins, st.gh, self.B, buf.idx,
                                     buf.count)
        hist_large = subtract_histogram(
            st.hists.index_select(0, leaf).squeeze(0), hist_small)
        hist_left = torch.where(smaller_is_left, hist_small, hist_large)
        hist_right = torch.where(smaller_is_left, hist_large, hist_small)
        _put(st.hists, leaf, hist_left, valid)
        _put(st.hists, new_leaf, hist_right, valid)

        # depth gating and both children's scans (reference
        # _finish_split)
        child_depth = st.leaf_depth.index_select(0, leaf) + 1
        _put(st.leaf_depth, leaf, child_depth[0], valid)
        _put(st.leaf_depth, new_leaf, child_depth[0], valid)
        for child, hist, side in ((leaf, hist_left, S.LEFT_SUM_GRAD),
                                  (new_leaf, hist_right, S.RIGHT_SUM_GRAD)):
            info = find_best_split(
                hist, row[side], row[side + 1], row[side + 2],
                row[side + 3], meta, self.params, self.feature_mask,
                row[side + 4], buf.qscale)
            if self.max_depth > 0:
                gain = torch.where(child_depth < self.max_depth,
                                   info[S.GAIN:S.GAIN + 1], float("-inf"))
                info = torch.cat([gain, info[S.GAIN + 1:]])
            _put(st.cand, child, info, valid)
        slot = torch.clamp(i.long(), max=L - 2).view(1)
        _put(st.records, slot,
             torch.cat([best.to(torch.float32), row]), valid)
        st.step.add_(valid.to(torch.int32))

    def _capture(self, buf: _FusedBuffers) -> None:
        """Run one step eagerly on a side stream (the warm-up the
        ``torch.cuda.graphs`` docs ask for: kernels built and loaded,
        launch counters and library workspaces made; it is a real step
        of the tree) and capture the next one as the learner's graph.
        A failure raises: there is no fallback to the per-split loop."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._step(buf)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.grow_stats["steps"] += 1
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph):
                self._step(buf)
        except RuntimeError as exc:
            raise LightGBMError("whole-tree loop: capturing the split step "
                                "as a CUDA graph failed: %s" % exc) from exc
        self.grow_stats["capture_ms"] += 1e3 * (time.perf_counter() - t0)
        self.grow_stats["captures"] += 1
        self._graph = graph

    def _replay(self) -> None:
        try:
            self._graph.replay()
        except RuntimeError as exc:
            raise LightGBMError("whole-tree loop: replaying the split step "
                                "failed: %s" % exc) from exc
        self.grow_stats["replays"] += 1
        self.grow_stats["steps"] += 1

    def _grow_fused(self, gh: torch.Tensor) -> Tuple[Tree, GrowState]:
        """The reference's ``_train_fused``: the root, then up to L - 1
        split steps on the device (graph replays on CUDA, in chunks of
        :data:`FUSED_CHUNK` with one read of the step counter between
        chunks), then one read of the tree's records, replayed into the
        host Tree."""
        buf = self._fused_buffers(gh)
        self._root(buf.state)
        done, steps = 0, self.L - 1
        if self.device.type == "cuda" and self._graph is None:
            self._capture(buf)
            done = 1
        while done < steps:
            k = min(FUSED_CHUNK - done % FUSED_CHUNK, steps - done)
            for _ in range(k):
                if self._graph is not None:
                    self._replay()
                else:
                    self._step(buf)
                    self.grow_stats["steps"] += 1
            done += k
            if done < steps:
                # one flag read per chunk: a step that found no valid
                # split left the counter behind the steps run
                self.grow_stats["flag_reads"] += 1
                if int(buf.state.step) < done:
                    break
        records = buf.state.records.cpu().tolist()
        self.grow_stats["record_reads"] += 1
        tree = Tree(self.L)
        for row in records:
            rec = SplitRecord.from_row(int(row[0]), row[1:])
            if not record_is_valid(rec):
                break
            apply_split_record(tree, self.dataset, rec)
        return tree, buf.state
