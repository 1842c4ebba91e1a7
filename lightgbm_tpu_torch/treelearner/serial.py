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

Categorical features add the scan's categorical variants (a static
switch: an all-numerical learner runs none of it) and route rows by
the winner's left-bin mask, which the record carries beside its f32
values, so it comes back in the same one record read per tree.

EFB (a dataset with a ``bundle``; reference ``_leaf_histogram``,
``build_bundle_tables`` and ``_partition_col``,
lightgbm_tpu/treelearner/serial.py:346-411): the device holds the
[N, Gp] bundle columns, the kernel histograms them at ``Bg`` bins, and
``unpack_bundle_histogram`` turns that into the per-feature [Fp, B]
histogram the scan reads; the partition reads a feature's bin back
through its bundle's member / unmap tables.

Wide bins and f64 sums (reference ``serial.py:952``,
``ops/histogram.py::build_histogram``): the device matrix keeps the
Dataset's dtype, uint16 past 256 bins (a feature's, or an EFB bundle's),
and the histograms are B (or Bg) = the next power of two wide, up to
4096 and past it, through the kernel's uint16 build; the partition reads
a uint16 column through an int16 view. ``tpu_use_f64_hist`` /
``gpu_use_dp`` sum the f32 rows in f64 and round each histogram once to
f32; the learner works in f32 from there, as the reference's does.

Sampling and the per-node filters (reference ``SerialTreeLearner.train``,
lightgbm_tpu/treelearner/serial.py:1140-1205; ``capabilities.py``):

- ``feature_fraction`` gives each tree a mask, copied into the one
  ``feature_mask`` tensor before the root (never a new tensor: the
  captured step reads that storage on every replay);
- ``extra_trees`` scans one random threshold per feature and node
  (``ops/split.py::make_rand_bins``) under the tree's key
  ``PRNGKey((extra_seed + 7919 * tree) & 0x7FFFFFFF)``, filled into one
  device key before the root; the root folds in node id 0, a split's
  children ``2 * new_leaf`` and ``2 * new_leaf + 1`` from the device's
  ``new_leaf``, so the whole-tree step stays free of host reads;
- GOSS reaches the learner as scaled gradients and a bag
  (``boosting/sample_strategy.py``);
- CEGB, then per-node masks (``feature_fraction_bynode``,
  ``interaction_constraints``), take the per-split loop whatever
  ``tpu_fused_tree`` says: their masks and penalties follow host state
  that each split changes, so they read one record per split
  (``grow_stats["split_reads"]``), as in the reference.

Monotone constraints, forced splits (reference
lightgbm_tpu/treelearner/serial.py:91-95,436-452,705-835,1074-1131):

- the basic method runs in every loop: a monotone learner's scan (a
  static switch) clamps each leaf's outputs into the bounds its
  candidate row carries and writes the bounds each child inherits into
  the row, so the whole-tree step reads them from the device like the
  rest of the record; the root scans under (-inf, +inf), at depth 0;
- ``monotone_constraints_method=intermediate`` and ``advanced`` take
  the per-split loop of ``capabilities.py``'s ``_grow_monotone``: host-tracked
  bounds (``monotone.py``), one record read per split, rescans of the
  leaves whose bounds tightened and one read after them
  (``grow_stats["rescans"]``);
- forced splits (``forcedsplits_filename``) are applied breadth-first
  after the root, each from a cumsum of its leaf's stored histogram
  row (gain 0, one record read each), then the loop the config asks for
  goes on; the whole-tree loop starts its step counter after them, and
  its replay applies those first records whatever their gain.

Quantized-gradient mode (``use_quantized_grad``; reference:
``CapabilityMixin._init_quantization`` / ``_quantize_stage``,
lightgbm_tpu/treelearner/capabilities.py:109-162) stages each tree's
rows as int8/int16 ``(q_grad, q_hess, in_bag, 1)`` under the tree's
stochastic-rounding key, keeps int32 histograms (the sibling
subtraction is exact), takes exact integer root sums and dequantizes
them once, and hands the tree's scales to every split scan.

Telemetry (``obs/``; reference serial.py:976, :1148-1259): the stages
``io::stage_bins_device``, ``tree::stage_gh`` and
``tree::root_histogram`` (with ``watch_ready`` on their outputs), then
``tree::split_batches`` over the whole-tree loop's steps and its record
read, and ``tree::apply_records`` over the replay into the host tree.
No scope, event or ``watch_ready`` sits inside :meth:`_step`: a CUDA
event recorded while the step is captured would land in the graph. Each
capture counts under ``graph_capture/serial.split_step``
(``obs/compile.py``).
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..io.binning import MissingType
from ..io.dataset import BinnedDataset
from ..models.tree import Tree
from ..obs import compile as obs_compile
from ..obs.registry import registry as obs
from ..ops import split as S
from ..ops.histogram import (build_histogram, subtract_histogram,
                             unpack_bundle_histogram)
from ..ops.quantize import (dequantize_sums, effective_quant_max,
                            quant_dtype, quant_warn_capped, quantize_gh,
                            sum_gh, tree_key)
from ..ops.split import (FeatureMeta, RecordLayout, SplitParams,
                         calculate_leaf_output, cat_mask_of_row,
                         cegb_penalty, find_best_split, make_rand_bins,
                         pad_feature_meta, prefix_sum, unpack_cat_mask)
from ..utils import log, next_pow2
from ..utils.log import LightGBMError
from ..utils.prng import PRNGKey, fold_in
from .capabilities import CapabilityMixin

#: whole-tree loop: split steps per chunk between two reads of the step
#: counter (a tree that ends early stops at the end of its chunk; the
#: steps after its end change nothing, so the trees do not depend on it)
FUSED_CHUNK = 32


class SplitRecord(NamedTuple):
    """One winning split, read back to the host (f32 values as floats);
    a categorical winner also carries its left-bin mask."""
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
    is_categorical: bool = False
    cat_mask: Optional[np.ndarray] = None

    @classmethod
    def from_row(cls, leaf: int, row: List[float],
                 layout: RecordLayout) -> "SplitRecord":
        """From a record row of :func:`find_best_split` in the learner's
        ``layout`` (its switches say which optional columns the row has;
        its length alone cannot); a categorical winner's mask is
        unpacked over its bins."""
        cat = layout.has_categorical and row[S.IS_CATEGORICAL] > 0
        return cls(leaf, row[S.GAIN], int(row[S.FEATURE]),
                   int(row[S.THRESHOLD_BIN]), bool(row[S.DEFAULT_LEFT]),
                   *row[S.LEFT_SUM_GRAD:S.RECORD_WIDTH], cat,
                   cat_mask_of_row(row, layout.num_bins) if cat else None)


class GrowState(NamedTuple):
    """Per-tree device state (the whole-tree loop keeps one set per
    learner, refilled by each tree's root, at fixed addresses for its
    graph)."""
    leaf_of_row: torch.Tensor     # [N] int32
    gh: torch.Tensor              # [N, 4] (grad, hess, in-bag, total):
    #                               f32, or int8/int16 when quantized
    hists: torch.Tensor           # [L, Fp, B, 4] f32 (int32 quantized)
    cand: torch.Tensor            # [L, W] f32 best candidates (W: record
    #                               width, wider with categorical features)
    leaf_depth: torch.Tensor      # [L] int32
    step: torch.Tensor            # 0-d int32: splits applied so far
    records: torch.Tensor         # [L - 1, 1 + W] f32: split i's leaf,
    #                               then its record row


def record_is_valid(rec: SplitRecord) -> bool:
    """Host twin of :func:`record_valid` (the two must agree: the device
    leaves the state alone after an invalid record, the host stops
    replaying at it)."""
    return (rec.feature >= 0 and np.isfinite(rec.gain)
            and rec.gain > 0.0)


def record_valid(row: torch.Tensor) -> torch.Tensor:
    """Device twin of :func:`record_is_valid` over a record row
    (reference ``rec_valid``); a 0-d bool tensor, or [n] over a [W, n]
    column block of n rows."""
    gain = row[S.GAIN]
    return (row[S.FEATURE] >= 0) & torch.isfinite(gain) & (gain > 0.0)


def apply_split_record(tree: Tree, dataset: BinnedDataset,
                       rec: SplitRecord) -> None:
    """Replay one split record into the host Tree (reference: the
    Tree::Split / Tree::SplitCategorical call of
    SerialTreeLearner::Split, serial_tree_learner.cpp:593). A
    categorical split stores the category values of its left bins."""
    f = rec.feature
    mapper = dataset.bin_mappers[f]
    common = dict(
        leaf=rec.leaf, feature=dataset.real_feature_index(f),
        feature_inner=f,
        left_value=rec.left_output, right_value=rec.right_output,
        left_count=int(round(rec.left_count)),
        right_count=int(round(rec.right_count)),
        left_weight=rec.left_sum_hess, right_weight=rec.right_sum_hess,
        gain=rec.gain)
    if rec.is_categorical:
        cats = [mapper.bin_2_categorical[b]
                for b in np.nonzero(rec.cat_mask)[0]
                if b < len(mapper.bin_2_categorical)]
        tree.split_categorical(cat_values=cats, bin_mask=rec.cat_mask,
                               **common)
        return
    tree.split(threshold_bin=rec.threshold_bin,
               threshold_real=dataset.real_threshold(f, rec.threshold_bin),
               missing_type=mapper.missing_type,
               default_left=rec.default_left, **common)


def go_left_on_device(col: torch.Tensor, tbin: torch.Tensor,
                      default_left: torch.Tensor, missing_type: torch.Tensor,
                      nan_bin: torch.Tensor,
                      zero_bin: torch.Tensor) -> torch.Tensor:
    """Training-time split direction over bin values, the split's values
    as device tensors (reference ``_go_left_by_bin``, after
    DenseBin::Split, src/io/dense_bin.hpp): a NaN-missing feature
    sends its NaN bin, a zero-missing one its zero bin, the default
    way."""
    special = (((missing_type == MissingType.NAN) & (col == nan_bin))
               | ((missing_type == MissingType.ZERO) & (col == zero_bin)))
    return torch.where(special, default_left, col <= tbin)


class BundleTables(NamedTuple):
    """The EFB layout on the device (reference ``BundleTables``):
    ``member[g, b]`` / ``unmap[g, b]`` take a bundle bin back to its
    feature and that feature's bin; ``gidx_g`` / ``gidx_b`` gather the
    bundle histogram into per-feature histograms; ``zero_fix`` marks the
    features whose zero bin is rebuilt from the leaf's totals."""
    group_of: torch.Tensor      # [Fp] int64
    member: torch.Tensor        # [Gp, Bg] int64 (-1: none)
    unmap: torch.Tensor         # [Gp, Bg] int64
    gidx_g: torch.Tensor        # [Fp, B] int32 (-1: empty)
    gidx_b: torch.Tensor        # [Fp, B] int32
    zero_fix: torch.Tensor      # [Fp] bool


def build_bundle_tables(dataset: BinnedDataset, Fp: int, Gp: int, B: int,
                        Bg: int, device: torch.device) -> BundleTables:
    """Device EFB tables from the dataset's BundleLayout, padded to
    ``Fp`` features and ``Gp`` bundle columns (reference
    ``build_bundle_tables``)."""
    lay = dataset.bundle
    F, G = dataset.num_features, lay.num_groups
    member = np.full((Gp, Bg), -1, dtype=np.int64)
    member[:G, :lay.member.shape[1]] = lay.member
    unmap = np.zeros((Gp, Bg), dtype=np.int64)
    unmap[:G, :lay.unmap.shape[1]] = lay.unmap
    group_of = np.zeros(Fp, dtype=np.int64)
    group_of[:F] = lay.group_of
    gidx_g = np.full((Fp, B), -1, dtype=np.int32)
    gidx_b = np.zeros((Fp, B), dtype=np.int32)
    gidx_g[:F, :lay.gidx_g.shape[1]] = lay.gidx_g
    gidx_b[:F, :lay.gidx_b.shape[1]] = lay.gidx_b
    zero_fix = np.zeros(Fp, dtype=bool)
    zero_fix[:F] = lay.needs_zero_fix

    def t(a):
        return torch.from_numpy(a).to(device)
    return BundleTables(group_of=t(group_of), member=t(member),
                        unmap=t(unmap), gidx_g=t(gidx_g), gidx_b=t(gidx_b),
                        zero_fix=t(zero_fix))


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


class SerialTreeLearner(CapabilityMixin):
    """Leaf-wise grower over a device-resident binned dataset."""

    #: the device holds EFB bundle columns when the dataset has them (the
    #: feature- and voting-parallel learners unbundle instead)
    _supports_bundles = True

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
        self.Fp = self._padded_features(F)
        # EFB: the device holds the bundle columns (padded to a multiple
        # of 8 too) and the kernel sums them at Bg bins
        self._bundled = dataset.bundle is not None and self._supports_bundles
        #: per-leaf histogram slots (the voting learner keeps one)
        self._hist_slots = self.L
        ncols = dataset.bundle.num_groups if self._bundled else F
        self.Gp = -(-ncols // 8) * 8
        # the dataset's bin dtype: uint8, or uint16 past 256 bins (the
        # kernel's uint16 build sums those)
        self._stage_bins(dataset, ncols)
        # f64 histogram sums, rounded once to f32 (tpu_use_f64_hist)
        self._f64 = config.f64_histograms
        self.Bg, self._btab = 0, None
        if self._bundled:
            self.Bg = next_pow2(max(dataset.bundle.num_bundled_bins, 2))
            self._btab = build_bundle_tables(dataset, self.Fp, self.Gp,
                                             self.B, self.Bg, device)
        self.meta = pad_feature_meta(
            FeatureMeta.from_dataset(dataset, device,
                                     int(config.max_cat_to_onehot)),
            self.Fp - F)
        # static, as in the reference: an all-numerical learner runs no
        # categorical scan and keeps the 14-column record; a learner
        # with no monotone feature runs no monotone part of the scan
        self._has_cat = self.meta.cat_positions > 0
        self._has_mono = self.meta.monotone is not None
        self.layout = RecordLayout(self.B, self._has_cat, self._has_mono)
        self._record_width = self.layout.width
        self.params = SplitParams.from_config(config, device)
        # the tree's feature mask: each tree's is copied into this one
        # tensor (the captured step reads its storage)
        self._mask_host = np.zeros(self.Fp, dtype=bool)
        self._mask_host[:F] = True
        self.feature_mask = torch.from_numpy(self._mask_host.copy()).to(
            device)
        self._extra_trees = bool(config.extra_trees)
        self._extra_seed = int(config.extra_seed)
        # the tree's extra_trees key [0, seed], refilled before each root
        self._extra_key = PRNGKey(0, device)
        self._init_capabilities(config)
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
        #: tree), split steps run (eagerly or replayed; a forced split is
        #: one), graph replays and captures, capture ms, host reads of
        #: the step counter, of the tree's records (one per tree), of
        #: single records (per split in the per-split loop, and after
        #: the rescans of the intermediate and advanced monotone
        #: methods), of forced-split records (one per forced node
        #: tried), and those rescans
        self.grow_stats: Dict[str, float] = dict.fromkeys(
            ("roots", "steps", "replays", "captures", "capture_ms",
             "flag_reads", "record_reads", "split_reads", "forced_reads",
             "rescans"), 0)

    @staticmethod
    def _padded_features(F: int) -> int:
        return -(-F // 8) * 8

    def _stage_bins(self, dataset: BinnedDataset, ncols: int) -> None:
        """The binned rows on the device, their columns padded to
        ``Gp`` (bundled) or ``Fp``: the bundle columns, or per-feature
        columns (unbundled from a bundled dataset where the learner does
        not take bundles); the out-of-core learner stages them shard by
        shard instead."""
        bins = np.zeros((self.N, self.Gp if self._bundled else self.Fp),
                        dtype=dataset.bins.dtype)
        bins[:, :ncols] = (dataset.bins if self._bundled
                           or dataset.bundle is None
                           else dataset.feature_bins())
        with obs.scope("io::stage_bins_device"):
            self.bins = torch.from_numpy(bins).to(self.device)

    def bin_blocks(self):
        """(first row, [n, Fp] device bins) blocks that cover the
        training rows in order: the resident matrix as one block (the
        out-of-core learner yields one per shard); what the boosting
        layer replays trees over."""
        yield 0, self.bins

    def reset_config(self, config) -> None:
        """New split parameters, depth limit and loop choice between trees
        (reference: ``ops_refresh.refresh_learner_params``;
        ``feature_fraction`` and ``feature_fraction_bynode`` are read
        from the config at each tree). The captured step holds the old
        ones (its parameter tensors and ``max_depth``), so the graph is
        dropped and the next tree captures it again. ``extra_trees`` and
        ``extra_seed`` keep their first values, as in the reference
        (upstream LightGBM would take the new ones)."""
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

    def _leaf_histogram(self, gh: torch.Tensor,
                        idx: Optional[torch.Tensor] = None,
                        count: Optional[torch.Tensor] = None,
                        totals: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """[Fp, B, 4] histogram of the rows (all, or ``idx[:count]``).
        Bundled (reference ``_leaf_histogram``): the kernel sums the
        bundle columns at Bg bins and the result is unpacked, a shared
        feature's zero bin rebuilt as ``totals`` (the rows' f32 channel
        sums) minus its other bins. Integer rows take exact totals
        instead, as the reference recomputes them (``serial.py:500``):
        the sums of bundle column 0's bins, where every row sits in one
        bin."""
        return self._unpack(build_histogram(self.bins, gh, self._width(),
                                            idx, count, f64=self._f64),
                            gh, totals)

    def _width(self) -> int:
        """Bins per histogram row the kernel sums: Bg bundled, else B."""
        return self.Bg if self._bundled else self.B

    def _unpack(self, bhist: torch.Tensor, gh: torch.Tensor,
                totals: Optional[torch.Tensor]) -> torch.Tensor:
        """The kernel's histogram as the scan's per-feature [Fp, B, 4]
        one: as it is, or unpacked from the bundle columns (after the
        cross-shard sum, on the mesh learners)."""
        if not self._bundled:
            return bhist
        if not gh.dtype.is_floating_point:
            totals = bhist[0].sum(dim=0, dtype=bhist.dtype)
        bt = self._btab
        return unpack_bundle_histogram(bhist, bt.gidx_g, bt.gidx_b,
                                       bt.zero_fix, self.meta.zero_bin,
                                       totals)

    def _bin_column(self, col: torch.Tensor) -> torch.Tensor:
        """[N] int32 bin values of device column ``col`` (a [1] int64
        tensor): uint16 bins are read through an int16 view (torch's
        uint16 is a limited dtype on the card) and masked back."""
        if self.bins.dtype == torch.uint16:
            v = self.bins.view(torch.int16).index_select(1, col).view(-1)
            return v.to(torch.int32) & 0xFFFF
        return self.bins.index_select(1, col).view(-1).to(torch.int32)

    def _go_left(self, row: torch.Tensor) -> torch.Tensor:
        """[N] bool: the rows that the record row ``row`` sends left
        (reference ``_partition_col`` + ``_go_left_by_bin``): the split
        feature's own bin, read through its bundle's tables when
        bundled, and its missing rule by gather from the device meta; a
        categorical winner sends the bins of its mask left. Device
        values only: no host read."""
        meta = self.meta
        f = torch.clamp(row[S.FEATURE], min=0.0).long().view(1)
        zero_bin = meta.zero_bin.index_select(0, f)
        if self._bundled:
            bt = self._btab
            g = bt.group_of.index_select(0, f)
            raw = self._bin_column(g).long()
            owner = bt.member.index_select(0, g).view(-1).index_select(
                0, raw)
            col = torch.where(
                owner == f,
                bt.unmap.index_select(0, g).view(-1).index_select(0, raw),
                zero_bin).to(torch.int32)
        else:
            col = self._bin_column(f)
        gl = go_left_on_device(
            col, row[S.THRESHOLD_BIN].to(torch.int32),
            row[S.DEFAULT_LEFT] > 0.0, meta.missing_type.index_select(0, f),
            meta.num_bin.index_select(0, f) - 1, zero_bin)
        if self._has_cat:
            mask = unpack_cat_mask(row[self.layout.cat_words], self.B)
            gl = torch.where(row[S.IS_CATEGORICAL] > 0.0,
                             mask.index_select(0, col.long()), gl)
        return gl

    def _scan(self, hist, sums, parent_out, qscale, mask=None,
              rand_bins=None, penalty=None, bounds=(None, None),
              depth=None, bound_arrays=None) -> torch.Tensor:
        """One leaf's scan; ``bounds`` (min, max output; None for -inf,
        +inf), ``depth`` and ``bound_arrays`` reach a monotone learner's
        scan only."""
        return find_best_split(hist, sums[0], sums[1], sums[2], sums[3],
                               self.meta, self.params,
                               self.feature_mask if mask is None else mask,
                               parent_out, qscale, self._has_cat,
                               rand_bins, penalty, self._has_mono,
                               bounds[0], bounds[1], depth, bound_arrays)

    def _child_bounds(self, row: torch.Tensor, c: int) -> tuple:
        """Child ``c``'s (min, max) output bounds from a monotone
        learner's record row (device values), else (None, None)."""
        if not self._has_mono:
            return None, None
        at = self.layout.bounds + 2 * c
        return row[at], row[at + 1]

    def _depth(self, depth: int) -> Optional[torch.Tensor]:
        """A leaf depth as the f32 0-d tensor a monotone scan's gain
        penalty reads (None for other learners)."""
        if not self._has_mono:
            return None
        return torch.full((), float(depth), device=self.device)

    def _draws_thresholds(self) -> bool:
        """extra_trees is on (CEGB and the intermediate and advanced
        monotone methods ignore it)."""
        return (self._extra_trees and not self._cegb_enabled
                and self._mono_tracker is None)

    def _rand_bins(self, node_ids: torch.Tensor) -> tuple:
        """The extra_trees candidates of nodes ``node_ids`` (int64 [c] on
        the device): three int32 [c, Fp] tensors, from the tree's key
        folded with each node id."""
        keys = fold_in(self._extra_key, node_ids)
        return make_rand_bins(keys, self.meta, self.params)

    def _child_rand_bins(self, new_leaf) -> tuple:
        """Both children's extra_trees candidates, node ids ``2 *
        new_leaf`` and ``2 * new_leaf + 1`` (``new_leaf`` a host int, or
        the step's device tensor), or (None, None) without
        extra_trees."""
        if not self._draws_thresholds():
            return None, None
        rb = self._rand_bins(2 * new_leaf
                             + torch.arange(2, device=self.device))
        return tuple(tuple(r[c] for r in rb) for c in (0, 1))

    def _set_tree_mask(self, mask: np.ndarray) -> None:
        """Copy the tree's mask into ``feature_mask`` when it changed (on
        the card from pinned memory, with no host sync)."""
        if np.array_equal(mask, self._mask_host):
            return
        self._mask_host = mask
        src = torch.from_numpy(mask)
        if self.device.type == "cuda":
            self.feature_mask.copy_(src.pin_memory(), non_blocking=True)
        else:
            self.feature_mask.copy_(src)

    def _splittable(self, depth: int) -> bool:
        return self.max_depth <= 0 or depth < self.max_depth

    def _store(self, cand: torch.Tensor, leaf: int, info: torch.Tensor,
               allowed: bool) -> None:
        if not allowed:
            info = info.clone()
            info[S.GAIN].fill_(float("-inf"))
        cand[leaf] = info

    def train(self, grad: torch.Tensor, hess: torch.Tensor,
              bag: Optional[torch.Tensor] = None
              ) -> Tuple[Tree, torch.Tensor]:
        """Grow one tree from f32 [N] gradients; ``bag`` is an optional
        f32 [N] in-bag indicator (0/1). Returns the host Tree and the
        final [N] int32 row->leaf partition (on the device) for the
        score update (reference: GBDT::UpdateScore uses the learner's
        partition, gbdt.cpp:475)."""
        with obs.scope("tree::stage_gh"):
            gh = self._stage_tree(grad, hess, bag)
            obs.watch_ready("tree::stage_gh", gh)
        if self._cegb_enabled:
            tree, state = self._grow_stepped(gh, cegb=True)
        elif self._mono_tracker is not None:
            tree, state = self._grow_monotone(gh)
        elif self._needs_per_node_masks() and self._forced is None:
            tree, state = self._grow_stepped(gh, node_masks=True)
        elif self._fused_growth:
            tree, state = self._grow_fused(gh)
            # the state's buffers are the next tree's
            return tree, state.leaf_of_row.clone()
        else:
            tree, state = self._grow_stepped(gh)
        return tree, state.leaf_of_row

    def _stage_tree(self, grad: torch.Tensor, hess: torch.Tensor,
                    bag: Optional[torch.Tensor]) -> torch.Tensor:
        """A new tree's rows ``(grad, hess, in-bag, 1)`` (quantized under
        the tree's rounding key, which advances here, before any loop),
        its feature mask and its extra_trees key; no host read."""
        ind = self._ones if bag is None else bag
        self._tree_idx += 1
        if self._quantized:
            gh, self._qscale = self._quantize_stage(grad, hess, ind,
                                                    self._tree_idx)
        else:
            gh = torch.stack([grad * ind, hess * ind, ind, self._ones],
                             dim=1)
        self._set_tree_mask(self._sample_features())
        if self._draws_thresholds():
            self._extra_key[1].fill_(
                (self._extra_seed + 7919 * self._tree_idx) & 0x7FFFFFFF)
        return gh

    # ------------------------------------------------------------------
    # the root, shared by both loops
    # ------------------------------------------------------------------
    def _new_state(self, gh: torch.Tensor) -> GrowState:
        L, dev, W = self.L, self.device, self._record_width
        acc = torch.int32 if not gh.dtype.is_floating_point else gh.dtype
        return GrowState(
            leaf_of_row=torch.empty(self.N, dtype=torch.int32, device=dev),
            gh=gh,
            hists=torch.empty((self._hist_slots, self.Fp, self.B, 4),
                              dtype=acc, device=dev),
            cand=torch.empty((L, W), dtype=torch.float32, device=dev),
            leaf_depth=torch.empty(L, dtype=torch.int32, device=dev),
            step=torch.empty((), dtype=torch.int32, device=dev),
            records=torch.empty((max(L - 1, 1), 1 + W),
                                dtype=torch.float32, device=dev))

    def _root(self, state: GrowState) -> None:
        """Fill ``state`` in place for a new tree: the root histogram of
        ``state.gh`` over all rows and its scan in slot 0, every other
        slot empty."""
        with obs.scope("tree::root_histogram"):
            self._root_inner(state)
            obs.watch_ready("tree::root_histogram", state.cand)

    def _root_sums(self, gh: torch.Tensor) -> torch.Tensor:
        """The root's channel sums over every row."""
        return sum_gh(gh, self._padded_rows)

    def _root_histogram(self, gh: torch.Tensor,
                        sums_raw: torch.Tensor) -> torch.Tensor:
        """The root's [Fp, B, 4] histogram over every row."""
        return self._leaf_histogram(gh, totals=sums_raw)

    def _root_inner(self, state: GrowState) -> None:
        gh = state.gh
        # exact integer sums in quantized mode, dequantized once
        sums_raw = self._root_sums(gh)
        sums = dequantize_sums(sums_raw, self._qscale)
        hist = self._root_histogram(gh, sums_raw)
        # root "parent" output: its own unsmoothed output (reference:
        # SerialTreeLearner::GetParentOutput)
        parent_out = calculate_leaf_output(sums[0], sums[1], self.params)
        rand_bins = penalty = None
        if self._draws_thresholds():
            zero = torch.zeros(1, dtype=torch.int64, device=self.device)
            rand_bins = tuple(r[0] for r in self._rand_bins(zero))
        if self._cegb_enabled:
            unfetched = None
            if self._cegb_has_lazy:
                unfetched = (~self._cegb_fetched).sum(
                    0, dtype=torch.int32).to(torch.float32)
            penalty = cegb_penalty(self.params, sums[3], self._cegb_used,
                                   self._cegb_coupled, unfetched,
                                   self._cegb_lazy if unfetched is not None
                                   else None)
        # the root scans at depth 0 (the reference's CEGB root gives no
        # depth, so no monotone penalty)
        info = self._scan(hist, sums, parent_out, self._qscale,
                          rand_bins=rand_bins, penalty=penalty,
                          depth=None if self._cegb_enabled
                          else self._depth(0))
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
    def _grow_stepped(self, gh: torch.Tensor, node_masks: bool = False,
                      cegb: bool = False) -> Tuple[Tree, GrowState]:
        """One host step per split: read the best record back (one read
        per split, ``grow_stats["split_reads"]``; the row list's
        ``torch.nonzero`` syncs too), replay it into the tree, then split
        on the device. With ``node_masks`` (interaction constraints,
        ``feature_fraction_bynode``; reference ``train_stepwise``) the
        host tracks each leaf's feature path and draws both children's
        masks after the split, left then right; the root scans with the
        tree mask alone. ``cegb`` scans the children with CEGB penalties
        that follow the used and fetched state the split leaves behind
        (reference ``train_cegb``). Forced splits come first (not with
        CEGB, which ignores them, as in the reference)."""
        state = self._new_state(gh)
        self._root(state)
        tree = Tree(self.L)
        start = 1
        if self._forced is not None and not cegb:
            start += self._apply_forced(tree, state)
        paths = [frozenset()] * self.L
        for new_leaf in range(start, self.L):
            rec, row, packed = self._read_best(state)
            if not record_is_valid(rec):
                break
            apply_split_record(tree, self.dataset, rec)
            child_depth = int(tree.leaf_depth[rec.leaf])
            state.records[new_leaf - 1] = packed
            state.step.fill_(new_leaf)
            state.leaf_depth[rec.leaf].fill_(child_depth)
            state.leaf_depth[new_leaf].fill_(child_depth)
            masks = (None, None)
            if node_masks:
                path = paths[rec.leaf] | {rec.feature}
                paths[rec.leaf] = paths[new_leaf] = path
                masks = tuple(self._node_mask(self.feature_mask, path)
                              for _ in range(2))
            self._split(state, rec, row, new_leaf, child_depth, masks, cegb)
            self.grow_stats["steps"] += 1
        return tree, state

    def _read_best(self, state: GrowState, with_gains: bool = False):
        """The best candidate, read back (one host read): its record, its
        device row (a copy: the children's candidates overwrite
        ``cand[leaf]``) and the row packed after its leaf; with
        ``with_gains`` also every leaf's candidate gain (host floats)."""
        best = torch.argmax(state.cand[:, S.GAIN])
        row = state.cand[best].clone()
        packed = torch.cat([best.to(torch.float32).view(1), row])
        parts = [packed, state.cand[:, S.GAIN]] if with_gains else [packed]
        host = torch.cat(parts).tolist()
        self.grow_stats["split_reads"] += 1
        W = self._record_width
        rec = SplitRecord.from_row(int(host[0]), host[1:1 + W], self.layout)
        if with_gains:
            return rec, row, packed, host[1 + W:]
        return rec, row, packed

    # ------------------------------------------------------------------
    # forced splits (reference _apply_forced_splits, _forced_fn_cached)
    # ------------------------------------------------------------------
    def _forced_row(self, state: GrowState, leaf: int, f: int,
                    tbin: int) -> torch.Tensor:
        """The record row of splitting ``leaf`` on inner feature ``f`` at
        bin ``tbin``: left sums from the prefix sum of the leaf's stored
        histogram row up to ``tbin`` (exact when integer), gain 0,
        unsmoothed outputs, ``default_left`` where the prefix put the
        missing rows; a monotone row keeps the leaf candidate's child
        bounds."""
        hrow = state.hists[leaf, f]                          # [B, 4]
        if hrow.dtype.is_floating_point:
            cum = prefix_sum(hrow.t().contiguous()).t()
        else:
            cum = torch.cumsum(hrow, dim=0, dtype=hrow.dtype)
        left = dequantize_sums(cum[tbin], self._qscale)
        right = dequantize_sums(cum[-1], self._qscale) - left
        mapper = self.dataset.bin_mappers[f]
        dl = (tbin >= mapper.num_bin - 1
              if mapper.missing_type == MissingType.NAN
              else mapper.default_bin <= tbin)
        row = torch.zeros(self._record_width, dtype=torch.float32,
                          device=self.device)
        # fill_ takes the scalar as a kernel argument: an item assignment
        # would copy it from the host and wait for the card
        row[S.FEATURE].fill_(float(f))
        row[S.THRESHOLD_BIN].fill_(float(tbin))
        row[S.DEFAULT_LEFT].fill_(float(dl))
        for side, sums in ((S.LEFT_SUM_GRAD, left),
                           (S.RIGHT_SUM_GRAD, right)):
            row[side:side + 4] = sums
            row[side + 4] = calculate_leaf_output(sums[0], sums[1],
                                                  self.params)
        if self._has_mono:
            at = self.layout.bounds
            row[at:at + 4] = state.cand[leaf, at:at + 4]
        return row

    def _apply_forced(self, tree: Tree, state: GrowState) -> int:
        """Apply the forced-split tree breadth-first after the root
        (upstream SerialTreeLearner::ForceSplits,
        serial_tree_learner.cpp:451): one record read
        (``grow_stats["forced_reads"]``) and one split per node; a split
        that leaves a side empty is skipped with a warning, its subtree
        too. Records and the step counter are written in place. Returns
        the splits applied."""
        next_leaf = 1
        queue = [(0, self._forced)]
        while queue and next_leaf < self.L:
            leaf, spec = queue.pop(0)
            if not isinstance(spec, dict) or "feature" not in spec:
                continue
            inner = self.dataset.inner_feature_index(int(spec["feature"]))
            if inner < 0:
                continue
            mapper = self.dataset.bin_mappers[inner]
            tbin = int(mapper.value_to_bin(
                np.asarray([float(spec.get("threshold", 0.0))]))[0])
            row = self._forced_row(state, leaf, inner, tbin)
            packed = torch.cat([torch.full((1,), float(leaf),
                                           device=self.device), row])
            host = packed.tolist()
            self.grow_stats["forced_reads"] += 1
            rec = SplitRecord.from_row(leaf, host[1:], self.layout)
            if not (rec.left_total_count > 0.5
                    and rec.right_total_count > 0.5):
                log.warning("Forced split on feature %d leaves an empty "
                            "side; skipped" % int(spec["feature"]))
                continue
            apply_split_record(tree, self.dataset, rec)
            child_depth = int(tree.leaf_depth[leaf])
            state.records[next_leaf - 1] = packed
            state.leaf_depth[leaf].fill_(child_depth)
            state.leaf_depth[next_leaf].fill_(child_depth)
            self._split(state, rec, row, next_leaf, child_depth)
            self.grow_stats["steps"] += 1
            if "left" in spec:
                queue.append((leaf, spec["left"]))
            if "right" in spec:
                queue.append((next_leaf, spec["right"]))
            next_leaf += 1
        state.step.fill_(next_leaf - 1)
        return next_leaf - 1

    # ------------------------------------------------------------------
    # the steps of the intermediate and advanced monotone methods
    # (driven by CapabilityMixin._grow_monotone)
    # ------------------------------------------------------------------
    def _mono_step(self, state: GrowState, rec: SplitRecord,
                   row: torch.Tensor, new_leaf: int, child_depth: int,
                   bounds: tuple) -> None:
        """Split ``rec`` with the children's bounds the host tracker set
        (reference ``_mono_step_fn_cached``): the row's bound columns
        take ``bounds`` (lmin, lmax, rmin, rmax), then the split and
        both children's scans as in the per-split loop."""
        row = row.clone()
        at = self.layout.bounds
        row[at:at + 4] = self._host_to_device(np.asarray(bounds))
        self._split(state, rec, row, new_leaf, child_depth)

    def _host_to_device(self, a: np.ndarray) -> torch.Tensor:
        """An f32 copy of host values on the learner's device, taken now
        (the tracker changes its arrays later); on the card from pinned
        memory without a host sync."""
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _mono_rescan(self, state: GrowState, leaf: int, sums: tuple,
                     bounds: tuple, depth: int,
                     bound_arrays: Optional[tuple] = None) -> None:
        """Scan ``leaf``'s stored histogram again under new bounds and
        store its candidate (upstream RecomputeBestSplitForLeaf,
        serial_tree_learner.cpp:800; reference ``_rescan_fn_cached``):
        ``sums`` are its (grad, hess, count, total) as host floats,
        ``bounds`` its (min, max) output, or ``bound_arrays`` the
        advanced method's [Fp, B] host arrays."""
        dev = self.device
        sg, sh, c, tc = (torch.full((), float(v), device=dev) for v in sums)
        own = calculate_leaf_output(sg, sh, self.params)
        parent_out = torch.where(self.params.path_smooth > 1e-10, own, 0.0)
        lo_hi = tuple(None if b is None else torch.full((), float(b),
                                                        device=dev)
                      for b in bounds)
        arrays = (None if bound_arrays is None else
                  tuple(self._host_to_device(a) for a in bound_arrays))
        info = self._scan(state.hists[leaf], (sg, sh, c, tc), parent_out,
                          self._qscale, bounds=lo_hi,
                          depth=self._depth(depth), bound_arrays=arrays)
        self._store(state.cand, leaf, info, self._splittable(depth))
        self.grow_stats["rescans"] += 1

    def _cegb_penalties(self, rec: SplitRecord, row: torch.Tensor,
                        on_leaf: torch.Tensor, gl: torch.Tensor):
        """Mark the split's feature used and, in lazy mode, fetched by
        every row of the split leaf; return both children's CEGB
        penalties (reference ``_cegb_step_fn_cached``). As in the
        reference, and unlike upstream LightGBM, a coupled penalty
        stored in another leaf's candidate is not refunded when its
        feature becomes used: it keeps the penalty until that leaf is
        scanned again as a child."""
        f = rec.feature
        self._cegb_used[f] = True
        unf = (None, None)
        lazy = None
        if self._cegb_has_lazy:
            rows = torch.nonzero(on_leaf).view(-1)
            self._cegb_fetched[:, f].index_fill_(0, rows, True)
            unfetched = ~self._cegb_fetched.index_select(0, rows)
            gl_rows = gl.index_select(0, rows)[:, None]
            # counts of 0/1 below 2^24 rows: exact integers, exact in f32
            unf = tuple((unfetched & side).sum(0, dtype=torch.int32).to(
                torch.float32) for side in (gl_rows, ~gl_rows))
            lazy = self._cegb_lazy
        return tuple(
            cegb_penalty(self.params, row[count], self._cegb_used,
                         self._cegb_coupled, u, lazy)
            for count, u in ((S.LEFT_TOTAL_COUNT, unf[0]),
                             (S.RIGHT_TOTAL_COUNT, unf[1])))

    def _split(self, state: GrowState, rec: SplitRecord, row: torch.Tensor,
               new_leaf: int, child_depth: int, masks=(None, None),
               cegb: bool = False) -> None:
        """Apply ``rec`` (already replayed into the tree; ``row`` is its
        device copy) and scan both children, under ``masks`` (each None
        for the tree mask) and, with ``cegb``, CEGB penalties. Updates
        ``state`` in place."""
        leaf = rec.leaf
        gl = self._go_left(row)
        on_leaf = state.leaf_of_row == leaf
        pens = (self._cegb_penalties(rec, row, on_leaf, gl) if cegb
                else (None, None))
        state.leaf_of_row.masked_fill_(on_leaf & ~gl, new_leaf)
        hist_left, hist_right, masks = self._split_histograms(
            state, rec, row, new_leaf, masks)

        allowed = self._splittable(child_depth)
        rand_bins = self._child_rand_bins(new_leaf)
        depth = self._depth(child_depth)
        for c, (child, hist, side) in enumerate((
                (leaf, hist_left, S.LEFT_SUM_GRAD),
                (new_leaf, hist_right, S.RIGHT_SUM_GRAD))):
            info = self._scan(hist, row[side:side + 4], row[side + 4],
                              self._qscale, masks[c], rand_bins[c], pens[c],
                              self._child_bounds(row, c), depth)
            self._store(state.cand, child, info, allowed)

    def _split_histograms(self, state: GrowState, rec: SplitRecord,
                          row: torch.Tensor, new_leaf: int, masks: tuple):
        """The per-split loop's children histograms, after the partition:
        the smaller child's from its rows (``torch.nonzero``, a host
        sync), the sibling by subtraction, both stored. Returns them with
        the children's scan masks (each None for the tree mask)."""
        leaf = rec.leaf
        smaller_is_left = rec.left_total_count <= rec.right_total_count
        small_id = leaf if smaller_is_left else new_leaf
        idx = torch.nonzero(state.leaf_of_row == small_id).view(-1).to(
            torch.int32)
        side = S.LEFT_SUM_GRAD if smaller_is_left else S.RIGHT_SUM_GRAD
        hist_small = self._leaf_histogram(state.gh, idx,
                                          totals=row[side:side + 4])
        hist_large = subtract_histogram(state.hists[leaf], hist_small)
        hist_left, hist_right = ((hist_small, hist_large) if smaller_is_left
                                 else (hist_large, hist_small))
        state.hists[leaf] = hist_left
        state.hists[new_leaf] = hist_right
        return hist_left, hist_right, masks

    # ------------------------------------------------------------------
    # the whole-tree loop (tpu_fused_tree=true, the default)
    # ------------------------------------------------------------------
    def _fused_buffers(self, gh: torch.Tensor) -> _FusedBuffers:
        """The loop's fixed buffers, made at the first tree; each tree
        copies its rows and scales into them."""
        if self._fused is None:
            dev = self.device
            state = self._new_state(torch.empty_like(gh))
            idx, rows, count = self._row_list_buffers()
            self._fused = _FusedBuffers(
                state=state, idx=idx, rows=rows, count=count,
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

    def _row_list_buffers(self):
        """The whole-tree loop's row list (with a trash slot), the row
        ids it is filled from and the list's length on the device."""
        dev = self.device
        return (torch.zeros(self.N + 1, dtype=torch.int32, device=dev),
                torch.arange(self.N, dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev))

    def _step(self, buf: _FusedBuffers) -> None:
        """One split of the whole tree, on the device with no host read:
        the reference's ``_split_body`` + ``_finish_split``. Every write
        is guarded by the step's validity (a valid best record, and
        fewer than L - 1 splits so far), so a step after the tree's end
        changes nothing."""
        st = buf.state
        row, valid, leaf, new_leaf = self._step_partition(st)
        smaller_is_left = (row[S.LEFT_TOTAL_COUNT]
                           <= row[S.RIGHT_TOTAL_COUNT])
        small_id = torch.where(smaller_is_left, leaf, new_leaf)
        small_totals = torch.where(
            smaller_is_left, row[S.LEFT_SUM_GRAD:S.LEFT_SUM_GRAD + 4],
            row[S.RIGHT_SUM_GRAD:S.RIGHT_SUM_GRAD + 4])
        hist_small = self._child_histogram(buf, small_id, valid,
                                           small_totals)
        self._finish_split(st, leaf, new_leaf, row, hist_small, valid,
                           buf.qscale)

    def _step_partition(self, st: GrowState):
        """The head of a split step: the best candidate (first maximum)
        and its validity, the leaf and the new leaf ([1] int64), and the
        partition (reference _split_body :473-486), with no host read."""
        i, L = st.step, self.L
        best = torch.argmax(st.cand[:, S.GAIN]).view(1)   # first maximum
        row = st.cand.index_select(0, best).view(-1)      # a copy
        valid = record_valid(row) & (i < L - 1)
        new_leaf = torch.clamp(i.long() + 1, max=L - 1).view(1)
        gl = self._go_left(row)
        move = (st.leaf_of_row == best) & ~gl & valid
        st.leaf_of_row.copy_(torch.where(move, new_leaf.to(torch.int32),
                                         st.leaf_of_row))
        return row, valid, best, new_leaf

    def _child_histogram(self, buf: _FusedBuffers, child: torch.Tensor,
                         valid: torch.Tensor,
                         totals: torch.Tensor) -> torch.Tensor:
        """The histogram of leaf ``child``'s rows (none unless ``valid``):
        its rows, ascending (torch.nonzero's list), go into the fixed row
        list, the others to its trash slot N, and the kernel's
        device-count entry sums them."""
        st = buf.state
        is_child = (st.leaf_of_row == child) & valid
        pos = torch.cumsum(is_child, 0, dtype=torch.int32)
        buf.count.copy_(pos[-1:])
        dest = torch.where(is_child, pos - 1, self.N)
        buf.idx.scatter_(0, dest.long(), buf.rows)
        return self._leaf_histogram(st.gh, buf.idx, buf.count, totals)

    def _finish_split(self, st: GrowState, leaf: torch.Tensor,
                      new_leaf: torch.Tensor, row: torch.Tensor,
                      hist_small: torch.Tensor, valid: torch.Tensor,
                      qscale: Optional[torch.Tensor]) -> None:
        """The tail of a split step after the smaller child's histogram
        (reference ``_finish_split``): the sibling by subtraction, both
        children's histograms, depths, scans and candidates stored, the
        record written and the step counter advanced, every write
        guarded by ``valid``. ``leaf`` and ``new_leaf`` are [1] int64
        device tensors and ``row`` the split's record row; the
        out-of-core learner calls it once per split of a sweep round."""
        smaller_is_left = (row[S.LEFT_TOTAL_COUNT]
                           <= row[S.RIGHT_TOTAL_COUNT])
        hist_large = subtract_histogram(
            st.hists.index_select(0, leaf).squeeze(0), hist_small)
        hist_left = torch.where(smaller_is_left, hist_small, hist_large)
        hist_right = torch.where(smaller_is_left, hist_large, hist_small)
        _put(st.hists, leaf, hist_left, valid)
        _put(st.hists, new_leaf, hist_right, valid)
        self._finish_children(st, leaf, new_leaf, row, hist_left,
                              hist_right, valid, qscale)

    def _finish_children(self, st: GrowState, leaf: torch.Tensor,
                         new_leaf: torch.Tensor, row: torch.Tensor,
                         hist_left: torch.Tensor, hist_right: torch.Tensor,
                         valid: torch.Tensor,
                         qscale: Optional[torch.Tensor],
                         masks: tuple = (None, None)) -> None:
        """Both children's depths, scans (under ``masks``, each None for
        the tree mask) and candidates, the record and the step counter,
        every write guarded by ``valid``."""
        i, L = st.step, self.L
        # depth gating and both children's scans (reference
        # _finish_split)
        child_depth = st.leaf_depth.index_select(0, leaf) + 1
        _put(st.leaf_depth, leaf, child_depth[0], valid)
        _put(st.leaf_depth, new_leaf, child_depth[0], valid)
        rand_bins = self._child_rand_bins(new_leaf)
        depth = child_depth[0].to(torch.float32) if self._has_mono else None
        for c, (child, hist, side) in enumerate((
                (leaf, hist_left, S.LEFT_SUM_GRAD),
                (new_leaf, hist_right, S.RIGHT_SUM_GRAD))):
            info = self._scan(hist, row[side:side + 4], row[side + 4],
                              qscale, mask=masks[c], rand_bins=rand_bins[c],
                              bounds=self._child_bounds(row, c),
                              depth=depth)
            if self.max_depth > 0:
                gain = torch.where(child_depth < self.max_depth,
                                   info[S.GAIN:S.GAIN + 1], float("-inf"))
                info = torch.cat([gain, info[S.GAIN + 1:]])
            _put(st.cand, child, info, valid)
        slot = torch.clamp(i.long(), max=L - 2).view(1)
        _put(st.records, slot,
             torch.cat([leaf.to(torch.float32), row]), valid)
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
            # thread_local: a server or another learner may use the
            # card from its own thread meanwhile (the refresh loop);
            # "global" would make their syncs fail this capture
            with torch.cuda.graph(graph,
                                  capture_error_mode="thread_local"):
                self._step(buf)
        except RuntimeError as exc:
            raise LightGBMError("whole-tree loop: capturing the split step "
                                "as a CUDA graph failed: %s" % exc) from exc
        seconds = time.perf_counter() - t0
        self.grow_stats["capture_ms"] += 1e3 * seconds
        self.grow_stats["captures"] += 1
        obs_compile.record_graph_capture("serial.split_step", seconds)
        self._graph = graph

    def _captures_steps(self) -> bool:
        """Whether the step is captured as a CUDA graph on the card (the
        mesh learners run it eagerly where a step crosses devices or
        processes)."""
        return True

    def _replay(self) -> None:
        try:
            self._graph.replay()
        except RuntimeError as exc:
            raise LightGBMError("whole-tree loop: replaying the split step "
                                "failed: %s" % exc) from exc
        self.grow_stats["replays"] += 1
        self.grow_stats["steps"] += 1

    def _grow_fused(self, gh: torch.Tensor) -> Tuple[Tree, GrowState]:
        """The reference's ``_train_fused``: the root, the forced splits
        (host-stepped, their records written in place), then up to L - 1
        split steps in all on the device (graph replays on CUDA, in
        chunks of :data:`FUSED_CHUNK` with one read of the step counter
        between chunks), then one read of the tree's records, replayed
        into the host Tree after the forced ones."""
        buf = self._fused_buffers(gh)
        self._root(buf.state)
        tree = Tree(self.L)
        forced = (self._apply_forced(tree, buf.state)
                  if self._forced is not None else 0)
        with obs.scope("tree::split_batches"):
            self._run_steps(buf, self.L - 1 - forced, forced,
                            read_flags=True)
            records = buf.state.records.cpu().tolist()
            self.grow_stats["record_reads"] += 1
        with obs.scope("tree::apply_records"):
            # the forced records (gain 0) are in the tree already
            for row in records[forced:]:
                rec = SplitRecord.from_row(int(row[0]), row[1:],
                                           self.layout)
                if not record_is_valid(rec):
                    break
                apply_split_record(tree, self.dataset, rec)
        return tree, buf.state

    def _run_steps(self, buf: _FusedBuffers, steps: int, start: int,
                   read_flags: bool) -> None:
        """Up to ``steps`` split steps after ``start`` applied ones (graph
        replays on CUDA, the step eagerly on the CPU). With
        ``read_flags``, one read of the step counter per
        :data:`FUSED_CHUNK` steps stops a tree that ended; without, all
        ``steps`` run (those past the tree's end change nothing)."""
        done = 0
        if (self.device.type == "cuda" and self._graph is None
                and steps > 0 and self._captures_steps()):
            self._capture(buf)
            done = 1
        while done < steps:
            k = (min(FUSED_CHUNK - done % FUSED_CHUNK, steps - done)
                 if read_flags else steps - done)
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
                if int(buf.state.step) < start + done:
                    break

    # ------------------------------------------------------------------
    # batched iterations (reference parallel/data_parallel.py train_many)
    # ------------------------------------------------------------------
    def supports_train_many(self) -> bool:
        """True when T boosting iterations can run with no host read
        (reference ``supports_train_many``, data_parallel.py:800): the
        whole-tree loop, and no setting that needs per-split or per-tree
        host state: CEGB, a host monotone tracker, per-node masks,
        ``0 < feature_fraction < 1`` (a host draw per tree) or forced
        splits (the reference keeps those on its serial learner)."""
        return (self._fused_growth and self._forced is None
                and not self._cegb_enabled and self._mono_tracker is None
                and not self._needs_per_node_masks()
                and not 0.0 < float(self.config.feature_fraction) < 1.0)

    def _leaf_outputs(self, records: torch.Tensor) -> torch.Tensor:
        """[L] f32 final leaf outputs from a tree's record buffer
        (reference ``_leaf_outputs_from_records``): split i writes its
        left output to its leaf and its right output to leaf i + 1, and
        the last write to a leaf wins. Done as one scatter: each leaf
        keeps the write with the largest (step, side) order."""
        L, dev = self.L, self.device
        n = records.shape[0]
        rows = records[:, 1:]
        valid = record_valid(rows.t()).repeat(2)
        order = torch.arange(n, device=dev)
        target = torch.where(valid, torch.cat([records[:, 0].long(),
                                               order + 1]), L)
        when = torch.cat([2 * order, 2 * order + 1])
        last = torch.full((L + 1,), -1, dtype=torch.int64,
                          device=dev).scatter_reduce(0, target, when, "amax")
        target = torch.where(when == last[target], target, L)
        value = torch.cat([rows[:, S.LEFT_OUTPUT], rows[:, S.RIGHT_OUTPUT]])
        out = torch.zeros(L + 1, dtype=torch.float32, device=dev)
        return out.scatter_(0, target, value)[:L]

    def train_many(self, grad_fn, sample, score: torch.Tensor,
                   iters: List[int], shrinkage: float) -> torch.Tensor:
        """Run ``len(iters)`` boosting iterations with no host read until
        one read of all their records (reference ``train_many``,
        data_parallel.py:986, ``_many_impl`` / ``_many_impl_multi``).
        ``score`` is the [N, K] training score, updated in place;
        ``grad_fn`` the objective's gradients of it ([N] for K = 1);
        ``sample`` a strategy whose ``device_draw`` keys on the absolute
        iteration numbers ``iters`` (None: every row in bag). For each
        iteration and class, as the looped path does it: the tree's
        rows, root and L - 1 steps (replays with no flag read), its leaf
        outputs from its own records, then ``score += f32(f64(out) *
        shrinkage)[leaf_of_row]``, the looped update's rounding. After an
        iteration where no class grew, the score stays as it is and the
        later records read as invalid (the reference's ``alive`` flag
        and -inf gains). Returns the host [T, K, L - 1, 1 + W] records:
        the one host read of the batch."""
        host = self._train_many_on_device(grad_fn, sample, score, iters,
                                           shrinkage).cpu()
        self.grow_stats["record_reads"] += 1
        return host

    def _train_many_on_device(self, grad_fn, sample, score: torch.Tensor,
                              iters: List[int],
                              shrinkage: float) -> torch.Tensor:
        """:meth:`train_many` up to its read: the [T, K, L - 1, 1 + W]
        records on the learner's device."""
        if not self.supports_train_many():
            raise LightGBMError("train_many needs the whole-tree loop "
                                "and no per-split host state")
        K, dev = score.shape[1], self.device
        out = torch.empty((len(iters), K, max(self.L - 1, 1),
                           1 + self._record_width), dtype=torch.float32,
                          device=dev)
        dead = torch.zeros(1 + self._record_width, dtype=torch.float32,
                           device=dev)
        dead[1 + S.GAIN].fill_(float("-inf"))
        dead[1 + S.FEATURE].fill_(-1.0)
        alive = torch.ones((), dtype=torch.bool, device=dev)
        for t, it in enumerate(iters):
            grad, hess = grad_fn(score[:, 0] if K == 1 else score)
            bag = None
            if sample is not None:
                grad, hess, bag = sample.device_draw(it, grad, hess)
            grew = torch.zeros((), dtype=torch.bool, device=dev)
            for k in range(K):
                gk = grad if K == 1 else grad[:, k].contiguous()
                hk = hess if K == 1 else hess[:, k].contiguous()
                buf = self._fused_buffers(self._stage_tree(gk, hk, bag))
                self._root(buf.state)
                self._run_steps(buf, self.L - 1, 0, read_flags=False)
                st = buf.state
                grew_k = record_valid(st.records[0, 1:])
                grew |= grew_k
                out[t, k] = torch.where(alive, st.records, dead)
                lv = (self._leaf_outputs(st.records).double()
                      * float(shrinkage)).float()
                col = score[:, k]
                col.copy_(torch.where(alive & grew_k,
                                      col + lv[st.leaf_of_row.long()], col))
            alive &= grew
        return out
