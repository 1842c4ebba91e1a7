"""StackedForest: the whole forest in one device pass.

Port of ``lightgbm_tpu/serve/forest.py``. Prediction over raw rows packs
all T trees' flat node arrays into single ``[T, NI]`` tensors, quantizes
the rows on the device against the model's own thresholds and walks
every tree at once (``ops/predict.py``); inference throughput comes from
batching the forest, not the tree.

Quantization comes from the model itself: every numerical node's real
threshold is one of its feature's bin upper bounds, so the sorted unique
thresholds of a feature ARE the model's bin grid for it. They are stored
as the largest f32 <= t ("round-down f32"), which makes every device
decision exact for f32 inputs:

    v <= t  (host, f64)  <=>  v <= rd32(t)  (device, f32)

because rd32(t) is the largest f32 not above t and v is itself an f32.
``bin(v) = #{thresholds < v}`` then turns each node decision into the
integer compare ``bin <= rank(threshold)``; NaN and zero-as-missing fold
into sentinel bins during quantization. A feature whose nodes mix
missing types cannot be quantized once per row: such a model raises
``ValueError`` and the caller takes the host walk.

The bins the walk gathers from cover only the features the forest splits
on (``[U, n]``, U = used features).

**f64 rows** that the f32 grid cannot hold exactly take the
double-double path: ``encode_dd`` splits each value into (round-down
f32, exact int32 residual rank), thresholds are packed the same way, and
a lexicographic pair count reproduces the host's f64 compares bit for
bit (exact whenever |value| is not in the f32-subnormal range).

**Categorical nodes** decide by one gather from a shared boolean LUT
over category values (one row per categorical node, built from its
bitset); a categorical feature's quantized "bin" is its value's integer
part, clamped into the LUT (NaN, negative and unseen values fall in an
all-False column: they go right, as on the host). A feature split both
ways, or with mixed missing types, cannot be quantized once per row:
such a model raises ``ValueError`` and the caller takes the host walk.

**The LUT-node encoding** (``lut=True``, asked for explicitly; the
default is the compare encoding) makes every node a LUT row: a
numerical node's row is ``bin <= rank`` over its feature's bins, and
two sentinel columns carry default_left for NaN and zero-as-missing.
One gather decides any node. Both encodings give the same bytes. The
JAX package picks LUT nodes by itself for wide sparse models (F >= 32
and 2 U <= F); the port does not, because the only model timed on the
card walks slower with them (PERF.md, PR 7) and no model that rule
picks has been timed there.

``predict`` / ``predict_raw`` are byte-equal to the host walk
(``GBDT.predict``): the device gathers the f64 leaf values and adds them
per class in tree order from 0, the same IEEE adds in the same order as
the host, and reads back ``[n, K]``. ``predict_raw_device`` is the
throughput path: a Kahan-compensated f32 sum, read back as f32.

**Linear leaves** (``linear_tree``) pack their per-leaf constants,
coefficients and raw feature columns into :class:`LinearLeaves`;
``predict_raw_device`` evaluates them on the device in f32 over the
rows, while ``predict`` / ``predict_raw`` keep their contract: the
device's leaf ids, then every tree's f64 value (the linear ones by
``models/linear.py::linear_predict``) added on the host in tree order,
as the host walk does.

``average_output`` (random forest): the raw sums are divided by the
number of iterations, as ``GBDT.predict_raw`` divides them (in f64 on
the host for ``predict_raw``, so it stays byte-equal to the host walk;
by the f32 divisor for ``predict_raw_device``).
"""
from __future__ import annotations

import copy as _copy
import threading
import weakref
from typing import List, Optional

import numpy as np
import torch

from ..io.binning import MissingType, kZeroThreshold
from ..models.linear import linear_predict
from ..models.tree import Tree, kCategoricalMask, kDefaultLeftMask
from ..ops.predict import (LinearLeaves, QuantizerTables, QuantizerTablesDD,
                           StackedNodes, _sum_leaf_values_f64,
                           stacked_forest_leaves, stacked_forest_leaves_dd,
                           stacked_forest_raw, stacked_forest_raw_dd,
                           stacked_leaf_values)
from ..utils import next_pow2


def round_down_f32(x) -> np.ndarray:
    """Largest float32 <= x (elementwise). The quantizer's exactness
    hinges on this rounding direction (see the module docstring)."""
    x = np.asarray(x, dtype=np.float64)
    with np.errstate(over="ignore"):  # |x| > f32 max rounds to +-inf,
        x32 = x.astype(np.float32)    # then steps down to +-f32 max
        too_big = x32.astype(np.float64) > x
        return np.where(too_big,
                        np.nextafter(x32, np.float32(-np.inf)),
                        x32).astype(np.float32)


# the double-double residual rank: the f64s inside one f32 gap
# [hi, next32(hi)) sit on a 2^29-step grid (53 - 24 mantissa bits), so
# lo = (v - hi) / (gap / 2^29) is an EXACT int32 for normal-range hi
kDDSteps = float(2 ** 29)


def _dd_pair(x: np.ndarray):
    """Split f64 values into (hi: round-down f32, lo: exact int32
    residual rank). Monotone and injective on the f64s the pair can
    resolve; exact for every value whose f32 round-down is normal."""
    x = np.asarray(x, dtype=np.float64)
    hi = round_down_f32(x)
    hi64 = hi.astype(np.float64)
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        gap = (np.nextafter(hi, np.float32(np.inf)).astype(np.float64)
               - hi64)
        finite = np.isfinite(x) & np.isfinite(hi64) & (gap > 0)
        scale = np.where(finite, kDDSteps / np.where(gap > 0, gap, 1.0),
                         0.0)
        res = np.where(finite, x - hi64, 0.0) * scale
        lo = np.floor(np.where(np.isfinite(res), res, 0.0)) \
            .astype(np.int32)
    return hi, lo


def f32_exact(X: np.ndarray) -> bool:
    """True when every finite value of X survives an f32 round trip: THE
    dd-or-f32 routing predicate, shared by ``StackedForest._route`` and
    ``BucketedPredictor.predict`` so the bucket key and the program run
    can never disagree."""
    return bool(np.all((X.astype(np.float32).astype(np.float64) == X)
                       | np.isnan(X)))


_KIND_NONE, _KIND_NUM, _KIND_CAT = 0, 1, 2


def _canonical_device(device) -> torch.device:
    """``device`` with its index filled in (``cuda`` is the current
    card), so that one card has one key in the placement cache."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class StackedForest:
    """Immutable packed forest and quantizer tables (on one device)."""

    def __init__(self, models: List[Tree], num_tree_per_iteration: int = 1,
                 num_features: Optional[int] = None, objective=None,
                 average_output: bool = False, lut: bool = False):
        models = list(models)
        if not models:
            raise ValueError("StackedForest needs at least one tree")
        self.average_output = bool(average_output)
        self.has_linear = any(t.is_linear for t in models)
        # the host f64 exact path evaluates linear trees over the rows
        self._models = models if self.has_linear else None
        K = max(int(num_tree_per_iteration), 1)
        if len(models) % K != 0:
            raise ValueError("len(models)=%d is not a multiple of "
                             "num_tree_per_iteration=%d" % (len(models), K))
        if num_features is None:
            num_features = 1 + max(
                (int(t.split_feature[:t.num_internal].max())
                 for t in models if t.num_internal > 0), default=0)
        F = max(int(num_features), 1)
        self.num_trees = len(models)
        self.num_classes = K
        self.num_features = F
        self.objective = objective

        # --- per-feature scan: kind, missing type and threshold set -----
        kind = np.zeros(F, dtype=np.int8)
        missing = np.full(F, -1, dtype=np.int8)
        thresholds: List[List[float]] = [[] for _ in range(F)]
        cat_nodes: List[tuple] = []          # (tree, node, split index)
        for ti, tree in enumerate(models):
            dt = tree.decision_type
            for node in range(tree.num_internal):
                f = int(tree.split_feature[node])
                if f >= F:
                    raise ValueError("node feature %d out of range (%d)"
                                     % (f, F))
                bits = int(dt[node])
                want = _KIND_CAT if bits & kCategoricalMask else _KIND_NUM
                if kind[f] not in (_KIND_NONE, want):
                    raise ValueError(
                        "feature %d has both numerical and categorical "
                        "splits; cannot quantize once per row" % f)
                kind[f] = want
                if want == _KIND_CAT:
                    cat_nodes.append((ti, node,
                                      int(tree.threshold_in_bin[node])))
                    continue
                m = min((bits >> 2) & 3, MissingType.NAN)
                if missing[f] not in (-1, m):
                    raise ValueError(
                        "feature %d mixes missing types across nodes; "
                        "cannot quantize once per row" % f)
                missing[f] = m
                t = float(tree.threshold[node])
                if not np.isnan(t):
                    thresholds[f].append(t)

        # --- used-feature compaction ------------------------------------
        used = [int(f) for f in np.nonzero(kind != _KIND_NONE)[0]] or [0]
        col_of = {f: u for u, f in enumerate(used)}
        U = len(used)
        k_used = kind[used]
        m_used = missing[used]
        self._h_kind = kind          # full-F host mirrors (encode_dd)
        self._h_missing = missing

        # --- quantizer tables (f32 grid and exact f64 dd grid) ----------
        thr32 = [np.unique(round_down_f32(np.asarray(thresholds[f])))
                 if thresholds[f] else np.zeros(0, dtype=np.float32)
                 for f in used]
        thr64 = [np.unique(np.asarray(thresholds[f], dtype=np.float64))
                 if thresholds[f] else np.zeros(0, dtype=np.float64)
                 for f in used]
        M = max(1, max(len(u) for u in thr32))
        M64 = max(1, max(len(u) for u in thr64))
        thr = np.full((U, M), np.inf, dtype=np.float32)
        for u, vals in enumerate(thr32):
            thr[u, :len(vals)] = vals
        thr_hi = np.full((U, M64), np.inf, dtype=np.float32)
        thr_lo = np.zeros((U, M64), dtype=np.int32)
        for u, vals in enumerate(thr64):
            thr_hi[u, :len(vals)], thr_lo[u, :len(vals)] = _dd_pair(vals)

        # --- the categorical LUT: row 0 (numerical nodes) and column
        # vmax + 1 (NaN, negative, unseen) are all False; the last two
        # columns are the walk's NaN / zero sentinel columns ------------
        vmax = max(0, max((models[ti].cat_value_words(ci) * 32 - 1
                           for ti, _, ci in cat_nodes), default=-1))
        cat_lut = np.zeros((len(cat_nodes) + 1, vmax + 4), dtype=bool)
        cat_slot_of = {}
        for slot, (ti, node, ci) in enumerate(cat_nodes, start=1):
            cat_lut[slot, :vmax + 1] = models[ti].cat_value_mask(ci, vmax)
            cat_slot_of[(ti, node)] = slot

        # --- stacked node arrays ---------------------------------------
        T = len(models)
        NI = next_pow2(max(t.num_internal for t in models))
        NL = next_pow2(max(t.num_leaves for t in models))
        feat = np.zeros((T, NI), dtype=np.int64)
        tbin = np.full((T, NI), -1, dtype=np.int32)
        tbin_dd = np.full((T, NI), -1, dtype=np.int32)
        dleft = np.zeros((T, NI), dtype=bool)
        left = np.full((T, NI), ~0, dtype=np.int32)
        right = np.full((T, NI), ~0, dtype=np.int32)
        is_cat = np.zeros((T, NI), dtype=bool)
        cat_slot = np.zeros((T, NI), dtype=np.int64)
        leaf_f32 = np.zeros((T, NL), dtype=np.float32)
        leaf_f64 = np.zeros((T, NL), dtype=np.float64)
        if not isinstance(lut, bool):
            raise ValueError("lut must be True or False, not %r" % (lut,))
        self.lut_nodes = lut
        if self.lut_nodes:
            W = max(M + 1, vmax + 2) + 2
            node_lut = np.zeros(
                (sum(t.num_internal for t in models) + 1, W), dtype=bool)
            lut_slot = np.zeros((T, NI), dtype=np.int64)
            next_slot = 1
        depth = 0
        for ti, tree in enumerate(models):
            ni, nl = tree.num_internal, tree.num_leaves
            leaf_f64[ti, :nl] = tree.leaf_value[:nl]
            leaf_f32[ti, :nl] = tree.leaf_value[:nl].astype(np.float32)
            depth = max(depth, tree.structure_depth())
            if ni == 0:
                continue  # stump: the padded root falls through to leaf 0
            dt = tree.decision_type[:ni].astype(np.int64)
            feat[ti, :ni] = [col_of[int(f)]
                             for f in tree.split_feature[:ni]]
            dleft[ti, :ni] = (dt & kDefaultLeftMask) != 0
            left[ti, :ni] = tree.left_child[:ni]
            right[ti, :ni] = tree.right_child[:ni]
            for node in range(ni):
                slot = cat_slot_of.get((ti, node))
                if self.lut_nodes:
                    ls = next_slot
                    next_slot += 1
                    lut_slot[ti, node] = ls
                if slot is not None:
                    is_cat[ti, node] = True
                    cat_slot[ti, node] = slot
                    if self.lut_nodes:
                        node_lut[ls, :vmax + 2] = cat_lut[slot, :vmax + 2]
                    continue
                t = float(tree.threshold[node])
                u = col_of[int(tree.split_feature[node])]
                if not np.isnan(t):
                    # tbin stays -1 for NaN: "v <= NaN" is always False
                    tbin[ti, node] = int(np.searchsorted(
                        thr32[u], round_down_f32(t), side="left"))
                    tbin_dd[ti, node] = int(np.searchsorted(
                        thr64[u], t, side="left"))
                if self.lut_nodes:
                    nb = len(thr32[u]) + 1
                    node_lut[ls, :nb] = np.arange(nb) <= tbin[ti, node]
                    node_lut[ls, W - 2:] = bool(dt[node] & kDefaultLeftMask)

        self.trips = next_pow2(max(depth, 1))
        nan_feat = (k_used == _KIND_NUM) & (m_used == MissingType.NAN)
        zero_feat = (k_used == _KIND_NUM) & (m_used == MissingType.ZERO)
        has_cat = bool(cat_nodes)
        t = torch.from_numpy
        nodes_cmp = StackedNodes(
            feat=t(feat), tbin=t(tbin), default_left=t(dleft),
            left=t(left), right=t(right), leaf_value=t(leaf_f32),
            is_cat=t(is_cat) if has_cat else None,
            cat_slot=t(cat_slot) if has_cat else None)
        if self.lut_nodes:
            # every node one gather into node_lut, no compare lanes
            self._nodes = nodes_cmp._replace(
                tbin=None, default_left=None,
                is_cat=torch.ones((T, NI), dtype=torch.bool),
                cat_slot=t(lut_slot))
            self._cat_lut = t(node_lut)
        else:
            self._nodes = nodes_cmp
            self._cat_lut = t(cat_lut) if has_cat else None
        # the dd walk always compares (its bins live in the f64 grid,
        # whose ranks differ from the f32 grid's where two f64
        # thresholds collapse onto one f32)
        self._nodes_dd = nodes_cmp._replace(tbin=t(tbin_dd))
        self._cat_lut_dd = t(cat_lut) if has_cat else None
        self._leaf_f64 = t(leaf_f64)
        self._lin = (self._pack_linear(models, T, NL) if self.has_linear
                     else None)
        used_t = t(np.asarray(used, dtype=np.int64))
        cat_used = t(k_used == _KIND_CAT) if has_cat else None
        self._qt = QuantizerTables(
            used=used_t, thresholds=t(thr), nan_feat=t(nan_feat),
            zero_feat=t(zero_feat),
            zero_eps=float(round_down_f32(kZeroThreshold)),
            is_cat=cat_used, vmax=vmax)
        self._qt_dd = QuantizerTablesDD(
            used=used_t, thr_hi=t(thr_hi), thr_lo=t(thr_lo),
            nan_feat=t(nan_feat), zero_feat=t(zero_feat), is_cat=cat_used,
            vmax=vmax)
        self._device = torch.device("cpu")
        #: bytes copied to and from the device by this placement's calls
        self.transfer_bytes = {"to_device": 0, "from_device": 0}
        # placed copies by device, held by this forest (the base); each
        # copy points back to it weakly, so no cycle keeps a swapped-out
        # model's device tensors alive: one transfer per device, however
        # many replicas or swaps ask
        self._placed = {}
        self._base = None
        self._place_lock = threading.Lock()

    @staticmethod
    def _pack_linear(models: List[Tree], T: int, NL: int) -> LinearLeaves:
        """The linear leaves as [T, NL(, C)] arrays, C the most
        features of a fitted leaf (reference ``_pack_linear``)."""
        C = max(1, max((len(t.leaf_coeff[leaf]) for t in models
                        if t.is_linear for leaf in range(t.num_leaves)),
                       default=1))
        const = np.zeros((T, NL), dtype=np.float32)
        coeff = np.zeros((T, NL, C), dtype=np.float32)
        feat = np.zeros((T, NL, C), dtype=np.int64)
        valid = np.zeros((T, NL, C), dtype=bool)
        has = np.zeros((T, NL), dtype=bool)
        for ti, tree in enumerate(models):
            if not tree.is_linear:
                continue
            for leaf in range(tree.num_leaves):
                feats = tree.leaf_features[leaf]
                if not feats:
                    continue   # no fit: the leaf value serves
                k = len(feats)
                has[ti, leaf] = True
                const[ti, leaf] = tree.leaf_const[leaf]
                coeff[ti, leaf, :k] = tree.leaf_coeff[leaf]
                feat[ti, leaf, :k] = feats
                valid[ti, leaf, :k] = True
        t = torch.from_numpy
        return LinearLeaves(const=t(const), coeff=t(coeff), feat=t(feat),
                            valid=t(valid), has=t(has))

    # ------------------------------------------------------------------
    @classmethod
    def from_gbdt(cls, gbdt, start_iteration: int = 0,
                  num_iteration: int = -1, lut: bool = False
                  ) -> "StackedForest":
        """Pack a trained or text-loaded GBDT (the same tree slice as
        ``GBDT.predict_raw``); a Booster is accepted too."""
        gbdt = getattr(gbdt, "inner", gbdt)
        models = gbdt._used_models(start_iteration, num_iteration)
        return cls(models, gbdt.num_tree_per_iteration,
                   gbdt.max_feature_idx + 1, objective=gbdt.objective,
                   average_output=gbdt.average_output, lut=lut)

    # ------------------------------------------------------------------
    def place(self, device) -> "StackedForest":
        """A copy of this forest with every tensor on ``device``, made
        once per device and cached (reference ``place``: "one transfer,
        cached per device"); the cache is the base forest's, so placing
        any of its copies returns the same copy. A copy whose base is
        gone keeps a cache of its own."""
        device = _canonical_device(device)
        base = self._base() if self._base is not None else None
        if base is None:
            base = self
        if device == base._device:
            return base
        return base._place_new(device)

    def _place_new(self, device: torch.device) -> "StackedForest":
        with self._place_lock:
            got = self._placed.get(device)
            if got is not None:
                return got

            def put(tup):
                return tup._replace(**{
                    k: v.to(device) for k, v in tup._asdict().items()
                    if isinstance(v, torch.Tensor)})

            cp = _copy.copy(self)
            cp._nodes = put(self._nodes)
            cp._nodes_dd = put(self._nodes_dd)
            cp._cat_lut = (None if self._cat_lut is None
                           else self._cat_lut.to(device))
            cp._cat_lut_dd = (None if self._cat_lut_dd is None
                              else self._cat_lut_dd.to(device))
            cp._leaf_f64 = self._leaf_f64.to(device)
            if self._lin is not None:
                cp._lin = put(self._lin)
            cp._qt = put(self._qt)
            cp._qt_dd = put(self._qt_dd)
            cp._device = device
            cp.transfer_bytes = {"to_device": 0, "from_device": 0}
            cp._placed = {}
            cp._base = weakref.ref(self)
            cp._place_lock = threading.Lock()
            if device.type == "cuda":
                # replicas dispatch on streams of their own: the copy
                # must be whole before any of them reads it
                torch.cuda.current_stream(device).synchronize()
            self._placed[device] = cp
            return cp

    @property
    def device(self) -> torch.device:
        return self._device

    # ------------------------------------------------------------------
    def _check_shape(self, X: np.ndarray) -> np.ndarray:
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if X.shape[1] != self.num_features:
            raise ValueError("X has %d features, model expects %d"
                             % (X.shape[1], self.num_features))
        return X

    def _route(self, X, dd=None):
        """("f32", X_f32) or ("dd", X_f64): f64 rows the f32 quantizer
        cannot hold exactly take the double-double path. ``dd`` forces
        the mode (the bucket cache decides once for a whole chunked
        batch); None derives it with :func:`f32_exact`."""
        X = self._check_shape(np.asarray(X))
        if dd is None:
            dd = X.dtype == np.float64 and not f32_exact(X)
        if dd:
            return "dd", np.ascontiguousarray(X, dtype=np.float64)
        return "f32", np.ascontiguousarray(X, dtype=np.float32)

    def encode_dd(self, X64: np.ndarray):
        """Host double-double encoding of rows: [n, F] f64 ->
        (hi [n, F] f32, lo [n, F] int32). NaN stays in ``hi`` (the
        device substitutes the exact (0, 0) pair on features whose
        missing type is not NaN); the one f64-exact decision made here
        is zero-as-missing, marked ``lo == -1`` (NaN counts as 0.0 on
        those features, as in the host walk)."""
        X = np.asarray(X64, dtype=np.float64)
        zerof = ((self._h_kind == _KIND_NUM)
                 & (self._h_missing == MissingType.ZERO))
        isnan = np.isnan(X)
        hi, lo = _dd_pair(X)
        zs = zerof[None, :] & (isnan | (np.abs(np.where(isnan, 0.0, X))
                                        <= kZeroThreshold))
        lo = np.where(zs, np.int32(-1), lo)
        return hi, np.ascontiguousarray(lo)

    def _to_device(self, a: np.ndarray, pinned: bool = False
                   ) -> torch.Tensor:
        """Rows to this placement's device. ``pinned`` (a server's
        dispatches) stages them on the card through a pinned host buffer
        copied without blocking on the current stream (the host
        allocator keeps the buffer until the copy has run), so a worker
        on a stream of its own does not wait for the copy; a large
        ``Booster.predict`` batch ran slower that way on an H100
        (``chip_smoke.py`` phase 12, in PERF.md) and copies from
        pageable memory."""
        self.transfer_bytes["to_device"] += a.nbytes
        t = torch.from_numpy(a)
        if pinned and self._device.type == "cuda":
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.to(self._device)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        self.transfer_bytes["from_device"] += t.numel() * t.element_size()
        return t.cpu().numpy()

    # ------------------------------------------------------------------
    def leaves_device(self, X, dd=None, pinned: bool = False
                      ) -> torch.Tensor:
        """[T, n] int32 leaf ids on this placement's device: one
        quantize and one walk of the whole forest, no host read."""
        mode, Xp = self._route(X, dd)
        if mode == "dd":
            hi, lo = self.encode_dd(Xp)
            return stacked_forest_leaves_dd(
                self._to_device(hi, pinned), self._to_device(lo, pinned),
                self._qt_dd, self._nodes_dd, self.trips, self._cat_lut_dd)
        return stacked_forest_leaves(self._to_device(Xp, pinned), self._qt,
                                     self._nodes, self.trips, self._cat_lut)

    def leaves(self, X, dd=None, pinned: bool = False) -> np.ndarray:
        """[n, T] leaf index of every row in every tree."""
        return self._to_host(self.leaves_device(X, dd, pinned)).T

    def predict_raw(self, X, dd=None, pinned: bool = False) -> np.ndarray:
        """Raw scores byte-equal to ``GBDT.predict_raw``: the f64 leaf
        values of the device's leaf ids, added per class in tree order on
        the device ([n] or [n, K]). With linear trees the leaf ids come
        back and the host adds every tree's f64 value in tree order, the
        linear ones over the f64 rows, as the host walk does."""
        K = self.num_classes
        if self.has_linear:
            leaves = self.leaves(X, dd, pinned)
            X64 = self._check_shape(np.asarray(X, dtype=np.float64))
            lv = self._leaf_f64.cpu().numpy()
            out = np.zeros((leaves.shape[0], K), dtype=np.float64)
            for i, tree in enumerate(self._models):
                out[:, i % K] += (linear_predict(tree, X64, leaves[:, i])
                                  if tree.is_linear
                                  else lv[i][leaves[:, i]])
        else:
            out = self._to_host(_sum_leaf_values_f64(
                self.leaves_device(X, dd, pinned), self._leaf_f64, K))
        if self.average_output:
            out /= max(self.num_trees // K, 1)
        return out[:, 0] if K == 1 else out

    def predict(self, X, raw_score: bool = False, dd=None,
                pinned: bool = False) -> np.ndarray:
        """Transformed output, byte-equal to the host ``Booster.predict``
        (the same objective ``convert_output``)."""
        raw = self.predict_raw(X, dd, pinned)
        if raw_score or self.objective is None:
            return raw
        return self.objective.convert_output(raw)

    def predict_raw_device(self, X, dd=None, pinned: bool = False
                           ) -> torch.Tensor:
        """[n, K] f32 raw scores summed on the device with Kahan
        compensation (the throughput path: within ~2 f32 ulp of the f64
        sum of the trees' f32 values, not byte-equal to it; linear leaves
        evaluate in f32), left on the device."""
        mode, Xp = self._route(X, dd)
        if mode == "dd":
            hi, lo = self.encode_dd(Xp)
            out = stacked_forest_raw_dd(
                self._to_device(hi, pinned), self._to_device(lo, pinned),
                self._qt_dd, self._nodes_dd, self.trips, self.num_classes,
                self._cat_lut_dd, self._lin)
        else:
            out = stacked_forest_raw(self._to_device(Xp, pinned), self._qt,
                                     self._nodes, self.trips,
                                     self.num_classes, self._cat_lut,
                                     self._lin)
        if self.average_output:
            out = out / float(np.float32(
                max(self.num_trees // self.num_classes, 1)))
        return out

    def tree_values_device(self, X) -> torch.Tensor:
        """[T, n] f32 value of every f32 row in every tree on the device,
        linear leaves included: the terms ``predict_raw_device`` sums."""
        Xd = self._to_device(self._route(X, dd=False)[1])
        leaves = stacked_forest_leaves(Xd, self._qt, self._nodes,
                                       self.trips, self._cat_lut)
        return stacked_leaf_values(Xd, leaves, self._nodes, self._lin)
