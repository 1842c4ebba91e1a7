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

``predict`` / ``predict_raw`` are byte-equal to the host walk
(``GBDT.predict``): the device gathers the f64 leaf values and adds them
per class in tree order from 0, the same IEEE adds in the same order as
the host, and reads back ``[n, K]``. ``predict_raw_device`` is the
throughput path: a Kahan-compensated f32 sum, read back as f32.

Categorical nodes and the LUT-node encoding are ROADMAP item 11, linear
leaves item 15 and ``average_output`` (random forest) item 16; each
raises naming its item.
"""
from __future__ import annotations

import copy as _copy
from typing import List, Optional

import numpy as np
import torch

from ..io.binning import MissingType, kZeroThreshold
from ..models.tree import Tree, kCategoricalMask, kDefaultLeftMask
from ..ops.predict import (QuantizerTables, QuantizerTablesDD, StackedNodes,
                           _sum_leaf_values_f64, stacked_forest_leaves,
                           stacked_forest_leaves_dd, stacked_forest_raw,
                           stacked_forest_raw_dd)
from ..utils import next_pow2
from ..utils.log import unsupported


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


class StackedForest:
    """Immutable packed forest and quantizer tables (on one device)."""

    def __init__(self, models: List[Tree], num_tree_per_iteration: int = 1,
                 num_features: Optional[int] = None, objective=None,
                 average_output: bool = False, lut="auto"):
        models = list(models)
        if not models:
            raise ValueError("StackedForest needs at least one tree")
        if lut is True:
            unsupported("the LUT-node encoding of the stacked forest",
                        "item 11")
        if average_output:
            unsupported("average_output models (random forest)", "item 16")
        if any(getattr(t, "is_linear", False) for t in models):
            unsupported("linear trees", "item 15")
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

        # --- per-feature scan: missing type (-1: never split on) and
        # threshold set --------------------------------------------------
        missing = np.full(F, -1, dtype=np.int8)
        thresholds: List[List[float]] = [[] for _ in range(F)]
        for tree in models:
            dt = tree.decision_type
            for node in range(tree.num_internal):
                f = int(tree.split_feature[node])
                if f >= F:
                    raise ValueError("node feature %d out of range (%d)"
                                     % (f, F))
                bits = int(dt[node])
                if bits & kCategoricalMask:
                    unsupported("categorical nodes in the stacked forest",
                                "item 11")
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
        used = [int(f) for f in np.nonzero(missing >= 0)[0]] or [0]
        col_of = {f: u for u, f in enumerate(used)}
        U = len(used)
        m_used = missing[used]
        self._h_missing = missing    # the full-F host mirror (encode_dd)

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
        leaf_f32 = np.zeros((T, NL), dtype=np.float32)
        leaf_f64 = np.zeros((T, NL), dtype=np.float64)
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
                t = float(tree.threshold[node])
                if np.isnan(t):
                    continue  # tbin stays -1: "v <= NaN" is always False
                u = col_of[int(tree.split_feature[node])]
                tbin[ti, node] = int(np.searchsorted(
                    thr32[u], round_down_f32(t), side="left"))
                tbin_dd[ti, node] = int(np.searchsorted(
                    thr64[u], t, side="left"))

        self.trips = next_pow2(max(depth, 1))
        nan_feat = m_used == MissingType.NAN
        zero_feat = m_used == MissingType.ZERO
        t = torch.from_numpy
        self._nodes = StackedNodes(
            feat=t(feat), tbin=t(tbin), default_left=t(dleft),
            left=t(left), right=t(right), leaf_value=t(leaf_f32))
        # the dd walk has its own threshold ranks: two f64 thresholds can
        # collapse onto one f32, so the f64 grid's ranks differ
        self._nodes_dd = self._nodes._replace(tbin=t(tbin_dd))
        self._leaf_f64 = t(leaf_f64)
        used_t = t(np.asarray(used, dtype=np.int64))
        self._qt = QuantizerTables(
            used=used_t, thresholds=t(thr), nan_feat=t(nan_feat),
            zero_feat=t(zero_feat),
            zero_eps=float(round_down_f32(kZeroThreshold)))
        self._qt_dd = QuantizerTablesDD(
            used=used_t, thr_hi=t(thr_hi), thr_lo=t(thr_lo),
            nan_feat=t(nan_feat), zero_feat=t(zero_feat))
        self._device = torch.device("cpu")
        #: bytes copied to and from the device by this placement's calls
        self.transfer_bytes = {"to_device": 0, "from_device": 0}

    # ------------------------------------------------------------------
    @classmethod
    def from_gbdt(cls, gbdt, start_iteration: int = 0,
                  num_iteration: int = -1, lut="auto") -> "StackedForest":
        """Pack a trained or text-loaded GBDT (the same tree slice as
        ``GBDT.predict_raw``); a Booster is accepted too."""
        gbdt = getattr(gbdt, "inner", gbdt)
        models = gbdt._used_models(start_iteration, num_iteration)
        return cls(models, gbdt.num_tree_per_iteration,
                   gbdt.max_feature_idx + 1, objective=gbdt.objective,
                   lut=lut)

    # ------------------------------------------------------------------
    def place(self, device) -> "StackedForest":
        """A copy of this forest with every tensor on ``device``."""
        device = torch.device(device)
        if device == self._device:
            return self

        def put(tup):
            return tup._replace(**{
                k: v.to(device) for k, v in tup._asdict().items()
                if isinstance(v, torch.Tensor)})

        cp = _copy.copy(self)
        cp._nodes = put(self._nodes)
        cp._nodes_dd = put(self._nodes_dd)
        cp._leaf_f64 = self._leaf_f64.to(device)
        cp._qt = put(self._qt)
        cp._qt_dd = put(self._qt_dd)
        cp._device = device
        cp.transfer_bytes = {"to_device": 0, "from_device": 0}
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
        zerof = self._h_missing == MissingType.ZERO
        isnan = np.isnan(X)
        hi, lo = _dd_pair(X)
        zs = zerof[None, :] & (isnan | (np.abs(np.where(isnan, 0.0, X))
                                        <= kZeroThreshold))
        lo = np.where(zs, np.int32(-1), lo)
        return hi, np.ascontiguousarray(lo)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        self.transfer_bytes["to_device"] += a.nbytes
        return torch.from_numpy(a).to(self._device)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        self.transfer_bytes["from_device"] += t.numel() * t.element_size()
        return t.cpu().numpy()

    # ------------------------------------------------------------------
    def leaves_device(self, X, dd=None) -> torch.Tensor:
        """[T, n] int32 leaf ids on this placement's device: one
        quantize and one walk of the whole forest, no host read."""
        mode, Xp = self._route(X, dd)
        if mode == "dd":
            hi, lo = self.encode_dd(Xp)
            return stacked_forest_leaves_dd(
                self._to_device(hi), self._to_device(lo), self._qt_dd,
                self._nodes_dd, self.trips)
        return stacked_forest_leaves(self._to_device(Xp), self._qt,
                                     self._nodes, self.trips)

    def leaves(self, X, dd=None) -> np.ndarray:
        """[n, T] leaf index of every row in every tree."""
        return self._to_host(self.leaves_device(X, dd)).T

    def predict_raw(self, X, dd=None) -> np.ndarray:
        """Raw scores byte-equal to ``GBDT.predict_raw``: the f64 leaf
        values of the device's leaf ids, added per class in tree order on
        the device ([n] or [n, K])."""
        raw = _sum_leaf_values_f64(self.leaves_device(X, dd),
                                   self._leaf_f64, self.num_classes)
        out = self._to_host(raw)
        return out[:, 0] if self.num_classes == 1 else out

    def predict(self, X, raw_score: bool = False, dd=None) -> np.ndarray:
        """Transformed output, byte-equal to the host ``Booster.predict``
        (the same objective ``convert_output``)."""
        raw = self.predict_raw(X, dd)
        if raw_score or self.objective is None:
            return raw
        return self.objective.convert_output(raw)

    def predict_raw_device(self, X, dd=None) -> torch.Tensor:
        """[n, K] f32 raw scores summed on the device with Kahan
        compensation (the throughput path: within ~2 f32 ulp of the f64
        sum, not byte-equal to it), left on the device."""
        mode, Xp = self._route(X, dd)
        if mode == "dd":
            hi, lo = self.encode_dd(Xp)
            return stacked_forest_raw_dd(
                self._to_device(hi), self._to_device(lo), self._qt_dd,
                self._nodes_dd, self.trips, self.num_classes)
        return stacked_forest_raw(self._to_device(Xp), self._qt,
                                  self._nodes, self.trips, self.num_classes)
