"""Tree traversal on the device: one tree over binned rows, and the
whole stacked forest over raw rows.

Port of ``lightgbm_tpu/ops/predict.py``. Both walks are lockstep: every
row advances one level per pass, nodes are flat arrays gathered by the
row's current node, and a child pointer < 0 encodes leaf ``~index``
(as in the host ``Tree`` and the reference's tree.h:25).

- :class:`DeviceTree` / :func:`predict_leaf_on_device` /
  :func:`tree_output_on_device` walk ONE tree over dataset-binned rows
  (validation scores, continued training, rollback).
- The stacked functions serve prediction: ``serve/forest.py`` packs all
  T trees into ``[T, NI]`` node arrays (:class:`StackedNodes`) and
  per-feature threshold tables (:class:`QuantizerTables`, or
  :class:`QuantizerTablesDD` for f64 rows). Raw rows are quantized on
  the device against the model's own thresholds, and the walk advances
  all T trees at once over a ``[T, n]`` node tensor, one pass per level.
  Leaf values are summed per class with a Kahan-compensated f32 sum.
  Linear leaves (:class:`LinearLeaves`) replace a leaf's value by its
  f32 ``const + coeff . x`` over the row's raw values where it has a fit
  and none of its features is NaN.

A categorical node decides by one gather from a boolean table over its
feature's values (its LUT row); a categorical feature's "bin" is its
category value, clamped into the table. The LUT-node encoding decides
EVERY node that way (a numerical node's row is ``bin <= rank``, with two
sentinel columns for NaN and zero-as-missing), and so does the binned
walk of an EFB-bundled dataset, whose node rows are tables over the
node's bundle column.

These are plain PyTorch ops on whatever device the tensors lie on; the
reference's versions are jnp code (no Pallas), so there is no hand
kernel here. The Kahan steps run eagerly and must stay so: a compiler
that reassociates f32 adds could fold the compensation away.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..io.binning import MissingType
from ..models.tree import Tree, kCategoricalMask, kDefaultLeftMask
from ..utils import next_pow2


# ---------------------------------------------------------------------------
# one tree over binned rows (training side)
# ---------------------------------------------------------------------------
class DeviceTree(NamedTuple):
    """Flat node arrays of one tree on the device."""
    feat: torch.Tensor          # [NI] int64 inner feature index
    tbin: torch.Tensor          # [NI] int32 threshold bin
    default_left: torch.Tensor  # [NI] bool
    nan_bin: torch.Tensor       # [NI] int32 (-1 when the feature has none)
    zero_bin: torch.Tensor      # [NI] int32 (-1 unless MissingType.ZERO)
    left: torch.Tensor          # [NI] int32 (>= 0 node, < 0 ~leaf)
    right: torch.Tensor         # [NI] int32
    leaf_value: torch.Tensor    # [NL] f32
    depth: int                  # host int: the most hops a row needs
    is_cat: Optional[torch.Tensor] = None    # [NI] bool: decide by LUT
    cat_mask: Optional[torch.Tensor] = None  # [NI, W] bool: bin -> left


def build_device_tree(tree: Tree, bin_meta, device: torch.device,
                      num_bins: int = 256,
                      bundle=None) -> Optional[DeviceTree]:
    """Pack a host Tree for the binned walk. ``bin_meta`` is the GBDT's
    (nan_bins, zero_bins, missing_types) per inner feature; ``num_bins``
    bounds the bin values of the rows walked. Categorical nodes decide
    by their bin mask (``tree.cat_bin_masks``). Over EFB-bundled rows
    (``bundle``, the dataset's BundleLayout) every node is a LUT row over
    its bundle column (reference ``_build_bundled_device_tree``).
    Returns None for a stump (its output is a constant)."""
    ni = tree.num_internal
    if ni == 0:
        return None
    nan_bins, zero_bins, missing_types = bin_meta
    f = tree.split_feature_inner[:ni]
    dt = tree.decision_type[:ni]

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
            device)

    if bundle is not None:
        return _bundled_device_tree(tree, bin_meta, num_bins, bundle, t)
    is_cat = (dt & kCategoricalMask) != 0
    cat_mask = None
    if is_cat.any():
        cat_mask = np.zeros((ni, num_bins), dtype=bool)
        for node in np.nonzero(is_cat)[0]:
            m = np.asarray(tree.cat_bin_masks[int(node)], dtype=bool)
            cat_mask[node, :min(len(m), num_bins)] = m[:num_bins]
    return DeviceTree(
        feat=t(f, np.int64),
        tbin=t(tree.threshold_in_bin[:ni], np.int32),
        default_left=t((dt & kDefaultLeftMask) != 0, np.bool_),
        nan_bin=t(np.where(missing_types[f] == MissingType.NAN,
                           nan_bins[f], -1), np.int32),
        zero_bin=t(np.where(missing_types[f] == MissingType.ZERO,
                            zero_bins[f], -1), np.int32),
        left=t(tree.left_child[:ni], np.int32),
        right=t(tree.right_child[:ni], np.int32),
        leaf_value=t(tree.leaf_value[:tree.num_leaves], np.float32),
        depth=tree.structure_depth(),
        is_cat=None if cat_mask is None else t(is_cat, np.bool_),
        cat_mask=None if cat_mask is None else t(cat_mask, np.bool_))


def _bundled_device_tree(tree: Tree, bin_meta, num_bins: int, bundle,
                         t) -> DeviceTree:
    """LUT-node DeviceTree over EFB-bundled rows: per node a bool table
    over its bundle column's bins, from the member / unmap maps."""
    nan_bins, zero_bins, missing_types = bin_meta
    ni = tree.num_internal
    feat = np.zeros(ni, dtype=np.int64)
    lut = np.zeros((ni, num_bins), dtype=bool)
    for node in range(ni):
        f = int(tree.split_feature_inner[node])
        g = int(bundle.group_of[f])
        feat[node] = g
        zb = int(zero_bins[f])
        orig = np.where(bundle.member[g] == f, bundle.unmap[g],
                        zb)[:num_bins]
        bits = int(tree.decision_type[node])
        if bits & kCategoricalMask:
            mask = np.asarray(tree.cat_bin_masks[node], dtype=bool)
            gl = mask[np.minimum(orig, len(mask) - 1)]
        else:
            dl = bool(bits & kDefaultLeftMask)
            gl = orig <= int(tree.threshold_in_bin[node])
            if missing_types[f] == MissingType.NAN:
                gl = np.where(orig == nan_bins[f], dl, gl)
            elif missing_types[f] == MissingType.ZERO:
                gl = np.where(orig == zb, dl, gl)
        lut[node, :len(gl)] = gl
    neg1 = np.full(ni, -1, dtype=np.int32)
    return DeviceTree(
        feat=t(feat, np.int64), tbin=t(neg1, np.int32),
        default_left=t(np.zeros(ni, dtype=bool), np.bool_),
        nan_bin=t(neg1, np.int32), zero_bin=t(neg1, np.int32),
        left=t(tree.left_child[:ni], np.int32),
        right=t(tree.right_child[:ni], np.int32),
        leaf_value=t(tree.leaf_value[:tree.num_leaves], np.float32),
        depth=tree.structure_depth(),
        is_cat=t(np.ones(ni, dtype=bool), np.bool_),
        cat_mask=t(lut, np.bool_))


def _traverse(bins: torch.Tensor, dt: DeviceTree, trips: int) -> torch.Tensor:
    """Lockstep binned walk: [n, F] uint8 or uint16 bins -> [n] int32
    leaf ids. uint16 bins are read through an int16 view (torch's uint16
    is a limited dtype on the card) and masked back."""
    n = bins.shape[0]
    rows = torch.arange(n, device=bins.device)
    node = torch.zeros(n, dtype=torch.int32, device=bins.device)
    wide = bins.dtype == torch.uint16
    src = bins.view(torch.int16) if wide else bins
    for _ in range(trips):
        nd = node.clamp(min=0).long()
        b = src[rows, dt.feat[nd]].to(torch.int32)
        if wide:
            b = b & 0xFFFF
        gl = b <= dt.tbin[nd]
        gl = torch.where(b == dt.nan_bin[nd], dt.default_left[nd], gl)
        gl = torch.where(b == dt.zero_bin[nd], dt.default_left[nd], gl)
        if dt.is_cat is not None:
            gl = torch.where(dt.is_cat[nd], dt.cat_mask[nd, b.long()], gl)
        nxt = torch.where(gl, dt.left[nd], dt.right[nd])
        node = torch.where(node >= 0, nxt, node)
    return torch.where(node < 0, ~node, 0)


def predict_leaf_on_device(bins: torch.Tensor,
                           dtree: DeviceTree) -> torch.Tensor:
    """[n] int32 leaf index of every binned row."""
    return _traverse(bins, dtree, next_pow2(dtree.depth))


def tree_output_on_device(bins: torch.Tensor,
                          dtree: DeviceTree) -> torch.Tensor:
    """[n] f32 output of one tree over binned rows."""
    return dtree.leaf_value[predict_leaf_on_device(bins, dtree).long()]


# ---------------------------------------------------------------------------
# the stacked forest over raw rows (prediction)
# ---------------------------------------------------------------------------
# sentinel bins from the quantizer; they never collide with a real bin
# (>= 0) or a node's threshold rank (>= -1)
kNanBin = -2    # NaN on a MissingType.NAN feature
kZeroBin = -4   # |v| <= kZeroThreshold on a MissingType.ZERO feature


class StackedNodes(NamedTuple):
    """All T trees' node arrays padded to common [T, NI] / [T, NL]
    shapes (``serve/forest.py`` packs them). Two encodings share it:

    - compare nodes: a numerical node decides ``bin <= tbin``, a
      categorical one (``is_cat``) by its row ``cat_slot`` of the shared
      LUT; ``is_cat`` is None for a forest without categorical nodes;
    - LUT nodes: every node is a LUT row over its feature's bins
      (``is_cat`` all True; ``tbin`` and ``default_left`` None: the walk
      runs no compare)."""
    feat: torch.Tensor          # [T, NI] int64 used-feature (compact) index
    tbin: Optional[torch.Tensor]  # [T, NI] int32 threshold rank (-1: none)
    default_left: Optional[torch.Tensor]  # [T, NI] bool
    left: torch.Tensor          # [T, NI] int32 (>= 0 node, < 0 ~leaf)
    right: torch.Tensor         # [T, NI] int32
    leaf_value: torch.Tensor    # [T, NL] f32
    is_cat: Optional[torch.Tensor] = None    # [T, NI] bool
    cat_slot: Optional[torch.Tensor] = None  # [T, NI] int64 LUT row


class QuantizerTables(NamedTuple):
    """Per used feature, the raw-value -> bin table from the model's own
    split thresholds (exact in f32; ``serve/forest.py`` builds them)."""
    used: torch.Tensor          # [U] int64 raw column of each table row
    thresholds: torch.Tensor    # [U, M] f32 round-down thresholds, +inf pad
    nan_feat: torch.Tensor      # [U] bool (MissingType.NAN features)
    zero_feat: torch.Tensor     # [U] bool (MissingType.ZERO features)
    zero_eps: float             # round-down f32 of kZeroThreshold
    is_cat: Optional[torch.Tensor] = None    # [U] bool categorical
    vmax: int = 0               # the largest category value in the LUT


class QuantizerTablesDD(NamedTuple):
    """Double-double tables for f64 rows: each f64 threshold t is the
    exact pair (round-down f32 of t, integer residual rank); see
    ``serve/forest.py``'s ``encode_dd``."""
    used: torch.Tensor          # [U] int64
    thr_hi: torch.Tensor        # [U, M64] f32, +inf pad
    thr_lo: torch.Tensor        # [U, M64] int32, 0 pad
    nan_feat: torch.Tensor      # [U] bool
    zero_feat: torch.Tensor     # [U] bool
    is_cat: Optional[torch.Tensor] = None    # [U] bool
    vmax: int = 0


def _category_bins(X: torch.Tensor, b: torch.Tensor, is_cat, vmax: int
                   ) -> torch.Tensor:
    """A categorical feature's bin is its value's integer part, clamped
    into the LUT's row: NaN, negative and values above ``vmax`` take
    column vmax + 1, which is False for every node (the host's
    FindInBitset miss: go right)."""
    if is_cat is None:
        return b
    iv = torch.clamp(torch.where(torch.isnan(X), -1.0, X), -1.0,
                     vmax + 1.0).to(torch.int32)
    cb = torch.where((iv >= 0) & (iv <= vmax), iv, vmax + 1)
    return torch.where(is_cat[:, None], cb, b)


def _quantize_rows_impl(X: torch.Tensor, qt: QuantizerTables) -> torch.Tensor:
    """[n, F] raw f32 rows -> [U, n] int32 model-space bins over the used
    columns (the transpose of the reference's [n, U]: the walk gathers a
    row's bin along dim 0).

    A numerical bin is #{thresholds of the feature < v}, so
    ``bin <= rank(t)`` decides exactly as the host's ``v <= t`` does
    (thresholds are stored as the largest f32 <= t). NaN and
    zero-as-missing are resolved here once per value, into sentinel
    bins the walk sends to default_left."""
    Xu = X.index_select(1, qt.used).t().contiguous()        # [U, n]
    isnan = torch.isnan(Xu)
    # NaN counts as 0.0 except on MissingType.NAN features (the host
    # walk's rule)
    Xn = torch.where(isnan & ~qt.nan_feat[:, None], 0.0, Xu)
    b = torch.searchsorted(qt.thresholds, Xn, right=False).to(torch.int32)
    b = torch.where(qt.nan_feat[:, None] & isnan, kNanBin, b)
    b = torch.where(qt.zero_feat[:, None] & (Xn.abs() <= qt.zero_eps),
                    kZeroBin, b)
    return _category_bins(Xu, b, qt.is_cat, qt.vmax)


def _quantize_rows_dd_impl(Xhi: torch.Tensor, Xlo: torch.Tensor,
                           qt: QuantizerTablesDD) -> torch.Tensor:
    """[n, F] double-double rows -> [U, n] int32 bins in the model's f64
    threshold grid: the lexicographic pair count

        bin = #{j : (thr_hi_j, thr_lo_j) < (hi, lo)}

    which is exactly #{t_j < v}, the pair encoding being monotone and
    exact for every f64 whose f32 round-down is a normal float. The host
    encoder resolved zero-as-missing (``lo == -1``); NaN stays in ``hi``
    and counts as the exact pair (0, 0) on features whose missing type
    is not NaN. The compare is [U, n, M64] booleans, which the caller
    bounds by its chunk size."""
    hi = Xhi.index_select(1, qt.used).t()
    lo = Xlo.index_select(1, qt.used).t()
    isnan = torch.isnan(hi)
    as_zero = isnan & ~qt.nan_feat[:, None]
    h = torch.where(as_zero, 0.0, hi)[:, :, None]
    lw = torch.where(as_zero, 0, lo)[:, :, None]
    thi = qt.thr_hi[:, None, :]
    tlo = qt.thr_lo[:, None, :]
    less = (thi < h) | ((thi == h) & (tlo < lw))
    b = less.sum(dim=2, dtype=torch.int32)
    b = torch.where(qt.nan_feat[:, None] & isnan, kNanBin, b)
    b = torch.where(qt.zero_feat[:, None] & (lo == -1), kZeroBin, b)
    return _category_bins(hi, b, qt.is_cat, qt.vmax)


def _walk_stacked(bins_t: torch.Tensor, nodes: StackedNodes,
                  trips: int, cat_lut: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """[U, n] bins -> [T, n] int32 leaf ids: the lockstep walk of every
    tree at once. ``node`` is [T, n]; each pass gathers the node fields
    along dim 1 and each (tree, row)'s bin from ``bins_t`` along dim 0.
    ``trips`` is at least the deepest tree's depth; rows already on a
    leaf keep it. ``cat_lut`` [rows, W] decides the nodes of
    ``nodes.is_cat``; its last two columns take the NaN and zero
    sentinel bins (read by LUT-encoded numerical nodes only)."""
    T = nodes.feat.shape[0]
    n = bins_t.shape[1]
    node = torch.zeros((T, n), dtype=torch.int32, device=bins_t.device)
    if nodes.is_cat is not None:
        lut_w = cat_lut.shape[1]
        lut_flat = cat_lut.reshape(-1)
    for _ in range(trips):
        nd = node.clamp(min=0).long()
        b = bins_t.gather(0, nodes.feat.gather(1, nd))
        if nodes.is_cat is not None:
            bi = torch.where(b == kNanBin, lut_w - 2, torch.where(
                b == kZeroBin, lut_w - 1, b.clamp(min=0)))
            lu = lut_flat[nodes.cat_slot.gather(1, nd) * lut_w + bi]
        if nodes.tbin is None:
            gl = lu                       # LUT nodes: one gather decides
        else:
            gl = b <= nodes.tbin.gather(1, nd)
            gl = torch.where((b == kNanBin) | (b == kZeroBin),
                             nodes.default_left.gather(1, nd), gl)
            if nodes.is_cat is not None:
                gl = torch.where(nodes.is_cat.gather(1, nd), lu, gl)
        nxt = torch.where(gl, nodes.left.gather(1, nd),
                          nodes.right.gather(1, nd))
        node = torch.where(node >= 0, nxt, node)
    return torch.where(node < 0, ~node, 0)


class LinearLeaves(NamedTuple):
    """The linear leaves of a stacked forest: per tree and leaf a constant
    and up to C coefficients over raw feature columns. ``valid`` masks
    the pad lanes (a NaN in a pad column must not send a row to the
    constant); ``has`` marks the leaves with a fit."""
    const: torch.Tensor     # [T, NL] f32
    coeff: torch.Tensor     # [T, NL, C] f32 (0 pad)
    feat: torch.Tensor      # [T, NL, C] int64 raw column (0 pad)
    valid: torch.Tensor     # [T, NL, C] bool
    has: torch.Tensor       # [T, NL] bool


def stacked_leaf_values(X: torch.Tensor, leaves: torch.Tensor,
                        nodes: StackedNodes,
                        lin: Optional[LinearLeaves] = None) -> torch.Tensor:
    """[T, n] f32 value of every row in every tree: its leaf's value, or,
    at a linear leaf with a fit and no NaN among the row's values of its
    features, ``const + sum(coeff * x)`` in f32 over the raw rows ``X``
    [n, F] (reference ``_linear_leaf_values``)."""
    lf = leaves.long()
    vals = nodes.leaf_value.gather(1, lf)                   # [T, n]
    if lin is None:
        return vals
    T, n = lf.shape
    idx = lf[:, :, None].expand(T, n, lin.feat.shape[2])
    xv = X[None].expand(T, *X.shape).gather(2, lin.feat.gather(1, idx))
    lanes = lin.valid.gather(1, idx)
    bad = (torch.isnan(xv) & lanes).any(dim=2)
    s = lin.const.gather(1, lf) + torch.where(
        lanes, lin.coeff.gather(1, idx) * xv, 0.0).sum(dim=2)
    return torch.where(lin.has.gather(1, lf) & ~bad, s, vals)


def _raw_from_leaves(vals: torch.Tensor, K: int) -> torch.Tensor:
    """[T, n] f32 values -> [n, K] f32 raw scores. Trees are
    iteration-major (tree i is class i % K); each class sums its trees
    in iteration order with Kahan compensation, which lands within ~1
    ulp of the correctly rounded sum where a plain f32 running sum drifts
    by ~sqrt(T)/2 ulp."""
    per_iter = vals.view(-1, K, vals.shape[1])              # [I, K, n]
    s = torch.zeros(per_iter.shape[1:], dtype=vals.dtype,
                    device=vals.device)
    c = torch.zeros_like(s)
    for v in per_iter:
        y = v - c
        t = s + y
        c = (t - s) - y
        s = t
    return s.t()


def _sum_leaf_values_f64(leaves: torch.Tensor, leaf_value: torch.Tensor,
                         K: int) -> torch.Tensor:
    """[T, n] leaf ids and [T, NL] f64 leaf values -> [n, K] f64: each
    class adds its trees' values from 0 in tree order, the same IEEE adds
    in the same order as the host walk (``GBDT.predict_raw``), so the
    result is byte-equal to it."""
    vals = leaf_value.gather(1, leaves.long())              # [T, n]
    per_iter = vals.view(-1, K, vals.shape[1])
    s = torch.zeros(per_iter.shape[1:], dtype=torch.float64,
                    device=vals.device)
    for v in per_iter:
        s = s + v
    return s.t()


def stacked_forest_leaves(X, qt, nodes, trips, cat_lut=None):
    return _walk_stacked(_quantize_rows_impl(X, qt), nodes, trips, cat_lut)


def stacked_forest_raw(X, qt, nodes, trips, K, cat_lut=None, lin=None):
    leaves = stacked_forest_leaves(X, qt, nodes, trips, cat_lut)
    return _raw_from_leaves(stacked_leaf_values(X, leaves, nodes, lin), K)


def stacked_forest_leaves_dd(Xhi, Xlo, qt, nodes, trips, cat_lut=None):
    return _walk_stacked(_quantize_rows_dd_impl(Xhi, Xlo, qt), nodes, trips,
                         cat_lut)


def stacked_forest_raw_dd(Xhi, Xlo, qt, nodes, trips, K, cat_lut=None,
                          lin=None):
    """The dd walk; linear leaves evaluate over the rows' f32 parts
    ``Xhi`` (as in the reference)."""
    leaves = stacked_forest_leaves_dd(Xhi, Xlo, qt, nodes, trips, cat_lut)
    return _raw_from_leaves(stacked_leaf_values(Xhi, leaves, nodes, lin),
                            K)
