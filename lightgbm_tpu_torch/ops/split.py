"""Best-split search over (grad, hess, count) histograms.

Port of ``lightgbm_tpu/ops/split.py`` (reference:
src/treelearner/feature_histogram.hpp:85 ``FindBestThreshold``;
categorical scans at :278-520; closed forms at :477+):

- leaf output  = -ThresholdL1(sum_grad, l1) / (sum_hess + l2), clipped to
  +-max_delta_step when that is positive, then path-smoothed
- leaf gain    = -(2*ThresholdL1(g, l1)*out + (h + l2)*out^2)
- a split is valid iff both children have >= min_data_in_leaf in-bag rows
  and >= min_sum_hessian_in_leaf, and its gain exceeds the parent's gain
  plus min_gain_to_split
- missing values: a NaN-missing feature keeps NaN rows in its last bin;
  the scan scores both "NaN goes right" and "NaN goes left" and records
  ``default_left``; a zero-missing feature's rows sit in the zero bin, so
  default_left = (zero_bin <= threshold).

Everything is one vectorized pass in f32 on the histogram's device:
cumulative sums over the bin axis (:func:`prefix_sum`, in the
reference's own addition order) give the left-side stats of every
(feature, threshold), and a flat argmax (first maximum on ties, like
``jnp.argmax``) picks the winner. Invalid candidates score ``-inf``.

Categorical features (``has_categorical``, a static switch as in the
reference, so an all-numerical scan runs none of it) add three variants
over bins 1..num_bin-1 (bin 0 holds NaN and other values and always goes
right): one-hot (a single bin left, for features of at most
``max_cat_to_onehot`` bins) and the sorted subset in both directions
(eligible bins sorted by g / (h + cat_smooth) with a stable sort,
prefixes of at most ``max_cat_threshold`` bins, l2 raised by ``cat_l2``,
evaluated once per ``min_data_per_group`` rows). The winner's left bins
come back packed into the record.

Two optional inputs, as in the reference's ``find_best_split``
(lightgbm_tpu/ops/split.py:287-288): ``rand_bins`` (extra_trees: one
random candidate per feature and mode, from :func:`make_rand_bins`) and
``gain_penalty`` (CEGB: a per-feature penalty subtracted from every
candidate's gain before the argmax). Without them the scan runs exactly
the ops it runs without extra_trees and CEGB.

Monotone constraints (``has_monotone``, a static switch like
``has_categorical``; reference lightgbm_tpu/ops/split.py:334-426,570-680,
upstream BasicLeafConstraints, monotone_constraints.hpp): every output
is clamped into the leaf's ``[min_output, max_output]``, a numerical
split of a +1 (-1) feature whose left output exceeds (falls below) its
right one is rejected, gains of monotone features shrink with the
leaf's depth under ``monotone_penalty``, and the record carries the
bounds its children inherit (the mid-point of the two outputs caps the
monotone side). ``bound_arrays`` (the advanced method) clamps each
threshold by the running extrema of per-(feature, bin) bounds instead.
A learner with no monotone feature runs none of it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as TF

from ..io.binning import MissingType
from ..utils.prng import fold_in, uniform
from .quantize import dequantize_hist

_NEG_INF = float("-inf")
kSmoothEps = 1e-15
_SCAN_BASE = 16

# columns of a packed split record (one f32 row per leaf candidate)
(GAIN, FEATURE, THRESHOLD_BIN, DEFAULT_LEFT,
 LEFT_SUM_GRAD, LEFT_SUM_HESS, LEFT_COUNT, LEFT_TOTAL_COUNT, LEFT_OUTPUT,
 RIGHT_SUM_GRAD, RIGHT_SUM_HESS, RIGHT_COUNT, RIGHT_TOTAL_COUNT,
 RIGHT_OUTPUT) = range(14)
RECORD_WIDTH = 14
# a scan with categorical features appends: 1.0 for a categorical
# winner, then its left-bin mask as 16-bit words (bins 16k..16k+15 of
# word k, bit j for bin 16k + j; exact as f32 integers)
IS_CATEGORICAL = 14
CAT_WORDS = 15
CAT_WORD_BITS = 16
kEps = 1e-15


# a scan with monotone features appends, after the columns above, the
# bounds the winner's children inherit
(LEFT_MIN, LEFT_MAX, RIGHT_MIN, RIGHT_MAX) = range(4)


def record_width(num_bins: int, has_categorical: bool,
                 has_monotone: bool = False) -> int:
    """Columns of a record row: :data:`RECORD_WIDTH`, plus the winner's
    kind and its mask words when the scan has categorical features, plus
    four child bounds when it has monotone features."""
    width = RECORD_WIDTH
    if has_categorical:
        width = CAT_WORDS + -(-num_bins // CAT_WORD_BITS)
    return width + (4 if has_monotone else 0)


class RecordLayout(NamedTuple):
    """Where the optional columns of a learner's record rows sit, from
    the learner's static switches (a row's length alone cannot tell a
    categorical row from a monotone one)."""
    num_bins: int
    has_categorical: bool = False
    has_monotone: bool = False

    @property
    def width(self) -> int:
        return record_width(self.num_bins, self.has_categorical,
                            self.has_monotone)

    @property
    def cat_words(self) -> slice:
        """The columns of the winner's packed left-bin mask."""
        return slice(CAT_WORDS,
                     CAT_WORDS + -(-self.num_bins // CAT_WORD_BITS))

    @property
    def bounds(self) -> int:
        """The first of the four child-bound columns (LEFT_MIN, ...)."""
        return record_width(self.num_bins, self.has_categorical)


def pack_cat_mask(mask: torch.Tensor) -> torch.Tensor:
    """bool [B] -> f32 [ceil(B / 16)] words (bit j of word k: bin
    16k + j); sums of distinct powers of two below 2^16, exact in any
    order."""
    B = mask.shape[0]
    nw = -(-B // CAT_WORD_BITS)
    m = TF.pad(mask.to(torch.float32), (0, nw * CAT_WORD_BITS - B))
    pow2 = torch.pow(2.0, torch.arange(CAT_WORD_BITS, dtype=torch.float32,
                                       device=mask.device))
    return (m.view(nw, CAT_WORD_BITS) * pow2).sum(dim=1)


def unpack_cat_mask(words: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Inverse of :func:`pack_cat_mask` (on any device, no host read);
    words [..., nw] -> bool [..., num_bins]."""
    w = words.to(torch.int32)
    bits = torch.arange(CAT_WORD_BITS, dtype=torch.int32,
                        device=words.device)
    unpacked = ((w[..., None] >> bits) & 1).reshape(*w.shape[:-1], -1)
    return unpacked[..., :num_bins] > 0


def cat_mask_of_row(row, num_bins: int) -> np.ndarray:
    """Host twin of :func:`unpack_cat_mask` over a record row read back
    as floats."""
    nw = -(-num_bins // CAT_WORD_BITS)
    words = np.asarray(row[CAT_WORDS:CAT_WORDS + nw],
                       dtype=np.float64).astype(np.int64)
    bits = (words[:, None] >> np.arange(CAT_WORD_BITS)) & 1
    return bits.reshape(-1)[:num_bins] > 0


class SplitParams(NamedTuple):
    """Scalar hyper-parameters of the split search as f32 0-d tensors on
    the learner's device (the reference holds them as f32 device
    scalars, so comparisons and arithmetic round the same way)."""
    lambda_l1: torch.Tensor
    lambda_l2: torch.Tensor
    min_data_in_leaf: torch.Tensor
    min_sum_hessian_in_leaf: torch.Tensor
    min_gain_to_split: torch.Tensor
    max_delta_step: torch.Tensor
    path_smooth: torch.Tensor
    # categorical knobs (config.h:452-472); max_cat_threshold is a host
    # int: it bounds the sequential part of the sorted-subset scan
    cat_l2: torch.Tensor
    cat_smooth: torch.Tensor
    min_data_per_group: torch.Tensor
    max_cat_threshold: int
    # CEGB scalars (cost_effective_gradient_boosting.hpp:80-87)
    cegb_tradeoff: torch.Tensor
    cegb_penalty_split: torch.Tensor
    # monotone split gain penalty (config.h:503); read only by a scan
    # with monotone features
    monotone_penalty: torch.Tensor

    @classmethod
    def from_config(cls, config, device: torch.device) -> "SplitParams":
        def f32(v):
            return torch.tensor(float(v), dtype=torch.float32,
                                device=device)
        return cls(lambda_l1=f32(config.lambda_l1),
                   lambda_l2=f32(config.lambda_l2),
                   min_data_in_leaf=f32(config.min_data_in_leaf),
                   min_sum_hessian_in_leaf=f32(
                       config.min_sum_hessian_in_leaf),
                   min_gain_to_split=f32(config.min_gain_to_split),
                   max_delta_step=f32(config.max_delta_step),
                   path_smooth=f32(config.path_smooth),
                   cat_l2=f32(config.cat_l2),
                   cat_smooth=f32(config.cat_smooth),
                   min_data_per_group=f32(config.min_data_per_group),
                   max_cat_threshold=int(config.max_cat_threshold),
                   cegb_tradeoff=f32(config.cegb_tradeoff),
                   cegb_penalty_split=f32(config.cegb_penalty_split),
                   monotone_penalty=f32(config.monotone_penalty))


class FeatureMeta(NamedTuple):
    """Per-feature metadata, int32 [F] tensors on the learner's device;
    ``is_categorical`` and ``use_onehot`` bool [F] (None: all
    numerical). ``cat_positions`` (host int) is the most prefix
    positions a sorted-subset scan can evaluate, the largest
    num_bin // 2 of a categorical feature. ``monotone`` is the int32
    [F] constraint (-1, 0, +1), None when no feature has one."""
    num_bin: torch.Tensor
    missing_type: torch.Tensor
    zero_bin: torch.Tensor
    is_categorical: Optional[torch.Tensor] = None
    use_onehot: Optional[torch.Tensor] = None
    cat_positions: int = 0
    monotone: Optional[torch.Tensor] = None

    @classmethod
    def from_dataset(cls, dataset, device: torch.device,
                     max_cat_to_onehot: int) -> "FeatureMeta":
        from ..io.binning import BinType

        def i32(vals):
            return torch.from_numpy(np.asarray(vals, dtype=np.int32)).to(
                device)
        num_bin = np.asarray(dataset.num_bin_per_feature, dtype=np.int32)
        is_cat = np.asarray([m.bin_type == BinType.CATEGORICAL
                             for m in dataset.bin_mappers], dtype=bool)
        mc = getattr(dataset, "monotone_constraints", None)
        has_mono = mc is not None and bool(np.any(np.asarray(mc) != 0))
        return cls(
            num_bin=i32(num_bin),
            missing_type=i32([m.missing_type for m in dataset.bin_mappers]),
            zero_bin=i32([m.default_bin for m in dataset.bin_mappers]),
            is_categorical=torch.from_numpy(is_cat).to(device),
            use_onehot=torch.from_numpy(
                is_cat & (num_bin <= max_cat_to_onehot)).to(device),
            cat_positions=int((num_bin[is_cat] // 2).max())
            if is_cat.any() else 0,
            monotone=i32(mc) if has_mono else None)


def pad_feature_meta(meta: FeatureMeta, pad: int) -> FeatureMeta:
    """Append ``pad`` trivial features (num_bin 1: never a valid split)."""
    if pad <= 0:
        return meta

    def padv(a, fill):
        if a is None:
            return None
        return torch.cat([a, torch.full((pad,), fill, dtype=a.dtype,
                                        device=a.device)])

    return meta._replace(num_bin=padv(meta.num_bin, 1),
                         missing_type=padv(meta.missing_type, 0),
                         zero_bin=padv(meta.zero_bin, 0),
                         is_categorical=padv(meta.is_categorical, False),
                         use_onehot=padv(meta.use_onehot, False),
                         monotone=padv(meta.monotone, 0))


def select_frontier(gain: torch.Tensor, k: int):
    """(leaves [k] int64, selection gains [k] f32) of the top ``k``
    pending split candidates, slot 0 always ``argmax(gain)`` (the first
    maximum, ties included): reference ``select_frontier``. The
    out-of-core learner speculates these as the next ``k`` leaf-wise
    splits in order; pinning slot 0 to the argmax makes every validated
    round accept at least one split, whatever order ``topk`` gives
    ties. The gains are the selection values: a slot past the live
    candidates carries -inf even where its index repeats a live leaf,
    which is what marks it dead."""
    best = torch.argmax(gain).view(1)
    if k <= 1:
        return best, gain.index_select(0, best)
    masked = gain.clone()
    masked[best] = float("-inf")
    vals, rest = torch.topk(masked, min(k - 1, gain.shape[0]))
    return (torch.cat([best, rest]),
            torch.cat([gain.index_select(0, best), vals]))


def threshold_l1(s: torch.Tensor, l1: torch.Tensor) -> torch.Tensor:
    """Soft-threshold by the L1 penalty (reference: ``ThresholdL1``)."""
    return torch.sign(s) * torch.clamp(s.abs() - l1, min=0.0)


def calculate_leaf_output(sum_grad, sum_hess, p: SplitParams, l2=None):
    """Closed-form leaf weight (reference: CalculateSplittedLeafOutput);
    ``l2`` replaces lambda_l2 (the sorted-subset scan adds cat_l2)."""
    if l2 is None:
        l2 = p.lambda_l2
    out = -threshold_l1(sum_grad, p.lambda_l1) / (sum_hess + l2)
    clipped = torch.minimum(torch.maximum(out, -p.max_delta_step),
                            p.max_delta_step)
    return torch.where(p.max_delta_step > 0.0, clipped, out)


def leaf_gain_given_output(sum_grad, sum_hess, output, p: SplitParams,
                           l2=None):
    """reference: GetLeafGainGivenOutput (exact also when the output was
    clipped by max_delta_step)."""
    if l2 is None:
        l2 = p.lambda_l2
    sg = threshold_l1(sum_grad, p.lambda_l1)
    return -(2.0 * sg * output + (sum_hess + l2) * output * output)


def leaf_gain(sum_grad, sum_hess, p: SplitParams):
    return leaf_gain_given_output(
        sum_grad, sum_hess, calculate_leaf_output(sum_grad, sum_hess, p), p)


def smooth_output(out, count, parent_output, p: SplitParams):
    """Path smoothing toward the parent's output (reference:
    feature_histogram.hpp:743-765): out*(n/a)/(n/a+1) + parent/(n/a+1)."""
    alpha = torch.clamp(p.path_smooth, min=1e-30)
    f = count / alpha
    smoothed = out * f / (f + 1.0) + parent_output / (f + 1.0)
    return torch.where(p.path_smooth > kSmoothEps, smoothed, out)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 sum along the last axis of ``x [..., B]``, added in
    the order of the reference's ``jnp.cumsum``.

    XLA's CPU build rewrites that cumsum (a reduce-window;
    ``ReduceWindowRewriter``, base length 16, as compiled by the JAX
    version the tests pin) into two levels: pad the axis to a multiple of
    16, take a sequential inclusive sum inside each block of 16, take the
    exclusive sum of the block totals by the same rule (recursively once
    there are more than 16 blocks), and add the two. An axis of at most
    16 is summed sequentially. Every step here is an f32 add on a tensor
    (no ``torch.cumsum``, whose CPU kernel accumulates in f64), so the
    CPU and the card give the reference's bits for the same input.

    The sequential steps run on ``[..., nb, 16]`` views: about 35 small
    ops for B = 256, whatever the leading shape."""
    B = x.shape[-1]
    if B <= _SCAN_BASE:
        out = x.clone()
        for k in range(1, B):
            out[..., k] += out[..., k - 1]
        return out
    nb = -(-B // _SCAN_BASE)
    blocks = TF.pad(x, (0, nb * _SCAN_BASE - B)).view(*x.shape[:-1], nb,
                                                       _SCAN_BASE)
    for k in range(1, _SCAN_BASE):
        blocks[..., k] += blocks[..., k - 1]
    # exclusive sums of the block totals: 0, t0, t0 + t1, ...
    offsets = TF.pad(prefix_sum(blocks[..., :-1, -1]), (1, 0))
    out = blocks + offsets[..., None]
    return out.view(*x.shape[:-1], nb * _SCAN_BASE)[..., :B]


def make_rand_bins(keys: torch.Tensor, meta: FeatureMeta,
                   params: SplitParams):
    """extra_trees (config.h:368): one random candidate per feature and
    node (reference ``make_rand_bins``, lightgbm_tpu/ops/split.py:250;
    upstream's rand.NextInt calls, feature_histogram.hpp:109,321,402).

    ``keys`` holds node keys ``[..., 2]`` (one node's ``[2]``, or both
    children of a split as ``[2, 2]``). Feature f of a node draws
    ``uniform(fold_in(node_key, f), (3,))``, so its draw depends only on
    (key, f), never on the padded feature count; every node and feature
    is drawn in one hash call per stage. Returns int32 ``[..., F]``
    tensors: the numerical threshold ``floor(u0 * max(num_bin - 2, 1))``,
    the one-hot bin ``1 + floor(u1 * max(num_bin - 1, 1))`` and the
    sorted-subset position ``floor(u2 * max(min(max_cat_threshold,
    (num_bin + 1) // 2), 1))``."""
    F = meta.num_bin.shape[0]
    fids = torch.arange(F, dtype=torch.int64, device=keys.device)
    u = uniform(fold_in(keys[..., None, :], fids), (3,))
    nb = meta.num_bin
    rand_num = torch.floor(
        u[..., 0] * torch.clamp(nb - 2, min=1)).to(torch.int32)
    rand_oh = 1 + torch.floor(
        u[..., 1] * torch.clamp(nb - 1, min=1)).to(torch.int32)
    max_thr = torch.clamp(torch.clamp((nb + 1) // 2,
                                      max=params.max_cat_threshold), min=1)
    rand_sorted = torch.floor(u[..., 2] * max_thr).to(torch.int32)
    return rand_num, rand_oh, rand_sorted


def cegb_penalty(params: SplitParams, count: torch.Tensor,
                 used: torch.Tensor, coupled: torch.Tensor,
                 unfetched: Optional[torch.Tensor] = None,
                 lazy: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 [F] CEGB gain penalty of scanning one leaf (reference
    ``_cegb_penalty``, lightgbm_tpu/treelearner/serial.py:598; upstream
    CostEfficientGradientBoosting::DeltaGain,
    cost_effective_gradient_boosting.hpp:80-99): the split penalty
    scaled by the leaf's row count, the coupled penalty of features the
    model has not used yet, and in lazy mode the per-row fetch cost of
    the leaf's rows that have not fetched the feature, all times
    ``cegb_tradeoff``."""
    pen = params.cegb_penalty_split * count + coupled * (~used)
    if lazy is not None:
        pen = pen + lazy * unfetched
    return params.cegb_tradeoff * pen


def _at(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``a[i]`` for a 1-d ``a`` and a 0-d index on the device, as a 0-d
    tensor. Indexing with the tensor itself would read it back to the
    host; this keeps the scan free of host reads, so a CUDA graph can
    hold it."""
    return a.index_select(0, i.view(1)).view(())


def find_best_split(hist: torch.Tensor, sum_grad: torch.Tensor,
                    sum_hess: torch.Tensor, sum_count: torch.Tensor,
                    sum_total_count: torch.Tensor, meta: FeatureMeta,
                    params: SplitParams, feature_mask: torch.Tensor,
                    parent_output: torch.Tensor,
                    hist_scale: Optional[torch.Tensor] = None,
                    has_categorical: bool = False,
                    rand_bins: Optional[tuple] = None,
                    gain_penalty: Optional[torch.Tensor] = None,
                    has_monotone: bool = False,
                    min_output: Optional[torch.Tensor] = None,
                    max_output: Optional[torch.Tensor] = None,
                    leaf_depth: Optional[torch.Tensor] = None,
                    bound_arrays: Optional[tuple] = None,
                    with_variant: bool = False):
    """Scan one leaf histogram for its best (feature, threshold).

    hist : f32 [F, B, 4] sums of (grad, hess, in-bag count, total count);
        int32 in quantized-gradient mode, dequantized once here by
        ``hist_scale`` (f32 [2], the tree's (g_scale, h_scale)) so each
        bin sum carries one rounding; the count channels convert exactly
    sum_* : the leaf's f32 0-d totals (already dequantized)
    feature_mask : bool [F]
    parent_output : f32 0-d, the leaf's own output (path smoothing)
    has_categorical : static; scan the categorical features of ``meta``
        too (and return the wider record of :func:`record_width`)
    rand_bins : extra_trees; the node's (numerical threshold, one-hot
        bin, sorted-subset position) per feature (:func:`make_rand_bins`),
        the one candidate of each mode
    gain_penalty : CEGB; f32 [F] subtracted from every candidate's gain
        (:func:`cegb_penalty`)
    has_monotone : static; ``meta.monotone`` holds constraints: clamp
        every output into [``min_output``, ``max_output``] (f32 0-d,
        None for -inf / +inf), reject splits against a feature's
        direction, shrink monotone gains by ``leaf_depth`` (f32 0-d; no
        penalty when None) and append the children's bounds
    bound_arrays : the advanced method; (min_c, max_c) f32 [F, B]
        per-(feature, bin) bounds (pad bins -inf / +inf) that replace
        the leaf-wide pair: a threshold's left child is clamped by the
        running extrema over bins [0, t], its right child over [t + 1,
        B), and a threshold whose interval inverts is rejected

    with_variant : also return the winner's variant (0-d int64: 0 the
        NaN bin right, 1 left, 2.. the categorical modes), which with
        its feature and bin orders the flat argmax across feature blocks

    Returns one f32 record row (see the column constants); an invalid
    record has gain -inf and feature -1.
    """
    F, B, _ = hist.shape
    dev = hist.device
    hist = dequantize_hist(hist, hist_scale)
    g, h, c, tc = hist[..., 0], hist[..., 1], hist[..., 2], hist[..., 3]
    if has_monotone:
        if min_output is None:
            min_output = torch.full((), _NEG_INF, device=dev)
        if max_output is None:
            max_output = torch.full((), float("inf"), device=dev)
    flat_min, flat_max = min_output, max_output
    if bound_arrays is not None:
        min_c, max_c = bound_arrays                              # [F, B]
        lmin_b = torch.cummax(min_c, dim=1).values
        lmax_b = torch.cummin(max_c, dim=1).values
        rmin_b = TF.pad(torch.cummax(min_c.flip(1), dim=1).values.flip(1)
                        [:, 1:], (0, 1), value=_NEG_INF)
        rmax_b = TF.pad(torch.cummin(max_c.flip(1), dim=1).values.flip(1)
                        [:, 1:], (0, 1), value=float("inf"))
        bounds_ok = (lmin_b <= lmax_b) & (rmin_b <= rmax_b)
        # categorical splits take the leaf-wide clamp: the most
        # restrictive piece (pad bins are neutral)
        flat_min = min_c.amax(dim=1)[:, None]
        flat_max = max_c.amin(dim=1)[:, None]

    def bounded_output(sg, sh, n, l2=None, lo=None, hi=None):
        out = calculate_leaf_output(sg, sh, params, l2)
        out = smooth_output(out, n, parent_output, params)
        if not has_monotone:
            return out
        lo = min_output if lo is None else lo
        hi = max_output if hi is None else hi
        return torch.minimum(torch.maximum(out, lo), hi)

    def bounded_gain(sg, sh, n, l2=None):
        return leaf_gain_given_output(
            sg, sh, bounded_output(sg, sh, n, l2, flat_min, flat_max),
            params, l2)

    # the four channels' prefix sums in one call: [4, F, B]
    left_g, left_h, left_c, left_tc = prefix_sum(hist.permute(2, 0, 1))

    bin_ids = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    num_bin = meta.num_bin[:, None]
    is_nan_missing = meta.missing_type == MissingType.NAN
    nan_bin = torch.clamp(meta.num_bin - 1, 0, B - 1).long()[:, None]
    zero = torch.zeros((), dtype=hist.dtype, device=dev)

    def nan_of(a):
        return torch.where(is_nan_missing,
                           torch.gather(a, 1, nan_bin)[:, 0], zero)

    nan_g, nan_h, nan_c, nan_tc = nan_of(g), nan_of(h), nan_of(c), \
        nan_of(tc)

    # thresholds t <= num_bin - 2 (the right side must be reachable); a
    # NaN-missing feature's NaN bin is not a threshold either
    t_max = torch.where(is_nan_missing[:, None], num_bin - 2, num_bin - 1)
    valid_t = (bin_ids < t_max) & feature_mask[:, None]
    if has_categorical:
        valid_t = valid_t & ~meta.is_categorical[:, None]
    if rand_bins is not None:
        # extra_trees: only the feature's random threshold is a candidate
        valid_t = valid_t & (bin_ids == rand_bins[0][:, None])

    def split_gain(lg, lh, lc):
        rg, rh, rc = sum_grad - lg, sum_hess - lh, sum_count - lc
        ok = ((lc >= params.min_data_in_leaf)
              & (rc >= params.min_data_in_leaf)
              & (lh >= params.min_sum_hessian_in_leaf)
              & (rh >= params.min_sum_hessian_in_leaf))
        if bound_arrays is not None:
            out_l = bounded_output(lg, lh, lc, lo=lmin_b, hi=lmax_b)
            out_r = bounded_output(rg, rh, rc, lo=rmin_b, hi=rmax_b)
            ok = ok & bounds_ok
        else:
            out_l = bounded_output(lg, lh, lc)
            out_r = bounded_output(rg, rh, rc)
        if has_monotone:
            mono = meta.monotone[:, None]
            ok = ok & ~(((mono > 0) & (out_l > out_r))
                        | ((mono < 0) & (out_l < out_r)))
        gain = (leaf_gain_given_output(lg, lh, out_l, params)
                + leaf_gain_given_output(rg, rh, out_r, params))
        return torch.where(ok & valid_t, gain, _NEG_INF)

    gain_r = split_gain(left_g, left_h, left_c)        # NaN bin stays right
    gain_l = split_gain(left_g + nan_g[:, None],       # NaN bin goes left
                        left_h + nan_h[:, None],
                        left_c + nan_c[:, None])
    gain_l = torch.where(is_nan_missing[:, None], gain_l, _NEG_INF)

    # parent baseline subtracted before the argmax (reference:
    # min_gain_shift; under path smoothing the smoothed own output)
    own_out = calculate_leaf_output(sum_grad, sum_hess, params)
    own_smoothed = smooth_output(own_out, sum_count, parent_output, params)
    use_smooth = params.path_smooth > kSmoothEps
    parent_gain_plain = leaf_gain(sum_grad, sum_hess, params)
    parent_gain = torch.where(
        use_smooth,
        leaf_gain_given_output(sum_grad, sum_hess, own_smoothed, params),
        parent_gain_plain)
    shift = parent_gain + params.min_gain_to_split
    variants = [gain_r - shift, gain_l - shift]
    if has_categorical:
        cat = _categorical_scan(g, h, c, tc, sum_grad, sum_hess, sum_count,
                                meta, params, feature_mask, bounded_gain,
                                rand_bins)
        # the categorical baseline scores the stored parent output
        # under path smoothing (reference fh.hpp:294-303)
        shift_cat = torch.where(
            use_smooth,
            leaf_gain_given_output(sum_grad, sum_hess, parent_output,
                                   params),
            parent_gain_plain) + params.min_gain_to_split
        variants += [cat["gain_oh"] - shift_cat, cat["gain_f"] - shift_cat,
                     cat["gain_r"] - shift_cat]

    gains = torch.stack(variants)
    if gain_penalty is not None:
        # CEGB: threshold-independent, so it reorders features without
        # moving a feature's best threshold
        gains = gains - gain_penalty[None, :, None]
    if has_monotone and leaf_depth is not None:
        # monotone split gain penalty (upstream
        # ComputeMonotoneSplitGainPenalty, monotone_constraints.hpp:355):
        # gains of splits on monotone features shrink with depth
        p = params.monotone_penalty
        d = leaf_depth.to(torch.float32)
        factor = torch.where(
            p >= d + 1.0, 1e-10,
            torch.where(p <= 1.0, 1.0 - p / torch.exp2(d) + 1e-10,
                        1.0 - torch.exp2(p - 1.0 - d) + 1e-10))
        mult = torch.where((meta.monotone != 0) & (p > 0.0), factor, 1.0)
        gains = torch.where(torch.isfinite(gains),
                            gains * mult[None, :, None], gains)
    flat = gains.reshape(-1)
    best = torch.argmax(flat)
    best_gain = _at(flat, best)
    variant, rem = best // (F * B), best % (F * B)
    feature, tbin = rem // B, rem % B

    is_l = variant == 1

    def left_at(prefix, nan):
        return (_at(prefix.reshape(-1), rem)
                + torch.where(is_l, _at(nan, feature), zero))

    lg, lh = left_at(left_g, nan_g), left_at(left_h, nan_h)
    lc, ltc = left_at(left_c, nan_c), left_at(left_tc, nan_tc)
    default_left = torch.where(
        _at(is_nan_missing, feature), is_l,
        (_at(meta.missing_type, feature) == MissingType.ZERO)
        & (_at(meta.zero_bin, feature) <= tbin))
    out_l2 = None
    if has_categorical:
        # the winner's left stats by variant: one-hot bin, or the
        # prefix of the sorted bins in either direction
        def pick(numerical, oh, fwd, rev):
            return torch.where(variant <= 1, numerical, torch.where(
                variant == 2, oh, torch.where(
                    variant == 3, _at(fwd.reshape(-1), rem),
                    _at(rev.reshape(-1), rem))))
        stats_f, stats_r = cat["stats_f"], cat["stats_r"]
        lg = pick(lg, _at(g.reshape(-1), rem), stats_f[0], stats_r[0])
        lh = pick(lh, _at(h.reshape(-1), rem) + kEps, stats_f[1],
                  stats_r[1])
        lc = pick(lc, _at(c.reshape(-1), rem), stats_f[2], stats_r[2])
        ltc = pick(ltc, _at(tc.reshape(-1), rem), stats_f[3], stats_r[3])
        is_cat_winner = variant >= 2
        default_left = default_left & ~is_cat_winner
        out_l2 = torch.where(variant >= 3, cat["cat_l2"], params.lambda_l2)
        cat_mask = _winner_cat_mask(cat, variant, feature, tbin, B)
    rg, rh, rc = sum_grad - lg, sum_hess - lh, sum_count - lc
    rtc = sum_total_count - ltc

    is_valid = torch.isfinite(best_gain) & (best_gain > 0.0)
    if bound_arrays is not None:
        # the winner's outputs carry the clamp its gain was scored with
        if has_categorical:
            def w_bound(per_t, flat):
                return torch.where(is_cat_winner, _at(flat[:, 0], feature),
                                   _at(per_t.reshape(-1), rem))
        else:
            def w_bound(per_t, flat):
                return _at(per_t.reshape(-1), rem)
        out_left = bounded_output(lg, lh, lc, out_l2,
                                  w_bound(lmin_b, flat_min),
                                  w_bound(lmax_b, flat_max))
        out_right = bounded_output(rg, rh, rc, out_l2,
                                   w_bound(rmin_b, flat_min),
                                   w_bound(rmax_b, flat_max))
    else:
        out_left = bounded_output(lg, lh, lc, out_l2)
        out_right = bounded_output(rg, rh, rc, out_l2)
    neg_one = torch.full((), -1.0, dtype=torch.float32, device=dev)
    row = torch.stack([
        torch.where(is_valid, best_gain, _NEG_INF),
        torch.where(is_valid, feature.float(), neg_one),
        tbin.float(), default_left.float(),
        lg, lh, lc, ltc, out_left, rg, rh, rc, rtc, out_right])
    if has_categorical:
        row = torch.cat([row, is_cat_winner.float().view(1),
                         pack_cat_mask(cat_mask)])
    if not has_monotone:
        return (row, variant) if with_variant else row
    # the children's bounds (upstream BasicLeafConstraints::Update): the
    # mid-point of the two outputs caps the monotone side
    mc_w = _at(meta.monotone, feature)
    if has_categorical:
        mc_w = torch.where(is_cat_winner, 0, mc_w)
    mid = (out_left + out_right) / 2.0
    row = torch.cat([row, torch.stack([
        torch.where(mc_w < 0, torch.maximum(min_output, mid), min_output),
        torch.where(mc_w > 0, torch.minimum(max_output, mid), max_output),
        torch.where(mc_w > 0, torch.maximum(min_output, mid), min_output),
        torch.where(mc_w < 0, torch.minimum(max_output, mid),
                    max_output)])])
    return (row, variant) if with_variant else row


def _categorical_scan(g, h, c, tc, sum_grad, sum_hess, sum_count,
                      meta: FeatureMeta, params: SplitParams,
                      feature_mask, bounded_gain, rand_bins=None) -> dict:
    """The categorical variants of a leaf scan (reference:
    FindBestThresholdCategoricalInner, feature_histogram.hpp:278-520, as
    vectorized by ``lightgbm_tpu/ops/split.py:439-535``): [F, B] gains of
    one-hot mode and of the sorted-subset prefixes in both directions,
    with what the winner's stats and mask are read from."""
    F, B = g.shape
    dev = g.device
    bin_ids = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    is_cat = meta.is_categorical
    cat_bin_ok = ((bin_ids >= 1) & (bin_ids < meta.num_bin[:, None])
                  & is_cat[:, None] & feature_mask[:, None])
    min_data = params.min_data_in_leaf
    min_hess = params.min_sum_hessian_in_leaf

    # one-hot mode (num_bin <= max_cat_to_onehot; plain lambda_l2)
    oh_ok = (cat_bin_ok & meta.use_onehot[:, None]
             & (c >= min_data) & (h >= min_hess)
             & ((sum_count - c) >= min_data)
             & ((sum_hess - h - kEps) >= min_hess))
    gain_oh = (bounded_gain(g, h + kEps, c)
               + bounded_gain(sum_grad - g, sum_hess - h - kEps,
                              sum_count - c))
    if rand_bins is not None:
        oh_ok = oh_ok & (bin_ids == rand_bins[1][:, None])
    gain_oh = torch.where(oh_ok, gain_oh, _NEG_INF)

    # sorted-subset mode: eligible bins by g / (h + cat_smooth), stably
    # (ineligible ones last, as +inf), l2 raised by cat_l2
    cat_l2 = params.lambda_l2 + params.cat_l2
    sort_elig = (cat_bin_ok & ~meta.use_onehot[:, None]
                 & (c >= params.cat_smooth))
    used_bin = sort_elig.sum(dim=1, dtype=torch.int32)
    ratio = torch.where(sort_elig, g / (h + params.cat_smooth),
                        float("inf"))
    order = torch.sort(ratio, dim=1, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(B, device=dev).expand(F, B).contiguous())
    sorted_stats = torch.stack([a.gather(1, order) for a in (g, h, c, tc)])
    max_num_cat = torch.clamp((used_bin + 1) // 2,
                              max=params.max_cat_threshold)
    # reverse direction: the sorted bins from the high end, rolled so
    # that the eligible ones come first
    shift_idx = (bin_ids.long() + (B - used_bin.long())[:, None]) % B
    rev_stats = sorted_stats.flip(2).gather(
        2, shift_idx.expand(4, F, B))

    # both directions at once: [2 directions, 4 channels, F, B]
    stats = torch.stack([sorted_stats, rev_stats])
    left = prefix_sum(stats)
    lg, lh, lc, ltc = left[:, 0], left[:, 1] + kEps, left[:, 2], left[:, 3]
    rg, rh, rc = sum_grad - lg, sum_hess - lh, sum_count - lc
    pos_ok = ((bin_ids < used_bin[:, None])
              & (bin_ids < max_num_cat[:, None]))           # [F, B]
    cont = (lc < min_data) | (lh < min_hess)
    brk = ~cont & ((rc < min_data) | (rc < params.min_data_per_group)
                   | (rh < min_hess))
    # a direction's scan stops at its first break (reference
    # feature_histogram.hpp:436-441): broken before position i
    brk_pos = (brk & pos_ok).to(torch.int32)
    broken = (torch.cumsum(brk_pos, dim=2) - brk_pos) > 0
    allowed = pos_ok & ~broken & ~cont & ~brk
    # min_data_per_group batching (fh.hpp:443-447): rows accumulate and
    # a position is evaluated once the running group holds
    # min_data_per_group, which starts a new group; sequential over the
    # positions a prefix can reach (max_cat_threshold, num_bin // 2)
    K = min(B, params.max_cat_threshold,
            meta.cat_positions if meta.cat_positions > 0 else B)
    scd = stats[:, 2]
    cnt = torch.zeros((2, F), dtype=g.dtype, device=dev)
    can_eval = torch.zeros((2, F, B), dtype=torch.bool, device=dev)
    for i in range(K):
        cnt = cnt + scd[:, :, i]
        ce = allowed[:, :, i] & (cnt >= params.min_data_per_group)
        cnt = torch.where(ce, 0.0, cnt)
        can_eval[:, :, i] = ce
    gains = (bounded_gain(lg, lh, lc, cat_l2)
             + bounded_gain(rg, rh, rc, cat_l2))
    gains = torch.where(can_eval, gains, _NEG_INF)
    if rand_bins is not None:
        # extra_trees: only the random prefix length, both directions
        gains = torch.where(rand_bins[2][:, None] == bin_ids, gains,
                            _NEG_INF)
    return dict(gain_oh=gain_oh, gain_f=gains[0], gain_r=gains[1],
                stats_f=(lg[0], lh[0], lc[0], ltc[0]),
                stats_r=(lg[1], lh[1], lc[1], ltc[1]),
                rank=rank, used_bin=used_bin, sort_elig=sort_elig,
                cat_l2=cat_l2)


def _winner_cat_mask(cat: dict, variant, feature, tbin,
                     B: int) -> torch.Tensor:
    """bool [B] of the bins a categorical winner sends left: one-hot ->
    {tbin}; sorted forward -> ranks <= tbin; sorted reverse -> the
    tbin + 1 highest-ratio eligible bins; all False for a numerical
    winner."""
    dev = tbin.device
    f = feature.view(1)
    rk = cat["rank"].index_select(0, f).view(-1)
    ub = _at(cat["used_bin"], feature)
    elig = cat["sort_elig"].index_select(0, f).view(-1)
    bins = torch.arange(B, device=dev)
    mask_oh = bins == tbin
    mask_fwd = (rk <= tbin) & elig
    mask_rev = (rk >= ub - 1 - tbin) & (rk < ub) & elig
    return torch.where(variant == 2, mask_oh, torch.where(
        variant == 3, mask_fwd, torch.where(
            variant == 4, mask_rev, torch.zeros_like(mask_oh))))
