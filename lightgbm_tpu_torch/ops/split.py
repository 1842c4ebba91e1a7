"""Best-split search over (grad, hess, count) histograms.

Port of the numerical path of ``lightgbm_tpu/ops/split.py``
(reference: src/treelearner/feature_histogram.hpp:85
``FindBestThreshold``; closed forms at :477+):

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
cumulative sums over the bin axis give the left-side stats of every
(feature, threshold), and a flat argmax (first maximum on ties, like
``jnp.argmax``) picks the winner. Invalid candidates score ``-inf``.
Categorical scans and monotone bounds are later slices (ROADMAP items
11 and 15).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..io.binning import MissingType
from .quantize import dequantize_hist

_NEG_INF = float("-inf")
kSmoothEps = 1e-15

# columns of a packed split record (one f32 row per leaf candidate)
(GAIN, FEATURE, THRESHOLD_BIN, DEFAULT_LEFT,
 LEFT_SUM_GRAD, LEFT_SUM_HESS, LEFT_COUNT, LEFT_TOTAL_COUNT, LEFT_OUTPUT,
 RIGHT_SUM_GRAD, RIGHT_SUM_HESS, RIGHT_COUNT, RIGHT_TOTAL_COUNT,
 RIGHT_OUTPUT) = range(14)
RECORD_WIDTH = 14


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
                   path_smooth=f32(config.path_smooth))


class FeatureMeta(NamedTuple):
    """Per-feature metadata, int32 [F] tensors on the learner's device."""
    num_bin: torch.Tensor
    missing_type: torch.Tensor
    zero_bin: torch.Tensor

    @classmethod
    def from_dataset(cls, dataset, device: torch.device) -> "FeatureMeta":
        def i32(vals):
            return torch.from_numpy(np.asarray(vals, dtype=np.int32)).to(
                device)
        return cls(
            num_bin=i32(dataset.num_bin_per_feature),
            missing_type=i32([m.missing_type for m in dataset.bin_mappers]),
            zero_bin=i32([m.default_bin for m in dataset.bin_mappers]))


def pad_feature_meta(meta: FeatureMeta, pad: int) -> FeatureMeta:
    """Append ``pad`` trivial features (num_bin 1: never a valid split)."""
    if pad <= 0:
        return meta

    def padv(a, fill):
        return torch.cat([a, torch.full((pad,), fill, dtype=a.dtype,
                                        device=a.device)])

    return FeatureMeta(num_bin=padv(meta.num_bin, 1),
                       missing_type=padv(meta.missing_type, 0),
                       zero_bin=padv(meta.zero_bin, 0))


def threshold_l1(s: torch.Tensor, l1: torch.Tensor) -> torch.Tensor:
    """Soft-threshold by the L1 penalty (reference: ``ThresholdL1``)."""
    return torch.sign(s) * torch.clamp(s.abs() - l1, min=0.0)


def calculate_leaf_output(sum_grad, sum_hess, p: SplitParams):
    """Closed-form leaf weight (reference: CalculateSplittedLeafOutput)."""
    out = -threshold_l1(sum_grad, p.lambda_l1) / (sum_hess + p.lambda_l2)
    clipped = torch.minimum(torch.maximum(out, -p.max_delta_step),
                            p.max_delta_step)
    return torch.where(p.max_delta_step > 0.0, clipped, out)


def leaf_gain_given_output(sum_grad, sum_hess, output, p: SplitParams):
    """reference: GetLeafGainGivenOutput (exact also when the output was
    clipped by max_delta_step)."""
    sg = threshold_l1(sum_grad, p.lambda_l1)
    return -(2.0 * sg * output + (sum_hess + p.lambda_l2) * output * output)


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


def find_best_split(hist: torch.Tensor, sum_grad: torch.Tensor,
                    sum_hess: torch.Tensor, sum_count: torch.Tensor,
                    sum_total_count: torch.Tensor, meta: FeatureMeta,
                    params: SplitParams, feature_mask: torch.Tensor,
                    parent_output: torch.Tensor,
                    hist_scale: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Scan one leaf histogram for its best (feature, threshold).

    hist : f32 [F, B, 4] sums of (grad, hess, in-bag count, total count);
        int32 in quantized-gradient mode, dequantized once here by
        ``hist_scale`` (f32 [2], the tree's (g_scale, h_scale)) so each
        bin sum carries one rounding; the count channels convert exactly
    sum_* : the leaf's f32 0-d totals (already dequantized)
    feature_mask : bool [F]
    parent_output : f32 0-d, the leaf's own output (path smoothing)

    Returns one f32 record row of width ``RECORD_WIDTH`` (see the column
    constants); an invalid record has gain -inf and feature -1.
    """
    F, B, _ = hist.shape
    dev = hist.device
    hist = dequantize_hist(hist, hist_scale)
    g, h, c, tc = hist[..., 0], hist[..., 1], hist[..., 2], hist[..., 3]

    def bounded_output(sg, sh, n):
        out = calculate_leaf_output(sg, sh, params)
        return smooth_output(out, n, parent_output, params)

    left_g = torch.cumsum(g, dim=1)
    left_h = torch.cumsum(h, dim=1)
    left_c = torch.cumsum(c, dim=1)
    left_tc = torch.cumsum(tc, dim=1)

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

    def split_gain(lg, lh, lc):
        rg, rh, rc = sum_grad - lg, sum_hess - lh, sum_count - lc
        ok = ((lc >= params.min_data_in_leaf)
              & (rc >= params.min_data_in_leaf)
              & (lh >= params.min_sum_hessian_in_leaf)
              & (rh >= params.min_sum_hessian_in_leaf))
        out_l = bounded_output(lg, lh, lc)
        out_r = bounded_output(rg, rh, rc)
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
    parent_gain = torch.where(
        params.path_smooth > kSmoothEps,
        leaf_gain_given_output(sum_grad, sum_hess, own_smoothed, params),
        leaf_gain(sum_grad, sum_hess, params))
    shift = parent_gain + params.min_gain_to_split

    flat = torch.stack([gain_r - shift, gain_l - shift]).reshape(-1)
    best = torch.argmax(flat)
    best_gain = flat[best]
    variant, rem = best // (F * B), best % (F * B)
    feature, tbin = rem // B, rem % B

    is_l = variant == 1
    lg = left_g[feature, tbin] + torch.where(is_l, nan_g[feature], zero)
    lh = left_h[feature, tbin] + torch.where(is_l, nan_h[feature], zero)
    lc = left_c[feature, tbin] + torch.where(is_l, nan_c[feature], zero)
    ltc = left_tc[feature, tbin] + torch.where(is_l, nan_tc[feature], zero)
    rg, rh, rc = sum_grad - lg, sum_hess - lh, sum_count - lc
    rtc = sum_total_count - ltc

    is_valid = torch.isfinite(best_gain) & (best_gain > 0.0)
    default_left = torch.where(
        is_nan_missing[feature], is_l,
        (meta.missing_type[feature] == MissingType.ZERO)
        & (meta.zero_bin[feature] <= tbin))
    out_left = bounded_output(lg, lh, lc)
    out_right = bounded_output(rg, rh, rc)
    neg_one = torch.full((), -1.0, dtype=torch.float32, device=dev)
    return torch.stack([
        torch.where(is_valid, best_gain, _NEG_INF),
        torch.where(is_valid, feature.float(), neg_one),
        tbin.float(), default_left.float(),
        lg, lh, lc, ltc, out_left, rg, rh, rc, rtc, out_right])
