"""Feature quantization (BinMapper) for lightgbm_tpu_torch.

Host-side NumPy port of ``lightgbm_tpu/io/binning.py`` (reference:
include/LightGBM/bin.h:61 ``BinMapper``; src/io/bin.cpp:78
``GreedyFindBin``, :256 ``FindBinWithZeroAsOneBin``, :336
``BinMapper::FindBin``, bin.h:492 ``ValueToBin``). Binning runs once at
load time on the host; the resulting uint8 bin matrix (uint16 past 256
bins) is what lives in device memory.

The greedy bin search gives the reference's loop's bounds, each bin
closing found by a binary search instead of a step per distinct value;
the reference dispatches columns with more than 512 distinct values to
a native ``GreedyFindBin``, which its own tests hold bit-identical to
its loop.
``value_to_bin`` is one ``torch.searchsorted`` per column (NumPy's
comparisons, on every core). A categorical
feature maps its category values to bins sorted by count (bin.cpp:424;
bin 0 holds NaN, negative and rare or unseen values).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..obs.registry import scoped as _scoped

# reference: include/LightGBM/meta.h:56
kZeroThreshold = 1e-35
# reference: include/LightGBM/bin.h:39
kSparseThreshold = 0.7


class MissingType:
    NONE = 0
    ZERO = 1
    NAN = 2

    _NAMES = {0: "none", 1: "zero", 2: "nan"}

    @staticmethod
    def name(v: int) -> str:
        return MissingType._NAMES[v]


class BinType:
    NUMERICAL = 0
    CATEGORICAL = 1


def _next_after_up(a: np.ndarray | float):
    """Common::GetDoubleUpperBound (reference: utils/common.h:850)."""
    return np.nextafter(a, np.inf)


def _greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                     max_bin: int, total_cnt: int,
                     min_data_in_bin: int) -> List[float]:
    """Greedy equal-count bin boundary search
    (reference: src/io/bin.cpp:78-152): the reference's loop over
    distinct values, its bin closings found by binary search over the
    counts' prefix sums (a search per bin instead of a Python step per
    distinct value)."""
    assert max_bin > 0
    num_distinct = len(distinct_values)
    bin_upper_bound: List[float] = []
    if num_distinct <= max_bin:
        cur_cnt_inbin = 0
        for i in range(num_distinct - 1):
            cur_cnt_inbin += int(counts[i])
            if cur_cnt_inbin >= min_data_in_bin:
                val = _next_after_up((distinct_values[i] + distinct_values[i + 1]) / 2.0)
                if not bin_upper_bound or val > _next_after_up(bin_upper_bound[-1]):
                    bin_upper_bound.append(float(val))
                    cur_cnt_inbin = 0
        bin_upper_bound.append(math.inf)
        return bin_upper_bound

    if min_data_in_bin > 0:
        max_bin = min(max_bin, int(total_cnt // min_data_in_bin))
        max_bin = max(max_bin, 1)
    mean_bin_size = total_cnt / max_bin

    # values with count >= mean get a dedicated bin (bin.cpp:105-116)
    is_big = counts >= mean_bin_size
    rest_bin_cnt = max_bin - int(is_big.sum())
    rest_sample_cnt = int(total_cnt - counts[is_big].sum())
    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)

    upper_bounds = [math.inf] * max_bin
    lower_bounds = [math.inf] * max_bin
    bin_cnt = 0
    lower_bounds[0] = float(distinct_values[0])
    # The reference walks every distinct value i, adding its count to the
    # open bin, and closes the bin at i when i is big, when the bin holds
    # mean_bin_size or more, or when i + 1 is big and the bin holds half
    # of it (at least 1). Only the closings change state, so each one is
    # found directly: with the counts' prefix sums ``csum`` and the open
    # bin starting after ``base = csum[start - 1]``, "the bin holds m or
    # more" is ``csum[i] >= base + ceil(m)`` (integer counts), the first
    # such i a binary search. The rest counts at a closing are the
    # non-big counts' prefix sum there. The same closings as the loop.
    csum = np.cumsum(np.asarray(counts, dtype=np.int64))
    rest_before = np.cumsum(np.where(is_big, 0, np.asarray(counts,
                                                          dtype=np.int64)))
    rest0 = rest_sample_cnt
    last = num_distinct - 2
    big_at = np.flatnonzero(is_big[:last + 1])
    big_next = np.flatnonzero(is_big[1:last + 2])
    start, base = 0, 0

    def first_at_least(thr: int) -> int:
        return max(start, int(np.searchsorted(csum, base + thr)))

    def first_of(cands: np.ndarray, lo: int) -> int:
        k = int(np.searchsorted(cands, lo))
        return int(cands[k]) if k < len(cands) else last + 1

    while start <= last:
        i = min(first_of(big_at, start),
                first_at_least(math.ceil(mean_bin_size)),
                first_of(big_next, first_at_least(
                    math.ceil(max(1.0, mean_bin_size * 0.5)))))
        if i > last:
            break
        upper_bounds[bin_cnt] = float(distinct_values[i])
        bin_cnt += 1
        lower_bounds[bin_cnt] = float(distinct_values[i + 1])
        if bin_cnt >= max_bin - 1:
            break
        if not is_big[i]:
            rest_bin_cnt -= 1
            mean_bin_size = (rest0 - int(rest_before[i])) / max(rest_bin_cnt,
                                                                1)
        base, start = int(csum[i]), i + 1
    bin_cnt += 1
    for i in range(bin_cnt - 1):
        val = _next_after_up((upper_bounds[i] + lower_bounds[i + 1]) / 2.0)
        if not bin_upper_bound or val > _next_after_up(bin_upper_bound[-1]):
            bin_upper_bound.append(float(val))
    bin_upper_bound.append(math.inf)
    return bin_upper_bound


def _find_bin_zero_as_one_bin(distinct_values: np.ndarray, counts: np.ndarray,
                              max_bin: int, total_sample_cnt: int,
                              min_data_in_bin: int) -> List[float]:
    """Split negative / zero / positive value ranges so that zero sits in its
    own bin (reference: src/io/bin.cpp:256-310 FindBinWithZeroAsOneBin)."""
    num_distinct = len(distinct_values)
    left_cnt_data = int(counts[distinct_values <= -kZeroThreshold].sum())
    cnt_zero = int(counts[(distinct_values > -kZeroThreshold)
                          & (distinct_values <= kZeroThreshold)].sum())
    right_cnt_data = int(counts[distinct_values > kZeroThreshold].sum())

    nonneg = np.nonzero(distinct_values > -kZeroThreshold)[0]
    left_cnt = int(nonneg[0]) if len(nonneg) else num_distinct

    bin_upper_bound: List[float] = []
    if left_cnt > 0 and max_bin > 1:
        denom = max(total_sample_cnt - cnt_zero, 1)
        left_max_bin = int(left_cnt_data / denom * (max_bin - 1))
        left_max_bin = max(1, left_max_bin)
        bin_upper_bound = _greedy_find_bin(
            distinct_values[:left_cnt], counts[:left_cnt], left_max_bin,
            left_cnt_data, min_data_in_bin)
        if bin_upper_bound:
            bin_upper_bound[-1] = -kZeroThreshold

    pos = np.nonzero(distinct_values[left_cnt:] > kZeroThreshold)[0]
    right_start = int(pos[0]) + left_cnt if len(pos) else -1

    right_max_bin = max_bin - 1 - len(bin_upper_bound)
    if right_start >= 0 and right_max_bin > 0:
        right_bounds = _greedy_find_bin(
            distinct_values[right_start:], counts[right_start:],
            right_max_bin, right_cnt_data, min_data_in_bin)
        bin_upper_bound.append(kZeroThreshold)
        bin_upper_bound.extend(right_bounds)
    else:
        bin_upper_bound.append(math.inf)
    assert len(bin_upper_bound) <= max_bin
    return bin_upper_bound


def _find_bin_with_predefined(distinct_values: np.ndarray, counts: np.ndarray,
                              max_bin: int, total_sample_cnt: int,
                              min_data_in_bin: int,
                              forced_upper_bounds: List[float]) -> List[float]:
    """Binning with user-forced boundaries
    (reference: src/io/bin.cpp:155-254 FindBinWithPredefinedBin)."""
    num_distinct = len(distinct_values)
    bin_upper_bound: List[float] = []
    nonneg = np.nonzero(distinct_values > -kZeroThreshold)[0]
    left_cnt = int(nonneg[0]) if len(nonneg) else num_distinct
    pos = np.nonzero(distinct_values[left_cnt:] > kZeroThreshold)[0]
    right_start = int(pos[0]) + left_cnt if len(pos) else -1

    if max_bin == 2:
        bin_upper_bound.append(kZeroThreshold if left_cnt == 0 else -kZeroThreshold)
    elif max_bin >= 3:
        if left_cnt > 0:
            bin_upper_bound.append(-kZeroThreshold)
        if right_start >= 0:
            bin_upper_bound.append(kZeroThreshold)
    bin_upper_bound.append(math.inf)

    max_to_insert = max_bin - len(bin_upper_bound)
    num_inserted = 0
    for ub in forced_upper_bounds:
        if num_inserted >= max_to_insert:
            break
        if abs(ub) > kZeroThreshold:
            bin_upper_bound.append(float(ub))
            num_inserted += 1
    bin_upper_bound.sort()

    free_bins = max_bin - len(bin_upper_bound)
    bounds_to_add: List[float] = []
    value_ind = 0
    n_fixed = len(bin_upper_bound)
    for i, ub in enumerate(bin_upper_bound):
        cnt_in_bin = 0
        bin_start = value_ind
        while value_ind < num_distinct and distinct_values[value_ind] < ub:
            cnt_in_bin += int(counts[value_ind])
            value_ind += 1
        bins_remaining = max_bin - n_fixed - len(bounds_to_add)
        num_sub_bins = int(round(cnt_in_bin * free_bins / max(total_sample_cnt, 1)))
        num_sub_bins = min(num_sub_bins, bins_remaining) + 1
        if i == n_fixed - 1:
            num_sub_bins = bins_remaining + 1
        if value_ind > bin_start:
            new_bounds = _greedy_find_bin(
                distinct_values[bin_start:value_ind], counts[bin_start:value_ind],
                num_sub_bins, cnt_in_bin, min_data_in_bin)
            bounds_to_add.extend(new_bounds[:-1])  # last bound is inf
    bin_upper_bound.extend(bounds_to_add)
    bin_upper_bound.sort()
    assert len(bin_upper_bound) <= max_bin
    return bin_upper_bound


def _need_filter(cnt_in_bin: List[int], total_cnt: int, filter_cnt: int,
                 bin_type: int) -> bool:
    """reference: src/io/bin.cpp:55-76 NeedFilter."""
    if bin_type == BinType.NUMERICAL:
        sum_left = 0
        for i in range(len(cnt_in_bin) - 1):
            sum_left += cnt_in_bin[i]
            if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                return False
        return True
    if len(cnt_in_bin) <= 2:
        for i in range(len(cnt_in_bin) - 1):
            if cnt_in_bin[i] >= filter_cnt and total_cnt - cnt_in_bin[i] >= filter_cnt:
                return False
        return True
    return False


class BinMapper:
    """Per-feature value→bin quantizer (reference: include/LightGBM/bin.h:61)."""

    def __init__(self) -> None:
        self.num_bin: int = 1
        self.missing_type: int = MissingType.NONE
        self.is_trivial: bool = True
        self.sparse_rate: float = 1.0
        self.bin_type: int = BinType.NUMERICAL
        self.bin_upper_bound: np.ndarray = np.array([math.inf])
        self.bin_2_categorical: List[int] = []
        self.categorical_2_bin: Dict[int, int] = {}
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0
        self.most_freq_bin: int = 0

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-safe fields (the reference's ``to_dict``): upper bounds
        as floats, categorical keys as strings."""
        return {
            "num_bin": int(self.num_bin),
            "missing_type": int(self.missing_type),
            "is_trivial": bool(self.is_trivial),
            "sparse_rate": float(self.sparse_rate),
            "bin_type": int(self.bin_type),
            "bin_upper_bound": [float(v) for v in self.bin_upper_bound],
            "bin_2_categorical": [int(v) for v in self.bin_2_categorical],
            "categorical_2_bin": {str(k): int(v) for k, v
                                  in self.categorical_2_bin.items()},
            "min_val": float(self.min_val),
            "max_val": float(self.max_val),
            "default_bin": int(self.default_bin),
            "most_freq_bin": int(self.most_freq_bin),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BinMapper":
        """Inverse of :meth:`to_dict`; the categorical keys are optional
        (a numerical mapper's dict may leave them out)."""
        m = cls()
        m.num_bin = int(d["num_bin"])
        m.missing_type = int(d["missing_type"])
        m.is_trivial = bool(d["is_trivial"])
        m.sparse_rate = float(d["sparse_rate"])
        m.bin_type = int(d["bin_type"])
        m.bin_upper_bound = np.asarray(d["bin_upper_bound"],
                                       dtype=np.float64)
        m.bin_2_categorical = [int(v) for v in d.get("bin_2_categorical",
                                                     [])]
        m.categorical_2_bin = {int(k): int(v) for k, v
                               in d.get("categorical_2_bin", {}).items()}
        m.min_val = float(d["min_val"])
        m.max_val = float(d["max_val"])
        m.default_bin = int(d["default_bin"])
        m.most_freq_bin = int(d["most_freq_bin"])
        return m

    # ------------------------------------------------------------------
    @_scoped("io::find_bin")
    def find_bin(self, sample_values: np.ndarray, total_sample_cnt: int,
                 max_bin: int, min_data_in_bin: int = 3,
                 min_split_data: int = 20, pre_filter: bool = False,
                 bin_type: int = BinType.NUMERICAL, use_missing: bool = True,
                 zero_as_missing: bool = False,
                 forced_upper_bounds: Optional[List[float]] = None) -> None:
        """Build bin boundaries from a sampled column
        (reference: src/io/bin.cpp:336 BinMapper::FindBin).

        ``sample_values`` is the full sampled column *including* zeros and NaNs
        (the reference receives non-zero values plus a zero count; equivalent).
        ``total_sample_cnt`` may exceed ``len(sample_values)`` when the caller
        pre-dropped zeros (sparse input).
        """
        values = np.asarray(sample_values, dtype=np.float64)
        na_mask = np.isnan(values)
        na_cnt = int(na_mask.sum())
        values = values[~na_mask]

        if not use_missing:
            self.missing_type = MissingType.NONE
        elif zero_as_missing:
            self.missing_type = MissingType.ZERO
        else:
            self.missing_type = MissingType.NAN if na_cnt > 0 else MissingType.NONE
        if self.missing_type != MissingType.NAN:
            # NaN samples count as zeros when not tracked as missing
            # (reference: bin.cpp:356-366 — na_cnt stays 0, so
            # zero_cnt = total - non_na absorbs them)
            na_cnt = 0

        zero_mask = np.abs(values) <= kZeroThreshold
        zero_cnt = int(zero_mask.sum()) + int(
            total_sample_cnt - len(sample_values)) + (int(na_mask.sum()) - na_cnt)
        nonzero = values[~zero_mask]

        self.bin_type = bin_type
        self.default_bin = 0

        # distinct values with zero spliced into sorted position
        # (reference: bin.cpp:371-407)
        if len(nonzero):
            distinct, counts = np.unique(nonzero, return_counts=True)
        else:
            distinct = np.empty(0)
            counts = np.empty(0, dtype=np.int64)
        if zero_cnt > 0 or len(distinct) == 0:
            pos = int(np.searchsorted(distinct, 0.0))
            distinct = np.insert(distinct, pos, 0.0)
            counts = np.insert(counts, pos, zero_cnt)
        self.min_val = float(distinct[0])
        self.max_val = float(distinct[-1])
        counts = counts.astype(np.int64)

        def _find(max_b: int, total: int) -> List[float]:
            # dispatch on forced bounds (reference: bin.cpp:312-322)
            if forced_upper_bounds:
                return _find_bin_with_predefined(
                    distinct, counts, max_b, total, min_data_in_bin,
                    list(forced_upper_bounds))
            return _find_bin_zero_as_one_bin(
                distinct, counts, max_b, total, min_data_in_bin)

        cnt_in_bin: List[int] = []
        if bin_type == BinType.NUMERICAL:
            if self.missing_type == MissingType.NAN:
                bounds = _find(max_bin - 1, total_sample_cnt - na_cnt)
                bounds.append(math.nan)
            else:
                bounds = _find(max_bin, total_sample_cnt)
                if self.missing_type == MissingType.ZERO and len(bounds) == 2:
                    self.missing_type = MissingType.NONE
            self.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
            self.num_bin = len(bounds)
            # count per bin (bin.cpp:409-422)
            n_search = self.num_bin - (1 if self.missing_type == MissingType.NAN else 0)
            idx = np.searchsorted(self.bin_upper_bound[:max(n_search - 1, 0)],
                                  distinct, side="left")
            cnt_arr = np.zeros(self.num_bin, dtype=np.int64)
            np.add.at(cnt_arr, idx, counts)
            if self.missing_type == MissingType.NAN:
                cnt_arr[self.num_bin - 1] = na_cnt
            cnt_in_bin = cnt_arr.tolist()
        else:
            cnt_in_bin = self._find_bin_categorical(
                distinct, counts, max_bin, total_sample_cnt, na_cnt,
                min_data_in_bin)

        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and pre_filter and _need_filter(
                cnt_in_bin, total_sample_cnt, min_split_data, bin_type):
            self.is_trivial = True

        if not self.is_trivial:
            self.default_bin = int(self.value_to_bin(0.0))
            self.most_freq_bin = int(np.argmax(cnt_in_bin))
            max_sparse_rate = cnt_in_bin[self.most_freq_bin] / max(total_sample_cnt, 1)
            if self.most_freq_bin != self.default_bin and max_sparse_rate < kSparseThreshold:
                self.most_freq_bin = self.default_bin
            self.sparse_rate = cnt_in_bin[self.most_freq_bin] / max(total_sample_cnt, 1)
        else:
            self.sparse_rate = 1.0

    # ------------------------------------------------------------------
    def _find_bin_categorical(self, distinct: np.ndarray,
                              counts: np.ndarray, max_bin: int,
                              total_sample_cnt: int, na_cnt: int,
                              min_data_in_bin: int) -> List[int]:
        """The categorical branch of FindBin (reference:
        src/io/bin.cpp:424-491): integer categories sorted by count
        (ties by value), kept until 99% of the non-NaN sample is covered
        and while they hold ``min_data_in_bin`` rows; bin 0 holds NaN,
        negative and dropped values. Returns the count per bin."""
        vals_int: List[int] = []
        cnts_int: List[int] = []
        for v, c in zip(distinct, counts):
            iv = int(v)
            if iv < 0:
                na_cnt += int(c)
                continue
            if vals_int and iv == vals_int[-1]:
                cnts_int[-1] += int(c)
            else:
                vals_int.append(iv)
                cnts_int.append(int(c))
        self.bin_2_categorical = [-1]
        self.categorical_2_bin = {-1: 0}
        cnt_in_bin = [0]
        self.num_bin = 1
        rest_cnt = total_sample_cnt - na_cnt
        if rest_cnt <= 0 or not vals_int:
            return cnt_in_bin
        order = np.argsort(-np.asarray(cnts_int), kind="stable")
        cut_cnt = int(round((total_sample_cnt - na_cnt) * 0.99))
        distinct_cnt = len(vals_int) + (1 if na_cnt > 0 else 0)
        max_bin = min(distinct_cnt, max_bin)
        used_cnt = 0
        cur = 0
        while cur < len(order) and (used_cnt < cut_cnt
                                    or self.num_bin < max_bin):
            i = int(order[cur])
            if cnts_int[i] < min_data_in_bin and cur > 1:
                break
            self.bin_2_categorical.append(vals_int[i])
            self.categorical_2_bin[vals_int[i]] = self.num_bin
            used_cnt += cnts_int[i]
            cnt_in_bin.append(cnts_int[i])
            self.num_bin += 1
            cur += 1
        if cur == len(order) and na_cnt == 0:
            self.missing_type = MissingType.NONE
        else:
            self.missing_type = MissingType.NAN
        cnt_in_bin[0] = total_sample_cnt - used_cnt
        return cnt_in_bin

    # ------------------------------------------------------------------
    def value_to_bin(self, value) -> np.ndarray:
        """Vectorized ValueToBin (reference: include/LightGBM/bin.h:492).
        A categorical value maps through ``categorical_2_bin`` (its
        integer part); NaN, negative and unseen values go to bin 0."""
        v = np.atleast_1d(np.asarray(value))
        scalar = np.ndim(value) == 0
        if self.bin_type == BinType.CATEGORICAL:
            out = self._categorical_to_bin(v.astype(np.float64))
            return out[0] if scalar else out
        # torch's searchsorted: the same comparisons in f64 as NumPy's,
        # on every core of the host (a column's f32 values widen
        # exactly)
        if not (v.dtype in (np.float32, np.float64) and v.flags.writeable
                and all(st > 0 for st in v.strides)):
            v = np.array(v, dtype=np.float64)
        t = torch.from_numpy(v).to(torch.float64).contiguous()
        nan_mask = torch.isnan(t)
        if self.missing_type != MissingType.NAN:
            t = t.masked_fill(nan_mask, 0.0)
        n_search = self.num_bin - (1 if self.missing_type == MissingType.NAN else 0)
        bounds = torch.from_numpy(np.ascontiguousarray(
            self.bin_upper_bound[:max(n_search - 1, 0)], dtype=np.float64))
        out = torch.searchsorted(bounds, t, side="left").to(torch.int32)
        if self.missing_type == MissingType.NAN:
            out.masked_fill_(nan_mask, self.num_bin - 1)
        out = out.numpy()
        return out[0] if scalar else out

    def _categorical_to_bin(self, v: np.ndarray) -> np.ndarray:
        iv = np.where(np.isnan(v), -1, v).astype(np.int64)
        cats = np.array(sorted(c for c in self.categorical_2_bin if c >= 0),
                        dtype=np.int64)
        if len(cats) == 0:
            return np.zeros(len(iv), dtype=np.int32)
        bins_for_cats = np.array(
            [self.categorical_2_bin[int(c)] for c in cats], dtype=np.int32)
        pos = np.searchsorted(cats, iv)
        pos_clip = np.clip(pos, 0, len(cats) - 1)
        hit = (pos < len(cats)) & (cats[pos_clip] == iv) & (iv >= 0)
        return np.where(hit, bins_for_cats[pos_clip], 0).astype(np.int32)

    def bin_to_value(self, bin_idx: int) -> float:
        """Upper bound of a bin — the real-valued threshold stored in trees
        (reference: include/LightGBM/bin.h:115 BinToValue); the category
        value of a categorical bin."""
        if self.bin_type == BinType.CATEGORICAL:
            return float(self.bin_2_categorical[bin_idx])
        return float(self.bin_upper_bound[bin_idx])

    def feature_info(self) -> str:
        """String for the model file 'feature_infos' section
        (reference: src/io/dataset.cpp DumpModel feature_infos format)."""
        if self.is_trivial:
            return "none"
        if self.bin_type == BinType.CATEGORICAL:
            return ":".join(str(c) for c in self.bin_2_categorical[1:])
        return f"[{self.min_val}:{self.max_val}]"
