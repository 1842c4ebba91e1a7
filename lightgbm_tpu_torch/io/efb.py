"""Exclusive Feature Bundling (EFB): mostly-zero features share a column.

Port of ``lightgbm_tpu/io/efb.py`` (reference: ``Dataset::FindGroups``,
src/io/dataset.cpp:107-200, greedy conflict-aware grouping;
``FeatureGroup``, include/LightGBM/feature_group.h:25, bin-offset
packing). Mutually (almost) exclusive sparse features share one bin
column: bundle bin 0 means "every member at its zero bin", and member
j's other bins occupy a contiguous sub-range in its own bin order.

The learner histograms the [N, G] bundled matrix with the same kernel as
an unbundled one and unpacks the [G, Bg] bundle histogram into
per-feature [F, B] histograms by a static gather
(``ops/histogram.py::unpack_bundle_histogram``); a member's zero-bin
row is rebuilt as the leaf total minus its other bins (exclusivity: a
row under another member's bin is a zero row of this one; the
reference's FixHistogram does the same).

Only numerical features without a NaN bin are bundled; categorical and
NaN-carrying features keep their own columns (single-member groups use
identity tables, so the learner has one code path).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np


class BundleLayout(NamedTuple):
    """Static description of the bundled bin matrix.

    For every bundle column g, ``member[g, b]`` is the used-feature index
    owning bundle bin b (-1 for bin 0 of a multi-member bundle and for
    padding), and ``unmap[g, b]`` the original bin id of that feature.
    For single-member groups these are identity-like (member = the
    feature for every bin, unmap = b). ``needs_zero_fix[f]`` marks
    features living in multi-member bundles: their zero-bin histogram row
    must be reconstructed as total − Σ(others).
    """
    groups: List[List[int]]          # used-feature indices per bundle
    group_of: np.ndarray             # [F] i32 bundle column per feature
    member: np.ndarray               # [G, Bg] i32
    unmap: np.ndarray                # [G, Bg] i32
    needs_zero_fix: np.ndarray       # [F] bool
    # per-feature gather table into the bundle histogram:
    gidx_g: np.ndarray               # [F, B] i32 bundle column (or -1)
    gidx_b: np.ndarray               # [F, B] i32 bundle bin (or 0)
    num_bundled_bins: int            # Bg

    @property
    def num_groups(self) -> int:
        return len(self.groups)


def find_groups(nonzero_masks: List[Optional[np.ndarray]],
                num_bins: np.ndarray,
                sample_cnt: int,
                max_bundle_bins: int,
                max_conflict_rate: float = 1e-4) -> List[List[int]]:
    """Greedy conflict-aware bundling over sampled non-zero masks
    (reference: Dataset::FindGroups, src/io/dataset.cpp:107: features
    sorted by non-zero count, each placed into the first group whose
    accumulated conflict count stays under the budget).

    ``nonzero_masks[f]`` is a bool[sample_cnt] mask of sampled rows where
    feature f is away from its zero bin, or None if the feature must not
    be bundled (dense/categorical/NaN) — those get singleton groups.
    """
    F = len(nonzero_masks)
    max_conflict = int(max_conflict_rate * sample_cnt)
    candidates = [f for f in range(F) if nonzero_masks[f] is not None]
    # densest first, like the reference's sorted-by-cnt order
    candidates.sort(key=lambda f: -int(nonzero_masks[f].sum()))

    groups: List[List[int]] = []
    group_mask: List[np.ndarray] = []     # union of member non-zero rows
    group_conflicts: List[int] = []
    group_bins: List[int] = []            # 1 (shared zero) + Σ (b_f - 1)
    for f in candidates:
        mask = nonzero_masks[f]
        extra_bins = int(num_bins[f]) - 1
        placed = False
        for gi in range(len(groups)):
            if group_bins[gi] + extra_bins > max_bundle_bins:
                continue
            conflicts = int((group_mask[gi] & mask).sum())
            if group_conflicts[gi] + conflicts <= max_conflict:
                groups[gi].append(f)
                group_mask[gi] |= mask
                group_conflicts[gi] += conflicts
                group_bins[gi] += extra_bins
                placed = True
                break
        if not placed:
            groups.append([f])
            group_mask.append(mask.copy())
            group_conflicts.append(0)
            group_bins.append(1 + extra_bins)
    # non-candidates keep their own columns
    for f in range(F):
        if nonzero_masks[f] is None:
            groups.append([f])
    return groups


def build_layout(groups: List[List[int]], num_bins: np.ndarray,
                 zero_bins: np.ndarray, max_num_bin: int) -> BundleLayout:
    """Assign bundle bin ranges and build the member/unmap/gather
    tables (reference: FeatureGroup bin offsets,
    include/LightGBM/feature_group.h:25)."""
    F = len(num_bins)
    G = len(groups)
    group_of = np.zeros(F, dtype=np.int32)
    needs_zero_fix = np.zeros(F, dtype=bool)
    # width of the bundled matrix's bin axis
    widths = []
    for g, members in enumerate(groups):
        if len(members) == 1:
            widths.append(int(num_bins[members[0]]))
        else:
            widths.append(1 + int(sum(num_bins[f] - 1 for f in members)))
    Bg = max(max(widths), 2)
    member = np.full((G, Bg), -1, dtype=np.int32)
    unmap = np.zeros((G, Bg), dtype=np.int32)
    gidx_g = np.full((F, max_num_bin), -1, dtype=np.int32)
    gidx_b = np.zeros((F, max_num_bin), dtype=np.int32)
    for g, members in enumerate(groups):
        if len(members) == 1:
            f = members[0]
            group_of[f] = g
            b = int(num_bins[f])
            member[g, :b] = f
            unmap[g, :b] = np.arange(b)
            gidx_g[f, :b] = g
            gidx_b[f, :b] = np.arange(b)
            continue
        offset = 1
        for f in members:
            group_of[f] = g
            needs_zero_fix[f] = True
            zb = int(zero_bins[f])
            nonzero = [t for t in range(int(num_bins[f])) if t != zb]
            for k, t in enumerate(nonzero):
                member[g, offset + k] = f
                unmap[g, offset + k] = t
                gidx_g[f, t] = g
                gidx_b[f, t] = offset + k
            offset += len(nonzero)
    return BundleLayout(groups=groups, group_of=group_of, member=member,
                        unmap=unmap, needs_zero_fix=needs_zero_fix,
                        gidx_g=gidx_g, gidx_b=gidx_b,
                        num_bundled_bins=Bg)


def bundle_columns(per_feature_bin_cols, layout: BundleLayout,
                   zero_bins: np.ndarray, n: int,
                   dtype) -> np.ndarray:
    """Pack per-feature bin columns into the bundled [N, G] matrix.
    ``per_feature_bin_cols(f)`` yields the full bin column of used
    feature f. Conflict rows (two members non-zero) keep the later
    member's value, matching the reference's last-write-wins push."""
    G = layout.num_groups
    out = np.zeros((n, G), dtype=dtype)
    for g, members in enumerate(layout.groups):
        if len(members) == 1:
            out[:, g] = per_feature_bin_cols(members[0])
            continue
        col = np.zeros(n, dtype=np.int64)
        offset = 1
        for f in members:
            fb = per_feature_bin_cols(f).astype(np.int64)
            zb = int(zero_bins[f])
            # map original bin t (≠ zero_bin) to its bundle slot
            slot = np.where(fb < zb, fb, fb - 1)
            nz = fb != zb
            col = np.where(nz, offset + slot, col)
            offset += int(np.sum(layout.member[g] == f))
        out[:, g] = col.astype(dtype)
    return out
