"""The intermediate and advanced monotone-constraint methods: host-side
bound tracking.

Port of ``lightgbm_tpu/treelearner/monotone.py`` (upstream
``IntermediateLeafConstraints`` and ``AdvancedLeafConstraints``,
src/treelearner/monotone_constraints.hpp:508-1184), plain NumPy over
the host ``Tree``:

- intermediate: per-leaf (min, max) output bounds, tightened with the
  actual sibling outputs instead of the mid-point of ``basic``, and
  propagated to every leaf that is value-contiguous with the new
  children (the walk up from the split node and down the opposite
  branches); each touched leaf's candidate is then scanned again on the
  device from its stored histogram
  (``SerialTreeLearner._mono_rescan``);
- advanced: per-(leaf, feature) dense [B] bound arrays over the
  feature's bins instead of one leaf-wide pair, updated flat and
  rebuilt lazily from the tree when dirty; the device scan clamps each
  threshold by their running extrema (``find_best_split``'s
  ``bound_arrays``).

The walks are O(num_leaves) pointer chasing over the host tree, so they
stay in Python; only the scans run on the device.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..models.tree import Tree, kCategoricalMask

_INF = float("inf")


class IntermediateMonotoneTracker:
    """Host mirror of per-leaf output bounds + the contiguity walk."""

    def __init__(self, num_leaves: int, monotone_inner: np.ndarray):
        self.L = num_leaves
        self.mono = np.asarray(monotone_inner, dtype=np.int8)
        self.reset()

    def reset(self) -> None:
        self.entries: List[Tuple[float, float]] = \
            [(-_INF, _INF) for _ in range(self.L)]
        self.in_mono_subtree = [False] * self.L
        # node_parent_[node] — parent internal node of each internal node
        self.node_parent = [-1] * max(self.L - 1, 1)

    # ------------------------------------------------------------------
    def before_split(self, tree: Tree, leaf: int, mono_type: int) -> None:
        """reference: IntermediateLeafConstraints::BeforeSplit
        (monotone_constraints.hpp:530) — must run BEFORE the split is
        applied to the host tree (it records the pre-split leaf parent
        as the new node's parent)."""
        new_leaf = tree.num_leaves
        new_node = tree.num_leaves - 1
        if mono_type != 0 or self.in_mono_subtree[leaf]:
            self.in_mono_subtree[leaf] = True
            self.in_mono_subtree[new_leaf] = True
        self.node_parent[new_node] = int(tree.leaf_parent[leaf])

    def child_bounds(self, leaf: int, mono_type: int,
                     left_output: float, right_output: float
                     ) -> Tuple[float, float, float, float]:
        """Bounds the two children inherit + the entry updates
        (reference: UpdateConstraintsWithOutputs,
        monotone_constraints.hpp:543 — sibling outputs, not mid-points).
        Returns (lmin, lmax, rmin, rmax)."""
        pmin, pmax = self.entries[leaf]
        lmin, lmax = pmin, pmax
        rmin, rmax = pmin, pmax
        if mono_type < 0:
            lmin = max(lmin, right_output)   # left ≥ right for decreasing
            rmax = min(rmax, left_output)
        elif mono_type > 0:
            lmax = min(lmax, right_output)
            rmin = max(rmin, left_output)
        return lmin, lmax, rmin, rmax

    def apply_split(self, tree: Tree, leaf: int, new_leaf: int,
                    bounds: Tuple[float, float, float, float]) -> None:
        self.entries[leaf] = (bounds[0], bounds[1])
        self.entries[new_leaf] = (bounds[2], bounds[3])

    # ------------------------------------------------------------------
    def _update_leaf_bound(self, leaf: int, update_max: bool,
                           lo: float, hi: float, out: List[int]) -> None:
        """UpdateMin/MaxAndReturnBoolIfChanged
        (monotone_constraints.hpp:74-88); the advanced tracker overrides
        this with mark-dirty semantics."""
        emin, emax = self.entries[leaf]
        if update_max:
            if lo < emax:
                self.entries[leaf] = (emin, lo)
                out.append(leaf)
        else:
            if hi > emin:
                self.entries[leaf] = (hi, emax)
                out.append(leaf)

    # ------------------------------------------------------------------
    def leaves_to_update(self, tree: Tree, new_leaf: int,
                         split_feature_inner: int, split_threshold: int,
                         left_output: float, right_output: float,
                         is_numerical: bool,
                         leaf_has_candidate) -> List[int]:
        """The GoUp/GoDown walk (reference: GoUpToFindLeavesToUpdate /
        GoDownToFindLeavesToUpdate, monotone_constraints.hpp:620-805).
        ``leaf_has_candidate(leaf) -> bool`` mirrors the reference's
        ``best_split_per_leaf[leaf].gain == kMinScore`` skip. Updates
        ``self.entries`` in place; returns the leaves needing a device
        rescan."""
        out: List[int] = []
        if not self.in_mono_subtree[new_leaf]:
            return out
        feats_up: List[int] = []
        thr_up: List[int] = []
        was_right: List[bool] = []

        node = int(tree.leaf_parent[new_leaf])
        child_code = node  # start: the new split node (walk begins above)
        parent = self.node_parent[node] if node >= 0 else -1
        while parent != -1:
            inner = int(tree.split_feature_inner[parent])
            mono_type = int(self.mono[inner]) \
                if inner < len(self.mono) else 0
            is_right = int(tree.right_child[parent]) == child_code
            p_numerical = not (int(tree.decision_type[parent])
                               & kCategoricalMask)
            # OppositeChildShouldBeUpdated (monotone_constraints.hpp:589).
            # NOTE: the reference's comment claims categorical ancestors
            # should still be descended, but its code returns false for
            # them (the `else` branch); behavior parity follows the code.
            should = p_numerical and not any(
                f == inner and wr == is_right
                for f, wr in zip(feats_up, was_right))
            if should:
                if mono_type != 0:
                    left_c = int(tree.left_child[parent])
                    right_c = int(tree.right_child[parent])
                    curr_is_left = left_c == child_code
                    opposite = right_c if curr_is_left else left_c
                    update_max = (curr_is_left if mono_type < 0
                                  else not curr_is_left)
                    self._go_down(tree, opposite, feats_up, thr_up,
                                  was_right, update_max,
                                  split_feature_inner, split_threshold,
                                  left_output, right_output, True, True,
                                  is_numerical, leaf_has_candidate, out)
                was_right.append(is_right)
                thr_up.append(int(tree.threshold_in_bin[parent]))
                feats_up.append(inner)
            child_code = parent
            parent = self.node_parent[parent]
        return out

    def _go_down(self, tree: Tree, node: int, feats_up, thr_up, was_right,
                 update_max: bool, split_feature: int,
                 split_threshold: int, left_output: float,
                 right_output: float, use_left: bool, use_right: bool,
                 split_is_numerical: bool, leaf_has_candidate,
                 out: List[int]) -> None:
        if node < 0:
            leaf = ~node
            if not leaf_has_candidate(leaf):
                return
            if use_left and use_right:
                lo, hi = sorted((left_output, right_output))
            elif use_right:
                lo = hi = right_output
            else:
                lo = hi = left_output
            self._update_leaf_bound(leaf, update_max, lo, hi, out)
            return
        # ShouldKeepGoingLeftRight (monotone_constraints.hpp:806)
        inner = int(tree.split_feature_inner[node])
        thr = int(tree.threshold_in_bin[node])
        n_numerical = not (int(tree.decision_type[node])
                           & kCategoricalMask)
        keep_left = keep_right = True
        if n_numerical:
            for f, t, wr in zip(feats_up, thr_up, was_right):
                if f == inner:
                    if thr >= t and not wr:
                        keep_right = False
                    if thr <= t and wr:
                        keep_left = False
        use_left_for_right = True
        use_right_for_left = True
        if n_numerical and inner == split_feature and split_is_numerical:
            if thr >= split_threshold:
                use_left_for_right = False
            if thr <= split_threshold:
                use_right_for_left = False
        if keep_left:
            self._go_down(tree, int(tree.left_child[node]), feats_up,
                          thr_up, was_right, update_max, split_feature,
                          split_threshold, left_output, right_output,
                          use_left, use_right and use_right_for_left,
                          split_is_numerical, leaf_has_candidate, out)
        if keep_right:
            self._go_down(tree, int(tree.right_child[node]), feats_up,
                          thr_up, was_right, update_max, split_feature,
                          split_threshold, left_output, right_output,
                          use_left and use_left_for_right, use_right,
                          split_is_numerical, leaf_has_candidate, out)


class AdvancedMonotoneTracker(IntermediateMonotoneTracker):
    """monotone_constraints_method=advanced ("monotone precise mode").

    Equivalent of the reference's ``AdvancedLeafConstraints``
    (src/treelearner/monotone_constraints.hpp:856-1184): each leaf
    carries *per-feature, per-threshold* output constraints, so a
    candidate split is clamped only by the leaves actually contiguous
    with each child, not by a leaf-wide bound. The reference stores
    these as sorted (thresholds[], constraints[]) piece lists merged by
    ``UpdateConstraints`` (:870-968); here each (leaf, feature) holds a
    DENSE f32[B] array over the feature's bin axis — a range update is a
    vectorized ``np.maximum`` on a slice, piece bookkeeping disappears,
    and the arrays ship to the device split scan as-is
    (``find_best_split(bound_arrays=...)`` computes the running-extrema
    left/right clamps the reference keeps in
    ``CumulativeFeatureConstraint``).

    Laziness matches the reference: propagation
    (``UpdateMin/MaxAndReturnBoolIfChanged``) flat-updates the arrays and
    marks the touched side dirty for every feature; the dirty side is
    rebuilt from the tree on next use (``RecomputeConstraintsIfNeeded``,
    :375-430) by the up-then-down walk over constraining leaves
    (``GoUpToFindConstrainingLeaves`` / ``GoDown...``, :1027-1184).
    Reference quirk kept for parity: when BOTH sides are dirty only the
    min side is recomputed, and both flags clear (:385-393).
    """

    def __init__(self, num_leaves: int, monotone_inner: np.ndarray,
                 num_bin: np.ndarray, B: int):
        self.B = int(B)
        self.num_bin = np.asarray(num_bin, dtype=np.int64)
        super().__init__(num_leaves, monotone_inner)

    def reset(self) -> None:
        super().reset()
        Fp = len(self.mono)
        # dense per-(leaf, feature, bin) constraints; pads stay ±inf so
        # device-side reverse cumulative extrema are neutral there
        self.min_c = np.full((self.L, Fp, self.B), -_INF, dtype=np.float32)
        self.max_c = np.full((self.L, Fp, self.B), _INF, dtype=np.float32)
        self.min_dirty = np.zeros((self.L, Fp), dtype=bool)
        self.max_dirty = np.zeros((self.L, Fp), dtype=bool)
        # valid-bin mask per feature — flat updates must not disturb the
        # ±inf pads
        Fp_ = len(self.mono)
        cols = np.arange(self.B)[None, :]
        self._valid = cols < self.num_bin[:Fp_, None]        # [Fp, B]

    # -- entry ops (AdvancedConstraintEntry, monotone_constraints.hpp:375)
    def _flat_update_min(self, leaf: int, v: float) -> None:
        row = self.min_c[leaf]
        np.maximum(row, np.float32(v), out=row, where=self._valid)

    def _flat_update_max(self, leaf: int, v: float) -> None:
        row = self.max_c[leaf]
        np.minimum(row, np.float32(v), out=row, where=self._valid)

    def apply_split_outputs(self, leaf: int, new_leaf: int,
                            mono_type: int, left_output: float,
                            right_output: float,
                            is_numerical: bool) -> None:
        """UpdateConstraintsWithOutputs (monotone_constraints.hpp:543):
        clone the entry to the new leaf, then flat-tighten both with the
        actual sibling outputs."""
        self.min_c[new_leaf] = self.min_c[leaf]
        self.max_c[new_leaf] = self.max_c[leaf]
        self.min_dirty[new_leaf] = self.min_dirty[leaf]
        self.max_dirty[new_leaf] = self.max_dirty[leaf]
        if not is_numerical:
            return
        if mono_type < 0:
            self._flat_update_min(leaf, right_output)
            self._flat_update_max(new_leaf, left_output)
        elif mono_type > 0:
            self._flat_update_max(leaf, right_output)
            self._flat_update_min(new_leaf, left_output)

    def _update_leaf_bound(self, leaf: int, update_max: bool,
                           lo: float, hi: float, out: List[int]) -> None:
        """Advanced semantics (UpdateMin/MaxAndReturnBoolIfChanged,
        monotone_constraints.hpp:440-456): flat-update + mark the side
        dirty on every feature, and ALWAYS report the leaf as needing a
        rescan — even an unchanged flat bound may have been derived from
        a stale walk."""
        if update_max:
            self._flat_update_max(leaf, lo)
            self.max_dirty[leaf, :] = True
        else:
            self._flat_update_min(leaf, hi)
            self.min_dirty[leaf, :] = True
        out.append(leaf)

    # -- lazy recompute (RecomputeConstraintsIfNeeded, :375-430) -------
    def _recompute_if_needed(self, tree: Tree, leaf: int, f: int) -> None:
        if not (self.min_dirty[leaf, f] or self.max_dirty[leaf, f]):
            return
        min_update = bool(self.min_dirty[leaf, f])
        nb = int(self.num_bin[f]) if f < len(self.num_bin) else self.B
        if min_update:
            self.min_c[leaf, f, :nb] = -_INF
        else:
            self.max_c[leaf, f, :nb] = _INF
        self._go_up_constraining(tree, f, ~leaf, [], [], [],
                                 min_update, 0, nb, nb)
        self.min_dirty[leaf, f] = False
        self.max_dirty[leaf, f] = False

    def leaf_bound_arrays(self, tree: Tree, leaf: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """The [Fp, B] (min_c, max_c) pair for a leaf's split scan, with
        every numerical feature's dirty side rebuilt first (the
        reference recomputes per feature right before FindBestThreshold,
        serial_tree_learner.cpp:758-762)."""
        for f in range(len(self.mono)):
            self._recompute_if_needed(tree, leaf, f)
        return self.min_c[leaf], self.max_c[leaf]

    # -- the up-then-down constraining-leaf walk -----------------------
    def _range_update(self, f: int, min_update: bool, extremum: float,
                      it_start: int, it_end: int, node_leaf: int) -> None:
        """UpdateConstraints (monotone_constraints.hpp:870-968) on the
        dense row: the piece-list insertion/merge collapses to a slice
        extremum."""
        if it_start >= it_end:
            return
        if min_update:
            row = self.min_c[self._target_leaf, f, it_start:it_end]
            np.maximum(row, np.float32(extremum), out=row)
        else:
            row = self.max_c[self._target_leaf, f, it_start:it_end]
            np.minimum(row, np.float32(extremum), out=row)

    def _go_up_constraining(self, tree: Tree, f_c: int, node_idx: int,
                            feats_up: List[int], thr_up: List[int],
                            was_right: List[bool], min_update: bool,
                            it_start: int, it_end: int,
                            last_threshold: int) -> None:
        """GoUpToFindConstrainingLeaves (monotone_constraints.hpp:1083)."""
        if node_idx < 0:
            self._target_leaf = ~node_idx
            parent = int(tree.leaf_parent[~node_idx])
        else:
            parent = self.node_parent[node_idx]
        if parent == -1:
            return
        inner = int(tree.split_feature_inner[parent])
        mono_type = int(self.mono[inner]) if inner < len(self.mono) else 0
        is_right = int(tree.right_child[parent]) == node_idx
        is_numerical = not (int(tree.decision_type[parent])
                            & kCategoricalMask)
        threshold = int(tree.threshold_in_bin[parent])
        if f_c == inner and is_numerical:
            # note the reference's asymmetry: right child widens only to
            # `threshold`, not threshold+1 (monotone_constraints.hpp:1100)
            if is_right:
                it_start = max(threshold, it_start)
            else:
                it_end = min(threshold + 1, it_end)
        should = self._opposite_should_update(is_numerical, feats_up,
                                              inner, was_right, is_right)
        if should:
            if mono_type != 0:
                left_c = int(tree.left_child[parent])
                right_c = int(tree.right_child[parent])
                curr_is_left = left_c == node_idx
                update_min_in_curr = (curr_is_left if mono_type < 0
                                      else not curr_is_left)
                if update_min_in_curr == min_update:
                    opposite = right_c if curr_is_left else left_c
                    self._go_down_constraining(
                        tree, f_c, inner, opposite, min_update,
                        it_start, it_end, feats_up, thr_up, was_right,
                        last_threshold)
            was_right.append(is_right)
            thr_up.append(threshold)
            feats_up.append(inner)
        if parent != 0:
            self._go_up_constraining(tree, f_c, parent, feats_up, thr_up,
                                     was_right, min_update, it_start,
                                     it_end, last_threshold)

    @staticmethod
    def _opposite_should_update(is_numerical: bool, feats_up, inner,
                                was_right, is_right) -> bool:
        """OppositeChildShouldBeUpdated (monotone_constraints.hpp:589)."""
        if not is_numerical:
            return False
        return not any(f == inner and wr == is_right
                       for f, wr in zip(feats_up, was_right))

    def _go_down_constraining(self, tree: Tree, f_c: int,
                              root_mono_f: int, node: int,
                              min_update: bool, it_start: int,
                              it_end: int, feats_up, thr_up, was_right,
                              last_threshold: int) -> None:
        """GoDownToFindConstrainingLeaves (monotone_constraints.hpp:1000)."""
        if node < 0:
            extremum = float(tree.leaf_value[~node])
            self._range_update(f_c, min_update, extremum, it_start,
                               it_end, node)
            return
        inner = int(tree.split_feature_inner[node])
        threshold = int(tree.threshold_in_bin[node])
        n_numerical = not (int(tree.decision_type[node])
                           & kCategoricalMask)
        # ShouldKeepGoingLeftRight (monotone_constraints.hpp:806)
        keep_left = keep_right = True
        if n_numerical:
            for f, t, wr in zip(feats_up, thr_up, was_right):
                if f == inner:
                    if threshold >= t and not wr:
                        keep_right = False
                    if threshold <= t and wr:
                        keep_left = False
        split_is_inner = inner == f_c
        split_is_mono_root = root_mono_f == f_c
        # LeftRightContainsRelevantInformation (:975-998)
        contains_left = contains_right = True
        if not (split_is_inner and not split_is_mono_root):
            m = int(self.mono[inner]) if inner < len(self.mono) else 0
            if m != 0:
                if (m == -1 and min_update) or (m == 1 and not min_update):
                    contains_right = False
                else:
                    contains_left = False
        if keep_left and (contains_left or not keep_right):
            new_end = min(threshold + 1, it_end) if (split_is_inner
                                                     and n_numerical) \
                else it_end
            self._go_down_constraining(
                tree, f_c, root_mono_f, int(tree.left_child[node]),
                min_update, it_start, new_end, feats_up, thr_up,
                was_right, last_threshold)
        if keep_right and (contains_right or not keep_left):
            new_start = max(threshold + 1, it_start) if (split_is_inner
                                                         and n_numerical) \
                else it_start
            self._go_down_constraining(
                tree, f_c, root_mono_f, int(tree.right_child[node]),
                min_update, new_start, it_end, feats_up, thr_up,
                was_right, last_threshold)
