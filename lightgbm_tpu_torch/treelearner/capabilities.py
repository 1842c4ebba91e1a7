"""Column sampling, interaction constraints, CEGB, forced splits and the
monotone methods: the config-derived feature state of the learner.

Port of ``lightgbm_tpu/treelearner/capabilities.py`` without its
quantization part (which lives in ``serial.py``):

- per-tree column sampling (``feature_fraction``; upstream ColSampler,
  src/treelearner/col_sampler.hpp:20) and per-node sampling
  (``feature_fraction_bynode``) draw from ONE host RNG,
  ``np.random.RandomState(feature_fraction_seed)``: a tree's mask first,
  then two node masks per split, left child then right. The order of
  the draws is part of the contract with the reference;
- ``interaction_constraints`` (config.h:562): groups of features; a
  branch may only combine features that share a group (upstream
  ColSampler::SetUsedFeatureByNode). The tree mask keeps the union of
  the groups, a node mask the groups that hold its whole feature path;
- cost-effective gradient boosting (CEGB; upstream
  cost_effective_gradient_boosting.hpp): a per-feature gain penalty
  from the split, coupled and lazy costs. The used-feature vector and,
  in lazy mode, the per-(row, feature) fetched state persist across
  trees;
- ``forcedsplits_filename`` (config.h:518): a JSON tree of ``{"feature",
  "threshold", "left", "right"}`` nodes applied before best-gain growth;
- ``monotone_constraints_method=intermediate`` / ``advanced``: the
  loop :meth:`CapabilityMixin._grow_monotone` (reference
  ``train_monotone``) with the trackers of ``monotone.py``.

Which setting wins (the reference's order, each loser warned of once,
when the learner is made): CEGB over the intermediate and advanced
methods (monotone constraints then run in the basic method); those
methods over forced splits, interaction constraints and extra_trees
(the root is scanned greedily too); forced splits over per-node masks
(the whole-tree or per-split loop runs without them).

Per-node masks and CEGB depend on host state that changes with every
split (the feature path, the used and fetched features), so their trees
grow through the per-split loop (``SerialTreeLearner._grow_stepped``)
with one record read per split: that is the contract of these modes, in
the reference too (its ``train_stepwise`` and ``train_cegb``).
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from ..models.tree import Tree
from ..utils import log
from .monotone import AdvancedMonotoneTracker, IntermediateMonotoneTracker


class CapabilityMixin:
    """Config-derived feature state of the learner. Needs ``config``,
    ``dataset``, ``device``, ``F``, ``Fp``, ``N``, ``L``, ``B``,
    ``_extra_trees`` and ``_has_mono`` before
    :meth:`_init_capabilities`."""

    #: the voting learner keeps no per-leaf histogram store, so the
    #: rescans of the intermediate and advanced methods cannot run there
    _supports_intermediate = True

    def _init_capabilities(self, config) -> None:
        self._ff_rng = np.random.RandomState(config.feature_fraction_seed)
        self._resolve_constraints()
        self._forced = self._load_forced_splits(config)
        self._init_cegb(config)
        self._init_monotone(config)
        if (self._forced is not None and self._needs_per_node_masks()
                and not self._cegb_enabled and self._mono_tracker is None):
            log.warning("forced splits combined with per-node feature "
                        "masks run without the per-node masks")

    @staticmethod
    def _load_forced_splits(config):
        """The forced-split tree of ``forcedsplits_filename`` (JSON), or
        None; a file that cannot be read or parsed warns and forces
        nothing."""
        if not config.forcedsplits_filename:
            return None
        try:
            with open(config.forcedsplits_filename) as fh:
                return json.load(fh)
        except (OSError, ValueError) as e:
            log.warning("Cannot load forced splits from %s: %s"
                        % (config.forcedsplits_filename, e))
            return None

    def _resolve_constraints(self) -> None:
        """``interaction_constraints`` as groups of inner feature
        indices (columns the dataset does not use drop out; an empty
        group goes)."""
        ic = self.config.interaction_constraints
        if not ic:
            self._constraint_groups = None
            return
        groups = []
        for grp in ic:
            inner = set()
            for real_f in grp:
                j = self.dataset.inner_feature_index(int(real_f))
                if j >= 0:
                    inner.add(j)
            if inner:
                groups.append(frozenset(inner))
        self._constraint_groups = groups or None

    def _needs_per_node_masks(self) -> bool:
        return (self._constraint_groups is not None
                or 0.0 < float(self.config.feature_fraction_bynode) < 1.0)

    def _sample_features(self) -> np.ndarray:
        """The tree's bool [Fp] feature mask: ``k = max(1, round(F *
        feature_fraction))`` features drawn without replacement (one draw
        per tree, each class tree of an iteration too), ANDed with the
        union of the constraint groups."""
        ff = float(self.config.feature_fraction)
        mask = np.zeros(self.Fp, dtype=bool)
        mask[:self.F] = True
        if 0.0 < ff < 1.0:
            k = max(1, int(round(self.F * ff)))
            mask[:] = False
            mask[self._ff_rng.choice(self.F, k, replace=False)] = True
        if self._constraint_groups is not None:
            allowed = np.zeros(self.Fp, dtype=bool)
            for grp in self._constraint_groups:
                allowed[list(grp)] = True
            mask &= allowed
        return mask

    def _node_mask(self, tree_mask: torch.Tensor,
                   path_features: frozenset) -> torch.Tensor:
        """A child's bool [Fp] mask on the device: the tree mask, ANDed
        with the constraint groups that hold the child's whole feature
        path and with a ``feature_fraction_bynode`` draw."""
        mask = None
        if self._constraint_groups is not None:
            allowed = np.zeros(self.Fp, dtype=bool)
            for grp in self._constraint_groups:
                if path_features <= grp:
                    allowed[list(grp)] = True
            mask = allowed
        ffb = float(self.config.feature_fraction_bynode)
        if 0.0 < ffb < 1.0:
            n_real = self.dataset.num_features
            m2 = np.zeros(self.Fp, dtype=bool)
            k = max(1, int(round(n_real * ffb)))
            m2[self._ff_rng.choice(n_real, k, replace=False)] = True
            mask = m2 if mask is None else (mask & m2)
        if mask is None:
            return tree_mask
        return tree_mask & torch.from_numpy(mask).to(self.device)

    def _init_cegb(self, config) -> None:
        """CEGB setup (upstream CostEfficientGradientBoosting::IsEnable
        and Init, cost_effective_gradient_boosting.hpp:27-68): the
        per-feature penalty vectors in inner order, the used-feature
        vector and, in lazy mode, the fetched state, which persist
        across trees.

        ``fetched`` is bool [N, Fp] (the reference keeps f32): a row's
        unfetched count per feature is a sum of 0/1 over at most N <
        2^24 rows, an exact integer that converts to f32 exactly, so the
        penalties equal the reference's in a quarter of the memory."""
        coupled = list(config.cegb_penalty_feature_coupled or [])
        lazy = list(config.cegb_penalty_feature_lazy or [])
        self._cegb_enabled = (config.cegb_tradeoff < 1.0
                              or config.cegb_penalty_split > 0.0
                              or bool(coupled) or bool(lazy))
        if not self._cegb_enabled:
            return
        if config.extra_trees:
            log.warning("extra_trees is ignored when CEGB is enabled")
        if self._needs_per_node_masks() or self._forced is not None:
            log.warning("CEGB runs without forced splits / per-node "
                        "feature masks")
        n_total = self.dataset.num_total_features
        for name, vec in (("cegb_penalty_feature_coupled", coupled),
                          ("cegb_penalty_feature_lazy", lazy)):
            if vec and len(vec) != n_total:
                log.fatal("%s should be the same size as feature number "
                          "(%d vs %d)" % (name, len(vec), n_total))

        def to_inner(vec):
            out = np.zeros(self.Fp, dtype=np.float32)
            if vec:
                for j in range(self.dataset.num_features):
                    out[j] = vec[self.dataset.real_feature_index(j)]
            return torch.from_numpy(out).to(self.device)

        self._cegb_coupled = to_inner(coupled)
        self._cegb_lazy = to_inner(lazy)
        self._cegb_has_lazy = bool(lazy) and any(v != 0 for v in lazy)
        self._cegb_used = torch.zeros(self.Fp, dtype=torch.bool,
                                      device=self.device)
        self._cegb_fetched: Optional[torch.Tensor] = None
        if self._cegb_has_lazy:
            if self.N * self.Fp > 3 * 10 ** 8:
                log.warning("cegb_penalty_feature_lazy tracks a [rows x "
                            "features] matrix (%.1f GB)"
                            % (self.N * self.Fp / 2 ** 30))
            self._cegb_fetched = torch.zeros((self.N, self.Fp),
                                             dtype=torch.bool,
                                             device=self.device)


    # ------------------------------------------------------------------
    # monotone_constraints_method=intermediate / advanced
    # ------------------------------------------------------------------
    def _init_monotone(self, config) -> None:
        """The host tracker of the intermediate or advanced method, None
        for the basic method (which the scan runs in every loop) or
        without monotone features (reference ``_init_monotone``)."""
        self._mono_tracker = None
        method = str(config.monotone_constraints_method)
        if not self._has_mono or method == "basic":
            return
        if self._cegb_enabled:
            log.warning("CEGB takes precedence over "
                        "monotone_constraints_method=%s; monotone "
                        "constraints run in basic mode" % method)
            return
        if not self._supports_intermediate:
            log.warning("monotone_constraints_method=%s degrades to "
                        "'basic' under the voting-parallel learner (no "
                        "per-leaf histogram store to rescan)" % method)
            return
        if self._extra_trees:
            log.warning("extra_trees is ignored under "
                        "monotone_constraints_method=%s" % method)
        if self._forced is not None:
            log.warning("forced splits are ignored under "
                        "monotone_constraints_method=%s" % method)
        if self._constraint_groups is not None:
            log.warning("interaction constraints are ignored under "
                        "monotone_constraints_method=%s" % method)
        mono = np.zeros(self.Fp, dtype=np.int8)
        mono[:self.F] = np.asarray(self.dataset.monotone_constraints,
                                   dtype=np.int8)[:self.F]
        if method == "advanced":
            num_bin = np.ones(self.Fp, dtype=np.int64)
            num_bin[:self.F] = self.dataset.num_bin_per_feature
            self._mono_tracker = AdvancedMonotoneTracker(self.L, mono,
                                                         num_bin, self.B)
        else:
            self._mono_tracker = IntermediateMonotoneTracker(self.L, mono)

    def _grow_monotone(self, gh: torch.Tensor):
        """One tree under the intermediate or advanced method (reference
        ``train_monotone``; upstream SerialTreeLearner::Split ->
        constraints_->Update -> RecomputeBestSplitForLeaf,
        serial_tree_learner.cpp:702-710): per split, the tracker sets
        the children's bounds from the actual outputs, the split and its
        children's scans run (the advanced method scans both children
        again under their per-bin bounds), one record read brings the
        next best candidate and every leaf's gain, the leaves whose
        bounds the split tightened are scanned again, and one more read
        follows those rescans. Returns (tree, state)."""
        from .serial import apply_split_record, record_is_valid
        tracker = self._mono_tracker
        advanced = isinstance(tracker, AdvancedMonotoneTracker)
        tracker.reset()
        state = self._new_state(gh)
        self._root(state)
        tree = Tree(self.L)
        rec, row, _, gains = self._read_best(state, with_gains=True)
        leaf_sums: dict = {}
        for k in range(1, self.L):
            if not record_is_valid(rec):
                break
            leaf, f_inner = rec.leaf, rec.feature
            mono_type = int(tracker.mono[f_inner])
            if leaf == 0 and 0 not in leaf_sums:
                leaf_sums[0] = (rec.left_sum_grad + rec.right_sum_grad,
                                rec.left_sum_hess + rec.right_sum_hess,
                                rec.left_count + rec.right_count,
                                rec.left_total_count
                                + rec.right_total_count)
            tracker.before_split(tree, leaf, mono_type)
            apply_split_record(tree, self.dataset, rec)
            lo, ro = rec.left_output, rec.right_output
            rec_tbin = rec.threshold_bin
            numerical = not rec.is_categorical
            if advanced:
                tracker.apply_split_outputs(leaf, k, mono_type, lo, ro,
                                            numerical)
                bounds = (-np.inf, np.inf, -np.inf, np.inf)
            else:
                bounds = tracker.child_bounds(leaf, mono_type, lo, ro)
                tracker.apply_split(tree, leaf, k, bounds)
            leaf_sums[leaf] = (rec.left_sum_grad, rec.left_sum_hess,
                               rec.left_count, rec.left_total_count)
            leaf_sums[k] = (rec.right_sum_grad, rec.right_sum_hess,
                            rec.right_count, rec.right_total_count)
            child_depth = int(tree.leaf_depth[leaf])
            state.leaf_depth[leaf].fill_(child_depth)
            state.leaf_depth[k].fill_(child_depth)
            self._mono_step(state, rec, row, k, child_depth, bounds)
            self.grow_stats["steps"] += 1
            if advanced:
                for child in (leaf, k):
                    self._mono_rescan(
                        state, child, leaf_sums[child], (None, None),
                        int(tree.leaf_depth[child]),
                        tracker.leaf_bound_arrays(tree, child))
            rec, row, _, gains = self._read_best(state, with_gains=True)
            upd = tracker.leaves_to_update(
                tree, k, f_inner, rec_tbin, lo, ro,
                numerical, lambda l: l <= k and np.isfinite(gains[l]))
            for l in upd:
                depth = int(tree.leaf_depth[l])
                if advanced:
                    self._mono_rescan(
                        state, l, leaf_sums[l], (None, None), depth,
                        tracker.leaf_bound_arrays(tree, l))
                else:
                    self._mono_rescan(state, l, leaf_sums[l],
                                      tracker.entries[l], depth)
            if upd:
                rec, row, _, gains = self._read_best(state,
                                                     with_gains=True)
        return tree, state

