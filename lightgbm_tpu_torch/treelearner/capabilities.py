"""Column sampling, interaction constraints and CEGB: the config-derived
feature state of the learner.

Port of ``lightgbm_tpu/treelearner/capabilities.py`` without its
monotone and quantization parts (monotone constraints are ROADMAP item
15b; quantization lives in ``serial.py``):

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
  trees.

Per-node masks and CEGB depend on host state that changes with every
split (the feature path, the used and fetched features), so their trees
grow through the per-split loop (``SerialTreeLearner._grow_stepped``)
with one record read per split: that is the contract of these modes, in
the reference too (its ``train_stepwise`` and ``train_cegb``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import log


class CapabilityMixin:
    """Config-derived feature state of the learner. Needs ``config``,
    ``dataset``, ``device``, ``F``, ``Fp`` and ``N`` before
    :meth:`_init_capabilities`."""

    def _init_capabilities(self, config) -> None:
        self._ff_rng = np.random.RandomState(config.feature_fraction_seed)
        self._resolve_constraints()
        self._init_cegb(config)

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
        if self._needs_per_node_masks():
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

