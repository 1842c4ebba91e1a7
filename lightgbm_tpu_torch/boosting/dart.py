"""DART boosting: dropout trees.

Port of ``lightgbm_tpu/boosting/dart.py`` (reference: DART,
src/boosting/dart.hpp:23). Each iteration drops a random subset of the
earlier iterations' trees from the scores, trains the new tree on what
is left, then scales the new tree and the dropped ones so the expected
score holds (dart.hpp:158 ``Normalize``). The drops are drawn on the
host from ``np.random.RandomState(drop_seed)`` in the reference's draw
order, so a seed gives the same drop sets on every device; the scores
move by the binned walk of each dropped tree on the learner's device
(``gbdt.device_tree_outputs``).
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..utils import log
from .gbdt import GBDT, device_tree_outputs


class DART(GBDT):
    """reference: src/boosting/dart.hpp."""

    # its drops and normalization are host work per iteration (reference:
    # the same flag in dart.py / rf.py)
    _supports_batched = False

    def __init__(self, config, train_data=None, device=None):
        super().__init__(config, train_data, device)
        self.drop_rng = np.random.RandomState(config.drop_seed)
        self.drop_index: List[int] = []
        self.sum_weight = 0.0
        self.tree_weight: List[float] = []
        # scores move at weight 1; the normalization scales the trees
        self.shrinkage_rate = 1.0
        log.info("Using DART")

    def _select_dropping_trees(self) -> None:
        """The iterations to drop (reference: DART::DroppingTrees,
        dart.hpp:97): each with probability ``drop_rate`` (or in
        proportion to its tree weight without ``uniform_drop``), at most
        ``max_drop`` of them (a shuffle picks which), none with
        probability ``skip_drop``."""
        self.drop_index = []
        num_iters = self.iter
        if num_iters <= 0:
            return
        cfg = self.config
        if cfg.uniform_drop:
            keep = self.drop_rng.random_sample(num_iters) >= cfg.drop_rate
            self.drop_index = [i for i in range(num_iters) if not keep[i]]
        else:
            w = np.asarray(self.tree_weight)
            p = w / w.sum() * cfg.drop_rate * num_iters
            u = self.drop_rng.random_sample(num_iters)
            self.drop_index = [i for i in range(num_iters) if u[i] < p[i]]
        if cfg.max_drop > 0 and len(self.drop_index) > cfg.max_drop:
            self.drop_rng.shuffle(self.drop_index)
            self.drop_index = sorted(self.drop_index[:cfg.max_drop])
        if self.drop_rng.random_sample() < cfg.skip_drop:
            self.drop_index = []

    def _apply_trees(self, iters: List[int], sign: float) -> None:
        """Add ``sign`` times the trees of iterations ``iters`` to the
        training and validation scores, by the binned walk on the
        device (an f32 ``delta * sign``, as the reference)."""
        K = self.num_tree_per_iteration
        bins = self.learner.bins
        for it in iters:
            for k in range(K):
                tree = self.models[it * K + k]
                delta = device_tree_outputs(tree, bins,
                                            self._train_bin_meta, self._raw)
                if delta is not None:
                    self.train_score[:, k] += delta * float(np.float32(sign))
                for vd in self.valid_data:
                    vd.add_tree(tree, k, self._bin_meta, sign=sign)

    def train_one_iter(self, grad=None, hess=None) -> bool:
        self._select_dropping_trees()
        if self.drop_index:
            self._apply_trees(self.drop_index, -1.0)
        n_models_before = len(self.models)
        res = super().train_one_iter(grad, hess)
        if len(self.models) > n_models_before:
            self._normalize()
        elif self.drop_index:
            # no new tree: the dropped trees go back as they were
            self._apply_trees(self.drop_index, 1.0)
        return res

    def _normalize(self) -> None:
        """reference: DART::Normalize (dart.hpp:158). The new tree takes
        weight lr / (k + lr) (``xgboost_dart_mode``) or lr / k / (1 + lr
        / k), the k dropped trees k / (k + lr) or 1 / (1 + lr / k); the
        new tree went into the scores at weight 1, so the scores take
        ``new_weight - 1`` of it more, and the dropped trees go back at
        their new weight."""
        cfg = self.config
        K = self.num_tree_per_iteration
        k_drop = len(self.drop_index)
        lr = float(cfg.learning_rate)
        if cfg.xgboost_dart_mode:
            new_weight = lr / (k_drop + lr)
            old_factor = k_drop / (k_drop + lr)
        elif k_drop == 0:
            new_weight, old_factor = lr, 1.0
        else:
            new_weight = lr / k_drop / (1.0 + lr / k_drop)
            old_factor = 1.0 / (1.0 + lr / k_drop)
        self._apply_trees([self.iter - 1], new_weight - 1.0)
        for k in range(K):
            tree = self.models[-K + k]
            if tree.num_leaves >= 1:
                tree.apply_shrinkage(new_weight)
        for it in self.drop_index:
            for k in range(K):
                self.models[it * K + k].apply_shrinkage(old_factor)
            self.tree_weight[it] *= old_factor
        if self.drop_index:
            self._apply_trees(self.drop_index, 1.0)
        self.tree_weight.append(new_weight)
        self.sum_weight += new_weight
