"""Random-forest mode.

Port of ``lightgbm_tpu/boosting/rf.py`` (reference: RF,
src/boosting/rf.hpp:25): bagging-only trees with no shrinkage, each
grown on the gradients of the constant init score (computed once), each
with the init score added as its bias; the maintained scores are the
running average of the trees' outputs, and the model text says
``average_output`` so prediction divides the sum of the trees by the
number of iterations.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.tree import Tree
from ..utils import log
from .gbdt import GBDT, kEpsilon


class RF(GBDT):
    """reference: src/boosting/rf.hpp."""

    # its bag refits and averaging are host work per iteration (reference:
    # the same flag in dart.py / rf.py)
    _supports_batched = False

    def __init__(self, config, train_data=None, device=None):
        has_bag = ((config.bagging_freq > 0
                    and 0.0 < config.bagging_fraction < 1.0)
                   or 0.0 < config.feature_fraction < 1.0)
        if not has_bag:
            log.fatal("Random forest needs bagging_freq + bagging_fraction "
                      "< 1 or feature_fraction < 1")
        super().__init__(config, train_data, device)
        self.average_output = True
        self.shrinkage_rate = 1.0
        if train_data is None:
            return
        if self.objective is None:
            log.fatal("RF mode does not support custom objective function, "
                      "please use built-in objectives.")
        # the gradients of the constant init score, once
        K = self.num_tree_per_iteration
        self.init_scores = [self._rf_init_score(k) for k in range(K)]
        const = torch.from_numpy(np.tile(
            np.asarray(self.init_scores, dtype=np.float32),
            (self.num_data, 1))).to(self.device)
        self._grad, self._hess = self.objective.get_gradients(
            const[:, 0] if K == 1 else const)

    def _rf_init_score(self, class_id: int) -> float:
        if self.config.boost_from_average \
                or self.train_data.num_features == 0:
            return self.objective.boost_from_score(class_id)
        return 0.0

    def _multiply_score(self, factor: float, class_id: int) -> None:
        self.train_score[:, class_id] *= float(np.float32(factor))
        for vd in self.valid_data:
            vd.multiply(factor, class_id)

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One tree per class on a new bag; the scores become the
        average of the trees so far (reference RF::TrainOneIter)."""
        if grad is not None or hess is not None:
            log.fatal("RF does not take external gradients")
        K = self.num_tree_per_iteration
        g, h, bag = self.sample_strategy.bagging(self.iter, self._grad,
                                                 self._hess)
        for k in range(K):
            gk = g if K == 1 else g[:, k].contiguous()
            hk = h if K == 1 else h[:, k].contiguous()
            tree: Optional[Tree] = None
            leaf_of_row = None
            if self.class_need_train[k] and self.train_data.num_features > 0:
                tree, leaf_of_row = self.learner.train(gk, hk, bag)
            denom = self.iter + self.num_init_iteration
            if tree is not None and tree.num_leaves > 1:
                if self.objective.is_renew_tree_output:
                    self.objective.renew_tree_output(
                        tree, np.full(self.num_data, self.init_scores[k]),
                        leaf_of_row.cpu().numpy(),
                        None if bag is None else bag.cpu().numpy() > 0)
                if abs(self.init_scores[k]) > kEpsilon:
                    tree.add_bias(self.init_scores[k])
                self._multiply_score(denom, k)
                self._update_score(tree, leaf_of_row, k)
                self._multiply_score(1.0 / (denom + 1), k)
            elif len(self.models) < K:
                out = (0.0 if self.class_need_train[k]
                       else self.objective.boost_from_score(k))
                tree = Tree(1)
                tree.leaf_value[0] = out
                self._multiply_score(denom, k)
                self._add_const_score(out, k)
                self._multiply_score(1.0 / (denom + 1), k)
            elif tree is None:
                tree = Tree(1)
            self.models.append(tree)
        self.iter += 1
        return False
