"""Multiclass objectives: softmax and one-vs-all.

Port of ``lightgbm_tpu/objective/multiclass.py`` (reference:
src/objective/multiclass_objective.hpp:22,176). Scores and gradients
are [N, K] tensors; the boosting loop hands one class column at a time
to the learner.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..utils import log
from .base import ObjectiveFunction
from .binary import BinaryLogloss


class MulticlassSoftmax(ObjectiveFunction):
    """Softmax objective (reference: multiclass_objective.hpp:22):
    p = softmax(score_row); grad_k = p_k - 1{y=k};
    hess_k = factor * p_k * (1 - p_k), factor = K/(K-1)."""

    name = "multiclass"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        if self.num_class < 2:
            log.fatal("num_class should be >= 2 for multiclass")
        self.factor = self.num_class / (self.num_class - 1.0)

    @property
    def num_model_per_iteration(self) -> int:
        return self.num_class

    def _check_label(self, label: np.ndarray) -> None:
        li = label.astype(np.int32)
        if not np.allclose(li, label):
            log.fatal("Label must be int type for multiclass")
        if li.min() < 0 or li.max() >= self.num_class:
            log.fatal("Label must be in [0, %d) for multiclass, but found "
                      "%d" % (self.num_class, int(li.max())))

    def init(self, metadata, num_data: int,
             device: torch.device = torch.device("cpu")) -> None:
        super().init(metadata, num_data, device)
        li = np.asarray(metadata.label).astype(np.int32)
        self.label_onehot = torch.from_numpy(
            np.eye(self.num_class, dtype=np.float32)[li]).to(device)

    def get_gradients(self, score: torch.Tensor):
        # jax.nn.softmax: exp(x - max) / sum(exp(x - max)), the sum taken
        # class by class in order, as XLA's row reduction adds
        e = torch.exp(score - score.max(dim=1, keepdim=True).values)
        total = e[:, 0].clone()
        for k in range(1, self.num_class):
            total += e[:, k]
        p = e / total[:, None]
        grad = p - self.label_onehot
        hess = self.factor * p * (1.0 - p)
        if self.weights is not None:
            grad = grad * self.weights[:, None]
            hess = hess * self.weights[:, None]
        return grad, hess

    def convert_output(self, score):
        e = np.exp(score - score.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    def to_string(self) -> str:
        return "%s num_class:%d" % (self.name, self.num_class)


class MulticlassOVA(ObjectiveFunction):
    """One-vs-all (reference: MulticlassOVA, multiclass_objective.hpp:
    176): K independent BinaryLogloss objectives, one per class
    column."""

    name = "multiclassova"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        if self.num_class < 2:
            log.fatal("num_class should be >= 2 for multiclassova")
        self.sigmoid = float(config.sigmoid)
        self._binary: List[BinaryLogloss] = [
            BinaryLogloss(config, is_pos=_make_is_pos(k))
            for k in range(self.num_class)]

    @property
    def num_model_per_iteration(self) -> int:
        return self.num_class

    def init(self, metadata, num_data: int,
             device: torch.device = torch.device("cpu")) -> None:
        self.num_data = num_data
        self.device = device
        for b in self._binary:
            b.init(metadata, num_data, device)

    def get_gradients(self, score: torch.Tensor):
        grads, hesss = [], []
        for k, b in enumerate(self._binary):
            g, h = b.get_gradients(score[:, k])
            grads.append(g)
            hesss.append(h)
        return torch.stack(grads, dim=1), torch.stack(hesss, dim=1)

    def boost_from_score(self, class_id: int = 0) -> float:
        return self._binary[class_id].boost_from_score(0)

    def class_need_train(self, class_id: int) -> bool:
        return self._binary[class_id].class_need_train(0)

    def convert_output(self, score):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * score))

    def to_string(self) -> str:
        return "%s num_class:%d sigmoid:%g" % (
            self.name, self.num_class, self.sigmoid)


def _make_is_pos(k: int):
    return lambda y: np.asarray(y).astype(np.int32) == k
