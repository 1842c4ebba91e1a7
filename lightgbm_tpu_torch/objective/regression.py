"""Regression objectives: L2.

Port of ``RegressionL2`` from ``lightgbm_tpu/objective/regression.py``
(reference: RegressionL2loss, src/objective/regression_objective.hpp:
127-139): grad = score - label, hess = 1, with the optional sqrt label
transform. The rest of the family is ROADMAP item 10.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import ObjectiveFunction


class RegressionL2(ObjectiveFunction):
    name = "regression"

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = bool(config.reg_sqrt)

    def init(self, metadata, num_data: int,
             device: torch.device = torch.device("cpu")) -> None:
        super().init(metadata, num_data, device)
        if self.sqrt:
            raw = np.asarray(metadata.label, dtype=np.float64)
            trans = np.sign(raw) * np.sqrt(np.abs(raw))
            self.label = torch.from_numpy(
                trans.astype(np.float32)).to(device)

    def get_gradients(self, score: torch.Tensor):
        grad = score - self.label
        hess = torch.ones_like(score)
        if self.weights is not None:
            grad = grad * self.weights
            hess = hess * self.weights
        return grad, hess

    def boost_from_score(self, class_id: int = 0) -> float:
        label = self.label.double().cpu().numpy()
        if self.weights is not None:
            w = self.weights.double().cpu().numpy()
            return float((label * w).sum() / w.sum())
        return float(label.mean())

    def convert_output(self, score):
        if self.sqrt:
            return np.sign(score) * score * score
        return score

    def to_string(self) -> str:
        return self.name + (" sqrt" if self.sqrt else "")
