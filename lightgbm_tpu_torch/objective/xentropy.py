"""Cross-entropy objectives over [0, 1]-valued labels.

Port of ``lightgbm_tpu/objective/xentropy.py`` (reference:
src/objective/xentropy_objective.hpp:21,148). ``torch.sigmoid`` stands
for ``jax.nn.sigmoid``: of the ways to write it, it rounds closest to
XLA's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import log
from .base import ObjectiveFunction, apply_weight

_EPS = 1e-12


class CrossEntropy(ObjectiveFunction):
    """loss(y, p, w) = (-(1-y) log(1-p) - y log p) * w, p = sigmoid(score)
    (reference: xentropy_objective.hpp:82-92): grad = z - y,
    hess = z(1-z), scaled by the weight."""

    name = "cross_entropy"

    def _check_label(self, label: np.ndarray) -> None:
        if label.min() < 0.0 or label.max() > 1.0:
            log.fatal("[%s]: label must be in [0, 1]" % self.name)
        log.info("[%s]: (objective) labels passed interval [0, 1] check"
                 % self.name)

    def init(self, metadata, num_data: int,
             device: torch.device = torch.device("cpu")) -> None:
        super().init(metadata, num_data, device)
        if metadata.weights is not None:
            w = np.asarray(metadata.weights)
            if (w < 0).any():
                log.fatal("[%s]: at least one weight is negative"
                          % self.name)
            if w.sum() == 0.0:
                log.fatal("[%s]: sum of weights is zero" % self.name)

    def get_gradients(self, score: torch.Tensor):
        z = torch.sigmoid(score)
        grad = z - self.label
        hess = z * (1.0 - z)
        return apply_weight(grad, hess, self.weights)

    def _mean_label(self) -> float:
        label = self.label.double().cpu().numpy()
        if self.weights is not None:
            w = self.weights.double().cpu().numpy()
            return (label * w).sum() / w.sum()
        return label.mean()

    def boost_from_score(self, class_id: int = 0) -> float:
        pavg = min(max(self._mean_label(), _EPS), 1.0 - _EPS)
        initscore = float(np.log(pavg / (1.0 - pavg)))
        log.info("[%s:BoostFromScore]: pavg = %f -> initscore = %f"
                 % (self.name, pavg, initscore))
        return initscore

    def convert_output(self, score):
        return 1.0 / (1.0 + np.exp(-score))


class CrossEntropyLambda(CrossEntropy):
    """Alternative parameterization with p = 1 - exp(-lambda * w),
    lambda = log(1 + exp(f)) (reference: xentropy_objective.hpp:148-216).
    Unweighted it reduces to CrossEntropy."""

    name = "cross_entropy_lambda"

    def _check_label(self, label: np.ndarray) -> None:
        if label.min() < 0.0 or label.max() > 1.0:
            log.fatal("[%s]: label must be in [0, 1]" % self.name)

    def init(self, metadata, num_data: int,
             device: torch.device = torch.device("cpu")) -> None:
        ObjectiveFunction.init(self, metadata, num_data, device)
        if metadata.weights is not None:
            w = np.asarray(metadata.weights)
            if (w <= 0).any():
                log.fatal("[%s]: at least one weight is non-positive"
                          % self.name)

    def get_gradients(self, score: torch.Tensor):
        if self.weights is None:
            z = torch.sigmoid(score)
            return z - self.label, z * (1.0 - z)
        w, y = self.weights, self.label
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = 1.0 / epf
        grad = (1.0 - y / z) * w / (1.0 + enf)
        c = 1.0 / (1.0 - z)
        d = 1.0 + epf
        a = w * epf / (d * d)
        d2 = c - 1.0
        b = (c / (d2 * d2)) * (1.0 + w * epf - c)
        hess = a * (1.0 + y * b)
        return grad, hess

    def boost_from_score(self, class_id: int = 0) -> float:
        havg = self._mean_label()
        initscore = float(np.log(max(np.expm1(havg), _EPS)))
        log.info("[%s:BoostFromScore]: havg = %f -> initscore = %f"
                 % (self.name, havg, initscore))
        return initscore

    def convert_output(self, score):
        return np.log1p(np.exp(score))
