"""Regression objectives.

Port of ``lightgbm_tpu/objective/regression.py`` (reference:
src/objective/regression_objective.hpp): l2, l1, huber, fair, poisson,
quantile, mape, gamma and tweedie. Gradients are elementwise torch ops
on the learner's device, written in the reference's operation order
(a constant over a tensor is a true division, never a reciprocal
times the constant). Leaf renewal (l1, quantile, mape) runs on the
host over the score column and the row->leaf partition, as in the
reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import log
from .base import ObjectiveFunction, apply_weight, weighted_percentile


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` rounded to f32 as a tensor shaped like ``like``: the
    numerator of a true division (``value / tensor`` in torch is a
    reciprocal times ``value``, which rounds twice)."""
    return torch.full_like(like, float(value))


class RegressionL2(ObjectiveFunction):
    """L2 loss (reference: RegressionL2loss, regression_objective.hpp:
    127-139): grad = score - label, hess = 1, with the optional sqrt
    label transform."""

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

    def _grads(self, score: torch.Tensor):
        return score - self.label, torch.ones_like(score)

    def get_gradients(self, score: torch.Tensor):
        grad, hess = self._grads(score)
        return apply_weight(grad, hess, self.weights)

    def _label_np(self) -> np.ndarray:
        return self.label.double().cpu().numpy()

    def _weights_np(self) -> Optional[np.ndarray]:
        return (None if self.weights is None
                else self.weights.double().cpu().numpy())

    def boost_from_score(self, class_id: int = 0) -> float:
        label = self._label_np()
        w = self._weights_np()
        if w is not None:
            return float((label * w).sum() / w.sum())
        return float(label.mean())

    def convert_output(self, score):
        if self.sqrt:
            return np.sign(score) * score * score
        return score

    def to_string(self) -> str:
        return self.name + (" sqrt" if self.sqrt else "")


class RegressionL1(RegressionL2):
    """L1 loss (reference: RegressionL1loss, regression_objective.hpp:
    217-236): grad = sign(diff), hess = 1; leaf outputs renewed to the
    weighted median of the residuals (RenewTreeOutput at :253)."""

    name = "regression_l1"
    _renew_alpha = 0.5

    def _grads(self, score):
        return torch.sign(score - self.label), torch.ones_like(score)

    def boost_from_score(self, class_id: int = 0) -> float:
        return weighted_percentile(self._label_np(), self._weights_np(),
                                   self._renew_alpha)

    @property
    def is_renew_tree_output(self) -> bool:
        return True

    def _renew_weights(self) -> Optional[np.ndarray]:
        return self._weights_np()

    def renew_tree_output(self, tree, score, leaf_of_row, row_mask=None):
        residual = self._label_np() - score
        w = self._renew_weights()
        for leaf in range(tree.num_leaves):
            rows = leaf_of_row == leaf
            if row_mask is not None:
                rows &= row_mask
            if not rows.any():
                continue
            tree.set_leaf_output(leaf, weighted_percentile(
                residual[rows], None if w is None else w[rows],
                self._renew_alpha))


class RegressionHuber(RegressionL2):
    """Huber loss (reference: RegressionHuberLoss,
    regression_objective.hpp:292+): grad = diff clipped to +-alpha,
    hess = 1; the sqrt transform is disabled."""

    name = "huber"

    def __init__(self, config):
        super().__init__(config)
        if self.sqrt:
            log.warning("Cannot use sqrt transform in %s Regression, "
                        "will auto disable it", self.name)
            self.sqrt = False
        self.alpha = float(config.alpha)
        if self.alpha <= 0.0:
            log.fatal("alpha should be greater than 0")

    def _grads(self, score):
        return (torch.clamp(score - self.label, -self.alpha, self.alpha),
                torch.ones_like(score))


class RegressionFair(RegressionL2):
    """Fair loss (reference: RegressionFairLoss,
    regression_objective.hpp:352+): grad = c*x/(|x|+c),
    hess = c^2/(|x|+c)^2."""

    name = "fair"

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = False
        self.c = float(config.fair_c)

    def _grads(self, score):
        x = score - self.label
        denom = torch.abs(x) + self.c
        grad = self.c * x / denom
        hess = _const(denom, self.c * self.c) / (denom * denom)
        return grad, hess

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0


class RegressionPoisson(RegressionL2):
    """Poisson regression (reference: RegressionPoissonLoss,
    regression_objective.hpp:407+): log-scale scores;
    grad = exp(s) - label, hess = exp(s + poisson_max_delta_step);
    BoostFromScore = log(weighted mean label)."""

    name = "poisson"

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = False
        self.max_delta_step = float(config.poisson_max_delta_step)
        if self.max_delta_step <= 0.0:
            log.fatal("poisson_max_delta_step should be greater than 0")

    def _check_label(self, label: np.ndarray) -> None:
        if (label < 0).any():
            log.fatal("[%s]: at least one target label is negative"
                      % self.name)
        if label.sum() <= 0.0:
            log.fatal("[%s]: sum of labels is zero" % self.name)

    def _grads(self, score):
        exp_score = torch.exp(score)
        return (exp_score - self.label,
                exp_score * float(np.exp(self.max_delta_step)))

    def boost_from_score(self, class_id: int = 0) -> float:
        mean = super().boost_from_score(class_id)
        return float(np.log(max(mean, 1e-20)))

    def convert_output(self, score):
        return np.exp(score)


class RegressionQuantile(RegressionL2):
    """Quantile regression (reference: RegressionQuantileloss,
    regression_objective.hpp:478+): grad = (1-alpha) if score > label
    else -alpha, hess = 1; leaves renewed at the alpha percentile of the
    residuals."""

    name = "quantile"

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = False
        self.alpha = float(config.alpha)
        if not (0.0 < self.alpha < 1.0):
            log.fatal("alpha should be in (0, 1) for quantile objective")

    def _grads(self, score):
        grad = torch.where(score > self.label, _const(score, 1.0 - self.alpha),
                           _const(score, -self.alpha))
        return grad, torch.ones_like(score)

    def boost_from_score(self, class_id: int = 0) -> float:
        return weighted_percentile(self._label_np(), self._weights_np(),
                                   self.alpha)

    @property
    def is_renew_tree_output(self) -> bool:
        return True

    def renew_tree_output(self, tree, score, leaf_of_row, row_mask=None):
        residual = self._label_np() - score
        w = self._weights_np()
        for leaf in range(tree.num_leaves):
            rows = leaf_of_row == leaf
            if row_mask is not None:
                rows &= row_mask
            if not rows.any():
                continue
            tree.set_leaf_output(leaf, weighted_percentile(
                residual[rows], None if w is None else w[rows],
                self.alpha))


class RegressionMAPE(RegressionL1):
    """MAPE (reference: RegressionMAPELOSS, regression_objective.hpp:
    579+): row label weight 1/max(1, |label|); grad =
    sign(diff) * label_weight, hess = 1 (or the user weight); renewal
    weighted by the label weight."""

    name = "mape"

    def init(self, metadata, num_data: int,
             device: torch.device = torch.device("cpu")) -> None:
        super().init(metadata, num_data, device)
        raw = np.asarray(metadata.label, dtype=np.float64)
        lw = 1.0 / np.maximum(1.0, np.abs(raw))
        if metadata.weights is not None:
            lw = lw * np.asarray(metadata.weights, dtype=np.float64)
        if (np.abs(raw) < 1).any():
            log.warning(
                "Some label values are < 1 in absolute value. MAPE is "
                "unstable with such values, so LightGBM rounds them to "
                "1.0 when computing MAPE.")
        self.label_weight = torch.from_numpy(lw.astype(np.float32)).to(
            device)
        self._label_weight_np = lw

    def get_gradients(self, score):
        grad = torch.sign(score - self.label) * self.label_weight
        hess = (torch.ones_like(score) if self.weights is None
                else self.weights.clone())
        return grad, hess

    def boost_from_score(self, class_id: int = 0) -> float:
        return weighted_percentile(self._label_np(), self._label_weight_np,
                                   0.5)

    def _renew_weights(self) -> Optional[np.ndarray]:
        return self._label_weight_np


class RegressionGamma(RegressionPoisson):
    """Gamma regression (reference: RegressionGammaLoss,
    regression_objective.hpp:679+): grad = 1 - label*exp(-s),
    hess = label*exp(-s)."""

    name = "gamma"

    def _grads(self, score):
        exp_ns = torch.exp(-score)
        return 1.0 - self.label * exp_ns, self.label * exp_ns


class RegressionTweedie(RegressionPoisson):
    """Tweedie regression (reference: RegressionTweedieLoss,
    regression_objective.hpp:716+): with rho = tweedie_variance_power,
    grad = -label*exp((1-rho)s) + exp((2-rho)s)."""

    name = "tweedie"

    def __init__(self, config):
        super().__init__(config)
        self.rho = float(config.tweedie_variance_power)

    def _check_label(self, label: np.ndarray) -> None:
        if (label < 0).any():
            log.fatal("[%s]: at least one target label is negative"
                      % self.name)

    def _grads(self, score):
        exp_1 = torch.exp((1.0 - self.rho) * score)
        exp_2 = torch.exp((2.0 - self.rho) * score)
        grad = -self.label * exp_1 + exp_2
        hess = (-self.label * (1.0 - self.rho) * exp_1
                + (2.0 - self.rho) * exp_2)
        return grad, hess
