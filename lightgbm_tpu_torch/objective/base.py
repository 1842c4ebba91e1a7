"""Objective function interface.

Port of ``lightgbm_tpu/objective/base.py`` (reference:
include/LightGBM/objective_function.h:19). ``init(metadata, num_data,
device)`` puts label and weight tensors on the learner's device;
``get_gradients(score)`` returns f32 ``(grad, hess)`` tensors shaped
like ``score`` ([N], or [N, K] for the multiclass objectives), computed
on that device. Leaf renewal (l1, quantile, mape) and
:func:`weighted_percentile` are host NumPy, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


class ObjectiveFunction:
    #: model-format name (reference: each objective's ToString())
    name: str = "custom"

    def __init__(self, config):
        self.config = config
        self.num_data = 0
        self.device = torch.device("cpu")
        self.label: Optional[torch.Tensor] = None
        self.weights: Optional[torch.Tensor] = None

    def init(self, metadata, num_data: int,
             device: torch.device = torch.device("cpu")) -> None:
        """Bind training metadata (reference: ObjectiveFunction::Init).
        Labels and weights are f32, as in the reference's device
        arrays."""
        self.num_data = num_data
        self.device = device
        self.label = torch.from_numpy(
            np.asarray(metadata.label, dtype=np.float32)).to(device)
        self.weights = None if metadata.weights is None else \
            torch.from_numpy(np.asarray(metadata.weights,
                                        dtype=np.float32)).to(device)
        self._check_label(np.asarray(metadata.label))

    def _check_label(self, label: np.ndarray) -> None:
        pass

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    @property
    def num_model_per_iteration(self) -> int:
        """Trees per boosting iteration (reference:
        ObjectiveFunction::NumModelPerIteration; > 1 only for
        multiclass)."""
        return 1

    @property
    def num_tree_per_iteration(self) -> int:
        return self.num_model_per_iteration

    def boost_from_score(self, class_id: int = 0) -> float:
        """Optimal constant initial score (used when boost_from_average)."""
        return 0.0

    def class_need_train(self, class_id: int) -> bool:
        return True

    def convert_output(self, score: np.ndarray) -> np.ndarray:
        """Raw score -> prediction output (host)."""
        return score

    @property
    def has_stochastic_gradients(self) -> bool:
        """True when ``get_gradients`` draws fresh randomness per call
        (rank_xendcg's per-query uniforms)."""
        return False

    def renew_tree_output(self, tree, score: np.ndarray,
                          leaf_of_row: np.ndarray,
                          row_mask: Optional[np.ndarray] = None) -> None:
        """Post-hoc leaf-output renewal (reference:
        ObjectiveFunction::RenewTreeOutput; percentile-based for
        l1/quantile/mape, a no-op otherwise). ``score`` and
        ``leaf_of_row`` are host arrays over the training rows;
        ``row_mask`` marks the in-bag rows when bagging."""
        return None

    @property
    def is_renew_tree_output(self) -> bool:
        return False

    def to_string(self) -> str:
        return self.name

    def __str__(self) -> str:
        return self.to_string()


def apply_weight(grad: torch.Tensor, hess: torch.Tensor,
                 weights: Optional[torch.Tensor]):
    if weights is None:
        return grad, hess
    return grad * weights, hess * weights


def weighted_percentile(values: np.ndarray, weights: Optional[np.ndarray],
                        alpha: float) -> float:
    """Percentile matching the reference's ``PercentileFun`` /
    ``WeightedPercentileFun`` exactly, including interpolation quirks
    (src/objective/regression_objective.hpp:19-88). ``alpha`` has the
    reference call-site meaning: 0.5 for the L1/MAPE median, the
    objective's alpha for quantile."""
    n = len(values)
    if n == 0:
        return 0.0
    if n == 1:
        return float(values[0])
    if weights is None:
        # PercentileFun: position (1-alpha)*n in DESCENDING order
        float_pos = (1.0 - alpha) * n
        pos = int(float_pos)
        if pos < 1:
            return float(values.max())
        if pos >= n:
            return float(values.min())
        bias = float_pos - pos
        desc = np.sort(values)[::-1]
        v1, v2 = float(desc[pos - 1]), float(desc[pos])
        return v1 - (v1 - v2) * bias
    # WeightedPercentileFun: ascending weighted CDF, threshold total*alpha
    order = np.argsort(values, kind="stable")
    sv = values[order]
    cdf = np.cumsum(weights[order])
    threshold = cdf[-1] * alpha
    pos = int(np.searchsorted(cdf, threshold, side="right"))
    pos = min(pos, n - 1)
    if pos == 0 or pos == n - 1:
        return float(sv[pos])
    v1, v2 = float(sv[pos - 1]), float(sv[pos])
    if pos + 1 < n and cdf[pos + 1] - cdf[pos] >= 1.0:
        return ((threshold - cdf[pos]) / (cdf[pos + 1] - cdf[pos])
                * (v2 - v1) + v1)
    return v2
