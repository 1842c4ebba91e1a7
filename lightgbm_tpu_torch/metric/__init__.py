"""Metrics: ``auc``, ``binary_logloss`` and ``l2``.

Port of those three from ``lightgbm_tpu/metric/__init__.py``
(reference: src/metric/binary_metric.hpp, regression_metric.hpp).
Metrics are O(N) reductions plus a sort for AUC over the fetched score,
so they run in NumPy on the host, as in the reference. The rest of the
catalog is ROADMAP item 10.

``Metric.eval(score, objective)`` returns a list of values;
``factor_to_bigger_better`` > 0 means bigger is better.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..utils import log
from ..utils.log import unsupported

kEpsilon = 1e-15


class Metric:
    name: List[str] = []
    factor_to_bigger_better: float = -1.0

    def __init__(self, config):
        self.config = config

    def init(self, metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = np.asarray(metadata.label, dtype=np.float64)
        self.weights = (None if metadata.weights is None
                        else np.asarray(metadata.weights, dtype=np.float64))
        self.sum_weights = (float(num_data) if self.weights is None
                            else float(self.weights.sum()))

    def eval(self, score: np.ndarray, objective=None) -> List[float]:
        raise NotImplementedError


class L2Metric(Metric):
    """Mean (weighted) squared error of the converted score
    (reference: RegressionMetric::Eval, regression_metric.hpp:55-95)."""

    name = ["l2"]

    def eval(self, score, objective=None) -> List[float]:
        score = np.asarray(score, dtype=np.float64).reshape(self.label.shape)
        if objective is not None:
            score = objective.convert_output(score)
        pt = (score - self.label) ** 2
        if self.weights is not None:
            pt = pt * self.weights
        return [float(pt.sum()) / self.sum_weights]


class BinaryLoglossMetric(Metric):
    """reference: binary_metric.hpp:119-130."""

    name = ["binary_logloss"]

    def eval(self, score, objective=None) -> List[float]:
        score = np.asarray(score, dtype=np.float64).reshape(self.label.shape)
        if objective is not None:
            prob = objective.convert_output(score)
        else:
            prob = 1.0 / (1.0 + np.exp(-score))
        p = np.where(self.label > 0, prob, 1.0 - prob)
        pt = -np.log(np.maximum(p, kEpsilon))
        if self.weights is not None:
            pt = pt * self.weights
        return [float(pt.sum()) / self.sum_weights]


def weighted_auc(label_pos: np.ndarray, score: np.ndarray,
                 weights: Optional[np.ndarray]) -> float:
    """Weighted AUC with tie handling (reference: AUCMetric::Eval,
    binary_metric.hpp:160-270: sorted threshold sweep, ties contribute a
    trapezoid)."""
    w = np.ones_like(score) if weights is None else weights
    order = np.argsort(score, kind="stable")
    s, wp = score[order], (w * label_pos)[order]
    wn = (w * (1.0 - label_pos))[order]
    boundary = np.concatenate([[True], s[1:] != s[:-1]])
    group = np.cumsum(boundary) - 1
    ngroups = group[-1] + 1
    gp = np.zeros(ngroups)
    gn = np.zeros(ngroups)
    np.add.at(gp, group, wp)
    np.add.at(gn, group, wn)
    cum_neg_before = np.concatenate([[0.0], np.cumsum(gn)[:-1]])
    accum = float((gp * (cum_neg_before + 0.5 * gn)).sum())
    total_pos, total_neg = float(wp.sum()), float(wn.sum())
    if total_pos <= 0 or total_neg <= 0:
        log.warning("AUC is undefined with only one class")
        return 1.0
    return accum / (total_pos * total_neg)


class AUCMetric(Metric):
    name = ["auc"]
    factor_to_bigger_better = 1.0

    def eval(self, score, objective=None) -> List[float]:
        score = np.asarray(score, dtype=np.float64).reshape(self.label.shape)
        return [weighted_auc((self.label > 0).astype(np.float64), score,
                             self.weights)]


_METRICS = {"l2": L2Metric, "binary_logloss": BinaryLoglossMetric,
            "auc": AUCMetric}
# the objective's default metric (reference: Config::Set default)
_DEFAULT_OF = {"binary": "binary_logloss", "regression": "l2"}


def create_metric(name: str, config) -> Metric:
    if name not in _METRICS:
        unsupported("metric=%s" % name, "item 10")
    return _METRICS[name](config)


def resolve_metric_names(config, objective_name: str) -> List[str]:
    """The configured metrics, else the objective's own."""
    names = [m for m in (config.metric or []) if m]
    if names:
        return names
    return [_DEFAULT_OF[objective_name]] if objective_name in _DEFAULT_OF \
        else []


__all__ = ["Metric", "create_metric", "resolve_metric_names",
           "weighted_auc"]
