"""Metrics: every metric of the reference's catalog.

Port (a copy: host NumPy) of ``lightgbm_tpu/metric/__init__.py``
(reference: src/metric/, factory src/metric/metric.cpp:19). Metrics are
O(N) reductions plus sorts for AUC and NDCG over the fetched score, so
they run in NumPy on the host, as in the reference.

``Metric.eval(score, objective)`` returns a list of values (one per
``eval_at`` position for ndcg and map); ``factor_to_bigger_better`` > 0
means bigger is better.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..objective import dcg
from ..utils import log

kEpsilon = 1e-15


class Metric:
    name: List[str] = []
    factor_to_bigger_better: float = -1.0  # negative: smaller is better

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


# ---------------------------------------------------------------------------
# Regression family (reference: src/metric/regression_metric.hpp)
# ---------------------------------------------------------------------------
class _PointwiseMetric(Metric):
    """Average of a pointwise loss, optionally weight-scaled
    (reference: RegressionMetric::Eval, regression_metric.hpp:55-95)."""

    convert_score = True  # apply objective->ConvertOutput before loss

    def loss(self, label: np.ndarray, score: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def average(self, sum_loss: float) -> float:
        return sum_loss / self.sum_weights

    def eval(self, score, objective=None) -> List[float]:
        score = np.asarray(score, dtype=np.float64).reshape(self.label.shape)
        if self.convert_score and objective is not None:
            score = objective.convert_output(score)
        pt = self.loss(self.label, score)
        if self.weights is not None:
            pt = pt * self.weights
        return [self.average(float(pt.sum()))]


class L2Metric(_PointwiseMetric):
    name = ["l2"]

    def loss(self, label, score):
        d = score - label
        return d * d


class RMSEMetric(L2Metric):
    name = ["rmse"]

    def average(self, sum_loss):
        return float(np.sqrt(sum_loss / self.sum_weights))


class L1Metric(_PointwiseMetric):
    name = ["l1"]

    def loss(self, label, score):
        return np.abs(score - label)


class QuantileMetric(_PointwiseMetric):
    name = ["quantile"]

    def loss(self, label, score):
        delta = label - score
        a = self.config.alpha
        return np.where(delta < 0, (a - 1.0) * delta, a * delta)


class HuberMetric(_PointwiseMetric):
    name = ["huber"]

    def loss(self, label, score):
        d = score - label
        a = self.config.alpha
        return np.where(np.abs(d) <= a, 0.5 * d * d,
                        a * (np.abs(d) - 0.5 * a))


class FairMetric(_PointwiseMetric):
    name = ["fair"]

    def loss(self, label, score):
        x = np.abs(score - label)
        c = self.config.fair_c
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_PointwiseMetric):
    name = ["poisson"]

    def loss(self, label, score):
        s = np.maximum(score, 1e-10)
        return s - label * np.log(s)


class MAPEMetric(_PointwiseMetric):
    name = ["mape"]

    def loss(self, label, score):
        return np.abs(label - score) / np.maximum(1.0, np.abs(label))


class GammaMetric(_PointwiseMetric):
    name = ["gamma"]

    def loss(self, label, score):
        # reference: regression_metric.hpp:260-270 (negative gamma
        # log-likelihood with psi = 1)
        theta = -1.0 / np.maximum(score, 1e-300)
        b = -_safe_log(-theta)
        c = _safe_log(label) - _safe_log(label)  # psi=1 → zero, kept for parity
        return -((label * theta - b) + c)


class GammaDevianceMetric(_PointwiseMetric):
    name = ["gamma_deviance"]

    def loss(self, label, score):
        tmp = label / (score + 1e-9)
        return tmp - _safe_log(tmp) - 1.0

    def average(self, sum_loss):
        return sum_loss * 2.0


class TweedieMetric(_PointwiseMetric):
    name = ["tweedie"]

    def loss(self, label, score):
        rho = self.config.tweedie_variance_power
        s = np.maximum(score, 1e-10)
        a = label * np.exp((1.0 - rho) * np.log(s)) / (1.0 - rho)
        b = np.exp((2.0 - rho) * np.log(s)) / (2.0 - rho)
        return -a + b


def _safe_log(x):
    return np.log(np.maximum(x, 1e-300))


# ---------------------------------------------------------------------------
# Binary family (reference: src/metric/binary_metric.hpp)
# ---------------------------------------------------------------------------
class _BinaryPointwiseMetric(_PointwiseMetric):
    """Score -> prob via the objective's sigmoid when available
    (reference: BinaryMetric::Eval, binary_metric.hpp:60-95)."""

    def eval(self, score, objective=None) -> List[float]:
        score = np.asarray(score, dtype=np.float64).reshape(self.label.shape)
        if objective is not None:
            prob = objective.convert_output(score)
        else:
            prob = 1.0 / (1.0 + np.exp(-score))
        pt = self.loss(self.label, prob)
        if self.weights is not None:
            pt = pt * self.weights
        return [self.average(float(pt.sum()))]


class BinaryLoglossMetric(_BinaryPointwiseMetric):
    name = ["binary_logloss"]

    def loss(self, label, prob):
        # reference: binary_metric.hpp:119-130
        p = np.where(label > 0, prob, 1.0 - prob)
        return -np.log(np.maximum(p, kEpsilon))


class BinaryErrorMetric(_BinaryPointwiseMetric):
    name = ["binary_error"]

    def loss(self, label, prob):
        pred_pos = prob > 0.5
        return np.where(pred_pos, label <= 0, label > 0).astype(np.float64)


def weighted_auc(label_pos: np.ndarray, score: np.ndarray,
                  weights: Optional[np.ndarray]) -> float:
    """Weighted AUC with tie handling (reference: AUCMetric::Eval,
    binary_metric.hpp:160-270: sorted threshold sweep, ties contribute a
    trapezoid)."""
    w = np.ones_like(score) if weights is None else weights
    # ascending order: for each positive, negatives *before* it are the
    # correctly-ranked pairs
    order = np.argsort(score, kind="stable")
    s, wp = score[order], (w * label_pos)[order]
    wn = (w * (1.0 - label_pos))[order]
    # tie groups
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


class AveragePrecisionMetric(Metric):
    """reference: binary_metric.hpp AveragePrecisionMetric — threshold
    sweep accumulating precision * recall increments."""

    name = ["average_precision"]
    factor_to_bigger_better = 1.0

    def eval(self, score, objective=None) -> List[float]:
        score = np.asarray(score, dtype=np.float64).reshape(self.label.shape)
        label_pos = (self.label > 0).astype(np.float64)
        w = np.ones_like(score) if self.weights is None else self.weights
        order = np.argsort(-score, kind="stable")
        s = score[order]
        wp = (w * label_pos)[order]
        wt = w[order]
        boundary = np.concatenate([[True], s[1:] != s[:-1]])
        group = np.cumsum(boundary) - 1
        ngroups = group[-1] + 1
        gp = np.zeros(ngroups)
        gt = np.zeros(ngroups)
        np.add.at(gp, group, wp)
        np.add.at(gt, group, wt)
        cum_pos = np.cumsum(gp)
        cum_tot = np.cumsum(gt)
        total_pos = cum_pos[-1]
        if total_pos <= 0:
            log.warning("Average precision is undefined without positives")
            return [1.0]
        precision = cum_pos / cum_tot
        recall_delta = gp / total_pos
        return [float((precision * recall_delta).sum())]


# ---------------------------------------------------------------------------
# Multiclass family (reference: src/metric/multiclass_metric.hpp)
# ---------------------------------------------------------------------------
class _MulticlassMetric(Metric):
    def init(self, metadata, num_data: int) -> None:
        super().init(metadata, num_data)
        self.num_class = int(self.config.num_class)

    def _probs(self, score, objective):
        score = np.asarray(score, dtype=np.float64)
        if score.ndim == 1:
            score = score.reshape(self.num_class, -1).T
        if objective is not None:
            return objective.convert_output(score)
        e = np.exp(score - score.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)


class MultiLoglossMetric(_MulticlassMetric):
    name = ["multi_logloss"]

    def eval(self, score, objective=None) -> List[float]:
        p = self._probs(score, objective)
        k = self.label.astype(np.int64)
        pk = p[np.arange(len(k)), k]
        pt = -np.log(np.maximum(pk, kEpsilon))
        if self.weights is not None:
            pt = pt * self.weights
        return [float(pt.sum()) / self.sum_weights]


class MultiErrorMetric(_MulticlassMetric):
    @property
    def name(self):
        k = self.config.multi_error_top_k
        return ["multi_error" if k == 1 else "multi_error@%d" % k]

    def eval(self, score, objective=None) -> List[float]:
        p = self._probs(score, objective)
        k = self.label.astype(np.int64)
        own = p[np.arange(len(k)), k][:, None]
        num_larger = (p >= own).sum(axis=1)  # includes own class
        err = (num_larger > self.config.multi_error_top_k).astype(np.float64)
        if self.weights is not None:
            err = err * self.weights
        return [float(err.sum()) / self.sum_weights]


class AucMuMetric(_MulticlassMetric):
    """reference: AucMuMetric, multiclass_metric.hpp:184-340 — mean of
    pairwise class-separability AUCs over class-pair hyperplanes
    (Kleiman & Page, auc-mu)."""

    name = ["auc_mu"]
    factor_to_bigger_better = 1.0

    def init(self, metadata, num_data: int) -> None:
        super().init(metadata, num_data)
        K = self.num_class
        cw = self.config.auc_mu_weights
        if cw:
            if len(cw) != K * K:
                log.fatal("auc_mu_weights must have %d elements" % (K * K))
            self.class_weights = np.asarray(cw, dtype=np.float64).reshape(K, K)
        else:
            self.class_weights = 1.0 - np.eye(K)

    def eval(self, score, objective=None) -> List[float]:
        score = np.asarray(score, dtype=np.float64)
        if score.ndim == 1:
            score = score.reshape(self.num_class, -1).T
        K = self.num_class
        label = self.label.astype(np.int64)
        total = 0.0
        for i in range(K):
            for j in range(i + 1, K):
                v = self.class_weights[i] - self.class_weights[j]
                t1 = v[i] - v[j]
                sel = (label == i) | (label == j)
                d = t1 * (score[sel] @ v)
                is_i = (label[sel] == i).astype(np.float64)
                w = None if self.weights is None else self.weights[sel]
                total += weighted_auc(is_i, d, w)
        npairs = K * (K - 1) / 2
        return [total / npairs]


# ---------------------------------------------------------------------------
# Ranking family (reference: src/metric/rank_metric.hpp, map_metric.hpp)
# ---------------------------------------------------------------------------
class _RankMetric(Metric):
    def init(self, metadata, num_data: int) -> None:
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            log.fatal("For ranking metrics, there should be query information")
        self.query_boundaries = np.asarray(metadata.query_boundaries)
        self.num_queries = len(self.query_boundaries) - 1
        self.eval_at = [int(k) for k in (self.config.eval_at or [1, 2, 3, 4, 5])]
        # per-query weight = weight of the query's first doc when weighted
        # (reference: Metadata::query_weights_)
        if self.weights is not None:
            qw = np.zeros(self.num_queries)
            for q in range(self.num_queries):
                qw[q] = self.weights[self.query_boundaries[q]]
            self.query_weights = qw
            self.sum_query_weights = float(qw.sum())
        else:
            self.query_weights = None
            self.sum_query_weights = float(self.num_queries)


class NDCGMetric(_RankMetric):
    factor_to_bigger_better = 1.0

    @property
    def name(self):
        return ["ndcg@%d" % k for k in self.eval_at]

    def init(self, metadata, num_data: int) -> None:
        super().init(metadata, num_data)
        self.label_gain = dcg.resolve_label_gain(self.config.label_gain)
        dcg.check_label(self.label, len(self.label_gain))
        # cache per-(query, k) inverse max DCG (reference:
        # NDCGMetric::Init, rank_metric.hpp)
        self.inverse_max_dcgs = np.zeros((self.num_queries,
                                          len(self.eval_at)))
        for q in range(self.num_queries):
            lo, hi = self.query_boundaries[q], self.query_boundaries[q + 1]
            for ki, k in enumerate(self.eval_at):
                m = dcg.max_dcg_at_k(k, self.label[lo:hi], self.label_gain)
                self.inverse_max_dcgs[q, ki] = 1.0 / m if m > 0 else -1.0

    def eval(self, score, objective=None) -> List[float]:
        score = np.asarray(score, dtype=np.float64)
        result = np.zeros(len(self.eval_at))
        for q in range(self.num_queries):
            lo, hi = self.query_boundaries[q], self.query_boundaries[q + 1]
            qw = 1.0 if self.query_weights is None else self.query_weights[q]
            for ki, k in enumerate(self.eval_at):
                inv = self.inverse_max_dcgs[q, ki]
                if inv < 0:
                    # no positive labels: define NDCG = 1 (reference)
                    result[ki] += qw
                else:
                    d = dcg.dcg_at_k(k, self.label[lo:hi], score[lo:hi],
                                     self.label_gain)
                    result[ki] += qw * d * inv
        return list(result / self.sum_query_weights)


class MapMetric(_RankMetric):
    factor_to_bigger_better = 1.0

    @property
    def name(self):
        return ["map@%d" % k for k in self.eval_at]

    def eval(self, score, objective=None) -> List[float]:
        score = np.asarray(score, dtype=np.float64)
        result = np.zeros(len(self.eval_at))
        for q in range(self.num_queries):
            lo, hi = self.query_boundaries[q], self.query_boundaries[q + 1]
            label = self.label[lo:hi]
            npos = int((label > 0.5).sum())
            order = np.argsort(-score[lo:hi], kind="stable")
            is_pos = (label[order] > 0.5).astype(np.float64)
            hits = np.cumsum(is_pos)
            prec = hits / np.arange(1, len(is_pos) + 1)
            qw = 1.0 if self.query_weights is None else self.query_weights[q]
            for ki, k in enumerate(self.eval_at):
                kk = min(k, len(is_pos))
                if npos > 0:
                    ap = float((prec[:kk] * is_pos[:kk]).sum()) \
                        / min(npos, kk)
                    result[ki] += qw * ap
                else:
                    result[ki] += qw
        return list(result / self.sum_query_weights)


# ---------------------------------------------------------------------------
# Cross-entropy family (reference: src/metric/xentropy_metric.hpp)
# ---------------------------------------------------------------------------
def _xent_loss(y, p):
    a = np.where(y > 0, y * np.log(np.maximum(p, kEpsilon)), 0.0)
    b = np.where(y < 1, (1.0 - y) * np.log(np.maximum(1.0 - p, kEpsilon)),
                 0.0)
    return -(a + b)


class CrossEntropyMetric(Metric):
    name = ["cross_entropy"]

    def eval(self, score, objective=None) -> List[float]:
        score = np.asarray(score, dtype=np.float64).reshape(self.label.shape)
        p = 1.0 / (1.0 + np.exp(-score))
        pt = _xent_loss(self.label, p)
        if self.weights is not None:
            pt = pt * self.weights
        return [float(pt.sum()) / self.sum_weights]


class CrossEntropyLambdaMetric(Metric):
    name = ["cross_entropy_lambda"]

    def eval(self, score, objective=None) -> List[float]:
        score = np.asarray(score, dtype=np.float64).reshape(self.label.shape)
        hhat = np.log1p(np.exp(score))
        w = np.ones_like(score) if self.weights is None else self.weights
        p = 1.0 - np.exp(-w * hhat)
        pt = _xent_loss(self.label, p)
        return [float(pt.sum()) / float(self.num_data)]


class KullbackLeiblerDivergence(Metric):
    """reference: KullbackLeiblerDivergence (xentropy_metric.hpp:240+):
    cross-entropy minus the label-entropy offset."""

    name = ["kullback_leibler"]

    def init(self, metadata, num_data: int) -> None:
        super().init(metadata, num_data)
        y = self.label
        ent = _xent_loss(y, np.clip(y, kEpsilon, 1 - kEpsilon))
        if self.weights is not None:
            ent = ent * self.weights
        self.presum_label_entropy = float(ent.sum()) / self.sum_weights

    def eval(self, score, objective=None) -> List[float]:
        score = np.asarray(score, dtype=np.float64).reshape(self.label.shape)
        p = 1.0 / (1.0 + np.exp(-score))
        pt = _xent_loss(self.label, p)
        if self.weights is not None:
            pt = pt * self.weights
        return [float(pt.sum()) / self.sum_weights
                - self.presum_label_entropy]


# ---------------------------------------------------------------------------
# Factory (reference: Metric::CreateMetric, src/metric/metric.cpp:19)
# ---------------------------------------------------------------------------
_METRICS = {
    "l1": L1Metric, "mean_absolute_error": L1Metric, "mae": L1Metric,
    "regression_l1": L1Metric,
    "l2": L2Metric, "mean_squared_error": L2Metric, "mse": L2Metric,
    "regression": L2Metric, "l2_root": RMSEMetric,
    "rmse": RMSEMetric, "root_mean_squared_error": RMSEMetric,
    "quantile": QuantileMetric,
    "huber": HuberMetric,
    "fair": FairMetric,
    "poisson": PoissonMetric,
    "mape": MAPEMetric, "mean_absolute_percentage_error": MAPEMetric,
    "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric,
    "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "average_precision": AveragePrecisionMetric,
    "auc_mu": AucMuMetric,
    "multi_logloss": MultiLoglossMetric, "multiclass": MultiLoglossMetric,
    "softmax": MultiLoglossMetric, "multiclassova": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
    "ndcg": NDCGMetric, "lambdarank": NDCGMetric,
    "rank_xendcg": NDCGMetric,
    "map": MapMetric, "mean_average_precision": MapMetric,
    "cross_entropy": CrossEntropyMetric, "xentropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "xentlambda": CrossEntropyLambdaMetric,
    "kullback_leibler": KullbackLeiblerDivergence,
    "kldiv": KullbackLeiblerDivergence,
}


def create_metric(name: str, config) -> Optional[Metric]:
    name = name.strip().lower()
    if name in ("", "none", "null", "na", "custom"):
        return None
    if name not in _METRICS:
        log.fatal("Unknown metric type name: %s" % name)
    return _METRICS[name](config)


def resolve_metric_names(config, objective_name: str) -> List[str]:
    """When no metric is given, default to the objective's metric
    (reference: Config::Set metric default handling)."""
    names = [m for m in (config.metric or []) if m]
    if names:
        return names
    if objective_name in ("custom", "none", ""):
        return []
    return [objective_name]


__all__ = ["Metric", "create_metric", "resolve_metric_names",
           "weighted_auc"]
