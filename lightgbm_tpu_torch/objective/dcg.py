"""DCG/NDCG math shared by the lambdarank objective and the ndcg metric.

Port (a copy: host NumPy) of ``lightgbm_tpu/objective/dcg.py``, the
reference's ``DCGCalculator``
(reference: include/LightGBM/metric.h:68, src/metric/dcg_calculator.cpp):
label gain table (default 2^l - 1), position discounts 1/log2(2 + rank),
and max-DCG@k over a label multiset.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..utils import log


def default_label_gain(num: int = 31) -> np.ndarray:
    """2^i - 1 (reference: DCGCalculator::DefaultLabelGain,
    src/metric/dcg_calculator.cpp:33)."""
    return (2.0 ** np.arange(num)) - 1.0


def resolve_label_gain(config_label_gain: Sequence[float]) -> np.ndarray:
    if config_label_gain:
        return np.asarray(config_label_gain, dtype=np.float64)
    return default_label_gain()


def discounts(n: int) -> np.ndarray:
    """1/log2(2 + i) for rank i (reference: DCGCalculator::Init)."""
    return 1.0 / np.log2(2.0 + np.arange(n))


def check_label(label: np.ndarray, num_gains: int) -> None:
    li = label.astype(np.int64)
    if not np.allclose(li, label):
        log.fatal("label should be int type (met %f) for ranking task"
                  % float(label[np.argmax(li != label)]))
    if li.min() < 0:
        log.fatal("Label should be >= 0 in ranking task")
    if li.max() >= num_gains:
        log.fatal("Label %d is not less than the number of label mappings "
                  "(%d)" % (int(li.max()), num_gains))


def max_dcg_at_k(k: int, label: np.ndarray, label_gain: np.ndarray) -> float:
    """Max achievable DCG@k: labels sorted descending (reference:
    DCGCalculator::CalMaxDCGAtK, src/metric/dcg_calculator.cpp:54)."""
    n = len(label)
    k = min(k, n)
    if k <= 0:
        return 0.0
    top = np.sort(label.astype(np.int64))[::-1][:k]
    return float((discounts(k) * label_gain[top]).sum())


def dcg_at_k(k: int, label: np.ndarray, score: np.ndarray,
             label_gain: np.ndarray) -> float:
    """DCG@k of a scored ranking (reference: DCGCalculator::CalDCGAtK).
    Ties broken by stable argsort of descending score, matching the
    reference's stable partial sort."""
    n = len(label)
    k = min(k, n)
    if k <= 0:
        return 0.0
    order = np.argsort(-score, kind="stable")[:k]
    top = label.astype(np.int64)[order]
    return float((discounts(k) * label_gain[top]).sum())
