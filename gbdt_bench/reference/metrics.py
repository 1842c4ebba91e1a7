"""Held-out metrics in f64: AUC (ties at half credit) and NDCG@k (docs
ranked by score, descending, ties in query order; a query whose best DCG
is 0 counts 1)."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def auc(label: np.ndarray, score: np.ndarray) -> float:
    pos = np.asarray(label) > 0
    s = np.asarray(score, dtype=np.float64)
    uniq, inv = np.unique(s, return_inverse=True)
    n_pos = np.bincount(inv, weights=pos.astype(np.float64),
                        minlength=len(uniq))
    n_neg = np.bincount(inv, weights=(~pos).astype(np.float64),
                        minlength=len(uniq))
    # negatives strictly below each score group, plus half of its own
    below = np.concatenate([[0.0], np.cumsum(n_neg)[:-1]])
    total = float(n_pos.sum()) * float(n_neg.sum())
    if total == 0:
        return 1.0
    return float((n_pos * (below + 0.5 * n_neg)).sum() / total)


def ndcg(label: np.ndarray, score: np.ndarray, group: np.ndarray,
         ks: Sequence[int]) -> Dict[int, float]:
    label = np.asarray(label, dtype=np.int64)
    score = np.asarray(score, dtype=np.float64)
    gain = np.exp2(label.astype(np.float64)) - 1.0
    out = {k: 0.0 for k in ks}
    lo = 0
    sizes = np.asarray(group, dtype=np.int64)
    for n in sizes:
        hi = lo + int(n)
        g = gain[lo:hi]
        ranked = g[np.argsort(-score[lo:hi], kind="stable")]
        best = -np.sort(-g)
        for k in ks:
            m = min(k, n)
            disc = 1.0 / np.log2(2.0 + np.arange(m))
            ideal = float((best[:m] * disc).sum())
            out[k] += (float((ranked[:m] * disc).sum()) / ideal
                       if ideal > 0 else 1.0)
        lo = hi
    return {k: v / len(sizes) for k, v in out.items()}
