"""Route raw rows through trees by their thresholds (LightGBM's numerical
decision: a value at or below the threshold goes left; a NaN goes by the
split's missing type; zero as missing within 1e-35).

Everything here works on any torch device and in the rows' own dtype;
the comparison with a threshold is made in f64."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .model_text import PlainTree

_DEFAULT_LEFT = 2
_ZERO_THRESHOLD = 1e-35


def _go_left(v: torch.Tensor, thr: torch.Tensor, dtype: torch.Tensor
             ) -> torch.Tensor:
    """``v`` f64 values of the split features, ``thr`` f64 thresholds,
    ``dtype`` each split's decision type (bit 1 default left, bits 2-3
    the missing type: 0 none, 1 zero, 2 NaN)."""
    missing = (dtype >> 2) & 3
    default_left = (dtype & _DEFAULT_LEFT) != 0
    isnan = torch.isnan(v)
    v = torch.where(isnan & (missing != 2), torch.zeros_like(v), v)
    left = v <= thr
    left = torch.where((missing == 1) & (v.abs() <= _ZERO_THRESHOLD),
                       default_left, left)
    return torch.where((missing == 2) & isnan, default_left, left)


def route(X: torch.Tensor, tree: PlainTree) -> torch.Tensor:
    """[n] int64 leaf index of each row of ``X`` [n, F]."""
    n = X.shape[0]
    dev = X.device
    if tree.num_leaves == 1:
        return torch.zeros(n, dtype=torch.int64, device=dev)
    sf = torch.from_numpy(tree.split_feature).to(dev)
    th = torch.from_numpy(tree.threshold).to(dev)
    dt = torch.from_numpy(tree.decision_type).to(dev)
    lc = torch.from_numpy(tree.left_child).to(dev)
    rc = torch.from_numpy(tree.right_child).to(dev)
    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev)
    # every row of ``rows`` sits at an internal node ``cur``; rows leave
    # the list when they reach a leaf
    leaf = torch.empty(n, dtype=torch.int64, device=dev)
    while rows.numel():
        v = X[rows, sf[cur]].double()
        nxt = torch.where(_go_left(v, th[cur], dt[cur]), lc[cur], rc[cur])
        done = nxt < 0
        leaf[rows[done]] = ~nxt[done]
        keep = ~done
        rows, cur = rows[keep], nxt[keep]
    return leaf


class StackedTrees:
    """All trees of a forest padded into [T, nodes] tensors, for a walk of
    every tree at once."""

    def __init__(self, trees: Sequence[PlainTree], device: torch.device):
        T = len(trees)
        ni = max(max(t.num_leaves - 1, 1) for t in trees)
        nl = max(t.num_leaves for t in trees)
        sf = np.zeros((T, ni), np.int64)
        th = np.zeros((T, ni), np.float64)
        dt = np.zeros((T, ni), np.int64)
        # a one-leaf tree: both children of its dummy root are leaf 0
        lc = np.full((T, ni), -1, np.int64)
        rc = np.full((T, ni), -1, np.int64)
        lv = np.zeros((T, nl), np.float64)
        for i, t in enumerate(trees):
            k = t.num_leaves - 1
            sf[i, :k], th[i, :k], dt[i, :k] = (t.split_feature, t.threshold,
                                               t.decision_type)
            lc[i, :k], rc[i, :k] = t.left_child, t.right_child
            lv[i, :t.num_leaves] = t.leaf_value
        to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        self.sf, self.th, self.dt = to(sf), to(th), to(dt)
        self.lc, self.rc, self.leaf_value = to(lc), to(rc), to(lv)
        self.T = T

    def leaves(self, X: torch.Tensor) -> torch.Tensor:
        """[T, n] leaf index of each row in each tree."""
        n = X.shape[0]
        dev = X.device
        cur = torch.zeros((self.T, n), dtype=torch.int64, device=dev)
        tix = torch.arange(self.T, device=dev)[:, None]
        active = torch.ones((self.T, n), dtype=torch.bool, device=dev)
        while bool(active.any()):
            node = cur.clamp(min=0)
            feat = self.sf[tix, node]
            v = X.t()[feat, torch.arange(n, device=dev)[None, :]].double()
            left = _go_left(v, self.th[tix, node], self.dt[tix, node])
            nxt = torch.where(left, self.lc[tix, node], self.rc[tix, node])
            cur = torch.where(active, nxt, cur)
            active = cur >= 0
        return ~cur

    def raw_sum(self, X: torch.Tensor) -> torch.Tensor:
        """[n] f64 sum of every tree's leaf value, added in tree order."""
        lv = self.leaf_value.gather(1, self.leaves(X))
        out = torch.zeros(X.shape[0], dtype=torch.float64, device=X.device)
        for t in range(self.T):
            out += lv[t]
        return out


def replay_f32(leaves: List[torch.Tensor], values: List[np.ndarray],
               start: torch.Tensor) -> torch.Tensor:
    """An f32 score maintained as the program keeps one: ``start`` plus,
    tree by tree, each leaf's value rounded to f32."""
    score = start.clone()
    for leaf, v in zip(leaves, values):
        score += torch.from_numpy(v.astype(np.float32)).to(
            score.device)[leaf]
    return score
