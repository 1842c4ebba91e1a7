"""Whether each split that the program chose was the best one open to it,
and whether every leaf keeps the configuration's floors
(``min_data_in_leaf``, ``min_sum_hessian_in_leaf``).

Candidates. The program splits a feature only at its own bin boundaries,
which the reference does not know; every threshold at which a tree of the
run splits a feature is one of them. So a feature's candidates are the
distinct thresholds at which any tree of the run splits it, and at every
internal node of every tree the reference works out, from the raw rows
routed there and their f64 gradients, the gain of every candidate of every
feature whose two sides keep the floors. ``split_gap`` is the largest
shortfall of the chosen split's gain below a candidate's, in units of the
f32 rounding that both gains carry (those of ``train_check``: a child's
path sum bounded by its parent's path sum plus the parent's own). A
candidate with a side whose hessian sum lies within ``HESS_MARGIN`` such
units of ``min_sum_hessian_in_leaf`` is left out: the program's f32 sums
may put it on either side of the floor.

``leaf_floor_gap``: over every leaf, the shortfall of its hessian sum
below ``min_sum_hessian_in_leaf`` in the same units; a leaf with fewer
rows than ``min_data_in_leaf`` reads infinite."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

U32 = 2.0 ** -24
#: units of f32 rounding kept between a candidate's side and the hessian
#: floor
HESS_MARGIN = 100.0
#: (row, feature) pairs added into the histograms in one call
_PAIRS_PER_CALL = 1 << 25


def membership(tree) -> np.ndarray:
    """[internal nodes, leaves]: 1 where the leaf lies under the node."""
    ni, nl = tree.num_leaves - 1, tree.num_leaves
    out = np.zeros((ni, nl))
    for p in range(ni - 1, -1, -1):     # children come after parents
        for c in (tree.left_child[p], tree.right_child[p]):
            if c < 0:
                out[p, ~c] = 1.0
            else:
                out[p] += out[c]
    return out


class SplitCheck:
    """Candidates of every feature from ``trees``, and each training row's
    place among them (``codes`` [n, F]: how many of the feature's
    candidates lie below the row's value, so the row goes left at
    candidate j exactly when its code is at most j)."""

    def __init__(self, X: torch.Tensor, trees: List, params: dict):
        F = X.shape[1]
        self.min_data = int(params.get("min_data_in_leaf", 20))
        self.min_hess = float(params.get("min_sum_hessian_in_leaf", 1e-3))
        self.l2 = float(params.get("lambda_l2", 0.0))
        by_f: List[List[float]] = [[] for _ in range(F)]
        plain = np.ones(F, dtype=bool)
        for t in trees:
            for f, thr, dt in zip(t.split_feature, t.threshold,
                                  t.decision_type):
                by_f[f].append(thr)
                # a NaN or zero missing type routes some values by its
                # default side: such a feature is no candidate
                plain[f] &= ((int(dt) >> 2) & 3) == 0
        self.cand = [np.unique(np.asarray(v, np.float64)) if plain[f]
                     else np.zeros(0) for f, v in enumerate(by_f)]
        K = np.array([len(c) for c in self.cand], dtype=np.int64)
        self.B = int(K.max()) + 1 if F else 1
        dev = X.device
        self.K = torch.from_numpy(K).to(dev)
        dt = torch.int16 if self.B < (1 << 15) else torch.int32
        self.codes = torch.zeros(X.shape, dtype=dt, device=dev)
        for f in range(F):
            if K[f]:
                v = X[:, f].double()
                v = torch.where(torch.isnan(v), 0.0, v).contiguous()
                c = torch.from_numpy(self.cand[f]).to(dev)
                self.codes[:, f] = torch.searchsorted(c, v).to(dt)
        self.worst: Dict = {}

    def _leaf_histograms(self, leaf: torch.Tensor, nl: int,
                         w: torch.Tensor) -> torch.Tensor:
        """[nl, F, B, 3] sums of ``w`` [n, 3] by leaf, feature and code."""
        n, F = self.codes.shape
        B = self.B
        hist = torch.zeros((nl * F * B, 3), dtype=torch.float64,
                           device=w.device)
        base = leaf * (F * B)
        fc = max(1, min(F, _PAIRS_PER_CALL // max(n, 1)))
        for f0 in range(0, F, fc):
            f1 = min(F, f0 + fc)
            off = torch.arange(f0, f1, device=w.device) * B
            idx = (base[:, None] + off[None, :]
                   + self.codes[:, f0:f1].long()).reshape(-1)
            hist.index_add_(0, idx, w[:, None, :].expand(
                n, f1 - f0, 3).reshape(-1, 3))
        return hist.view(nl, F, B, 3)

    def tree(self, t: int, tree, leaf: torch.Tensor, g: torch.Tensor,
             h: torch.Tensor, chosen: Tuple[np.ndarray, np.ndarray],
             node_sums: np.ndarray, paths: Tuple[np.ndarray, np.ndarray],
             leaf_cnt: np.ndarray, leaf_h: np.ndarray,
             leaf_ch: np.ndarray) -> Tuple[float, float]:
        """(split_gap, leaf_floor_gap) of one tree. ``chosen``: the
        reference's gain of each chosen split and its rounding scale;
        ``node_sums`` [ni, 4] (G, H, A, AH) of each internal node;
        ``paths`` (C, CH) of each internal node, itself included;
        ``leaf_cnt``, ``leaf_h``, ``leaf_ch``: each leaf's rows, hessian
        sum and hessian path sum."""
        short = np.maximum(self.min_hess - leaf_h, 0.0)
        floor = np.where(short > 0, short / np.maximum(U32 * leaf_ch,
                                                       1e-300), 0.0)
        floor = np.where(leaf_cnt < self.min_data, np.inf, floor)
        floor_gap = float(floor.max()) if floor.size else 0.0
        ni = tree.num_leaves - 1
        if ni == 0:
            return 0.0, floor_gap
        dev = g.device
        w = torch.stack([g, h, torch.ones_like(g)], dim=1)
        hist = self._leaf_histograms(leaf, tree.num_leaves, w)
        M = torch.from_numpy(membership(tree)).to(dev)
        F, B = hist.shape[1], hist.shape[2]
        node = (M @ hist.reshape(tree.num_leaves, -1)).reshape(ni, F, B, 3)
        left = node.cumsum(dim=2)
        tot = node[:, 0].sum(dim=1)                          # [ni, 3]
        GL, HL, CL = left[..., 0], left[..., 1], left[..., 2]
        GP, HP = tot[:, 0, None, None], tot[:, 1, None, None]
        CP = tot[:, 2, None, None]
        GR, HR, CR = GP - GL, HP - HL, CP - CL
        T = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a, np.float64)).to(dev)[:, None, None]
        nA, nAH = T(node_sums[:, 2]), T(node_sums[:, 3])
        nC, nCH = T(paths[0]), T(paths[1])
        g_c, sc_c = T(chosen[0]), T(chosen[1])
        cb, chb = nC + nA, nCH + nAH           # a child's path sums, bounded
        l2 = self.l2
        margin = HESS_MARGIN * U32 * chb
        j = torch.arange(B, device=dev)[None, None, :]
        ok = ((j < self.K[None, :, None])
              & (CL >= self.min_data) & (CR >= self.min_data)
              & (HL >= self.min_hess + margin)
              & (HR >= self.min_hess + margin)
              & (HL + l2 > 0) & (HR + l2 > 0))
        HLs = torch.where(ok, HL + l2, 1.0)
        HRs = torch.where(ok, HR + l2, 1.0)
        HPs = HP + l2
        gain = GL ** 2 / HLs + GR ** 2 / HRs - GP ** 2 / HPs

        def unit(G, H, c, ch):
            return 2 * G.abs() * c / H + G ** 2 * ch / H ** 2 + G ** 2 / H
        sc = U32 * (unit(GL, HLs, cb, chb) + unit(GR, HRs, cb, chb)
                    + unit(GP, HPs, nC, nCH))
        ratio = torch.where(ok, (gain - g_c) / (sc_c + sc).clamp(min=1e-300),
                            float("-inf")).reshape(ni, -1)
        best, at = ratio.max(dim=1)
        p = int(best.argmax())
        gap = max(float(best[p]), 0.0)
        if gap > self.worst.get("split_gap", 0.0):
            f, b = divmod(int(at[p]), B)
            self.worst.update(
                split_gap=gap, tree=t, node=p,
                chosen=[int(tree.split_feature[p]),
                        float(tree.threshold[p]), float(chosen[0][p])],
                better=[f, float(self.cand[f][b]),
                        float(gain.reshape(ni, -1)[p, int(at[p])])])
        return gap, floor_gap
