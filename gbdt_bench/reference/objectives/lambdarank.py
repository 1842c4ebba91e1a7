"""LambdaRank with NDCG (LightGBM's ``lambdarank``), in f64.

Per query, docs are ranked by score, descending, ties in their order in
the query (a stable sort). For each pair of docs with different labels of
which the better-ranked one is within ``lambdarank_truncation_level``:

    dndcg = |gain_hi - gain_lo| |disc(rank_hi) - disc(rank_lo)| / maxDCG@trunc
            (divided by 0.01 + |s_hi - s_lo| under lambdarank_norm, unless
             every score of the query is equal)
    p     = 1 / (1 + exp(sigma (s_hi - s_lo)))
    grad_hi -= sigma dndcg p, grad_lo += sigma dndcg p
    hess_hi, hess_lo += sigma^2 dndcg p (1 - p)

gain = 2^label - 1, disc(r) = 1 / log2(2 + r). Under lambdarank_norm each
query's gradients and hessians are then scaled by log2(1 + S) / S, S the
sum of 2 sigma dndcg p over its pairs. Queries are taken in batches of
similar length, padded, so that a batch holds at most ``_PAIRS`` pairs.
"""
from __future__ import annotations

import numpy as np
import torch

_PAIRS = 1 << 24


class Objective:
    def __init__(self, label: np.ndarray, group, params: dict,
                 device: torch.device):
        if group is None:
            raise ValueError("lambdarank needs query sizes")
        self.sigmoid = float(params.get("sigmoid", 1.0))
        self.trunc = int(params.get("lambdarank_truncation_level", 30))
        self.norm = bool(params.get("lambdarank_norm", True))
        label = np.asarray(label, dtype=np.int64)
        sizes = np.asarray(group, dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        self.n = int(sizes.sum())
        self.device = device
        gain = np.exp2(label.astype(np.float64)) - 1.0
        # batches of queries of similar length
        order = np.argsort(sizes, kind="stable")
        self.batches = []
        i = 0
        while i < len(order):
            L = int(sizes[order[i]])
            j = i + 1
            while j < len(order):
                Lj = int(sizes[order[j]])
                if (j - i + 1) * Lj * Lj > _PAIRS:
                    break
                L = Lj
                j += 1
            qs = order[i:j]
            pos = np.arange(L)[None, :]
            valid = pos < sizes[qs][:, None]
            idx = np.where(valid, starts[qs][:, None] + pos, self.n)
            g = np.where(valid, np.append(gain, 0.0)[idx], 0.0)
            self.batches.append((torch.from_numpy(idx).to(device),
                                 torch.from_numpy(valid).to(device),
                                 torch.from_numpy(g).to(device),
                                 torch.from_numpy(self._inv_max_dcg(g))
                                 .to(device)))
            i = j

    def _inv_max_dcg(self, g: np.ndarray) -> np.ndarray:
        k = min(self.trunc, g.shape[1])
        best = -np.sort(-g, axis=1)[:, :k]
        disc = 1.0 / np.log2(2.0 + np.arange(k))
        m = (best * disc).sum(axis=1)
        return np.where(m > 0, 1.0 / np.where(m > 0, m, 1.0), 0.0)

    def init_score(self) -> float:
        return 0.0

    def gradients(self, score: torch.Tensor):
        dev = score.device
        pad = torch.cat([score, score.new_zeros(1)])
        outs = [score.new_zeros(self.n + 1) for _ in range(4)]
        for idx, valid, gain, inv in self.batches:
            B, L = idx.shape
            s = torch.where(valid, pad[idx], float("-inf"))
            order = torch.argsort(-s, dim=1, stable=True)
            rank = torch.empty_like(order)
            rank.scatter_(1, order, torch.arange(L, device=dev)
                          .expand(B, L).contiguous())
            disc = 1.0 / torch.log2(2.0 + rank.double())
            hi_lo = ((gain[:, :, None] > gain[:, None, :])
                     & valid[:, :, None] & valid[:, None, :]
                     & (torch.minimum(rank[:, :, None], rank[:, None, :])
                        < self.trunc))
            sv = torch.where(valid, s, 0.0)
            ds = sv[:, :, None] - sv[:, None, :]
            dndcg = ((gain[:, :, None] - gain[:, None, :]).abs()
                     * (disc[:, :, None] - disc[:, None, :]).abs()
                     * inv[:, None, None])
            if self.norm:
                smax = torch.where(valid, sv, float("-inf")).amax(dim=1)
                smin = torch.where(valid, sv, float("inf")).amin(dim=1)
                spread = (smax != smin)[:, None, None]
                dndcg = torch.where(spread, dndcg / (0.01 + ds.abs()), dndcg)
            p = 1.0 / (1.0 + torch.exp(self.sigmoid * ds))
            lam = torch.where(hi_lo, self.sigmoid * dndcg * p, 0.0)
            hes = torch.where(hi_lo, self.sigmoid ** 2 * dndcg * p * (1 - p),
                              0.0)
            # rows (dim 1) are the better-labelled doc of each pair
            grad = lam.sum(dim=1) - lam.sum(dim=2)
            gabs = lam.sum(dim=1) + lam.sum(dim=2)
            hess = hes.sum(dim=1) + hes.sum(dim=2)
            if self.norm:
                S = 2.0 * lam.sum(dim=(1, 2))
                f = torch.where(S > 0, torch.log2(1.0 + S)
                                / torch.where(S > 0, S, 1.0), 1.0)[:, None]
                grad, gabs, hess = grad * f, gabs * f, hess * f
            for out, v in zip(outs, (grad, hess, gabs, hess)):
                out.index_put_((idx.reshape(-1),), v.reshape(-1))
        g, h, ga, ha = (o[:self.n] for o in outs)
        return g, h, ga, ha
