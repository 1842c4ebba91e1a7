"""Learning-to-rank objectives: LambdarankNDCG and RankXENDCG.

Port of ``lightgbm_tpu/objective/rank.py`` (reference:
src/objective/rank_objective.hpp:25 RankingObjective, :96
LambdarankNDCG, :285 RankXENDCG). Queries are laid out as a padded
[Q, L] index (:class:`QueryLayout`; pad slots point at row N, one past
the end). Lambdarank's pairwise [L, L] lambdas go in batches of
``_QUERY_CHUNK`` consecutive queries, as the reference's ``lax.map``
does, each batch cut to the longest query in it, so that the peak
memory is at most chunk * L^2; rank_xendcg takes all queries in one
batch over the full [Q, L] layout, where its uniforms are drawn.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..utils import log
from ..utils.prng import PRNGKey, split, uniform
from . import dcg
from .base import ObjectiveFunction, apply_weight

_QUERY_CHUNK = 64
_NEG_INF = -1e30


class QueryLayout:
    """Padded [Q, L] view of ragged per-query rows.

    ``doc_idx[q, j]`` indexes the flat row space; padding slots point at
    row N (one past the end), so gathers read a pad row and scatters
    write a discarded slot."""

    def __init__(self, query_boundaries: np.ndarray, num_data: int,
                 device: torch.device):
        qb = np.asarray(query_boundaries, dtype=np.int64)
        self.num_queries = len(qb) - 1
        self.counts = (qb[1:] - qb[:-1]).astype(np.int32)
        self.max_len = int(self.counts.max()) if self.num_queries else 0
        Q, L = self.num_queries, self.max_len
        pos = np.arange(L, dtype=np.int64)[None, :]
        doc_idx = np.where(pos < self.counts[:, None], qb[:-1, None] + pos,
                           num_data)
        self.doc_idx = torch.from_numpy(doc_idx).to(device)
        self.mask = torch.from_numpy(pos < self.counts[:, None]).to(device)
        self.num_data = num_data

    def chunks(self, chunk: int) -> List[Tuple[int, int, int]]:
        """(first query, end query, longest query length) of each batch
        of ``chunk`` consecutive queries."""
        return [(q, min(q + chunk, self.num_queries),
                 int(self.counts[q:q + chunk].max()))
                for q in range(0, self.num_queries, chunk)]


def _scatter_rows(values: torch.Tensor, doc_idx: torch.Tensor,
                  out: torch.Tensor) -> None:
    """out[doc_idx] = values: every real row appears once in the
    layout; the pad slot N takes the pads' zeros."""
    out.index_put_((doc_idx.reshape(-1),), values.reshape(-1))


class LambdarankNDCG(ObjectiveFunction):
    """reference: rank_objective.hpp:96. Per query, for each doc pair with
    different labels where the better-ranked doc is above
    ``lambdarank_truncation_level``:

        delta_ndcg = |gain_hi - gain_lo| * |disc(rank_hi) - disc(rank_lo)|
                     * inv_max_dcg            (normed by 0.01+|ds| if norm)
        p = 1 / (1 + exp(sigmoid * (s_hi - s_lo)))
        lambda_hi -= sigmoid * delta_ndcg * p   (lambda_lo gets +)
        hess_both += sigmoid^2 * delta_ndcg * p * (1 - p)

    then the query's lambdas are rescaled by log2(1+S)/S where
    S = sum of 2*sigmoid*delta_ndcg*p (the reference's sum_lambdas)."""

    name = "lambdarank"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0.0:
            log.fatal("Sigmoid param %f should be greater than zero"
                      % self.sigmoid)
        self.norm = bool(config.lambdarank_norm)
        self.truncation_level = int(config.lambdarank_truncation_level)
        self.label_gain = dcg.resolve_label_gain(config.label_gain)

    def init(self, metadata, num_data: int,
             device: torch.device = torch.device("cpu")) -> None:
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            log.fatal("Ranking tasks require query information")
        label_np = np.asarray(metadata.label)
        dcg.check_label(label_np, len(self.label_gain))
        self.layout = QueryLayout(metadata.query_boundaries, num_data,
                                  device)
        qb = np.asarray(metadata.query_boundaries)
        inv = np.zeros(self.layout.num_queries, dtype=np.float64)
        for q in range(self.layout.num_queries):
            m = dcg.max_dcg_at_k(self.truncation_level,
                                 label_np[qb[q]:qb[q + 1]], self.label_gain)
            inv[q] = 1.0 / m if m > 0.0 else 0.0
        self.inverse_max_dcgs = torch.from_numpy(
            inv.astype(np.float32)).to(device)
        self.gain_table = torch.from_numpy(
            self.label_gain.astype(np.float32)).to(device)
        self.discount_table = torch.from_numpy(
            dcg.discounts(max(self.layout.max_len, 1)).astype(np.float32)
        ).to(device)
        zero = torch.zeros(1, dtype=torch.float32, device=device)
        self.labels_pad = torch.cat([self.label, zero])[self.layout.doc_idx]
        self._chunks = self.layout.chunks(_QUERY_CHUNK)

    def _chunk_lambdas(self, labels: torch.Tensor, scores: torch.Tensor,
                       mask: torch.Tensor, inv_max_dcg: torch.Tensor):
        """Lambdas and hessians of a batch of queries over padded
        [B, L] arrays (the reference's ``_query_lambdas``, one query per
        row)."""
        B, L = labels.shape
        s = torch.where(mask, scores, _NEG_INF)
        # rank of each doc in descending-score order (stable)
        order = torch.argsort(-s, dim=1, stable=True)
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(L, device=s.device)
                      .expand(B, L).contiguous())
        discount = self.discount_table[rank.clamp(0, L - 1)]
        gain = self.gain_table[labels.long().clamp(
            0, self.gain_table.shape[0] - 1)]
        best_score = s.max(dim=1).values
        # worst valid score (the reference skips kMinScore docs)
        worst_score = torch.where(mask, scores, float("inf")).min(
            dim=1).values
        # a = high candidate (dim 1), b = low candidate (dim 2)
        is_pair = ((labels[:, :, None] > labels[:, None, :])
                   & mask[:, :, None] & mask[:, None, :])
        is_pair &= torch.minimum(rank[:, :, None], rank[:, None, :]) \
            < self.truncation_level
        delta_score = s[:, :, None] - s[:, None, :]
        dcg_gap = gain[:, :, None] - gain[:, None, :]
        paired_discount = torch.abs(discount[:, :, None]
                                    - discount[:, None, :])
        delta_ndcg = dcg_gap * paired_discount * inv_max_dcg[:, None, None]
        del dcg_gap, paired_discount
        if self.norm:
            delta_ndcg = torch.where(
                (best_score != worst_score)[:, None, None],
                delta_ndcg / (0.01 + torch.abs(delta_score)), delta_ndcg)
        p = 1.0 / (1.0 + torch.exp(
            torch.clamp(self.sigmoid * delta_score, -50.0, 50.0)))
        del delta_score
        lam = torch.where(is_pair, self.sigmoid * delta_ndcg * p, 0.0)
        hes = torch.where(is_pair, self.sigmoid * self.sigmoid * delta_ndcg
                          * p * (1.0 - p), 0.0)
        del is_pair, delta_ndcg, p
        # the high doc's gradient decreases (descent pushes its score
        # up): rows of ``lam`` (dim 1) are the high role
        lambdas = lam.sum(dim=1) - lam.sum(dim=2)
        hessians = hes.sum(dim=2) + hes.sum(dim=1)
        if self.norm:
            sum_lambdas = 2.0 * lam.sum(dim=(1, 2))
            norm_factor = torch.where(
                sum_lambdas > 0,
                torch.log2(1.0 + sum_lambdas)
                / torch.clamp(sum_lambdas, min=1e-30), 1.0)
            lambdas = lambdas * norm_factor[:, None]
            hessians = hessians * norm_factor[:, None]
        return lambdas, hessians

    def get_gradients(self, score: torch.Tensor):
        N = score.shape[0]
        lay = self.layout
        score_pad = torch.cat([score, score.new_zeros(1)])
        grad = score.new_zeros(N + 1)
        hess = score.new_zeros(N + 1)
        for q0, q1, Lc in self._chunks:
            idx = lay.doc_idx[q0:q1, :Lc]
            lam, hes = self._chunk_lambdas(
                self.labels_pad[q0:q1, :Lc], score_pad[idx],
                lay.mask[q0:q1, :Lc], self.inverse_max_dcgs[q0:q1])
            _scatter_rows(lam, idx, grad)
            _scatter_rows(hes, idx, hess)
        grad, hess = grad[:N], hess[:N]
        return apply_weight(grad, hess, self.weights)


class RankXENDCG(ObjectiveFunction):
    """XE_NDCG (reference: rank_objective.hpp:285; arXiv:1911.09798):
    per query, rho = softmax(scores); targets phi_i = 2^label_i - u_i with
    u ~ U[0, 1) drawn anew every call (from a key split off the
    objective's key, as ``jax.random.split`` does); three-term gradient
    expansion and hess = rho(1-rho)."""

    name = "rank_xendcg"

    def __init__(self, config):
        super().__init__(config)
        self.seed = int(config.objective_seed)

    @property
    def has_stochastic_gradients(self) -> bool:
        return True

    def init(self, metadata, num_data: int,
             device: torch.device = torch.device("cpu")) -> None:
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            log.fatal("Ranking tasks require query information")
        self.layout = QueryLayout(metadata.query_boundaries, num_data,
                                  device)
        zero = torch.zeros(1, dtype=torch.float32, device=device)
        self.labels_pad = torch.cat([self.label, zero])[self.layout.doc_idx]
        self._key = PRNGKey(self.seed, device)

    def get_gradients(self, score: torch.Tensor):
        N = score.shape[0]
        lay = self.layout
        self._key, sub = split(self._key)
        unif = uniform(sub, tuple(lay.doc_idx.shape))
        mask = lay.mask
        scores = torch.cat([score, score.new_zeros(1)])[lay.doc_idx]
        s = torch.where(mask, scores, _NEG_INF)
        e = torch.exp(s - s.max(dim=1, keepdim=True).values)
        rho = torch.where(mask, e / e.sum(dim=1, keepdim=True), 0.0)
        cnt = mask.sum(dim=1, keepdim=True)
        phi = torch.where(mask, torch.pow(2.0, self.labels_pad) - unif, 0.0)
        inv_denominator = 1.0 / torch.clamp(phi.sum(dim=1, keepdim=True),
                                            min=1e-12)
        l1 = -phi * inv_denominator + rho
        one_minus_rho = torch.clamp(1.0 - rho, min=1e-12)
        params1 = torch.where(mask, l1 / one_minus_rho, 0.0)
        l2 = rho * (params1.sum(dim=1, keepdim=True) - params1)
        params2 = torch.where(mask, l2 / one_minus_rho, 0.0)
        lambdas = l1 + l2 + rho * (params2.sum(dim=1, keepdim=True)
                                   - params2)
        hessians = rho * (1.0 - rho)
        ok = mask & (cnt > 1)
        grad = score.new_zeros(N + 1)
        hess = score.new_zeros(N + 1)
        _scatter_rows(torch.where(ok, lambdas, 0.0), lay.doc_idx, grad)
        _scatter_rows(torch.where(ok, hessians, 0.0), lay.doc_idx, hess)
        grad, hess = grad[:N], hess[:N]
        return apply_weight(grad, hess, self.weights)
