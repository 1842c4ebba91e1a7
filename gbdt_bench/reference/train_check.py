"""The comparison that decides a training cell's ``correct``.

The reference follows the program tree by tree, from the program's own
trees (its model text): it routes the raw training rows through each tree
by its thresholds, rebuilds the f32 training score the program keeps,
works out the objective's gradients from that score in f64, and from the
rows in each leaf the leaf's sums, its value and each split's gain. It
compares:

- ``tree_gap``: boosting iterations run against trees in the model;
- ``count_gap``: each leaf's and node's row count against the rows the
  reference routes there (this covers the binning: the routing uses the
  raw values, the program its bins);
- ``score_gap``: the program's final f32 training score against the
  reference's replay of it (f32 leaf values added tree by tree);
- ``leaf_gap`` and ``gain_gap``: each leaf value and each split's gain
  against the reference's, in units of the f32 rounding that the sums
  behind them carry (below);
- ``split_gap`` and ``leaf_floor_gap``: whether each chosen split was
  the best one open to the program, and whether every leaf keeps the
  configuration's floors (``split_check.py``);
- ``eval_gap``: the program's held-out metric against the reference's,
  from the reference's own walk of the held-out rows.

Units of ``leaf_gap`` and ``gain_gap``. The program sums f32 gradients
into f32 histograms and takes a larger child's histogram as its parent's
less its sibling's, so a leaf's gradient sum carries the rounding of
every histogram on its path from the root: up to u (the f32 unit
roundoff) times C, the sum over that path of each node's sum of absolute
gradient terms. Where the gradients of a leaf cancel, as lambdarank's do
(they sum to zero over each query), C is many times the leaf's own
gradient sum. A leaf value v = -lr G / (H + l2) is therefore held to
u lr (C / (H + l2) + |G| CH / (H + l2)^2) + u |v|, CH the same path sum of
hessians; a gain G_L^2 / H_L + G_R^2 / H_R - G_P^2 / H_P to
u sum over L, R, P of (2 |G| C / H + G^2 CH / H^2 + G^2 / H).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import metrics as ref_metrics
from .model_text import parse_model
from .objectives import objective_for
from .split_check import SplitCheck
from .walk import replay_f32, route

U32 = 2.0 ** -24
K_EPSILON = 1e-15
_UNSUPPORTED = ("lambda_l1", "max_delta_step", "path_smooth",
                "min_gain_to_split")


def _ratio(gap: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """gap / scale, where a gap that is not a number, or not 0 over a
    scale of 0, reads infinite."""
    gap = np.where(np.isnan(gap), np.inf, gap)
    out = np.where(gap > 0, np.inf, 0.0)
    np.divide(gap, scale, out=out, where=scale > 0)
    return out


def _tree_sums(leaf: torch.Tensor, nl: int, gh: Optional[torch.Tensor]):
    """Per leaf: row count, and with ``gh`` [N, 4] the sums of its
    columns (grad, hess, |grad| terms, |hess| terms) in f64."""
    count = torch.bincount(leaf, minlength=nl).cpu().numpy()
    if gh is None:
        return count, None
    s = torch.zeros((nl, gh.shape[1]), dtype=torch.float64,
                    device=gh.device)
    s.index_add_(0, leaf, gh)
    return count, s.cpu().numpy()


def _node_totals(tree, leaf_vals: np.ndarray) -> np.ndarray:
    """Sums of ``leaf_vals`` [nl, k] over each internal node's leaves."""
    ni = tree.num_leaves - 1
    out = np.zeros((ni,) + leaf_vals.shape[1:], dtype=leaf_vals.dtype)
    for p in range(ni - 1, -1, -1):     # children come after parents
        for c in (tree.left_child[p], tree.right_child[p]):
            out[p] += leaf_vals[~c] if c < 0 else out[c]
    return out


def _path_sums(tree, node_v: np.ndarray, leaf_v: np.ndarray):
    """Sum of ``node_v`` / ``leaf_v`` over each node's and each leaf's
    path from the root, itself included."""
    ni = tree.num_leaves - 1
    node_c = np.array(node_v, dtype=np.float64, copy=True)
    leaf_c = np.array(leaf_v, dtype=np.float64, copy=True)
    for p in range(ni):
        for c in (tree.left_child[p], tree.right_child[p]):
            if c < 0:
                leaf_c[~c] += node_c[p]
            else:
                node_c[c] += node_c[p]
    return node_c, leaf_c


class TrainCheck:
    """Accumulates the numbers of one run's trees; ``numbers()`` gives
    each compared number, ``worst`` the leaf and split behind the largest
    ``leaf_gap`` and ``gain_gap``."""

    def __init__(self, collect: bool = False):
        self.n = {"tree_gap": 0.0, "count_gap": 0.0, "score_gap": 0.0,
                  "leaf_gap": 0.0, "gain_gap": 0.0, "split_gap": 0.0,
                  "leaf_floor_gap": 0.0, "eval_gap": 0.0}
        self.worst: Dict[str, Dict] = {}
        #: with ``collect``, per leaf and per split: (rows, relative gap,
        #: A / |G|, C / |G|, the gap in the units above)
        self.leaves: Optional[List] = [] if collect else None
        self.splits: Optional[List] = [] if collect else None

    def _leaf_and_gain(self, t: int, tree, cnt, sums, lr, l2, bias):
        """Reads ``leaf_gap`` and ``gain_gap`` of one tree; returns what
        the split check takes of it: each chosen split's gain and its
        rounding scale, the nodes' sums and path sums, and each leaf's
        hessian path sum (None for a one-leaf tree)."""
        G, H, A, AH = (sums[:, i] for i in range(4))
        ni = tree.num_leaves - 1
        if ni == 0:
            return None
        node = _node_totals(tree, sums)
        nG, nH, nA, nAH = (node[:, i] for i in range(4))
        nC, lC = _path_sums(tree, nA, A)
        nCH, lCH = _path_sums(tree, nAH, AH)
        Hl = H + l2
        v_ref = -lr * G / Hl
        gap = np.abs(tree.leaf_value - bias - v_ref)
        scale = (lr * U32 * (lC / Hl + np.abs(G) * lCH / Hl ** 2)
                 + U32 * np.abs(v_ref))
        r = _ratio(gap, scale)
        if self.leaves is not None:
            absG = np.maximum(np.abs(G), 1e-300)
            rel = gap / np.maximum(np.abs(v_ref), 1e-300)
            self.leaves += list(zip(cnt, rel, A / absG, lC / absG, r))
        i = int(np.argmax(r))
        if r[i] > self.n["leaf_gap"]:
            self.n["leaf_gap"] = float(r[i])
            self.worst["leaf"] = {
                "tree": t, "leaf": i, "rows": int(cnt[i]),
                "grad_sum": float(G[i]), "abs_grad_sum": float(A[i]),
                "path_abs_grad_sum": float(lC[i]),
                "hess_sum": float(H[i]), "value": float(tree.leaf_value[i]),
                "value_ref": float(v_ref[i] + bias),
                "rel_gap": float(gap[i] / max(abs(v_ref[i]), 1e-300)),
                "cancel": float(A[i] / max(abs(G[i]), 1e-300))}

        def side(c):
            return (sums[~c] if c < 0 else node[c]), \
                ((lC[~c], lCH[~c]) if c < 0 else (nC[c], nCH[c]))

        g_c, sc_c = np.zeros(ni), np.zeros(ni)
        for p in range(ni):
            parts = [(node[p], (nC[p], nCH[p])),
                     side(tree.left_child[p]), side(tree.right_child[p])]
            lg = [s[0] ** 2 / (s[1] + l2) for s, _ in parts]
            g_ref = lg[1] + lg[2] - lg[0]
            sc = U32 * sum(2 * abs(s[0]) * c / (s[1] + l2)
                           + s[0] ** 2 * ch / (s[1] + l2) ** 2
                           + s[0] ** 2 / (s[1] + l2)
                           for s, (c, ch) in parts)
            g_c[p], sc_c[p] = g_ref, sc
            d = abs(tree.split_gain[p] - g_ref)
            r = float(_ratio(np.array([d]), np.array([sc]))[0])
            if self.splits is not None:
                self.splits.append((int(tree.internal_count[p]),
                                    d / max(abs(g_ref), 1e-300), sc / U32
                                    / max(abs(g_ref), 1e-300), r))
            if r > self.n["gain_gap"]:
                self.n["gain_gap"] = r
                self.worst["gain"] = {
                    "tree": t, "node": p, "rows": int(tree.internal_count[p]),
                    "gain": float(tree.split_gain[p]), "gain_ref": g_ref,
                    "rel_gap": d / max(abs(g_ref), 1e-300),
                    "parent_grad_sum": float(nG[p]),
                    "parent_abs_grad_sum": float(nA[p]),
                    "parent_path_abs_grad_sum": float(nC[p])}
        return (g_c, sc_c), node, (nC, nCH), lCH

    def run(self, X: torch.Tensor, label: np.ndarray, group,
            params: dict, model_text: str, train_score: np.ndarray,
            iterations: int, held_out: Optional[dict] = None) -> "TrainCheck":
        """``X`` the raw training rows [N, F] on the device the reference
        runs on; ``train_score`` the program's final f32 score [N];
        ``held_out`` {X, label, group, metrics: the program's values}."""
        for k in _UNSUPPORTED:
            if float(params.get(k, 0.0)) != 0.0:
                raise ValueError("%s != 0 is outside this reference" % k)
        model = parse_model(model_text)
        trees = model["trees"]
        dev = X.device
        obj = objective_for(params["objective"])(label, group, params, dev)
        lr = float(params["learning_rate"])
        l2 = float(params.get("lambda_l2", 0.0))
        init = (obj.init_score() if params.get("boost_from_average", True)
                else 0.0)
        if abs(init) <= K_EPSILON:
            init = 0.0
        self.n["tree_gap"] = float(abs(len(trees) - iterations))
        splits = SplitCheck(X, trees, params)
        score = torch.full((X.shape[0],), float(np.float32(init)),
                           dtype=torch.float32, device=dev)
        for t, tree in enumerate(trees):
            bias = init if t == 0 else 0.0
            leaf = route(X, tree)
            g, h, ga, ha = obj.gradients(score.double())
            cnt, sums = _tree_sums(leaf, tree.num_leaves,
                                   torch.stack([g, h, ga, ha], dim=1))
            cgap = np.abs(cnt - tree.leaf_count).max()
            if tree.num_leaves > 1:
                node_cnt = _node_totals(tree, cnt.astype(np.int64))
                cgap = max(cgap, np.abs(node_cnt - tree.internal_count).max())
            self.n["count_gap"] = max(self.n["count_gap"], float(cgap))
            got = self._leaf_and_gain(t, tree, cnt, sums, lr, l2, bias)
            if got is None:
                chosen, node, paths = None, None, None
                lch = sums[:, 3]
            else:
                chosen, node, paths, lch = got
            sg, fg = splits.tree(t, tree, leaf, g, h, chosen, node, paths,
                                 cnt, sums[:, 1], lch)
            self.n["split_gap"] = max(self.n["split_gap"], sg)
            self.n["leaf_floor_gap"] = max(self.n["leaf_floor_gap"], fg)
            score += torch.from_numpy(
                (tree.leaf_value - bias).astype(np.float32)).to(dev)[leaf]
        if splits.worst:
            self.worst["split"] = splits.worst
        k = splits.K.cpu().numpy()
        self.worst["candidates_per_feature"] = [
            int(k.min()), float(np.median(k)), int(k.max())]
        if trees:
            self.worst["leaves_per_tree"] = [
                min(t.num_leaves for t in trees),
                max(t.num_leaves for t in trees)]
        del splits
        prog = torch.from_numpy(np.asarray(train_score, np.float32)).to(dev)
        self.n["score_gap"] = float((score - prog).abs().max())
        if held_out is not None:
            self._held_out(trees, params, held_out)
        return self

    def _held_out(self, trees: List, params: dict, held: dict) -> None:
        Xv = held["X"]
        leaves = [route(Xv, t) for t in trees]
        score = replay_f32(leaves, [t.leaf_value for t in trees],
                           torch.zeros(Xv.shape[0], dtype=torch.float32,
                                       device=Xv.device))
        s = score.double().cpu().numpy()
        if params["metric"] == "auc":
            ref = {"auc": ref_metrics.auc(held["label"], s)}
        elif params["metric"] == "ndcg":
            ks = [int(k) for k in str(params["eval_at"]).split(",")]
            ref = {"ndcg@%d" % k: v for k, v in ref_metrics.ndcg(
                held["label"], s, held["group"], ks).items()}
        else:
            raise ValueError("metric %r is outside this reference"
                             % params["metric"])
        prog = held["metrics"]
        gaps = [abs(prog[k] - v) if k in prog else float("inf")
                for k, v in ref.items()]
        self.n["eval_gap"] = max(g if g == g else float("inf") for g in gaps)
        self.worst["eval"] = {"reference": ref, "program": dict(prog)}

    def numbers(self) -> Dict[str, float]:
        return dict(self.n)
