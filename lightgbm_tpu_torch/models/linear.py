"""Piecewise-linear trees: a ridge fit in each leaf.

Port of ``lightgbm_tpu/models/linear.py`` (upstream LinearTreeLearner,
src/treelearner/linear_tree_learner.cpp:173 ``CalculateLinear``): after
a tree's structure is grown, each leaf gets ``f(x) = const + coeff .
x[path]`` over the raw values of the features on its root path (in path
order, each once), minimizing ``sum_i [g_i f + h_i f^2 / 2] +
linear_lambda |coeff|^2 / 2`` (the constant is not regularized). A leaf
with fewer than ``max(10, k + 1)`` usable rows, or whose system is
singular or gives a non-finite solution, keeps its constant output.
Rows with NaN in one of the leaf's features are left out of its fit and
predict its constant.

- :func:`fit_linear_leaves` fits in f64 on the tensors' device (the
  card in training, the CPU in the tests). One stable sort of the
  row->leaf partition makes each leaf's rows contiguous, each leaf's
  normal equations are one product of its rows (rows left out carry
  zeros), and one batched ``torch.linalg.solve_ex`` solves every leaf;
  two host reads per tree (the leaves' row counts, the solutions).
  Leaves of fewer features are padded to the tree's longest path by
  zero columns whose diagonal is 1, which leaves their solution alone.
- :func:`linear_predict` evaluates on the host in f64 NumPy (the host
  walk ``Tree.predict`` and the exact stacked ``predict``), with a
  leaf's products added row by row in feature order;
  :func:`linear_values_device` is the same on the tensors' device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .tree import Tree


def _start_linear(tree: Tree) -> None:
    """Mark ``tree`` linear with every leaf at its constant output."""
    tree.is_linear = True
    tree.leaf_const = tree.leaf_value.copy()
    tree.leaf_features = [[] for _ in range(tree.max_leaves)]
    tree.leaf_coeff = [[] for _ in range(tree.max_leaves)]


def _leaf_paths(tree: Tree) -> dict:
    """leaf -> the features (original columns) on its root path, in
    path order, each once."""
    out = {}
    if tree.num_leaves <= 1:
        return {0: []}
    stack = [(0, [])]
    while stack:
        node, feats = stack.pop()
        if node < 0:
            out[~node] = list(dict.fromkeys(feats))
            continue
        f = int(tree.split_feature[node])
        stack.append((int(tree.right_child[node]), feats + [f]))
        stack.append((int(tree.left_child[node]), feats + [f]))
    return out


def _dot_rows(cols, coeff):
    """Per row, ``sum_j cols[j] * coeff[j]`` added in feature order: a
    row's value does not depend on which other rows are computed with
    it (a BLAS matrix-vector product's rounding does), so the stacked
    forest's chunks give the host walk's bytes."""
    acc = cols[0] * coeff[0]
    for j in range(1, len(coeff)):
        acc = acc + cols[j] * coeff[j]
    return acc


def linear_predict(tree: Tree, X: np.ndarray,
                   leaf_idx: Optional[np.ndarray] = None) -> np.ndarray:
    """f64 outputs of a linear tree over raw rows (upstream Tree::Predict
    linear branch, src/io/tree.cpp), on the host. The reference adds a
    leaf's products with ``Xl @ coeff``; here in feature order, row by
    row (:func:`_dot_rows`), which can differ from it in the last bits."""
    X = np.asarray(X, dtype=np.float64)
    if leaf_idx is None:
        leaf_idx = tree.predict_leaf_index(X)
    out = tree.leaf_value[leaf_idx].copy()
    for leaf in range(tree.num_leaves):
        feats = tree.leaf_features[leaf]
        if not feats:
            continue
        rows = leaf_idx == leaf
        if not rows.any():
            continue
        Xl = X[np.ix_(rows, feats)]
        ok = ~np.isnan(Xl).any(axis=1)
        vals = tree.leaf_const[leaf] + _dot_rows(Xl.T, tree.leaf_coeff[leaf])
        res = out[rows]
        res[ok] = vals[ok]
        out[rows] = res
    return out


def _path_tables(feats: list, device: torch.device):
    """[nl, K] int64 feature columns (0 pad) and bool lanes of each
    leaf's feature list, K the longest (at least 1)."""
    K = max(1, max(len(f) for f in feats))
    ftab = np.zeros((len(feats), K), dtype=np.int64)
    vtab = np.zeros((len(feats), K), dtype=bool)
    for leaf, f in enumerate(feats):
        ftab[leaf, :len(f)] = f
        vtab[leaf, :len(f)] = True
    return (torch.from_numpy(ftab).to(device),
            torch.from_numpy(vtab).to(device), K)


def fit_linear_leaves(tree: Tree, X: torch.Tensor, grad: torch.Tensor,
                      hess: torch.Tensor, leaf_of_row: torch.Tensor,
                      linear_lambda: float,
                      row_mask: Optional[torch.Tensor] = None,
                      min_rows: int = 10) -> None:
    """Fit every leaf of ``tree`` in f64 on the tensors' device: ``X``
    [N, num_columns] raw rows (f32 or f64, every original column),
    ``grad`` / ``hess`` [N], ``leaf_of_row`` [N] int, ``row_mask`` [N]
    bool (the in-bag rows)."""
    _start_linear(tree)
    nl = tree.num_leaves
    paths = _leaf_paths(tree)
    feats = [paths.get(leaf, []) for leaf in range(nl)]
    dev = X.device
    ftab, vtab, K = _path_tables(feats, dev)
    leaf = leaf_of_row.long()
    lanes = vtab[leaf]                                       # [N, K]
    A = X.gather(1, ftab[leaf]).to(torch.float64)
    ok = ~(torch.isnan(A) & lanes).any(dim=1)
    if row_mask is not None:
        ok &= row_mask
    # a row left out carries zeros: it adds nothing to any sum
    A = torch.cat([torch.where(lanes & ok[:, None], A, 0.0),
                   ok.to(torch.float64)[:, None]], dim=1)    # [N, K + 1]
    order = torch.sort(leaf, stable=True).indices
    counts = torch.stack([
        torch.bincount(leaf, minlength=nl),
        torch.bincount(leaf, weights=ok.to(torch.float64),
                       minlength=nl).to(torch.int64)]).tolist()
    A = A[order]
    h = hess.to(torch.float64)[order]
    g = grad.to(torch.float64)[order]
    fit, H, b = [], [], []
    start = 0
    for lf in range(nl):
        end = start + counts[0][lf]
        k = len(feats[lf])
        if k and counts[1][lf] >= max(min_rows, k + 1):
            rows = A[start:end]
            H.append(rows.t() @ (rows * h[start:end, None]))
            b.append(-(rows.t() @ g[start:end]))
            fit.append(lf)
        start = end
    if not fit:
        return
    diag = np.zeros((len(fit), K + 1))
    for i, lf in enumerate(fit):
        k = len(feats[lf])
        diag[i, :k] = linear_lambda
        diag[i, k:K] = 1.0            # pad columns: beta 0
    reg = torch.diag_embed(torch.from_numpy(diag).to(dev))
    beta, info = torch.linalg.solve_ex(torch.stack(H) + reg,
                                       torch.stack(b))
    beta_h = beta.tolist()
    info_h = info.tolist()
    for i, lf in enumerate(fit):
        sol = beta_h[i]
        k = len(feats[lf])
        if info_h[i] != 0 or not np.isfinite(sol).all():
            continue
        tree.leaf_features[lf] = [int(f) for f in feats[lf]]
        tree.leaf_coeff[lf] = [float(v) for v in sol[:k]]
        tree.leaf_const[lf] = float(sol[K])


def linear_values_device(tree: Tree, X: torch.Tensor,
                         leaf: torch.Tensor) -> torch.Tensor:
    """[n] f64 outputs of a linear tree on ``X``'s device, rows ``X``
    [n, num_columns] at leaves ``leaf`` [n]: :func:`linear_predict`'s
    rules (a leaf without a fit, or a row with NaN in one of its
    features, takes ``leaf_value``) and its adds in the same order, so
    the same bytes."""
    nl = tree.num_leaves
    dev = X.device
    feats = [tree.leaf_features[lf] for lf in range(nl)]
    ftab, vtab, K = _path_tables(feats, dev)
    coeff = np.zeros((nl, K))
    for lf, cs in enumerate(tree.leaf_coeff[:nl]):
        coeff[lf, :len(cs)] = cs
    has = torch.tensor([bool(f) for f in feats], device=dev)
    value = torch.from_numpy(tree.leaf_value[:nl].copy()).to(dev)
    const = torch.from_numpy(np.asarray(tree.leaf_const[:nl],
                                        dtype=np.float64)).to(dev)
    leaf = leaf.long()
    lanes = vtab[leaf]
    xv = X.gather(1, ftab[leaf]).to(torch.float64)
    bad = (torch.isnan(xv) & lanes).any(dim=1)
    terms = torch.where(lanes, torch.from_numpy(coeff).to(dev)[leaf] * xv,
                        0.0)
    s = const[leaf] + _dot_rows(terms.t(), [1.0] * K)
    return torch.where(has[leaf] & ~bad, s, value[leaf])
