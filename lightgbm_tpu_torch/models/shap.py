"""SHAP feature contributions (TreeSHAP), on the host.

Copy of ``lightgbm_tpu/models/shap.py``. Equivalent of the reference's ``Tree::PredictContrib`` path
(reference: include/LightGBM/tree.h:139 PredictContrib, the TreeSHAP
recursion in src/io/tree.cpp ``TreeSHAP``/``ExtendPath``/``UnwindPath``,
after Lundberg & Lee's exact polynomial-time algorithm). Per-node covers
come from the training-time ``internal_count``/``leaf_count`` just like
the reference.
"""
from __future__ import annotations

import numpy as np

from .tree import Tree, kCategoricalMask


class _Path:
    __slots__ = ("feature", "zero", "one", "pweight")

    def __init__(self, depth: int):
        self.feature = np.full(depth, -1, dtype=np.int64)
        self.zero = np.zeros(depth)
        self.one = np.zeros(depth)
        self.pweight = np.zeros(depth)

    def copy_from(self, other: "_Path", n: int) -> None:
        self.feature[:n] = other.feature[:n]
        self.zero[:n] = other.zero[:n]
        self.one[:n] = other.one[:n]
        self.pweight[:n] = other.pweight[:n]


def _extend(path: _Path, depth: int, zero: float, one: float,
            feature: int) -> None:
    path.feature[depth] = feature
    path.zero[depth] = zero
    path.one[depth] = one
    path.pweight[depth] = 1.0 if depth == 0 else 0.0
    for i in range(depth - 1, -1, -1):
        path.pweight[i + 1] += one * path.pweight[i] * (i + 1) / (depth + 1)
        path.pweight[i] = zero * path.pweight[i] * (depth - i) / (depth + 1)


def _unwind(path: _Path, depth: int, index: int) -> None:
    one = path.one[index]
    zero = path.zero[index]
    next_one = path.pweight[depth]
    for i in range(depth - 1, -1, -1):
        if one != 0.0:
            tmp = path.pweight[i]
            path.pweight[i] = next_one * (depth + 1) / ((i + 1) * one)
            next_one = tmp - path.pweight[i] * zero * (depth - i) / (depth + 1)
        else:
            path.pweight[i] = (path.pweight[i] * (depth + 1)) \
                / (zero * (depth - i))
    for i in range(index, depth):
        path.feature[i] = path.feature[i + 1]
        path.zero[i] = path.zero[i + 1]
        path.one[i] = path.one[i + 1]


def _unwound_sum(path: _Path, depth: int, index: int) -> float:
    one = path.one[index]
    zero = path.zero[index]
    next_one = path.pweight[depth]
    total = 0.0
    for i in range(depth - 1, -1, -1):
        if one != 0.0:
            tmp = next_one * (depth + 1) / ((i + 1) * one)
            total += tmp
            next_one = path.pweight[i] - tmp * zero * (depth - i) / (depth + 1)
        else:
            total += (path.pweight[i] / zero) * (depth + 1) / (depth - i)
    return total


def _node_count(tree: Tree, node: int) -> float:
    if node < 0:
        return float(max(tree.leaf_count[~node], 1))
    return float(max(tree.internal_count[node], 1))


def _decision(tree: Tree, node: int, x: np.ndarray) -> bool:
    return bool(tree._decide(np.array([x[tree.split_feature[node]]]),
                             node)[0])


def _tree_shap(tree: Tree, x: np.ndarray, phi: np.ndarray, node: int,
               unique_depth: int, parent_path: _Path,
               parent_zero: float, parent_one: float,
               parent_feature: int) -> None:
    path = _Path(unique_depth + 2)
    path.copy_from(parent_path, unique_depth + 1)
    _extend(path, unique_depth, parent_zero, parent_one, parent_feature)

    if node < 0:  # leaf
        leaf = ~node
        for i in range(1, unique_depth + 1):
            w = _unwound_sum(path, unique_depth, i)
            phi[path.feature[i]] += (w * (path.one[i] - path.zero[i])
                                     * tree.leaf_value[leaf])
        return

    hot = tree.left_child[node] if _decision(tree, node, x) \
        else tree.right_child[node]
    cold = tree.right_child[node] if hot == tree.left_child[node] \
        else tree.left_child[node]
    node_cnt = _node_count(tree, node)
    hot_zero = _node_count(tree, hot) / node_cnt
    cold_zero = _node_count(tree, cold) / node_cnt
    incoming_zero, incoming_one = 1.0, 1.0
    path_index = 0
    feat = tree.split_feature[node]
    while path_index <= unique_depth:
        if path.feature[path_index] == feat:
            break
        path_index += 1
    if path_index != unique_depth + 1:
        incoming_zero = path.zero[path_index]
        incoming_one = path.one[path_index]
        _unwind(path, unique_depth, path_index)
        unique_depth -= 1

    _tree_shap(tree, x, phi, hot, unique_depth + 1, path,
               hot_zero * incoming_zero, incoming_one, feat)
    _tree_shap(tree, x, phi, cold, unique_depth + 1, path,
               cold_zero * incoming_zero, 0.0, feat)


def _expected_value(tree: Tree) -> float:
    """Cover-weighted mean output (reference: Tree::ExpectedValue)."""
    total = tree.leaf_count[:tree.num_leaves].sum()
    if total <= 0:
        return float(tree.leaf_value[:tree.num_leaves].mean())
    return float((tree.leaf_value[:tree.num_leaves]
                  * tree.leaf_count[:tree.num_leaves]).sum() / total)


def tree_predict_contrib(tree: Tree, X: np.ndarray,
                         num_features: int) -> np.ndarray:
    """Per-row SHAP values [n, num_features + 1]; last column is the
    expected value (reference: PredictContrib appends the bias term)."""
    n = X.shape[0]
    out = np.zeros((n, num_features + 1))
    expected = _expected_value(tree)
    out[:, -1] = expected
    if tree.num_leaves == 1:
        return out
    for r in range(n):
        phi = out[r]
        _tree_shap(tree, X[r], phi, 0, 0, _Path(1), 1.0, 1.0, -1)
    return out


def predict_contrib(models, X: np.ndarray, num_features: int,
                    num_tree_per_iteration: int) -> np.ndarray:
    """Sum of per-tree SHAP values. Returns [n, (F+1)] for single-class
    or [n, K*(F+1)] multiclass (reference: c_api predict_contrib
    layout)."""
    X = np.asarray(X, dtype=np.float64)
    n = X.shape[0]
    K = num_tree_per_iteration
    out = np.zeros((n, K, num_features + 1))
    for i, tree in enumerate(models):
        out[:, i % K, :] += tree_predict_contrib(tree, X, num_features)
    if K == 1:
        return out[:, 0, :]
    return out.reshape(n, K * (num_features + 1))
