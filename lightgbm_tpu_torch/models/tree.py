"""Decision tree model — flat-array representation, host-side.

Port of ``lightgbm_tpu/models/tree.py`` (reference: include/LightGBM/
tree.h:25, src/io/tree.cpp). The learner builds the tree on the device;
this class is the host mirror used for model storage, prediction over
raw feature values, and LightGBM-v3 text serialization (tree.cpp:339
``ToString``, :682 parse ctor), so models interchange with the reference
and with ``lightgbm_tpu``.

Conventions (same as reference):
- internal nodes are numbered 0..num_leaves-2 in creation order; a child
  pointer >= 0 is an internal node, < 0 encodes leaf ``~index``
- splitting leaf L creates internal node ``num_leaves-1``; the left child
  keeps leaf index L, the right child becomes leaf ``num_leaves``
- ``decision_type`` bit flags: 1 = categorical, 2 = default_left,
  bits 2-3 = missing type (none/zero/nan) (include/LightGBM/tree.h:19-20)

This slice holds numerical splits only; categorical and linear trees
(text with ``num_cat > 0`` or ``is_linear=1``) raise on load.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..io.binning import MissingType, kZeroThreshold
from ..utils.log import unsupported

kDefaultLeftMask = 2


def _fmt(x: float) -> str:
    """Shortest round-trip decimal, matching the reference's
    Common::DoubleToStr output closely enough to round-trip."""
    return np.format_float_positional(
        np.float64(x), unique=True, trim="0") if np.isfinite(x) else repr(x)


def _arr_to_str(a, is_float: bool) -> str:
    if is_float:
        return " ".join(_fmt(v) for v in a)
    return " ".join(str(int(v)) for v in a)


class Tree:
    def __init__(self, max_leaves: int):
        self.max_leaves = max_leaves
        self.num_leaves = 1
        n = max(max_leaves - 1, 1)
        self.split_feature = np.zeros(n, dtype=np.int32)      # real feature idx
        self.split_feature_inner = np.zeros(n, dtype=np.int32)
        self.threshold_in_bin = np.zeros(n, dtype=np.int32)
        self.threshold = np.zeros(n, dtype=np.float64)
        self.decision_type = np.zeros(n, dtype=np.int8)
        self.split_gain = np.zeros(n, dtype=np.float64)
        self.left_child = np.zeros(n, dtype=np.int32)
        self.right_child = np.zeros(n, dtype=np.int32)
        self.internal_value = np.zeros(n, dtype=np.float64)
        self.internal_weight = np.zeros(n, dtype=np.float64)
        self.internal_count = np.zeros(n, dtype=np.int64)
        self.leaf_value = np.zeros(max_leaves, dtype=np.float64)
        self.leaf_weight = np.zeros(max_leaves, dtype=np.float64)
        self.leaf_count = np.zeros(max_leaves, dtype=np.int64)
        self.leaf_parent = np.full(max_leaves, -1, dtype=np.int32)
        self.leaf_depth = np.zeros(max_leaves, dtype=np.int32)
        self.shrinkage = 1.0

    # ------------------------------------------------------------------
    def split(self, leaf: int, feature: int, feature_inner: int,
              threshold_bin: int, threshold_real: float,
              left_value: float, right_value: float,
              left_count: int, right_count: int,
              left_weight: float, right_weight: float,
              gain: float, missing_type: int, default_left: bool) -> int:
        """Split ``leaf``; returns the new (right-child) leaf index
        (reference: Tree::Split, include/LightGBM/tree.h:62)."""
        node = self.num_leaves - 1
        parent = self.leaf_parent[leaf]
        if parent >= 0:
            if self.left_child[parent] == ~leaf:
                self.left_child[parent] = node
            else:
                self.right_child[parent] = node
        self.split_feature[node] = feature
        self.split_feature_inner[node] = feature_inner
        self.threshold_in_bin[node] = threshold_bin
        self.threshold[node] = threshold_real
        dt = (missing_type & 3) << 2
        if default_left:
            dt |= kDefaultLeftMask
        self.decision_type[node] = dt
        self.split_gain[node] = gain
        self.left_child[node] = ~leaf
        self.right_child[node] = ~self.num_leaves
        self.internal_value[node] = self.leaf_value[leaf]
        self.internal_weight[node] = left_weight + right_weight
        self.internal_count[node] = left_count + right_count
        new_leaf = self.num_leaves
        self.leaf_parent[leaf] = node
        self.leaf_parent[new_leaf] = node
        self.leaf_value[leaf] = _sane(left_value)
        self.leaf_value[new_leaf] = _sane(right_value)
        self.leaf_weight[leaf] = left_weight
        self.leaf_weight[new_leaf] = right_weight
        self.leaf_count[leaf] = left_count
        self.leaf_count[new_leaf] = right_count
        self.leaf_depth[new_leaf] = self.leaf_depth[leaf] + 1
        self.leaf_depth[leaf] += 1
        self.num_leaves += 1
        return new_leaf

    # ------------------------------------------------------------------
    def apply_shrinkage(self, rate: float) -> None:
        """reference: Tree::Shrinkage (tree.h:113)."""
        self.leaf_value[:self.num_leaves] *= rate
        self.internal_value[:max(self.num_leaves - 1, 0)] *= rate
        self.shrinkage *= rate

    def add_bias(self, val: float) -> None:
        """reference: Tree::AddBias — used by boost_from_average refit."""
        self.leaf_value[:self.num_leaves] += val
        self.internal_value[:max(self.num_leaves - 1, 0)] += val

    def set_leaf_output(self, leaf: int, value: float) -> None:
        """A renewed leaf output (reference: Tree::SetLeafOutput)."""
        self.leaf_value[leaf] = _sane(value)

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.leaf_value[self.predict_leaf_index(X)]

    def predict_leaf_index(self, X: np.ndarray) -> np.ndarray:
        """Lockstep vectorized traversal: all rows advance one level per
        pass (reference: tree.h:133 Predict over NumericalDecision —
        here the per-row branch walk becomes array ops over the flat
        node arrays)."""
        n = X.shape[0]
        if self.num_leaves == 1:
            return np.zeros(n, dtype=np.int32)
        ni = self.num_internal
        feat = self.split_feature[:ni]
        thr = self.threshold[:ni]
        dt = self.decision_type[:ni].astype(np.int64)
        default_left = (dt & kDefaultLeftMask) != 0
        missing = (dt >> 2) & 3
        left, right = self.left_child[:ni], self.right_child[:ni]
        node = np.zeros(n, dtype=np.int32)   # >=0 internal, <0 = ~leaf
        for _ in range(ni):
            act = np.nonzero(node >= 0)[0]
            if len(act) == 0:
                break
            nd = node[act]
            fv = X[act, feat[nd]]
            m = missing[nd]
            isnan = np.isnan(fv)
            v = np.where(isnan & (m != MissingType.NAN), 0.0, fv)
            gl = v <= thr[nd]
            gl = np.where((m == MissingType.ZERO)
                          & (np.abs(v) <= kZeroThreshold),
                          default_left[nd], gl)
            gl = np.where((m == MissingType.NAN) & isnan,
                          default_left[nd], gl)
            node[act] = np.where(gl, left[nd], right[nd])
        return (~node).astype(np.int32)

    # ------------------------------------------------------------------
    def to_string(self) -> str:
        """Serialize in the reference's model text format
        (src/io/tree.cpp:339-410)."""
        nl = self.num_leaves
        ni = max(nl - 1, 0)
        lines = [f"num_leaves={nl}", "num_cat=0"]
        if nl == 1:
            lines += [f"leaf_value={_fmt(self.leaf_value[0])}"]
        else:
            lines += [
                "split_feature=" + _arr_to_str(self.split_feature[:ni], False),
                "split_gain=" + _arr_to_str(self.split_gain[:ni], True),
                "threshold=" + _arr_to_str(self.threshold[:ni], True),
                "decision_type=" + _arr_to_str(self.decision_type[:ni], False),
                "left_child=" + _arr_to_str(self.left_child[:ni], False),
                "right_child=" + _arr_to_str(self.right_child[:ni], False),
                "leaf_value=" + _arr_to_str(self.leaf_value[:nl], True),
                "leaf_weight=" + _arr_to_str(self.leaf_weight[:nl], True),
                "leaf_count=" + _arr_to_str(self.leaf_count[:nl], False),
                "internal_value=" + _arr_to_str(self.internal_value[:ni], True),
                "internal_weight=" + _arr_to_str(self.internal_weight[:ni], True),
                "internal_count=" + _arr_to_str(self.internal_count[:ni], False),
            ]
        lines += ["is_linear=0"]
        lines += [f"shrinkage={_fmt(self.shrinkage)}", ""]
        return "\n".join(lines)

    @classmethod
    def from_string(cls, s: str) -> "Tree":
        """Parse the text format (reference: Tree::Tree(const char*, ...),
        src/io/tree.cpp:682)."""
        kv = {}
        for line in s.strip().splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v.strip()
        nl = int(kv["num_leaves"])
        if int(kv.get("num_cat", 0)) > 0:
            unsupported("categorical trees", "item 11")
        if int(kv.get("is_linear", 0)):
            unsupported("linear trees", "item 15")
        t = cls(max(nl, 1))
        t.num_leaves = nl
        t.shrinkage = float(kv.get("shrinkage", 1.0))
        if nl == 1:
            t.leaf_value[0] = float(kv.get("leaf_value", 0.0))
            return t
        ni = nl - 1

        def farr(key, n, dtype=np.float64):
            return np.array(kv[key].split(), dtype=dtype)[:n]

        t.split_feature[:ni] = farr("split_feature", ni, np.int32)
        t.split_feature_inner[:ni] = t.split_feature[:ni]
        if "split_gain" in kv:
            t.split_gain[:ni] = farr("split_gain", ni)
        t.threshold[:ni] = farr("threshold", ni)
        t.decision_type[:ni] = farr("decision_type", ni, np.int64).astype(np.int8)
        t.left_child[:ni] = farr("left_child", ni, np.int32)
        t.right_child[:ni] = farr("right_child", ni, np.int32)
        t.leaf_value[:nl] = farr("leaf_value", nl)
        # leaf_depth is a train-time field the text format does not
        # carry; rebuild it from the structure
        stack = [(0, 0)]
        while stack:
            idx, d = stack.pop()
            if idx < 0:
                t.leaf_depth[~idx] = d
            else:
                stack.append((int(t.left_child[idx]), d + 1))
                stack.append((int(t.right_child[idx]), d + 1))
        if "leaf_weight" in kv:
            t.leaf_weight[:nl] = farr("leaf_weight", nl)
        if "leaf_count" in kv:
            t.leaf_count[:nl] = farr("leaf_count", nl, np.int64)
        if "internal_value" in kv:
            t.internal_value[:ni] = farr("internal_value", ni)
        if "internal_weight" in kv:
            t.internal_weight[:ni] = farr("internal_weight", ni)
        if "internal_count" in kv:
            t.internal_count[:ni] = farr("internal_count", ni, np.int64)
        return t

    # ------------------------------------------------------------------
    @property
    def num_internal(self) -> int:
        return max(self.num_leaves - 1, 0)


def _sane(v: float) -> float:
    """reference: Tree::Split guards leaf outputs against NaN/Inf
    (kMaxTreeOutput clamp in feature_histogram)."""
    if not np.isfinite(v):
        return 0.0
    return float(v)


def parse_tree_blocks(s: str) -> List["Tree"]:
    """Parse the ``Tree=<i>`` ... ``end of trees`` section of a v3
    model text into Tree objects — THE tree-framing parser, shared by
    ``GBDT.load_model_from_string`` and checkpoint resume
    (ft/checkpoint.py) so the block grammar cannot drift between the
    two loaders. Lines before the first ``Tree=`` are ignored, so the
    full model text (or just its tree section) both work."""
    models: List[Tree] = []
    cur: List[str] = []
    in_tree = False
    for line in s.splitlines():
        if line.startswith("Tree="):
            if cur:
                models.append(Tree.from_string("\n".join(cur)))
            cur = []
            in_tree = True
        elif line.strip() == "end of trees":
            if cur:
                models.append(Tree.from_string("\n".join(cur)))
            cur = []
            in_tree = False
        elif in_tree:
            cur.append(line)
    return models
