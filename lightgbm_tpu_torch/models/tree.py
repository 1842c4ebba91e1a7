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
- a categorical node's ``threshold`` is the index of its split in
  ``cat_boundaries``; its category values sending rows left are the set
  bits of ``cat_threshold[cat_boundaries[i]:cat_boundaries[i + 1]]``
  (uint32 words, tree.h ``cat_threshold_``); NaN, negative and unseen
  categories go right

Linear trees (``is_linear``; tree.h ``leaf_const_`` / ``leaf_features_``
/ ``leaf_coeff_``) carry a ridge fit per leaf over the raw values of the
features on its path (``models/linear.py``); their text adds
``leaf_const``, ``num_features``, ``leaf_features`` and ``leaf_coeff``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..io.binning import MissingType, kZeroThreshold

kCategoricalMask = 1
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
        # categorical splits (tree.h cat_boundaries_ / cat_threshold_)
        self.num_cat = 0
        self.cat_boundaries: List[int] = [0]
        self.cat_threshold: List[int] = []      # uint32 bitset words
        # node -> bool mask over its feature's BINS, for the binned
        # walks of the training session (not serialized; a text-loaded
        # tree gets it from GBDT.align_trees_to_dataset)
        self.cat_bin_masks: Dict[int, np.ndarray] = {}
        # linear leaves: const + coeff . x[features] per leaf (a leaf
        # without features keeps its leaf_value)
        self.is_linear = False
        self.leaf_const = np.zeros(0)
        self.leaf_features: List[List[int]] = []
        self.leaf_coeff: List[List[float]] = []

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
    def split_categorical(self, leaf: int, feature: int, feature_inner: int,
                          cat_values, bin_mask,
                          left_value: float, right_value: float,
                          left_count: int, right_count: int,
                          left_weight: float, right_weight: float,
                          gain: float) -> int:
        """Categorical split: rows whose category is in ``cat_values``
        go left (reference: Tree::SplitCategorical, tree.h:85: the
        bitset words are appended to ``cat_threshold``, and the node's
        threshold is the split's index into ``cat_boundaries``).
        ``bin_mask`` is the same set over the feature's bins."""
        node = self.num_leaves - 1
        new_leaf = self.split(
            leaf=leaf, feature=feature, feature_inner=feature_inner,
            threshold_bin=self.num_cat, threshold_real=float(self.num_cat),
            left_value=left_value, right_value=right_value,
            left_count=left_count, right_count=right_count,
            left_weight=left_weight, right_weight=right_weight,
            gain=gain, missing_type=MissingType.NONE, default_left=False)
        self.decision_type[node] = kCategoricalMask
        max_cat = max([int(v) for v in cat_values], default=0)
        words = [0] * (max_cat // 32 + 1)
        for v in cat_values:
            v = int(v)
            if v >= 0:
                words[v // 32] |= 1 << (v % 32)
        self.cat_threshold.extend(words)
        self.cat_boundaries.append(len(self.cat_threshold))
        self.num_cat += 1
        self.cat_bin_masks[node] = np.asarray(bin_mask, dtype=bool)
        return new_leaf

    def _cat_contains(self, cat_idx: int, values: np.ndarray) -> np.ndarray:
        """Vectorized FindInBitset (reference: utils/common.h): whether
        each (integer-truncated) value is in split ``cat_idx``'s set;
        negative values and values past its words are not."""
        lo = self.cat_boundaries[cat_idx]
        hi = self.cat_boundaries[cat_idx + 1]
        words = np.asarray(self.cat_threshold[lo:hi], dtype=np.uint64)
        iv = values.astype(np.int64)
        word_idx = iv // 32
        ok = (iv >= 0) & (word_idx < len(words))
        wi = np.clip(word_idx, 0, max(len(words) - 1, 0))
        bits = (words[wi] >> (iv % 32).astype(np.uint64)) & 1
        return ok & (bits > 0)

    def cat_value_words(self, cat_idx: int) -> int:
        """Bitset words of categorical split ``cat_idx``: it sends no
        value >= 32 * words left."""
        return self.cat_boundaries[cat_idx + 1] - self.cat_boundaries[cat_idx]

    def cat_value_mask(self, cat_idx: int, max_value: int) -> np.ndarray:
        """[max_value + 1] bool: which of the category values
        0..max_value split ``cat_idx`` sends left (from the bitset
        alone, so text-loaded trees have it)."""
        return self._cat_contains(
            cat_idx, np.arange(max_value + 1, dtype=np.float64))

    def _cats_of(self, cat_idx: int) -> List[int]:
        """The category values of split ``cat_idx``, ascending
        (reference: Tree::NodeToJSON's FindInBitset loop)."""
        lo = self.cat_boundaries[cat_idx]
        hi = self.cat_boundaries[cat_idx + 1]
        return [w * 32 + j for w in range(hi - lo)
                for j in range(32)
                if (int(self.cat_threshold[lo + w]) >> j) & 1]

    # ------------------------------------------------------------------
    def apply_shrinkage(self, rate: float) -> None:
        """reference: Tree::Shrinkage (tree.h:113)."""
        self.leaf_value[:self.num_leaves] *= rate
        self.internal_value[:max(self.num_leaves - 1, 0)] *= rate
        if self.is_linear:
            self.leaf_const[:self.num_leaves] *= rate
            self.leaf_coeff = [[c * rate for c in cs]
                               for cs in self.leaf_coeff]
        self.shrinkage *= rate

    def add_bias(self, val: float) -> None:
        """reference: Tree::AddBias — used by boost_from_average refit."""
        self.leaf_value[:self.num_leaves] += val
        self.internal_value[:max(self.num_leaves - 1, 0)] += val

    def set_leaf_output(self, leaf: int, value: float) -> None:
        """A renewed leaf output (reference: Tree::SetLeafOutput)."""
        self.leaf_value[leaf] = _sane(value)

    def _decide(self, fval: np.ndarray, node: int) -> np.ndarray:
        """Node ``node``'s decision over values ``fval`` of its feature,
        True = left (upstream NumericalDecision / CategoricalDecision,
        tree.h:335-395; the rules of :meth:`predict_leaf_index`)."""
        dt = int(self.decision_type[node])
        if dt & kCategoricalMask:
            iv = np.where(np.isnan(fval), -1.0, fval)
            return self._cat_contains(int(self.threshold_in_bin[node]), iv)
        missing = (dt >> 2) & 3
        default_left = bool(dt & kDefaultLeftMask)
        isnan = np.isnan(fval)
        v = np.where(isnan & (missing != MissingType.NAN), 0.0, fval)
        go_left = v <= self.threshold[node]
        if missing == MissingType.ZERO:
            go_left = np.where(np.abs(v) <= kZeroThreshold, default_left,
                               go_left)
        elif missing == MissingType.NAN:
            go_left = np.where(isnan, default_left, go_left)
        return go_left

    def predict(self, X: np.ndarray) -> np.ndarray:
        leaf = self.predict_leaf_index(X)
        if self.is_linear:
            from .linear import linear_predict
            return linear_predict(self, X, leaf)
        return self.leaf_value[leaf]

    def predict_leaf_index(self, X: np.ndarray) -> np.ndarray:
        """Lockstep vectorized traversal: all rows advance one level per
        pass (reference: tree.h:133 Predict over NumericalDecision and
        CategoricalDecision — here the per-row branch walk becomes array
        ops over the flat node arrays). A categorical node sends a row
        left when its value's integer part is in the node's bitset: NaN,
        negative and unseen categories go right."""
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
        is_cat = (dt & kCategoricalMask) != 0
        has_cat = bool(is_cat.any())
        if has_cat:
            boundaries = np.asarray(self.cat_boundaries, dtype=np.int64)
            words = np.asarray(self.cat_threshold, dtype=np.uint64)
            cat_idx = self.threshold_in_bin[:ni].astype(np.int64)
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
            if has_cat:
                cn = is_cat[nd]
                if cn.any():
                    iv = np.where(isnan, -1.0, fv).astype(np.int64)
                    # numerical nodes hold bins in threshold_in_bin:
                    # clamp them out of the boundaries lookup
                    ci = np.clip(np.where(cn, cat_idx[nd], 0), 0,
                                 len(boundaries) - 2)
                    n_words = boundaries[ci + 1] - boundaries[ci]
                    ok = (iv >= 0) & (iv // 32 < n_words)
                    pos = np.clip(boundaries[ci] + iv // 32, 0,
                                  max(len(words) - 1, 0))
                    bits = (words[pos] >> (iv % 32).astype(np.uint64)) & 1
                    gl = np.where(cn, ok & (bits > 0), gl)
            node[act] = np.where(gl, left[nd], right[nd])
        return (~node).astype(np.int32)

    # ------------------------------------------------------------------
    def to_string(self) -> str:
        """Serialize in the reference's model text format
        (src/io/tree.cpp:339-410)."""
        nl = self.num_leaves
        ni = max(nl - 1, 0)
        lines = [f"num_leaves={nl}", f"num_cat={self.num_cat}"]
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
            if self.num_cat > 0:
                lines += [
                    "cat_boundaries=" + " ".join(
                        str(v) for v in self.cat_boundaries),
                    "cat_threshold=" + " ".join(
                        str(v) for v in self.cat_threshold),
                ]
        if self.is_linear:
            lines += [
                "is_linear=1",
                "leaf_const=" + _arr_to_str(self.leaf_const[:nl], True),
                "num_features=" + " ".join(
                    str(len(self.leaf_features[i])) for i in range(nl)),
                "leaf_features=" + " ".join(
                    str(f) for i in range(nl) for f in self.leaf_features[i]),
                "leaf_coeff=" + " ".join(
                    _fmt(c) for i in range(nl) for c in self.leaf_coeff[i]),
            ]
        else:
            lines += ["is_linear=0"]
        lines += [f"shrinkage={_fmt(self.shrinkage)}", ""]
        return "\n".join(lines)

    def _node_to_json(self, index: int) -> dict:
        """reference: Tree::NodeToJSON (src/io/tree.cpp:455-520).
        Iterative (post-order): a chain-shaped tree can be num_leaves - 1
        deep, past Python's recursion limit."""
        order: List[int] = []
        stack = [index]
        while stack:
            idx = stack.pop()
            order.append(idx)
            if idx >= 0:
                stack.append(int(self.left_child[idx]))
                stack.append(int(self.right_child[idx]))
        memo: dict = {}
        for idx in reversed(order):
            if idx < 0:
                leaf = ~idx
                memo[idx] = {
                    "leaf_index": int(leaf),
                    "leaf_value": float(self.leaf_value[leaf]),
                    "leaf_weight": float(self.leaf_weight[leaf]),
                    "leaf_count": int(self.leaf_count[leaf]),
                }
                if self.is_linear:
                    memo[idx].update(self._linear_json(leaf))
                continue
            dt = int(self.decision_type[idx])
            if dt & kCategoricalMask:
                threshold = "||".join(str(c) for c in self._cats_of(
                    int(self.threshold_in_bin[idx])))
                decision = "=="
            else:
                threshold = float(self.threshold[idx])
                decision = "<="
            memo[idx] = {
                "split_index": int(idx),
                "split_feature": int(self.split_feature[idx]),
                "split_gain": float(self.split_gain[idx]),
                "threshold": threshold,
                "decision_type": decision,
                "default_left": bool(dt & kDefaultLeftMask),
                "missing_type": ("None", "Zero", "NaN", "NaN")[(dt >> 2) & 3],
                "internal_value": float(self.internal_value[idx]),
                "internal_weight": float(self.internal_weight[idx]),
                "internal_count": int(self.internal_count[idx]),
                "left_child": memo[int(self.left_child[idx])],
                "right_child": memo[int(self.right_child[idx])],
            }
        return memo[index]

    def _linear_json(self, leaf: int) -> dict:
        return {"leaf_const": float(self.leaf_const[leaf]),
                "leaf_features": list(self.leaf_features[leaf]),
                "leaf_coeff": [float(c) for c in self.leaf_coeff[leaf]]}

    def to_json(self) -> dict:
        """JSON-dump structure (reference: Tree::ToJSON,
        src/io/tree.cpp:411-429)."""
        d = {"num_leaves": int(self.num_leaves),
             "num_cat": int(self.num_cat),
             "shrinkage": float(self.shrinkage)}
        if self.num_leaves == 1:
            d["tree_structure"] = {"leaf_value": float(self.leaf_value[0])}
            if self.is_linear:
                d["tree_structure"].update(self._linear_json(0))
        else:
            d["tree_structure"] = self._node_to_json(0)
        return d

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
        if int(kv.get("is_linear", 0)):
            t.is_linear = True
            t.leaf_const = np.zeros(max(nl, 1))
            t.leaf_const[:nl] = farr("leaf_const", nl)
            nfeat = [int(v) for v in kv.get("num_features", "").split()]
            flat_feats = [int(v)
                          for v in kv.get("leaf_features", "").split()]
            flat_coef = [float(v)
                         for v in kv.get("leaf_coeff", "").split()]
            t.leaf_features, t.leaf_coeff = [], []
            pos = 0
            for c in nfeat:
                t.leaf_features.append(flat_feats[pos:pos + c])
                t.leaf_coeff.append(flat_coef[pos:pos + c])
                pos += c
            while len(t.leaf_features) < t.max_leaves:
                t.leaf_features.append([])
                t.leaf_coeff.append([])
        t.num_cat = int(kv.get("num_cat", 0))
        if t.num_cat > 0:
            t.cat_boundaries = [int(v)
                                for v in kv["cat_boundaries"].split()]
            t.cat_threshold = [int(v) for v in kv["cat_threshold"].split()]
            # a categorical node's threshold is its split index; cast
            # only those (a numerical one may be NaN)
            cat_nodes = (t.decision_type[:ni] & kCategoricalMask) != 0
            t.threshold_in_bin[:ni] = np.where(
                cat_nodes,
                np.where(cat_nodes, t.threshold[:ni], 0).astype(np.int32),
                t.threshold_in_bin[:ni])
        return t

    # ------------------------------------------------------------------
    @property
    def num_internal(self) -> int:
        return max(self.num_leaves - 1, 0)

    def structure_depth(self) -> int:
        """Most root-to-leaf hops, from the child arrays alone (the trip
        count of the device walks; ``leaf_depth`` is a train-time field
        that trees carried across from other sources may leave zero)."""
        best = 0
        stack = [(0, 0)] if self.num_leaves > 1 else []
        while stack:
            idx, d = stack.pop()
            if idx < 0:
                best = max(best, d)
                continue
            stack.append((int(self.left_child[idx]), d + 1))
            stack.append((int(self.right_child[idx]), d + 1))
        return best


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
