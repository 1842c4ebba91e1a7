"""Carry binning and model state across from plain NumPy data.

With these two functions a caller holding another package's bin
boundaries and trees — for example ``lightgbm_tpu``'s
``BinMapper.to_dict()`` output and its ``Tree`` arrays — hands them to
this package unchanged, so both compute from exactly the same bins and
the same model.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .io.binning import BinMapper, BinType
from .models.tree import Tree
from .utils.log import unsupported

_TREE_INT_FIELDS = ("split_feature", "split_feature_inner",
                    "threshold_in_bin", "decision_type", "left_child",
                    "right_child", "leaf_count", "internal_count",
                    "leaf_parent", "leaf_depth")
_TREE_FLOAT_FIELDS = ("threshold", "split_gain", "leaf_value",
                      "leaf_weight", "internal_value", "internal_weight")


def bin_mappers_from_numpy(dicts: Sequence[Optional[dict]]
                           ) -> List[BinMapper]:
    """One BinMapper per column from ``BinMapper.to_dict()``-shaped
    dicts (keys ``num_bin``, ``missing_type``, ``is_trivial``,
    ``sparse_rate``, ``bin_type``, ``bin_upper_bound``, ``min_val``,
    ``max_val``, ``default_bin``, ``most_freq_bin``). ``None`` stands for
    a trivial (unused) column. Pass the result as ``mappers=`` to
    ``BinnedDataset.from_matrix``."""
    out = []
    for d in dicts:
        m = BinMapper()
        if d is not None:
            if int(d["bin_type"]) != BinType.NUMERICAL:
                unsupported("categorical bin mappers", "item 11")
            m.num_bin = int(d["num_bin"])
            m.missing_type = int(d["missing_type"])
            m.is_trivial = bool(d["is_trivial"])
            m.sparse_rate = float(d["sparse_rate"])
            m.bin_upper_bound = np.asarray(d["bin_upper_bound"],
                                           dtype=np.float64)
            m.min_val = float(d["min_val"])
            m.max_val = float(d["max_val"])
            m.default_bin = int(d["default_bin"])
            m.most_freq_bin = int(d["most_freq_bin"])
        out.append(m)
    return out


def trees_from_numpy(dicts: Sequence[Dict[str, object]]) -> List[Tree]:
    """Trees from per-tree dicts of arrays named as ``Tree``'s fields
    (``split_feature``, ``threshold``, ``threshold_in_bin``,
    ``decision_type``, ``left_child``, ``right_child``, ``leaf_value``,
    counts, weights, …) plus ``num_leaves`` and ``shrinkage``. Missing
    optional arrays stay zero."""
    trees = []
    for d in dicts:
        if int(d.get("num_cat", 0)) > 0:
            unsupported("categorical trees", "item 11")
        if bool(d.get("is_linear", False)):
            unsupported("linear trees", "item 15")
        nl = int(d["num_leaves"])
        t = Tree(max(nl, 1))
        t.num_leaves = nl
        t.shrinkage = float(d.get("shrinkage", 1.0))
        for names, dtype in ((_TREE_INT_FIELDS, None),
                             (_TREE_FLOAT_FIELDS, np.float64)):
            for name in names:
                if name not in d:
                    continue
                dst = getattr(t, name)
                src = np.asarray(d[name])
                n = min(len(src), len(dst))
                dst[:n] = src[:n].astype(dtype or dst.dtype)
        trees.append(t)
    return trees
