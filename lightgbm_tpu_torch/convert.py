"""Carry binning and model state across from plain NumPy data.

With these functions a caller holding another package's bin boundaries,
EFB layout and trees — for example ``lightgbm_tpu``'s
``BinMapper.to_dict()`` output, its ``BundleLayout`` and its ``Tree``
arrays — hands them to this package unchanged, so both compute from
exactly the same bins, the same bundles and the same model.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .io.binning import BinMapper
from .io.efb import BundleLayout
from .models.tree import Tree

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
    ``max_val``, ``default_bin``, ``most_freq_bin``, and for a
    categorical column ``bin_2_categorical`` and ``categorical_2_bin``).
    ``None`` stands for a trivial (unused) column. Pass the result as
    ``mappers=`` to ``BinnedDataset.from_matrix``."""
    return [BinMapper() if d is None else BinMapper.from_dict(d)
            for d in dicts]


def bundle_layout_from_numpy(layout) -> BundleLayout:
    """An EFB layout from another package's ``BundleLayout`` (any object
    or mapping with its fields: ``groups``, ``group_of``, ``member``,
    ``unmap``, ``needs_zero_fix``, ``gidx_g``, ``gidx_b``,
    ``num_bundled_bins``). Pass it as ``bundle=`` beside ``mappers=`` to
    ``BinnedDataset.from_matrix``."""
    get = (layout.get if isinstance(layout, dict)
           else lambda k: getattr(layout, k))
    return BundleLayout(
        groups=[[int(f) for f in g] for g in get("groups")],
        group_of=np.asarray(get("group_of"), dtype=np.int32),
        member=np.asarray(get("member"), dtype=np.int32),
        unmap=np.asarray(get("unmap"), dtype=np.int32),
        needs_zero_fix=np.asarray(get("needs_zero_fix"), dtype=bool),
        gidx_g=np.asarray(get("gidx_g"), dtype=np.int32),
        gidx_b=np.asarray(get("gidx_b"), dtype=np.int32),
        num_bundled_bins=int(get("num_bundled_bins")))


def trees_from_numpy(dicts: Sequence[Dict[str, object]]) -> List[Tree]:
    """Trees from per-tree dicts of arrays named as ``Tree``'s fields
    (``split_feature``, ``threshold``, ``threshold_in_bin``,
    ``decision_type``, ``left_child``, ``right_child``, ``leaf_value``,
    counts, weights, …) plus ``num_leaves`` and ``shrinkage``. A tree
    with categorical nodes also gives ``num_cat``, ``cat_boundaries``
    and ``cat_threshold`` (its bitset words), and may give
    ``cat_bin_masks`` (node -> bool mask over the node's bins, for the
    binned walks). A linear tree (``is_linear``) also gives
    ``leaf_const`` and, per leaf, ``leaf_features`` (original columns)
    and ``leaf_coeff``. Missing optional arrays stay zero."""
    trees = []
    for d in dicts:
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
        t.num_cat = int(d.get("num_cat", 0))
        if t.num_cat > 0:
            t.cat_boundaries = [int(v) for v in d["cat_boundaries"]]
            t.cat_threshold = [int(v) for v in d["cat_threshold"]]
        t.cat_bin_masks = {int(k): np.asarray(v, dtype=bool)
                           for k, v in dict(d.get("cat_bin_masks")
                                            or {}).items()}
        if bool(d.get("is_linear", False)):
            t.is_linear = True
            t.leaf_const = np.zeros(t.max_leaves)
            const = np.asarray(d["leaf_const"], dtype=np.float64)
            t.leaf_const[:min(len(const), t.max_leaves)] = \
                const[:t.max_leaves]
            feats = [[int(f) for f in fs] for fs in d["leaf_features"]]
            coefs = [[float(c) for c in cs] for cs in d["leaf_coeff"]]
            pad = [[] for _ in range(t.max_leaves - len(feats))]
            t.leaf_features = (feats + pad)[:t.max_leaves]
            t.leaf_coeff = (coefs + [[] for _ in pad])[:t.max_leaves]
        trees.append(t)
    return trees
