"""Parse the model text of LightGBM's format (``Tree=`` blocks) into plain
arrays."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass
class PlainTree:
    num_leaves: int
    split_feature: np.ndarray     # [num_leaves - 1] int64
    threshold: np.ndarray         # [num_leaves - 1] f64
    decision_type: np.ndarray     # [num_leaves - 1] int64
    left_child: np.ndarray        # [num_leaves - 1] int64, ~leaf if < 0
    right_child: np.ndarray
    split_gain: np.ndarray        # [num_leaves - 1] f64
    internal_count: np.ndarray    # [num_leaves - 1] int64
    leaf_value: np.ndarray        # [num_leaves] f64
    leaf_count: np.ndarray        # [num_leaves] int64


def _arr(kv: Dict[str, str], key: str, n: int, dtype) -> np.ndarray:
    if key not in kv or n == 0:
        return np.zeros(n, dtype=dtype)
    return np.array(kv[key].split(), dtype=np.float64 if dtype == np.float64
                    else np.int64)[:n].astype(dtype)


def parse_tree(block: str) -> PlainTree:
    kv = {}
    for line in block.splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            kv[k.strip()] = v.strip()
    nl = int(kv["num_leaves"])
    if int(kv.get("num_cat", 0)) != 0:
        raise ValueError("categorical splits are outside this reference")
    if int(kv.get("is_linear", 0)) != 0:
        raise ValueError("linear trees are outside this reference")
    ni = nl - 1
    return PlainTree(
        num_leaves=nl,
        split_feature=_arr(kv, "split_feature", ni, np.int64),
        threshold=_arr(kv, "threshold", ni, np.float64),
        decision_type=_arr(kv, "decision_type", ni, np.int64),
        left_child=_arr(kv, "left_child", ni, np.int64),
        right_child=_arr(kv, "right_child", ni, np.int64),
        split_gain=_arr(kv, "split_gain", ni, np.float64),
        internal_count=_arr(kv, "internal_count", ni, np.int64),
        leaf_value=_arr(kv, "leaf_value", nl, np.float64),
        leaf_count=_arr(kv, "leaf_count", nl, np.int64))


def parse_model(text: str) -> Dict:
    """{"header": {key: value}, "trees": [PlainTree, ...]}."""
    head, _, rest = text.partition("\nTree=")
    header = {}
    for line in head.splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            header[k.strip()] = v.strip()
    trees: List[PlainTree] = []
    if rest:
        body = ("Tree=" + rest).split("end of trees")[0]
        for block in body.split("Tree=")[1:]:
            trees.append(parse_tree(block.split("\n", 1)[1]))
    return {"header": header, "trees": trees}
