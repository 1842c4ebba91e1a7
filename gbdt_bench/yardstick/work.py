"""The least bytes and operations of a training iteration's and a
prediction call's work. Each input is counted as read once and each
output as written once, whatever a kernel reads again."""
from __future__ import annotations

import json
import os
from typing import Iterable, Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))

#: bytes of one row's gradient and hessian (f32 each) and of a row index
GH_BYTES = 8
INDEX_BYTES = 4
#: channels of a histogram bin: gradient, hessian and count, 4 bytes each
HIST_BIN_BYTES = 12
#: adds of one row into one feature's histogram: gradient, hessian, count
ADDS_PER_ROW_FEATURE = 3
#: lambdarank's operations per doc pair (difference, exp, products, sums)
PAIR_OPS = 10


def peaks() -> dict:
    with open(os.path.join(_HERE, "peaks.json")) as fh:
        return json.load(fh)


def child_counts(tree):
    """(left rows, right rows) of each internal node."""
    def rows(c):
        return tree.leaf_count[~c] if c < 0 else tree.internal_count[c]
    return [(rows(l), rows(r)) for l, r in zip(tree.left_child,
                                              tree.right_child)]


def histogram_work(trees: Iterable, rows: int, features: int,
                   max_bin: int):
    """(bytes, adds) of the trees' histograms: the root's rows and each
    split's smaller child's rows, each read once (its bins, gradient and
    hessian, and for a child its row index), and one histogram written
    for the root and for each split."""
    bin_bytes = 1 if max_bin < 256 else 2
    width = features * (max_bin + 1) * HIST_BIN_BYTES
    total_b = total_ops = 0.0
    for t in trees:
        direct = sum(min(lc, rc) for lc, rc in child_counts(t))
        built = rows + direct
        total_b += (built * (features * bin_bytes + GH_BYTES)
                    + direct * INDEX_BYTES + (1 + len(t.left_child)) * width)
        total_ops += built * features * ADDS_PER_ROW_FEATURE
    return total_b, total_ops


def iteration_work(trees: Sequence, rows: int, features: int, max_bin: int,
                   group: Optional[np.ndarray] = None):
    """(bytes, f32 operations) of the iterations that grew ``trees``:
    their histograms; per iteration the gradient pass (score and label
    read, gradient and hessian written; lambdarank's pairs as
    operations) and the score update (score read and written, a leaf id
    read); each split's partition of its rows (a bin and a row index
    read, a row index written)."""
    b, ops = histogram_work(trees, rows, features, max_bin)
    it = len(trees)
    b += it * rows * (4 + 4 + GH_BYTES)
    b += it * rows * (4 + 4 + INDEX_BYTES)
    for t in trees:
        b += float(np.sum(t.internal_count)) * (1 + 2 * INDEX_BYTES)
    if group is not None:
        pairs = float(np.sum(np.asarray(group, np.float64) ** 2))
        ops += it * pairs * PAIR_OPS
    return b, ops


def least_seconds(nbytes: float, f32_ops: float) -> float:
    p = peaks()
    return max(nbytes / p["hbm_bytes_per_s"], f32_ops / p["f32_flops_per_s"])


def predict_call_bytes(rows: int, features: int, trees: Sequence) -> float:
    """One call: its rows read (f32), the forest's node tables (feature,
    f64 threshold, two children) and leaf values (f64) read, one f64
    output per row written."""
    nodes = sum(len(t.left_child) for t in trees)
    leaves = sum(t.num_leaves for t in trees)
    return rows * features * 4 + nodes * (4 + 8 + 4 + 4) + leaves * 8 \
        + rows * 8
