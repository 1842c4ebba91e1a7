"""Refit: new leaf values for an existing model's trees from new data.

Port of ``lightgbm_tpu/boosting/refit.py::refit_model_device``
(reference: GBDT::RefitTree, src/boosting/gbdt.cpp:250): the tree
structures stay; every leaf value becomes ``decay * old + (1 - decay) *
shrinkage * optimum``, the optimum taken over the new rows in the leaf
at the scores of the trees before it. The leaf of every row in every
tree comes from one walk of the stacked forest on the device, the
per-leaf sums from ``ops/refit.py``, and the [T, NL] leaf table comes
back to the host once.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..io.dataset import Metadata
from ..objective import create_objective
from ..ops.refit import refit_tree_step
from ..utils import next_pow2


def refit_model_device(gbdt, X: np.ndarray, y: np.ndarray,
                       weight: np.ndarray = None, decay_rate: float = 0.9,
                       forest=None) -> None:
    """Refit ``gbdt``'s leaf values on (X, y[, weight]) in place.
    ``forest`` may be a :class:`~..serve.StackedForest` of the same
    trees on the device to walk (a refresh loop reuses one: refit keeps
    the structure). The objective is a copy of the model's, bound to the
    new labels (the model's own keeps its training rows). Sums run in
    f32, as in the reference."""
    models = gbdt.models
    if not models:
        return
    config = gbdt.config
    objective = (copy.copy(gbdt.objective) if gbdt.objective is not None
                 else create_objective(config.objective, config))
    y = np.asarray(y, dtype=np.float64)
    md = Metadata(len(y))
    md.set_label(y)
    if weight is not None:
        md.set_weights(np.asarray(weight, dtype=np.float64))
    if forest is None:
        from ..serve import StackedForest
        forest = StackedForest.from_gbdt(gbdt)
    device = forest.device
    objective.init(md, len(y), device)

    leaf_ids = forest.leaves_device(X)              # [T, n] on the device
    T = len(models)
    K = gbdt.num_tree_per_iteration
    NL = int(next_pow2(max(t.num_leaves for t in models)))
    old = np.zeros((T, NL), dtype=np.float32)
    for i, t in enumerate(models):
        old[i, :t.num_leaves] = t.leaf_value[:t.num_leaves]
    old_dev = torch.from_numpy(old).to(device)
    n = len(y)
    score = torch.zeros((n,) if K == 1 else (n, K), dtype=torch.float32,
                        device=device)

    def f32(v):
        return torch.tensor(float(v), dtype=torch.float32, device=device)

    mds = float(config.max_delta_step)
    l1, l2 = f32(config.lambda_l1), f32(config.lambda_l2)
    max_delta = f32(mds if mds > 0 else float("inf"))
    shrink, decay = f32(gbdt.shrinkage_rate), f32(decay_rate)
    rows = []
    for i in range(T):
        g, h = objective.get_gradients(score)
        row, score = refit_tree_step(score, g, h, i % K, i, leaf_ids,
                                     old_dev, NL, l1, l2, max_delta, shrink,
                                     decay)
        rows.append(row)
    vals = torch.stack(rows).cpu().numpy().astype(np.float64)
    for i, tree in enumerate(models):
        for leaf in range(tree.num_leaves):
            tree.set_leaf_output(leaf, float(vals[i, leaf]))
