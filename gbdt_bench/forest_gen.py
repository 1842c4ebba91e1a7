"""A binary model text of LightGBM's format, grown from a seed in the shapes
of trees that the program grew.

Each tree takes the structure of one of the ``shapes`` (trees that the
``higgs`` configuration grew best-first by gain, written by ``shapes.py``):
its nodes, which child of each is a leaf, and the share of a node's rows
that goes left. The generator walks a sample of rows down it: each node
splits on a feature drawn at random, at the value of the feature's grid
that sends about the node's share of its sample rows left (a node that no
sample row reaches takes the value at that quantile of the whole sample).
A feature's grid holds ``max_bin - 1`` quantiles of the sample, as a
trained model's thresholds are its bin boundaries. Leaf values are drawn
from a normal of scale ``leaf_scale``. All trees grow in lockstep on the
device."""
from __future__ import annotations

import json
from typing import Dict, List

import numpy as np
import torch


def _fmt(x: float) -> str:
    return np.format_float_positional(np.float64(x), unique=True, trim="0")


def load_shapes(path: str) -> List[Dict]:
    with open(path) as fh:
        return json.load(fh)["trees"]


def leaf_depths(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Depth of each leaf of one tree (a stump's leaves are at depth 1)."""
    ni = len(left)
    if ni == 0:
        return np.zeros(1, np.int64)
    depth = np.zeros(ni, np.int64)
    out = np.zeros(ni + 1, np.int64)
    for p in range(ni):                 # children come after parents
        for c in (left[p], right[p]):
            if c < 0:
                out[~c] = depth[p] + 1
            else:
                depth[c] = depth[p] + 1
    return out


def depth_profile(trees) -> dict:
    """Max leaf depth over the trees, the mean of each tree's max, the
    mean leaf depth, and the passes of a walk that takes every tree to
    the next power of two of the deepest leaf."""
    d = [leaf_depths(np.asarray(t["left"]), np.asarray(t["right"]))
         for t in trees]
    mx = max(int(x.max()) for x in d)
    return {"max_depth": mx,
            "mean_tree_max_depth": float(np.mean([x.max() for x in d])),
            "mean_leaf_depth": float(np.mean(np.concatenate(d))),
            "walk_passes": 1 << max(mx - 1, 0).bit_length()}


def grow(X: torch.Tensor, shapes: List[Dict], trees: int, max_bin: int,
         leaf_scale: float, g: torch.Generator) -> dict:
    """Arrays of ``trees`` trees over the rows ``X`` [n, F] (f32, on the
    device of ``g``), each in the structure of one of ``shapes``."""
    T = trees
    n, F = X.shape
    dev = X.device
    K = len(shapes)
    perm = torch.randperm(K, generator=g, device=dev).cpu().numpy()
    pick = [shapes[perm[i % K]] for i in range(T)]
    ni = np.array([len(s["left"]) for s in pick], np.int64)
    NI = int(ni.max())
    left = np.full((T, NI), -1, np.int64)
    right = np.full((T, NI), -1, np.int64)
    share = np.full((T, NI), 0.5)
    for i, s in enumerate(pick):
        k = ni[i]
        left[i, :k], right[i, :k] = s["left"], s["right"]
        share[i, :k] = s["left_share"]
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    left_t, right_t, share_t = to(left), to(right), to(share)
    # each feature's grid: max_bin - 1 quantiles of the sample [F, G]
    srt_all = X.sort(dim=0).values.double()
    G = max_bin - 1
    at = (torch.arange(1, G + 1, device=dev, dtype=torch.float64)
          / max_bin * (n - 1)).round().long()
    grid = srt_all[at].t().contiguous()
    del srt_all
    tix = torch.arange(T, device=dev)
    # every sample row's place: an internal node (>= 0) or ~leaf
    pos = torch.zeros((T, n), dtype=torch.int64, device=dev)
    feat = torch.zeros((T, NI), dtype=torch.int64, device=dev)
    thr = torch.zeros((T, NI), dtype=torch.float64, device=dev)
    icount = torch.zeros((T, NI), dtype=torch.int64, device=dev)
    Xt = X.t()
    for s in range(NI):
        f = torch.randint(0, F, (T,), generator=g, device=dev)
        inn = pos == s
        cnt = inn.sum(dim=1)
        v = Xt[f].double()                                       # [T, n]
        srt = torch.where(inn, v, float("inf")).sort(dim=1).values
        q = share_t[:, s]
        k = ((cnt - 1).clamp(min=0).double() * q).floor().long()
        g_f = grid[f]                                            # [T, G]
        whole = g_f[tix, (q * (G - 1)).round().long()]
        target = torch.where(cnt > 0, srt[tix, k], whole)
        j = torch.searchsorted(g_f, target[:, None]).clamp(max=G - 1)
        t = g_f[tix, j[:, 0]]
        go_left = inn & (v <= t[:, None])
        pos = torch.where(go_left, left_t[:, s, None],
                          torch.where(inn, right_t[:, s, None], pos))
        feat[:, s], thr[:, s], icount[:, s] = f, t, cnt
    NL = NI + 1
    leaf_of = torch.where(pos < 0, ~pos, NL)
    count = torch.zeros((T, NL + 1), dtype=torch.int64, device=dev)
    count.scatter_add_(1, leaf_of, torch.ones_like(leaf_of))
    value = torch.randn((T, NL), generator=g, device=dev,
                        dtype=torch.float64) * leaf_scale
    out = {k: v.cpu().numpy() for k, v in dict(
        feat=feat, thr=thr, icount=icount, count=count[:, :NL],
        value=value).items()}
    out.update(left=left, right=right, num_leaves=ni + 1)
    return out


def model_text(a: dict, num_features: int) -> str:
    blocks: List[str] = []
    for i, L in enumerate(a["num_leaves"]):
        k = L - 1
        lines = ["num_leaves=%d" % L, "num_cat=0",
                 "split_feature=" + " ".join(map(str, a["feat"][i, :k])),
                 "split_gain=" + " ".join(["1"] * k),
                 "threshold=" + " ".join(_fmt(v) for v in a["thr"][i, :k]),
                 "decision_type=" + " ".join(["0"] * k),
                 "left_child=" + " ".join(map(str, a["left"][i, :k])),
                 "right_child=" + " ".join(map(str, a["right"][i, :k])),
                 "leaf_value=" + " ".join(_fmt(v)
                                          for v in a["value"][i, :L]),
                 "leaf_count=" + " ".join(map(str, a["count"][i, :L])),
                 "internal_count=" + " ".join(map(str, a["icount"][i, :k])),
                 "is_linear=0", "shrinkage=1", ""]
        blocks.append("Tree=%d\n%s\n" % (i, "\n".join(lines)))
    names = ["Column_%d" % j for j in range(num_features)]
    head = ["tree", "version=v3", "num_class=1", "num_tree_per_iteration=1",
            "label_index=0", "max_feature_idx=%d" % (num_features - 1),
            "objective=binary sigmoid:1",
            "feature_names=" + " ".join(names),
            "feature_infos=" + " ".join(["none"] * num_features),
            "tree_sizes=" + " ".join(str(len(b)) for b in blocks), ""]
    return "\n".join(head) + "\n" + "".join(blocks) + "end of trees\n"
