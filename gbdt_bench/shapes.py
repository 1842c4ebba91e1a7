"""Write the tree shapes that ``forest_gen.py`` grows the prediction cell's
model in: trees that the program grows best-first by gain.

    python3 gbdt_bench/shapes.py --workload higgs.train --seed 20 \\
        --iterations 500 --keep 25 --out gbdt_bench/traffic/shapes/higgs.json

trains the cell's configuration on the card for ``--iterations`` boosting
iterations from the seed's rows, and writes the structure of ``--keep``
of its trees, evenly spaced over the run, with the deepest tree among
them: each internal node's children (``~leaf`` for a leaf) and the share
of the node's rows that goes left. It prints the depth profile of every
tree of the run and of the kept ones. ``--small`` runs a cut cell on the
CPU."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def shape_of(tree) -> dict:
    rows = lambda c: (tree.leaf_count[~c] if c < 0  # noqa: E731
                      else tree.internal_count[c])
    share = [round(float(rows(lc)) / max(float(n), 1.0), 5)
             for lc, n in zip(tree.left_child, tree.internal_count)]
    return {"left": [int(c) for c in tree.left_child],
            "right": [int(c) for c in tree.right_child],
            "left_share": share}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="higgs.train")
    ap.add_argument("--seed", type=int, default=20)
    ap.add_argument("--iterations", type=int, default=500)
    ap.add_argument("--keep", type=int, default=25)
    ap.add_argument("--out", required=True)
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, _ROOT)
    import torch
    from gbdt_bench import calibrate, forest_gen, harness
    from gbdt_bench.data import generator_for
    from gbdt_bench.reference.model_text import parse_model
    import lightgbm_tpu_torch as lgb
    if args.small:
        dev = torch.device("cpu")
    elif torch.cuda.is_available():
        dev = torch.device("cuda", 0)
    else:
        print("shapes: no CUDA card (use --small for the CPU)",
              file=sys.stderr)
        return 2
    r = harness.load_run(args.workload, args.seed, 0.0, False, dev,
                         time.perf_counter(), lambda m: None)
    if args.small:
        calibrate.shrink(r)
    cfg = r.config
    tr = generator_for(cfg["data"]["generator"])(
        dict(cfg["data"], held_out_rows=0, held_out_queries=0), args.seed,
        dev)["train"]
    params = dict(cfg["params"])
    if dev.type == "cpu":
        params["device_type"] = "cpu"
    ds = lgb.Dataset(tr["X"], label=tr["label"], group=tr["group"],
                     params=params).construct()
    bst = lgb.Booster(params, ds)
    t0 = time.perf_counter()
    for _ in range(args.iterations):
        bst.update()
    secs = time.perf_counter() - t0
    trees = parse_model(bst.model_to_string())["trees"]
    shapes = [shape_of(t) for t in trees]
    deepest = int(np.argmax([forest_gen.leaf_depths(
        np.asarray(s["left"]), np.asarray(s["right"])).max()
        for s in shapes]))
    keep = sorted(set(np.linspace(0, len(trees) - 1, args.keep)
                      .round().astype(int).tolist()) | {deepest})
    out = {"workload": args.workload, "seed": args.seed,
           "iterations": args.iterations, "kept": keep,
           "profile_all": forest_gen.depth_profile(shapes),
           "profile_kept": forest_gen.depth_profile(
               [shapes[i] for i in keep]),
           "trees": [shapes[i] for i in keep]}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, separators=(",", ":"))
        fh.write("\n")
    print(json.dumps({k: out[k] for k in ("workload", "seed", "iterations",
                                          "kept", "profile_all",
                                          "profile_kept")}))
    print("max depth of each tree: %s" % [int(forest_gen.leaf_depths(
        np.asarray(s["left"]), np.asarray(s["right"])).max())
        for s in shapes])
    print("leaves per tree: min %d max %d; %.3f s an iteration"
          % (min(t.num_leaves for t in trees),
             max(t.num_leaves for t in trees), secs / args.iterations))
    return 0


if __name__ == "__main__":
    sys.exit(main())
