"""split_ms: host wall ms of the registry's whole-tree stages named in
``split_ms/*.txt`` (timed in sample mode over the window) per split
grown in the window."""
from gbdt_bench.metrics import names_in, splits


def read(ctx):
    stages, trees = ctx.get("stages"), ctx.get("window_trees")
    n = splits(trees or [])
    total = sum(stages.get(k, 0.0) for k in names_in(ctx, "split_ms")) \
        if stages else 0.0
    if n == 0 or total <= 0:
        return None
    return 1e3 * total / n
