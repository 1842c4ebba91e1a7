"""ops_per_split: device operations (kernels, copies, fills) launched by
the tree learner's ``train`` call (the benchmark's fenced range
``bench::learner`` around it) per split, in the profiled iterations. The
objective's operations and the score update lie outside it."""
from gbdt_bench.metrics import splits


def read(ctx):
    p, trees = ctx.get("profile"), ctx.get("profiled_trees")
    n = splits(trees or [])
    if p is None or n == 0:
        return None
    ops = p.ops_in("bench::learner")
    if not ops:
        return None
    return len(ops) / n
