"""train_mfu_pct: the least time of the window's iterations' work
(yardstick.work.iteration_work at the card's peaks) over the window."""
from gbdt_bench.yardstick import work


def read(ctx):
    trees = ctx.get("window_trees")
    if not trees or not ctx.get("window_s"):
        return None
    b, ops = work.iteration_work(trees, ctx.rows, ctx.features, ctx.max_bin,
                                 ctx.group)
    return 100.0 * work.least_seconds(b, ops) / ctx.window_s
