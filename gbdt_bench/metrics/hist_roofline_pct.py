"""hist_roofline_pct: the least time of the profiled iterations'
histogram work (yardstick.work.histogram_work at the card's peaks) over
the device time of the kernels named in ``hist_roofline_pct/*.txt``."""
from gbdt_bench.metrics import names_in
from gbdt_bench.yardstick import work


def read(ctx):
    p, trees = ctx.get("profile"), ctx.get("profiled_trees")
    if p is None or not trees:
        return None
    names = names_in(ctx, "hist_roofline_pct")
    us = sum(e - s for n, s, e in p.device if any(k in n for k in names))
    if us <= 0:
        return None
    b, ops = work.histogram_work(trees, ctx.rows, ctx.features, ctx.max_bin)
    return 100.0 * work.least_seconds(b, ops) / (us / 1e6)
