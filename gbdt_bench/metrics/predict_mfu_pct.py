"""predict_mfu_pct: the least time of one call's bytes
(yardstick.work.predict_call_bytes at the card's memory rate) over the
window's mean time per call."""
from gbdt_bench.yardstick import work


def read(ctx):
    if not ctx.get("calls"):
        return None
    b = work.predict_call_bytes(ctx.batch_rows, ctx.features,
                                ctx.model_trees)
    return 100.0 * work.least_seconds(b, 0.0) / ctx.s_per_call
