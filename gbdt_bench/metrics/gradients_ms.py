"""gradients_ms: device ms per profiled iteration in which the operations
launched by the objective's ``get_gradients`` ran (the benchmark's fenced
range ``bench::gradients`` around the call)."""
from gbdt_bench.trace import union_us


def read(ctx):
    p, n = ctx.get("profile"), ctx.get("profiled_iterations")
    if p is None or not n:
        return None
    us = union_us([(s, e) for _, s, e in p.ops_in("bench::gradients")])
    if us <= 0:
        return None
    return us / 1e3 / n
