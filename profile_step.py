"""Profile one tree of the whole-tree loop on the card with torch.profiler.

Three learners at Covertype's shape (``chip_smoke.make_covertype_like``:
581,012 rows, 7 classes, 255 leaves): phase 9's 54 columns with EFB on
(bundled) and with ``enable_bundle=false``, and phase 13's categorical
form (12 columns, ``categorical_feature=[10, 11]``). Each trains one
round, so its split step is captured as a CUDA graph, then grows one more
tree on synthetic gradients from a seed: twice without the profiler (the
tree's wall ms), then once under ``torch.profiler`` (CPU and CUDA
activities). For each learner it prints one JSON line: splits, wall ms,
device operations (kernels, and copies and fills) per tree and per split,
device busy ms (the union of their intervals), its share of the
profiled tree's wall time, and the kernels that take the most time.

Run from the repo root on a machine with a CUDA card:
``python3 profile_step.py``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from typing import Dict, List, Tuple


def busy_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_summary(events, wall_ms: float, splits: int) -> Dict:
    """Counts and times of the device events of one profiled tree;
    ``events`` are ``(name, start_us, end_us)``."""
    kernels = [ev for ev in events
               if not ev[0].startswith(("Memcpy", "Memset"))]
    by_name = defaultdict(lambda: [0, 0.0])
    for name, s, e in kernels:
        by_name[name][0] += 1
        by_name[name][1] += e - s
    busy = busy_us([(s, e) for _, s, e in events]) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {
        "device_ops": len(events), "kernels": len(kernels),
        "kernels_per_split": round(len(kernels) / max(splits, 1), 1),
        "device_busy_ms": round(busy, 3),
        "device_busy_share": round(busy / wall_ms, 4) if wall_ms else None,
        "top_kernels": [{"name": n[:80], "count": c, "ms": round(t / 1e3, 3)}
                        for n, (c, t) in top]}


def profile_tree(learner, gh) -> Dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, _ = learner._grow_fused(gh)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    splits = tree.num_leaves - 1
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learner._grow_fused(gh)
        torch.cuda.synchronize()
        prof_wall = 1e3 * (time.perf_counter() - t0)
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.device_type == cuda]
    out = {"splits": splits, "wall_ms": [round(w, 3) for w in walls],
           "ms_per_split": round(walls[-1] / max(splits, 1), 3),
           "profiled_wall_ms": round(prof_wall, 3)}
    out.update(device_summary(events, prof_wall, splits))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device is visible", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs
    import lightgbm_tpu_torch as lgb
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print("card: %s" % smi.stdout.strip(), flush=True)
    params = {"objective": "multiclass", "num_class": 7, "num_leaves": 255,
              "learning_rate": 0.1, "max_bin": 255, "verbosity": -1}
    n = cs.COVERTYPE_ROWS
    X, y = cs.make_covertype_like(n, seed=9)
    Xc, yc = cs.make_covertype_categorical(n, seed=9)
    cases = (("phase 9 bundled", X, y, params),
             ("phase 9 unbundled", X, y, dict(params, enable_bundle=False)),
             ("phase 13 categorical", Xc, yc,
              dict(params, categorical_feature=[10, 11])))
    g = torch.Generator(device="cuda")
    g.manual_seed(21)
    grad = torch.rand(n, generator=g, device="cuda") - 0.5
    hess = torch.rand(n, generator=g, device="cuda") * 0.25
    gh = torch.stack([grad, hess, torch.ones_like(grad),
                      torch.ones_like(grad)], dim=1)
    for what, Xi, yi, p in cases:
        bst = lgb.train(p, lgb.Dataset(Xi, label=yi, params=p),
                        num_boost_round=1)
        learner = bst.inner.learner
        res = {"learner": what, "bundled": learner._bundled,
               "columns": int(learner.bins.shape[1])}
        res.update(profile_tree(learner, gh))
        print(json.dumps(res), flush=True)
        del bst, learner
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
