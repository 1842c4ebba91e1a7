"""Batch prediction: ``Booster.predict(X, predict_on_device=True)`` on
host batches of ``batch_rows`` rows, one after another in a closed loop,
as a batch-scoring job calls it.

Set-up makes the rows on the card from the seed (a sample that the model
is grown over, then a pool of ``pool_batches`` batches handed over as host
arrays), writes the model text from the seed in the tree shapes that the
mix names (``forest_gen.py``), loads it
with ``Booster(model_str=...)`` and calls ``predict`` on the mix's
``warmup_calls`` batches. A call that the stacked path declines would take
the host walk: the run counts it failed. The window cycles through the
pool until ``seconds`` have passed; each call is timed from its start
until its output is on the host. The outputs of calls drawn from the seed
(each with chance ``check_share``, and the last call) are kept and
checked once the window has closed."""
from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from .. import forest_gen
from ..data import generator_for, torch_generator
from ..harness import BENCH_DIR, Outcome, sync
from ..reference.model_text import parse_model
from ..reference.predict_check import PredictCheck
from ..trace import profiled


def run(r) -> Outcome:
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.obs import events

    cfg, mix, dev = r.config, r.traffic, r.device
    m = mix["model"]
    B, P = int(mix["batch_rows"]), int(mix["pool_batches"])
    spec = dict(cfg["data"], train_rows=int(m["sample_rows"]) + B * P,
                held_out_rows=0)
    X = generator_for(cfg["data"]["generator"])(spec, r.seed, dev)[
        "train"]["X"]
    F = X.shape[1]
    sample = torch.from_numpy(X[:int(m["sample_rows"])]).to(dev)
    shapes = forest_gen.load_shapes(os.path.join(
        BENCH_DIR, "traffic", m["shapes"]))
    arrays = forest_gen.grow(sample, shapes, int(m["trees"]),
                             int(m["max_bin"]), float(m["leaf_scale"]),
                             torch_generator(r.seed, 7, dev))
    del sample
    text = forest_gen.model_text(arrays, F)
    prof = forest_gen.depth_profile(
        [{"left": a, "right": b} for a, b, k in zip(
            arrays["left"], arrays["right"], arrays["num_leaves"] - 1)
         for a, b in [(a[:k], b[:k])]])
    r.log("model: %d trees, %d-%d leaves; depth %s" % (
        len(arrays["num_leaves"]), arrays["num_leaves"].min(),
        arrays["num_leaves"].max(), prof))
    pool = [np.ascontiguousarray(X[int(m["sample_rows"]) + i * B:
                                   int(m["sample_rows"]) + (i + 1) * B])
            for i in range(P)]
    del X
    declined = []
    events.register_event_callback(
        lambda ev: declined.append(ev) if ev.get("event") == "perf_warning"
        else None)
    bst = lgb.Booster(params={"device_type": "cpu"} if dev.type == "cpu"
                      else None, model_str=text)
    for i in range(int(mix["warmup_calls"])):
        bst.predict(pool[i % P], predict_on_device=True)
    sync(dev)
    setup_s = time.perf_counter() - r.t0
    r.log("set-up %.3f s" % setup_s)

    keep = np.random.default_rng([int(r.seed) % (1 << 63), 11]).random(
        1 << 20) < float(mix["check_share"])
    kept, lat = [], []
    calls, failed = 0, 0
    start = time.perf_counter()
    while True:
        i = calls % P
        t = time.perf_counter()
        before = len(declined)
        out = bst.predict(pool[i], predict_on_device=True)
        lat.append(time.perf_counter() - t)
        failed += len(declined) > before
        if calls < len(keep) and keep[calls]:
            kept.append((i, out))
        calls += 1
        if time.perf_counter() - start >= r.seconds:
            break
    window_s = time.perf_counter() - start
    kept.append((i, out))
    r.log("window %.3f s, %d calls, ms each: min %.3f median %.3f max %.3f"
          % (window_s, calls, 1e3 * min(lat), 1e3 * float(np.median(lat)),
             1e3 * max(lat)))
    profile = None
    if r.trace:
        with profiled(dev) as box:
            for j in range(int(mix["profiled_calls"])):
                bst.predict(pool[j % P], predict_on_device=True)
        profile = box[0]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    events.register_event_callback(None)
    del bst
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    r.layer.update(
        kind="predict", window_s=window_s, calls=calls,
        s_per_call=window_s / calls, batch_rows=B, features=F,
        model_trees=parse_model(text)["trees"], profile=profile)
    t_check = time.perf_counter()
    numbers = PredictCheck(text, dev).run((pool[i], out) for i, out in kept)
    numbers["declined"] = float(len(declined))
    r.log("reference check %.1f s over %d calls" % (
        time.perf_counter() - t_check, len(kept)))
    return Outcome(
        e2e={"predict_rows_per_s": calls * B / window_s,
             "predict_p95_ms": 1e3 * float(np.percentile(lat, 95)),
             "setup_s": setup_s},
        attempted=calls, failed=failed, memory_peak_bytes=int(peak),
        numbers=numbers)
