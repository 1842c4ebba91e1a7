"""Training: ``Booster.update()`` on one Booster built from a constructed
Dataset with no validation set, iteration after iteration.

Set-up makes the rows on the card from the seed and hands them to the
program as host arrays, bins them (the training rows and the held-out
rows against the training bins), builds the Booster and runs the mix's
``warmup_iterations``, the first of which builds the kernels and captures
the split step. The window then runs whole iterations until ``seconds``
have passed and ends at a synchronize. A traced run times the registry's
stages in the window (sample mode, no fences) and then profiles the mix's
``profiled_iterations``. The check follows every tree the run grew."""
from __future__ import annotations

import gc
import resource
import time

import numpy as np
import torch

from ..data import generator_for
from ..harness import Outcome, sync
from ..reference.model_text import parse_model
from ..reference.train_check import TrainCheck
from ..trace import fence_method, profiled


def _marks():
    return (time.perf_counter(), time.thread_time(), time.process_time(),
            resource.getrusage(resource.RUSAGE_SELF).ru_minflt)


def _eval_held_out(bst, valid) -> dict:
    bst.add_valid(valid, "held_out")
    return {name: float(v) for _, name, v, _ in bst.eval_valid()}


def run(r) -> Outcome:
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.obs.registry import registry

    cfg, mix, dev = r.config, r.traffic, r.device
    r.log("imports and card context")
    data = generator_for(cfg["data"]["generator"])(cfg["data"], r.seed, dev)
    tr, ho = data["train"], data.get("held_out")
    r.log("rows made and on the host")
    params = dict(cfg["params"])
    if dev.type == "cpu":
        params["device_type"] = "cpu"
    ds = lgb.Dataset(tr["X"], label=tr["label"], group=tr["group"],
                     params=params).construct()
    r.log("training rows binned")
    valid = None
    if ho is not None:
        valid = lgb.Dataset(ho["X"], label=ho["label"], group=ho["group"],
                            reference=ds).construct()
        r.log("held-out rows binned")
    bst = lgb.Booster(params, ds)
    r.log("booster built")
    warm = int(mix["warmup_iterations"])
    for i in range(warm):
        bst.update()
        sync(dev)
        r.log("warm-up iteration %d" % (i + 1))
    setup_s = time.perf_counter() - r.t0
    r.log("set-up %.3f s" % setup_s)

    if r.trace:
        registry.reset()
        registry.enable(sampling=True)
    iters = 0
    # per iteration: wall, the main thread's and the process's CPU time,
    # the process's minor page faults
    marks = [_marks()]
    start = time.perf_counter()
    while True:
        bst.update()
        iters += 1
        marks.append(_marks())
        if marks[-1][0] - start >= r.seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - start
    d = np.diff(np.array(marks), axis=0)
    steps = d[:, 0]
    r.log("window %.3f s, %d iterations, s each: min %.4f median %.4f "
          "max %.4f" % (window_s, iters, steps.min(), np.median(steps),
                        steps.max()))
    r.log("each iteration's wall / main thread / process CPU ms and minor "
          "faults: %s" % " ".join("%.0f/%.0f/%.0f/%d" % (
              1e3 * a, 1e3 * b, 1e3 * c, f) for a, b, c, f in d))
    stages, profile, prof_iters = {}, None, 0
    if r.trace:
        stages = {k: v[0] for k, v in registry.timer.stats().items()}
        registry.disable()
        registry.drain_ready()
        prof_iters = int(mix["profiled_iterations"])
        obj, learner = bst.inner.objective, bst.inner.learner
        fence_method(obj, "get_gradients", "gradients", dev)
        fence_method(learner, "train", "learner", dev)
        with profiled(dev) as box:
            for _ in range(prof_iters):
                bst.update()
        del obj.get_gradients, learner.train
        profile = box[0]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    text = bst.model_to_string()
    score = bst.inner.train_score[:, 0].cpu().numpy().copy()
    prog_metrics = _eval_held_out(bst, valid) if valid is not None else None
    del bst, ds, valid
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    trees = parse_model(text)["trees"]
    r.layer.update(
        kind="train", window_s=window_s, iterations=iters,
        window_trees=trees[warm:warm + iters],
        profiled_trees=trees[warm + iters:warm + iters + prof_iters],
        profiled_iterations=prof_iters, profile=profile, stages=stages,
        rows=int(tr["X"].shape[0]), features=int(tr["X"].shape[1]),
        max_bin=int(params.get("max_bin", 255)), group=tr["group"])

    t_check = time.perf_counter()
    X = torch.from_numpy(tr["X"]).to(dev)
    held = None
    if ho is not None:
        held = {"X": torch.from_numpy(ho["X"]).to(dev), "label": ho["label"],
                "group": ho["group"], "metrics": prog_metrics}
    check = TrainCheck().run(X, tr["label"], tr["group"], cfg["params"],
                             text, score, warm + iters + prof_iters,
                             held_out=held)
    r.log("reference check %.1f s over %d trees; worst: %s"
          % (time.perf_counter() - t_check, len(trees), check.worst))
    return Outcome(
        e2e={"train_s_per_iter": window_s / iters, "setup_s": setup_s},
        attempted=iters, failed=0, memory_peak_bytes=int(peak),
        numbers=check.numbers())
