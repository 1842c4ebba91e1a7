"""Readings that the correctness limits are set from, in one process.

    python3 gbdt_bench/calibrate.py --workload mslr.train --seeds 3,4,5 \\
        --seconds 20 --variants sound,q16,q8,unchanged,half,altered

runs the cell once per seed and variant, each with data made anew from
the seed, and prints one JSON line per run with every number the check
compares (``--out FILE`` appends the lines to a file too). The variants:

- ``sound``: the program as the configuration states;
- the control: for training ``bf16``, the program with its gradients and
  hessians rounded to bfloat16 before the tree learner (the
  configuration states f32), and ``q16`` / ``q8``, the program's own
  quantized-gradient path (16- or 8-bit gradients);
  for prediction ``f32``, the reference walk in f32 put in the program's
  place (the configuration states f64 leaf sums);
- the faults, planted in the program: ``unchanged`` (a step that returns
  its state unchanged: ``Booster.update`` trains nothing, ``predict``
  returns the previous call's output), ``half`` (half of the batch left
  out: the tree learner takes the second half of the rows out of the
  bag; ``predict`` scores half the rows and gives the rest their mean),
  ``altered`` (an answer altered where it is produced: one leaf value of
  each tree doubled, or one output of each call off by one part in
  10^4) and, for training, ``altered_metric`` (the held-out metric off
  by one part in 10^6), ``partial_scan`` (a tree learner that scans half
  of the features at each node: the program's ``feature_fraction_bynode``
  0.5, which the check does not know of) and ``no_leaf_floor`` (a tree
  learner that ignores ``min_sum_hessian_in_leaf``: the program run with
  LightGBM's default 1e-3 while the check holds the stated floor).

``--small`` shrinks the cell to a size a CPU test run holds and runs it
on the CPU."""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def variant(name: str, run):
    """A context manager that plants ``name`` into the program for the
    run ``run`` (a :class:`gbdt_bench.harness.Run`), whose config it may
    also change."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.treelearner.serial import SerialTreeLearner
    train = run.traffic["driver"] == "train"
    if name == "sound":
        return contextlib.nullcontext()
    if name in ("q16", "q8") and train:
        run.config["params"].update(use_quantized_grad=True,
                                    quant_grad_bits=int(name[1:]))
        return contextlib.nullcontext()
    if name == "bf16" and train:
        plain = SerialTreeLearner.train

        def bf16(self, grad, hess, *a, **k):
            return plain(self, grad.bfloat16().float(),
                         hess.bfloat16().float(), *a, **k)
        return _patched(SerialTreeLearner, "train", bf16)
    if name == "unchanged" and train:
        return _patched(lgb.Booster, "update", lambda self, *a, **k: False)
    if name == "half" and train:
        plain = SerialTreeLearner.train

        def half(self, grad, hess, bag=None):
            n = grad.shape[0]
            bag = torch.ones_like(grad) if bag is None else bag.clone()
            bag[n // 2:] = 0
            return plain(self, grad, hess, bag)
        return _patched(SerialTreeLearner, "train", half)
    if name == "altered" and train:
        plain = SerialTreeLearner.train

        def altered(self, *a, **k):
            tree, leaf_of_row = plain(self, *a, **k)
            if tree is not None:
                tree.leaf_value[0] *= 2.0
            return tree, leaf_of_row
        return _patched(SerialTreeLearner, "train", altered)
    if name in ("partial_scan", "no_leaf_floor") and train:
        extra = ({"feature_fraction_bynode": 0.5} if name == "partial_scan"
                 else {"min_sum_hessian_in_leaf": 1e-3})
        plain_init = lgb.Booster.__init__

        def init(self, params=None, *a, **k):
            plain_init(self, dict(params or {}, **extra), *a, **k)
        return _patched(lgb.Booster, "__init__", init)
    if name == "altered_metric" and train:
        plain_eval = lgb.Booster.eval_valid

        def altered_metric(self, *a, **k):
            return [(d, m, v * (1.0 + 1e-6), hb)
                    for d, m, v, hb in plain_eval(self, *a, **k)]
        return _patched(lgb.Booster, "eval_valid", altered_metric)
    plain_predict = lgb.Booster.predict
    if name == "f32" and not train:
        from gbdt_bench.reference.predict_check import PredictCheck

        def f32(self, X, *a, **k):
            if not hasattr(self, "_f32_control"):
                self._f32_control = PredictCheck(
                    self.model_to_string(), run.device, torch.float32)
            return self._f32_control.expected(X)
        return _patched(lgb.Booster, "predict", f32)
    if name == "unchanged" and not train:
        def stale(self, X, *a, **k):
            out = plain_predict(self, X, *a, **k)
            prev = getattr(self, "_prev_out", out)
            self._prev_out = out
            return prev
        return _patched(lgb.Booster, "predict", stale)
    if name == "half" and not train:
        def half_rows(self, X, *a, **k):
            n = X.shape[0] // 2
            out = plain_predict(self, X[:n], *a, **k)
            return np.concatenate([out, np.full(X.shape[0] - n, out.mean())])
        return _patched(lgb.Booster, "predict", half_rows)
    if name == "altered" and not train:
        def altered_out(self, X, *a, **k):
            out = plain_predict(self, X, *a, **k).copy()
            out[0] *= 1.0 + 1e-4
            return out
        return _patched(lgb.Booster, "predict", altered_out)
    raise ValueError("no variant %r for this cell" % name)


def shrink(run) -> None:
    """The cell at a size a CPU test run holds."""
    d = run.config["data"]
    if d["generator"] == "higgs":
        d.update(train_rows=20000, held_out_rows=4000)
        run.config["params"].update(num_leaves=31)
    else:
        d.update(train_rows=12000, train_queries=120, held_out_queries=30,
                 max_query_len=300)
        # 120 queries' lambdarank hessians sum to a few hundred: the
        # stated floor of 100 would leave trees of 2-4 leaves
        run.config["params"].update(num_leaves=31,
                                    min_sum_hessian_in_leaf=1.0)
    if run.traffic["driver"] == "predict":
        run.traffic.update(batch_rows=1024, pool_batches=3,
                           check_share=0.5)
        run.traffic["model"].update(trees=12, sample_rows=2048)


def readings(workload: str, seed: int, seconds: float, name: str,
             device, small: bool = False, log=None) -> dict:
    from gbdt_bench import harness
    log = log or (lambda m: None)
    r = harness.load_run(workload, seed, seconds, False, device,
                         time.perf_counter(), log)
    if small:
        shrink(r)
    with variant(name, r):
        out = harness.run_cell(r)
    return {"workload": workload, "seed": seed, "variant": name,
            "numbers": out.numbers, "e2e": out.e2e,
            "attempted": out.attempted,
            "failed": out.failed,
            "correct": harness.verdict(out.numbers, r.limits, out.failed)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--variants", default="sound")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, _ROOT)
    import torch
    if args.small:
        torch.set_num_threads(4)
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        print("calibrate: no CUDA card (use --small for the CPU)",
              file=sys.stderr)
        return 2
    for seed in [int(s) for s in args.seeds.split(",")]:
        for name in args.variants.split(","):
            t = time.perf_counter()
            rec = readings(args.workload, seed, args.seconds, name, device,
                           args.small)
            rec["seconds"] = time.perf_counter() - t
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(line + "\n")
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
