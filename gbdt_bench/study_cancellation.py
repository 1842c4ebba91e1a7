"""Why lambdarank's largest leaf and gain gaps are large relative to the
values: the study behind ``leaf_gap`` and ``gain_gap``'s units, on the CPU.

    python3 gbdt_bench/study_cancellation.py --seeds 1,2,3 \\
        [--rows 200000 --queries 1700 --iterations 4]

trains the ``mslr`` configuration at a cut size on the CPU (255 leaves,
the stated settings), follows it with the reference, and prints per seed:
the largest relative leaf and gain gaps (|program - reference| / |reference|,
the measure a fixed relative limit holds), the leaf and split behind
them with how far their f32 sums cancel (A / |G|: the sum of the absolute
gradient terms over the gradient sum; C / |G|: the same over the root-to-
leaf path of histograms the program subtracts), and the same gaps in the
units of ``reference/train_check.py``. If the relative gaps follow C / |G|
(their ratio to u C / |G| stays bounded while they themselves swing), the
gaps are the rounding of cancelling f32 sums; a defect would show as a gap
far above u C / |G|."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def study(seed: int, rows: int, queries: int, iterations: int) -> dict:
    import torch
    from gbdt_bench import harness
    from gbdt_bench.data import generator_for
    from gbdt_bench.reference.train_check import U32, TrainCheck
    import lightgbm_tpu_torch as lgb
    r = harness.load_run("mslr.train", seed, 0.0, False,
                         torch.device("cpu"), time.perf_counter(),
                         lambda m: None)
    spec = dict(r.config["data"], train_rows=rows, train_queries=queries,
                held_out_queries=0)
    tr = generator_for("mslr")(spec, seed, torch.device("cpu"))["train"]
    params = dict(r.config["params"], device_type="cpu")
    ds = lgb.Dataset(tr["X"], label=tr["label"], group=tr["group"],
                     params=params)
    bst = lgb.Booster(params, ds)
    for _ in range(iterations):
        bst.update()
    chk = TrainCheck(collect=True).run(
        torch.from_numpy(tr["X"]), tr["label"], tr["group"],
        r.config["params"], bst.model_to_string(),
        bst.inner.train_score[:, 0].numpy(), iterations)
    lv = np.array(chk.leaves, dtype=np.float64)
    sp = np.array(chk.splits, dtype=np.float64)
    i, j = int(np.argmax(lv[:, 1])), int(np.argmax(sp[:, 1]))
    # relative gap over the predicted relative rounding u C / |G|
    follow = lv[:, 1] / (U32 * lv[:, 3])
    return {
        "seed": seed, "leaves": len(lv), "splits": len(sp),
        "max_rel_leaf_gap": lv[i, 1], "median_rel_leaf_gap":
            float(np.median(lv[:, 1])),
        "its_rows": int(lv[i, 0]), "its_A_over_G": lv[i, 2],
        "its_C_over_G": lv[i, 3], "its_units": lv[i, 4],
        "max_rel_gain_gap": sp[j, 1], "its_split_rows": int(sp[j, 0]),
        "its_scale_over_gain": sp[j, 2], "its_gain_units": sp[j, 3],
        "leaf_gap": chk.n["leaf_gap"], "gain_gap": chk.n["gain_gap"],
        "rel_over_uC_max": float(follow.max()),
        "rel_over_uC_median": float(np.median(follow)),
        "corr_log_rel_log_C_over_G": float(np.corrcoef(
            np.log(lv[:, 1] + 1e-30), np.log(lv[:, 3]))[0, 1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--rows", type=int, default=200000)
    ap.add_argument("--queries", type=int, default=1700)
    ap.add_argument("--iterations", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path.insert(0, _ROOT)
    import torch
    torch.set_num_threads(4)
    for s in args.seeds.split(","):
        print(json.dumps(study(int(s), args.rows, args.queries,
                               args.iterations)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
