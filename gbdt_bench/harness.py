"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

A cell's pieces are found by name: the configuration's file from its
``configs`` entry, the traffic mix in ``traffic/<mix>.json`` (whose
``driver`` names a module of ``drivers/``), the limits of the correctness
check in ``checks/<cell>.json``, and each per-layer metric's reader in
``metrics/<name>.py``, or, for a name with a dot, ``metrics/<part before
the first dot>.py``. A later cell, mix or metric is added as files and
entries; no file here changes."""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
#: the checkout's root, which holds ``BENCHMARK.json`` and the program
ROOT = os.path.dirname(BENCH_DIR)
#: top-level modules that may not be loaded in the process that prints a
#: result (the JAX package is ``lightgbm_tpu``; the program's name begins
#: with it, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "lightgbm_tpu")


def sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


@dataclass
class Outcome:
    """What a driver hands back: the end-to-end metrics, the calls or
    iterations of the window and how many failed, the card's peak memory
    (read before the check), and each number the check compared."""
    e2e: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    numbers: Dict[str, float]


@dataclass
class Run:
    """One run of a cell: its entries and files, the command's arguments,
    the device, the process's start (``t0``, ``time.perf_counter``), and
    ``layer``, the driver's record for the per-layer readers."""
    spec: dict
    cell: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    log: Callable[[str], None]
    layer: Dict = field(default_factory=dict)


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_run(workload: str, seed: int, seconds: float, trace: bool,
             device, t0: float, log: Callable[[str], None]) -> Run:
    spec = _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit("no workload %r in BENCHMARK.json" % workload)
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _json(os.path.join(ROOT, configs[cell["config"]]["file"]))
    traffic = _json(os.path.join(BENCH_DIR, "traffic",
                                 cell["traffic"] + ".json"))
    limits = _json(os.path.join(BENCH_DIR, "checks", workload + ".json"))
    return Run(spec=spec, cell=cell, config=config,
               traffic=traffic, limits=limits["limits"], seed=seed,
               seconds=seconds, trace=trace, device=device, t0=t0, log=log)


def metric_reader(name: str):
    """The ``read(ctx)`` of a per-layer metric's file."""
    for stem in (name, name.split(".", 1)[0]):
        path = os.path.join(BENCH_DIR, "metrics", stem + ".py")
        if os.path.exists(path):
            mod_name = "gbdt_bench.metrics._" + stem.replace(".", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError("no reader for per-layer metric %r" % name)


def _reports(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            failed: int) -> bool:
    """Correct when every number is at or within its limit (a number that
    is not a number fails) and no call failed."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError("checks without a reading: %s" % sorted(missing))
    return failed == 0 and all(numbers[k] <= limits[k] for k in limits)


def result(run: Run, out: Outcome, device_kind: str,
           platform: str) -> dict:
    wl = run.cell["name"]
    metrics: Dict[str, dict] = {}
    extra_device: Dict[str, float] = {}
    breakdown = None
    if not run.trace:
        for m in run.spec["end_to_end"]:
            if _reports(m, wl):
                metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                      "unit": m["unit"]}
    else:
        ctx = Layer(run.layer, run.config, run.traffic)
        for m in run.spec["per_layer"]:
            if not _reports(m, wl):
                continue
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        prof = run.layer.get("profile")
        if prof is not None and prof.device and prof.window_us():
            extra_device = {"busy_s": prof.busy_us() / 1e6,
                            "window_s": prof.window_us() / 1e6}
            breakdown = {"device_ops": prof.top_ops(),
                         "idle_gaps": prof.idle_gaps()}
    correct = verdict(out.numbers, run.limits, out.failed)
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics,
            "device": dict({"platform": platform, "kind": device_kind,
                            "count": int(run.cell["chips"]),
                            "memory_peak_bytes": out.memory_peak_bytes},
                           **extra_device)}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": out.numbers[k], "limit": run.limits[k]}
                      for k in run.limits}
    return line


class Layer:
    """What the per-layer readers read: the driver's record of the run
    (``profile``, ``window_s``, trees, shapes, stage times), and the
    cell's configuration and traffic mix."""

    def __init__(self, record: dict, config: dict, traffic: dict):
        self.__dict__.update(record)
        self.config = config
        self.traffic = traffic
        self.bench_dir = BENCH_DIR

    def get(self, name: str, default=None):
        return self.__dict__.get(name, default)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(run: Run) -> Outcome:
    from .drivers import driver_for
    return driver_for(run.traffic["driver"])(run)
