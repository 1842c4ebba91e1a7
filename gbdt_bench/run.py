"""Run one cell of the benchmark once on the card and print its result.

    python3 gbdt_bench/run.py --workload higgs.train --seed 7 \\
        --seconds 20 --trace 0

from the root of a checkout that holds the program. The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number the correctness check compared, beside
its limit); the same numbers end standard error. Without a CUDA card, or
with fewer cards than the cell asks for, it prints no result and exits
with code 2; with a JAX module loaded once the window has closed, with
code 3."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, ".bench_cache", _sub)


def _log(msg: str) -> None:
    """A line on standard error with the seconds since the start and the
    process's CPU seconds (all threads) so far."""
    print("[gbdt_bench %.1f s, cpu %.1f s] %s" % (
        time.perf_counter() - T0, time.process_time(), msg),
        file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from gbdt_bench import harness

    device = torch.device("cuda", 0)
    run = harness.load_run(args.workload, args.seed, args.seconds,
                           bool(args.trace), device, T0, _log)
    chips = int(run.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("gbdt_bench: the cell needs %d CUDA card(s); %d visible"
              % (chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    out = harness.run_cell(run)
    line = harness.result(run, out, torch.cuda.get_device_name(device),
                          "gpu")
    bad = harness.forbidden_modules()
    if bad:
        print("gbdt_bench: modules of JAX or the JAX package are loaded: %s"
              % ", ".join(bad), file=sys.stderr)
        return 3
    print("correct: %s" % line["correct"], file=sys.stderr)
    for name, c in line["checks"].items():
        print("check %s: %r (limit %r)" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
