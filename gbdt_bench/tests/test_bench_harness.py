"""The harness: a configuration, a traffic mix and a per-layer metric
added as new files are found by name; nothing it or the reference loads
is JAX or the JAX package; the command refuses a machine without a card."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "gbdt_bench")
FORBIDDEN = {"jax", "jaxlib", "flax", "lightgbm_tpu"}


def _python(code: str, path, timeout=600):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=timeout, cwd=path[0])


_RUN_TINY = """
import json, sys, time, torch
torch.set_num_threads(2)
from gbdt_bench import harness
r = harness.load_run(%r, 3, 0.2, True, torch.device("cpu"),
                     time.perf_counter(), lambda m: None)
%s
out = harness.run_cell(r)
line = harness.result(r, out, "cpu", "cpu")
mods = sorted({m.split(".", 1)[0] for m in sys.modules})
print(json.dumps({"line": line, "bench_dir": harness.BENCH_DIR,
                  "modules": mods, "forbidden": harness.forbidden_modules()}))
"""


def test_added_files_are_found_by_name(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "gbdt_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy)
    before = {str(p): p.read_bytes()
              for p in (copy / "gbdt_bench").rglob("*") if p.is_file()}
    g = copy / "gbdt_bench"
    cfg = json.loads((g / "configs" / "higgs.json").read_text())
    cfg["name"] = "tiny"
    cfg["data"].update(train_rows=3000, held_out_rows=500)
    cfg["params"].update(num_leaves=7, min_data_in_leaf=20)
    (g / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (g / "traffic" / "tiny_loop.json").write_text(json.dumps(
        {"driver": "train", "warmup_iterations": 1,
         "profiled_iterations": 1}))
    (g / "checks" / "tiny.loop.json").write_text(
        (g / "checks" / "higgs.train.json").read_text())
    (g / "metrics" / "trees_made.py").write_text(
        "def read(ctx):\n"
        "    return float(len(ctx.window_trees) + ctx.profiled_iterations)\n")
    spec = json.loads((copy / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "gbdt_bench/configs/tiny.json",
                            "reduced": ["train_rows"], "why": "test"})
    spec["workloads"].append({"name": "tiny.loop", "config": "tiny",
                              "traffic": "tiny_loop", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "trees_made", "unit": "trees",
                              "better": "higher", "source": "program_counter",
                              "layer": "test", "moves": "train_s_per_iter",
                              "workloads": ["tiny.loop"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    res = _python(_RUN_TINY % ("tiny.loop", ""), [str(copy), ROOT])
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bench_dir"] == str(g)
    line = out["line"]
    assert line["correct"], line["checks"]
    assert line["metrics"]["trees_made"]["value"] == line["attempted"] + 1
    # a metric that lists other cells is not read here
    assert set(line["metrics"]) == {"trees_made"}
    # the files that were there are as they were
    assert all(Path(p).read_bytes() == b for p, b in before.items())


def test_no_jax_in_the_run_and_no_program_in_the_reference():
    res = _python(_RUN_TINY % ("higgs.predict", (
        "r.traffic.update(batch_rows=512, pool_batches=2)\n"
        "r.traffic['model'].update(trees=4, sample_rows=512)")),
        [ROOT])
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["line"]["correct"]
    assert "lightgbm_tpu_torch" in out["modules"]
    assert not FORBIDDEN & set(out["modules"]) and out["forbidden"] == []
    res = _python(
        "import sys\n"
        "import gbdt_bench.reference.train_check\n"
        "import gbdt_bench.reference.predict_check\n"
        "import gbdt_bench.reference.objectives.binary\n"
        "import gbdt_bench.reference.objectives.lambdarank\n"
        "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))",
        [ROOT])
    assert res.returncode == 0, res.stderr[-3000:]
    mods = set(res.stdout.split())
    assert not (FORBIDDEN | {"lightgbm_tpu_torch"}) & mods


def test_refuses_a_machine_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    res = subprocess.run(
        [sys.executable, "gbdt_bench/run.py", "--workload", "higgs.train",
         "--seed", "4294967297", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 2
    assert res.stdout == ""


@pytest.mark.cuda
def test_one_short_run_on_the_card(cuda_card):
    res = subprocess.run(
        [sys.executable, "gbdt_bench/run.py", "--workload", "higgs.predict",
         "--seed", "4294967297", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
