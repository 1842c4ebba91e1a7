"""The port's telemetry (``lightgbm_tpu_torch/obs``) against the JAX
package's (``lightgbm_tpu/obs``) on the CPU.

Levels: (a) equal values; a set or sequence compare is exact. Each
package is configured through its own programmatic calls
(``configure``, ``enable``, ``register_event_callback``), never through
an environment variable that both would read.

- the stage timer's totals, counts and percentile columns, the registry
  snapshot and the reservoir percentiles: (a), on the same recorded
  values;
- the event sink's JSON-lines round trip and buffer order;
- ``register_log_callback`` and the ``log_fatal`` event: the same
  message and event keys;
- one small training run (binary, 2,000 rows, 15 leaves, 3 rounds, one
  valid set), looped and with ``tpu_batch_iterations=2``: the same stage
  names, event kinds and event keys in both packages (the compile
  records, ``jit::*`` and ``jit_trace`` in the JAX package, are its
  backend's and have no CPU counterpart in the port);
- the kernel-build and graph-capture counters as far as the CPU reaches
  them: a build through a stand-in ``nvcc``, and the capture record.
"""
import os
import stat
import sys

import numpy as np
import pytest

import lightgbm_tpu as ref_lgb
from lightgbm_tpu.obs import events as ref_events
from lightgbm_tpu.obs import health as ref_health
from lightgbm_tpu.obs.registry import MetricsRegistry as RefRegistry
from lightgbm_tpu.obs.registry import StageTimer as RefTimer
from lightgbm_tpu.obs.registry import registry as ref_registry
from lightgbm_tpu.utils import log as ref_log

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch import csrc
from lightgbm_tpu_torch.obs import compile as obs_compile
from lightgbm_tpu_torch.obs import events, health
from lightgbm_tpu_torch.obs.registry import MetricsRegistry, StageTimer
from lightgbm_tpu_torch.obs.registry import kHistCap, registry
from lightgbm_tpu_torch.utils import log, timer
from lightgbm_tpu_torch.utils.log import LightGBMError
from _torch_watch_env import watch_env_defaults  # noqa: F401

CPU = {"device_type": "cpu"}


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Both packages share process-wide registries and sinks: leave them
    as they were."""
    yield
    for ev, lg, reg in ((events, log, registry),
                        (ref_events, ref_log, ref_registry)):
        ev.configure(None)
        ev.register_event_callback(None)
        lg.register_log_callback(None)
        reg.disable()
        reg.timer.sampling = False


def _values(n, seed=0):
    return np.random.RandomState(seed).exponential(1e-3, n).tolist()


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------

def test_stage_timer_totals_and_counts_match_reference():
    """Totals, counts and the p50 / p99 columns of ``phases()`` (a)."""
    port, ref = MetricsRegistry(), RefRegistry()
    for reg in (port, ref):
        reg.enable()
        for i, v in enumerate(_values(300)):
            reg.timer.record("stage_%d" % (i % 3), v)
    assert port.phases() == ref.phases()
    stats = port.timer.stats()
    assert sorted(stats) == ["stage_0", "stage_1", "stage_2"]
    assert [stats[k][1] for k in sorted(stats)] == [100, 100, 100]


def test_stage_timer_scope_records_only_when_enabled():
    t, rt = StageTimer(), RefTimer()
    for tm in (t, rt):
        with tm.scope("off"):
            pass
        tm.enable()
        for _ in range(3):
            with tm.scope("on"):
                pass
    assert set(t.totals) == set(rt.totals) == {"on"}
    assert t.counts["on"] == rt.counts["on"] == 3
    # the timer shim is the registry's timer, as in the JAX package
    assert timer.global_timer is registry.timer


def test_registry_snapshot_matches_reference():
    port, ref = MetricsRegistry(), RefRegistry()
    for reg in (port, ref):
        reg.inc("a")
        reg.inc("a", 4)
        reg.inc("serve/requests", 7)
        reg.gauge("g", 2.5)
        reg.gauge("serve/queue_depth", 3)
        for v in _values(50, seed=1):
            reg.observe("serve/latency_ms", v * 1e3)
        reg.enable()
        reg.timer.record("stage", 0.25)
    assert port.snapshot() == ref.snapshot()
    port.reset()
    assert port.snapshot() == {"phases": {}, "counters": {}, "gauges": {},
                               "hists": {}}


@pytest.mark.parametrize("q", [0, 1, 25, 50, 90, 99, 99.9, 100])
def test_reservoir_percentiles_match_reference(q):
    """More observations than the reservoir holds: the oldest age out in
    both packages alike."""
    port, ref = MetricsRegistry(), RefRegistry()
    obs = _values(kHistCap + 500, seed=2)
    for reg in (port, ref):
        for v in obs:
            reg.observe("lat", v)
    assert len(port.hist_values["lat"]) == kHistCap
    assert port.hist_counts["lat"] == kHistCap + 500
    assert port.percentile("lat", q) == ref.percentile("lat", q)
    assert port.percentile("missing", q) == 0.0


# ----------------------------------------------------------------------
# events and the log sink
# ----------------------------------------------------------------------

def test_event_sink_round_trip_and_buffer_order(tmp_path):
    """Emits below the buffer limit stay in memory; a flush writes them
    in order; numpy payloads come back as JSON values; records follow
    the sink path that was active when they were emitted."""
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    events.configure(a)
    for i in range(5):
        events.emit("buffered", seq=i, arr=np.arange(2), f=np.float32(i))
    assert not os.path.exists(a) or os.path.getsize(a) == 0
    events.configure(b)                    # flushes a's records
    events.emit("moved", seq=5)
    events.configure(None)
    recs = events.read_jsonl(a)
    assert [r["seq"] for r in recs] == list(range(5))
    assert recs[3]["arr"] == [0, 1] and recs[3]["f"] == 3.0
    assert all(r["run_id"] == events.run_id() for r in recs)
    assert [r["event"] for r in events.read_jsonl(b)] == ["moved"]


def test_event_callback_gets_every_emit():
    seen = []
    assert events.emit("nothing") is None           # no sink: no record
    events.register_event_callback(seen.append)
    rec = events.emit("x", n=np.int64(3))
    assert seen == [rec] and rec["n"] == 3 and rec["event"] == "x"


def test_log_callback_and_log_fatal_match_reference():
    """A registered log sink sees the fatal line; the fatal emits one
    ``log_fatal`` event with the message, in both packages."""
    out = {}
    for name, lg, ev in (("port", log, events), ("ref", ref_log,
                                                  ref_events)):
        lines, recs = [], []
        lg.register_log_callback(lines.append)
        ev.register_event_callback(recs.append)
        with pytest.raises(Exception, match="broken input 7"):
            lg.fatal("broken input %d", 7)
        lg.register_log_callback(None)
        ev.register_event_callback(None)
        out[name] = (lines, recs)
    for lines, recs in out.values():
        assert len(lines) == 1 and lines[0].endswith(
            "[Fatal] broken input 7\n")
        assert [r["event"] for r in recs] == ["log_fatal"]
        assert recs[0]["message"] == "broken input 7"
    assert sorted(out["port"][1][0]) == sorted(out["ref"][1][0])
    with pytest.raises(LightGBMError):
        log.fatal("raises the port's error type")


# ----------------------------------------------------------------------
# one training run in both packages
# ----------------------------------------------------------------------

def _rows(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 10)
    return X, (X[:, 0] + X[:, 1] > 0).astype(float)


def _names_and_kinds(pkg, ev, reg, health_mod, params):
    seen = []
    ev.register_event_callback(seen.append)
    reg.reset()
    reg.enable()
    health_mod._reported = False          # one backend event per run
    X, y = _rows(2000, 0)
    Xv, yv = _rows(500, 1)
    tr = pkg.Dataset(X, label=y)
    bst = pkg.train(params, tr, num_boost_round=3,
                    valid_sets=[pkg.Dataset(Xv, label=yv, reference=tr)])
    ev.register_event_callback(None)
    reg.disable()
    stages = {k for k in reg.timer.stats() if not k.startswith("jit::")}
    kinds = {}
    for rec in seen:
        if rec["event"] != "jit_trace":
            kinds.setdefault(rec["event"], set()).update(rec)
    counts = {k: sum(r["event"] == k for r in seen) for k in kinds}
    return bst, stages, kinds, counts


@pytest.mark.parametrize("batched", [False, True])
def test_stage_names_and_event_kinds_match_reference(batched):
    """Level (a) on the sets: the same stage scopes, event kinds and keys
    of each kind, and as many ``train_iter`` and ``eval`` events."""
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "metric": "auc"}
    ref_params = dict(params)
    if batched:
        params["tpu_batch_iterations"] = 2
        ref_params.update(tpu_batch_iterations=2, tree_learner="data",
                          mesh_shape="data=1")
    port = _names_and_kinds(lgb, events, registry, health,
                            dict(params, **CPU))
    ref = _names_and_kinds(ref_lgb, ref_events, ref_registry, ref_health,
                           ref_params)
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3] == ref[3]
    expected = {"io::find_bins", "io::apply_bins", "io::stage_bins_device",
                "gbdt::gradients", "gbdt::bagging", "tree::grow",
                "tree::stage_gh", "tree::root_histogram",
                "tree::split_batches", "tree::apply_records",
                "gbdt::score_update", "gbdt::eval_metrics"}
    assert expected <= port[1]
    assert ("tree::train_batch_dispatch" in port[1]) == batched
    assert {"dataset", "backend", "train_iter", "eval"} <= set(port[2])
    assert ("train_batch" in port[2]) == batched
    assert port[3]["train_iter"] == 3
    assert port[0].model_to_string().count("Tree=") == 3


def test_sample_mode_lands_readiness_on_the_cpu():
    """Sample mode on CPU tensors: every watched stage lands its
    ``::ready`` record (a CPU value is ready when watched) and the
    fences stay off."""
    registry.reset()
    registry.enable(sampling=True)
    assert not registry.fence()
    X, y = _rows(600, 3)
    lgb.train(dict(CPU, objective="binary", num_leaves=7, verbose=-1),
              lgb.Dataset(X, label=y), num_boost_round=2)
    assert registry.drain_ready(timeout=30)
    phases = registry.phases()
    for stage in ("gbdt::gradients", "tree::stage_gh",
                  "tree::root_histogram", "gbdt::score_update"):
        assert phases[stage + "::ready"]["calls"] >= 1, stage


# ----------------------------------------------------------------------
# kernel builds and graph captures
# ----------------------------------------------------------------------

def _fake_nvcc(tmp_path):
    """An executable that writes the file after ``-o``, as nvcc does."""
    path = tmp_path / "nvcc"
    path.write_text("#!%s\nimport sys\nargs = sys.argv\n"
                    "open(args[args.index('-o') + 1], 'wb').write(b'x')\n"
                    % sys.executable)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_kernel_build_is_counted_with_its_event(tmp_path, monkeypatch):
    """Each nvcc run counts once under ``kernel_build/<library>`` and
    emits a ``kernel_build`` event with its seconds; a library already
    built is not built (or counted) again."""
    monkeypatch.setattr(csrc, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(csrc, "_nvcc", lambda: _fake_nvcc(tmp_path))
    monkeypatch.setattr(csrc, "library_path", lambda n: os.path.join(
        str(tmp_path / "build"), "lib%s.so" % n))
    registry.reset()
    registry.enable()
    seen = []
    events.register_event_callback(seen.append)
    csrc.build(["histogram", "histogram_u16"])
    csrc.build(["histogram"])
    assert obs_compile.build_counts() == {"histogram": 1,
                                          "histogram_u16": 1}
    builds = [r for r in seen if r["event"] == "kernel_build"]
    assert sorted(r["library"] for r in builds) == ["histogram",
                                                    "histogram_u16"]
    assert all(r["nvcc_seconds"] >= 0 and r["count"] == 1 for r in builds)
    assert registry.phases()["build::histogram"]["calls"] == 1


def test_graph_capture_counter_and_recapture_warning():
    """The capture record (the card's ``_capture`` calls it): a counter,
    a ``graph_capture`` event, and one warning past the threshold, which
    ``registry.reset()`` re-arms."""
    registry.reset()
    seen, lines = [], []
    events.register_event_callback(seen.append)
    log.register_log_callback(lines.append)
    log.set_verbosity(0)
    thr = obs_compile._warn_threshold()
    for _ in range(thr + 2):
        obs_compile.record_graph_capture("serial.split_step", 0.001)
    assert obs_compile.capture_count("serial.split_step") == thr + 2
    assert obs_compile.capture_counts() == {"serial.split_step": thr + 2}
    assert sum("captured %d times" % (thr + 1) in ln for ln in lines) == 1
    caps = [r for r in seen if r["event"] == "graph_capture"]
    assert len(caps) == thr + 2 and caps[-1]["count"] == thr + 2
    assert caps[0]["graph"] == "serial.split_step"
    registry.reset()
    assert "serial.split_step" not in obs_compile._WARNED
    assert obs_compile.capture_counts() == {}


def test_cpu_run_counts_no_capture_and_records_the_cpu_backend():
    """A CPU run captures no graph and builds no kernel; its backend
    event says ``cpu``."""
    registry.reset()
    seen = []
    events.register_event_callback(seen.append)
    health._reported = False
    X, y = _rows(400, 4)
    lgb.train(dict(CPU, objective="binary", num_leaves=7, verbose=-1),
              lgb.Dataset(X, label=y), num_boost_round=2)
    assert obs_compile.capture_counts() == {}
    assert obs_compile.build_counts() == {}
    backend = [r for r in seen if r["event"] == "backend"]
    assert [(r["platform"], r["num_devices"], r["source"])
            for r in backend] == [("cpu", 1, "gbdt_init")]
    assert registry.gauges["backend"] == "cpu"


def test_forced_predict_decline_emits_the_references_event():
    """A forced stacked predict that must decline (``pred_early_stop``)
    warns and emits a ``perf_warning`` event with the reference's
    component, in both packages."""
    X, y = _rows(600, 5)
    out = {}
    for name, pkg, ev, extra in (("port", lgb, events, CPU),
                                 ("ref", ref_lgb, ref_events, {})):
        bst = pkg.train(dict(extra, objective="binary", num_leaves=7,
                             verbose=-1), pkg.Dataset(X, label=y),
                        num_boost_round=2)
        seen = []
        ev.register_event_callback(seen.append)
        bst.predict(X, predict_on_device=True, pred_early_stop=True)
        ev.register_event_callback(None)
        out[name] = sorted((r["event"], r.get("component"))
                           for r in seen if r["event"] == "perf_warning")
    assert out["port"] == out["ref"] == [("perf_warning",
                                          "serve.host_walk")]


def test_clear_gauges_and_percentile_since():
    """A new measurement window drops the gauges an earlier component
    left under a prefix, and nothing else; ``percentile(since=)`` reads
    only the samples observed after an ``observed()`` baseline, also
    once the reservoir has dropped older ones."""
    reg = MetricsRegistry()
    reg.gauge("quality/psi_max", 0.4)
    reg.gauge("quality/psi/feature/3", 0.4)
    reg.gauge("serve/models", 1)
    reg.clear_gauges("quality/")
    assert reg.gauges == {"serve/models": 1}
    for v in (1.0, 2.0, 300.0):
        reg.observe("serve/latency_ms", v)
    base = reg.observed("serve/latency_ms")
    assert base == 3
    assert reg.percentile("serve/latency_ms", 99.0, since=base) == 0.0
    reg.observe("serve/latency_ms", 7.0)
    assert reg.percentile("serve/latency_ms", 99.0, since=base) == 7.0
    assert reg.percentile("serve/latency_ms", 99.0) > 7.0
    for v in range(kHistCap + 10):
        reg.observe("serve/latency_ms", float(v % 5))
    # the window outgrew the reservoir: all of it is newer than base
    assert reg.percentile("serve/latency_ms", 100.0, since=base) == 4.0
    base = reg.observed("serve/latency_ms")
    reg.observe("serve/latency_ms", 9.0)
    assert reg.percentile("serve/latency_ms", 0.0, since=base) == 9.0