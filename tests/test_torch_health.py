"""The port's SLO watchdog (``lightgbm_tpu_torch/obs/health.py``)
against the JAX package's on the CPU.

One scripted snapshot stream goes through a :class:`Watchdog` of each
package, with ``default_rules`` and with ``fleet_rules``: the same
``health`` events fire in the same order, with the same fields (level
a). The one rule whose input differs by backend is the recapture watch:
the JAX package counts new jit traces (``jit_trace/<fn>``), the port new
kernel builds and CUDA graph captures (``graph_capture/<name>``,
``kernel_build/<library>``); the stream feeds each package its own
counter, and that rule's ``detail`` text names what it counted.
"""
import numpy as np
import pytest

from lightgbm_tpu.obs import events as ref_events
from lightgbm_tpu.obs import health as ref_health
from lightgbm_tpu.obs.registry import MetricsRegistry as RefRegistry

from lightgbm_tpu_torch.obs import events, health
from lightgbm_tpu_torch.obs.registry import MetricsRegistry
from _torch_watch_env import watch_env_defaults  # noqa: F401


@pytest.fixture(autouse=True)
def _clean():
    yield
    events.register_event_callback(None)
    ref_events.register_event_callback(None)


def _stream(compile_key):
    """Snapshots of a run that limps: a recapture storm, queue
    saturation that clears and comes back, trace drops, retries, a shed
    storm, an open breaker, a refresh window over its SLO, and drift
    gauges from a quality monitor."""
    snaps = []
    counters, gauges = {}, {}

    def snap():
        snaps.append({"phases": {}, "counters": dict(counters),
                      "gauges": dict(gauges), "hists": {}})

    for step in range(14):
        counters[compile_key] = counters.get(compile_key, 0) + (
            12 if step == 2 else 1)
        gauges["serve/queue_depth"] = 2048 if step in (3, 4, 9) else 10
        if step == 5:
            counters["trace/dropped_events"] = 64
        if step == 6:
            counters["ft/retries"] = 20
            counters["ft/retry_exhausted"] = 1
        counters["serve/requests"] = 100 * (step + 1)
        counters["serve/shed_total"] = 0 if step < 7 else 60 * (step - 6)
        gauges["serve/breaker_state/m"] = 2 if step in (8, 9) else 0
        gauges["refresh/active"] = 1 if 10 <= step <= 11 else 0
        gauges["refresh/serve_p99_ms"] = 400.0 if step == 11 else 50.0
        gauges["quality/psi_max"] = 0.4 if step >= 12 else 0.01
        gauges["quality/psi/feature/3"] = gauges["quality/psi_max"]
        gauges["quality/score_psi"] = 0.3 if step == 13 else 0.0
        snap()
    return snaps


def _fleet_stream():
    snaps = []
    for step in range(8):
        ranks = {
            "0/train": {"rank": "0", "stage_seconds": 10.0 + step,
                        "age_s": 0.5, "shed_total": 0, "requests": 0},
            "1/train": {"rank": "1",
                        "stage_seconds": 1.0 if step in (2, 3, 6) else
                        9.0 + step,
                        "age_s": 40.0 if step == 4 else 0.5,
                        "shed_total": 0, "requests": 0},
            "0/serve": {"rank": "0", "stage_seconds": 0.0, "age_s": 0.2,
                        "shed_total": 0 if step < 5 else 30 * step,
                        "requests": 100 * step},
        }
        snaps.append({"phases": {}, "counters": {}, "gauges": {},
                      "hists": {}, "fleet": {"ranks": ranks,
                                             "stale_after_s": 30.0}})
    return snaps


def _run(health_mod, events_mod, reg, rules, snaps):
    seen = []
    events_mod.register_event_callback(seen.append)
    wd = health_mod.Watchdog(reg, rules=rules)
    for s in snaps:
        wd.evaluate(s)
    events_mod.register_event_callback(None)
    return [{k: v for k, v in r.items() if k not in ("ts", "run_id")}
            for r in seen if r["event"] == "health"], wd


def test_default_rules_fire_the_references_events_in_order():
    port, pwd = _run(health, events, MetricsRegistry(),
                     health.default_rules(),
                     _stream("graph_capture/serial.split_step"))
    ref, rwd = _run(ref_health, ref_events, RefRegistry(),
                    ref_health.default_rules(),
                    _stream("jit_trace/serial.root"))
    assert [r["rule"] for r in port] == [r["rule"] for r in ref]
    assert [r["rule"] for r in port] == [
        "retrace_spike", "queue_saturation", "trace_drops",
        "retry_exhausted", "fault_storm", "shed_rate", "breaker_open",
        "queue_saturation", "refresh_slo", "feature_drift",
        "prediction_drift"]
    for p, r in zip(port, ref):
        if p["rule"] == "retrace_spike":
            assert "graph captures" in p["detail"]
            p, r = dict(p, detail=""), dict(r, detail="")
        assert p == r
    assert pwd.breached() == [
        dict(r, detail=pwd._last_fired[r["rule"]]["detail"])
        for r in rwd.breached()]


def test_recapture_watch_counts_builds_and_captures():
    """Builds and captures add up in one window; the first snapshot
    only arms the baseline."""
    rule = [r for r in health.default_rules()
            if r.name == "retrace_spike"][0]
    state = {}
    base = {"counters": {"kernel_build/histogram": 1}}
    assert rule.check(base, state) is None
    spike = {"counters": {"kernel_build/histogram": 5,
                          "graph_capture/serial.split_step": 4}}
    assert rule.check(spike, state)["value"] == 8


def test_fleet_rules_fire_the_references_events_in_order():
    port, _ = _run(health, events, MetricsRegistry(),
                   health.fleet_rules(), _fleet_stream())
    ref, _ = _run(ref_health, ref_events, RefRegistry(),
                  ref_health.fleet_rules(), _fleet_stream())
    assert port == ref
    assert [r["rule"] for r in port] == ["rank_skew", "dead_rank",
                                         "fleet_shed_rate", "rank_skew"]


def test_backend_event_keys_on_the_cpu():
    """The CPU backend record carries the reference's keys; the port has
    no fallback path, so no ``record_backend_fallback``."""
    seen = []
    events.register_event_callback(seen.append)
    assert health.record_backend(platform="cpu", source="t") == "cpu"
    ref_seen = []
    ref_events.register_event_callback(ref_seen.append)
    ref_health.record_backend(platform="cpu", source="t")
    assert set(seen[0]) == set(ref_seen[0])
    assert not hasattr(health, "record_backend_fallback")
    assert np.isclose(seen[0]["num_devices"], 1)
