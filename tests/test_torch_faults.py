"""The port's fault injection (``lightgbm_tpu_torch/obs/faults.py``) and
bounded retry (``utils/retry.py``) against the JAX package's on the CPU.

- a schedule string parses to the same specs in both packages (level
  a), and a malformed one raises in both;
- the ``prob`` mode's firing pattern replays from its seed, as the
  reference's does;
- every site the port keeps (``checkpoint_finalize``, ``metrics_dump``,
  ``gateway_push``, ``trace_finalize``) raises :class:`InjectedFault`
  and emits a ``fault_injected`` event, directly and through the code
  that calls it;
- ``retry_call`` backs off, counts and gives up as the reference does.
"""
import os

import numpy as np
import pytest

from lightgbm_tpu.obs import faults as ref_faults
from lightgbm_tpu.obs.registry import MetricsRegistry as RefRegistry
from lightgbm_tpu.utils import retry as ref_retry

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.obs import events, export, faults, trace
from lightgbm_tpu_torch.obs.registry import MetricsRegistry, registry
from lightgbm_tpu_torch.utils import retry
from lightgbm_tpu_torch.utils.log import LightGBMError

SITES = ("checkpoint_finalize", "metrics_dump", "gateway_push",
         "trace_finalize", "serve_admit", "serve_dispatch",
         "registry_swap", "shard_open", "spill_write",
         "prefetch_device_put")


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()
    trace.configure_stream(None)
    events.register_event_callback(None)


def _fields(specs):
    return [(s.site, s.mode, s.arg, s.errno_name, s.errno_no, s.seed)
            for s in specs]


@pytest.mark.parametrize("spec", [
    "checkpoint_finalize:nth:2",
    "metrics_dump:once;gateway_push:always:0:ENOSPC",
    "trace_finalize:prob:0.25:EAGAIN:7, checkpoint_finalize:nth:1:EIO",
    "  gateway_push:always ; ",
])
def test_spec_parsing_matches_reference(spec):
    assert _fields(faults.parse_spec(spec)) == \
        _fields(ref_faults.parse_spec(spec))


@pytest.mark.parametrize("spec", ["checkpoint_finalize",
                                  "metrics_dump:sometimes",
                                  "gateway_push:nth",
                                  "gateway_push:nth:0",
                                  "trace_finalize:once:0:ENOTANERRNO"])
def test_malformed_spec_raises_in_both(spec):
    with pytest.raises(ValueError):
        faults.parse_spec(spec)
    with pytest.raises(ValueError):
        ref_faults.parse_spec(spec)


def test_prob_mode_replays_the_references_pattern():
    pattern = {}
    for name, mod in (("port", faults), ("ref", ref_faults)):
        mod.configure("metrics_dump:prob:0.3:EIO:11")
        hits = []
        for _ in range(64):
            try:
                mod.check("metrics_dump")
                hits.append(0)
            except OSError:
                hits.append(1)
        pattern[name] = hits
        mod.reset()
    assert pattern["port"] == pattern["ref"] and 0 < sum(pattern["port"])


@pytest.mark.parametrize("site", SITES)
def test_every_kept_site_raises_and_emits(site):
    seen = []
    events.register_event_callback(seen.append)
    faults.configure("%s:nth:2:ENOSPC" % site)
    faults.check(site, path="p")                 # call 1: passes
    with pytest.raises(faults.InjectedFault) as ei:
        faults.check(site, path="p")
    assert ei.value.errno == __import__("errno").ENOSPC
    assert isinstance(ei.value, OSError)
    rec = [r for r in seen if r["event"] == "fault_injected"]
    assert len(rec) == 1
    assert (rec[0]["site"], rec[0]["call"], rec[0]["mode"],
            rec[0]["errno"], rec[0]["path"]) == (site, 2, "nth", "ENOSPC",
                                                  "p")
    assert registry.count("ft/faults_injected/" + site) >= 1
    assert site in faults.SITES


def test_sites_are_the_references():
    """Every site of the JAX package has its call site in the port (the
    serving and out-of-core ones fire through their callers in
    tests/test_torch_serve_resilience.py and tests/test_torch_shards.py)."""
    assert faults.SITES == ref_faults.SITES
    assert set(SITES) == set(faults.SITES)


def test_sites_fire_through_their_callers(tmp_path):
    """metrics_dump: a skipped dump; trace_finalize: a dropped segment;
    checkpoint_finalize: a fatal save after its retries (the gateway's
    is held in tests/test_torch_gateway.py)."""
    reg = MetricsRegistry()
    faults.configure("metrics_dump:always")
    export.dump_metrics(str(tmp_path / "m.prom"), reg)
    assert reg.count("ft/metrics_dump_failed") == 1
    assert not os.path.exists(str(tmp_path / "m.prom"))

    faults.configure("trace_finalize:always")
    before = registry.count("trace/dropped_events")
    d = str(tmp_path / "segs")
    trace.configure_stream(d)
    with registry.scope("probe::fault"):
        pass
    trace.flush()
    assert registry.count("trace/dropped_events") > before
    assert not [f for f in os.listdir(d) if not f.startswith(".")]

    faults.configure("checkpoint_finalize:always")
    rng = np.random.RandomState(0)
    X = rng.randn(300, 4)
    y = (X[:, 0] > 0).astype(float)
    with pytest.raises(LightGBMError, match="could not be finalized"):
        lgb.train({"objective": "binary", "verbose": -1,
                   "device_type": "cpu", "num_leaves": 4},
                  lgb.Dataset(X, label=y), num_boost_round=2,
                  checkpoint_dir=str(tmp_path / "ck"), checkpoint_freq=1)
    assert not [f for f in os.listdir(str(tmp_path / "ck"))
                if f.startswith("ckpt-")]


def test_retry_call_matches_reference_backoff():
    """The same seeded backoff delays, retry counters and final raise."""
    out = {}
    for name, mod, reg in (("port", retry, MetricsRegistry()),
                           ("ref", ref_retry, RefRegistry())):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError(5, "transient")
            return "ok"

        assert mod.retry_call(flaky, "probe_site", attempts=4, base_ms=0,
                              reg=reg) == "ok"
        with pytest.raises(OSError):
            mod.retry_call(lambda: (_ for _ in ()).throw(OSError(5, "x")),
                           "probe_site", attempts=2, base_ms=0, reg=reg)
        with pytest.raises(ValueError):
            mod.retry_call(lambda: (_ for _ in ()).throw(ValueError()),
                           "probe_site", attempts=3, base_ms=0, reg=reg)
        out[name] = (len(calls), dict(reg.counters))
    assert out["port"] == out["ref"]
    assert out["port"][1]["ft/retry_exhausted"] == 1


def test_dead_peer_is_fatal_health_event():
    """tests/test_faults.py::test_dead_peer_is_fatal_health_event on the
    port's ``parallel.dtrain.run_collective``, with no sockets: a
    collective that never completes ends as a fatal, flushed
    ``dtrain_peer_timeout`` health event and a ``LightGBMError`` naming
    the peer rank, within its timeout."""
    import threading
    import time

    from lightgbm_tpu_torch.parallel.dtrain import run_collective
    from lightgbm_tpu_torch.utils.log import LightGBMError
    seen = []
    events.register_event_callback(
        lambda rec: seen.append(rec) if rec["event"] == "health"
        else None)
    t0 = time.perf_counter()
    try:
        with pytest.raises(LightGBMError, match="peer rank"):
            run_collective(lambda: threading.Event().wait(),
                           what="allreduce_sum", timeout=0.2)
    finally:
        events.register_event_callback(None)
    assert 0.15 < time.perf_counter() - t0 < 10
    assert seen and seen[0]["rule"] == "dtrain_peer_timeout" \
        and seen[0]["severity"] == "fatal" and seen[0]["rank"] == -1
