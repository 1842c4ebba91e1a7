"""The port's overload-safe serving plane against the JAX package's, on
the CPU: admission control, deadlines, the circuit breaker, canary swaps
and the drain (``docs/SERVING.md``).

Each scenario runs through both packages' servers over the same model
(the JAX package's, its text loaded by the port) and the same rows:
the typed error of every Future, the counters that move, and the
serving events in order must be the reference's (level a); answers are
byte-equal to the host walk. Faults are injected at the sites
``serve_admit``, ``serve_dispatch`` and ``registry_swap`` through each
package's own ``obs.faults``. Scenarios that race threads (the overload
burst) hold invariants instead: every Future resolves, each shed is
typed, counted and has its event.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from _torch_serve_util import (SIDES, Side, kWait, kinds, outcome,
                               shared_model)
from _torch_watch_env import watch_env_defaults  # noqa: F401

torch.set_num_threads(1)

kKinds = ("model_swap", "model_canary", "model_rollback", "request_shed",
          "breaker_open", "breaker_close", "serve_drain_timeout",
          "fault_injected")


@pytest.fixture(scope="module")
def shared():
    return shared_model()


@pytest.fixture(autouse=True)
def _clean():
    for name in SIDES:
        Side(name).reset()
    yield
    for name in SIDES:
        Side(name).reset()


def _both(run):
    """``run(side)`` for each package; returns {"ref": ..., "port": ...}."""
    return {name: run(Side(name)) for name in SIDES}


# ----------------------------------------------------------------------
# admission control
# ----------------------------------------------------------------------

def test_overload_burst_sheds_typed_and_strands_nothing(shared):
    """Eight producers outrun one worker against ``max_queue_rows``:
    every Future resolves (served byte-equal, or ``Overloaded``), the
    queue never holds more than its cap, and each shed has its counter
    and its ``request_shed`` event (the invariants the reference pins;
    the split between served and shed depends on the schedule)."""
    X, boosters, host = shared
    kCap, n_threads, per = 64, 8, 100
    side = Side("port")
    with side.recording() as rec:
        srv = side.server(side.forest(boosters["port"]), max_batch=256,
                          max_wait_ms=50, max_queue_rows=kCap)
        futs = [[None] * per for _ in range(n_threads)]
        peaks = [0] * n_threads

        def producer(t):
            for i in range(per):
                idx = (t * per + i) % len(X)
                futs[t][i] = (idx, srv.submit(X[idx]))
                peaks[t] = max(peaks[t], srv._pending_rows)

        threads = [threading.Thread(target=producer, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=kWait)
            assert not th.is_alive()
        ok = shed = 0
        for t in range(n_threads):
            for idx, fut in futs[t]:
                kind, val = outcome(fut)
                if kind == "ok":
                    assert val == host[idx]
                    ok += 1
                else:
                    assert kind == "Overloaded"
                    shed += 1
        assert srv._thread.is_alive()
        srv.stop()
    assert ok > 0 and shed > 0 and ok + shed == n_threads * per
    assert max(peaks) <= kCap
    assert rec.delta("serve/shed_total") == shed
    assert rec.delta("serve/requests") == n_threads * per
    sheds = [e for e in rec.events if e["event"] == "request_shed"]
    assert len(sheds) == shed
    assert all(e["reason"] == "queue_full" for e in sheds)


def test_block_policy_then_reject_match_reference(shared):
    """``overflow="block"`` waits at most ``block_timeout_ms`` for space,
    then sheds typed; with the worker live the blocked space frees."""
    X, boosters, host = shared

    def run(side):
        srv = side.server(side.forest(boosters[side.name]), max_batch=8,
                          max_wait_ms=1, max_queue_rows=8,
                          overflow="block", block_timeout_ms=150,
                          autostart=False)
        with side.recording() as rec:
            f1 = srv.submit(X[:8])
            t0 = time.perf_counter()
            f2 = srv.submit(X[8:16])
            waited = time.perf_counter() - t0
            second = outcome(f2, 5)[0]
            srv.start()
            first = outcome(f1)
            third = outcome(srv.submit(X[16:24]))
            srv.stop()
        assert waited >= 0.1
        reasons = [e["reason"] for e in rec.events
                   if e["event"] == "request_shed"]
        return (second, first[0], third[0], reasons,
                np.concatenate([first[1], third[1]]))

    out = _both(run)
    assert out["port"][:4] == out["ref"][:4] == (
        "Overloaded", "ok", "ok", ["block_timeout"])
    assert np.array_equal(out["port"][4], np.concatenate([host[:8],
                                                          host[16:24]]))


def test_block_wait_bounded_by_request_deadline(shared):
    X, boosters, _ = shared

    def run(side):
        srv = side.server(side.forest(boosters[side.name]), max_batch=8,
                          max_wait_ms=1, max_queue_rows=8,
                          overflow="block", block_timeout_ms=2000,
                          autostart=False)
        with side.recording() as rec:
            srv.submit(X[:8])
            t0 = time.perf_counter()
            doomed = srv.submit(X[8:16], deadline_ms=60)
            waited = time.perf_counter() - t0
            srv.stop(drain_timeout_s=0.1)
        assert waited < 1.0
        return outcome(doomed, 5)[0], rec.delta("serve/deadline_expired")

    out = _both(run)
    assert out["port"] == out["ref"] == ("DeadlineExceeded", 1)


@pytest.mark.parametrize("cap,rows", [(32, 40), (16, 17)])
def test_request_larger_than_queue_is_shed(shared, cap, rows):
    X, boosters, _ = shared

    def run(side):
        srv = side.server(side.forest(boosters[side.name]), max_batch=16,
                          max_queue_rows=cap, autostart=False)
        with side.recording() as rec:
            got = outcome(srv.submit(X[:rows]), 5)[0]
        srv.stop()
        return got, [e["reason"] for e in rec.events
                     if e["event"] == "request_shed"]

    out = _both(run)
    assert out["port"] == out["ref"] == ("Overloaded",
                                         ["larger_than_queue"])


def test_admission_fault_fails_the_future_typed(shared):
    X, boosters, host = shared

    def run(side):
        srv = side.server(side.forest(boosters[side.name]), max_batch=8,
                          max_wait_ms=1)
        side.faults.configure("serve_admit:nth:2")
        try:
            got = [outcome(srv.submit(X[i]))[0] for i in range(3)]
        finally:
            side.faults.reset()
            srv.stop()
        return got

    out = _both(run)
    assert out["port"] == out["ref"] == ["ok", "InjectedFault", "ok"]


# ----------------------------------------------------------------------
# deadlines
# ----------------------------------------------------------------------

def test_deadline_checked_at_admission_and_dispatch_pop(shared):
    X, boosters, host = shared

    def run(side):
        srv = side.server(side.forest(boosters[side.name]), max_batch=16,
                          max_wait_ms=1, autostart=False)
        with side.recording() as rec:
            f0 = srv.submit(X[0], deadline_ms=0)
            aged = srv.submit(X[1], deadline_ms=25)
            keep = srv.submit(X[2])
            time.sleep(0.08)
            srv.start()
            got = [outcome(f) for f in (f0, aged, keep)]
            srv.stop()
        return ([g[0] for g in got], got[2][1],
                rec.delta("serve/deadline_expired"), srv.stats["expired"])

    out = _both(run)
    assert out["port"][0] == out["ref"][0] == [
        "DeadlineExceeded", "DeadlineExceeded", "ok"]
    assert out["port"][1] == out["ref"][1] == host[2]
    assert out["port"][2:] == out["ref"][2:] == (2, 2)


def test_default_deadline_applies_per_server(shared):
    X, boosters, host = shared

    def run(side):
        srv = side.server(side.forest(boosters[side.name]), max_batch=16,
                          max_wait_ms=1, default_deadline_ms=30,
                          autostart=False)
        doomed = srv.submit(X[0])
        time.sleep(0.08)
        srv.start()
        first = outcome(doomed, 5)[0]
        second = srv.predict(X[1], timeout=kWait, deadline_ms=60_000)
        srv.stop()
        return first, second

    out = _both(run)
    assert out["port"] == out["ref"] == ("DeadlineExceeded", host[1])


# ----------------------------------------------------------------------
# oversized requests
# ----------------------------------------------------------------------

def test_oversized_request_split_and_reassembled(shared):
    X, boosters, host = shared

    def run(side):
        srv = side.server(side.forest(boosters[side.name]), max_batch=16,
                          max_wait_ms=1, autostart=False)
        with side.recording() as rec:
            big = srv.submit(X[:70])
            one = srv.submit(X[70])
            srv.start()
            got = (outcome(big)[1], outcome(one)[1])
            srv.stop()
        rows = [e["rows"] for e in rec.events
                if e["event"] == "predict_batch"]
        return got, rows, dict(srv.stats)

    out = _both(run)
    assert np.array_equal(out["port"][0][0], host[:70])
    assert out["port"][0][1] == host[70]
    assert out["port"][1:] == out["ref"][1:]
    assert max(out["port"][1]) <= 16 and sum(out["port"][1]) == 71


# ----------------------------------------------------------------------
# the circuit breaker
# ----------------------------------------------------------------------

def test_breaker_open_half_open_close_matches_reference(shared):
    X, boosters, host = shared

    def run(side):
        srv = side.server(side.forest(boosters[side.name]), max_batch=8,
                          max_wait_ms=1, breaker_threshold=2,
                          breaker_cooldown_ms=200)
        trail = []
        with side.recording() as rec:
            side.faults.configure("serve_dispatch:always")
            for i in range(2):
                trail.append((outcome(srv.submit(X[i]))[0],
                              srv.breaker.state))
            fast = outcome(srv.submit(X[2]), 5)
            try:
                srv.submit(X[2]).result(timeout=5)
            except side.BreakerOpen as e:
                trail.append(("BreakerOpen", e.state,
                              e.consecutive_failures >= 2))
            trail.append((fast[0], srv.breaker.state))
            time.sleep(0.25)
            trail.append((outcome(srv.submit(X[3]))[0],
                          srv.breaker.state))
            time.sleep(0.25)
            side.faults.reset()
            probe = outcome(srv.submit(X[4]))
            trail.append((probe[0], srv.breaker.state, probe[1]))
            gauge = side.registry.snapshot()["gauges"][
                "serve/breaker_state/default"]
            srv.stop()
        opens = [(e["probe_failed"], e["consecutive_failures"])
                 for e in rec.events if e["event"] == "breaker_open"]
        closes = [e["from_state"] for e in rec.events
                  if e["event"] == "breaker_close"]
        return (trail, gauge, opens, closes,
                rec.delta("serve/breaker_opens"),
                kinds(rec.events, ("breaker_open", "breaker_close")))

    out = _both(run)
    assert out["port"] == out["ref"]
    trail = out["port"][0]
    assert trail[0] == ("InjectedFault", "closed")
    assert trail[1] == ("InjectedFault", "open")
    assert trail[-1] == ("ok", "closed", host[4])
    assert out["port"][3] == ["half_open"]


def test_stranded_probe_frees_the_breaker_slot(shared):
    X, boosters, host = shared

    def run(side):
        srv = side.server(side.forest(boosters[side.name]), max_batch=8,
                          max_wait_ms=1, breaker_threshold=1,
                          breaker_cooldown_ms=30, autostart=False)
        srv.breaker.record_failure(RuntimeError("boom"))
        states = [srv.breaker.state]
        time.sleep(0.05)
        probe = srv.submit(X[0])
        states.append(srv.breaker.state)
        other = outcome(srv.submit(X[1]), 5)[0]
        srv.stop(drain_timeout_s=0.1)
        stranded = outcome(probe, 5)[0]
        srv.start()
        served = srv.predict(X[2], timeout=kWait)
        states.append(srv.breaker.state)
        srv.stop()
        return states, other, stranded, served

    out = _both(run)
    assert out["port"] == out["ref"] == (
        ["open", "half_open", "closed"], "BreakerOpen", "ShuttingDown",
        host[2])


def test_worker_survives_failure_outside_the_predict_call(shared):
    X, boosters, host = shared

    def run(side):
        srv = side.server(side.forest(boosters[side.name]), max_batch=8,
                          max_wait_ms=1, autostart=False)
        orig = srv.registry.route
        boom = [True]

        def route_once(name, **kwargs):
            if boom[0]:
                boom[0] = False
                raise MemoryError("routing blew up")
            return orig(name, **kwargs)

        srv.registry.route = route_once
        doomed = srv.submit(X[0])
        srv.start()
        first = outcome(doomed)[0]
        alive = srv._thread.is_alive()
        second = srv.predict(X[1], timeout=kWait)
        srv.stop()
        return first, alive, second

    out = _both(run)
    assert out["port"] == out["ref"] == ("MemoryError", True, host[1])


# ----------------------------------------------------------------------
# canary swaps
# ----------------------------------------------------------------------

def _canary(side, boosters, X, canary_batches, fault=None, poisoned=False):
    """v1 (3 iterations) serving, then a canary v2 (the whole model, or a
    NaN stump) with ``fault`` configured for the canary's dispatches."""
    reg = side.ModelRegistry()
    with side.recording() as rec:
        v1 = reg.load("m", booster=boosters[side.name], num_iteration=3)
        srv = side.server(reg, name="m", max_batch=32, max_wait_ms=1)
        first = srv.predict(X[:8], timeout=kWait)
        if poisoned:
            t = side.Tree(1)
            t.leaf_value[0] = np.nan
            v2 = reg.publish("m", side.StackedForest(
                [t], num_tree_per_iteration=1, num_features=X.shape[1]),
                canary_batches=canary_batches)
        else:
            v2 = reg.load("m", booster=boosters[side.name],
                          canary_batches=canary_batches)
        if fault:
            side.faults.configure(fault)
        outs = [srv.predict(X[8 * i:8 * (i + 1)], timeout=kWait)
                for i in range(1, 4)]
        side.faults.reset()
        srv.stop()
    evs = [(e["event"], e.get("version"), e.get("rolled_back_to"),
            e.get("canary")) for e in rec.events
           if e["event"] in ("model_swap", "model_canary",
                             "model_rollback")]
    return ((v1, v2, reg.get("m")[0], reg.canary_active("m")), evs,
            rec.delta("serve/rollbacks"),
            rec.delta("serve/canary_promotions"),
            np.concatenate([first] + outs))


@pytest.mark.parametrize("case", ["promote", "dispatch_fault",
                                  "promote_fault", "non_finite"])
def test_canary_window_matches_reference(shared, case):
    """A clean window promotes; an injected dispatch fault, an injected
    fault at the promote (``registry_swap``) and non-finite canary
    output each roll back, and the old version keeps serving byte-equal
    (the batch that caught the failure replays on it)."""
    X, boosters, host = shared
    host3 = boosters["ref"].predict(X, num_iteration=3,
                                    predict_on_device=False)
    kw = {"promote": dict(canary_batches=2),
          "dispatch_fault": dict(canary_batches=3,
                                 fault="serve_dispatch:nth:1"),
          "promote_fault": dict(canary_batches=1,
                                fault="registry_swap:nth:1"),
          "non_finite": dict(canary_batches=2, poisoned=True)}[case]
    out = _both(lambda side: _canary(side, boosters, X, **kw))
    assert out["port"][:4] == out["ref"][:4]
    assert np.array_equal(out["port"][4], out["ref"][4])
    state, _, rollbacks, promotions, served = out["port"]
    if case == "promote":
        assert state == (1, 2, 2, False) and promotions == 1
        assert np.array_equal(served[8:], host[8:32])
    else:
        assert state == (1, 2, 1, False) and rollbacks == 1
        expect = host3[:32].copy()
        if case == "promote_fault":
            expect[8:16] = host[8:16]    # the canary batch itself ran
        assert np.array_equal(served, expect)


# ----------------------------------------------------------------------
# the drain
# ----------------------------------------------------------------------

def test_stop_drains_queued_work_then_rejects_new(shared):
    X, boosters, host = shared

    def run(side):
        srv = side.server(side.forest(boosters[side.name]), max_batch=8,
                          max_wait_ms=1, autostart=False)
        futs = [srv.submit(X[i]) for i in range(10)]
        srv.start()
        srv.stop(drain_timeout_s=kWait)
        got = [outcome(f, 5) for f in futs]
        late = outcome(srv.submit(X[0]), 5)[0]
        return ([g[1] for g in got], late, srv.readiness)

    out = _both(run)
    assert out["port"] == out["ref"]
    assert out["port"][0] == list(host[:10])
    assert out["port"][1:] == ("ShuttingDown", "stopped")


@pytest.mark.parametrize("rows,n", [(1, 3), (40, 1)])
def test_stop_without_worker_fails_every_caller_once(shared, rows, n):
    """Queued Futures are failed ``ShuttingDown`` at the drain timeout;
    an oversized request counts as one caller, not one per chunk."""
    X, boosters, _ = shared

    def run(side):
        srv = side.server(side.forest(boosters[side.name]), max_batch=8,
                          max_wait_ms=1, autostart=False)
        with side.recording() as rec:
            futs = [srv.submit(X[i:i + rows]) for i in range(n)]
            srv.stop(drain_timeout_s=0.05)
        unresolved = [e["unresolved"] for e in rec.events
                      if e["event"] == "serve_drain_timeout"]
        return ([f.done() for f in futs], [outcome(f, 0)[0] for f in futs],
                rec.delta("serve/drain_failed"), unresolved)

    out = _both(run)
    assert out["port"] == out["ref"] == (
        [True] * n, ["ShuttingDown"] * n, n, [n])


def test_drain_with_a_mid_drain_fault_resolves_every_future(shared):
    X, boosters, host = shared

    def run(side):
        srv = side.server(side.forest(boosters[side.name]), max_batch=4,
                          max_wait_ms=1, autostart=False)
        futs = [srv.submit(X[i * 4:(i + 1) * 4]) for i in range(3)]
        side.faults.configure("serve_dispatch:nth:2")
        srv.start()
        srv.stop(drain_timeout_s=kWait)
        side.faults.reset()
        return [f.done() for f in futs], [outcome(f, 0)[0] for f in futs]

    out = _both(run)
    assert out["port"] == out["ref"] == (
        [True] * 3, ["ok", "InjectedFault", "ok"])


def test_drain_timeout_fails_a_wedged_dispatch(shared):
    X, boosters, _ = shared

    def run(side):
        srv = side.server(side.forest(boosters[side.name]), max_batch=8,
                          max_wait_ms=1, autostart=False)
        orig = srv.predictor.predict

        def wedged(Xb):
            time.sleep(1.5)
            return orig(Xb)

        srv.predictor.predict = wedged
        fut = srv.submit(X[0])
        srv.start()
        time.sleep(0.3)
        t0 = time.perf_counter()
        srv.stop(drain_timeout_s=0.2)
        took = time.perf_counter() - t0
        got = outcome(fut, 5)[0]
        srv._thread.join(timeout=kWait)
        return took < 1.2, got, srv.readiness, srv._thread.is_alive()

    out = _both(run)
    assert out["port"] == out["ref"] == (True, "ShuttingDown", "stopped",
                                         False)


def test_exit_waits_for_a_worker_left_in_a_dispatch(tmp_path):
    """The port's own contract (its workers may be inside a CUDA call):
    a worker still in a dispatch when ``stop``'s drain timeout fires
    finishes it before the interpreter exits, instead of being cut off
    inside it. The wedged dispatch prints after ``stop`` has returned."""
    script = textwrap.dedent("""
        import sys, time
        import numpy as np
        import lightgbm_tpu_torch as lgb
        from lightgbm_tpu_torch.serve import PredictServer, StackedForest
        rng = np.random.RandomState(0)
        X = rng.randn(200, 4)
        bst = lgb.train({"objective": "binary", "num_leaves": 4,
                         "verbosity": -1, "device_type": "cpu"},
                        lgb.Dataset(X, label=(X[:, 0] > 0).astype(float)),
                        num_boost_round=2)
        srv = PredictServer(StackedForest.from_gbdt(bst), max_batch=8,
                            max_wait_ms=1, devices=["cpu"],
                            autostart=False)
        orig = srv.predictor.predict

        def wedged(Xb):
            time.sleep(1.0)
            out = orig(Xb)
            print("dispatch returned", flush=True)
            return out

        srv.predictor.predict = wedged
        fut = srv.submit(X[0])
        srv.start()
        time.sleep(0.3)
        srv.stop(drain_timeout_s=0.05)
        print("stopped", type(fut.exception(timeout=5)).__name__,
              flush=True)
    """)
    path = tmp_path / "exit_after_stop.py"
    path.write_text(script)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    done = subprocess.run([sys.executable, str(path)], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=2 * kWait)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.split("\n")[:2] == ["stopped ShuttingDown",
                                           "dispatch returned"], done.stdout


def test_healthz_readiness_distinct_from_liveness(shared):
    X, boosters, host = shared

    def run(side):
        srv = side.server(side.forest(boosters[side.name]), max_batch=16,
                          max_wait_ms=1, metrics_port=0)
        states = []
        try:
            doc = json.loads(urllib.request.urlopen(
                srv.metrics.url + "/healthz", timeout=30).read().decode())
            states.append((doc["readiness"], doc["ready"]))
            served = srv.predict(X[0], timeout=kWait)
            with srv._cond:
                srv._stop = True
                srv._cond.notify_all()
            doc = json.loads(urllib.request.urlopen(
                srv.metrics.url + "/healthz", timeout=30).read().decode())
            states.append((doc["readiness"], doc["ready"]))
        finally:
            srv.stop()
        states.append(srv.readiness)
        return states, served

    out = _both(run)
    assert out["port"] == out["ref"] == (
        [("ready", True), ("draining", False), "stopped"], host[0])


def test_typed_error_catalog_matches_reference():
    for name in SIDES:
        side = Side(name)
        for exc in ("Overloaded", "DeadlineExceeded", "ShuttingDown",
                    "BreakerOpen"):
            cls = getattr(side, exc)
            assert issubclass(cls, side.ServeError)
            assert issubclass(cls, RuntimeError)
        assert not issubclass(side.faults.InjectedFault, side.ServeError)
        assert issubclass(side.faults.InjectedFault, OSError)
    e = Side("port").BreakerOpen("x", state="half_open",
                                 consecutive_failures=3, last_error="y")
    assert (e.state, e.consecutive_failures, e.last_error) == (
        "half_open", 3, "y")
