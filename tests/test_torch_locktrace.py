"""The port's lock sanitizer (``lightgbm_tpu_torch/utils/locktrace.py``)
against the JAX package's, on the CPU.

- the sanitizer's own semantics run through both modules: a seeded
  lock-order inversion raises deterministically in one thread, hold
  overruns are recorded and not raised, ``Condition.wait`` is not billed
  as holding, proxies over one raw lock stay exclusive, ``reset`` keeps
  live proxies reporting; the reports (edges, violation kinds) are the
  reference's;
- wiring: ``maybe_trace`` does nothing with ``LIGHTGBM_TPU_LOCKTRACE``
  unset, and wraps the named locks of the serving classes and the
  metrics gateway when it is set;
- a warmed ``PredictServer`` through an overload burst, with two
  replicas, is clean (no inversion, no hold overrun), and so is one
  refresh cycle of the closed loop (``loop/controller.py``).
"""
import threading
import time

import pytest
import torch

from _torch_serve_util import kWait, shared_model
from _torch_watch_env import watch_env_defaults  # noqa: F401
from lightgbm_tpu.utils import locktrace as ref_locktrace
from lightgbm_tpu_torch.utils import locktrace

torch.set_num_threads(1)

kEnv = "LIGHTGBM_TPU_LOCKTRACE"
MODULES = {"ref": ref_locktrace, "port": locktrace}


@pytest.fixture()
def traced(monkeypatch):
    monkeypatch.setenv(kEnv, "1")
    for m in MODULES.values():
        m.reset()
        m.tracer().max_hold_s = 0.5
    yield
    for m in MODULES.values():
        m.reset()
        m.tracer().max_hold_s = 0.5


def _box(lt):
    class _TwoLocks:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()
            self._cond = threading.Condition()
            lt.maybe_trace(self)
    return _TwoLocks()


def _inversion(lt):
    box = _box(lt)
    with box._a:
        with box._b:
            pass
    with pytest.raises(lt.LockOrderError) as err:
        with box._b:
            with box._a:
                pass
    assert "_TwoLocks._a" in str(err.value)
    with pytest.raises(AssertionError):
        lt.assert_clean()
    rep = lt.report()
    return sorted(rep["edges"]), [v["pair"] for v in
                                  rep["order_violations"]]


def _hold(lt):
    box = _box(lt)
    lt.tracer().max_hold_s = 0.01
    with box._a:
        time.sleep(0.05)
    rep = lt.report()
    with pytest.raises(AssertionError, match="held"):
        lt.assert_clean()
    return [v["lock"] for v in rep["hold_violations"]]


def _wait(lt):
    box = _box(lt)
    lt.tracer().max_hold_s = 0.05

    def waker():
        time.sleep(0.2)
        with box._cond:
            box._cond.notify_all()

    t = threading.Thread(target=waker)
    t.start()
    with box._cond:
        assert box._cond.wait(timeout=2.0)
    t.join(timeout=kWait)
    lt.assert_clean()
    return sorted(lt.report()["edges"])


def _shared_raw(lt):
    raw = threading.Lock()
    p1 = lt.TracedLock(raw, "A.lock")
    p2 = lt.TracedLock(raw, "A.lock")
    with p1:
        first = p2.acquire(blocking=False)
    second = p2.acquire(blocking=False)
    p2.release()
    lt.assert_clean()
    return first, second


def _reset_live(lt):
    box = _box(lt)
    with box._a:
        pass
    lt.reset()
    with box._a:
        pass
    return lt.report()["acquires"]


def _consistent(lt):
    box = _box(lt)
    for _ in range(3):
        with box._a:
            with box._b:
                pass
    lt.assert_clean()
    rep = lt.report()
    return sorted(rep["edges"]), rep["acquires"]


@pytest.mark.parametrize("case", [_inversion, _hold, _wait, _shared_raw,
                                  _reset_live, _consistent],
                         ids=["inversion", "hold", "wait", "shared_raw",
                              "reset", "consistent"])
def test_sanitizer_semantics_match_reference(traced, case):
    got = {name: case(m) for name, m in MODULES.items()}
    assert got["port"] == got["ref"]


def test_disabled_is_a_noop(monkeypatch):
    monkeypatch.delenv(kEnv, raising=False)
    box = _box(locktrace)
    assert not isinstance(box._a, locktrace.TracedLock)
    assert not isinstance(box._cond, locktrace.TracedCondition)
    assert not locktrace.enabled()
    assert locktrace.report()["enabled"] is False


def test_hold_budget_reads_its_variable(monkeypatch):
    monkeypatch.setenv("LIGHTGBM_TPU_LOCKTRACE_MAX_HOLD_MS", "123")
    assert locktrace._Tracer().max_hold_s == pytest.approx(0.123)
    assert ref_locktrace._Tracer().max_hold_s == pytest.approx(0.123)


def test_serving_classes_and_gateway_get_traced(traced):
    from lightgbm_tpu_torch.obs.gateway import MetricsGateway
    from lightgbm_tpu_torch.serve.server import (CircuitBreaker,
                                                 ModelRegistry)
    assert isinstance(CircuitBreaker()._lock, locktrace.TracedLock)
    assert isinstance(ModelRegistry()._lock, locktrace.TracedLock)
    gw = MetricsGateway(port=0)
    try:
        assert isinstance(gw._lock, locktrace.TracedLock)
    finally:
        gw.close()


def test_warmed_server_overload_window_is_clean(traced):
    """Every named lock of a two-replica server (breaker, registry, the
    server's condition, the shared entries lock) crosses an overload
    burst in one order and within its hold budget."""
    from lightgbm_tpu_torch.serve import PredictServer, StackedForest
    X, boosters, _ = shared_model(rounds=8)
    srv = PredictServer(StackedForest.from_gbdt(boosters["port"]),
                        max_batch=32, max_wait_ms=2, max_queue_rows=64,
                        devices=["cpu", "cpu"], autostart=False)
    assert isinstance(srv._cond, locktrace.TracedCondition)
    assert isinstance(srv.predictors[0]._entries_lock,
                      locktrace.TracedLock)
    srv.start()
    try:
        for rows in (1, 8, 32):
            srv.submit(X[:rows]).result(timeout=kWait)
        locktrace.reset()
        locktrace.tracer().max_hold_s = 2.0
        futs = [srv.submit(X[i % len(X)]) for i in range(256)]
        done = 0
        for f in futs:
            try:
                f.result(timeout=kWait)
                done += 1
            except Exception:  # noqa: BLE001 — overload may shed
                pass
        assert done > 0
    finally:
        srv.stop()
    rep = locktrace.report()
    assert rep["acquires"] > 256
    locktrace.assert_clean()


def test_one_refresh_cycle_is_clean(traced, tmp_path, monkeypatch):
    """Bootstrap + one clean refresh under live traffic (reference
    ``TestRefreshWindow.test_one_refresh_cycle_is_clean``): train,
    publish, canary, promote, with every serve and registry lock traced
    end to end."""
    import numpy as np
    from lightgbm_tpu_torch.loop import RefreshController
    monkeypatch.setenv("LIGHTGBM_TPU_WATCH_REFRESH_P99_MS", "5000")
    locktrace.tracer().max_hold_s = 2.0
    kF = 10

    def data_fn(cycle, rows=600):
        rng = np.random.default_rng(50 + cycle)
        Xc = rng.normal(size=(rows, kF))
        yc = (Xc[:, 0] + 0.5 * Xc[:, 1] > 0.2).astype(np.float64)
        return Xc, yc

    ctl = RefreshController(
        {"objective": "binary", "num_leaves": 7, "max_bin": 31,
         "verbosity": -1, "min_data_in_leaf": 10,
         "bin_construct_sample_cnt": 800, "device_type": "cpu"},
        data_fn, num_features=kF, work_dir=str(tmp_path),
        base_rounds=2, extra_rounds=1, traffic_threads=2,
        traffic_rows=32, drain_timeout_s=15, schedule={},
        use_gateway=False)
    rep = ctl.run(cycles=2)
    assert rep["ok"], rep["problems"]
    assert rep["refresh_rollbacks"] == 0
    trace = locktrace.report()
    assert trace["acquires"] > 0
    locktrace.assert_clean()
