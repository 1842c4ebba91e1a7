"""The port's micro-batching server and model registry
(``lightgbm_tpu_torch/serve/server.py``) against the JAX package's, on
the CPU.

One model (trained by the JAX package, its text loaded by the port)
goes through both packages' ``PredictServer`` / ``ModelRegistry`` in the
same scenario; each test holds:

- the answers: byte-equal to each other and to the host walk (level a);
- the dispatch counts of deterministic batching (``autostart=False``),
  the counters and the kinds of events, in order (level a);
- the port's own rules: the devices default to the card (raising where
  none is visible), ``require_backend`` raises instead of the JAX
  package's ``backend_fallback`` event, and ``StackedForest.place``
  copies a forest once per device.
"""
import math

import numpy as np
import pytest
import torch

from _torch_serve_util import SIDES, Side, kWait, outcome, shared_model
from _torch_watch_env import watch_env_defaults  # noqa: F401
from lightgbm_tpu_torch.serve import (BucketedPredictor, PredictServer,
                                      StackedForest)
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def shared():
    return shared_model()


@pytest.fixture(autouse=True)
def _clean():
    yield
    for name in SIDES:
        Side(name).reset()


@pytest.mark.parametrize("n_req,max_batch", [(48, 16), (10, 4), (33, 8)])
def test_coalescing_matches_reference(shared, n_req, max_batch):
    """Requests queued before the worker starts coalesce into the same
    dispatches in both packages: ceil(n / max_batch), each a
    ``predict_batch`` event with the same rows and bucket."""
    X, boosters, host = shared
    seen = {}
    for name in SIDES:
        side = Side(name)
        with side.recording() as rec:
            srv = side.server(side.forest(boosters[name]),
                              max_batch=max_batch, max_wait_ms=5,
                              autostart=False)
            futs = [srv.submit(X[i]) for i in range(n_req)]
            srv.start()
            got = np.array([f.result(timeout=kWait) for f in futs])
            srv.stop()
        batches = [(e["rows"], e["bucket"], e["n_requests"])
                   for e in rec.events if e["event"] == "predict_batch"]
        seen[name] = (got, dict(srv.stats), batches,
                      rec.delta("serve/requests"))
        lat = srv.latency_percentiles()
        assert lat["p99"] >= lat["p50"] > 0.0
    assert np.array_equal(seen["port"][0], host[:n_req])
    assert np.array_equal(seen["port"][0], seen["ref"][0])
    assert seen["port"][1:] == seen["ref"][1:]
    assert seen["port"][1]["dispatches"] == math.ceil(n_req / max_batch)


def test_multi_row_requests_and_sync_predict(shared):
    X, boosters, host = shared
    out = {}
    for name in SIDES:
        side = Side(name)
        srv = side.server(boosters[name], max_batch=64, max_wait_ms=1)
        try:
            block = srv.predict(X[:10], timeout=kWait)
            single = srv.predict(X[0], timeout=kWait)
            with pytest.raises(ValueError, match="features"):
                srv.submit(np.zeros(X.shape[1] + 3, dtype=np.float32))
        finally:
            srv.stop()
        out[name] = (block, single)
    assert np.array_equal(out["port"][0], host[:10])
    assert np.array_equal(out["port"][0], out["ref"][0])
    assert out["port"][1] == out["ref"][1] == host[0]


def test_cancelled_future_drops_out_of_its_batch(shared):
    X, boosters, host = shared
    for name in SIDES:
        side = Side(name)
        srv = side.server(boosters[name], max_batch=8, max_wait_ms=1,
                          autostart=False)
        doomed = srv.submit(X[0])
        doomed.cancel()
        kept = srv.submit(X[1])
        srv.start()
        try:
            assert kept.result(timeout=kWait) == host[1]
            assert srv._thread.is_alive()
            assert srv.predict(X[2], timeout=kWait) == host[2]
        finally:
            srv.stop()
        assert doomed.cancelled()


def test_registry_hot_swap_matches_reference(shared):
    """Versions, answers and ``model_swap`` events of a load from a
    booster and a load from text are the reference's."""
    X, boosters, host = shared
    out = {}
    for name in SIDES:
        side = Side(name)
        with side.recording() as rec:
            reg = side.ModelRegistry()
            v1 = reg.load("m", booster=boosters[name], num_iteration=3)
            srv = side.server(reg, name="m", max_batch=32, max_wait_ms=1)
            try:
                got1 = srv.predict(X[:8], timeout=kWait)
                v2 = reg.load("m",
                              model_str=boosters[name].model_to_string())
                got2 = srv.predict(X[:8], timeout=kWait)
            finally:
                srv.stop()
        swaps = [(e["version"], e["num_trees"], e["num_features"],
                  e["source"]) for e in rec.events
                 if e["event"] == "model_swap"]
        out[name] = (v1, v2, got1, got2, swaps, reg.names())
    ref, port = out["ref"], out["port"]
    assert (port[0], port[1]) == (ref[0], ref[1]) == (1, 2)
    assert np.array_equal(port[2], ref[2])
    assert np.array_equal(port[3], host[:8])
    assert not np.array_equal(port[2], port[3])
    assert port[4] == ref[4]
    assert port[5] == ref[5] == ["m"]


def test_registry_route_and_get_before_publish(shared):
    for name in SIDES:
        side = Side(name)
        reg = side.ModelRegistry()
        with pytest.raises(KeyError):
            reg.get("nope")
        with pytest.raises(KeyError):
            reg.route("nope")
        with pytest.raises(ValueError):
            reg.load("m")
        assert not reg.canary_active("m")


@pytest.mark.parametrize("kind", ["value", "raw", "leaf", "raw_device"])
def test_output_kinds_match_reference(shared, kind):
    X, boosters, _ = shared
    got = {}
    for name in SIDES:
        side = Side(name)
        srv = side.server(side.forest(boosters[name]), max_batch=32,
                          max_wait_ms=1, output_kind=kind)
        try:
            got[name] = srv.predict(X[:20], timeout=kWait)
        finally:
            srv.stop()
    assert got["port"].dtype == got["ref"].dtype
    assert np.array_equal(got["port"], got["ref"])


def test_shared_entries_and_swap_keep_versions_match_reference(shared):
    """Two predictors sharing one ``entries`` dict count one bucket
    policy; a swap purges only versions outside ``keep_versions``."""
    import threading
    X, boosters, _ = shared
    out = {}
    for name in SIDES:
        side = Side(name)
        entries, lock = {}, threading.Lock()
        f = side.forest(boosters[name])
        a = side.BucketedPredictor(f, model_version=1, entries=entries,
                                   entries_lock=lock)
        b = side.BucketedPredictor(f, model_version=1, entries=entries,
                                   entries_lock=lock)
        a.predict(X[:5])
        b.predict(X[:5])
        b.predict(X[:40])
        a.swap(f, 2, keep_versions=[1])
        a.predict(X[:5])
        keys_kept = sorted(entries)
        b.swap(f, 3)
        out[name] = (keys_kept, sorted(entries))
    assert out["port"] == out["ref"]
    assert out["port"][0] == [(1, 16, "value"), (1, 64, "value"),
                              (2, 16, "value")]


def test_devices_default_to_the_card(shared):
    X, boosters, _ = shared
    forest = StackedForest.from_gbdt(boosters["port"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(LightGBMError, match="no CUDA device"):
        PredictServer(forest, autostart=False)
    srv = PredictServer(forest, devices=["cpu"], autostart=False)
    assert [d.type for d in srv._devices] == ["cpu"]
    srv.stop()
    # a booster brings its own device (its params say cpu)
    srv = PredictServer(boosters["port"], autostart=False)
    assert [d.type for d in srv._devices] == ["cpu"]
    srv.stop()


@pytest.mark.parametrize("backend", ["cuda", "gpu"])
def test_require_backend_raises_instead_of_falling_back(shared, backend):
    """The JAX package emits ``backend_fallback`` and serves on; the port
    has no fallback."""
    X, boosters, host = shared
    forest = StackedForest.from_gbdt(boosters["port"])
    with pytest.raises(LightGBMError, match="no fallback"):
        PredictServer(forest, devices=["cpu"], require_backend=backend,
                      autostart=False)
    srv = PredictServer(forest, devices=["cpu"], require_backend="cpu")
    try:
        assert srv.predict(X[0], timeout=kWait) == host[0]
    finally:
        srv.stop()


def test_place_copies_a_forest_once_per_device(shared):
    _, boosters, _ = shared
    forest = StackedForest.from_gbdt(boosters["port"])
    assert forest.place("cpu") is forest
    a = forest.place(torch.device("cpu"))
    assert a is forest
    # a server with replicas on one device shares the one placement
    srv = PredictServer(forest, devices=["cpu", "cpu"], autostart=False)
    assert all(p.forest is forest for p in srv.predictors)
    srv.stop()


def test_placed_copies_hold_their_base_weakly(shared):
    """The cache lives on the base forest; a copy points back weakly, so
    dropping the base frees it at once (no reference cycle), and a copy
    left alone is its own placement. ``meta`` stands in for a second
    device."""
    _, boosters, _ = shared
    forest = StackedForest.from_gbdt(boosters["port"])
    cp = forest.place("meta")
    assert cp is not forest and cp.device == torch.device("meta")
    assert forest.place("meta") is cp and cp.place("meta") is cp
    assert cp.place("cpu") is forest and cp._base() is forest
    del forest
    assert cp._base() is None
    assert cp.place("meta") is cp


def test_only_the_servers_dispatches_stage_through_pinned_memory(shared):
    X, boosters, _ = shared
    srv = PredictServer(StackedForest.from_gbdt(boosters["port"]),
                        devices=["cpu", "cpu"], autostart=False)
    assert [p.pinned for p in srv.predictors] == [True, True]
    srv.stop()
    assert BucketedPredictor(srv.predictor.forest).pinned is False
    boosters["port"].predict(X[:64], predict_on_device=True)
    assert boosters["port"]._stacked_cache[1].pinned is False


def test_bucketed_predictor_is_lock_traced_when_enabled(shared,
                                                        monkeypatch):
    from lightgbm_tpu_torch.utils import locktrace
    _, boosters, _ = shared
    forest = StackedForest.from_gbdt(boosters["port"])
    monkeypatch.setenv("LIGHTGBM_TPU_LOCKTRACE", "1")
    bp = BucketedPredictor(forest)
    assert isinstance(bp._entries_lock, locktrace.TracedLock)
    monkeypatch.delenv("LIGHTGBM_TPU_LOCKTRACE")
    assert not isinstance(BucketedPredictor(forest)._entries_lock,
                          locktrace.TracedLock)


def test_warm_dispatches_every_replica(shared):
    X, boosters, host = shared
    srv = PredictServer(StackedForest.from_gbdt(boosters["port"]),
                        devices=["cpu", "cpu"], max_batch=16,
                        autostart=False)
    srv.warm(X[:3])
    assert all(any(k[1] == 16 for k in p.entries)
               for p in srv.predictors)
    srv.start()
    try:
        assert outcome(srv.submit(X[:3]))[0] == "ok"
    finally:
        srv.stop()
