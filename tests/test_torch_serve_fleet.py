"""The port's serving fleet (``replicas=``, ``serve/replicate.py``)
against the JAX package's, on the CPU.

The CPU stands in for the cards: the port's replicas take
``devices=["cpu", "cpu"]`` (two dispatch workers over one admission
queue), the JAX package's run on its virtual CPU devices. Held here:

- answers of 1, 2 and 3 replicas byte-equal to each other, to the JAX
  package's fleet and to the host walk (level a), for binary,
  regression and multiclass models;
- every dispatch attributed to exactly one replica; the per-replica
  series export as ``{replica="k", model=...}`` OpenMetrics labels;
- the canary pinned to replica 0 (a poisoned canary rolls back, a clean
  one promotes, every answer byte-equal to the version serving it);
- one breaker and one drain for the whole fleet;
- ``sharded_bucket`` equal to the JAX package's for every size and
  device count, and ``ReplicatedForest.predict_raw_sharded``
  bit-identical to one device's ``predict_raw_device`` and to the JAX
  package's sharded program.
"""
import concurrent.futures as cf

import numpy as np
import pytest
import torch

import lightgbm_tpu as ref_lgb
import lightgbm_tpu_torch as lgb
from _torch_serve_util import SIDES, Side, data, kWait, shared_model
from _torch_watch_env import watch_env_defaults  # noqa: F401
from lightgbm_tpu.serve.replicate import sharded_bucket as ref_bucket
from lightgbm_tpu_torch.obs.export import render_openmetrics
from lightgbm_tpu_torch.obs.openmetrics import (metric_value,
                                                parse_openmetrics)
from lightgbm_tpu_torch.obs.registry import registry
from lightgbm_tpu_torch.serve import (PredictServer, ReplicatedForest,
                                      StackedForest, sharded_bucket)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def shared():
    return shared_model()


@pytest.fixture(autouse=True)
def _clean():
    yield
    for name in SIDES:
        Side(name).reset()


def _serve_all(srv, X, n_single=48):
    """Single rows, a block and an oversized request (its chunks land on
    different replicas); the reassembled answers."""
    futs = [srv.submit(X[i]) for i in range(n_single)]
    blk = srv.submit(X[:40])
    big = srv.submit(X)
    return [np.array([f.result(timeout=kWait) for f in futs]),
            np.asarray(blk.result(timeout=kWait)),
            np.asarray(big.result(timeout=kWait))]


@pytest.mark.parametrize("objective,extra", [
    ("binary", {}), ("regression", {}),
    ("multiclass", {"num_class": 3, "num_leaves": 7})])
def test_replicas_byte_equal_to_one_replica_and_reference(objective,
                                                          extra):
    X, y = data(n=400, seed=0)
    label = (y if objective == "binary"
             else X[:, 0] + np.nan_to_num(X[:, 2])
             if objective == "regression"
             else (X[:, 4] % 3).astype(float))
    params = {"objective": objective, "num_leaves": 15, "verbosity": -1,
              "min_data_in_leaf": 5, "max_bin": 63,
              "categorical_feature": [4], **extra}
    ref = ref_lgb.train(params, ref_lgb.Dataset(X, label=label),
                        num_boost_round=6)
    port = lgb.Booster(model_str=ref.model_to_string(),
                       params={"device_type": "cpu"})
    host = ref.predict(X, predict_on_device=False)
    forest = StackedForest.from_gbdt(port)
    outs = {}
    for n in (1, 2, 3):
        before = sum(registry.count(
            "serve/dispatches/replica/%d/model/default" % k)
            for k in range(n))
        srv = PredictServer(forest, max_batch=32, max_wait_ms=1,
                            devices=["cpu"] * n)
        assert srv.replicas == n and len(srv.predictors) == n
        outs[n] = _serve_all(srv, X)
        srv.stop()
        after = sum(registry.count(
            "serve/dispatches/replica/%d/model/default" % k)
            for k in range(n))
        assert after - before == srv.stats["dispatches"]
    srv = ref_lgb.serve.PredictServer(
        ref_lgb.serve.StackedForest.from_gbdt(ref), max_batch=32,
        max_wait_ms=1, replicas=2)
    outs["ref"] = _serve_all(srv, X)
    srv.stop()
    for n in (2, 3, "ref"):
        for a, b in zip(outs[1], outs[n]):
            assert np.array_equal(a, b), (objective, n)
    assert np.array_equal(outs[2][0], host[:48])
    assert np.array_equal(outs[2][2], host)


def test_replicas_auto_and_cycling(shared):
    _, boosters, _ = shared
    forest = StackedForest.from_gbdt(boosters["port"])
    srv = PredictServer(forest, devices=["cpu"], replicas=3,
                        autostart=False)
    assert srv.replicas == 3
    assert [str(d) for d in srv._devices] == ["cpu"] * 3
    srv.stop()
    srv = PredictServer(forest, devices=["cpu", "cpu"], replicas="auto",
                        autostart=False)
    assert srv.replicas == 2
    srv.stop()


def test_canary_pinned_to_replica_zero(shared):
    """Only replica 0 routes the canary: a non-finite canary is screened
    there and rolls back (every answer byte-equal to v1), then a clean
    canary promotes and every replica serves it."""
    X, boosters, host = shared
    side = Side("port")
    reg = side.ModelRegistry()
    v1 = reg.load("m", booster=boosters["port"], num_iteration=4)
    with side.recording() as rec:
        srv = PredictServer(reg, name="m", max_batch=64, max_wait_ms=1,
                            devices=["cpu"] * 3)
        want = srv.predict(X[:32], timeout=kWait)
        poisoned = lgb.Booster(model_str=boosters["port"].model_to_string(),
                               params={"device_type": "cpu"})
        for t in poisoned.inner.models:
            t.leaf_value[:t.num_leaves] = np.nan
        reg.publish("m", StackedForest.from_gbdt(poisoned),
                    canary_batches=2)
        outs = []
        base = side.registry.count("serve/rollbacks")
        for _ in range(80):
            outs.append(srv.predict(X[:32], timeout=kWait))
            if side.registry.count("serve/rollbacks") > base:
                break
        assert reg.get("m")[0] == v1
        assert all(np.array_equal(o, want) for o in outs)
        v3 = reg.load("m", booster=boosters["port"], canary_batches=2)
        for _ in range(80):
            srv.predict(X[:32], timeout=kWait)
            if reg.get("m")[0] == v3:
                break
        full = [srv.predict(X[:32], timeout=kWait) for _ in range(6)]
        srv.stop()
    assert reg.get("m")[0] == v3
    assert all(np.array_equal(f, host[:32]) for f in full)
    rolled = [e for e in rec.events if e["event"] == "model_rollback"]
    assert len(rolled) == 1 and rolled[0]["rolled_back_to"] == v1
    promoted = [e for e in rec.events
                if e["event"] == "model_swap" and e.get("canary")]
    assert [e["version"] for e in promoted] == [v3]
    # only replica 0 dispatched canary batches: its predict_batch events
    # are the only ones on a canary version before the promote
    canary_reps = {e["replica"] for e in rec.events
                   if e["event"] == "predict_batch" and e["version"] == 2}
    assert canary_reps <= {0}


def test_one_breaker_and_one_drain_for_the_fleet(shared):
    X, boosters, _ = shared
    out = {}
    for name in SIDES:
        side = Side(name)
        kw = ({"devices": ["cpu"] * 4} if name == "port"
              else {"replicas": 4})
        srv = side.serve.PredictServer(
            side.forest(boosters[name]), max_batch=16, max_wait_ms=1,
            breaker_threshold=3, breaker_cooldown_ms=60_000, **kw)
        side.faults.configure("serve_dispatch:always")
        kinds = []
        try:
            for i in range(12):
                try:
                    srv.predict(X[i], timeout=kWait)
                    kinds.append("ok")
                except Exception as e:  # noqa: BLE001
                    kinds.append(type(e).__name__)
        finally:
            side.faults.reset()
        srv.stop()
        srv = side.serve.PredictServer(
            side.forest(boosters[name]), max_batch=16, max_wait_ms=50,
            autostart=False, **kw)
        futs = [srv.submit(X[i]) for i in range(40)]
        srv.start()
        srv.stop(drain_timeout_s=30)
        unresolved = 0
        for f in futs:
            try:
                f.result(timeout=0)
            except cf.TimeoutError:
                unresolved += 1
            except Exception:  # noqa: BLE001 — typed failures resolve
                pass
        out[name] = (kinds, unresolved)
    assert out["port"] == out["ref"]
    assert out["port"][0] == ["InjectedFault"] * 3 + ["BreakerOpen"] * 9
    assert out["port"][1] == 0


def test_replica_labelled_metrics_export(shared):
    X, boosters, _ = shared
    srv = PredictServer(StackedForest.from_gbdt(boosters["port"]),
                        max_batch=32, max_wait_ms=1,
                        devices=["cpu", "cpu"], name="fleet")
    srv.warm(X[:32])
    futs = [srv.submit(X[i:i + 8]) for i in range(0, 320, 8)]
    for f in futs:
        f.result(timeout=kWait)
    stats = srv.replica_stats()
    srv.stop()
    assert set(stats) == {0, 1}
    assert sum(s["dispatches"] for s in stats.values()) > 0
    text = render_openmetrics(registry)
    parsed = parse_openmetrics(text)
    assert metric_value(parsed, "lightgbm_tpu_serve_replicas") == 2
    for k, s in stats.items():
        if not s["dispatches"]:
            continue
        assert metric_value(parsed, "lightgbm_tpu_serve_dispatches_total",
                            replica=str(k),
                            model="fleet") == s["dispatches"]
        assert metric_value(parsed, "lightgbm_tpu_serve_latency_ms",
                            replica=str(k), model="fleet",
                            quantile="0.99") is not None
    lat_types = [ln for ln in text.splitlines()
                 if ln == "# TYPE lightgbm_tpu_serve_latency_ms summary"]
    assert len(lat_types) == 1


def test_sharded_bucket_matches_reference():
    for n in (1, 5, 16, 100, 1000, 4097):
        for d in range(1, 9):
            for mb in (1, 16, 64):
                b = sharded_bucket(n, d, mb)
                assert b == ref_bucket(n, d, mb)
                assert b % d == 0 and b >= n


@pytest.mark.parametrize("n_dev,rows", [(1, 100), (2, 100), (3, 37),
                                        (4, 1)])
def test_sharded_dispatch_bit_identical(shared, n_dev, rows):
    X, boosters, _ = shared
    forest = StackedForest.from_gbdt(boosters["port"])
    rf = ReplicatedForest(forest, devices=["cpu"] * n_dev)
    assert rf.num_replicas == n_dev and rf.replica(n_dev) is forest
    single = forest.predict_raw_device(X[:rows]).numpy()
    got = rf.predict_raw_sharded(X[:rows])
    assert np.array_equal(got, single)
    ref_forest = ref_lgb.serve.StackedForest.from_gbdt(boosters["ref"])
    ref_rf = ref_lgb.serve.ReplicatedForest(ref_forest)
    assert np.array_equal(got, ref_rf.predict_raw_sharded(X[:rows]))


def test_replicated_forest_needs_a_card_by_default(shared):
    _, boosters, _ = shared
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    from lightgbm_tpu_torch.utils.log import LightGBMError
    with pytest.raises(LightGBMError, match="no CUDA device"):
        ReplicatedForest(StackedForest.from_gbdt(boosters["port"]))
