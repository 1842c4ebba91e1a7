"""The port's closed refresh loop (``lightgbm_tpu_torch/loop/``) on the
CPU: train -> publish -> serve -> retrain under live traffic, with chaos
firing mid-loop.

Every case of the JAX package's ``tests/test_refresh_loop.py``, with the
same tier-1 / ``slow`` split: one short two-cycle loop (bootstrap + one
poisoned refresh), a clean three-cycle loop and the deterministic
publish/checkpoint interleave in tier-1, the longer schedules ``slow``.
Beside them:

- the chaos schedule equals the JAX package's for every loop length;
- parity: the port's and the JAX package's controllers on the same
  windows, two clean cycles, publish stable versions whose trees agree
  at level (b) (the same splits and leaf counts, leaf values within
  f32 tolerance);
- a drift-triggered refresh: shifted traffic breaches the PSI
  threshold and starts a refresh early, an unshifted stream does not;
- a second loop in the same process reads only its own measurement
  window (latencies and drift gauges an earlier loop or server left
  do not reach its verdicts);
- without ``device_type="cpu"`` the controller asks for the card and
  raises here.

The watchdog's thresholds are pinned per test (``_torch_watch_env`` and
``monkeypatch``), never left in ``os.environ``.
"""
import os
import threading

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgb
from _torch_watch_env import watch_env_defaults  # noqa: F401
from lightgbm_tpu_torch.ft import checkpoint as ckpt_mod
from lightgbm_tpu_torch.loop import (ChaosLeg, RefreshController,
                                     TrafficGenerator, expected_rollbacks,
                                     refresh_schedule, validate_schedule)
from lightgbm_tpu_torch.obs import faults
from lightgbm_tpu_torch.obs.registry import registry as obs_registry
from lightgbm_tpu_torch.serve import ModelRegistry, PredictServer
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

kFeatures = 10
kParams = {"objective": "binary", "num_leaves": 7, "max_bin": 31,
           "verbosity": -1, "min_data_in_leaf": 10,
           "bin_construct_sample_cnt": 800, "device_type": "cpu"}


@pytest.fixture(autouse=True)
def _slo(monkeypatch, watch_env_defaults):  # noqa: F811
    # after the defaults: the loop's own SLO, as the JAX package's tests
    monkeypatch.setenv("LIGHTGBM_TPU_WATCH_REFRESH_P99_MS", "5000")
    faults.reset()
    yield
    faults.reset()


def _data_fn(cycle, rows=800):
    rng = np.random.default_rng(40 + cycle)
    X = rng.normal(size=(rows, kFeatures))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0.2).astype(np.float64)
    return X, y


def _run(tmp, cycles, params=kParams, **kw):
    kw.setdefault("base_rounds", 2)
    kw.setdefault("extra_rounds", 1)
    kw.setdefault("traffic_threads", 2)
    kw.setdefault("traffic_rows", 32)
    kw.setdefault("drain_timeout_s", 15)
    ctl = RefreshController(params, _data_fn, num_features=kFeatures,
                            work_dir=tmp, **kw)
    return ctl, ctl.run(cycles=cycles)


def test_schedule_shape():
    sched = refresh_schedule(4)
    validate_schedule(sched)
    assert sorted(sched) == [1, 2, 3]
    assert expected_rollbacks(sched) == 1
    # the poisoned leg leads: a 2-cycle loop still proves rollback
    assert refresh_schedule(2)[1][0].poison
    with pytest.raises(ValueError):
        validate_schedule({1: [ChaosLeg("no_such_site:nth:1",
                                        "train", False)]})


@pytest.mark.parametrize("cycles", [2, 3, 4, 7])
def test_schedule_equals_the_reference(cycles):
    from lightgbm_tpu import loop as ref_loop
    ref = ref_loop.refresh_schedule(cycles)
    port = refresh_schedule(cycles)
    assert {c: [tuple(leg) for leg in legs] for c, legs in port.items()} \
        == {c: [tuple(leg) for leg in legs] for c, legs in ref.items()}
    assert expected_rollbacks(port) == ref_loop.expected_rollbacks(ref)
    assert (ref_loop.TRAIN_SITES, ref_loop.SERVE_SITES) == \
        (lgb.loop.TRAIN_SITES, lgb.loop.SERVE_SITES)


def test_two_cycle_loop_poisoned_refresh_rolls_back(tmp_path):
    """Bootstrap + one poisoned refresh: the canary dies on the
    injected dispatch fault, v1 keeps serving, traffic never sees an
    untyped failure, nothing strands, no SLO breach."""
    ctl, rep = _run(str(tmp_path), cycles=2)
    assert rep["ok"], rep["problems"]
    assert rep["num_cycles"] == 2
    assert rep["refresh_rollbacks"] == 1
    assert rep["expected_rollbacks"] == 1
    assert rep["stranded_futures"] == 0
    assert rep["refresh_slo_breaches"] == 0
    assert rep["traffic"]["rows_ok"] > 0
    assert not rep["traffic"]["untyped"]
    c1 = rep["cycles"][1]
    assert c1["outcome"] == "rolled_back"
    assert c1["stable_version"] == rep["cycles"][0]["version"]
    assert c1["injected"] >= 1
    # the loop's spill + checkpoints persist for the next incarnation
    assert ckpt_mod.list_checkpoints(os.path.join(str(tmp_path),
                                                  "ckpt"))
    assert os.path.exists(os.path.join(str(tmp_path), "spill",
                                       "manifest.json"))


def test_clean_loop_promotes_every_cycle(tmp_path):
    """An empty chaos schedule: every refresh promotes, zero
    rollbacks, and each published version supersedes the last."""
    ctl, rep = _run(str(tmp_path), cycles=3, schedule={},
                    use_gateway=False)
    assert rep["ok"], rep["problems"]
    assert rep["refresh_rollbacks"] == 0
    outcomes = [c["outcome"] for c in rep["cycles"]]
    assert outcomes == ["bootstrap", "promoted", "promoted"]
    versions = [c["stable_version"] for c in rep["cycles"]]
    assert versions == sorted(versions) and len(set(versions)) == 3
    # each refresh cycle grew the forest by extra_rounds trees
    assert rep["cycles"][-1]["rounds"] == 2 + 1 * 2


@pytest.mark.slow
def test_full_schedule_loop(tmp_path):
    """Four cycles through the full rotation: poisoned publish,
    retryable train fault, telemetry push fault; every fault fires,
    exactly one rollback, every other cycle promotes."""
    ctl, rep = _run(str(tmp_path), cycles=4)
    assert rep["ok"], rep["problems"]
    assert rep["refresh_rollbacks"] == 1
    assert rep["faults_injected"] >= 3
    assert [c["outcome"] for c in rep["cycles"]] == \
        ["bootstrap", "rolled_back", "promoted", "promoted"]
    for c in rep["cycles"][1:]:
        assert c["injected"] >= 1, c


@pytest.mark.slow
def test_loop_survives_serve_admit_leg(tmp_path):
    """A serve_admit injection during a clean publish window: exactly
    one traffic request fails typed, the cycle still promotes."""
    sched = {1: [ChaosLeg("serve_admit:nth:1", "publish", False)]}
    ctl, rep = _run(str(tmp_path), cycles=2, schedule=sched)
    typed = rep["traffic"]["typed"]
    assert sum(typed.values()) == 1, typed
    assert rep["cycles"][1]["outcome"] == "promoted"
    assert not rep["traffic"]["untyped"]
    assert rep["stranded_futures"] == 0


def test_publish_checkpoint_interleave(tmp_path):
    """Canary rollback while the checkpoint machinery is mid-run, both
    failure sites pinned: the checkpoint finalize fault is retried (the
    dir stays valid and resumable), the canary fault rolls back (the
    registry keeps serving v1), and neither plane corrupts the other."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(900, kFeatures))
    y = (X[:, 0] > 0).astype(np.float64)
    ckdir = str(tmp_path / "ck")
    obs_registry.enable()
    rb0 = obs_registry.count("serve/rollbacks")

    reg = ModelRegistry()
    base = lgb.train(dict(kParams), lgb.Dataset(X, label=y),
                     num_boost_round=2)
    v1 = reg.load("m", booster=base)
    srv = PredictServer(reg, name="m", max_batch=64, max_wait_ms=2,
                        devices=["cpu"])
    blk = np.ascontiguousarray(X[:32], dtype=np.float32)
    srv.predict(blk, timeout=60)
    outcomes = {}

    def mid_train_publish(env):
        # iteration 2 of the checkpointed run: publish a canary into
        # the live server and let the armed dispatch fault kill it
        if env.iteration == 1 and "published" not in outcomes:
            outcomes["published"] = True
            reg.load("m", booster=base, canary_batches=2)
            outcomes["replayed"] = np.asarray(
                srv.predict(blk, timeout=60))

    faults.configure("checkpoint_finalize:nth:1;serve_dispatch:nth:1")
    try:
        trained = lgb.train(dict(kParams), lgb.Dataset(X, label=y),
                            num_boost_round=4, checkpoint_dir=ckdir,
                            checkpoint_freq=1,
                            callbacks=[mid_train_publish])
    finally:
        faults.reset()
    srv.stop()

    # serving plane: rolled back, v1 still the stable version, and the
    # poisoned batch was answered by v1's replay
    assert obs_registry.count("serve/rollbacks") - rb0 == 1
    assert reg.get("m")[0] == v1
    assert not reg.canary_active("m")
    host_ref = np.asarray(base.predict(blk, predict_on_device=False))
    np.testing.assert_array_equal(outcomes["replayed"], host_ref)

    # checkpoint plane: every iteration checkpointed through the
    # retried finalize; the newest one resumes bit-identically
    assert len(ckpt_mod.list_checkpoints(ckdir)) >= 1
    resumed = lgb.train(dict(kParams), lgb.Dataset(X, label=y),
                        num_boost_round=4, checkpoint_dir=ckdir,
                        resume=True)
    assert (resumed.inner.save_model_to_string()
            == trained.inner.save_model_to_string())


def test_traffic_generator_pause_quiesces(tmp_path):
    """pause() returns only once every pump is parked with no request
    in flight; resume() restarts the load."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(600, kFeatures))
    y = (X[:, 0] > 0).astype(np.float64)
    bst = lgb.train(dict(kParams), lgb.Dataset(X, label=y),
                    num_boost_round=2)
    srv = PredictServer(bst, max_batch=64, max_wait_ms=1)
    blk = np.ascontiguousarray(X[:16], dtype=np.float32)
    srv.predict(blk, timeout=60)
    gen = TrafficGenerator(srv, blk, threads=2, timeout_s=60)
    gen.start()
    deadline = threading.Event()
    deadline.wait(0.2)
    assert gen.pause(timeout_s=30)
    n_paused = gen.stats()["requests"]
    deadline.wait(0.1)
    assert gen.stats()["requests"] == n_paused   # truly idle
    gen.resume()
    deadline.wait(0.3)
    stats = gen.stop()
    srv.stop()
    assert stats["requests"] > n_paused
    assert not stats["untyped"]


def test_controller_rejects_degenerate_loop(tmp_path):
    ctl = RefreshController(kParams, _data_fn,
                            num_features=kFeatures,
                            work_dir=str(tmp_path))
    with pytest.raises(ValueError):
        ctl.run(cycles=1)


def test_controller_asks_for_the_card(tmp_path):
    """The params' device_type places the learner and the server; the
    default asks for the card and raises where none is visible, never
    a quiet CPU loop."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: cuda is allowed here")
    params = {k: v for k, v in kParams.items() if k != "device_type"}
    with pytest.raises(LightGBMError, match="no CUDA device"):
        RefreshController(params, _data_fn, num_features=kFeatures,
                          work_dir=str(tmp_path))


def _published_texts(ctl):
    """Record every model text the controller publishes (the booster
    of the bootstrap, the refit texts of the refreshes)."""
    texts = []
    load = ctl.registry.load

    def recording(name="default", booster=None, model_str=None, **kw):
        texts.append(model_str if model_str is not None
                     else booster.model_to_string())
        return load(name, booster=booster, model_str=model_str, **kw)
    ctl.registry.load = recording
    return texts


def _trees(text):
    return lgb.Booster(model_str=text,
                       params={"device_type": "cpu"}).inner.models


def test_port_and_reference_loops_publish_level_b_models(tmp_path):
    """Two clean cycles through both packages' controllers on the same
    windows: each stable version's trees agree at level (b). The
    refresh resumes from the checkpoint of the bootstrap, grows one
    tree on the re-attached spill and refits every leaf on window 1."""
    from lightgbm_tpu.loop import RefreshController as RefController
    kw = dict(base_rounds=2, extra_rounds=1, traffic_threads=2,
              traffic_rows=32, drain_timeout_s=15, schedule={},
              use_gateway=False)
    port = RefreshController(kParams, _data_fn, num_features=kFeatures,
                             work_dir=str(tmp_path / "port"), **kw)
    ref_params = {k: v for k, v in kParams.items() if k != "device_type"}
    ref = RefController(ref_params, _data_fn, num_features=kFeatures,
                        work_dir=str(tmp_path / "ref"), **kw)
    texts = {"port": _published_texts(port), "ref": _published_texts(ref)}
    for ctl in (port, ref):
        rep = ctl.run(cycles=2)
        assert rep["ok"], rep["problems"]
        assert [c["outcome"] for c in rep["cycles"]] == ["bootstrap",
                                                         "promoted"]
    assert len(texts["port"]) == len(texts["ref"]) == 2
    for p_text, r_text in zip(texts["port"], texts["ref"]):
        p_trees, r_trees = _trees(p_text), _trees(r_text)
        assert len(p_trees) == len(r_trees)
        for a, b in zip(r_trees, p_trees):
            ni = a.num_internal
            assert (a.num_leaves, a.split_feature[:ni].tolist(),
                    a.threshold[:ni].tolist(),
                    a.leaf_count[:a.num_leaves].tolist()) == \
                (b.num_leaves, b.split_feature[:ni].tolist(),
                 b.threshold[:ni].tolist(),
                 b.leaf_count[:b.num_leaves].tolist())
            np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                       a.leaf_value[:a.num_leaves],
                                       rtol=1e-4, atol=1e-6)


def _drift_run(tmp, trigger, cycles, shift_after_rows):
    return _run(str(tmp), cycles=cycles, schedule={}, use_gateway=False,
                refresh_trigger=trigger, traffic_pool=8,
                drift_window_s=0.1, drift_min_window_rows=256,
                shift_after_rows=shift_after_rows)


def test_drift_triggers_an_early_refresh(tmp_path):
    """Shifted traffic (``covariate_shift`` after 512 rows) breaches
    the PSI threshold and starts a refresh; the same loop without the
    shift stays below it and refreshes on cadence."""
    ctl, rep = _drift_run(tmp_path / "shift", "drift", 2, 512)
    assert rep["ok"], rep["problems"]
    assert rep["drift_psi_max"] >= 0.25
    assert rep["drift_triggered_refreshes"] >= 1
    assert rep["cycles"][1]["drift_gate"] == "triggered"
    ctl, rep = _drift_run(tmp_path / "calm", "cadence", 2, None)
    assert rep["ok"], rep["problems"]
    assert rep["drift_psi_max"] < 0.25
    assert rep["drift_triggered_refreshes"] == 0


def test_second_loop_in_a_process_reads_its_own_window(tmp_path):
    """Two controllers in one process: the first, on shifted traffic,
    leaves its monitor's drift gauges above the threshold; then an
    earlier server's slow answers sit in ``serve/latency_ms``. The
    second, calm loop's verdicts read only its own window: no
    ``feature_drift`` firing, no ``refresh_slo`` breach, and per-cycle
    p99s below the stale samples."""
    ctl, rep = _drift_run(tmp_path / "shift", "drift", 2, 512)
    assert rep["ok"], rep["problems"]
    assert obs_registry.gauges.get("quality/psi_max", 0.0) >= 0.25
    for _ in range(500):
        obs_registry.observe("serve/latency_ms", 60000.0)
    fired0 = obs_registry.count("health/feature_drift")
    ctl, rep = _drift_run(tmp_path / "calm", "cadence", 2, None)
    assert rep["ok"], rep["problems"]
    assert rep["refresh_slo_breaches"] == 0
    assert obs_registry.count("health/feature_drift") == fired0
    assert all(c["p99_ms"] < 60000.0 for c in rep["cycles"])
    assert rep["serve_p99_during_refresh_ms"] < 60000.0


def test_checkpointed_model_is_the_uninterrupted_training(tmp_path):
    """The loop's newest checkpoint (bootstrap rounds on the streamed
    spill, then a refresh resumed on the re-attached spill under
    traffic) holds the text of one uninterrupted ``lgb.train`` on the
    re-attached spill; refitting that model on the refresh's window
    gives the published stable version's text."""
    from lightgbm_tpu_torch.io.shards import ShardedBinnedDataset
    ctl = RefreshController(kParams, _data_fn, num_features=kFeatures,
                            work_dir=str(tmp_path), base_rounds=2,
                            extra_rounds=2, traffic_rows=32,
                            drain_timeout_s=15, schedule={},
                            use_gateway=False)
    texts = _published_texts(ctl)
    rep = ctl.run(cycles=2)
    assert rep["ok"], rep["problems"]
    _, newest = ckpt_mod.list_checkpoints(str(tmp_path / "ckpt"))[0]
    with open(os.path.join(newest, "model.txt")) as fh:
        loop_text = fh.read()
    spill = ShardedBinnedDataset.attach(str(tmp_path / "spill"))
    alone = lgb.train(dict(kParams), lgb.Dataset(spill), num_boost_round=4)
    assert loop_text == alone.model_to_string()
    Xw, yw = _data_fn(1)
    assert alone.refit(Xw, yw).model_to_string() == texts[-1]
