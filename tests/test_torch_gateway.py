"""The port's fleet gateway (``lightgbm_tpu_torch/obs/gateway.py``)
against the JAX package's, in one process on the CPU.

Two ranks push the same registry content through each package's
``SnapshotPusher`` into that package's ``MetricsGateway`` (bound to
127.0.0.1, port 0): the aggregated ``{rank=,process=}`` metrics are
equal (level a), leaving out the push ages, which are wall-clock. The
port's pusher also feeds the reference's gateway, so the wire format is
one. A push under the ``gateway_push`` fault spec retries, gives up and
counts, and training would go on. The reference's multi-process case
(``tests/test_gateway.py:420-445``, subprocess ranks) runs as two
``parallel.dtrain`` ranks over gloo on the CPU: each rank's pusher,
wired only through the environment, labels its pushes with its process
group rank, and the gateway's one scrape serves both ranks' stage
tables.
"""
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from lightgbm_tpu.obs import faults as ref_faults
from lightgbm_tpu.obs.gateway import MetricsGateway as RefGateway
from lightgbm_tpu.obs.gateway import SnapshotPusher as RefPusher
from lightgbm_tpu.obs.health import Watchdog as RefWatchdog
from lightgbm_tpu.obs.health import fleet_rules as ref_fleet_rules
from lightgbm_tpu.obs.registry import MetricsRegistry as RefRegistry

from lightgbm_tpu_torch.obs import events, faults
from lightgbm_tpu_torch.obs.gateway import MetricsGateway, SnapshotPusher
from lightgbm_tpu_torch.obs.health import Watchdog, fleet_rules
from lightgbm_tpu_torch.obs.openmetrics import (metric_value,
                                                parse_openmetrics,
                                                sum_metric)
from lightgbm_tpu_torch.obs.registry import MetricsRegistry
from _torch_watch_env import watch_env_defaults  # noqa: F401

_AGE = "lightgbm_tpu_gateway_push_age_seconds"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # Both packages cache a run id read from the environment; another
    # test that set and removed LIGHTGBM_TPU_RUN_ID leaves them holding
    # different ids. Pinned here, both read this one.
    monkeypatch.setenv("LIGHTGBM_TPU_RUN_ID", "gateway-test-run")
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()
    events.register_event_callback(None)


def _fill(reg, rank):
    rng = np.random.RandomState(rank)
    reg.enable()
    reg.inc("kernel/launches/histogram_f32", 255 * (rank + 1))
    reg.gauge("device/bytes_in_use", 1e9 + rank)
    for v in rng.exponential(1.0, 50):
        reg.observe("serve/latency_ms", float(v))
    reg.timer.record("tree::grow", 1.5 + rank)
    return reg


def _aggregate(gw_cls, pusher_cls, reg_cls, wd_cls, rules):
    reg = reg_cls()
    gw = gw_cls(port=0, host="127.0.0.1", reg=reg,
                watchdog=wd_cls(reg, rules=rules()))
    try:
        for rank in (0, 1):
            p = pusher_cls(gw.url, interval=0, reg=_fill(reg_cls(), rank),
                           rank=rank, role="train")
            assert p.push_now() is True
        with urllib.request.urlopen(gw.url + "/metrics", timeout=30) as r:
            text = r.read().decode()
        parsed = parse_openmetrics(text)
        return {k: v for k, v in parsed.items() if k[0] != _AGE}, p.process
    finally:
        gw.close()


def test_aggregated_metrics_match_reference():
    port, proc = _aggregate(MetricsGateway, SnapshotPusher,
                            MetricsRegistry, Watchdog, fleet_rules)
    ref, _ = _aggregate(RefGateway, RefPusher, RefRegistry, RefWatchdog,
                        ref_fleet_rules)
    assert port == ref
    assert metric_value(port, "lightgbm_tpu_stage_seconds_total",
                        rank="1", process=proc, stage="tree::grow") == 2.5
    assert metric_value(
        port, "lightgbm_tpu_kernel_launches_histogram_f32_total",
        rank="0", process=proc) == 255
    assert metric_value(port, "lightgbm_tpu_gateway_sources") == 2.0


def test_port_pusher_feeds_the_reference_gateway():
    reg = RefRegistry()
    gw = RefGateway(port=0, host="127.0.0.1", reg=reg,
                    watchdog=RefWatchdog(reg, rules=ref_fleet_rules()))
    try:
        p = SnapshotPusher(gw.url, interval=0, reg=_fill(
            MetricsRegistry(), 3), rank=3, role="train")
        assert p.push_now() is True
        parsed = parse_openmetrics(gw.render())
        assert metric_value(parsed, "lightgbm_tpu_stage_seconds_total",
                            rank="3", process=p.process,
                            stage="tree::grow") == 4.5
        assert gw.healthz()["num_sources"] == 1
    finally:
        gw.close()


def test_failed_push_retries_then_counts_and_returns():
    reg = MetricsRegistry()
    gw = MetricsGateway(port=0, host="127.0.0.1", reg=MetricsRegistry())
    seen = []
    events.register_event_callback(seen.append)
    try:
        faults.configure("gateway_push:always")
        p = SnapshotPusher(gw.url, interval=0, reg=_fill(reg, 0), rank=0)
        assert p.push_now() is False
        assert reg.count("ft/gateway_push_failed") == 1
        kinds = [r["event"] for r in seen]
        assert "fault_injected" in kinds and "retry_exhausted" in kinds
        assert gw.healthz()["num_sources"] == 0
    finally:
        gw.close()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RANK_CHILD = r"""
import sys
import numpy as np, torch
torch.set_num_threads(1)
from lightgbm_tpu_torch.parallel import distributed, dtrain
rank, init = int(sys.argv[1]), sys.argv[2]
distributed.initialize("file://" + init, 2, rank, backend="gloo")
rng = np.random.RandomState(rank)
X = rng.randn(400, 6)
y = (X[:, 0] + 0.3 * rng.randn(400) > 0).astype(float)
dtrain.train({"objective": "binary", "num_leaves": 7, "verbosity": -1,
              "min_data_in_leaf": 5, "max_bin": 63, "device_type": "cpu"},
             X, y, num_boost_round=2)
torch.distributed.destroy_process_group()
print("RANK_PUSH_OK")
"""


def test_two_dtrain_ranks_push_one_aggregate(tmp_path, monkeypatch):
    """Two ``dtrain`` ranks (gloo, CPU) wired to the parent's gateway
    through the environment alone; the parent's one scrape serves both
    ranks' stage tables under their process-group ranks."""
    reg = MetricsRegistry()
    gw = MetricsGateway(port=0, host="127.0.0.1", reg=reg,
                        watchdog=Watchdog(reg, rules=fleet_rules()),
                        stale_after_s=300)
    try:
        for name in [k for k in os.environ
                     if k.startswith(("LIGHTGBM_TPU_", "RANK"))]:
            monkeypatch.delenv(name)
        monkeypatch.setenv("LIGHTGBM_TPU_METRICS_GATEWAY", gw.url)
        monkeypatch.setenv("LIGHTGBM_TPU_METRICS_PUSH_INTERVAL", "0.2")
        monkeypatch.setenv("LIGHTGBM_TPU_RUN_ID", "fleet-e2e")
        monkeypatch.setenv("LIGHTGBM_TPU_TIMETAG", "1")
        monkeypatch.setenv("LIGHTGBM_TPU_DTRAIN_TIMEOUT_S", "60")
        monkeypatch.setenv("PYTHONPATH",
                           REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
        init = str(tmp_path / "rendezvous")
        procs = [subprocess.Popen(
            [sys.executable, "-c", _RANK_CHILD, str(r), init],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO) for r in range(2)]
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=120)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0])
        for r, (p, out) in enumerate(zip(procs, logs)):
            assert p.returncode == 0 and "RANK_PUSH_OK" in out, (
                "rank %d:\n%s" % (r, out[-3000:]))
        with urllib.request.urlopen(gw.url + "/metrics", timeout=10) as r:
            parsed = parse_openmetrics(r.read().decode())
        for rank in ("0", "1"):
            assert sum_metric(parsed, "lightgbm_tpu_stage_seconds_total",
                              rank=rank, stage="tree::grow") > 0.0, \
                "rank %s stage table missing from the aggregate" % rank
        assert metric_value(parsed, "lightgbm_tpu_run_info",
                            run_id="fleet-e2e") == 1.0
        hz = gw.healthz()
        assert hz["num_sources"] == 2
        assert hz["run_ids"] == ["fleet-e2e"]
    finally:
        gw.close()
