"""The port's fleet gateway (``lightgbm_tpu_torch/obs/gateway.py``)
against the JAX package's, in one process on the CPU.

Two ranks push the same registry content through each package's
``SnapshotPusher`` into that package's ``MetricsGateway`` (bound to
127.0.0.1, port 0): the aggregated ``{rank=,process=}`` metrics are
equal (level a), leaving out the push ages, which are wall-clock. The
port's pusher also feeds the reference's gateway, so the wire format is
one. A push under the ``gateway_push`` fault spec retries, gives up and
counts, and training would go on. The reference's multi-process case
(``tests/test_gateway.py``, subprocess ranks) waits for the port's
multi-device training (ROADMAP item 22).
"""
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
                                                parse_openmetrics)
from lightgbm_tpu_torch.obs.registry import MetricsRegistry
from _torch_watch_env import watch_env_defaults  # noqa: F401

_AGE = "lightgbm_tpu_gateway_push_age_seconds"


@pytest.fixture(autouse=True)
def _clean():
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
