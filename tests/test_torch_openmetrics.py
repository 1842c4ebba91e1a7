"""The port's OpenMetrics export (``lightgbm_tpu_torch/obs/export.py``,
``obs/openmetrics.py``) against the JAX package's on the CPU.

- ``render_openmetrics`` gives the reference's bytes on the same registry
  content (level a): counters (the jit-trace family included), gauges
  with labels folded out of their names, reservoir summaries and the
  stage table;
- the text parses back strictly, and malformed text raises;
- the ``/metrics`` and ``/healthz`` listener serves it on 127.0.0.1,
  port 0, and stops;
- an atomic dump leaves no temporary file, and a failed one (through
  the fault spec) is skipped with its counter.
"""
import json
import os
import urllib.request

import numpy as np
import pytest

from lightgbm_tpu.obs import export as ref_export
from lightgbm_tpu.obs.registry import MetricsRegistry as RefRegistry

from lightgbm_tpu_torch.obs import export, faults, openmetrics
from lightgbm_tpu_torch.obs.registry import MetricsRegistry


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.reset()


def _fill(reg):
    rng = np.random.RandomState(5)
    reg.inc("serve/requests", 12)
    reg.inc("kernel/launches/histogram_f32", 255)
    reg.inc("jit_trace/serial.root", 2)
    reg.inc("ft/retries/checkpoint_finalize")
    reg.gauge("serve/queue_depth", 3)
    reg.gauge("quality/psi/feature/4", 0.125)
    reg.gauge("device/bytes_in_use", 1.5e9)
    reg.gauge("backend", "cuda")
    for v in rng.exponential(2.0, 300):
        reg.observe("serve/latency_ms", float(v))
        reg.observe("serve/latency_ms/replica/1", float(v) * 2)
    reg.enable()
    for i, v in enumerate(rng.exponential(1e-3, 40)):
        reg.timer.record(("tree::grow", "gbdt::gradients")[i % 2], float(v))
    return reg


def test_render_is_byte_equal_to_reference():
    port = export.render_openmetrics(_fill(MetricsRegistry()))
    ref = ref_export.render_openmetrics(_fill(RefRegistry()))
    assert port == ref
    assert port.endswith("# EOF\n")
    assert openmetrics.kPrefix == "lightgbm_tpu_"


def test_render_parses_back_strictly():
    text = export.render_openmetrics(_fill(MetricsRegistry()))
    parsed = openmetrics.parse_openmetrics(text)
    assert openmetrics.metric_value(
        parsed, "lightgbm_tpu_serve_requests_total") == 12
    assert openmetrics.metric_value(
        parsed, "lightgbm_tpu_kernel_launches_histogram_f32_total") == 255
    with pytest.raises(ValueError):
        openmetrics.parse_openmetrics("lightgbm_tpu_x{bad 1\n")


def test_metrics_listener_serves_on_port_zero():
    reg = _fill(MetricsRegistry())
    srv = export.MetricsHTTPServer(port=0, host="127.0.0.1", reg=reg)
    try:
        assert srv.port > 0
        base = "http://127.0.0.1:%d" % srv.port
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            body = r.read().decode()
        assert body == export.render_openmetrics(reg)
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read().decode())
        assert health["snapshot"]["counters"]["serve/requests"] == 12
    finally:
        srv.close()


def test_dump_is_atomic_and_a_failed_dump_is_counted(tmp_path):
    reg = _fill(MetricsRegistry())
    path = str(tmp_path / "metrics.prom")
    export.dump_metrics(path, reg)
    with open(path) as f:
        assert f.read() == export.render_openmetrics(reg)
    assert os.listdir(str(tmp_path)) == ["metrics.prom"]
    faults.configure("metrics_dump:always")
    export.dump_metrics(path, reg)
    assert reg.count("ft/metrics_dump_failed") == 1
    assert reg.count("ft/retry_exhausted") == 1
