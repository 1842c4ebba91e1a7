"""Structured telemetry for the whole training pipeline.

Port of ``lightgbm_tpu/obs`` (reference: ``Common::Timer`` /
``FunctionTimer`` RAII scopes around every pipeline stage,
include/LightGBM/utils/common.h:973,1037, aggregated table printed at
exit under -DUSE_TIMETAG):

- :mod:`registry`  — counters, gauges, reservoir histograms and the
  stage timer; on the card, scopes also open NVTX ranges so stages show
  in an Nsight Systems timeline.
- :mod:`events`    — a JSON-lines event sink (``LIGHTGBM_TPU_EVENT_LOG``
  env var or a programmatic callback mirroring
  ``log.register_log_callback``).
- :mod:`compile`   — kernel builds (``nvcc``) and CUDA graph captures,
  counted with an event each (the JAX package's jit-trace tracking).
- :mod:`health`    — the ``backend`` event, plus the SLO
  :class:`~lightgbm_tpu_torch.obs.health.Watchdog` (threshold rules over
  the snapshot stream, one ``health`` event per breach).
- :mod:`export`    — OpenMetrics-style snapshot rendering: periodic
  file dumps (``LIGHTGBM_TPU_METRICS=path``) and the HTTP ``/metrics``
  listener (text-format primitives live in the stdlib-pure
  :mod:`openmetrics`).
- :mod:`gateway`   — the FLEET plane: per-process
  :class:`~lightgbm_tpu_torch.obs.gateway.SnapshotPusher` POSTs
  (``LIGHTGBM_TPU_METRICS_GATEWAY=url``) into one
  :class:`~lightgbm_tpu_torch.obs.gateway.MetricsGateway` serving
  aggregated ``{rank=,process=}`` metrics + per-rank push staleness.
- :mod:`trace`     — span tracing layered onto the scopes and events
  above, exported as Chrome-trace/Perfetto JSON
  (``LIGHTGBM_TPU_TRACE=path.json``), with the async readiness drainer
  (CUDA events it polls) that replaces stage fences under
  ``LIGHTGBM_TPU_TIMETAG=sample``; streaming runs can write the compact
  binary segment format of :mod:`trace_compact`
  (``LIGHTGBM_TPU_TRACE_FORMAT=compact``).
- :mod:`faults`    — deterministic fault injection at the I/O sites.
- :mod:`quality`   — reference profiles and drift scores over binned
  counts kept on the device.

Enable stage timing with ``LIGHTGBM_TPU_TIMETAG=1`` (fencing) or
``=sample`` (non-perturbing) or ``registry.enable()``; route events to a
file with ``LIGHTGBM_TPU_EVENT_LOG=path`` or
``events.register_event_callback``. The environment variables keep the
JAX package's names: a deployment carries them over unchanged.
"""
from __future__ import annotations

from . import compile as compile_tracking  # noqa: F401
from . import events, faults, health  # noqa: F401
from . import openmetrics, trace_compact  # noqa: F401  (stdlib-pure)
from .registry import MetricsRegistry, StageTimer, registry  # noqa: F401
from . import trace  # noqa: F401  (installs the span hooks/taps)
from . import export  # noqa: F401  (OpenMetrics snapshots + /metrics)
from . import gateway  # noqa: F401  (fleet push gateway)

scope = registry.scope
counter = registry.inc
gauge = registry.gauge
observe = registry.observe
watch_ready = registry.watch_ready

__all__ = [
    "MetricsRegistry", "StageTimer", "registry", "events", "health",
    "compile_tracking", "trace", "trace_compact", "openmetrics",
    "export", "gateway", "scope", "counter", "gauge",
    "observe", "watch_ready",
]
