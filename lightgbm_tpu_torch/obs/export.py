"""Metrics snapshot export: OpenMetrics text, periodic dumps, /metrics.

Port of ``lightgbm_tpu/obs/export.py``. The registry (counters / gauges
/ histograms / stage timer) is a pull model — everything this module
does is *render* one consistent ``registry.snapshot()`` into the
OpenMetrics-style text format and move it somewhere a consumer can
reach:

- :func:`render_openmetrics` — the serializer (stdlib-only);
  `serve/latency_ms` style histogram names come out as summary
  families with ``quantile`` labels, per-function compile/retrace
  telemetry as labeled families (``...jit_traces_total{fn="..."}``),
  the stage timer as ``stage_seconds_total{stage="..."}``.
- :func:`parse_openmetrics` — the matching reader (round-trip tested;
  also what the watchdog tests use to assert the exported numbers).
- :func:`dump_metrics` — one-shot ATOMIC file dump (tmp + rename), for
  training runs that want snapshots without an HTTP listener.
- :class:`SnapshotExporter` — a daemon thread re-dumping every
  ``interval`` seconds and running the SLO watchdog
  (:class:`obs.health.Watchdog`) over each snapshot. Enabled by
  ``LIGHTGBM_TPU_METRICS=path`` (+ ``LIGHTGBM_TPU_METRICS_INTERVAL``,
  seconds, default 10) via :func:`tick`, which the boosting drivers
  call once per iteration (`obs/trace.sample_iteration`).
- :class:`MetricsHTTPServer` — a ``/metrics`` (+ ``/healthz``) HTTP
  listener over the same renderer (the serving plane, ROADMAP item
  20, mounts it).

Multi-process fleets push instead of being scraped per process:
``LIGHTGBM_TPU_METRICS_GATEWAY=url`` makes :func:`tick` start one
:class:`obs.gateway.SnapshotPusher` POSTing this renderer's text to a
:class:`obs.gateway.MetricsGateway`, which serves the whole fleet as
ONE aggregated ``/metrics`` with ``{rank=,process=}`` labels.

Everything here is best-effort and never raises into the caller:
telemetry must not take training or serving down.
"""
from __future__ import annotations

import atexit
import json
import os
import re
import threading
import time
from typing import Dict, Optional

from . import events as _events
from .registry import registry
from ..utils import log
# the text-format layer (escaping, sample lines, strict parsing) lives
# in obs/openmetrics.py — stdlib-pure so the gateway and report
# scripts share it; re-exported here so existing `from obs.export import
# parse_openmetrics` call sites are unchanged
from .openmetrics import (  # noqa: F401  (re-exports)
    Sample, kPrefix, metric_value, parse_openmetrics,
    parse_type_headers, _esc, _fmt, _lbl, _san)

_ENV_PATH = "LIGHTGBM_TPU_METRICS"
_ENV_INTERVAL = "LIGHTGBM_TPU_METRICS_INTERVAL"
_ENV_WATCHDOG = "LIGHTGBM_TPU_WATCHDOG"

kDefaultIntervalS = 10.0

_LABEL_RE = re.compile(
    r"^(.*)/(replica|feature)/([^/]+)(?:/model/(.+))?$")


def _split_labels(name: str):
    """Generic ``<base>/<label>/<k>[/model/<m>]`` → labeled-family
    folding, ONE code path for every labeled registry series:

    - ``serve/latency_ms/replica/3/model/m`` →
      (``serve/latency_ms``, (("model", "m"), ("replica", "3"))) — a
      serving fleet's per-replica series render as ONE family, so a
      single scrape target covers all replicas of every server in the
      process (the per-process /metrics gap from the ROADMAP);
    - ``quality/psi/feature/7`` →
      (``quality/psi``, (("feature", "7"),)) — the drift plane's
      per-feature scores render as one ``{feature=}``-labeled family.
    """
    m = _LABEL_RE.match(name)
    if m is None:
        return name, None
    labels = [(m.group(2), m.group(3))]
    if m.group(4) is not None:
        labels.append(("model", m.group(4)))
    return m.group(1), tuple(sorted(labels))


def render_openmetrics(reg=registry) -> str:
    """Serialize one consistent registry snapshot as OpenMetrics-style
    text (``# TYPE`` headers, ``{label="..."}`` pairs, ``# EOF``
    terminator). Families:

    - counters → ``<name>_total`` (``jit_trace/<fn>`` folds into one
      ``jit_traces_total{fn="..."}`` family);
    - numeric gauges → gauges (``compile/<fn>/<metric>`` folds into
      ``compile_<metric>{fn="..."}``); non-numeric gauges (``backend``)
      → ``<name>_info{value="..."} 1``;
    - histograms (``registry.observe``) → summary families with
      ``quantile="0.5"/"0.99"`` samples + ``_count``;
    - per-replica serving series (``<base>/replica/<k>`` counters and
      histograms, e.g. ``serve/latency_ms/replica/0``) fold into ONE
      family carrying a ``replica="k"`` label, so one scrape target
      covers a whole replicated serving fleet;
    - the stage timer → ``stage_seconds_total{stage=...}`` /
      ``stage_calls_total{stage=...}`` /
      ``stage_duration_ms{stage=...,quantile=...}``.
    """
    snap = reg.snapshot()
    out = []

    counters = snap.get("counters", {})
    plain = {k: v for k, v in counters.items()
             if not k.startswith("jit_trace/")}
    jit = {k[len("jit_trace/"):]: v for k, v in counters.items()
           if k.startswith("jit_trace/")}
    # fold per-replica counters into one labeled family per base name
    # (the samples of a family must stay contiguous under one # TYPE)
    families: Dict[str, list] = {}
    for name, v in plain.items():
        base, labels = _split_labels(name)
        families.setdefault(base, []).append((labels, v))
    for base in sorted(families):
        m = kPrefix + _san(base) + "_total"
        out.append("# TYPE %s counter" % m)
        for labels, v in sorted(families[base],
                                key=lambda lv: lv[0] or ()):
            out.append("%s%s %s" % (m, _lbl(labels), _fmt(v)))
    if jit:
        m = kPrefix + "jit_traces_total"
        out.append("# TYPE %s counter" % m)
        for fn, v in sorted(jit.items()):
            out.append('%s{fn="%s"} %s' % (m, _esc(fn), _fmt(v)))

    gauges = snap.get("gauges", {})
    compile_g: Dict[str, Dict[str, float]] = {}
    # numeric gauges fold through the SAME labeled-family path as the
    # counters/histograms (quality/psi/feature/<k> → {feature="k"})
    gfams: Dict[str, list] = {}
    for name, v in sorted(gauges.items()):
        if name.startswith("compile/"):
            parts = name.split("/")
            if len(parts) == 3:
                compile_g.setdefault(parts[2], {})[parts[1]] = v
                continue
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            base, labels = _split_labels(name)
            gfams.setdefault(base, []).append((labels, v))
        else:
            m = kPrefix + _san(name) + "_info"
            out.append("# TYPE %s gauge" % m)
            out.append('%s{value="%s"} 1' % (m, _esc(v)))
    for base in sorted(gfams):
        m = kPrefix + _san(base)
        out.append("# TYPE %s gauge" % m)
        for labels, v in sorted(gfams[base], key=lambda lv: lv[0] or ()):
            out.append("%s%s %s" % (m, _lbl(labels), _fmt(v)))
    for metric, by_fn in sorted(compile_g.items()):
        m = kPrefix + "compile_" + _san(metric)
        out.append("# TYPE %s gauge" % m)
        for fn, v in sorted(by_fn.items()):
            out.append('%s{fn="%s"} %s' % (m, _esc(fn), _fmt(v)))

    hfams: Dict[str, list] = {}
    for name, h in snap.get("hists", {}).items():
        base, labels = _split_labels(name)
        hfams.setdefault(base, []).append((labels, h))
    for base in sorted(hfams):
        m = kPrefix + _san(base)
        out.append("# TYPE %s summary" % m)
        for labels, h in sorted(hfams[base],
                                key=lambda lh: lh[0] or ()):
            out.append("%s%s %s" % (m, _lbl(labels, [("quantile", "0.5")]),
                                    _fmt(h["p50"])))
            out.append("%s%s %s" % (m, _lbl(labels, [("quantile", "0.99")]),
                                    _fmt(h["p99"])))
            out.append("%s_count%s %s" % (m, _lbl(labels),
                                          _fmt(h["count"])))

    phases = snap.get("phases", {})
    if phases:
        sec = kPrefix + "stage_seconds_total"
        calls = kPrefix + "stage_calls_total"
        dur = kPrefix + "stage_duration_ms"
        out.append("# TYPE %s counter" % sec)
        for stage, e in sorted(phases.items()):
            out.append('%s{stage="%s"} %s'
                       % (sec, _esc(stage), _fmt(e["seconds"])))
        out.append("# TYPE %s counter" % calls)
        for stage, e in sorted(phases.items()):
            out.append('%s{stage="%s"} %s'
                       % (calls, _esc(stage), _fmt(e["calls"])))
        out.append("# TYPE %s summary" % dur)
        for stage, e in sorted(phases.items()):
            if "p50_ms" in e:
                out.append('%s{stage="%s",quantile="0.5"} %s'
                           % (dur, _esc(stage), _fmt(e["p50_ms"])))
                out.append('%s{stage="%s",quantile="0.99"} %s'
                           % (dur, _esc(stage), _fmt(e["p99_ms"])))
    out.append("# EOF")
    return "\n".join(out) + "\n"


def dump_metrics(path: str, reg=registry) -> None:
    """One-shot atomic snapshot dump. Never raises: transient write
    failures retry with bounded backoff (utils/retry.py), and a dump
    that still fails is SKIPPED with a counter + warning (the next
    tick dumps again) — degradation, never a crash or a torn file."""
    try:
        text = render_openmetrics(reg)

        def _write():
            from . import faults
            faults.check("metrics_dump", path=path)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, path)

        from ..utils.retry import retry_call
        retry_call(_write, site="metrics_dump", reg=reg)
    except Exception as e:
        reg.inc("ft/metrics_dump_failed")
        log.warning("metrics snapshot dump to %s failed: %r"
                    % (path, e))


# ----------------------------------------------------------------------
# periodic exporter + watchdog tick
# ----------------------------------------------------------------------

class SnapshotExporter:
    """Daemon thread: every ``interval`` seconds, atomically rewrite
    ``path`` with the current OpenMetrics text and run the SLO watchdog
    over the same snapshot. ``interval=0`` disables the thread — dumps
    then happen only on :meth:`dump_now` / atexit."""

    def __init__(self, path: str, interval: float = kDefaultIntervalS,
                 reg=registry, watchdog=None) -> None:
        from .health import Watchdog
        self.path = path
        self.interval = max(float(interval), 0.0)
        self.reg = reg
        self.watchdog = watchdog if watchdog is not None else Watchdog(reg)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._atexit_registered = False

    def start(self) -> "SnapshotExporter":
        if self.interval > 0 and (self._thread is None
                                  or not self._thread.is_alive()):
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="obs-metrics-exporter", daemon=True)
            self._thread.start()
        if not self._atexit_registered:
            self._atexit_registered = True
            atexit.register(self.dump_now)
        return self

    def stop(self) -> None:
        """Stop the thread AND detach the atexit dump — a stopped
        (replaced) exporter must not re-dump post-stop registry state
        over its old path at interpreter exit."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._atexit_registered:
            self._atexit_registered = False
            try:
                atexit.unregister(self.dump_now)
            except Exception:
                pass

    def dump_now(self) -> None:
        try:
            # each exporter tick is one drift window: drain the
            # registered quality monitors FIRST so the snapshot (and
            # the watchdog pass over it) sees this window's scores
            from . import quality as _quality
            _quality.drain_all(self.reg)
        except Exception:
            pass
        try:
            snap = self.reg.snapshot()
            self.watchdog.evaluate(snap)
        except Exception:
            pass
        dump_metrics(self.path, self.reg)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.dump_now()


_exporter: Optional[SnapshotExporter] = None
_pusher = None  # gateway SnapshotPusher singleton (obs/gateway.py)
_inline_watchdog = None
_lock = threading.Lock()


def tick(reg=registry) -> None:
    """Per-iteration hook (called from ``obs/trace.sample_iteration``):
    starts the env-configured exporter once, the env-configured fleet
    gateway pusher once (``LIGHTGBM_TPU_METRICS_GATEWAY=url`` — the
    training-side half of the obs/gateway.py plane), and — when no file
    exporter is running but ``LIGHTGBM_TPU_WATCHDOG`` asks for it —
    evaluates the default watchdog inline so event-log-only runs still
    get ``health`` events. Cheap when none of the env vars is set."""
    global _exporter, _pusher, _inline_watchdog
    path = os.environ.get(_ENV_PATH)
    if path and _exporter is None:
        with _lock:
            if _exporter is None:
                try:
                    interval = float(os.environ.get(
                        _ENV_INTERVAL, kDefaultIntervalS))
                except ValueError:
                    interval = kDefaultIntervalS
                _exporter = SnapshotExporter(path, interval,
                                             reg).start()
    gw_url = os.environ.get("LIGHTGBM_TPU_METRICS_GATEWAY")
    if gw_url and _pusher is None:
        with _lock:
            if _pusher is None:
                from .gateway import SnapshotPusher
                _pusher = SnapshotPusher(gw_url, reg=reg,
                                         role="train").start()
    if _exporter is not None:
        return
    wd = os.environ.get(_ENV_WATCHDOG, "")
    if wd.strip().lower() in ("", "0", "false", "off"):
        return
    if _inline_watchdog is None:
        with _lock:
            if _inline_watchdog is None:
                from .health import Watchdog
                _inline_watchdog = Watchdog(reg)
    try:
        _inline_watchdog.evaluate()
    except Exception:
        pass


def reset_exporter() -> None:
    """Detach the env-driven exporter/pusher/watchdog singletons
    (tests)."""
    global _exporter, _pusher, _inline_watchdog
    with _lock:
        if _exporter is not None:
            _exporter.stop()
        if _pusher is not None:
            _pusher.stop()
        _exporter = None
        _pusher = None
        _inline_watchdog = None


# ----------------------------------------------------------------------
# /metrics HTTP listener
# ----------------------------------------------------------------------

class MetricsHTTPServer:
    """Minimal stdlib HTTP listener for scraping:

    - ``GET /metrics``  → OpenMetrics text (the renderer above);
    - ``GET /healthz``  → JSON ``registry.snapshot()`` plus the
      watchdog's currently-breached rules, plus — when the mounting
      server provides a ``readiness`` callable — a readiness field
      (``readiness``: ``ready``/``draining``/``stopped``, and the
      boolean ``ready``) DISTINCT from liveness: a draining
      PredictServer still answers scrapes while an external balancer
      rotates it out.

    Binds ``host:port`` (``port=0`` picks a free ephemeral port —
    read it back from ``.port``); serves from a daemon thread. The
    request handler reads ONE consistent snapshot per request and
    never raises into the socket loop."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 reg=registry, watchdog=None, readiness=None) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        self.reg = reg
        self.watchdog = watchdog
        self.readiness = readiness
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                try:
                    if self.path.split("?")[0] == "/metrics":
                        body = render_openmetrics(outer.reg).encode()
                        ctype = "text/plain; charset=utf-8"
                    elif self.path.split("?")[0] == "/healthz":
                        doc = {"snapshot": outer.reg.snapshot()}
                        if outer.watchdog is not None:
                            doc["breached"] = outer.watchdog.breached()
                        if outer.readiness is not None:
                            state = outer.readiness()
                            doc["readiness"] = state
                            doc["ready"] = state == "ready"
                        body = (json.dumps(doc) + "\n").encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception:
                    self.send_error(500)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes must not spam stderr
                pass

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="obs-metrics-http", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return "http://%s:%d" % (self.host, self.port)

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
