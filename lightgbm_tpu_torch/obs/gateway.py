"""Fleet metrics gateway: one scrape target for every rank and replica.

Port of ``lightgbm_tpu/obs/gateway.py``. A multi-process run (training
ranks, a fleet of serving processes) has no single process that can
answer ``/metrics`` for the whole job — each process owns only its
registry. Pull-per-process does not compose: ranks live on different
hosts behind a scheduler. This module is the push half:

- :class:`SnapshotPusher` — a per-process daemon thread that renders
  the local registry (``obs.export.render_openmetrics``) and POSTs it
  to the gateway every ``interval`` seconds (plus once at exit).
  Transient failures retry via ``utils/retry.retry_call`` (site
  ``gateway_push``, fault-injectable); a DEAD gateway degrades to
  skip + ``ft/gateway_push_failed`` counter — training never blocks
  on telemetry, same contract as every other sink.
- :class:`MetricsGateway` — a stdlib ThreadingHTTPServer accepting
  ``POST /push?rank=R&process=P&run_id=I`` (OpenMetrics text body,
  parsed STRICTLY — malformed pushes get HTTP 400, not silent
  aggregation) and serving:

  - ``GET /metrics``  — every push re-rendered as ONE document, each
    sample tagged ``{rank="R",process="P"}``, families contiguous
    under one ``# TYPE``, plus gateway-own families (push ages,
    push counts, ``run_info``). Round-trips through
    ``parse_openmetrics``.
  - ``GET /healthz``  — per-source push staleness (``age_s`` vs
    ``stale_after_s``), run ids, and the fleet watchdog's currently
    breached rules.

  Every push and every ``/healthz`` evaluates the FLEET watchdog
  (``obs.health.fleet_rules``: ``rank_skew``, ``dead_rank``,
  ``fleet_shed_rate``) over a snapshot synthesized from the aggregated
  pushes — same once-per-breach + re-arm contract as the per-process
  rules, with ``health`` events emitted at the gateway process where
  an operator's event log actually is.

Run correlation: the pusher stamps ``obs.events.run_id()`` (the
``LIGHTGBM_TPU_RUN_ID`` value, generated once and exported to the
environment so spawned ranks inherit it) into every push, so a
gateway metrics dump joins a trace-segment directory on one key.

The rank of a push is the caller's, else the trace layer's process
index (obs/trace.py): the ``torch.distributed`` rank, which
``parallel.dtrain.train`` also pins, else ``RANK`` from the
environment (the JAX package reads ``jax.process_index``).
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Dict, Optional, Tuple

from . import events as _events
from . import faults
from .openmetrics import (kPrefix, parse_openmetrics, parse_type_headers,
                          _esc, _fmt, _lbl)
from .registry import registry
from ..utils import log

_ENV_GATEWAY = "LIGHTGBM_TPU_METRICS_GATEWAY"
_ENV_PUSH_INTERVAL = "LIGHTGBM_TPU_METRICS_PUSH_INTERVAL"
_ENV_PUSH_TIMEOUT = "LIGHTGBM_TPU_GATEWAY_TIMEOUT_S"
_ENV_STALE = "LIGHTGBM_TPU_WATCH_PUSH_STALE_S"

kDefaultPushIntervalS = 5.0
kDefaultPushTimeoutS = 5.0
kDefaultStaleS = 30.0


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class _Push:
    """One source's latest push (the gateway keeps last-value-wins per
    (rank, process) — OpenMetrics counters are cumulative, so history
    lives in the samples, not in the gateway)."""

    __slots__ = ("text", "parsed", "types", "ts", "run_id", "pushes")

    def __init__(self, text: str, parsed: dict, types: dict,
                 run_id: str) -> None:
        self.text = text
        self.parsed = parsed
        self.types = types
        self.ts = time.time()
        self.run_id = run_id
        self.pushes = 1


class MetricsGateway:
    """Aggregating push endpoint + fleet watchdog host. ``port=0``
    binds an ephemeral port (read ``.port`` / ``.url`` back); serves
    from daemon threads; handlers never raise into the socket loop."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 reg=registry, watchdog=None,
                 stale_after_s: Optional[float] = None) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        if watchdog is None:
            from .health import Watchdog, fleet_rules
            watchdog = Watchdog(reg, rules=fleet_rules())
        self.reg = reg
        self.watchdog = watchdog
        self.stale_after_s = (stale_after_s if stale_after_s is not None
                              else _env_float(_ENV_STALE, kDefaultStaleS))
        self._pushes: Dict[Tuple[str, str], _Push] = {}
        self._lock = threading.Lock()
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 — http.server API
                try:
                    if self.path.split("?")[0] != "/push":
                        self.send_error(404)
                        return
                    import urllib.parse
                    q = urllib.parse.parse_qs(
                        urllib.parse.urlsplit(self.path).query)
                    n = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(n).decode("utf-8",
                                                     errors="replace")
                    status, msg = outer.accept_push(
                        body,
                        rank=q.get("rank", ["0"])[0],
                        process=q.get("process", ["?"])[0],
                        run_id=q.get("run_id", [""])[0])
                except Exception:
                    self.send_error(500)
                    return
                out = (msg + "\n").encode()
                self.send_response(status)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def do_GET(self):  # noqa: N802 — http.server API
                try:
                    route = self.path.split("?")[0]
                    if route == "/metrics":
                        body = outer.render().encode()
                        ctype = "text/plain; charset=utf-8"
                    elif route == "/healthz":
                        body = (json.dumps(outer.healthz())
                                + "\n").encode()
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

            def log_message(self, *args):  # pushes must not spam stderr
                pass

        # the lock sanitizer wraps _lock before the serving thread exists
        from ..utils import locktrace
        locktrace.maybe_trace(self)
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="obs-metrics-gateway", daemon=True)
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

    # -- ingestion ------------------------------------------------------
    def accept_push(self, text: str, rank: str, process: str,
                    run_id: str = "") -> Tuple[int, str]:
        """Validate + store one push; returns (http_status, message).
        Strict parse: a malformed body is the PUSHER's bug and must
        surface as a 400 at push time, not as garbage in every
        subsequent scrape."""
        try:
            parsed = parse_openmetrics(text)
        except ValueError as e:
            self.reg.inc("gateway/rejected")
            return 400, "malformed OpenMetrics body: %s" % e
        types = parse_type_headers(text)
        key = (str(rank), str(process))
        with self._lock:
            prev = self._pushes.get(key)
            push = _Push(text, parsed, types, run_id)
            if prev is not None:
                push.pushes = prev.pushes + 1
            self._pushes[key] = push
        self.reg.inc("gateway/pushes")
        self.reg.inc("gateway/push_bytes", len(text))
        self._evaluate()
        return 200, "ok"

    # -- fleet snapshot + watchdog --------------------------------------
    def fleet_snapshot(self) -> dict:
        """The synthetic snapshot ``obs.health.fleet_rules`` evaluates:
        one entry per push source with its age and the fleet-relevant
        aggregates pre-extracted from the parsed samples."""
        now = time.time()
        with self._lock:
            items = sorted(self._pushes.items())
        ranks: Dict[str, dict] = {}
        for (rank, process), p in items:
            stage_s = sum(v for (n, _l), v in p.parsed.items()
                          if n == kPrefix + "stage_seconds_total")
            shed = sum(v for (n, _l), v in p.parsed.items()
                       if n == kPrefix + "serve_shed_total")
            reqs = sum(v for (n, _l), v in p.parsed.items()
                       if n == kPrefix + "serve_requests_total")
            ranks["%s/%s" % (rank, process)] = {
                "rank": rank, "process": process,
                "age_s": max(now - p.ts, 0.0),
                "stage_seconds": stage_s,
                "shed_total": shed, "requests": reqs,
                "run_id": p.run_id, "pushes": p.pushes,
            }
        return {"fleet": {"ranks": ranks,
                          "stale_after_s": self.stale_after_s}}

    def _evaluate(self) -> None:
        try:
            self.watchdog.evaluate(self.fleet_snapshot())
        except Exception:
            pass

    # -- rendering ------------------------------------------------------
    def render(self) -> str:
        """ONE OpenMetrics document for the whole fleet: every pushed
        sample re-rendered with ``{rank=,process=}`` injected (pushed
        rank/process labels, if any, are superseded — the gateway's
        source identity wins), one contiguous family per name, plus
        gateway-own families."""
        now = time.time()
        with self._lock:
            items = sorted(self._pushes.items())
        fams: Dict[str, dict] = {}
        for (rank, process), p in items:
            extra = (("process", process), ("rank", rank))
            for (name, labels), v in sorted(p.parsed.items()):
                kept = tuple((k, x) for k, x in labels
                             if k not in ("rank", "process"))
                fam = fams.setdefault(name, {"type": None, "samples": []})
                if p.types.get(name):
                    fam["type"] = p.types[name]
                fam["samples"].append(
                    (tuple(sorted(kept + extra)), v))
        out = []
        for name in sorted(fams):
            fam = fams[name]
            if fam["type"]:
                out.append("# TYPE %s %s" % (name, fam["type"]))
            for labels, v in fam["samples"]:
                out.append("%s%s %s" % (name, _lbl(labels), _fmt(v)))
        # gateway-own families: per-source freshness + run correlation
        if items:
            m = kPrefix + "gateway_push_age_seconds"
            out.append("# TYPE %s gauge" % m)
            for (rank, process), p in items:
                out.append("%s%s %s" % (
                    m, _lbl((("process", process), ("rank", rank))),
                    _fmt(round(max(now - p.ts, 0.0), 3))))
            m = kPrefix + "gateway_pushes_total"
            out.append("# TYPE %s counter" % m)
            for (rank, process), p in items:
                out.append("%s%s %s" % (
                    m, _lbl((("process", process), ("rank", rank))),
                    _fmt(p.pushes)))
            m = kPrefix + "gateway_sources"
            out.append("# TYPE %s gauge" % m)
            out.append("%s %d" % (m, len(items)))
            m = kPrefix + "run_info"
            out.append("# TYPE %s gauge" % m)
            for rid in sorted({p.run_id for _k, p in items if p.run_id}):
                out.append('%s{run_id="%s"} 1' % (m, _esc(rid)))
        out.append("# EOF")
        return "\n".join(out) + "\n"

    def healthz(self) -> dict:
        """Fleet liveness: per-source staleness + breached rules. A
        scrape is also a watchdog tick — ``dead_rank`` must fire even
        when the dead rank (by definition) stops pushing."""
        self._evaluate()
        snap = self.fleet_snapshot()["fleet"]
        stale = sorted(k for k, e in snap["ranks"].items()
                       if e["age_s"] >= self.stale_after_s)
        for e in snap["ranks"].values():
            e["age_s"] = round(e["age_s"], 3)
            e["stale"] = e["age_s"] >= self.stale_after_s
        return {"ranks": snap["ranks"], "stale": stale,
                "num_sources": len(snap["ranks"]),
                "stale_after_s": self.stale_after_s,
                "run_ids": sorted({e["run_id"]
                                   for e in snap["ranks"].values()
                                   if e["run_id"]}),
                "breached": self.watchdog.breached()}


# ----------------------------------------------------------------------
# push side
# ----------------------------------------------------------------------

class SnapshotPusher:
    """Per-process push loop: render the local registry, POST it to the
    gateway, repeat every ``interval`` seconds (``interval=0`` disables
    the thread — pushes then happen only via :meth:`push_now` and the
    atexit final push).

    The POST goes through ``retry_call(site="gateway_push")`` —
    bounded attempts, seeded backoff, ``ft/retries/gateway_push``
    accounting, and the ``gateway_push`` fault-injection gate. A push
    that still fails is SKIPPED with ``ft/gateway_push_failed`` + one
    warning per outage (not one per interval): the next tick pushes a
    fresh snapshot anyway, because counters are cumulative — a lost
    push costs staleness, never correctness, and training NEVER blocks
    on the gateway (the loop runs on a daemon thread and push_now's
    wall time is bounded by attempts x timeout)."""

    def __init__(self, url: str, interval: Optional[float] = None,
                 reg=registry, rank: Optional[int] = None,
                 role: str = "proc",
                 timeout_s: Optional[float] = None) -> None:
        self.url = url.rstrip("/")
        self.interval = (interval if interval is not None
                         else _env_float(_ENV_PUSH_INTERVAL,
                                         kDefaultPushIntervalS))
        self.interval = max(float(self.interval), 0.0)
        self.reg = reg
        self.rank = rank
        self.process = "%s:%d" % (role, os.getpid())
        self.timeout_s = (timeout_s if timeout_s is not None
                          else _env_float(_ENV_PUSH_TIMEOUT,
                                          kDefaultPushTimeoutS))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._atexit_registered = False
        self._warned = False

    def _resolve_rank(self) -> int:
        """The rank label: explicit, else the trace layer's process
        index (the caller's, or ``RANK`` from the environment)."""
        if self.rank is not None:
            return int(self.rank)
        from . import trace as _trace
        return _trace.process_index()

    def start(self) -> "SnapshotPusher":
        if self.interval > 0 and (self._thread is None
                                  or not self._thread.is_alive()):
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="obs-gateway-pusher", daemon=True)
            self._thread.start()
        if not self._atexit_registered:
            self._atexit_registered = True
            atexit.register(self.push_now)
        return self

    def stop(self) -> None:
        """Stop the loop AND detach the atexit push — a stopped
        (replaced) pusher must not report post-stop registry state as
        this process's final word."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._atexit_registered:
            self._atexit_registered = False
            try:
                atexit.unregister(self.push_now)
            except Exception:
                pass

    def push_now(self) -> bool:
        """One render + POST through the retry/fault plane; True on
        success. Never raises."""
        try:
            import http.client
            import urllib.parse
            import urllib.request

            from .export import render_openmetrics
            from ..utils.retry import retry_call
            text = render_openmetrics(self.reg).encode("utf-8")
            rank = self._resolve_rank()
            full = "%s/push?%s" % (self.url, urllib.parse.urlencode(
                {"rank": rank, "process": self.process,
                 "run_id": _events.run_id()}))

            def _post():
                faults.check("gateway_push", url=self.url, rank=rank)
                req = urllib.request.Request(
                    full, data=text, method="POST",
                    headers={"Content-Type":
                             "application/openmetrics-text"})
                with urllib.request.urlopen(
                        req, timeout=self.timeout_s) as resp:
                    resp.read()

            # HTTPException (torn response) is not an OSError but is
            # just as transient; URLError already subclasses OSError
            retry_call(_post, site="gateway_push", reg=self.reg,
                       retry_on=(OSError, http.client.HTTPException))
            self.reg.inc("gateway/pushes_sent")
            self._warned = False
            return True
        except Exception as e:
            self.reg.inc("ft/gateway_push_failed")
            if not self._warned:
                self._warned = True
                log.warning("metrics push to %s failed (%r) — skipping "
                            "until the gateway recovers" % (self.url, e))
            return False

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.push_now()
