"""Model registry + micro-batching predict server, overload-safe.

Port of ``lightgbm_tpu/serve/server.py``; the semantics are the JAX
package's (``docs/SERVING.md``), held against it on the CPU by
``tests/test_torch_serve*.py``.

``ModelRegistry`` holds named, versioned StackedForests and supports hot
swap: ``load`` packs a new version (from a live Booster/GBDT or a
LightGBM-v3 model text via models/tree.py parsing) and atomically
publishes it; every swap emits a ``model_swap`` event. In-flight
dispatches finish on the version they started with.
``publish(..., canary_batches=N)`` stages the new version as a CANARY
instead: the first N real dispatches route through it while the old
version stays resident, a dispatch exception or non-finite output
during the window auto-rolls back (flushed ``model_rollback`` event —
the old version keeps serving), and only a clean window promotes
(``model_swap`` with ``canary=True``). ``registry_swap`` stays the
fault-injection site for both the publish and the promote step, so the
whole path is chaos-testable.

``PredictServer`` coalesces concurrent requests into device batches: a
worker thread drains the queue, waits up to ``max_wait_ms`` from the
first queued request for more rows (up to ``max_batch``), and runs ONE
bucketed dispatch for the whole batch — N concurrent single-row
requests cost ceil(N / max_batch) dispatches, not N. A request larger
than ``max_batch`` is split across dispatches and its Future's result
reassembled (the predictor never sees a batch past its bucket cap).

``replicas=N`` (or ``"auto"``, one per visible card) turns the server
into a fleet: the forest is PLACED on each replica's device
(``StackedForest.place``; one copy per device, cached) and N dispatch
workers drain the ONE admission queue — so shedding, deadlines, the
breaker, and drain stay global while dispatch capacity scales with the
devices. ``replicas=N`` cycles the devices (``devices[k % D]``): on one
card, ``replicas=2`` runs two workers on it. Each worker on a card
dispatches on a CUDA stream of its own; its rows go up through a pinned
host buffer without blocking and its result comes back in one read per
dispatch, so no tensor crosses streams (a new version's placement
synchronizes once, before any worker reads it). The devices are the
card unless the caller passes ``devices=`` (``["cpu", "cpu"]`` on the
CPU); a Booster model brings its own device.
``replicas`` defaults to one per listed device when ``devices`` is
given, else to one.
All replicas share one bucket policy (``BucketedPredictor`` ``entries``).
Canary routing is pinned to replica 0, so a canary window's outcomes
are evaluated sequentially and rollback semantics are identical to the
single-replica server; the other replicas serve the stable version
throughout the window. Per-replica latency histograms
(``serve/latency_ms/replica/<k>``) and dispatch counters merge into the
serve summary via ``replica_stats()`` and export as
``{replica="k"}``-labeled series (obs/export.py).

The serving plane is fail-closed under overload (docs/SERVING.md has
the full semantics + typed error catalog):

- **Admission control** — ``max_queue_rows`` bounds the queue;
  ``overflow="reject"`` fails the Future immediately with
  :class:`Overloaded` (``serve/shed_total`` counter + flushed
  ``request_shed`` event), ``overflow="block"`` backpressures the
  submitter for at most ``block_timeout_ms`` before shedding.
- **Deadline budgets** — per-request ``deadline_ms`` (or the server's
  ``default_deadline_ms``) is checked at admission AND again at
  dispatch pop, so a request that aged out while queued fails fast
  with :class:`DeadlineExceeded` (``serve/deadline_expired``) instead
  of wasting dispatch capacity.
- **Circuit breaker** — ``breaker_threshold`` consecutive dispatch
  failures open it; submits then fail fast with :class:`BreakerOpen`
  (state attached) until a half-open probe dispatch re-closes it.
  Transitions emit flushed ``breaker_open``/``breaker_close`` events
  and the per-model ``serve/breaker_state/<model>`` gauge (0 closed /
  1 half-open / 2 open).
- **Graceful drain** — ``stop(drain_timeout_s=)`` stops admission
  immediately (typed :class:`ShuttingDown` rejection), drains what is
  queued, and FAILS — never strands — any Future still unresolved at
  the timeout; ``/healthz`` carries a readiness field
  (``ready``/``draining``/``stopped``) distinct from liveness so a
  balancer can rotate the worker out.

Fault sites ``serve_admit`` and ``serve_dispatch`` (obs/faults.py)
gate the two hot paths; injected faults flow through exactly the same
shedding / breaker / rollback machinery as real ones.

There is no fallback: ``require_backend`` names the device type the
caller needs (``cuda``, its alias ``gpu``, or ``cpu``), and a server
whose devices are of another type raises ``LightGBMError`` (the JAX
package emits ``backend_fallback`` and serves on).
"""
from __future__ import annotations

import atexit
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..obs import events as obs_events
from ..obs import faults as obs_faults
from ..obs.registry import registry as obs
from ..utils import locktrace
from ..utils import log
from ..utils import next_pow2
from ..utils.log import LightGBMError
from .cache import BucketedPredictor
from .forest import StackedForest

#: seconds the interpreter's exit waits, in all, for the dispatch
#: workers of every server to return (each from one bucket's walk at most)
WORKER_EXIT_TIMEOUT_S = 120.0

#: every server whose workers were started in this process, weakly held
_SERVERS: "weakref.WeakSet[PredictServer]" = weakref.WeakSet()


@atexit.register
def _join_workers_at_exit() -> None:
    """Tell every server's workers to stop and wait for them (bounded):
    the workers are daemon threads, and one caught inside a CUDA call
    when the interpreter finalizes aborts the process. A worker that was
    in a dispatch when ``stop``'s drain timeout fired, or a server never
    stopped, ends here; what is still queued is dispatched first."""
    deadline = time.perf_counter() + WORKER_EXIT_TIMEOUT_S
    servers = list(_SERVERS)
    for srv in servers:
        with srv._cond:
            srv._stop = True
            srv._cond.notify_all()
    for srv in servers:
        for t in srv._threads:
            t.join(timeout=max(deadline - time.perf_counter(), 0.0))


# ----------------------------------------------------------------------
# typed serving-plane errors
# ----------------------------------------------------------------------

class ServeError(RuntimeError):
    """Base of the serving plane's typed failures: every shed, expired,
    rejected, or stranded request fails its Future with one of these —
    a client can always tell overload policy from a model bug."""


class Overloaded(ServeError):
    """Shed at admission: the bounded queue was full (``reject``) or
    stayed full for the bounded block wait (``block``)."""


class DeadlineExceeded(ServeError):
    """The request's ``deadline_ms`` budget expired — at admission, or
    while the request sat in the queue (checked again at dispatch pop)."""


class ShuttingDown(ServeError):
    """Submitted while the server was draining/stopped, or still
    unresolved when the drain timeout fired."""


class BreakerOpen(ServeError):
    """Failed fast because the circuit breaker is open; carries the
    breaker state so callers can back off intelligently."""

    def __init__(self, msg: str, state: str = "open",
                 consecutive_failures: int = 0,
                 last_error: str = ""):
        super().__init__(msg)
        self.state = state
        self.consecutive_failures = consecutive_failures
        self.last_error = last_error


def _fail_future(fut: Optional[Future], exc: BaseException) -> None:
    """Resolve a Future with an exception, tolerating races (client
    cancelled it, or the worker resolved it between our check and
    set): a Future must never be left pending, but the FIRST
    resolution wins."""
    if fut is None:
        return
    try:
        fut.set_exception(exc)
    except Exception:
        pass


# ----------------------------------------------------------------------
# circuit breaker
# ----------------------------------------------------------------------

class CircuitBreaker:
    """K consecutive dispatch failures open the breaker; while open,
    submits fail fast with the state attached. After ``cooldown_s`` ONE
    request is admitted as a half-open probe — its dispatch outcome
    re-closes or re-opens. Transitions emit flushed ``breaker_open`` /
    ``breaker_close`` events and the per-model
    ``serve/breaker_state/<model>`` gauge (0 closed / 1 half-open /
    2 open)."""

    CLOSED, HALF_OPEN, OPEN = 0, 1, 2
    _NAMES = {CLOSED: "closed", HALF_OPEN: "half_open", OPEN: "open"}

    def __init__(self, threshold: int = 5, cooldown_s: float = 2.0,
                 model: str = "default"):
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = max(float(cooldown_s), 0.0)
        self.model = model
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._last_error = ""
        # per-model gauge: two servers' breakers must not clobber one
        # shared gauge (the watchdog rule scans the whole family)
        self.gauge_name = "serve/breaker_state/" + model
        obs.gauge(self.gauge_name, self._state)
        locktrace.maybe_trace(self)

    @property
    def state(self) -> str:
        return self._NAMES[self._state]

    def admit(self):
        """(error, is_probe): error is None when the request may
        enter; is_probe marks the single half-open probe request."""
        with self._lock:
            if self._state == self.CLOSED:
                return None, False
            now = time.perf_counter()
            if self._state == self.OPEN \
                    and now - self._opened_at >= self.cooldown_s:
                self._state = self.HALF_OPEN
                obs.gauge(self.gauge_name, self._state)
            if self._state == self.HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return None, True
            obs.inc("serve/breaker_rejections")
            return BreakerOpen(
                "circuit breaker is %s after %d consecutive dispatch "
                "failures (last: %s)" % (self.state, self._consecutive,
                                         self._last_error or "n/a"),
                state=self.state,
                consecutive_failures=self._consecutive,
                last_error=self._last_error), False

    def abort_probe(self) -> None:
        """The admitted probe died before dispatch (deadline/cancel/
        drain): free the slot so the next submit can probe."""
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._probe_inflight = False

    def record_success(self) -> None:
        with self._lock:
            was = self._state
            self._consecutive = 0
            self._probe_inflight = False
            if was == self.CLOSED:
                return
            self._state = self.CLOSED
            obs.gauge(self.gauge_name, self._state)
        log.info("serve: circuit breaker closed (model %r)" % self.model)
        obs_events.emit("breaker_close", model=self.model,
                        from_state=self._NAMES[was])
        obs_events.flush()

    def record_failure(self, exc: BaseException) -> None:
        with self._lock:
            self._consecutive += 1
            self._last_error = repr(exc)
            opening = (self._state == self.HALF_OPEN
                       or (self._state == self.CLOSED
                           and self._consecutive >= self.threshold))
            if self._state == self.OPEN:
                # queued-before-open stragglers keep it hot
                self._opened_at = time.perf_counter()
            if not opening:
                return
            reopened = self._state == self.HALF_OPEN
            self._state = self.OPEN
            self._opened_at = time.perf_counter()
            self._probe_inflight = False
            n = self._consecutive
            obs.inc("serve/breaker_opens")
            obs.gauge(self.gauge_name, self._state)
        log.warning_always(
            "serve: circuit breaker %s (model %r) after %d consecutive "
            "dispatch failures: %r"
            % ("re-opened" if reopened else "opened", self.model, n, exc))
        obs_events.emit("breaker_open", model=self.model,
                        consecutive_failures=n, probe_failed=reopened,
                        error=repr(exc))
        obs_events.flush()  # breach evidence must survive what follows


# ----------------------------------------------------------------------
# model registry (stable versions + canary windows)
# ----------------------------------------------------------------------

class ModelRegistry:
    """Named, versioned StackedForests with hot swap and canary
    windows."""

    def __init__(self):
        self._lock = threading.Lock()
        self._models: Dict[str, tuple] = {}  # name -> (version, forest)
        self._canary: Dict[str, dict] = {}
        self._next_version: Dict[str, int] = {}
        locktrace.maybe_trace(self)

    def load(self, name: str = "default", booster=None,
             model_str: Optional[str] = None,
             model_file: Optional[str] = None, start_iteration: int = 0,
             num_iteration: int = -1, canary_batches: int = 0) -> int:
        """Pack and publish a model version; returns the version id.
        Sources (one of): a live Booster/GBDT, a v3 model text string,
        or a model file path. ``canary_batches`` routes through
        :meth:`publish`'s canary window."""
        if model_file is not None:
            with open(model_file) as f:
                model_str = f.read()
            source = "file"
        elif model_str is not None:
            source = "string"
        elif booster is not None:
            source = "booster"
        else:
            raise ValueError("load needs booster=, model_str= or "
                             "model_file=")
        if model_str is not None:
            from ..basic import Booster
            booster = Booster(model_str=model_str)
        forest = StackedForest.from_gbdt(booster, start_iteration,
                                         num_iteration)
        return self.publish(name, forest, source=source,
                            canary_batches=canary_batches)

    def publish(self, name: str, forest: StackedForest,
                source: str = "direct", canary_batches: int = 0) -> int:
        # fail-closed swap: an error here (including an injected one)
        # propagates to the publisher BEFORE any mutation, so the
        # previously published version keeps serving untouched
        obs_faults.check("registry_swap", name=name)
        with self._lock:
            version = self._next_version.get(name, 0) + 1
            self._next_version[name] = version
            if canary_batches > 0 and name in self._models:
                self._canary[name] = {
                    "version": version, "forest": forest,
                    "remaining": int(canary_batches),
                    "total": int(canary_batches), "source": source}
                prev_version = self._models[name][0]
            else:
                # direct publish (also a canary publish with nothing to
                # roll back to) supersedes any in-flight canary
                self._models[name] = (version, forest)
                self._canary.pop(name, None)
                prev_version = None
                obs.gauge("serve/models", len(self._models))
        if prev_version is not None:
            log.info("serve: canary model %r v%d staged (%d batches, "
                     "v%d stays resident)"
                     % (name, version, canary_batches, prev_version))
            obs_events.emit("model_canary", name=name, version=version,
                            canary_batches=int(canary_batches),
                            prev_version=prev_version,
                            num_trees=forest.num_trees, source=source)
            obs_events.flush()
            return version
        log.info("serve: published model %r v%d (%d trees, %d features)"
                 % (name, version, forest.num_trees, forest.num_features))
        obs_events.emit("model_swap", name=name, version=version,
                        num_trees=forest.num_trees,
                        num_features=forest.num_features,
                        num_classes=forest.num_classes, source=source)
        obs_events.flush()
        return version

    def get(self, name: str = "default"):
        """(version, forest) of the current STABLE published version
        (a canary under evaluation is not yet "published")."""
        with self._lock:
            if name not in self._models:
                raise KeyError("no model published under %r" % name)
            return self._models[name]

    def route(self, name: str = "default", canary_ok: bool = True):
        """(version, forest, is_canary) the next dispatch should use:
        the canary while its window is open, else the stable version.
        ``canary_ok=False`` always routes stable — a multi-replica
        server PINS the canary to one replica (replica 0), so the
        window's dispatch outcomes stay sequential and rollback
        semantics are identical to the single-replica server."""
        with self._lock:
            c = self._canary.get(name)
            if c is not None and canary_ok:
                return c["version"], c["forest"], True
            if name not in self._models:
                raise KeyError("no model published under %r" % name)
            version, forest = self._models[name]
            return version, forest, False

    def canary_active(self, name: str = "default") -> bool:
        with self._lock:
            return name in self._canary

    def canary_result(self, name: str, version: int, ok: bool,
                      reason: str = "") -> str:
        """Record one canary dispatch outcome. Returns ``"rolled_back"``
        (failure — the canary is gone, the stable version keeps
        serving), ``"promoted"`` (clean window completed),
        ``"canary"`` (window continues), or ``"stale"`` (no canary /
        different version — e.g. a racing publish superseded it)."""
        with self._lock:
            c = self._canary.get(name)
            if c is None or c["version"] != version:
                return "stale"
            if ok:
                c["remaining"] -= 1
                if c["remaining"] > 0:
                    return "canary"
                # promote — registry_swap is the fault site here too;
                # a failure (injected or real) fails CLOSED into the
                # rollback path, the old version keeps serving
                try:
                    # the promote fault probe stays atomic with the
                    # promote decision (fail-closed rollback)
                    obs_faults.check("registry_swap", name=name,
                                     phase="promote")
                except OSError as e:
                    ok = False
                    reason = "promote failed: %r" % (e,)
            if not ok:
                del self._canary[name]
                stable_version = self._models[name][0]
                completed = c["total"] - c["remaining"]
            else:
                del self._canary[name]
                self._models[name] = (version, c["forest"])
                obs.gauge("serve/models", len(self._models))
        if not ok:
            obs.inc("serve/rollbacks")
            log.warning_always(
                "serve: canary model %r v%d ROLLED BACK after %d/%d "
                "batches (v%d keeps serving): %s"
                % (name, version, completed, c["total"], stable_version,
                   reason or "dispatch failure"))
            obs_events.emit("model_rollback", name=name, version=version,
                            rolled_back_to=stable_version,
                            completed_batches=completed,
                            canary_batches=c["total"],
                            reason=reason or "dispatch failure")
            obs_events.flush()  # rollback evidence must survive a crash
            return "rolled_back"
        obs.inc("serve/canary_promotions")
        forest = c["forest"]
        log.info("serve: canary model %r v%d promoted after %d clean "
                 "batches" % (name, version, c["total"]))
        obs_events.emit("model_swap", name=name, version=version,
                        num_trees=forest.num_trees,
                        num_features=forest.num_features,
                        num_classes=forest.num_classes,
                        source=c["source"], canary=True)
        obs_events.flush()
        return "promoted"

    def names(self):
        with self._lock:
            return sorted(self._models)


# ----------------------------------------------------------------------
# requests
# ----------------------------------------------------------------------

class _Assembly:
    """Reassembles a split oversized request into one parent Future:
    chunks complete independently (possibly across dispatches); the
    parent resolves when the last part lands, or fails once with the
    first chunk error."""

    def __init__(self, future: Future, n_parts: int):
        self.future = future
        self.n_parts = n_parts
        self.parts: Dict[int, np.ndarray] = {}
        self.lock = threading.Lock()
        self.dead = False       # parent cancelled / already failed
        self._started = False

    def claim(self) -> bool:
        """First chunk claims the parent Future (a client-cancelled
        parent drops every chunk); later chunks just check liveness."""
        with self.lock:
            if self.dead:
                return False
            if not self._started:
                self._started = True
                if not self.future.set_running_or_notify_cancel():
                    self.dead = True
                    return False
            return True

    def fail(self, exc: BaseException) -> None:
        with self.lock:
            if self.dead:
                return
            self.dead = True
        _fail_future(self.future, exc)

    def complete(self, offset: int, part: np.ndarray) -> None:
        with self.lock:
            if self.dead:
                return
            self.parts[offset] = part
            if len(self.parts) < self.n_parts:
                return
            self.dead = True
            parts = [self.parts[k] for k in sorted(self.parts)]
        try:
            self.future.set_result(np.concatenate(parts, axis=0))
        except Exception:
            pass  # raced with a drain-timeout failure


class _Request:
    __slots__ = ("x", "rows", "single", "future", "t_submit", "deadline",
                 "assembly", "offset", "probe")

    def __init__(self, x: np.ndarray, single: bool,
                 future: Optional[Future] = None,
                 deadline: Optional[float] = None):
        self.x = x
        self.rows = x.shape[0]
        self.single = single
        self.future = future
        self.t_submit = time.perf_counter()
        self.deadline = deadline
        self.assembly: Optional[_Assembly] = None
        self.offset = 0
        self.probe = False


class PredictServer:
    """Thread-safe micro-batching front end over a ModelRegistry entry.

    ``submit`` enqueues and returns a Future; the worker coalesces up to
    ``max_batch`` rows (waiting at most ``max_wait_ms`` after the first
    pending request) into one bucketed dispatch. Start with
    ``autostart=False`` to enqueue before serving (deterministic
    batching — what the coalescing test uses). Overload policy: see the
    module docstring (``max_queue_rows`` / ``overflow`` /
    ``deadline_ms`` / circuit breaker / drain)."""

    def __init__(self, model, name: str = "default", max_batch: int = 256,
                 max_wait_ms: float = 2.0, output_kind: str = "value",
                 min_bucket: int = 16, require_backend: Optional[str] = None,
                 autostart: bool = True,
                 metrics_port: Optional[int] = None,
                 metrics_host: str = "127.0.0.1",
                 metrics_gateway: Optional[str] = None,
                 max_queue_rows: Optional[int] = None,
                 overflow: str = "reject",
                 block_timeout_ms: float = 1000.0,
                 default_deadline_ms: Optional[float] = None,
                 breaker_threshold: int = 5,
                 breaker_cooldown_ms: float = 2000.0,
                 replicas=None, quality=None,
                 devices: Optional[Sequence] = None):
        if isinstance(model, ModelRegistry):
            self.registry = model
        else:
            self.registry = ModelRegistry()
            if isinstance(model, StackedForest):
                self.registry.publish(name, model)
            else:  # Booster / GBDT
                self.registry.load(name, booster=model)
        if overflow not in ("reject", "block"):
            raise ValueError("overflow must be 'reject' or 'block'")
        self.name = name
        self.max_batch = max(int(max_batch), 1)
        self.max_wait = max(float(max_wait_ms), 0.0) / 1e3
        self.max_queue_rows = (None if not max_queue_rows
                               else max(int(max_queue_rows), 1))
        self.overflow = overflow
        self.block_timeout = max(float(block_timeout_ms), 0.0) / 1e3
        self.default_deadline_ms = default_deadline_ms
        self.breaker = CircuitBreaker(breaker_threshold,
                                      breaker_cooldown_ms / 1e3,
                                      model=name)
        version, forest = self.registry.get(name)
        # --- replica fleet: one forest placement + one dispatch worker
        # per device; admission (queue/shedding/deadlines), the breaker,
        # and canary accounting stay GLOBAL so overload and rollback
        # semantics are unchanged — only dispatch capacity scales
        explicit = bool(devices)
        devices = _resolve_devices(model, devices)
        if replicas is None:
            # one replica per device the caller listed, else one
            replicas = len(devices) if explicit else 1
        elif replicas in ("auto", 0):
            replicas = len(devices)
        self.replicas = max(int(replicas), 1)
        self._devices = [devices[k % len(devices)]
                         for k in range(self.replicas)]
        if require_backend is not None:
            want = "cuda" if require_backend == "gpu" else require_backend
            actual = self._devices[0].type
            if actual != want:
                raise LightGBMError(
                    "serve: %s backend asked for, but the server's devices "
                    "are %s (no fallback)" % (require_backend, actual))
        mb = max(next_pow2(self.max_batch), min_bucket)
        shared_entries: Dict = {}
        shared_entries_lock = threading.Lock()
        placed = [forest.place(d) for d in self._devices]
        # data-quality monitor (obs/quality.py): ONE monitor shared by
        # every replica's predictor — its device window state is keyed
        # by device under its own lock, the same sharing contract as
        # `shared_entries`; drained on the exporter tick, not per batch
        self.quality = quality
        if self.quality is not None:
            from ..obs import quality as obs_quality
            obs_quality.register_monitor(self.quality)
        self.predictors = [BucketedPredictor(
            placed[k], model_version=version, min_bucket=min_bucket,
            max_bucket=mb, output_kind=output_kind,
            entries=shared_entries, entries_lock=shared_entries_lock,
            quality=quality, pinned=True)
            for k in range(self.replicas)]
        self.predictor = self.predictors[0]
        obs.gauge("serve/replicas", self.replicas)
        self._queue: deque = deque()
        self._pending_rows = 0
        self._cond = threading.Condition()
        self._stop = False
        self._stopped = False
        self._inflight: Dict[int, List[_Request]] = {}
        self._thread: Optional[threading.Thread] = None
        self._threads: List[threading.Thread] = []
        self.stats = {"dispatches": 0, "requests": 0, "rows": 0,
                      "shed": 0, "expired": 0}
        self._next_watch = 0.0
        # pull-based telemetry: metrics_port != None mounts an HTTP
        # listener serving GET /metrics (OpenMetrics text incl. the
        # serve/latency_ms quantiles + serve/queue_depth gauge) and
        # /healthz (JSON snapshot + breached watchdog rules + this
        # server's readiness, distinct from liveness). port 0 binds an
        # ephemeral port — read it from .metrics.port / .metrics.url
        self.metrics = None
        self.watchdog = None
        if metrics_port is not None:
            from ..obs.export import MetricsHTTPServer
            from ..obs.health import Watchdog
            self.watchdog = Watchdog()
            self.metrics = MetricsHTTPServer(metrics_port, metrics_host,
                                             watchdog=self.watchdog,
                                             readiness=lambda:
                                             self.readiness)
            log.info("serve: /metrics listening on %s" % self.metrics.url)
        # push-based fleet telemetry: metrics_gateway != None starts a
        # SnapshotPusher POSTing this process's registry to an
        # obs/gateway.py MetricsGateway, so a serving fleet appears in
        # the same aggregated {rank=,process=} scrape as its trainer
        # ranks. Falls back to LIGHTGBM_TPU_METRICS_GATEWAY via
        # export.tick() like everything else env-driven.
        self.pusher = None
        if metrics_gateway is not None:
            from ..obs.gateway import SnapshotPusher
            self.pusher = SnapshotPusher(metrics_gateway,
                                         role="serve").start()
        # LOCKTRACE hook: must precede start() — the proxies have to be
        # in place before the first dispatch thread touches _cond
        locktrace.maybe_trace(self)
        if autostart:
            self.start()

    # ------------------------------------------------------------------
    @property
    def readiness(self) -> str:
        """``ready`` (admitting), ``draining`` (admission closed, queue
        flushing) or ``stopped`` — the /healthz readiness field. The
        HTTP listener answering at all is liveness."""
        if self._stopped:
            return "stopped"
        if self._stop:
            return "draining"
        return "ready"

    def start(self) -> "PredictServer":
        """Start (or repair) the dispatch worker fleet: every replica
        whose worker is missing or dead gets a fresh thread — a fleet
        with ONE dead worker must be healable, not only a fully-dead
        one (the single-worker server restarted its only thread; N>1
        keeps that property per replica)."""
        if self._stopped or not self._threads \
                or not all(t.is_alive() for t in self._threads):
            self._stop = False
            self._stopped = False
            threads = list(self._threads) + \
                [None] * (self.replicas - len(self._threads))
            for k in range(self.replicas):
                if threads[k] is not None and threads[k].is_alive():
                    continue
                name = ("lightgbm-torch-serve" if k == 0
                        else "lightgbm-torch-serve-%d" % k)
                t = threading.Thread(target=self._run, args=(k,),
                                     name=name, daemon=True)
                t.start()
                threads[k] = t
            self._threads = threads
            self._thread = self._threads[0]
            _SERVERS.add(self)
        return self

    def stop(self, drain_timeout_s: float = 30.0) -> None:
        """Stop admission immediately (new submits fail with
        :class:`ShuttingDown`), drain what is already queued, and FAIL
        any Future still unresolved when ``drain_timeout_s`` expires —
        a stopped server never strands a caller. A worker still inside
        a dispatch at the timeout finishes it after ``stop`` returns
        (its results are dropped); the interpreter's exit waits for it
        (:func:`_join_workers_at_exit`). Closes the /metrics listener
        last so the final drained state is still scrapable during
        shutdown."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        limit = time.perf_counter() + max(float(drain_timeout_s), 0.0)
        for t in self._threads:
            if t.is_alive():
                t.join(timeout=max(limit - time.perf_counter(), 0.0))
        stranded: List[_Request] = []
        seen_asm = set()

        def _strand(r: _Request) -> None:
            # a stranded half-open probe must free its slot, or the
            # breaker is wedged half-open forever after a restart
            if r.probe:
                self.breaker.abort_probe()
            if r.assembly is not None:
                # count CALLER requests, not split chunks: one
                # oversized request strands exactly one Future
                if r.assembly.dead or id(r.assembly) in seen_asm:
                    return
                seen_asm.add(id(r.assembly))
            stranded.append(r)

        with self._cond:
            while self._queue:
                _strand(self._queue.popleft())
            self._pending_rows = 0
            for batch in self._inflight.values():
                for r in batch:
                    _strand(r)
            self._inflight = {}
            obs.gauge("serve/queue_depth", 0)
            self._stopped = True
        if stranded:
            obs.inc("serve/drain_failed", len(stranded))
            exc = ShuttingDown(
                "PredictServer stopped; the request was still "
                "unresolved at the %.1fs drain timeout"
                % float(drain_timeout_s))
            self._fail_batch(stranded, exc)
            obs_events.emit("serve_drain_timeout", model=self.name,
                            unresolved=len(stranded),
                            drain_timeout_s=float(drain_timeout_s))
            obs_events.flush()
        if self.quality is not None:
            from ..obs import quality as obs_quality
            obs_quality.unregister_monitor(self.quality)
        if self.pusher is not None:
            # one final push so the gateway sees the drained terminal
            # counters, then stop the loop
            self.pusher.push_now()
            self.pusher.stop()
        if self.metrics is not None:
            self.metrics.close()

    # ------------------------------------------------------------------
    def submit(self, x, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request (a [F] row or an [m, F] block); returns a
        Future resolving to the prediction for exactly those rows. The
        Future NEVER hangs: overload, deadline, breaker, and shutdown
        all resolve it with a typed :class:`ServeError`. Malformed
        requests still raise here — a shape bug is a caller bug, not
        an overload condition."""
        x = np.asarray(x)
        # f64 requests that actually EXCEED f32 precision keep their
        # dtype: the predictor serves them exactly through the
        # double-double device path. f32-exact f64 blocks downcast here
        # losslessly (so they coalesce with f32 traffic instead of
        # dragging a whole batch onto the slower dd program); everything
        # else is the f32 serving contract
        from .forest import f32_exact
        if x.dtype == np.float64 and not f32_exact(x):
            x = x.astype(np.float64, copy=False)
        else:
            x = x.astype(np.float32)
        single = x.ndim == 1
        if x.ndim not in (1, 2):
            raise ValueError("submit takes a [F] row or an [m, F] block")
        # validate now, not at dispatch: a malformed request must fail
        # ITSELF, never the batch it would have coalesced with
        n_feat = self.registry.get(self.name)[1].num_features
        if x.shape[-1] != n_feat:
            raise ValueError("request has %d features, model %r expects "
                             "%d" % (x.shape[-1], self.name, n_feat))
        x = x.reshape(1, -1) if single else x
        rows = x.shape[0]
        future: Future = Future()
        obs.inc("serve/requests")
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        deadline = None
        if deadline_ms is not None:
            deadline_ms = float(deadline_ms)
            if deadline_ms <= 0:
                # admission-time check: an already-expired budget never
                # touches the queue
                obs.inc("serve/deadline_expired")
                with self._cond:  # stats writes race across submitters
                    self.stats["expired"] += 1
                _fail_future(future, DeadlineExceeded(
                    "deadline_ms=%g expired at admission" % deadline_ms))
                return future
            deadline = time.perf_counter() + deadline_ms / 1e3
        try:
            obs_faults.check("serve_admit", model=self.name)
        except obs_faults.InjectedFault as e:
            _fail_future(future, e)
            return future
        shed_reason = None
        with self._cond:
            if self._stop:
                _fail_future(future, ShuttingDown(
                    "PredictServer is %s" % self.readiness))
                return future
            if self.max_queue_rows is not None:
                if rows > self.max_queue_rows:
                    shed_reason = "larger_than_queue"
                else:
                    if self._pending_rows + rows > self.max_queue_rows \
                            and self.overflow == "block":
                        # bounded backpressure: wait for space — but
                        # never past the request's OWN deadline (a
                        # caller with a 10 ms budget must not block
                        # the full block_timeout only to age out in
                        # the queue anyway)
                        limit = time.perf_counter() + self.block_timeout
                        if deadline is not None:
                            limit = min(limit, deadline)
                        while (self._pending_rows + rows
                               > self.max_queue_rows and not self._stop):
                            remaining = limit - time.perf_counter()
                            if remaining <= 0:
                                break
                            self._cond.wait(timeout=remaining)
                        if self._stop:
                            _fail_future(future, ShuttingDown(
                                "PredictServer began draining while "
                                "this request waited for queue space"))
                            return future
                    if self._pending_rows + rows > self.max_queue_rows:
                        if deadline is not None \
                                and time.perf_counter() >= deadline:
                            # the budget, not the queue, is what gave
                            # out: fail with the honest error
                            obs.inc("serve/deadline_expired")
                            self.stats["expired"] += 1
                            _fail_future(future, DeadlineExceeded(
                                "deadline_ms budget expired while "
                                "waiting for queue space"))
                            return future
                        shed_reason = ("queue_full"
                                       if self.overflow == "reject"
                                       else "block_timeout")
            if shed_reason is not None:
                queue_rows = self._pending_rows
            else:
                err, probe = self.breaker.admit()
                if err is not None:
                    _fail_future(future, err)
                    return future
                reqs: List[_Request] = []
                if rows > self.max_batch:
                    # oversized request: split into <= max_batch chunks
                    # that dispatch independently; the parent Future
                    # reassembles
                    offsets = list(range(0, rows, self.max_batch))
                    asm = _Assembly(future, len(offsets))
                    for lo in offsets:
                        r = _Request(x[lo:lo + self.max_batch], False,
                                     deadline=deadline)
                        r.assembly, r.offset = asm, lo
                        reqs.append(r)
                else:
                    reqs.append(_Request(x, single, future=future,
                                         deadline=deadline))
                reqs[0].probe = probe
                self._queue.extend(reqs)
                self._pending_rows += rows
                obs.gauge("serve/queue_depth", self._pending_rows)
                # notify_all: workers and backpressured submitters share
                # this condition — a single notify could wake a blocked
                # submitter while every dispatch worker keeps sleeping
                self._cond.notify_all()
        if shed_reason is not None:
            # shed accounting OUTSIDE the lock: the flushed event does
            # file I/O, and overload is exactly when the worker and
            # every other submitter must not serialize behind it
            return self._shed(future, rows, shed_reason, queue_rows)
        return future

    def predict(self, x, timeout: Optional[float] = None,
                deadline_ms: Optional[float] = None):
        """Synchronous convenience wrapper around ``submit``."""
        return self.submit(x, deadline_ms=deadline_ms).result(
            timeout=timeout)

    def warm(self, x) -> None:
        """Dispatch ``x`` through EVERY replica's predictor directly
        (bypassing the queue), so a fresh fleet's first requests pay no
        one-time costs of a bucket (the caching allocator's first
        blocks, the library handles of a new device). Pass a true-f64
        block to warm the double-double path's buckets too (the dtype
        is preserved, same as ``submit``)."""
        x = np.asarray(x)
        x = x.astype(np.float64 if x.dtype == np.float64 else np.float32,
                     copy=False)
        if x.ndim == 1:
            x = x.reshape(1, -1)
        for p in self.predictors:
            p.predict(x)

    def _shed(self, future: Future, rows: int, reason: str,
              queue_rows: int) -> Future:
        """Fail a request at admission (lock already released): typed
        error + counter + flushed ``request_shed`` event, so every shed
        is accounted for even if the process dies right after."""
        obs.inc("serve/shed_total")
        with self._cond:  # concurrent shedders: += is read-modify-write
            self.stats["shed"] += 1
        obs_events.emit("request_shed", model=self.name, rows=rows,
                        reason=reason, queue_rows=queue_rows,
                        max_queue_rows=self.max_queue_rows)
        obs_events.flush()
        _fail_future(future, Overloaded(
            "request shed (%s): queue holds %d of max %d rows"
            % (reason, queue_rows, self.max_queue_rows)))
        return future

    # ------------------------------------------------------------------
    def _take_batch(self):
        """Collect up to max_batch rows, waiting up to max_wait after
        the first pending request. Requests whose deadline aged out in
        the queue fail fast HERE (the second deadline check) instead of
        occupying dispatch capacity. Returns [] only at shutdown or
        when every popped request had expired/died."""
        with self._cond:
            while not self._queue:
                if self._stop:
                    return []
                # no timeout: submit() and stop() both notify, so an
                # idle server sleeps instead of polling
                self._cond.wait()
            wait_deadline = time.perf_counter() + self.max_wait
            batch: List[_Request] = []
            rows = 0
            while True:
                while self._queue and rows < self.max_batch:
                    nxt = self._queue[0]
                    if batch and rows + nxt.rows > self.max_batch:
                        break  # next request overflows: next dispatch
                    if batch and nxt.x.dtype != batch[0].x.dtype:
                        # keep batches dtype-homogeneous: one true-f64
                        # request must not drag coalesced f32 traffic
                        # onto the chunked dd program (the f64 rows
                        # dispatch in the NEXT batch)
                        break
                    self._queue.popleft()
                    self._pending_rows -= nxt.rows
                    if nxt.assembly is not None and nxt.assembly.dead:
                        continue  # a sibling chunk already failed it
                    if nxt.deadline is not None \
                            and time.perf_counter() > nxt.deadline:
                        self._expire_locked(nxt)
                        continue
                    batch.append(nxt)
                    rows += nxt.rows
                if rows >= self.max_batch or self._stop:
                    break
                remaining = wait_deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            obs.gauge("serve/queue_depth", self._pending_rows)
            # freed queue space: wake submitters blocked on backpressure
            self._cond.notify_all()
            return batch

    def _expire_locked(self, req: _Request) -> None:
        obs.inc("serve/deadline_expired")
        self.stats["expired"] += 1
        if req.probe:
            self.breaker.abort_probe()
        exc = DeadlineExceeded(
            "request aged out in the queue (%.1f ms past its deadline)"
            % ((time.perf_counter() - req.deadline) * 1e3))
        if req.assembly is not None:
            req.assembly.fail(exc)
        else:
            _fail_future(req.future, exc)

    def _run(self, replica: int = 0) -> None:
        device = self._devices[replica]
        if device.type != "cuda":
            self._serve(replica)
            return
        # one CUDA stream per worker: two replicas on one card overlap
        with torch.cuda.device(device), \
                torch.cuda.stream(torch.cuda.Stream(device)):
            self._serve(replica)

    def _serve(self, replica: int) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                if self._stop and not self._queue:
                    return
                continue
            self._dispatch(batch, replica)

    def _fail_batch(self, batch: List[_Request],
                    exc: BaseException) -> None:
        for r in batch:
            if r.assembly is not None:
                r.assembly.fail(exc)
            else:
                _fail_future(r.future, exc)

    def _predict_guarded(self, X: np.ndarray, version, canary: bool,
                         predictor: BucketedPredictor):
        """One faultable dispatch. During a canary window the output is
        additionally screened for non-finite values — a numerically
        poisoned model must not survive its canary."""
        obs_faults.check("serve_dispatch", model=self.name,
                         version=version)
        with obs.scope("serve::predict_batch"):
            y = predictor.predict(X)
        if canary and not np.all(np.isfinite(y)):
            raise FloatingPointError(
                "canary v%s produced non-finite predictions" % version)
        return y

    def _dispatch(self, batch, replica: int = 0) -> None:
        # claim every future first: a client-cancelled Future must drop
        # out here — set_result on it would raise InvalidStateError and
        # kill the worker (then every later submit hangs forever)
        live = []
        for r in batch:
            claimed = (r.assembly.claim() if r.assembly is not None
                       else r.future.set_running_or_notify_cancel())
            if claimed:
                live.append(r)
            elif r.probe:
                self.breaker.abort_probe()
        batch = live
        if not batch:
            return
        with self._cond:
            self._inflight[replica] = batch
        try:
            self._dispatch_claimed(batch, replica)
        except Exception as e:  # noqa: BLE001 — NOTHING in a dispatch
            # may kill the worker (every later submit would hang):
            # failures outside the guarded predict (routing, swap,
            # concatenation, result distribution) still fail the
            # BATCH, typed, and feed the breaker
            self.breaker.record_failure(e)
            self._fail_batch(batch, e)
        finally:
            with self._cond:
                self._inflight.pop(replica, None)

    def _swap_placed(self, predictor: BucketedPredictor, forest,
                     version, replica: int) -> None:
        """Swap a replica's predictor to a new version, placing the
        forest's arrays on the replica's own device (placements are
        cached per device on the forest, so N replicas sharing a device
        — or re-swapping — pay the transfer once). The shared entries
        dict keeps every version still live on a sibling replica — a
        pinned canary leaves replica 0 on a different version than the
        rest for the whole window, and its swap must not evict their
        hot keys."""
        forest = forest.place(self._devices[replica])
        predictor.swap(forest, version,
                       keep_versions=[p.model_version
                                      for p in self.predictors])

    def _dispatch_claimed(self, batch, replica: int = 0) -> None:
        rows = sum(r.rows for r in batch)
        predictor = self.predictors[replica]
        # hot swap / canary routing: pick up the latest published
        # (or canary) version between dispatches, never mid-batch.
        # Canary routing is PINNED to replica 0 — the other replicas
        # keep serving the stable version during the window, so canary
        # outcome accounting stays sequential (single-replica
        # semantics) while the fleet keeps its capacity
        version, forest, canary = self.registry.route(
            self.name, canary_ok=replica == 0)
        if version != predictor.model_version:
            self._swap_placed(predictor, forest, version, replica)
        X = (batch[0].x if len(batch) == 1
             else np.concatenate([r.x for r in batch], axis=0))
        t0 = time.perf_counter()
        try:
            y = self._predict_guarded(X, version, canary, predictor)
        except Exception as e:  # noqa: BLE001 — a bad batch must
            #                     not kill the worker
            rolled = False
            if canary:
                rolled = self.registry.canary_result(
                    self.name, version, ok=False,
                    reason=repr(e)) == "rolled_back"
            if not rolled:
                self.breaker.record_failure(e)
                self._fail_batch(batch, e)
                return
            # the canary rolled back and the stable version kept
            # serving: replay this batch on it — admitted requests
            # must not pay for a poisoned canary
            version, forest, _ = self.registry.route(self.name)
            self._swap_placed(predictor, forest, version, replica)
            canary = False
            try:
                y = self._predict_guarded(X, version, False, predictor)
            except Exception as e2:  # noqa: BLE001
                self.breaker.record_failure(e2)
                self._fail_batch(batch, e2)
                return
        dt = time.perf_counter() - t0
        self.breaker.record_success()
        if self.quality is not None:
            # prediction-score drift: the scores are already host-side
            # on their way back to the callers — one np.histogram here,
            # drained with the feature window at the exporter tick
            self.quality.observe_scores(y)
        if canary:
            self.registry.canary_result(self.name, version, ok=True)
        now = time.perf_counter()
        lo = 0
        # per-replica AND per-model series (two servers in one process
        # must not clobber each other's series, as with the breaker gauge);
        # obs/export.py folds the suffix into {replica=,model=} labels
        suffix = "/replica/%d/model/%s" % (replica, self.name)
        rep_hist = "serve/latency_ms" + suffix
        for r in batch:
            part = y[lo:lo + r.rows]
            lo += r.rows
            obs.observe("serve/latency_ms",
                        (now - r.t_submit) * 1e3)
            obs.observe(rep_hist, (now - r.t_submit) * 1e3)
            if r.assembly is not None:
                r.assembly.complete(r.offset, part)
            else:
                try:
                    r.future.set_result(part[0] if r.single else part)
                except Exception:
                    pass  # stop()'s drain-timeout failure raced us
        obs.inc("serve/dispatches" + suffix)
        obs.inc("serve/rows" + suffix, rows)
        with self._cond:  # N workers: stats += is read-modify-write
            self.stats["dispatches"] += 1
            # caller requests, not split chunks: chunk 0 stands for its
            # whole oversized request (matches the serve/requests
            # counter)
            self.stats["requests"] += sum(
                1 for r in batch if r.assembly is None or r.offset == 0)
            self.stats["rows"] += rows
        if self.watchdog is not None and now >= self._next_watch:
            # SLO rules over the live registry at most ~1 Hz (a full
            # snapshot per dispatch would cost more than the dispatch)
            self._next_watch = now + 1.0
            self.watchdog.evaluate()
        obs_events.emit(
            "predict_batch", model=self.name,
            version=predictor.model_version, replica=replica,
            n_requests=len(batch), rows=rows,
            bucket=predictor.bucket_for(
                min(rows, self.max_batch)),
            seconds=round(dt, 6))

    # ------------------------------------------------------------------
    def latency_percentiles(self) -> Dict[str, float]:
        return {"p50": obs.percentile("serve/latency_ms", 50.0),
                "p99": obs.percentile("serve/latency_ms", 99.0)}

    def replica_stats(self) -> Dict[int, Dict[str, float]]:
        """Per-replica dispatch/row counters + latency percentiles, the
        merge the serve summary and ``bench.py serve`` report (each
        replica also exports its own
        ``serve/latency_ms{replica=,model=}`` series through
        obs/export.py). The series are keyed by THIS server's model
        name, so two servers in one process read their own numbers."""
        out: Dict[int, Dict[str, float]] = {}
        for k in range(self.replicas):
            suffix = "/replica/%d/model/%s" % (k, self.name)
            h = "serve/latency_ms" + suffix
            out[k] = {
                "dispatches": obs.count("serve/dispatches" + suffix),
                "rows": obs.count("serve/rows" + suffix),
                "p50_ms": obs.percentile(h, 50.0),
                "p99_ms": obs.percentile(h, 99.0),
            }
        return out


def _model_device(model) -> Optional[torch.device]:
    """The device a model asks for: a forest's placement on a card (an
    unplaced forest, on the CPU, asks for none), a Booster's (its
    params' device_type), a GBDT's training device (None when loaded
    from text)."""
    if isinstance(model, StackedForest):
        return model.device if model.device.type != "cpu" else None
    resolve = getattr(model, "_device", None)
    if callable(resolve):
        return resolve()
    return getattr(model, "device", None)


def _resolve_devices(model, devices) -> List[torch.device]:
    """The replica devices: ``devices`` when given; else the model's
    own device when it is the CPU, or every visible card. Asking for the
    card where none is visible raises."""
    if devices:
        return [torch.device(d) for d in devices]
    base = (None if isinstance(model, ModelRegistry)
            else _model_device(model))
    if base is not None and base.type == "cpu":
        return [base]
    if not torch.cuda.is_available():
        raise LightGBMError("serve: the card was asked for but no CUDA "
                            "device is visible; pass devices=['cpu'] to "
                            "serve on the CPU")
    return [torch.device("cuda", k)
            for k in range(torch.cuda.device_count())]
