"""Metrics registry: counters, gauges, stage timers.

Port of ``lightgbm_tpu/obs/registry.py`` (reference:
``Common::Timer``/``FunctionTimer``, include/LightGBM/utils/common.h:973,
1037 — RAII scopes around every pipeline stage, aggregated table printed
at exit when built with USE_TIMETAG). On the card, enabled scopes also
open NVTX ranges (``torch.cuda.nvtx.range_push``/``range_pop``), so the
same stage names show in an Nsight Systems timeline; a CPU run opens
none. ``torch`` is looked up in ``sys.modules`` only: this module stays
importable without it.

Timing modes (``LIGHTGBM_TPU_TIMETAG``):

- ``1``      — fencing mode: :meth:`MetricsRegistry.watch_ready`
  synchronizes the stream that produced the stage's output, so the
  card's queue cannot smear one stage into the next. Exact per-stage
  device attribution, but it SERIALIZES the host and the card — the
  measured hot path is perturbed.
- ``sample`` — non-perturbing mode: scopes record host wall time
  synchronously; ``watch_ready`` records a ``torch.cuda.Event`` on the
  current stream and hands it to a drainer thread, which polls it
  (``Event.query``, never a blocking wait) and records the remaining
  device time under ``<stage>::ready``. The training thread never reads
  a tensor, never synchronizes and never waits on the event.

The span-trace layer (``obs/trace.py``) installs hooks here so every
scope doubles as a renderable Perfetto span without touching callers.
"""
from __future__ import annotations

import atexit
import os
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

from ..utils import log

# torch.cuda.nvtx, resolved once: None = unresolved, False = unavailable
_nvtx_mod = None
# the drainer's poll interval while a watched event is not done (s)
kReadyPoll = 0.0002

# histogram reservoir bound: old samples age out past this many
kHistCap = 4096

# Trace-layer hooks, installed by obs/trace.py (registry stays importable
# standalone; the hook object must expose active()/begin(name)/end(token),
# ready_span(name, t0_perf, t1_perf, queued_s, for_span) and
# current_span() — the span id open on the calling thread, the token
# that lets the readiness drainer land device time on the exact
# emitting span).
_trace_hooks = None

# Reset hooks: callables run on MetricsRegistry.reset() so module-global
# state elsewhere (obs/compile.py's retrace-warning dedup) follows the
# registry's lifecycle instead of living forever.
_reset_hooks: List[Callable[[], None]] = []


def add_reset_hook(fn: Callable[[], None]) -> None:
    _reset_hooks.append(fn)


def install_trace_hooks(hooks) -> None:
    global _trace_hooks
    _trace_hooks = hooks


def _tracing() -> bool:
    h = _trace_hooks
    return h is not None and h.active()


def _parse_timetag(value: Optional[str]) -> Tuple[bool, bool]:
    """``LIGHTGBM_TPU_TIMETAG`` → (enabled, sampling)."""
    v = (value or "0").strip().lower()
    if v == "sample":
        return True, True
    if v in ("", "0", "false", "off", "no"):
        return False, False
    try:
        return bool(int(v)), False
    except ValueError:
        # any other non-empty value: timing on, classic fencing mode
        return True, False


def _torch():
    """``torch`` when the process has imported it, else None (the
    registry never imports it itself)."""
    return sys.modules.get("torch")


def _get_nvtx():
    """``torch.cuda.nvtx`` while the process runs on the card (CUDA
    initialized), else None: a CPU run opens no range."""
    global _nvtx_mod
    torch = _torch()
    if torch is None or not torch.cuda.is_initialized():
        return None
    if _nvtx_mod is None:
        try:
            from torch.cuda import nvtx as _n
            _nvtx_mod = _n
        except Exception:
            _nvtx_mod = False
    return _nvtx_mod if _nvtx_mod is not False else None


def _cuda_tensor(value):
    """The first CUDA tensor in ``value`` (a tensor, or a tuple / list
    of them), else None."""
    torch = _torch()
    if torch is None:
        return None
    if isinstance(value, (tuple, list)):
        for v in value:
            t = _cuda_tensor(v)
            if t is not None:
                return t
        return None
    if isinstance(value, torch.Tensor) and value.is_cuda:
        return value
    return None


def _sync_producer(value) -> None:
    """Fencing mode: wait for the stream that produced ``value`` (the
    current stream of its device; a CPU value is ready already)."""
    t = _cuda_tensor(value)
    if t is not None:
        _torch().cuda.current_stream(t.device).synchronize()


def _record_ready(value):
    """Sample mode: a ``torch.cuda.Event`` recorded on the current
    stream of ``value``'s device (None for a CPU value, which is ready
    now). Recording queues a marker; it neither waits nor reads."""
    t = _cuda_tensor(value)
    if t is None:
        return None
    torch = _torch()
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


class StageTimer:
    """Per-stage wall-time aggregation (reference: FunctionTimer,
    common.h:1037). Enable with ``LIGHTGBM_TPU_TIMETAG=1`` or
    ``enable()``."""

    def __init__(self) -> None:
        self.enabled, self.sampling = _parse_timetag(
            os.environ.get("LIGHTGBM_TPU_TIMETAG"))
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        # per-call duration reservoirs (bounded like registry histograms)
        # backing the p50/p99 columns of phases()
        self.samples: Dict[str, list] = defaultdict(list)
        # record() runs on the caller's thread AND the readiness
        # drainer; readers (phases/print_summary) must not race a
        # first-time key insertion
        self._lock = threading.Lock()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def record(self, name: str, seconds: float) -> None:
        """Aggregate one completed stage call (totals + count + the
        bounded per-call sample reservoir). Thread-safe."""
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1
            vals = self.samples[name]
            vals.append(seconds)
            if len(vals) > kHistCap:
                del vals[:len(vals) - kHistCap]

    def stats(self) -> Dict[str, Tuple[float, int, list]]:
        """Consistent (total, calls, samples) snapshot per stage."""
        with self._lock:
            return {name: (self.totals[name], self.counts[name],
                           list(self.samples.get(name, ())))
                    for name in self.totals}

    @contextmanager
    def scope(self, name: str):
        """RAII stage scope (reference: FunctionTimer, common.h:1037).
        When the span-trace layer is active the scope also opens a span
        — even with aggregate timing disabled — so a trace-only run
        still renders every instrumented stage."""
        tracing = _tracing()
        if not self.enabled and not tracing:
            yield
            return
        nvtx = None
        if self.enabled:
            nvtx = _get_nvtx()
            if nvtx is not None:
                try:
                    nvtx.range_push(name)
                except Exception:
                    nvtx = None
        token = _trace_hooks.begin(name) if tracing else None
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.enabled:
                self.record(name, time.perf_counter() - start)
            if token is not None:
                _trace_hooks.end(token)
            if nvtx is not None:
                nvtx.range_pop()

    def print_summary(self) -> None:
        """reference: Timer::Print (common.h:1006) — per-stage totals.
        Prints regardless of verbosity: timing was explicitly enabled,
        exactly like a -DUSE_TIMETAG build's exit dump."""
        stats = self.stats()
        if not stats:
            return
        width = max(len(k) for k in stats)
        log.always("%s" % ("-" * (width + 30)))
        log.always("%-*s %12s %8s" % (width, "stage", "seconds", "calls"))
        for name in sorted(stats, key=lambda k: -stats[k][0]):
            log.always("%-*s %12.6f %8d"
                       % (width, name, stats[name][0], stats[name][1]))

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self.samples.clear()


class _ReadyWatcher:
    """Async stage-output readiness drainer (the non-perturbing
    replacement for TIMETAG's fences): the hot path records a CUDA event
    after a stage's output and keeps launching; a daemon thread polls
    the event (``Event.query``) off the hot path and attributes the
    remaining device time under ``<stage>::ready`` (plus a span on the
    trace's device-readiness lane). A CPU value is ready when it is
    watched and lands at once.

    Attribution is PER STREAM: each watched stage name gets its own
    drainer thread, so two stages whose outputs are in flight
    concurrently each measure ONLY their own readiness. Each watch also
    carries the span id that was open at submit time, so the ``::ready``
    span parent-links to the exact emitting span.

    At most ONE watch per stage name is in flight: when the host runs
    ahead of the card, further watches of the same stage are coalesced —
    counted under ``trace/ready_coalesced`` — so the drainer's queues
    stay bounded. Readiness is therefore a SAMPLE of iterations, which
    is exactly the mode's contract; the hot path never blocks."""

    kMaxStreams = 64

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._inflight = set()
        self._streams: Dict[str, object] = {}  # name -> queue.Queue
        self._unfinished = 0

    def _stream(self, name: str):
        q = self._streams.get(name)
        if q is None:
            with self._lock:
                q = self._streams.get(name)
                if q is None:
                    import queue
                    if len(self._streams) >= self.kMaxStreams:
                        # runaway distinct names (a bug upstream) must
                        # not spawn unbounded threads: fold the excess
                        # into one shared overflow stream
                        q = self._streams.get("<overflow>")
                        if q is None:
                            q = self._spawn("<overflow>")
                            self._streams["<overflow>"] = q
                        self._streams[name] = q
                    else:
                        q = self._spawn(name)
                        self._streams[name] = q
        return q

    def _spawn(self, name: str):
        import queue
        q = queue.Queue()
        t = threading.Thread(target=self._run, args=(q,),
                             name="obs-ready-drainer:" + name,
                             daemon=True)
        t.start()
        return q

    def submit(self, name: str, value, reg: "MetricsRegistry",
               span_id: int = 0) -> None:
        q = self._stream(name)
        with self._lock:
            if name in self._inflight:
                reg.inc("trace/ready_coalesced")
                return
            self._inflight.add(name)
            self._unfinished += 1
        q.put((name, _record_ready(value), time.perf_counter(), reg,
               span_id))

    def _run(self, q) -> None:
        while True:
            name, event, t_submit, reg, span_id = q.get()
            try:
                t_wait0 = time.perf_counter()
                if event is not None:
                    # poll, never a blocking wait: the drainer must not
                    # stall the card's queue or count as a host sync
                    while not event.query():
                        time.sleep(kReadyPoll)
                t_ready = time.perf_counter()
                if reg.timer.enabled:
                    reg.timer.record(name + "::ready", t_ready - t_submit)
                h = _trace_hooks
                if h is not None and h.active():
                    # span from wait-start (not submit): per-stream
                    # threads keep each lane's spans disjoint; the
                    # queue delay rides along as an arg
                    h.ready_span(name, t_wait0, t_ready,
                                 queued_s=t_wait0 - t_submit,
                                 for_span=span_id)
            except Exception:
                # a backend error must never kill telemetry
                pass
            finally:
                del event
                with self._lock:
                    self._inflight.discard(name)
                    self._unfinished -= 1

    def drain(self, timeout: float = 10.0) -> bool:
        """Best-effort wait for all watched outputs to resolve (used
        before trace export / summary printing). Returns False on
        timeout — a wedged device must not wedge telemetry too."""
        deadline = time.perf_counter() + timeout
        while True:
            with self._lock:
                if self._unfinished == 0:
                    return True
            if time.perf_counter() >= deadline:
                return False
            time.sleep(0.001)


_ready_watcher = _ReadyWatcher()


class MetricsRegistry:
    """Counters + gauges + the stage timer, one process-wide instance.

    Counters and gauges are always live (they back compile/health
    tracking and cost single dict writes); stage timing is gated on the
    timer's ``enabled`` flag like the reference's USE_TIMETAG build."""

    def __init__(self) -> None:
        self.timer = StageTimer()
        self.counters: Dict[str, int] = defaultdict(int)
        self.gauges: Dict[str, float] = {}
        # histograms: bounded value reservoirs (last kHistCap samples)
        # + an unbounded observation counter — what the serving layer's
        # p50/p99 latency reporting reads
        self.hist_values: Dict[str, list] = defaultdict(list)
        self.hist_counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        # Profiling mode: fence (synchronize the producing stream) at
        # stage boundaries so queued work can't smear one stage into the
        # next. On only
        # under an explicit LIGHTGBM_TPU_TIMETAG=1 ask — programmatic
        # enable() (the bench) keeps aggregate timing WITHOUT fences,
        # since fencing perturbs the very throughput being measured, and
        # LIGHTGBM_TPU_TIMETAG=sample attributes device time through the
        # async readiness drainer instead of fencing.
        self.fences = self.timer.enabled and not self.timer.sampling

    # -- stage timers ---------------------------------------------------
    def scope(self, name: str):
        return self.timer.scope(name)

    def enable(self, sampling: Optional[bool] = None) -> None:
        self.timer.enable()
        if sampling is not None:
            self.timer.sampling = bool(sampling)
            if sampling:
                self.fences = False

    def disable(self) -> None:
        self.timer.disable()

    @property
    def enabled(self) -> bool:
        return self.timer.enabled

    @property
    def sampling(self) -> bool:
        return self.timer.sampling

    def fence(self) -> bool:
        """True when stage boundaries should synchronize."""
        return (self.timer.enabled and self.fences
                and not self.timer.sampling)

    def watch_ready(self, name: str, value) -> None:
        """Stage-output readiness attribution, three modes:

        - fencing (``LIGHTGBM_TPU_TIMETAG=1``): synchronize the stream
          that produced ``value`` inline — exact per-stage device time,
          serialized launches;
        - sampling (``=sample``) or an active trace: record a CUDA event
          after ``value`` and hand it to the async drainer — the hot
          path never blocks, device time lands under ``<name>::ready`` /
          the trace's readiness lane;
        - otherwise: no-op (a few attribute reads).
        """
        tracing = _tracing()
        if not self.timer.enabled and not tracing:
            return
        if self.fence():
            _sync_producer(value)
            return
        if self.timer.sampling or tracing:
            span_id = 0
            if tracing:
                try:
                    span_id = _trace_hooks.current_span()
                except Exception:
                    span_id = 0
            _ready_watcher.submit(name, value, self, span_id=span_id)

    def drain_ready(self, timeout: float = 10.0) -> bool:
        """Wait for the readiness drainer's queue to empty."""
        return _ready_watcher.drain(timeout)

    # -- counters / gauges ---------------------------------------------
    def inc(self, name: str, n: int = 1) -> int:
        with self._lock:
            self.counters[name] += n
            return self.counters[name]

    def count(self, name: str) -> int:
        return self.counters.get(name, 0)

    def clear_counters(self, prefix: str) -> None:
        """Drop every counter whose name starts with ``prefix``."""
        with self._lock:
            for k in [k for k in self.counters if k.startswith(prefix)]:
                del self.counters[k]

    def clear_gauges(self, prefix: str) -> None:
        """Drop every gauge whose name starts with ``prefix`` (levels a
        finished component left, e.g. a drift monitor's last window)."""
        for k in [k for k in list(self.gauges) if k.startswith(prefix)]:
            self.gauges.pop(k, None)

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    # -- histograms -----------------------------------------------------
    def observe(self, name: str, value: float) -> None:
        """Record one sample into a bounded histogram reservoir."""
        with self._lock:
            self.hist_counts[name] += 1
            vals = self.hist_values[name]
            vals.append(float(value))
            if len(vals) > kHistCap:
                del vals[:len(vals) - kHistCap]

    def observed(self, name: str) -> int:
        """How many samples ``name`` has seen (a ``since`` baseline)."""
        with self._lock:
            return self.hist_counts.get(name, 0)

    def percentile(self, name: str, q: float, since: int = 0) -> float:
        """Linear-interpolated percentile over the reservoir (numpy's
        default method); 0.0 when nothing was observed. ``since`` (an
        earlier ``observed(name)``) keeps only the samples observed
        after it: the reservoir holds the newest ones, so they are its
        tail."""
        with self._lock:
            vals = self.hist_values.get(name, [])
            new = self.hist_counts.get(name, 0) - since
            if new < len(vals):
                vals = vals[len(vals) - max(new, 0):]
            vals = sorted(vals)
        return self._percentile_of(vals, q)

    @staticmethod
    def _percentile_of(vals: list, q: float) -> float:
        if not vals:
            return 0.0
        k = (len(vals) - 1) * (q / 100.0)
        f = int(k)
        c = min(f + 1, len(vals) - 1)
        return vals[f] + (vals[c] - vals[f]) * (k - f)

    # -- aggregation ----------------------------------------------------
    def phases(self) -> Dict[str, Dict[str, float]]:
        """Machine-readable stage table: {stage: {seconds, calls,
        p50_ms, p99_ms}} — what BENCH JSON publishes as its ``phases``
        dict. The percentile columns come from the bounded per-call
        sample reservoir, so BENCH records latency distributions, not
        just means."""
        out: Dict[str, Dict[str, float]] = {}
        for name, (total, calls, vals) in self.timer.stats().items():
            entry = {"seconds": round(total, 6), "calls": calls}
            if vals:
                sv = sorted(vals)
                entry["p50_ms"] = round(
                    self._percentile_of(sv, 50) * 1e3, 3)
                entry["p99_ms"] = round(
                    self._percentile_of(sv, 99) * 1e3, 3)
            out[name] = entry
        return out

    def snapshot(self) -> Dict:
        # histograms snapshot under the lock: a serving worker's first
        # observe() of a new name must not resize the dict mid-iteration
        with self._lock:
            hist_data = {name: (self.hist_counts[name], sorted(vals))
                         for name, vals in self.hist_values.items()}
            counters = dict(self.counters)
        return {"phases": self.phases(),
                "counters": counters,
                "gauges": dict(self.gauges),
                "hists": {name: {
                    "count": count,
                    "p50": round(self._percentile_of(vals, 50), 6),
                    "p99": round(self._percentile_of(vals, 99), 6)}
                    for name, (count, vals) in hist_data.items()}}

    def print_summary(self) -> None:
        self.timer.print_summary()

    def reset(self) -> None:
        self.timer.reset()
        with self._lock:
            self.counters.clear()
            self.hist_values.clear()
            self.hist_counts.clear()
        self.gauges.clear()
        for fn in _reset_hooks:
            try:
                fn()
            except Exception:
                pass


registry = MetricsRegistry()


def scoped(name: str):
    """Decorator form of ``registry.scope`` — the FunctionTimer analogue
    for whole functions."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with registry.scope(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


@atexit.register
def _print_at_exit() -> None:
    if registry.timer.enabled:
        # sample mode: let in-flight readiness watches land first so the
        # ::ready rows are complete in the exit table
        _ready_watcher.drain(timeout=5.0)
        registry.timer.print_summary()


_device_profile = None


def start_device_trace(logdir: str) -> None:
    """Start a ``torch.profiler`` session over the host and the card
    (its Chrome trace lands in ``logdir`` at :func:`stop_device_trace`)."""
    global _device_profile
    import torch.profiler as tp
    acts = [tp.ProfilerActivity.CPU]
    if _torch().cuda.is_available():
        acts.append(tp.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = tp.profile(activities=acts)
    prof.__enter__()
    _device_profile = (prof, logdir)


def stop_device_trace() -> None:
    global _device_profile
    session, _device_profile = _device_profile, None
    if session is None:
        return
    prof, logdir = session
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(os.path.join(
        logdir, "device-trace-%d.json" % os.getpid()))
