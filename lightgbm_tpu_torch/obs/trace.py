"""Span tracing with Chrome-trace / Perfetto JSON export.

Port of ``lightgbm_tpu/obs/trace.py``. Layers a span model (trace_id /
span_id / parent links, process+host tagged) onto the telemetry the
pipeline already emits, WITHOUT touching any call site:

- every ``registry.timer.scope`` (binning, root_histogram,
  split_batches, gradients, score_update, predict_batch, ...) becomes a
  ``ph:"X"`` complete event on the calling thread's lane, parented by
  the enclosing scope via a thread-local span stack;
- every ``events.emit`` record becomes an instant event on the same
  lane (``kernel_build`` and ``graph_capture`` events instead become
  spans on a dedicated compile lane, as long as the ``nvcc`` run or the
  capture took);
- the registry's async readiness drainer reports device completion of
  watched stage outputs (CUDA events it polls) as spans on a
  device-readiness lane;
- per-iteration device memory gauges (``torch.cuda.memory_allocated``
  and ``max_memory_allocated``, which read the caching allocator's
  books and do not synchronize) land as counter tracks.

Enable with ``LIGHTGBM_TPU_TRACE=/path/to/trace.json`` (or
:func:`configure`). The file is a standard Chrome-trace JSON object —
open it at https://ui.perfetto.dev or chrome://tracing. A run of several
processes writes one file per rank (the rank is folded into the path);
the rank is the caller's (:func:`set_process_index`), the
``torch.distributed`` group's, or the ``RANK`` environment variable of
its launchers, else 0.

Timestamps are wall-anchored but perf_counter-derived: one (wall, perf)
origin pair is sampled at import and every event timestamp is
``origin_wall + (perf_now - origin_perf)``, so intra-process ordering
is strictly monotone while cross-process merge still lines up on the
wall clock.

The span buffer is in-memory and bounded (``kMaxEvents``); it is
written on :func:`flush` (registered atexit), on :func:`configure`,
and the export rewrites the whole file — partial JSON is never left
behind.

For runs of unbounded length, ``LIGHTGBM_TPU_TRACE_STREAM=dir`` (or
:func:`configure_stream`) replaces the single bounded buffer with a
STREAMING SPOOL: events stage in a small in-memory chunk, a writer
thread serializes chunks off the hot path, and whenever the current
segment reaches ``LIGHTGBM_TPU_TRACE_SEGMENT_BYTES`` (default 8 MiB)
it is finalized ATOMICALLY (tmp + rename) as
``segment-r<rank>-<seq>.json`` — a self-contained Chrome-trace file —
inside the directory. Memory stays bounded at (staging chunk + writer
backlog + one segment); when the writer backlog is full, whole chunks
are dropped and counted under ``trace/dropped_events`` instead of
growing RSS. Flush (atexit, ``log.fatal``,
:func:`configure`) finalizes the partial tail segment, so the on-disk
directory never holds invalid JSON.

``LIGHTGBM_TPU_TRACE_FORMAT=compact`` switches the streaming spool to
the string-interned varint binary segment format of
:mod:`obs.trace_compact` (``segment-r<rank>-<seq>.ctrace``, ≥3x
smaller on disk, same atomic finalize + rotation + drop accounting;
``trace_compact.read_segment`` decodes one back into the JSON form).
Every
segment's ``otherData`` carries the run-correlation id
(``obs.events.run_id`` / ``LIGHTGBM_TPU_RUN_ID``) so fleet reports can
join segments with gateway metrics.
"""
from __future__ import annotations

import atexit
import itertools
import json
import os
import socket
import sys
import threading
import time
from typing import Dict, List, Optional

from . import events as _events
from . import faults
from . import trace_compact as _compact
from .registry import install_trace_hooks as _install_trace_hooks
from .registry import registry

_ENV_VAR = "LIGHTGBM_TPU_TRACE"
_ENV_STREAM = "LIGHTGBM_TPU_TRACE_STREAM"
_ENV_SEGMENT_BYTES = "LIGHTGBM_TPU_TRACE_SEGMENT_BYTES"
_ENV_FORMAT = "LIGHTGBM_TPU_TRACE_FORMAT"

kMaxEvents = 1 << 18
kDefaultSegmentBytes = 8 << 20
# streaming spool: hot-path staging chunk size and writer backlog cap
# (chunks). Memory in flight is bounded by
# stage_events * (1 + max_pending) events + one serialized segment.
kStreamStageEvents = 1024
kStreamMaxPending = 64

_lock = threading.Lock()
_events_buf: List[dict] = []
_dropped = 0
_path_override: Optional[str] = None
_stream_override: Optional[str] = None
_stream_disabled = False  # configure_stream(None) = explicitly OFF
_spool: Optional["_Spool"] = None
_span_seq = itertools.count(1)
_tls = threading.local()

# wall-anchored monotone clock origin (see module docstring)
_t0_wall = time.time()
_t0_perf = time.perf_counter()

_trace_id: Optional[str] = None
_process_index: Optional[int] = None

# lane (tid) allocation: stable small ints + a thread_name metadata
# record per lane; special string keys reserve the synthetic lanes
_lane_ids: Dict[object, int] = {}
_lane_names: Dict[int, str] = {}
kReadyLane = "device::ready"
kCompileLane = "build::compile"


def _now_us() -> float:
    return (_t0_wall + (time.perf_counter() - _t0_perf)) * 1e6


def _perf_to_us(t_perf: float) -> float:
    return (_t0_wall + (t_perf - _t0_perf)) * 1e6


# The env sinks are resolved ONCE at import (unlike the event log's
# per-emit read): active() sits on every stage-scope entry, and the
# telemetry-off fast path must stay a couple of attribute reads, not an
# os.environ lookup per scope. Late re-pointing goes through
# configure() / configure_stream().
_env_path = os.environ.get(_ENV_VAR) or None
_env_stream = os.environ.get(_ENV_STREAM) or None


def sink_path() -> Optional[str]:
    return _path_override or _env_path


def stream_dir() -> Optional[str]:
    """Segment-directory sink (streaming mode); takes precedence over
    the single-file sink when both are configured. None after an
    explicit ``configure_stream(None)`` even when the env var is set —
    detaching must not silently re-open (and re-write) the env
    directory."""
    if _stream_disabled:
        return None
    return _stream_override or _env_stream


def _streaming_configured() -> bool:
    return not _stream_disabled and (_stream_override is not None
                                     or _env_stream is not None)


def active() -> bool:
    return (_path_override is not None or _env_path is not None
            or _streaming_configured())


def trace_id() -> str:
    global _trace_id
    if _trace_id is None:
        _trace_id = "%d-%x" % (os.getpid(), int(time.time() * 1e6))
    return _trace_id


def process_index() -> int:
    """The rank used as the Chrome-trace pid (one lane group per rank
    after merge): the ``torch.distributed`` rank once a process group is
    initialized, else the ``RANK`` environment variable that its
    launchers set, else 0; :func:`set_process_index` overrides. Only a
    group's rank is kept: a rank read before the group starts is read
    again."""
    global _process_index
    if _process_index is not None:
        return _process_index
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        _process_index = dist.get_rank()
        return _process_index
    try:
        return int(os.environ.get("RANK", "0"))
    except ValueError:
        return 0


def set_process_index(idx: int) -> None:
    global _process_index
    _process_index = int(idx)


def rank_path(path: str, rank: int) -> str:
    """Per-rank trace file name: ``trace.json`` → ``trace.rank1.json``
    (rank 0 keeps the plain path so single-process usage is unchanged).
    Idempotent — re-ranking an already-ranked path (a second
    run in one process) returns it unchanged."""
    if rank == 0:
        return path
    root, ext = os.path.splitext(path)
    suffix = ".rank%d" % rank
    if root.endswith(suffix):
        return path
    return root + suffix + ext


def configure(path: Optional[str],
              process_index_override: Optional[int] = None,
              keep_buffer: bool = False) -> None:
    """Pin the trace sink programmatically (overrides the env var; None
    falls back to ``LIGHTGBM_TPU_TRACE`` as read at import). By default
    flushes to the OLD sink and then RESETS the span buffer, so each
    configured sink holds one self-contained trace.

    ``keep_buffer=True`` re-points WITHOUT touching the old sink:
    buffered events move to the new path as-is. A multi-process run uses
    this to fold the rank into the path — rank>0 must never write (not
    even a departing flush to) the shared un-ranked file."""
    global _path_override, _trace_id, _dropped
    if not keep_buffer:
        flush()
    with _lock:
        _path_override = path
        if not keep_buffer:
            _events_buf.clear()
            _lane_ids.clear()
            _lane_names.clear()
            _dropped = 0
            _trace_id = None
    if process_index_override is not None:
        set_process_index(process_index_override)


def configure_stream(dirpath: Optional[str],
                     segment_bytes: Optional[int] = None,
                     stage_events: Optional[int] = None,
                     max_pending: Optional[int] = None,
                     process_index_override: Optional[int] = None,
                     segment_format: Optional[str] = None) -> None:
    """Pin the streaming segment-directory sink programmatically
    (overrides ``LIGHTGBM_TPU_TRACE_STREAM``). ``None`` turns
    streaming OFF outright — unlike :func:`configure` it does NOT fall
    back to the env var: detaching must never silently re-open the
    env directory and restart its segment sequence over the previous
    run's files. Flushes whichever sink is currently active first, so
    each configured directory holds one self-contained segment
    sequence. ``segment_bytes`` / ``stage_events`` / ``max_pending``
    override the rotation size, the hot-path staging chunk, and the
    writer backlog cap (tests shrink all three to force rotation and
    drops at toy scale); ``segment_format`` (``"json"`` default /
    ``"compact"``) overrides ``LIGHTGBM_TPU_TRACE_FORMAT``."""
    global _stream_override, _stream_disabled, _spool, _trace_id
    old = _spool
    # whichever sink is currently active gets its staged events first
    # (a single-file trace switching into streaming mode must not
    # orphan its buffer)
    flush()
    with _lock:
        _stream_override = dirpath
        _stream_disabled = dirpath is None
        _spool = None
        if old is not None:
            _lane_ids.clear()
            _lane_names.clear()
            _trace_id = None
        if stream_dir() is not None:
            _spool = _Spool(stream_dir(), segment_bytes=segment_bytes,
                            stage_events=stage_events,
                            max_pending=max_pending,
                            segment_format=segment_format)
    if process_index_override is not None:
        set_process_index(process_index_override)


def _lane(key, name: str) -> int:
    # under _lock: concurrent first-use from the trainer, the readiness
    # drainer, and serve workers must not hand two threads one tid
    with _lock:
        lane = _lane_ids.get(key)
        if lane is None:
            lane = len(_lane_ids) + 1
            _lane_ids[key] = lane
            _lane_names[lane] = name
        return lane


def _thread_lane() -> int:
    # keyed by (ident, name), not bare ident: CPython recycles thread
    # ids, and a recycled id must not inherit a dead thread's lane label
    t = threading.current_thread()
    return _lane((t.ident, t.name), t.name)


def _push(ev: dict) -> None:
    global _dropped
    with _lock:
        sp = _ensure_spool_locked()
        if sp is not None:
            sp.push(ev)
            return
        if len(_events_buf) >= kMaxEvents:
            _dropped += 1
            registry.inc("trace/dropped_events")
            return
        _events_buf.append(ev)


def _ensure_spool_locked() -> Optional["_Spool"]:
    """The active spool, creating it lazily when streaming is enabled
    via the env var alone (configure_stream creates it eagerly).
    Caller holds ``_lock``."""
    global _spool
    if _spool is None and stream_dir() is not None:
        _spool = _Spool(stream_dir())
    return _spool


class _Spool:
    """Size-rotated streaming segment writer.

    Hot path: :meth:`push` (under the module ``_lock``) appends to a
    small staging list; every ``stage_events`` events the chunk is
    handed to a writer thread through a BOUNDED backlog — when the
    backlog is full (writer can't keep up / disk wedged) the chunk is
    dropped whole and counted under ``trace/dropped_events``, so RSS
    stays bounded no matter how long the run is.

    Writer thread: serializes each event once (a json line, or — in
    ``compact`` format — interned varint records via
    obs/trace_compact.py) and, when the serialized size of the open
    segment reaches ``segment_bytes``, finalizes it ATOMICALLY — the
    full document (lane metadata + events + otherData) is written to
    ``<name>.tmp`` and ``os.replace``d to
    ``segment-r<rank>-<seq>.json`` / ``.ctrace``. Every file in the
    directory is therefore always a complete, valid segment; readers
    never see a partial one.

    :meth:`flush` (atexit, ``log.fatal``, configure) drains staging +
    backlog and finalizes the partial tail segment. Never raises."""

    def __init__(self, dirpath: str,
                 segment_bytes: Optional[int] = None,
                 stage_events: Optional[int] = None,
                 max_pending: Optional[int] = None,
                 segment_format: Optional[str] = None) -> None:
        self.dir = dirpath
        if segment_bytes is None:
            try:
                segment_bytes = int(os.environ.get(
                    _ENV_SEGMENT_BYTES, kDefaultSegmentBytes))
            except ValueError:
                segment_bytes = kDefaultSegmentBytes
        if segment_format is None:
            segment_format = os.environ.get(_ENV_FORMAT) or "json"
        segment_format = segment_format.strip().lower()
        if segment_format not in ("json", "compact"):
            from ..utils import log
            log.warning_always(
                "unknown %s %r (json|compact) — using json"
                % (_ENV_FORMAT, segment_format))
            segment_format = "json"
        self.format = segment_format
        self.segment_bytes = max(int(segment_bytes), 1)
        self.stage_events = max(int(stage_events or kStreamStageEvents), 1)
        self.max_pending = max(int(max_pending or kStreamMaxPending), 1)
        self._staging: List[dict] = []
        self._pending: List[List[dict]] = []
        self._cond = threading.Condition()
        self._busy = False
        self._io = threading.Lock()
        self._lines: List[str] = []
        self._bytes = 0
        self._enc: Optional[_compact.SegmentEncoder] = None
        self._seq = 0
        self._seq_resumed = False
        self.events_emitted = 0
        self.dropped = 0
        self._thread: Optional[threading.Thread] = None
        os.makedirs(dirpath, exist_ok=True)

    # -- hot path (caller holds the module _lock) -----------------------
    def push(self, ev: dict) -> None:
        self._staging.append(ev)
        self.events_emitted += 1
        if len(self._staging) >= self.stage_events:
            self._hand_off()

    def _hand_off(self) -> None:
        chunk, self._staging = self._staging, []
        if not chunk:
            return
        with self._cond:
            if len(self._pending) >= self.max_pending:
                self.dropped += len(chunk)
                registry.inc("trace/dropped_events", len(chunk))
                return
            self._pending.append(chunk)
            self._ensure_thread()
            self._cond.notify()

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="obs-trace-spool", daemon=True)
            self._thread.start()

    # -- writer ---------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending:
                    self._cond.wait()
                chunk = self._pending.pop(0)
                self._busy = True
            try:
                self._write_chunk(chunk)
            except Exception:
                pass  # a full disk must not kill the writer
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def _write_chunk(self, chunk: List[dict]) -> None:
        with self._io:
            if self.format == "compact":
                # incremental binary encode: the open segment's memory
                # cost is its (already final) encoded bytes, same bound
                # as the JSON line list
                if self._enc is None:
                    self._enc = _compact.SegmentEncoder()
                for ev in chunk:
                    self._enc.add_event(ev)
                if self._enc.encoded_size >= self.segment_bytes:
                    self._finalize_io_locked()
                return
            for ev in chunk:
                line = json.dumps(ev)
                self._lines.append(line)
                self._bytes += len(line) + 1
            if self._bytes >= self.segment_bytes:
                self._finalize_io_locked()

    def _finalize_io_locked(self) -> None:
        """Write the open segment as one complete Chrome-trace file.
        Caller holds ``_io``; takes the module ``_lock`` only for the
        lane-name snapshot (never the reverse order — push under
        ``_lock`` touches only staging/backlog)."""
        compact = self.format == "compact"
        n_payload = (self._enc.n_events if compact and self._enc
                     else len(self._lines))
        if not n_payload:
            return
        pid = process_index()
        if not self._seq_resumed:
            # continue after any segments already in the directory for
            # this rank (a restarted run, or a re-configured spool):
            # on-disk segments are evidence and must never be
            # overwritten. Deferred to first finalize — the rank may
            # be pinned after the spool is constructed. Both
            # extensions count: a run restarted with the other format
            # must not reuse a live sequence number.
            self._seq_resumed = True
            prefix = "segment-r%d-" % pid
            try:
                for f in os.listdir(self.dir):
                    if not f.startswith(prefix):
                        continue
                    stem = f[len(prefix):]
                    for ext in (".json", _compact.EXTENSION):
                        if stem.endswith(ext):
                            try:
                                seq = int(stem[:-len(ext)])
                            except ValueError:
                                break
                            self._seq = max(self._seq, seq + 1)
                            break
            except OSError:
                pass
        with _lock:
            lanes = dict(_lane_names)
        meta_events = _metadata_events(lanes, pid)
        other = {"trace_id": trace_id(), "host": socket.gethostname(),
                 "os_pid": os.getpid(), "process_index": pid,
                 "run_id": _events.run_id(),
                 "segment_index": self._seq, "events": n_payload,
                 "dropped_events": self.dropped,
                 "producer": "lightgbm_tpu_torch/obs/trace.py"}
        if compact:
            other["format"] = "compact"
            name = "segment-r%d-%05d%s" % (pid, self._seq,
                                           _compact.EXTENSION)
            # lane metadata is only known at finalize; it appends after
            # the payload records (read_segment restores meta-first
            # ordering on decode)
            for m in meta_events:
                self._enc.add_event(m)
            body = self._enc.segment_bytes(other)
            mode = "wb"
        else:
            meta = [json.dumps(m) for m in meta_events]
            name = "segment-r%d-%05d.json" % (pid, self._seq)
            body = ('{"traceEvents":[' + ",".join(meta + self._lines)
                    + '],"displayTimeUnit":"ms","otherData":'
                    + json.dumps(other) + "}")
            mode = "w"
        path = os.path.join(self.dir, name)

        def _write():
            faults.check("trace_finalize", segment=name)
            tmp = path + ".tmp"
            with open(tmp, mode) as f:
                f.write(body)
            os.replace(tmp, path)

        # telemetry must never take training down: a segment whose
        # finalize fails even after the bounded retries is DROPPED
        # (counted like a backlog overflow) and the spool stays alive
        from ..utils.retry import retry_call
        try:
            retry_call(_write, site="trace_finalize")
        except Exception:
            self.dropped += n_payload
            registry.inc("trace/dropped_events", n_payload)
            self._lines = []
            self._bytes = 0
            self._enc = None
            return
        self._seq += 1
        self._lines = []
        self._bytes = 0
        self._enc = None
        registry.inc("trace/segments_written")

    # -- flush ----------------------------------------------------------
    def flush(self, timeout: float = 10.0) -> None:
        """Drain staging + writer backlog, then finalize the partial
        tail segment. Never raises."""
        try:
            with _lock:
                self._hand_off()
            deadline = time.perf_counter() + timeout
            with self._cond:
                while self._pending or self._busy:
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        break
                    self._cond.wait(timeout=min(left, 0.1))
            with self._io:
                self._finalize_io_locked()
        except Exception:
            pass


def _base_args(span_id: int = 0, parent: int = 0) -> dict:
    args = {"trace_id": trace_id()}
    if span_id:
        args["span_id"] = span_id
    if parent:
        args["parent_span_id"] = parent
    return args


# ----------------------------------------------------------------------
# registry scope hooks (the span stack)
# ----------------------------------------------------------------------

class _Hooks:
    """Installed into obs.registry so StageTimer.scope opens/closes
    spans without the registry importing this module."""

    @staticmethod
    def active() -> bool:
        return active()

    @staticmethod
    def begin(name: str):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        span_id = next(_span_seq)
        parent = stack[-1] if stack else 0
        stack.append(span_id)
        return (name, span_id, parent, _now_us())

    @staticmethod
    def end(token) -> None:
        name, span_id, parent, t0 = token
        stack = getattr(_tls, "stack", None)
        if stack:
            # normally a plain pop; sweep on mismatch so one leaked
            # scope cannot corrupt every later parent link
            if stack[-1] == span_id:
                stack.pop()
            elif span_id in stack:
                del stack[stack.index(span_id):]
        _push({"name": name, "ph": "X", "ts": t0,
               "dur": max(_now_us() - t0, 0.001),
               "pid": process_index(), "tid": _thread_lane(),
               "cat": "stage", "args": _base_args(span_id, parent)})

    @staticmethod
    def current_span() -> int:
        """Span id open on the calling thread (0 = none) — the token
        the readiness drainer carries so a ``::ready`` span lands on
        the exact span that submitted the watch, not on whichever
        span a FIFO pairing happened to be processing."""
        stack = getattr(_tls, "stack", None)
        return stack[-1] if stack else 0

    @staticmethod
    def ready_span(name: str, t0_perf: float, t1_perf: float,
                   queued_s: float = 0.0, for_span: int = 0) -> None:
        """Device-readiness span from the registry's async drainer.
        One lane PER STREAM (stage name): concurrent stages resolve on
        separate drainer threads, so their spans may overlap in time —
        distinct lanes keep the per-lane nesting invariant intact."""
        span_id = next(_span_seq)
        args = _base_args(span_id, parent=for_span)
        args["queued_ms"] = round(queued_s * 1e3, 3)
        _push({"name": name + "::ready", "ph": "X",
               "ts": _perf_to_us(t0_perf),
               "dur": max((t1_perf - t0_perf) * 1e6, 0.001),
               "pid": process_index(),
               "tid": _lane((kReadyLane, name), kReadyLane + ":" + name),
               "cat": "ready", "args": args})


_install_trace_hooks(_Hooks)


# ----------------------------------------------------------------------
# event tap (events.emit → instant events / compile spans)
# ----------------------------------------------------------------------

# compile-lane events (obs/compile.py): event -> (span name prefix,
# the field naming what was built, the field holding its seconds)
_COMPILE_EVENTS = {"kernel_build": ("build::", "library", "nvcc_seconds"),
                   "graph_capture": ("capture::", "graph",
                                     "capture_seconds")}


def _note_event(rec: dict) -> None:
    kind = _COMPILE_EVENTS.get(rec.get("event"))
    if kind is not None:
        # the build or capture window as a span on the compile lane,
        # ending when the event was emitted
        prefix, what, secs = kind
        dur = max(float(rec.get(secs, 0.0)) * 1e6, 0.001)
        end_us = float(rec.get("ts") or 0.0) * 1e6 or _now_us()
        args = _base_args(next(_span_seq))
        for k in (what, "count", secs):
            if k in rec:
                args[k] = rec[k]
        # per-thread compile lane: concurrent builds must not partially
        # overlap on one lane
        _push({"name": prefix + str(rec.get(what, "?")), "ph": "X",
               "ts": end_us - dur, "dur": dur,
               "pid": process_index(),
               "tid": _lane((kCompileLane, threading.get_ident()),
                            kCompileLane),
               "cat": "compile", "args": args})
        return
    args = _base_args()
    for k, v in rec.items():
        # run_id is per-run constant — it lives once in the segment's
        # otherData, not on every instant event
        if k not in ("ts", "event", "run_id"):
            args[k] = v
    stack = getattr(_tls, "stack", None)
    if stack:
        args["parent_span_id"] = stack[-1]
    _push({"name": rec.get("event", "?"), "ph": "i", "ts": _now_us(),
           "s": "t", "pid": process_index(), "tid": _thread_lane(),
           "cat": "event", "args": args})


_events.install_trace_tap(active, _note_event)


# ----------------------------------------------------------------------
# counters / device memory gauges
# ----------------------------------------------------------------------

def counter(name: str, values: Dict[str, float]) -> None:
    """Chrome counter track (rendered as a stacked area in Perfetto)."""
    if not active() or not values:
        return
    _push({"name": name, "ph": "C", "ts": _now_us(),
           "pid": process_index(), "tid": 0, "args": dict(values)})


def record_device_memory(reg=registry) -> Dict[str, float]:
    """Per-iteration device memory gauges while the process runs on the
    card: ``device/bytes_in_use`` (``torch.cuda.memory_allocated``),
    ``device/peak_bytes_in_use`` (``max_memory_allocated``) and
    ``device/bytes_limit`` (the card's total memory). These read the
    caching allocator's books on the host: no synchronize, no kernel.
    A CPU run records nothing. Lands in the registry's gauges and, when
    tracing, on a counter track."""
    out: Dict[str, float] = {}
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return out
    try:
        dev = torch.cuda.current_device()
        for dst, val in (
                ("device/bytes_in_use", torch.cuda.memory_allocated(dev)),
                ("device/peak_bytes_in_use",
                 torch.cuda.max_memory_allocated(dev)),
                ("device/bytes_limit", _total_memory(torch, dev))):
            reg.gauge(dst, float(val))
            out[dst] = float(val)
    except Exception:
        return out
    counter("device_memory", out)
    return out


_total_bytes: Dict[int, int] = {}


def _total_memory(torch, dev: int) -> int:
    if dev not in _total_bytes:
        _total_bytes[dev] = torch.cuda.get_device_properties(dev).total_memory
    return _total_bytes[dev]


# obs.export resolved once (same rule as compile.py's _get_trace):
# sample_iteration runs once per boosting iteration and must not pay
# import machinery per call
_export_mod = None


def _get_export():
    global _export_mod
    if _export_mod is None:
        from . import export
        _export_mod = export
    return _export_mod


_profiler_session = None  # None = not started, True = live, False = failed


def maybe_start_profiler_session(reg=registry) -> bool:
    """Optional ``torch.profiler`` session riding sample mode: with
    ``LIGHTGBM_TPU_TIMETAG=sample`` and
    ``LIGHTGBM_TPU_PROFILE_DIR=<logdir>`` set, the first sampled
    iteration starts one session (stopped atexit, its Chrome trace
    written into ``logdir``), with zero hot-path fences."""
    global _profiler_session
    if _profiler_session is not None:
        return _profiler_session is True
    logdir = os.environ.get("LIGHTGBM_TPU_PROFILE_DIR")
    if not logdir or not reg.timer.sampling:
        return False
    try:
        from .registry import start_device_trace, stop_device_trace
        start_device_trace(logdir)
        _profiler_session = True

        def _stop():
            try:
                stop_device_trace()
            except Exception:
                pass
        atexit.register(_stop)
        return True
    except Exception:
        _profiler_session = False
        return False


def sample_iteration(iter_idx: int, reg=registry) -> None:
    """Per-iteration telemetry hook for the boosting drivers: device
    memory gauges (+ the optional profiler session) only under the
    explicit profiling modes — TIMETAG fencing/sample or an active span
    trace. Programmatic ``registry.enable()`` alone (aggregate timing)
    skips it. Cheap no-op when
    off — safe on the hot path. Also the training-side tick for the
    metrics snapshot exporter + SLO watchdogs (obs/export.py), which
    gate themselves on their own env/config. The port's boosting
    driver calls it from ``GBDT.train_one_iter`` and ``train_batch``,
    outside the captured step."""
    _get_export().tick(reg)
    if not (reg.timer.sampling or reg.fence() or active()):
        return
    maybe_start_profiler_session(reg)
    record_device_memory(reg)


# ----------------------------------------------------------------------
# export
# ----------------------------------------------------------------------

def _metadata_events(lanes: Dict[int, str], pid: int) -> List[dict]:
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": "rank %d (%s)"
                      % (pid, socket.gethostname())}},
            {"name": "process_sort_index", "ph": "M", "pid": pid,
             "tid": 0, "args": {"sort_index": pid}}]
    for lane, name in sorted(lanes.items()):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": lane, "args": {"name": name}})
    return meta


def flush() -> None:
    """Drain in-flight readiness watches, then write the sink: in
    streaming mode, spool the staged events and finalize the partial
    tail segment; in single-file mode, (re)write the whole Chrome-trace
    JSON. Never raises — telemetry must not take the caller down."""
    if stream_dir() is not None:
        sp = _spool
        try:
            registry.drain_ready(timeout=5.0)
        except Exception:
            pass
        if sp is not None:
            sp.flush()
        return
    path = sink_path()
    if path is None:
        return
    try:
        registry.drain_ready(timeout=5.0)
        with _lock:
            if not _events_buf:
                return
            pid = process_index()
            evs = (_metadata_events(dict(_lane_names), pid)
                   + list(_events_buf))
            dropped = _dropped
        doc = {"traceEvents": evs,
               "displayTimeUnit": "ms",
               "otherData": {"trace_id": trace_id(),
                             "host": socket.gethostname(),
                             "os_pid": os.getpid(),
                             "process_index": pid,
                             "run_id": _events.run_id(),
                             "dropped_events": dropped,
                             "producer": "lightgbm_tpu_torch/obs/trace.py"}}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    except Exception:
        pass


atexit.register(flush)
