"""Structured JSON-lines event sink.

Port of ``lightgbm_tpu/obs/events.py`` (stdlib only).

Every event is one JSON object per line::

    {"ts": 1722700000.123, "event": "train_iter",
     "run_id": "18f2a-4c1", "iter": 4, ...}

(``run_id`` — see :func:`run_id` — correlates every record of one run
across processes: ranks inherit ``LIGHTGBM_TPU_RUN_ID``.)

Two sinks, both optional and independent:

- a file, named by ``LIGHTGBM_TPU_EVENT_LOG=path`` (read per emit, so a
  late ``os.environ`` assignment still takes effect) or pinned
  programmatically with :func:`configure`;
- a Python callback registered via :func:`register_event_callback` —
  the event-stream mirror of ``log.register_log_callback``
  (reference: LGBM_RegisterLogCallback, src/c_api.cpp:904).

Emission with no sink configured is a few dict lookups — cheap enough
to leave the call sites unconditional.

File writes are BUFFERED: emits append serialized lines to an in-memory
buffer that flushes on overflow (``LIGHTGBM_TPU_EVENT_BUFFER`` lines,
default 64; 0 = write-through), at process exit (atexit), on
:func:`configure`, and on explicit :func:`flush`. This replaces the old
per-emit open/append/close (one syscall trio per event — measurable in
tight iteration loops at Higgs scale). Each buffered record remembers
the sink path active when it was emitted, so late env-var changes keep
exact per-file ordering and content; :func:`read_jsonl` flushes first,
so readers never race the buffer. Callbacks still fire synchronously
per emit — only the file sink is deferred.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

_ENV_VAR = "LIGHTGBM_TPU_EVENT_LOG"
_ENV_BUFFER = "LIGHTGBM_TPU_EVENT_BUFFER"
_ENV_RUN_ID = "LIGHTGBM_TPU_RUN_ID"

_run_id: Optional[str] = None
_run_id_env: Optional[str] = None

_callback: Optional[Callable[[Dict], None]] = None
_path_override: Optional[str] = None
_lock = threading.Lock()
_buffer: List[Tuple[str, str]] = []  # (sink path at emit time, json line)

# span-trace tap (obs/trace.py): (active_predicate, note_fn). When the
# trace sink is live every emitted event also lands in the trace as an
# instant/compile span — the trace layer rides the existing emit call
# sites without any caller changes.
_trace_tap: Optional[Tuple[Callable[[], bool],
                           Callable[[Dict], None]]] = None


def install_trace_tap(active_fn: Callable[[], bool],
                      note_fn: Callable[[Dict], None]) -> None:
    global _trace_tap
    _trace_tap = (active_fn, note_fn)


def run_id() -> str:
    """The run-correlation id stamped into every event record, trace
    segment header, and gateway push. ``LIGHTGBM_TPU_RUN_ID`` wins when
    set (re-read per call, so a late assignment — or a test
    monkeypatch — takes effect); otherwise one id is generated on
    first use and WRITTEN BACK to the environment, so subprocesses
    spawned after that point (training ranks, serving workers) inherit
    the parent's id and the whole fleet's telemetry joins on one
    key."""
    global _run_id, _run_id_env
    env = os.environ.get(_ENV_RUN_ID)
    if env:
        if env != _run_id_env:
            _run_id_env = env
            _run_id = env
        return env
    if _run_id is None:
        _run_id = "%x-%x" % (int(time.time() * 1e3) & 0xFFFFFFFFFF,
                             os.getpid())
        _run_id_env = _run_id
        os.environ[_ENV_RUN_ID] = _run_id
    return _run_id


def _buffer_limit() -> int:
    try:
        return max(int(os.environ.get(_ENV_BUFFER, "64")), 1)
    except ValueError:
        return 64


def configure(path: Optional[str]) -> None:
    """Pin the event-log path programmatically (overrides the env var;
    pass None to fall back to ``LIGHTGBM_TPU_EVENT_LOG``). Flushes any
    buffered events first so readers of the previous sink are current."""
    global _path_override
    flush()
    _path_override = path


def register_event_callback(fn: Optional[Callable[[Dict], None]]) -> None:
    """Route every event dict through ``fn`` (None unregisters)."""
    global _callback
    _callback = fn


def sink_path() -> Optional[str]:
    return _path_override or os.environ.get(_ENV_VAR) or None


def _tap_active() -> bool:
    tap = _trace_tap
    if tap is None:
        return False
    try:
        return tap[0]()
    except Exception:
        return False


def enabled() -> bool:
    return (_callback is not None or sink_path() is not None
            or _tap_active())


def _jsonable(v):
    """Coerce numpy scalars / odd payloads into JSON-native types."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    try:
        import numpy as np
        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
        if isinstance(v, np.ndarray):
            return v.tolist()
    except Exception:
        pass
    return str(v)


def emit(event: str, **fields) -> Optional[Dict]:
    """Emit one structured event to every configured sink. Returns the
    event dict (or None when no sink is active). Never raises: telemetry
    must not take training down."""
    if not enabled():
        return None
    rec = {"ts": round(time.time(), 6), "event": event,
           "run_id": run_id()}
    for k, v in fields.items():
        rec[k] = _jsonable(v)
    cb = _callback
    if cb is not None:
        try:
            cb(rec)
        except Exception:
            pass
    tap = _trace_tap
    if tap is not None and _tap_active():
        try:
            tap[1](rec)
        except Exception:
            pass
    path = sink_path()
    if path is not None:
        try:
            line = json.dumps(rec)
            with _lock:
                _buffer.append((path, line))
                if len(_buffer) >= _buffer_limit():
                    _flush_locked()
        except Exception:
            pass
    return rec


def flush() -> None:
    """Write every buffered event to its file sink. Never raises —
    telemetry must not take the caller down. Registered atexit; call
    explicitly before handing a log file to an external reader."""
    with _lock:
        _flush_locked()


def _flush_locked() -> None:
    """Drain the buffer grouping CONSECUTIVE same-path records into one
    append each, so per-file line order is exactly emission order even
    when the sink path changed mid-buffer."""
    if not _buffer:
        return
    try:
        i = 0
        while i < len(_buffer):
            path = _buffer[i][0]
            j = i
            while j < len(_buffer) and _buffer[j][0] == path:
                j += 1
            try:
                with open(path, "a") as f:
                    f.write("\n".join(line for _, line in _buffer[i:j])
                            + "\n")
            except Exception:
                pass
            i = j
    finally:
        del _buffer[:]


atexit.register(flush)


def read_jsonl(path: str):
    """Parse an event-log file back into a list of event dicts (raises
    on malformed lines — the test-side round-trip check). Flushes the
    buffer first so in-process readers see everything emitted so far."""
    flush()
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
