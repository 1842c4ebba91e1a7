"""Leveled logging for lightgbm_tpu_torch.

Port of ``lightgbm_tpu/utils/log.py``: leveled Debug/Info/Warning/Fatal,
where Fatal raises ``LightGBMError`` instead of aborting. The sink is
stderr, or a Python callable given to :func:`register_log_callback` (the
reference's LGBM_RegisterLogCallback, src/c_api.cpp:904). A fatal
message also emits a ``log_fatal`` event and finalizes the span trace
written so far.
"""
from __future__ import annotations

import sys
from enum import IntEnum
from typing import Callable, Optional


class LogLevel(IntEnum):
    FATAL = -1
    WARNING = 0
    INFO = 1
    DEBUG = 2


class LightGBMError(Exception):
    """Raised on fatal errors (reference: Log::Fatal throws)."""


_level: LogLevel = LogLevel.INFO
_sink: Optional[Callable[[str], None]] = None


def set_verbosity(verbosity: int) -> None:
    """<0: fatal only, 0: warning, 1: info, >1: debug."""
    global _level
    if verbosity < 0:
        _level = LogLevel.FATAL
    elif verbosity == 0:
        _level = LogLevel.WARNING
    elif verbosity == 1:
        _level = LogLevel.INFO
    else:
        _level = LogLevel.DEBUG


def register_log_callback(fn: Optional[Callable[[str], None]]) -> None:
    """Route every log line through ``fn`` (None: back to stderr)."""
    global _sink
    _sink = fn


def _emit(msg: str) -> None:
    if _sink is not None:
        _sink(msg + "\n")
    else:
        print(msg, file=sys.stderr, flush=True)


def debug(msg: str, *args) -> None:
    if _level >= LogLevel.DEBUG:
        _emit("[LightGBM-Torch] [Debug] " + (msg % args if args else msg))


def info(msg: str, *args) -> None:
    if _level >= LogLevel.INFO:
        _emit("[LightGBM-Torch] [Info] " + (msg % args if args else msg))


def warning(msg: str, *args) -> None:
    if _level >= LogLevel.WARNING:
        _emit("[LightGBM-Torch] [Warning] " + (msg % args if args else msg))


def always(msg: str, *args) -> None:
    """Emit regardless of verbosity: output the user asked for (the
    LIGHTGBM_TPU_TIMETAG stage table at exit)."""
    _emit("[LightGBM-Torch] [Info] " + (msg % args if args else msg))


def warning_always(msg: str, *args) -> None:
    """A warning past the verbosity gate: a skipped checkpoint or a
    failed retry must never be silent."""
    _emit("[LightGBM-Torch] [Warning] " + (msg % args if args else msg))


def fatal(msg: str, *args) -> None:
    """Log then raise. A registered sink sees the message, a
    ``log_fatal`` event is emitted and flushed, and the span trace
    written so far is finalized: the evidence lands before the raise."""
    msg = msg % args if args else msg
    _emit("[LightGBM-Torch] [Fatal] " + msg)
    try:
        from ..obs import events as _events
        _events.emit("log_fatal", message=msg)
        _events.flush()
    except Exception:
        pass
    try:
        from ..obs import trace as _trace
        if _trace.active():
            _trace.flush()
    except Exception:
        pass
    raise LightGBMError(msg)
