"""Leveled logging for lightgbm_tpu_torch.

Port of ``lightgbm_tpu/utils/log.py``: leveled Debug/Info/Warning/Fatal
to stderr, where Fatal raises ``LightGBMError`` instead of aborting.
"""
from __future__ import annotations

import sys
from enum import IntEnum


class LogLevel(IntEnum):
    FATAL = -1
    WARNING = 0
    INFO = 1
    DEBUG = 2


class LightGBMError(Exception):
    """Raised on fatal errors (reference: Log::Fatal throws)."""


_level: LogLevel = LogLevel.INFO


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


def _emit(msg: str) -> None:
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


def fatal(msg: str, *args) -> None:
    """Log then raise."""
    msg = msg % args if args else msg
    _emit("[LightGBM-Torch] [Fatal] " + msg)
    raise LightGBMError(msg)


def unsupported(what: str, item: str) -> None:
    """Raise for a setting this port does not run yet, naming the
    ROADMAP item that brings it (never ignore it silently)."""
    fatal("%s is not supported by lightgbm_tpu_torch yet (ROADMAP %s)"
          % (what, item))
