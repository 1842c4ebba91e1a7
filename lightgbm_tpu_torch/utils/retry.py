"""Bounded, seeded retry with exponential backoff for transient I/O.

Port of ``lightgbm_tpu/utils/retry.py``. :func:`retry_call` gives every
I/O site of a long run (checkpoint finalize, metric dumps, gateway
pushes, trace segments) the same contract:

- up to ``attempts`` tries (``LIGHTGBM_TPU_RETRY_ATTEMPTS``, default 3)
  with exponential backoff + jitter from a SEEDED RNG
  (``LIGHTGBM_TPU_RETRY_SEED`` xor the site name — reruns back off
  identically, which keeps the fault-injection tests of obs/faults.py
  deterministic);
- every retry counts under ``ft/retries`` (total) and
  ``ft/retries/<site>`` and emits an ``io_retry`` event — the
  ``fault_storm`` watchdog rule (obs/health.py) monitors the total;
- giving up counts under ``ft/retry_exhausted``, emits a flushed
  ``retry_exhausted`` event, and re-raises the last error unchanged.

``retry_on`` filters which exception types are considered transient;
``no_retry`` vetoes individual instances (a full disk does not get
emptier by retrying).
"""
from __future__ import annotations

import os
import time
import zlib
from typing import Callable, Optional, Tuple, Type

import numpy as np

from ..obs import events as obs_events
from ..obs.registry import registry
from . import log

_ENV_ATTEMPTS = "LIGHTGBM_TPU_RETRY_ATTEMPTS"
_ENV_BASE_MS = "LIGHTGBM_TPU_RETRY_BASE_MS"
_ENV_SEED = "LIGHTGBM_TPU_RETRY_SEED"
kMaxBackoffMs = 2000.0


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def retry_call(fn: Callable, site: str, *,
               attempts: Optional[int] = None,
               base_ms: Optional[float] = None,
               retry_on: Tuple[Type[BaseException], ...] = (OSError,),
               no_retry: Optional[Callable[[BaseException], bool]] = None,
               reg=registry):
    """Call ``fn()`` with the bounded-retry contract above; returns its
    result or re-raises the final (or non-retryable) error."""
    n = max(attempts if attempts is not None
            else _env_int(_ENV_ATTEMPTS, 3), 1)
    base = max(base_ms if base_ms is not None
               else _env_float(_ENV_BASE_MS, 25.0), 0.0)
    rng = None
    for attempt in range(1, n + 1):
        try:
            return fn()
        except retry_on as e:
            if no_retry is not None and no_retry(e):
                raise
            if attempt >= n:
                reg.inc("ft/retry_exhausted")
                obs_events.emit("retry_exhausted", site=site,
                                attempts=n, error=repr(e))
                obs_events.flush()
                log.warning_always(
                    "%s: giving up after %d attempts (%r)"
                    % (site, n, e))
                raise
            reg.inc("ft/retries")
            reg.inc("ft/retries/" + site)
            if rng is None:
                rng = np.random.RandomState(
                    (_env_int(_ENV_SEED, 0)
                     ^ zlib.crc32(site.encode())) & 0x7FFFFFFF)
            delay_ms = min(base * (2.0 ** (attempt - 1)),
                           kMaxBackoffMs) * (0.5 + rng.random_sample())
            obs_events.emit("io_retry", site=site, attempt=attempt,
                            delay_ms=round(delay_ms, 3), error=repr(e))
            if delay_ms > 0:
                time.sleep(delay_ms / 1000.0)
