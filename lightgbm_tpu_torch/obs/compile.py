"""Kernel-build and CUDA-graph-capture tracking.

Port of ``lightgbm_tpu/obs/compile.py``. The JAX package counts the
traces of every ``jax.jit`` function (``jit_trace/<name>``, a
``jit_trace`` event each). The port has no ``jax.jit``; what it compiles
or records ahead of running is counted here instead, each under a
registry counter with its own event:

- **kernel builds** (``csrc/__init__.py``): every ``nvcc`` run of a
  kernel source counts under ``kernel_build/<library>`` and emits a
  ``kernel_build`` event with the library name and the ``nvcc`` seconds
  (also aggregated under the ``build::<library>`` stage); opening a
  built library counts under ``kernel_load/<library>`` with a
  ``kernel_load`` event.
- **CUDA graph captures** (``treelearner/serial.py``, the whole-tree
  step): every capture counts under ``graph_capture/<name>`` and emits a
  ``graph_capture`` event with the capture seconds (stage
  ``capture::<name>``).

A learner captures its step once and again only after ``reset_config``
or a resume; a name captured past ``LIGHTGBM_TPU_RETRACE_WARN`` times
(default 32; 0 disables) warns once about unexpected recaptures. The
warned-name set resets with ``registry.reset()``.

The JAX package's compile-cost capture (``lower().cost_analysis()``:
FLOPs, bytes and HLO size on the ``jit_trace`` event) has no
counterpart: ``nvcc`` and a graph capture expose no cost model to ask,
so no cost figure is recorded rather than a made-up one.
"""
from __future__ import annotations

import os
from typing import Dict

from ..utils import log
from . import events
from .registry import add_reset_hook, registry

_WARNED = set()


def reset_warned() -> None:
    """Clear the recapture-warning dedup set (also wired into
    ``registry.reset()`` below)."""
    _WARNED.clear()


add_reset_hook(reset_warned)


def _warn_threshold() -> int:
    try:
        return int(os.environ.get("LIGHTGBM_TPU_RETRACE_WARN", "32"))
    except ValueError:
        return 32


def record_kernel_build(library: str, seconds: float) -> int:
    """Count one ``nvcc`` build of ``library``; returns the count."""
    n = registry.inc("kernel_build/" + library)
    registry.timer.record("build::" + library, seconds)
    events.emit("kernel_build", library=library, count=n,
                nvcc_seconds=round(seconds, 6))
    return n


def record_kernel_load(library: str) -> int:
    """Count one opening of a built kernel library."""
    n = registry.inc("kernel_load/" + library)
    events.emit("kernel_load", library=library, count=n)
    return n


def record_graph_capture(name: str, seconds: float) -> int:
    """Count one CUDA graph capture of ``name``; returns the count and
    warns once when it passes the recapture threshold."""
    n = registry.inc("graph_capture/" + name)
    registry.timer.record("capture::" + name, seconds)
    events.emit("graph_capture", graph=name, count=n,
                capture_seconds=round(seconds, 6))
    thr = _warn_threshold()
    if thr and n == thr + 1 and name not in _WARNED:
        _WARNED.add(name)
        log.warning("CUDA graph %r captured %d times — unexpected "
                    "recaptures? (threshold LIGHTGBM_TPU_RETRACE_WARN=%d)"
                    % (name, n, thr))
    return n


def _by_prefix(prefix: str) -> Dict[str, int]:
    return {k[len(prefix):]: v for k, v in dict(registry.counters).items()
            if k.startswith(prefix)}


def build_counts() -> Dict[str, int]:
    return _by_prefix("kernel_build/")


def capture_counts() -> Dict[str, int]:
    return _by_prefix("graph_capture/")


def capture_count(name: str) -> int:
    return registry.count("graph_capture/" + name)
