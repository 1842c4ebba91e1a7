"""Deterministic fault injection — the substrate for chaos tests.

Port of ``lightgbm_tpu/obs/faults.py``. Every failure mode the
fault-tolerant plane claims to survive needs a way to be PROVOKED on
demand, deterministically, in-process or from the environment. This
module provides named injection sites at the I/O boundaries a long run
crosses:

================== ====================================================
site               fires inside
================== ====================================================
shard_open         ShardedBinnedDataset.shard_bins_host (memmap open)
prefetch_device_put ShardPrefetcher worker staging (pinned copy to the
                   card)
spill_write        sharded construction shard spill (np.save)
trace_finalize     streaming trace segment finalize (obs/trace.py)
metrics_dump       OpenMetrics snapshot dump (obs/export.py)
registry_swap      serve ModelRegistry.publish and canary promote
checkpoint_finalize ft/checkpoint.py directory finalize (rename)
serve_admit        PredictServer.submit admission (request intake)
serve_dispatch     PredictServer worker dispatch (predictor.predict)
gateway_push       SnapshotPusher metrics POST (obs/gateway.py)
================== ====================================================

A schedule is a ``;``-separated spec string (``LIGHTGBM_TPU_FAULTS``
env var, or :func:`configure` programmatically)::

    site:mode[:arg[:ERRNO[:seed]]]

with ``mode`` one of ``nth`` (fail exactly the arg-th call, 1-based),
``once`` (first call only), ``always`` (every call), or ``prob`` (each
call independently with probability arg, drawn from a RandomState
seeded by ``seed`` — the same spec replays the same firing pattern).
``ERRNO`` names the errno of the raised :class:`InjectedFault`
(default EIO); e.g. ``checkpoint_finalize:nth:2:ENOSPC`` makes the
second checkpoint finalize hit a full disk.

:func:`check` raises :class:`InjectedFault` — an ``OSError`` subclass,
so production retry/degradation code handles injected and real
failures through exactly the same paths — and first emits a
``fault_injected`` event (flushed: the evidence must survive whatever
the fault takes down) plus the ``ft/faults_injected`` counter. With no
schedule configured a check is one dict lookup + one env read: cheap
enough to sit on staging paths permanently.
"""
from __future__ import annotations

import errno as _errno
import os
import threading
from typing import Dict, List, Optional, Union

import numpy as np

from ..utils import log
from . import events
from .registry import registry

_ENV = "LIGHTGBM_TPU_FAULTS"

SITES = ("shard_open", "prefetch_device_put", "spill_write",
         "trace_finalize", "metrics_dump", "registry_swap",
         "checkpoint_finalize", "serve_admit", "serve_dispatch",
         "gateway_push")


class InjectedFault(OSError):
    """An injected failure; an OSError (with errno) so call sites treat
    it exactly like the real thing."""


class _Spec:
    __slots__ = ("site", "mode", "arg", "errno_no", "errno_name",
                 "seed", "calls", "fired", "rng")

    def __init__(self, site: str, mode: str, arg: float,
                 errno_name: str, seed: int):
        if mode not in ("nth", "once", "always", "prob"):
            raise ValueError("unknown fault mode %r" % mode)
        self.site = site
        self.mode = mode
        self.arg = arg
        self.errno_name = errno_name or "EIO"
        self.errno_no = getattr(_errno, self.errno_name, None)
        if self.errno_no is None:
            raise ValueError("unknown errno name %r" % errno_name)
        self.seed = seed
        self.calls = 0
        self.fired = 0
        self.rng = (np.random.RandomState(seed & 0x7FFFFFFF)
                    if mode == "prob" else None)

    def should_fire(self) -> bool:
        """Advance this spec's call counter and decide. Caller holds
        the module lock."""
        self.calls += 1
        if self.mode == "nth":
            hit = self.calls == int(self.arg)
        elif self.mode == "once":
            hit = self.fired == 0
        elif self.mode == "always":
            hit = True
        else:  # prob
            hit = bool(self.rng.random_sample() < self.arg)
        if hit:
            self.fired += 1
        return hit


def parse_spec(text: str) -> List[_Spec]:
    """Parse a ``;``-separated schedule string; raises ValueError on a
    malformed entry (a chaos test with a typoed schedule must not
    silently test nothing)."""
    specs: List[_Spec] = []
    for entry in (text or "").replace(",", ";").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 2:
            raise ValueError("fault spec %r needs site:mode" % entry)
        site, mode = parts[0].strip(), parts[1].strip()
        arg_s = parts[2].strip() if len(parts) > 2 else ""
        err_s = parts[3].strip() if len(parts) > 3 else ""
        seed_s = parts[4].strip() if len(parts) > 4 else ""
        if mode in ("nth", "prob"):
            if not arg_s:
                raise ValueError("fault spec %r: mode %r needs an arg"
                                 % (entry, mode))
            arg = float(arg_s)
            if mode == "nth" and arg < 1:
                raise ValueError("fault spec %r: nth arg is 1-based"
                                 % entry)
        else:
            arg = float(arg_s) if arg_s else 0.0
        seed = int(seed_s) if seed_s else 0
        if site not in SITES:
            # a typoed site parses but never fires — a chaos schedule
            # that silently tests nothing. Warn loudly; stay non-fatal
            # so ad-hoc sites (tests, future call sites) keep working
            log.warning_always(
                "fault spec names unknown site %r (wired sites: %s)"
                % (site, ", ".join(SITES)))
        specs.append(_Spec(site, mode, arg, err_s or "EIO", seed))
    return specs


_lock = threading.Lock()
_specs: Dict[str, List[_Spec]] = {}
_override = False        # configure() beats the env var
_env_cached: Optional[str] = None


def configure(spec: Union[str, List[str], None]) -> None:
    """Install a schedule programmatically (a string, a list of spec
    strings, or None to clear and fall back to the env var)."""
    global _specs, _override, _env_cached
    with _lock:
        if spec is None:
            _specs, _override, _env_cached = {}, False, None
            return
        if isinstance(spec, (list, tuple)):
            spec = ";".join(spec)
        parsed = parse_spec(spec)
        _specs = {}
        for s in parsed:
            _specs.setdefault(s.site, []).append(s)
        _override = True


def reset() -> None:
    """Clear every schedule and call counter (tests)."""
    configure(None)


def _current(site: str) -> List[_Spec]:
    """Site's active specs; lazily (re)parses the env schedule whenever
    its value changes, so late ``os.environ`` assignment works like the
    other telemetry env vars."""
    global _specs, _env_cached
    if _override:
        return _specs.get(site, ())
    env = os.environ.get(_ENV) or ""
    if env != _env_cached:
        with _lock:
            if env != _env_cached:
                try:
                    parsed = parse_spec(env)
                except ValueError as e:
                    log.warning_always(
                        "ignoring malformed %s: %s" % (_ENV, e))
                    parsed = []
                _specs = {}
                for s in parsed:
                    _specs.setdefault(s.site, []).append(s)
                _env_cached = env
    return _specs.get(site, ())


def enabled() -> bool:
    return bool(_specs) or bool(os.environ.get(_ENV))


def check(site: str, **ctx) -> None:
    """Fault gate for ``site``: no-op unless a configured spec decides
    this call fails, in which case it emits the (flushed)
    ``fault_injected`` event + counter and raises
    :class:`InjectedFault`."""
    specs = _current(site)
    if not specs:
        return
    for spec in specs:
        with _lock:
            hit = spec.should_fire()
        if not hit:
            continue
        registry.inc("ft/faults_injected")
        registry.inc("ft/faults_injected/" + site)
        events.emit("fault_injected", site=site, call=spec.calls,
                    mode=spec.mode, errno=spec.errno_name,
                    **{k: str(v) for k, v in ctx.items()})
        events.flush()
        raise InjectedFault(
            spec.errno_no,
            "injected fault at %s (call %d, mode %s)"
            % (site, spec.calls, spec.mode))
