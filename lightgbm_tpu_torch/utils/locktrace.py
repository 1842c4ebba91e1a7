"""Runtime lock sanitizer for the serving plane's locks.

Port of ``lightgbm_tpu/utils/locktrace.py`` (host-only; no device
code). Set ``LIGHTGBM_TPU_LOCKTRACE=1`` and every named lock of the
serving classes (``PredictServer``, ``CircuitBreaker``,
``ModelRegistry``, ``BucketedPredictor``) and of the metrics gateway is
wrapped in a tracing proxy that keeps

- a **per-thread acquisition stack** (which named locks this thread
  holds, in order),
- a **global lock-order graph**: the first time lock B is taken while
  A is held, the edge A->B is recorded with a witness stack; a later
  acquisition implying B->A raises :class:`LockOrderError` at once,
  before the raw acquire, in the acquiring thread, so an inversion is
  caught even when the schedule never deadlocks (one thread suffices),
- **bounded hold times**: releasing a lock held longer than the budget
  records a violation (``Condition.wait`` closes the hold interval
  while the lock is out, so waiting is never billed as holding).

Hold-time overruns are recorded, not raised: a slow machine must not
turn a latency smell into a crash mid-dispatch; a test asserts over
:func:`report` / :func:`assert_clean` at the end of its window. Order
inversions raise at the acquire: they are schedule bugs, not speed
bugs.

Wiring: classes call :func:`maybe_trace` at the end of ``__init__``
(before any worker thread starts); with the variable unset it does
nothing and the class runs on raw primitives. Proxies wrap the same
underlying primitive, so a lock shared across objects (the
replica-shared ``entries_lock``) stays mutually exclusive with every
proxy and with untraced references alike.

Enable:   LIGHTGBM_TPU_LOCKTRACE=1
Budget:   LIGHTGBM_TPU_LOCKTRACE_MAX_HOLD_MS (default 500)
"""
from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

__all__ = [
    "LockOrderError", "TracedLock", "TracedCondition", "enabled",
    "trace_object", "maybe_trace", "reset", "report", "assert_clean",
]

_ENV = "LIGHTGBM_TPU_LOCKTRACE"
_ENV_HOLD = "LIGHTGBM_TPU_LOCKTRACE_MAX_HOLD_MS"

_LOCK_TYPE = type(threading.Lock())
_RLOCK_TYPE = type(threading.RLock())


def enabled() -> bool:
    return os.environ.get(_ENV, "") not in ("", "0")


class LockOrderError(AssertionError):
    """Two code paths take the same pair of locks in opposite orders;
    two threads interleaving them deadlock."""


def _stack(limit: int = 8) -> List[str]:
    # drop the locktrace frames themselves; the caller's frames are
    # what identifies the witness site
    return [ln.strip() for ln in
            traceback.format_stack(limit=limit)[:-3]]


class _Tracer:
    """One process-wide order graph + violation log. Its own state is
    guarded by a raw (untraced) lock that is never held across a
    traced acquire, so the sanitizer cannot deadlock the sanitized."""

    def __init__(self) -> None:
        self._meta = threading.Lock()
        self._tls = threading.local()
        #: (held, acquired) -> witness {thread, stack}
        self.edges: Dict[Tuple[str, str], dict] = {}
        self.order_violations: List[dict] = []
        self.hold_violations: List[dict] = []
        self.acquires = 0
        try:
            ms = float(os.environ.get(_ENV_HOLD, "500"))
        except ValueError:
            ms = 500.0
        self.max_hold_s = ms / 1000.0

    # -- per-thread stack ----------------------------------------------
    def held(self) -> List[Tuple[str, float]]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    # -- events --------------------------------------------------------
    def note_acquire(self, name: str) -> None:
        """Called BEFORE the raw acquire: record order edges from every
        currently-held lock and raise on an inversion."""
        held = self.held()
        self.acquires += 1
        for h, _t0 in held:
            if h == name:
                continue  # re-acquire of the same named lock
            with self._meta:
                rev = self.edges.get((name, h))
                self.edges.setdefault((h, name), {
                    "thread": threading.current_thread().name,
                    "stack": _stack(),
                })
                if rev is None:
                    continue
                v = {
                    "pair": (h, name),
                    "thread": threading.current_thread().name,
                    "stack": _stack(),
                    "reverse_thread": rev["thread"],
                    "reverse_stack": rev["stack"],
                }
                self.order_violations.append(v)
            raise LockOrderError(
                "lock order inversion: acquiring %r while holding %r, "
                "but thread %r already took %r before %r (witness:\n  "
                "%s)" % (name, h, v["reverse_thread"], name, h,
                         "\n  ".join(v["reverse_stack"][-2:])))

    def push(self, name: str) -> None:
        self.held().append((name, time.monotonic()))

    def pop(self, name: str) -> None:
        held = self.held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                _, t0 = held.pop(i)
                dur = time.monotonic() - t0
                if dur > self.max_hold_s:
                    with self._meta:
                        self.hold_violations.append({
                            "lock": name,
                            "held_s": dur,
                            "budget_s": self.max_hold_s,
                            "thread":
                                threading.current_thread().name,
                        })
                return
        # release of a lock acquired before tracing wrapped it (or on
        # another proxy path): nothing to bill


_TRACER = _Tracer()


class TracedLock:
    """Composition proxy over a ``threading.Lock``/``RLock``."""

    def __init__(self, raw, name: str,
                 tracer: Optional[_Tracer] = None) -> None:
        self._raw = raw
        self._name = name
        self._tracer = tracer or _TRACER

    def acquire(self, blocking: bool = True, timeout: float = -1):
        self._tracer.note_acquire(self._name)
        got = self._raw.acquire(blocking, timeout)
        if got:
            self._tracer.push(self._name)
        return got

    def release(self) -> None:
        self._tracer.pop(self._name)
        self._raw.release()

    def locked(self) -> bool:
        return self._raw.locked()

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return "<TracedLock %s of %r>" % (self._name, self._raw)


class TracedCondition:
    """Composition proxy over a ``threading.Condition``. ``wait``/
    ``wait_for`` close the hold interval for the duration of the wait
    (the underlying lock really is released) and reopen it on wake."""

    def __init__(self, raw, name: str,
                 tracer: Optional[_Tracer] = None) -> None:
        self._raw = raw
        self._name = name
        self._tracer = tracer or _TRACER

    def acquire(self, *args):
        self._tracer.note_acquire(self._name)
        got = self._raw.acquire(*args)
        if got:
            self._tracer.push(self._name)
        return got

    def release(self) -> None:
        self._tracer.pop(self._name)
        self._raw.release()

    def __enter__(self) -> "TracedCondition":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def wait(self, timeout: Optional[float] = None):
        self._tracer.pop(self._name)
        try:
            return self._raw.wait(timeout)
        finally:
            self._tracer.push(self._name)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        self._tracer.pop(self._name)
        try:
            return self._raw.wait_for(predicate, timeout)
        finally:
            self._tracer.push(self._name)

    def notify(self, n: int = 1) -> None:
        self._raw.notify(n)

    def notify_all(self) -> None:
        self._raw.notify_all()

    def __repr__(self) -> str:
        return "<TracedCondition %s of %r>" % (self._name, self._raw)


# ----------------------------------------------------------------------
# wiring
# ----------------------------------------------------------------------

def trace_object(obj, tracer: Optional[_Tracer] = None):
    """Replace every lock/condition attribute of ``obj`` with a traced
    proxy named ``ClassName.attr``. Idempotent; returns ``obj``."""
    tracer = tracer or _TRACER
    cls = type(obj).__name__
    for attr, val in list(vars(obj).items()):
        if isinstance(val, (TracedLock, TracedCondition)):
            continue
        name = "%s.%s" % (cls, attr)
        if isinstance(val, threading.Condition):
            setattr(obj, attr, TracedCondition(val, name, tracer))
        elif isinstance(val, (_LOCK_TYPE, _RLOCK_TYPE)):
            setattr(obj, attr, TracedLock(val, name, tracer))
    return obj


def maybe_trace(obj):
    """The ``__init__`` hook: trace ``obj`` when the sanitizer is
    enabled, otherwise hand it back untouched."""
    if enabled():
        trace_object(obj)
    return obj


# ----------------------------------------------------------------------
# inspection
# ----------------------------------------------------------------------

def reset() -> None:
    """Fresh order graph and violation log, cleared IN PLACE so the
    proxies already wrapped around live objects keep reporting here
    (tests call this between windows; per-thread held stacks of live
    threads are preserved)."""
    t = _TRACER
    with t._meta:
        t.edges.clear()
        t.order_violations.clear()
        t.hold_violations.clear()
        t.acquires = 0


def tracer() -> _Tracer:
    return _TRACER


def report() -> dict:
    t = _TRACER
    with t._meta:
        return {
            "enabled": enabled(),
            "acquires": t.acquires,
            "edges": {"%s->%s" % k: dict(v)
                      for k, v in t.edges.items()},
            "order_violations": [dict(v)
                                 for v in t.order_violations],
            "hold_violations": [dict(v) for v in t.hold_violations],
            "max_hold_s": t.max_hold_s,
        }


def assert_clean() -> None:
    """Raise ``AssertionError`` describing every recorded violation
    (order inversions that were swallowed by a caller, plus hold-time
    overruns). Clean window -> returns silently."""
    t = _TRACER
    with t._meta:
        order = list(t.order_violations)
        hold = list(t.hold_violations)
    if not order and not hold:
        return
    lines = []
    for v in order:
        lines.append("order inversion %s vs %s (thread %s; reverse "
                     "in %s)" % (v["pair"][0], v["pair"][1],
                                 v["thread"], v["reverse_thread"]))
    for v in hold:
        lines.append("%s held %.3fs by %s (budget %.3fs)"
                     % (v["lock"], v["held_s"], v["thread"],
                        v["budget_s"]))
    raise AssertionError("locktrace: %d violation(s):\n  %s"
                         % (len(lines), "\n  ".join(lines)))
