"""The profile of a traced run and its reduction: device operations from
``torch.profiler`` (kernels, copies and fills), the union of their
intervals, the idle gaps between them labelled by what the host was doing,
and the device operations of the benchmark's own fenced ranges. The
profile is read in memory; no trace file is written."""
from __future__ import annotations

import bisect
from collections import defaultdict
from contextlib import contextmanager
from typing import List, Optional, Tuple

#: the range that spans the profiled work; ranges of the benchmark's own
#: start with ``bench::`` and are not device operations
SPAN = "bench::profiled"
_OWN = "bench::"
#: the profiler's own host work (CUPTI's activity buffers): device time
#: left idle while it runs is the tracing's cost, not the program's, and
#: is taken out of the window
PROFILER_OWN = ("Activity Buffer Request", "Buffer Flush")
#: longest kernel name kept in a breakdown
NAME_CHARS = 160


def union_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def minus(gaps: List[Tuple[float, float]], cut: List[List[float]]
          ) -> List[Tuple[float, float]]:
    """``gaps`` less the (merged, sorted) intervals ``cut``."""
    out = []
    for s, e in gaps:
        for cs, ce in cut:
            if ce <= s or cs >= e:
                continue
            if cs > s:
                out.append((s, cs))
            s = max(s, ce)
            if s >= e:
                break
        if s < e:
            out.append((s, e))
    return out


def merged(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class ProfileResult:
    """``device``: (name, start_us, end_us) of each device operation
    inside the span; ``host``: (name, start_us, end_us) of host
    operations; ``span``: (start_us, end_us) of :data:`SPAN`;
    ``ranges``: {name: [(start_us, end_us) of each range of that name]}
    (the benchmark's own ranges, which :func:`bench_range` fences, so
    that the device operations that run inside one are the ones its body
    launched)."""

    def __init__(self, device, host, span, ranges):
        self.device = device
        self.host = host
        self.span = span
        self.ranges = ranges
        self._idle = None

    @classmethod
    def from_events(cls, events) -> "ProfileResult":
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        device, host, span, ranges = [], [], None, defaultdict(list)
        for e in events:
            name = e.name
            s, t = e.time_range.start, e.time_range.end
            if e.device_type == cuda:
                if not name.startswith(_OWN):
                    device.append((name, s, t))
            elif name == SPAN:
                span = (s, t)
            else:
                if name.startswith(_OWN):
                    ranges[name].append((s, t))
                host.append((name, s, t))
        if span is not None:
            device = [d for d in device if d[2] > span[0] and d[1] < span[1]]
        return cls(device, host, span, dict(ranges))

    # -- reductions ----------------------------------------------------
    def idle(self) -> List[Tuple[float, float]]:
        """The intervals of the span in which no device operation ran,
        less those in which the profiler's own host work ran."""
        if self._idle is None:
            a, b = self.span
            busy = merged([(max(s, a), min(e, b)) for _, s, e in self.device
                           if e > a and s < b])
            gaps, cur = [], a
            for s, e in busy:
                if s > cur:
                    gaps.append((cur, s))
                cur = max(cur, e)
            if b > cur:
                gaps.append((cur, b))
            own = merged([(s, e) for n, s, e in self.host
                          if n in PROFILER_OWN])
            self._idle = minus(gaps, own)
        return self._idle

    def busy_us(self) -> float:
        if self.span is None:
            return 0.0
        a, b = self.span
        return union_us([(max(s, a), min(e, b)) for _, s, e in self.device
                         if e > a and s < b])

    def window_us(self) -> Optional[float]:
        """The span less the idle time the profiler's own work took."""
        if self.span is None:
            return None
        return self.busy_us() + sum(e - s for s, e in self.idle())

    def ops_in(self, name: str) -> List[Tuple[str, float, float]]:
        """The device operations that started inside a range ``name``."""
        spans = self.ranges.get(name, [])
        return [d for d in self.device
                if any(s <= d[1] < e for s, e in spans)]

    def top_ops(self, k: int = 10) -> List[List]:
        by = defaultdict(float)
        for name, s, e in self.device:
            by[name[:NAME_CHARS]] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, t / 1e6] for n, t in top]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The ``k`` longest gaps inside the span in which no device
        operation ran, each named by the innermost host operation open at
        its middle."""
        if self.span is None:
            return []
        gaps = sorted(self.idle(), key=lambda g: g[0] - g[1])[:k]
        host = sorted((h for h in self.host if h[0] not in PROFILER_OWN),
                      key=lambda h: h[1])
        starts = [h[1] for h in host]
        out = []
        for s, e in gaps:
            mid = 0.5 * (s + e)
            label = "host"
            # the latest-starting host operation still open at ``mid``
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 20000, -1), -1):
                if host[j][2] >= mid:
                    label = host[j][0]
                    break
            out.append([label[:NAME_CHARS], (e - s) / 1e6])
        return out


@contextmanager
def profiled(device):
    """Profile the body; yields a one-element list that holds the
    :class:`ProfileResult` once the body has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    box: List[ProfileResult] = []
    with profile(activities=acts) as prof:
        with record_function(SPAN):
            yield box
            if device.type == "cuda":
                torch.cuda.synchronize()
    box.append(ProfileResult.from_events(prof.events()))


@contextmanager
def bench_range(name: str, device):
    """A range of the benchmark's own around the body, fenced: the device
    is synchronized as the range opens and before it closes, so that the
    device operations that run inside it are those the body launched."""
    from torch.profiler import record_function
    with record_function(_OWN + name):
        _sync(device)
        yield
        _sync(device)


def _sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def fence_method(obj, attr: str, name: str, device):
    """Wrap ``obj.attr`` (an instance's method) in :func:`bench_range`;
    ``del obj.attr`` undoes it."""
    plain = getattr(obj, attr)

    def fenced(*a, **k):
        with bench_range(name, device):
            return plain(*a, **k)
    setattr(obj, attr, fenced)
