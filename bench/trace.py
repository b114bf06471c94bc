"""The traced part of a ``--trace 1`` window, read from ``torch.profiler``.

``Tracer`` opens the profiler (device activity only) between two engine
calls once the window has run ``start_s`` seconds, and closes it after the
first call that ends ``length_s`` seconds later once it has traced a call
of each kind, or ``2 * length_s`` seconds later in any case.  It still
slows the host inside every traced call, so readers that need the host's
pace take it from the untraced part of the window.  The engine calls it saw are stamped on the
wall clock (``time.time_ns``), the clock the profiler gives device
activity on.  ``read`` turns the profile into ``Trace``: the device's
activities (kernels, copies, sets) as intervals, the traced calls, and
each call's activities.  Engine calls block until their work is done, so
every activity a call queued runs inside that call's interval; an
activity is given to the call whose interval holds its midpoint.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field


KINDS = {"decode", "prefill"}     # the engine calls a traced part holds


class Tracer:
    def __init__(self, start_s: float, length_s: float):
        self.start_s, self.length_s = start_s, length_s
        self.active = self.done = False
        self.prof = None
        self.t_on = 0.0
        self.kinds: set[str] = set()

    @staticmethod
    def _profile():
        import torch
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CUDA
                                   if torch.cuda.is_available()
                                   else ProfilerActivity.CPU])

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        initialises the device tracer, which takes seconds."""
        import torch
        with self._profile():
            if torch.cuda.is_available():
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def before(self, elapsed: float) -> None:
        if not (self.active or self.done) and elapsed >= self.start_s:
            self.prof = self._profile()
            self.prof.__enter__()
            self.active = True
            self.t_on = elapsed

    def after(self, elapsed: float, kind: str) -> None:
        if not self.active:
            return
        self.kinds.add(kind)
        traced = elapsed - self.t_on
        if traced >= 2 * self.length_s or (
                traced >= self.length_s and self.kinds >= KINDS):
            self.stop()

    def stop(self) -> None:
        if self.active:
            self.prof.__exit__(None, None, None)
            self.active, self.done = False, True

    @staticmethod
    def stamp() -> float:
        """Now on the profiler's clock, in seconds."""
        return time.time_ns() / 1e9


@dataclass
class Trace:
    calls: list            # (kind, start_s, end_s), profiler clock, sorted
    device: list           # (name, start_s, end_s), profiler clock, sorted
    per_call: list = field(default_factory=list)   # activities per call

    @property
    def span(self) -> tuple[float, float]:
        return self.calls[0][1], self.calls[-1][2]

    @property
    def window_s(self) -> float:
        a, b = self.span
        return b - a

    def busy_s(self, names=None, call: int | None = None) -> float:
        """Seconds in which some device activity ran: in the traced span,
        or in call ``call``; only activities whose name holds one of
        ``names``, if given."""
        evs = self.device if call is None else self.per_call[call]
        if names is not None:
            evs = [e for e in evs if any(n in e[0] for n in names)]
        lo, hi = self.span if call is None else self.calls[call][1:]
        return union_s([(max(a, lo), min(b, hi)) for _, a, b in evs
                        if b > lo and a < hi])


def union_s(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _raw_events(prof):
    """(name, on_device, start_ns, end_ns) of every profiled event."""
    from torch.autograd import DeviceType
    try:
        evs = prof.profiler.kineto_results.events()
        return [(e.name(), e.device_type() != DeviceType.CPU, e.start_ns(),
                 e.start_ns() + e.duration_ns()) for e in evs]
    except AttributeError:      # an older profiler: its parsed events
        return [(e.name, e.device_type != DeviceType.CPU,
                 e.time_range.start * 1000, e.time_range.end * 1000)
                for e in prof.events()]


def read(prof, calls) -> Trace | None:
    """The profile as a ``Trace`` of the traced ``calls``, (kind, start,
    end) on the profiler's clock; None if there are none."""
    if not calls:
        return None
    calls = sorted(calls, key=lambda c: c[1])
    device = sorted(((name, a / 1e9, b / 1e9) for name, on_device, a, b
                     in _raw_events(prof) if on_device),
                    key=lambda e: e[1])
    trace = Trace(calls, device, [[] for _ in calls])
    starts = [c[1] for c in calls]
    for e in device:
        mid = 0.5 * (e[1] + e[2])
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= calls[i][2]:
            trace.per_call[i].append(e)
    return trace


def inside_calls(trace: Trace) -> float:
    """Share of the traced span's device time that falls inside engine
    calls: 1 where the two clocks agree."""
    total = trace.busy_s()
    inside = sum(trace.busy_s(call=i) for i in range(len(trace.calls)))
    return inside / total if total else 0.0


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the traced span, and
    the idle time between them by what the host was doing (inside which
    kind of engine call, or in the batcher between calls)."""
    lo, hi = trace.span
    by_name: dict[str, float] = {}
    for name, a, b in trace.device:
        if b > lo and a < hi:
            by_name[name[:80]] = by_name.get(name[:80], 0.0) \
                + min(b, hi) - max(a, lo)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps: dict[str, float] = {}
    end = lo
    starts = [c[1] for c in trace.calls]
    merged = sorted((max(a, lo), min(b, hi)) for _, a, b in trace.device
                    if b > lo and a < hi)
    for a, b in merged + [(hi, hi)]:
        if a > end:
            gaps_add(gaps, trace, starts, end, a)
        end = max(end, b)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}


def gaps_add(gaps, trace, starts, a, b) -> None:
    """Split the idle interval (a, b) over the calls and the time between
    them, and add each part to its host activity."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    t = a
    while t < b:
        kind, c0, c1 = trace.calls[i] if i < len(trace.calls) else \
            ("", b, b)
        if t < c0:                      # between calls: the batcher
            u = min(b, c0)
            key = "host: batcher between engine calls"
        elif t < c1:
            u = min(b, c1)
            key = f"host: inside {kind} calls"
        else:
            i += 1
            continue
        gaps[key] = gaps.get(key, 0.0) + u - t
        t = u
