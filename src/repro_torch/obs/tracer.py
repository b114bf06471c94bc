"""Low-overhead structured tracer for the offload serving stack.

The port of ``repro/obs/tracer.py``.  Its cycle-domain events, and every
export of a trace with no host-clock stamp, are bit-identical to the
reference's on the same inputs; the host clock's epoch (``now``, ``at``,
``epoch_unix_ns``) is the port's own.

The paper's claim is that offloaded runtime can be *modeled* (Eq. 1, ≤1%
MAPE); PRs 4-5 plan against that model at three layers (engine phase
timelines, Eq.-3 scheduler, fleet router).  This module is the observation
side: a span/instant/counter event recorder threaded through the engine,
batcher, scheduler, calibrator, and router, so every prediction the system
acts on can later be laid next to what actually happened (DESIGN.md §9).

Event model
-----------

Events live on **tracks**: a ``(proc, track)`` pair, where ``proc`` groups
the tracks of one component (a fabric lane like ``"f0:32c"``, or the
``"router"``) and ``track`` names one serial resource or event stream inside
it (``"host"``, ``"fabric"``, ``"sync"``, ``"jobs"``, ``"requests"``, ...).
The Chrome-trace exporter (repro_torch.obs.export) maps procs to processes and
tracks to threads, so Perfetto renders one swim-lane per resource.

Three event shapes:

  * ``span(...)``   — a complete interval (Chrome phase ``"X"``): engine
    dispatch/exec/sync phases, batcher jobs, request queue residency;
  * ``instant(...)``— a point event (``"i"``): admissions, route decisions,
    calibrator refits, residual observations;
  * ``counter(...)``— a sampled value (``"C"``): slot occupancy, queue depth.

``flow_start``/``flow_end`` emit Chrome flow events (``"s"``/``"f"``) that
visually link a route decision to the prefill execution it caused; the flow
id is the request id.

Two time domains (DESIGN.md §9): ``domain="cycles"`` is the fabric-cycle
virtual clock the scheduler plans in (at the paper's 1 GHz, cycles == ns);
``domain="wall_s"`` is the host clock.  A ``Tracer`` reads
``time.perf_counter()`` and ``time.time_ns()`` together once, when it is
built: that is the host clock's epoch.  :meth:`Tracer.now` gives host
seconds since it, and :meth:`Tracer.at` turns a ``perf_counter`` reading
the caller already made into the same clock, so ``epoch_unix_ns / 1e9 +
ts`` places a ``wall_s`` event on the Unix clock that ``torch.profiler``
stamps device activity on.  With a real engine attached, the serving
stack records its engine calls (dispatch, input copies, graph replay,
output copies, read-back, wait) and the batcher's phases (admission,
plan, calibrator, slot bookkeeping) on that clock.  The cycle domain has
no such epoch, so the exporter keeps the two domains in separate process
groups, never on one axis.

Overhead budget: tracing defaults to **off** — every instrumentation site
guards with ``if tracer is not None`` (or holds the shared :data:`NULL`
no-op whose methods return immediately), so the disabled cost is one
attribute check per event site and no clock read.  Enabled cost is one
dataclass append per event (and a clock read per host-clock stamp);
exporters do all formatting after the run.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

#: The tracer's two time domains (DESIGN.md §9).
TIME_DOMAINS = ("cycles", "wall_s")


@dataclass
class TraceEvent:
    """One recorded event; exporters translate to Chrome/JSONL records."""

    ph: str                    # "X" span | "i" instant | "C" counter
    #                          # | "s"/"f" flow start/end
    name: str
    proc: str                  # process-level track group (e.g. a lane)
    track: str                 # serial resource / stream within the proc
    ts: float                  # start time in the event's domain
    dur: float = 0.0           # span length ("X" only)
    domain: str = "cycles"     # "cycles" | "wall_s"
    args: dict | None = None   # payload shown in the Perfetto side panel
    flow: int | None = None    # flow id ("s"/"f" only; request rid)

    def as_dict(self) -> dict:
        d = {"ph": self.ph, "name": self.name, "proc": self.proc,
             "track": self.track, "ts": self.ts, "domain": self.domain}
        if self.ph == "X":
            d["dur"] = self.dur
        if self.args:
            d["args"] = self.args
        if self.flow is not None:
            d["flow"] = self.flow
        return d


class Tracer:
    """In-memory structured event recorder (spans + instants + counters)."""

    enabled = True

    def __init__(self):
        self.events: list[TraceEvent] = []
        # The host clock's epoch: one perf_counter reading, taken around
        # the Unix clock's, and that Unix time in ns.
        a = time.perf_counter()
        self.epoch_unix_ns = time.time_ns()
        self.perf0 = 0.5 * (a + time.perf_counter())
        #: True once an event was stamped on the host clock (now/at).
        self.host_stamped = False

    def now(self) -> float:
        """Host seconds since the epoch (the ``wall_s`` domain's clock)."""
        self.host_stamped = True
        return time.perf_counter() - self.perf0

    def at(self, perf_s: float) -> float:
        """A ``time.perf_counter()`` reading on the host clock."""
        self.host_stamped = True
        return perf_s - self.perf0

    def __bool__(self) -> bool:  # ``if tracer:`` guards stay truthy
        return True

    def __len__(self) -> int:
        return len(self.events)

    # ------------------------------------------------------------------ #
    def span(self, proc: str, track: str, name: str, ts: float, dur: float,
             *, domain: str = "cycles", args: dict | None = None) -> None:
        """A complete interval [ts, ts+dur) on one track."""
        self.events.append(TraceEvent("X", name, proc, track, ts, dur,
                                      domain, args))

    def instant(self, proc: str, track: str, name: str, ts: float, *,
                domain: str = "cycles", args: dict | None = None) -> None:
        self.events.append(TraceEvent("i", name, proc, track, ts, 0.0,
                                      domain, args))

    def counter(self, proc: str, track: str, name: str, ts: float,
                value: float, *, domain: str = "cycles") -> None:
        self.events.append(TraceEvent("C", name, proc, track, ts, 0.0,
                                      domain, {"value": float(value)}))

    def flow_start(self, proc: str, track: str, name: str, ts: float,
                   flow: int, *, domain: str = "cycles") -> None:
        """Open a flow arrow (e.g. a route decision); close with
        :meth:`flow_end` under the same ``flow`` id."""
        self.events.append(TraceEvent("s", name, proc, track, ts, 0.0,
                                      domain, None, flow))

    def flow_end(self, proc: str, track: str, name: str, ts: float,
                 flow: int, *, domain: str = "cycles") -> None:
        self.events.append(TraceEvent("f", name, proc, track, ts, 0.0,
                                      domain, None, flow))

    # ------------------------------------------------------------------ #
    def lane_events(self, proc: str) -> list[tuple]:
        """Comparable event tuples of one proc, flow linkage excluded.

        The fleet identity tests use this: a 1x32 fleet lane must be
        event-identical to the single-fabric path *modulo the routing
        layer* — the router proc and the flow binds it injects are the only
        legitimate difference (DESIGN.md §9).
        """
        return [
            (e.ph, e.name, e.track, e.ts, e.dur, e.domain,
             tuple(sorted(e.args.items())) if e.args else None)
            for e in self.events
            if e.proc == proc and e.ph not in ("s", "f")
        ]

    def procs(self) -> list[str]:
        seen: dict[str, None] = {}
        for e in self.events:
            seen.setdefault(e.proc)
        return list(seen)


class NullTracer:
    """Zero-cost default: every method is a no-op and ``bool()`` is False,
    so hot paths may either call through or skip with ``if tracer:``."""

    enabled = False
    events: list = []
    epoch_unix_ns = 0
    perf0 = 0.0
    host_stamped = False

    def __bool__(self) -> bool:
        return False

    def __len__(self) -> int:
        return 0

    def now(self) -> float:
        return 0.0

    def at(self, perf_s: float) -> float:
        return 0.0

    def span(self, *a, **k) -> None:
        pass

    def instant(self, *a, **k) -> None:
        pass

    def counter(self, *a, **k) -> None:
        pass

    def flow_start(self, *a, **k) -> None:
        pass

    def flow_end(self, *a, **k) -> None:
        pass


#: Shared no-op instance — components store this when no tracer is attached.
NULL = NullTracer()
