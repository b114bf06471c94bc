"""The program's own host-clock spans, read against the window and the
device trace.

A serving run given a ``repro_torch.obs.Tracer`` (handed to
``ContinuousBatcher``, which hands it to its engine) records each engine
call (``decode``, ``prefill``) with its phases (``dispatch``, ``copy_in``,
``replay`` or ``capture``, ``copy_out``, ``readback``, ``wait``) on the
``engine`` track, and the batcher's phases (``admit``, ``plan``,
``calibrator``, ``place``) on the ``batcher`` track, all in the ``wall_s``
domain: seconds since the tracer's epoch, a ``time.perf_counter()``
reading (``Tracer.perf0``) taken together with ``time.time_ns()``
(``Tracer.epoch_unix_ns``).  ``spans`` turns them into ``Span``s on both
the harness's clock (``perf_counter``, which ``window.Call`` stamps) and
the profiler's (Unix seconds, which ``trace.Trace`` holds).

The readers take the untraced part of the window, as ``RunData.clean``
cuts it (``untraced``), and return None where there is nothing to read: a
program older than its host-clock spans records none.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass

CALL_KINDS = ("decode", "prefill")
#: The engine's host work on a call apart from waiting for the card.
QUEUE_PHASES = ("dispatch", "copy_in", "replay", "copy_out", "readback")
OUTSIDE = "host: outside program spans"


@dataclass(eq=False)
class Span:
    track: str
    name: str
    t0: float              # perf_counter seconds (the harness's clock)
    t1: float
    u0: float              # Unix seconds (the profiler's clock)
    u1: float
    args: dict
    call: int = -1         # index of the engine call span it belongs to

    @property
    def label(self) -> str:
        return f"{self.track}.{self.name}"

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


def spans(tracer) -> list[Span]:
    """The tracer's ``wall_s`` spans in recording order.  An engine call's
    phases follow its call span on its track (``_CallTrace.close``), and
    carry its index in ``call``."""
    epoch = tracer.epoch_unix_ns / 1e9
    out: list[Span] = []
    last_call: dict[str, int] = {}
    for e in tracer.events:
        if e.ph != "X" or e.domain != "wall_s":
            continue
        s = Span(e.track, e.name, tracer.perf0 + e.ts,
                 tracer.perf0 + e.ts + e.dur, epoch + e.ts,
                 epoch + e.ts + e.dur, e.args or {})
        if e.track.startswith("engine"):
            if e.name in CALL_KINDS:
                last_call[e.track] = len(out)
            s.call = last_call.get(e.track, -1)
        out.append(s)
    return out


def traced_cut(calls, t_start: float) -> tuple[float, float] | None:
    """The traced part of the window on the harness's clock, from the end
    of the call before the first traced call to the start of the call
    after the last (``RunData.clean``'s cut); None without one."""
    traced = [i for i, c in enumerate(calls) if c.traced]
    if not traced:
        return None
    i, j = traced[0], traced[-1]
    a = calls[i - 1].t1 if i > 0 else t_start
    b = calls[j + 1].t0 if j + 1 < len(calls) else calls[j].t1
    return a, b


def untraced(all_spans: list[Span], calls, t_start: float) -> list[Span]:
    """The spans that lie in the window and outside its traced part."""
    cut = traced_cut(calls, t_start)
    end = calls[-1].t1 if calls else t_start
    return [s for s in all_spans if s.t0 >= t_start and s.t1 <= end
            and (cut is None or s.t1 <= cut[0] or s.t0 >= cut[1])]


def _mean_ms(values) -> float | None:
    return statistics.fmean(values) * 1e3 if values else None


def calibrator_refit_ms(window: list[Span]) -> float | None:
    """Mean host ms of the batcher's ``calibrator`` spans that refit."""
    return _mean_ms([s.dur for s in window if s.label == "batcher.calibrator"
                     and s.args.get("refit")])


def decode_phases(window: list[Span], phases) -> list[float]:
    """Per decode call in ``window``, the seconds of its ``phases``."""
    per = {s.call: 0.0 for s in window if s.name == "decode"}
    for s in window:
        if s.name in phases and s.call in per:
            per[s.call] += s.dur
    return list(per.values())


def decode_queue_ms(window: list[Span]) -> float | None:
    """Mean host ms per decode call in dispatch, copies, replay and
    read-back: the engine's host work on the call apart from waiting."""
    return _mean_ms(decode_phases(window, QUEUE_PHASES))


def graph_replay_ms(window: list[Span]) -> float | None:
    """Mean host ms per decode call in ``replay``."""
    return _mean_ms(decode_phases(window, ("replay",)))


def idle_by_span(trace, all_spans: list[Span], top: int = 12) -> list:
    """The traced span's device-idle seconds, split by the innermost
    program span open at each moment (the one that started last), as
    ``[label, seconds]`` pairs, most first; idle time that no span covers
    is ``host: outside program spans``."""
    lo, hi = trace.span
    busy: list[list[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for _, a, b in trace.device
                       if b > lo and a < hi):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    # One sweep over the idle intervals' and the spans' edges, in time
    # order; at a tie, ends before starts.
    edges = []
    t = lo
    for a, b in busy + [[hi, hi]]:
        if a > t:
            edges += [(t, 1, 0, None), (a, 0, 0, None)]
        t = max(t, b)
    for s in all_spans:
        if s.u1 > max(lo, s.u0) and s.u0 < hi:
            edges += [(s.u0, 1, 1, s), (s.u1, 0, 1, s)]
    edges.sort(key=lambda e: (e[0], e[1]))
    out: dict[str, float] = {}
    active: list[Span] = []
    idle, prev = False, lo
    for t, is_start, is_span, s in edges:
        if idle and t > prev:
            key = max(active, key=lambda x: (x.u0, -x.u1)).label \
                if active else OUTSIDE
            out[key] = out.get(key, 0.0) + t - prev
        prev = t
        if not is_span:
            idle = bool(is_start)
        elif is_start:
            active.append(s)
        else:
            active.remove(s)
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])
            ][:top]
