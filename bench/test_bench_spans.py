"""CPU tests of the readers of the program's host-clock spans
(``bench/spans.py``) and of the prefill calls' slot masks
(``metrics/prefill_rows_kept_pct.py``), on synthetic runs."""

from __future__ import annotations

import numpy as np
import pytest

from bench import spans as S
from bench.metrics import prefill_rows_kept_pct
from bench.trace import Trace
from bench.window import Call


class _Run:
    def __init__(self, calls):
        self.calls = calls


def _prefill(*kept):
    mask = np.zeros(4, bool)
    mask[list(kept)] = True
    return Call("prefill", 0.0, 1.0, mask=mask)


def test_prefill_rows_kept_pct_reads_the_program_counters():
    """A refill of 1 of 4 slots, a decode, a refill of 2 of 4: the masks
    keep 3 of the 8 rows the two prefills computed."""
    calls = [_prefill(1), Call("decode", 1.0, 2.0), _prefill(0, 2)]
    assert prefill_rows_kept_pct.read(_Run(calls)) == pytest.approx(37.5)
    assert prefill_rows_kept_pct.read(_Run(calls[:1])) == \
        pytest.approx(25.0)


def test_prefill_rows_kept_pct_is_silent_without_a_prefill():
    assert prefill_rows_kept_pct.read(_Run([])) is None
    assert prefill_rows_kept_pct.read(
        _Run([Call("decode", 0.0, 1.0)])) is None


def _tracer(calls):
    """A program tracer holding, per (kind, start, phase seconds, refit),
    an engine call span with its phases and, after it, a calibrator span
    of 2 ms (3 ms when it refit)."""
    from repro_torch.obs import Tracer
    tr = Tracer()
    for kind, t, phases, refit in calls:
        t0 = tr.at(t)
        total = sum(d for _, d in phases)
        tr.span("p", "engine", kind, t0, total, domain="wall_s",
                args={"seq": 1})
        for name, d in phases:
            tr.span("p", "engine", name, t0, d, domain="wall_s")
            t0 += d
        tr.span("p", "batcher", "calibrator", tr.at(t) + total,
                0.003 if refit else 0.002, domain="wall_s",
                args={"refit": refit, "samples": 8})
    return tr


DECODE = [("dispatch", 0.001), ("copy_in", 0.001), ("replay", 0.002),
          ("copy_out", 0.001), ("readback", 0.001), ("wait", 0.004)]


def test_span_readers_take_the_untraced_part():
    """Calls every 20 ms from t=100 s; the 3rd and 4th are traced, with
    phases twice as long, which the readers leave out."""
    base = 100.0
    spec, calls = [], []
    for i in range(8):
        t = base + 0.02 * i
        k = 2 if i in (2, 3) else 1
        spec.append(("decode", t, [(n, d * k) for n, d in DECODE],
                     i % 4 == 1))
        calls.append(Call("decode", t - 1e-4, t + 0.01 * k + 1e-4,
                          traced=k == 2))
    tr = _tracer(spec)
    every = S.spans(tr)
    assert [s.call for s in every[:8]] == [0] * 7 + [-1]
    window = S.untraced(every, calls, base)
    assert sum(s.name == "decode" for s in window) == 6
    assert S.decode_queue_ms(window) == pytest.approx(6.0)
    assert S.graph_replay_ms(window) == pytest.approx(2.0)
    # Refits after calls 1 and 5; call 1's reaches into the cut.
    assert S.calibrator_refit_ms(window) == pytest.approx(3.0)
    # On the profiler's clock through the epoch.
    s = every[0]
    assert s.u0 - s.t0 == pytest.approx(tr.epoch_unix_ns / 1e9 - tr.perf0)
    # A program without host-clock spans: every reader is silent.
    from repro_torch.obs import Tracer
    empty = S.untraced(S.spans(Tracer()), calls, base)
    assert S.calibrator_refit_ms(empty) is None
    assert S.decode_queue_ms(empty) is None
    assert S.graph_replay_ms(empty) is None


def test_idle_by_span_takes_the_innermost_span():
    """A call (0, 10) holding replay (2, 4) and wait (4, 9); the batcher's
    calibrator (10, 12); nothing in (12, 14).  The device runs (3, 5) and
    (6, 8), so idle is (0, 3), (5, 6), (8, 14)."""
    tr = Trace([("decode", 0.0, 14.0)], [("k", 3.0, 5.0), ("k", 6.0, 8.0)],
               [[]])

    def span(track, name, a, b):
        return S.Span(track, name, a, b, a, b, {})

    every = [span("engine", "decode", 0.0, 10.0),
             span("engine", "replay", 2.0, 4.0),
             span("engine", "wait", 4.0, 9.0),
             span("batcher", "calibrator", 10.0, 12.0),
             span("batcher", "plan", 13.0, 13.0)]     # empty: no piece
    got = dict(S.idle_by_span(tr, every))
    assert got == pytest.approx({"engine.decode": 3.0, "engine.replay": 1.0,
                                 "engine.wait": 2.0,
                                 "batcher.calibrator": 2.0, S.OUTSIDE: 2.0})
    assert sum(got.values()) == pytest.approx(14.0 - 4.0)
