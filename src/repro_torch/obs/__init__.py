"""Offload-aware observability: tracing + drift telemetry (DESIGN.md §9).

The port of ``repro/obs/__init__.py``: its results are bit-identical to
the reference's on the same inputs, and it adds a host clock with an epoch
(``tracer.Tracer.now``) on which a run with a real engine records its
engine calls and batcher phases.

    tracer.Tracer / tracer.NULL    -> span/instant/counter recorder with
                                      a host clock (``now``) whose epoch
                                      maps onto ``time.time_ns``; the
                                      shared no-op default keeps disabled
                                      tracing at one branch per event site
    export.write_chrome_trace      -> Perfetto-loadable Chrome Trace Event
                                      JSON (one track per host/fabric/lane,
                                      request flows route -> execution)
    export.write_jsonl             -> raw machine-readable event log
    residual.ResidualTracker       -> predicted-vs-actual pairing with
                                      windowed per-lane MAPE series (the
                                      drift signal, ROADMAP item 5)

Instrumented layers: ``core.engine`` (per-job dispatch/exec/sync phase
spans, host vs fabric tracks), ``serve.batcher`` (request lifecycle, job
spans, occupancy counters; with a real engine, host-clock spans of each
engine call and its phases, and of admission, plan, calibrator and
slot bookkeeping), ``serve.scheduler`` (plan/admission instants),
``serve.calibrator`` (refit events with before/after coefficients), and
``serve.fleet`` (route decisions with per-lane scores + Eq.-3 verdicts,
flow-linked to the execution they caused).  Capture with
``python -m repro_torch.launch.serve --trace out.json``; inspect with
``tools/trace_report.py``; validate with ``tools/check_trace.py``.
"""

from .export import (read_jsonl, to_chrome, write_chrome_trace,  # noqa: F401
                     write_jsonl)
from .residual import Residual, ResidualTracker  # noqa: F401
from .tracer import NULL, NullTracer, TraceEvent, Tracer  # noqa: F401

__all__ = [
    "NULL", "NullTracer", "Residual", "ResidualTracker", "TraceEvent",
    "Tracer", "read_jsonl", "to_chrome", "write_chrome_trace", "write_jsonl",
]
