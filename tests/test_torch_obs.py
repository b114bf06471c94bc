"""The port's observability layer against the reference, on the CPU.

A traced serving run through the port records the reference's events: the
Chrome-trace and JSON-lines exports are equal file for file, and the
residual trackers' summaries are equal.  The tracer primitives, the no-op
tracer and the JSON-lines reader behave as the reference's.
"""

from __future__ import annotations

import json

import pytest

from repro.obs import NULL as REF_NULL
from repro.obs import ResidualTracker as RefResidualTracker
from repro.obs import Tracer as RefTracer
from repro.obs import read_jsonl as ref_read_jsonl
from repro.obs import to_chrome as ref_to_chrome
from repro.obs import write_chrome_trace as ref_write_chrome_trace
from repro.obs import write_jsonl as ref_write_jsonl
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import WorkloadSpec as RefWorkloadSpec
from repro.serve import serve_workload as ref_serve_workload
from repro_torch.obs import (NULL, NullTracer, ResidualTracker, Tracer,
                             read_jsonl, to_chrome, write_chrome_trace,
                             write_jsonl)
from repro_torch.serve import ServeConfig, WorkloadSpec, serve_workload


def _record(tr):
    tr.span("f0:32c", "host", "dispatch", 10.0, 5.0, args={"job": 0})
    tr.span("f0:32c", "engine", "decode", 0.0, 0.003, domain="wall_s",
            args={"wall_s": 0.003})
    tr.instant("f0:32c", "scheduler", "admit", 11.0, args={"rid": 3})
    tr.counter("f0:32c", "slots", "slots_occupied", 12.0, 3)
    tr.flow_start("router", "routes", "route", 10.0, flow=7)
    tr.flow_end("f0:32c", "requests", "route", 12.0, flow=7)
    return tr


def test_tracer_primitives_match_reference(tmp_path):
    got, want = _record(Tracer()), _record(RefTracer())
    assert [e.as_dict() for e in got.events] == \
        [e.as_dict() for e in want.events]
    assert got.procs() == want.procs()
    assert got.lane_events("f0:32c") == want.lane_events("f0:32c")
    assert to_chrome(got) == ref_to_chrome(want)
    write_jsonl(got, tmp_path / "p.jsonl")
    ref_write_jsonl(want, tmp_path / "r.jsonl")
    assert read_jsonl(tmp_path / "p.jsonl") == \
        ref_read_jsonl(tmp_path / "r.jsonl")


def test_null_tracer_is_a_noop():
    assert isinstance(NULL, NullTracer)
    assert not NULL and not REF_NULL
    assert len(NULL) == 0 == len(REF_NULL)
    NULL.span("p", "t", "n", 0.0, 1.0)
    NULL.instant("p", "t", "n", 0.0)
    NULL.counter("p", "t", "n", 0.0, 1)
    NULL.flow_start("p", "t", "n", 0.0, flow=1)
    NULL.flow_end("p", "t", "n", 0.0, flow=1)
    assert len(NULL) == 0


def test_residual_tracker_matches_reference():
    got, want = ResidualTracker(window=8), RefResidualTracker(window=8)
    for i in range(20):
        lane = f"f{i % 2}:32c"
        kind = "prefill" if i % 3 else "decode"
        pred, act = 400.0 + 13 * i, 410.0 + 11 * i + (i % 5)
        a = got.observe(lane, kind, pred, act, t=float(i))
        b = want.observe(lane, kind, pred, act, t=float(i))
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.predicted, a.actual, a.ape_pct) == \
                (b.predicted, b.actual, b.ape_pct)
    assert got.lanes() == want.lanes()
    for lane in got.lanes():
        assert got.mape(lane) == want.mape(lane)
        assert got.series(lane, "prefill") == want.series(lane, "prefill")
    assert got.summary() == want.summary()
    assert got.format_summary() == want.format_summary()
    got.reset_lane("f0:32c")
    want.reset_lane("f0:32c")
    assert got.mape("f0:32c") == want.mape("f0:32c")
    assert got.mape("f1:32c") == want.mape("f1:32c")
    assert len(got) == len(want)


@pytest.mark.parametrize("cfg_kw", [
    {}, {"pipeline": True}, {"wave_boundary": True},
    {"faults": "stall@0:0.3+0.1,skew@0:0.5+0.2x1.5"},
    {"faults": "crash@0:0.6", "pipeline": True},
], ids=["continuous", "pipeline", "wave_boundary", "stall-skew", "crash"])
def test_traced_run_exports_match_reference(tmp_path, cfg_kw):
    spec = dict(num_requests=40, seed=1)
    tr, res = Tracer(), ResidualTracker()
    serve_workload(WorkloadSpec(**spec), config=ServeConfig(
        execute=False, tracer=tr, residuals=res, **cfg_kw))
    rtr, rres = RefTracer(), RefResidualTracker()
    ref_serve_workload(RefWorkloadSpec(**spec), config=RefServeConfig(
        execute=False, tracer=rtr, residuals=rres, **cfg_kw))
    assert len(tr) == len(rtr) > 0
    write_chrome_trace(tr, tmp_path / "p.json")
    ref_write_chrome_trace(rtr, tmp_path / "r.json")
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "r.json").read_text()
    write_jsonl(tr, tmp_path / "p.jsonl")
    ref_write_jsonl(rtr, tmp_path / "r.jsonl")
    assert (tmp_path / "p.jsonl").read_text() == \
        (tmp_path / "r.jsonl").read_text()
    assert res.summary() == rres.summary()
    assert res.format_summary() == rres.format_summary()
    chrome = json.loads((tmp_path / "p.json").read_text())
    assert chrome["traceEvents"]


def test_tracing_off_leaves_summary_unchanged():
    spec = WorkloadSpec(num_requests=24, seed=6)
    plain = serve_workload(spec, config=ServeConfig(execute=False))
    traced = serve_workload(spec, config=ServeConfig(
        execute=False, tracer=Tracer(), residuals=ResidualTracker()))
    assert json.dumps(plain["metrics"].summary(), sort_keys=True) == \
        json.dumps(traced["metrics"].summary(), sort_keys=True)


def test_cli_trace_files_match_reference(tmp_path, capsys):
    from repro.launch.serve import main as ref_main
    from repro_torch.launch.serve import main

    outs = {}
    for who, fn in (("p", main), ("r", ref_main)):
        fn(["--no-execute", "--requests", "16", "--pipeline",
            "--trace", str(tmp_path / f"{who}.json"),
            "--trace-jsonl", str(tmp_path / f"{who}.jsonl")])
        outs[who] = capsys.readouterr().out.replace(str(tmp_path / who),
                                                    "TRACE")
    assert outs["p"] == outs["r"]
    for ext in ("json", "jsonl"):
        assert (tmp_path / f"p.{ext}").read_text() == \
            (tmp_path / f"r.{ext}").read_text()
