"""Host-clock spans of the port's serving path, on the CPU.

With a tracer and a real engine, each engine call is a span on the host
clock holding its phases in order; the batcher records its admission,
plan, calibrator and bookkeeping phases; the tracer's epoch maps those
spans onto ``time.time_ns``.
Tracing changes no token and no count, and a CLI trace with an engine
passes ``tools/check_trace.py``.
"""

from __future__ import annotations

import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest

from repro_torch.obs import Tracer
from repro_torch.serve import ServeConfig, WorkloadSpec, serve_workload
from repro_torch.serve.batcher import ServingEngine
from repro_torch.serve.calibrator import OnlineCalibrator
from repro_torch.serve.metrics import ServeMetrics

REPO = Path(__file__).resolve().parents[1]
PHASES = ["dispatch", "copy_in", "replay", "copy_out", "readback", "wait"]
FIRST = ["dispatch", "capture", "readback", "wait"]


def _engine(max_batch=4):
    return ServingEngine("chatglm3-6b", reduced=True, max_batch=max_batch,
                         max_len=24, device="cpu")


def _calls(tr, track="engine"):
    """(call span, [its phases]) in recording order."""
    out = []
    for e in tr.events:
        if e.ph != "X" or e.domain != "wall_s" or e.track != track:
            continue
        if e.name in ("decode", "prefill"):
            out.append((e, []))
        else:
            out[-1][1].append(e)
    return out


def _drive(engine, metrics=None):
    """A slot prefill of row 1 of 4, two decodes, a refill of rows 0, 2."""
    caches = engine.init_caches()
    walls = []
    mask = np.array([False, True, False, False])
    tokens = np.ones((4, 8), np.int32)
    nxt, caches, w = engine.prefill_into_slots(tokens, caches, mask, metrics)
    walls.append(w)
    lens = np.array([0, 8, 0, 0], np.int32)
    for _ in range(2):
        nxt, caches, w = engine.decode(nxt[:, None], caches, lens)
        walls.append(w)
        lens[1] += 1
    mask = np.array([True, False, True, False])
    nxt, caches, w = engine.prefill_into_slots(tokens, caches, mask, metrics)
    walls.append(w)
    return walls


@pytest.fixture(scope="module")
def traced():
    engine = _engine()
    tr = Tracer()
    engine.trace_to(tr, "lane")
    metrics = ServeMetrics()
    before = time.time_ns() / 1e9
    walls = _drive(engine, metrics)
    after = time.time_ns() / 1e9
    return tr, walls, metrics, before, after


def test_engine_calls_hold_their_phases_in_order(traced):
    tr = traced[0]
    calls = _calls(tr)
    assert [c.name for c, _ in calls] == ["prefill", "decode", "decode",
                                          "prefill"]
    # A key's first call is its capture; later calls of it replay.
    assert [[p.name for p in ph] for _, ph in calls] == \
        [FIRST, FIRST, PHASES, PHASES]
    for call, phases in calls:
        end = call.ts + call.dur
        prev = call.ts
        for p in phases:
            assert p.ts >= prev - 1e-9 and p.dur >= 0
            prev = p.ts + p.dur
        assert prev <= end + 1e-9
        assert sum(p.dur for p in phases) <= call.dur + 1e-9
    capture = [p for _, ph in calls for p in ph if p.name == "capture"]
    assert all(p.args["capture_s"] == 0.0 for p in capture)   # no graph
    assert calls[2][0].args["key"] == [[4, 1], [4]]
    assert [c.args["seq"] for c, _ in calls] == [1, 2, 3, 4]
    assert calls[0][0].args["step"] == "slot_prefill[8]"


def test_wall_s_is_its_parts_and_the_spans_carry_them(traced):
    tr, walls = traced[:2]
    calls = _calls(tr)
    for (call, phases), wall in zip(calls, walls):
        a = call.args
        assert a["wall_s"] == wall == \
            a["dispatch_s"] + a["launch_s"] + a["wait_s"]
        by = {p.name: p for p in phases}
        # The launch's phases lie inside its measured seconds; the wait
        # and, for a prefill, the dispatch hold theirs.
        inside = [p for p in phases
                  if p.name not in ("dispatch", "wait")]
        assert inside[-1].ts + inside[-1].dur - inside[0].ts <= \
            a["launch_s"] + 1e-9
        assert by["wait"].dur >= a["wait_s"]
        assert by["dispatch"].dur >= a["dispatch_s"]
    assert calls[1][0].args["dispatch_s"] == 0.0     # decode: untimed put


def test_the_epoch_maps_the_host_clock_onto_unix_time(traced):
    tr, _, _, before, after = traced
    assert abs(tr.epoch_unix_ns / 1e9 + tr.now() - time.time_ns() / 1e9) \
        < 1e-3
    calls = _calls(tr)
    first = tr.epoch_unix_ns / 1e9 + calls[0][0].ts
    last = tr.epoch_unix_ns / 1e9 + calls[-1][0].ts + calls[-1][0].dur
    assert before - 1e-3 <= first and last <= after + 1e-3


def test_row_counters_for_a_refill_of_one_of_four_slots(traced):
    tr = traced[0]
    calls = _calls(tr)
    assert (calls[0][0].args["rows_computed"],
            calls[0][0].args["rows_kept"]) == (4, 1)
    assert (calls[3][0].args["rows_computed"],
            calls[3][0].args["rows_kept"]) == (4, 2)
    assert "rows_kept" not in calls[1][0].args


def test_each_call_records_the_cache_bytes_it_moves(traced):
    """``state_bytes``: a prefill writes every row it computes at its
    length, a decode step reads each row's keys and values below its
    length and writes one position (``models.cache_bytes``)."""
    from repro_torch.models import cache_bytes
    tr = traced[0]
    cfg = _engine().cfg
    calls = _calls(tr)
    assert calls[0][0].args["state_bytes"] == \
        cache_bytes(cfg, [0] * 4, 8) > 0
    assert calls[1][0].args["state_bytes"] == \
        cache_bytes(cfg, [0, 8, 0, 0], 1)
    per = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.qk_head_dim * 4
    assert calls[1][0].args["state_bytes"] == per * (8 + 4)


def test_an_untraced_engine_records_nothing():
    engine = _engine()
    tr = Tracer()
    engine.trace_to(tr, "lane")
    engine.trace_to(None)
    _drive(engine)
    assert len(tr) == 0 and not tr.host_stamped
    assert all(s.marks is None for s in engine.compiled_steps())


def _serve(tracer=None, calibrator=None, **kw):
    spec = WorkloadSpec(num_requests=8, seed=3)
    return serve_workload(spec, config=ServeConfig(
        arch="chatglm3-6b", device="cpu", tracer=tracer,
        calibrator=calibrator, **kw))


def _same(out):
    s = out["metrics"].summary()
    for k in ("step_p50_ms", "step_total_s", "dispatch_total_s"):
        s["wall"].pop(k)          # the host's own seconds, run to run
    return (json.dumps(s, sort_keys=True),
            [(r.rid, None if r.generated is None else r.generated.tolist())
             for r in out["requests"]])


@pytest.mark.parametrize("loop", [{}, {"pipeline": True},
                                  {"wave_boundary": True}],
                         ids=["continuous", "pipeline", "wave_boundary"])
def test_tracing_changes_no_token_and_no_count(loop):
    tr, cal = Tracer(), OnlineCalibrator(refit_interval=2, min_samples=2)
    traced = _serve(tr, cal, **loop)
    plain = _serve(calibrator=OnlineCalibrator(refit_interval=2,
                                               min_samples=2), **loop)
    assert _same(plain) == _same(traced)
    m = traced["metrics"]
    wall = [e for e in tr.events if e.domain == "wall_s"]
    names = {(e.track, e.name) for e in wall}
    assert {("batcher", n) for n in ("admit", "plan", "calibrator",
                                     "place")} <= names
    # Host-clock spans only: no instant, no counter.
    assert {e.ph for e in wall} == {"X"}
    prefills = [e for e in wall if e.name == "prefill"]
    assert prefills and all(e.args["rows_computed"] == 4 for e in prefills)
    if not loop:     # the slot prefills place each request once
        assert sum(e.args["rows_kept"] for e in prefills) == m.completed
    # The calibrator spans mark each entry into a refit, and the window.
    cspans = [e for e in wall if e.name == "calibrator"]
    assert sum(e.args["refit"] for e in cspans) == cal.refit_checks > 0
    assert [e.args["samples"] for e in cspans] == \
        list(range(1, len(cspans) + 1))
    # Calls on one track never overlap; nothing lands on a serial track.
    for track in {e.track for e in wall}:
        assert track not in ("host", "fabric")
        spans = sorted((e.ts, e.ts + e.dur) for e in wall
                       if e.track == track and e.name in ("decode",
                                                          "prefill"))
        assert all(b <= c + 1e-9 for (_, b), (c, _) in zip(spans,
                                                            spans[1:]))


def test_cli_trace_with_an_engine_passes_check_trace(tmp_path, capsys):
    from repro_torch.launch.serve import main
    spec = importlib.util.spec_from_file_location(
        "check_trace", REPO / "tools" / "check_trace.py")
    check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check)
    path = tmp_path / "t.json"
    main(["--arch", "chatglm3-6b", "--device", "cpu", "--requests", "6",
          "--fabric", "wallclock", "--trace", str(path)])
    capsys.readouterr()
    assert check.check_trace(path) == []
    doc = json.loads(path.read_text())
    assert doc["otherData"]["wall_epoch_unix_ns"] > 0
    procs = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert {"f0:32c", "wall:f0:32c"} <= procs
