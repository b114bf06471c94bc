"""The port's fleet (``repro_torch.serve.fleet``) against the reference, on
the CPU.

  * ``serve_fleet`` with ``execute=False``: for every router policy, both
    loops, the affinity layer, DVFS, the energy objectives and a crash
    under each recovery mode, the same route decisions,
    ``FleetMetrics.summary()``, per-lane summaries, calibration snapshots
    and request outcomes as the reference (``==``, no tolerance);
  * ``execute=True`` on reduced chatglm3-6b with the reference's weights
    carried across (``models.convert.params_from_numpy``): a ``(32, 8)``
    fleet, and the same fleet with lane 1 crashed and its decode state
    restored from its checkpoints, emit the reference's tokens for every
    request;
  * CI's trace-smoke and chaos-smoke commands through
    ``repro_torch.launch.serve``: the reference's stdout line for line, the
    same metrics and trace files, and ``tools/check_trace.py`` accepts the
    port's traces;
  * the fleet's config and keyword shim behave as the reference's, and
    the CLI refuses a wall-clock fabric for a fleet as the reference's
    does.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.launch.serve import main as ref_main
from repro.models import init_params as ref_init_params
from repro.models import scaled_down as ref_scaled_down
from repro.serve import FleetConfig as RefFleetConfig
from repro.serve import WorkloadSpec as RefWorkloadSpec
from repro.serve import serve_fleet as ref_serve_fleet
from repro_torch.launch.serve import main
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (RECOVERY_MODES, FleetConfig, WorkloadSpec,
                               serve_fleet)

REPO = Path(__file__).resolve().parent.parent
ARCH = "chatglm3-6b"


def _dump(x) -> str:
    """A canonical string of a nested value (NaN-safe equality)."""
    return json.dumps(x, sort_keys=True, default=repr)


def _outcome(out) -> dict:
    """Everything a fleet run decides, as plain values."""
    reqs = [(r.rid, r.state.value, r.reject_reason, r.t_admitted,
             r.t_first_token, r.t_done, r.slo_met, r.requeues,
             r.restore_len, r.preemptions, r.prefix_hit, r.prefix_handoff,
             r.priority)
            for r in out["requests"]]
    faults = out.get("faults")
    return {
        "routes": _dump([dataclasses.asdict(d) for d in out["routes"]]),
        "summary": _dump(out["metrics"].summary()),
        "format": out["metrics"].format_summary(),
        "lanes": _dump([lane["metrics"].summary() for lane in out["lanes"]]),
        "calibrations": _dump([dataclasses.asdict(s)
                               for s in out["calibrations"]]),
        "requests": _dump(reqs),
        "faults": None if faults is None else _dump(
            [dataclasses.asdict(e) for e in faults.events]),
        "recovery": _dump([out["recovery"], out["dropped"],
                           out["dead_lanes"], out["quarantined_lanes"]]),
    }


def _assert_same(got, ref) -> None:
    want, have = _outcome(ref), _outcome(got)
    for key in want:
        assert have[key] == want[key], key


# --------------------------------------------------------------------------- #
# (a) execute=False: the numpy fleet, bit-identical
# --------------------------------------------------------------------------- #
SPEC = dict(num_requests=64, rate_rps=2e6, gen_lens=(4, 16, 64), seed=7)
SIZES = (32, 8, 8)


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["continuous", "pipelined"])
@pytest.mark.parametrize("router", ["model", "rr", "lql"])
def test_fleet_no_execute_matches_reference(router, pipeline):
    kw = dict(fleet=SIZES, router=router, pipeline=pipeline)
    ref = ref_serve_fleet(RefWorkloadSpec(**SPEC), config=RefFleetConfig(**kw))
    got = serve_fleet(WorkloadSpec(**SPEC), config=FleetConfig(**kw))
    _assert_same(got, ref)
    assert got["metrics"].summary()["completed"] > 0
    assert got["sizes"] == ref["sizes"] and got["router"] == router


# (id, WorkloadSpec fields, FleetConfig fields)
OPTION_CASES = [
    ("affinity", {"turns": 3, "think_time_s": (0.0, 2e-5)},
     {"affinity": True}),
    ("dvfs-eco", {}, {"dvfs": "eco", "pipeline": True}),
    ("energy", {}, {"objective": "energy"}),
    ("edp", {}, {"objective": "edp", "dvfs": "turbo"}),
    ("tie-seed", {}, {"router": "lql", "tie_seed": 5}),
    ("skew-quarantine", {}, {"faults": "skew@1:0.3+0.5x1.5"}),
    ("tenants", {"tenants": 3,
                 "tenant_classes": ("premium", "standard", "batch")},
     {"priority": True, "preempt": True, "shed_depth": {2: 4, 1: 16}}),
] + [(f"crash-{mode}", {"rate_rps": 1.5e6, "slo_fraction": 0.5, "seed": 11},
      {"faults": "crash@1:0.45", "recovery": mode, "pipeline": True})
     for mode in RECOVERY_MODES]


@pytest.mark.parametrize("spec_kw,cfg_kw", [c[1:] for c in OPTION_CASES],
                         ids=[c[0] for c in OPTION_CASES])
def test_fleet_options_match_reference(spec_kw, cfg_kw):
    spec = {**SPEC, **spec_kw}
    kw = {"fleet": SIZES, **cfg_kw}
    ref = ref_serve_fleet(RefWorkloadSpec(**spec), config=RefFleetConfig(**kw))
    got = serve_fleet(WorkloadSpec(**spec), config=FleetConfig(**kw))
    _assert_same(got, ref)
    if "faults" in cfg_kw and cfg_kw["faults"].startswith("crash"):
        assert got["dead_lanes"] == [1]
        assert got["metrics"].summary()["faults"]["orphaned"] > 0


def test_fleet_config_fields_are_the_reference_s_and_the_port_s():
    ref_fields = {f.name: f.default
                  for f in dataclasses.fields(RefFleetConfig)}
    fields = {f.name: f.default for f in dataclasses.fields(FleetConfig)}
    assert {k: v for k, v in fields.items()
            if k not in ("device", "params")} == ref_fields
    assert fields["device"] == "cuda" and fields["params"] is None


def test_fleet_kwarg_shim_warns_and_matches_config():
    spec = dict(num_requests=24, seed=5)
    with pytest.warns(DeprecationWarning) as got_w:
        got = serve_fleet(WorkloadSpec(**spec), fleet=(16, 16), router="rr")
    with pytest.warns(DeprecationWarning) as ref_w:
        ref = ref_serve_fleet(RefWorkloadSpec(**spec), fleet=(16, 16),
                              router="rr")
    assert [str(w.message) for w in got_w] == [str(w.message) for w in ref_w]
    _assert_same(got, ref)
    with pytest.warns(DeprecationWarning), pytest.raises(TypeError):
        serve_fleet(WorkloadSpec(**spec), no_such_option=1)


def test_fleet_refuses_what_the_port_cannot_serve():
    # mesh_shape goes to the engines, as in the reference: without engines
    # it changes nothing, and engines on a (2, 1) mesh need a process group.
    spec = WorkloadSpec(num_requests=8)
    two = serve_fleet(spec, config=FleetConfig(mesh_shape=(2, 1)))
    one = serve_fleet(spec, config=FleetConfig())
    assert json.dumps(two["metrics"].summary(), sort_keys=True) == \
        json.dumps(one["metrics"].summary(), sort_keys=True)
    with pytest.raises(RuntimeError, match="process group"):
        serve_fleet(spec, config=FleetConfig(mesh_shape=(2, 1), execute=True,
                                             device="cpu"))
    # execute=False never resolves the device (there is no card here).
    out = serve_fleet(WorkloadSpec(num_requests=8),
                      config=FleetConfig(fleet=(32, 8), device="cuda"))
    assert out["metrics"].summary()["submitted"] == 8


# --------------------------------------------------------------------------- #
# (b) execute=True: one port engine per lane emits the reference's tokens
# --------------------------------------------------------------------------- #
# A trace on which the (32, 8) fleet's lane 1 crashes with two requests in
# decode at its last checkpoint: both resume on lane 0 from the checkpoint.
EXEC_SPEC = dict(num_requests=6, prompt_lens=(128,), gen_lens=(4, 8, 16),
                 rate_rps=1.5e6, slo_fraction=0.5, seed=11)
EXEC_RUNS = {"fault-free": {},
             "restore": {"faults": "crash@1:0.6", "recovery": "restore"}}


@pytest.fixture(scope="module")
def ref_params():
    cfg = ref_scaled_down(ref_get_config(ARCH))
    params = ref_init_params(jax.random.key(0), cfg)   # param_seed 0
    return jax.tree.map(np.asarray, params)


def _tokens(out) -> dict:
    return {r.rid: r.generated for r in out["requests"]
            if r.state.value == "done"}


@pytest.mark.parametrize("run", list(EXEC_RUNS))
def test_fleet_execute_emits_reference_tokens(ref_params, run):
    kw = dict(fleet=(32, 8), arch=ARCH, reduced=True, execute=True,
              **EXEC_RUNS[run])
    ref = ref_serve_fleet(RefWorkloadSpec(**EXEC_SPEC),
                          config=RefFleetConfig(**kw))
    got = serve_fleet(WorkloadSpec(**EXEC_SPEC), config=FleetConfig(
        device="cpu", params=params_from_numpy(ref_params, "cpu"), **kw))
    want, have = _tokens(ref), _tokens(got)
    assert have.keys() == want.keys() and len(want) > 0
    for rid in want:
        np.testing.assert_array_equal(have[rid], want[rid], err_msg=str(rid))
    # Routing is a cycle-model decision: the engines change no route.
    assert _outcome(got)["routes"] == _outcome(ref)["routes"]
    assert _outcome(got)["requests"] == _outcome(ref)["requests"]
    for lane, ref_lane in zip(got["lanes"], ref["lanes"]):
        assert lane["metrics"].decode_jobs == ref_lane["metrics"].decode_jobs
    engines = [lane.engine for lane in got["fleet"].lanes]
    assert all(e is not None and e.device.type == "cpu" for e in engines)
    assert engines[0].params is engines[1].params     # one shared tree
    if run == "restore":
        restored = [r for r in got["requests"] if r.restore_len > 0]
        assert got["dead_lanes"] == [1] and len(restored) >= 1
        assert got["metrics"].summary()["faults"]["restore_jobs"] >= 1


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_decode_write_past_the_cache_is_dropped(ref_params, fused):
    """A restored request resumes one position further on than a prefilled
    one, so when the trace's longest request is restored its freed slot
    keeps a length of ``max_len``; the next decode step's write for that
    empty row lies past the cache.  The reference's scatter drops it; so
    must the port's plain paths (the CUDA kernel drops it too), on the
    reference's tokens for every row."""
    from repro.serve import ServingEngine as RefServingEngine
    from repro_torch.serve import ServingEngine

    max_len = 12
    tokens = np.random.default_rng(0).integers(0, 128, (2, 8), np.int32)
    lens = np.array([max_len, 8], np.int32)
    tok = np.array([[3], [5]], np.int32)
    mask = np.ones(2, bool)
    ref = RefServingEngine(ARCH, reduced=True, max_batch=2, max_len=max_len)
    port = ServingEngine(ARCH, reduced=True, max_batch=2, max_len=max_len,
                         fused_decode=fused, device="cpu",
                         params=params_from_numpy(ref_params, "cpu"))
    outs = []
    for eng in (ref, port):
        _, caches, _ = eng.prefill_into_slots(tokens, eng.init_caches(), mask)
        nxt = []
        for step in range(2):
            t, caches, _ = eng.decode(tok, caches, lens + np.array([0, step]))
            nxt.append(np.asarray(t).tolist())
        outs.append(nxt)
    assert outs[1] == outs[0]


# --------------------------------------------------------------------------- #
# (c) the CLI: CI's trace-smoke and chaos-smoke steps, and --fleet 32,8
# --------------------------------------------------------------------------- #
SMOKE = ["--no-execute", "--pipeline", "--fleet", "32,8,8", "--requests",
         "96", "--trace", "trace_smoke.json", "--trace-jsonl",
         "trace_smoke.jsonl", "--metrics-json", "metrics_smoke.json"]
CHAOS = ["--no-execute", "--pipeline", "--fleet", "32,8,8", "--requests",
         "96", "--rate", "1.5e6", "--slo-fraction", "0.5", "--seed", "11",
         "--faults", "crash@1:0.45", "--recovery", "restore", "--trace",
         "trace_chaos.json", "--metrics-json", "metrics_chaos.json"]


@pytest.mark.parametrize("argv", [SMOKE, CHAOS], ids=["trace-smoke",
                                                      "chaos-smoke"])
def test_ci_smoke_commands_match_reference(argv, tmp_path, monkeypatch,
                                           capsys):
    outs = {}
    for who, fn in (("ref", ref_main), ("port", main)):
        (tmp_path / who).mkdir()
        monkeypatch.chdir(tmp_path / who)
        fn(argv)
        outs[who] = capsys.readouterr().out
    assert outs["port"] == outs["ref"]
    assert "router [model] over fleet 32+8+8" in outs["port"]
    files = [a for a in argv if a.endswith((".json", ".jsonl"))]
    for name in files:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name
    traces = [str(tmp_path / "port" / n) for n in files
              if n.startswith("trace") and n.endswith(".json")]
    res = subprocess.run([sys.executable, str(REPO / "tools" /
                                              "check_trace.py"), *traces],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    if "--faults" in argv:
        assert "dead lanes [1]" in outs["port"]


def test_cli_fleet_refuses_the_wallclock_fabric():
    with pytest.raises(SystemExit, match="simulated cycle domain only"):
        main(["--no-execute", "--fleet", "32,8", "--fabric", "wallclock"])
