"""The port's streaming serving path against the reference, on the CPU.

  * ``serve_workload`` with ``execute=False``: the same ``metrics.summary()``,
    admissions, plans, calibration and request outcomes as the reference on
    every workload family, loop, fault kind and tenancy option;
  * ``execute=True`` on reduced chatglm3-6b with the reference's weights
    carried across: the same per-request tokens in the continuous,
    ``wave_boundary`` and pipelined loops, fused and unfused; on reduced
    qwen3-moe-30b-a3b and mamba2-370m, the CLI's trace at 8 requests gives
    the reference's summary, schedule and tokens;
  * the discrete-event ``OffloadEngine`` and ``fit_pipelined_from_engine``
    are bit-identical to the reference's;
  * the streaming CLI prints what the reference's prints, and so does its
    ``--fleet`` mode;
  * the port's serving modules import neither ``jax`` nor ``repro``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.core import engine as ref_eng
from repro.core import runtime_model as ref_rm
from repro.core import simulator as ref_sim
from repro.launch.serve import main as ref_main
from repro.models import init_params as ref_init_params
from repro.models import scaled_down as ref_scaled_down
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import WorkloadSpec as RefWorkloadSpec
from repro.serve import serve_workload as ref_serve_workload
from repro.serve import synthetic_workload as ref_synthetic_workload
from repro_torch.core import engine as eng
from repro_torch.core import runtime_model as rm
from repro_torch.core import simulator as sim
from repro_torch.launch.serve import main
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (RequestState, ServeConfig, WorkloadSpec,
                               serve_workload, synthetic_workload)

REPO = Path(__file__).resolve().parent.parent
ARCH = "chatglm3-6b"


def _dump(x) -> str:
    """A canonical string of a nested value (NaN-safe equality)."""
    return json.dumps(x, sort_keys=True, default=repr)


def _outcome(out) -> dict:
    """Everything a run decides, as plain values."""
    reqs = [(r.rid, r.state.value, r.reject_reason, r.t_admitted,
             r.t_first_token, r.t_done, r.slo_met, r.requeues,
             r.preemptions, r.prefix_hit, r.prefix_handoff, r.priority)
            for r in out["requests"]]
    faults = out.get("faults")
    return {
        "summary": _dump(out["metrics"].summary()),
        "format": out["metrics"].format_summary(),
        "admissions": _dump([dataclasses.asdict(a)
                             for a in out["admissions"]]),
        "plans": _dump([dataclasses.asdict(p) for p in out["plans"]]),
        "calibration": _dump(dataclasses.asdict(out["calibration"])),
        "requests": _dump(reqs),
        "faults": None if faults is None else _dump(
            [dataclasses.asdict(e) for e in faults.events]),
    }


# --------------------------------------------------------------------------- #
# (a) execute=False: the numpy serving stack, bit-identical
# --------------------------------------------------------------------------- #
# (id, WorkloadSpec fields, ServeConfig fields)
NO_EXECUTE_CASES = [
    ("default", {}, {}),
    ("wave_boundary", {}, {"wave_boundary": True}),
    ("pipeline", {}, {"pipeline": True}),
    ("gamma", {"arrival": "gamma", "cv": 3.0}, {}),
    ("mmpp", {"arrival": "mmpp"}, {"pipeline": True}),
    ("lognormal", {"length_dist": "lognormal"}, {}),
    ("zipf", {"length_dist": "zipf"}, {"wave_boundary": True}),
    ("stall", {}, {"faults": "stall@0:0.5+0.1"}),
    ("skew", {}, {"faults": "skew@0:0.3+0.5x1.5"}),
    ("crash", {}, {"faults": "crash@0:0.45"}),
    ("crash-pipeline", {}, {"faults": "crash@0:0.45", "pipeline": True}),
    ("random-faults", {}, {"faults": "random:3"}),
    ("sessions-affinity", {"turns": 3, "think_time_s": (0.0, 2e-5)},
     {"affinity": True}),
    ("tenants", {"rate_rps": 2e6, "tenants": 3,
                 "tenant_classes": ("premium", "standard", "batch")},
     {"priority": True, "preempt": True, "shed_depth": {2: 4, 1: 16}}),
    ("simulated-dvfs", {}, {"fabric": "simulated", "dvfs": "eco"}),
]


@pytest.mark.parametrize("spec_kw,cfg_kw",
                         [c[1:] for c in NO_EXECUTE_CASES],
                         ids=[c[0] for c in NO_EXECUTE_CASES])
def test_no_execute_matches_reference(spec_kw, cfg_kw):
    ref = ref_serve_workload(RefWorkloadSpec(**spec_kw),
                             config=RefServeConfig(execute=False, **cfg_kw))
    got = serve_workload(WorkloadSpec(**spec_kw),
                         config=ServeConfig(execute=False, **cfg_kw))
    want = _outcome(ref)
    have = _outcome(got)
    for key in want:
        assert have[key] == want[key], key
    assert got["metrics"].completed > 0


def test_no_execute_never_touches_a_device():
    # device="cuda" on a machine without a card: nothing resolves it.
    out = serve_workload(WorkloadSpec(num_requests=8),
                         config=ServeConfig(execute=False, device="cuda"))
    assert out["metrics"].submitted == 8


def test_unported_options_raise():
    from repro.dse import DesignPoint as RefDesignPoint
    from repro_torch.dse import DesignPoint

    # mesh_shape goes to the engine: without one it changes nothing, and an
    # engine on a (2, 1) mesh needs a torch.distributed process group.
    spec = WorkloadSpec(num_requests=8)
    two = serve_workload(spec, config=ServeConfig(execute=False,
                                                  mesh_shape=(2, 1)))
    one = serve_workload(spec, config=ServeConfig(execute=False))
    assert _dump(two["metrics"].summary()) == _dump(one["metrics"].summary())
    with pytest.raises(RuntimeError, match="process group"):
        serve_workload(spec, config=ServeConfig(mesh_shape=(2, 1),
                                                device="cpu"))
    # A swept design point is served on the simulated fabric only, with the
    # reference's error.
    with pytest.raises(ValueError) as ref_exc:
        ref_serve_workload(config=RefServeConfig(
            execute=False, fabric="wallclock",
            design=RefDesignPoint(dispatch="multicast", sync="credit")))
    with pytest.raises(ValueError) as exc:
        serve_workload(config=ServeConfig(
            execute=False, fabric="wallclock",
            design=DesignPoint(dispatch="multicast", sync="credit")))
    assert str(exc.value) == str(ref_exc.value) == \
        "design= requires the simulated fabric"
    with pytest.raises(ValueError, match="needs execute=True"):
        serve_workload(config=ServeConfig(execute=False, fabric="wallclock"))


# --------------------------------------------------------------------------- #
# (g) the keyword shim
# --------------------------------------------------------------------------- #
def test_kwarg_shim_warns_and_matches_config():
    spec = WorkloadSpec(num_requests=24, seed=4)
    with pytest.warns(DeprecationWarning, match="config=ServeConfig"):
        shim = serve_workload(spec, execute=False, pipeline=True)
    cfg = serve_workload(spec, config=ServeConfig(execute=False,
                                                  pipeline=True))
    assert _outcome(shim) == _outcome(cfg)
    with pytest.warns(DeprecationWarning):
        ref = ref_serve_workload(RefWorkloadSpec(num_requests=24, seed=4),
                                 execute=False, pipeline=True)
    assert _outcome(shim) == _outcome(ref)
    with pytest.raises(TypeError), pytest.warns(DeprecationWarning):
        serve_workload(spec, no_such_option=1)


def test_synthetic_workload_alias_warns_and_matches():
    with pytest.warns(DeprecationWarning, match="WorkloadSpec.build"):
        got = synthetic_workload(WorkloadSpec(num_requests=12, seed=2))
    with pytest.warns(DeprecationWarning):
        want = ref_synthetic_workload(RefWorkloadSpec(num_requests=12,
                                                      seed=2))
    assert [(r.rid, r.arrival, r.prompt_len, r.gen_len, r.slo_cycles)
            for r in got] == [(r.rid, r.arrival, r.prompt_len, r.gen_len,
                               r.slo_cycles) for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)


# --------------------------------------------------------------------------- #
# (b) execute=True: the port's engine emits the reference's tokens
# --------------------------------------------------------------------------- #
EXEC_SPEC = dict(num_requests=8, prompt_lens=(8, 16), gen_lens=(2, 4),
                 rate_rps=2e6, seed=3)
MODES = {"continuous": {}, "wave_boundary": {"wave_boundary": True},
         "pipeline": {"pipeline": True}}


def _tokens(out) -> dict:
    return {r.rid: r.generated for r in out["requests"]
            if r.state.value == "done"}


@pytest.fixture(scope="module")
def exec_ref():
    runs = {}
    for mode, kw in MODES.items():
        runs[mode] = ref_serve_workload(
            RefWorkloadSpec(**EXEC_SPEC),
            config=RefServeConfig(arch=ARCH, reduced=True, **kw))
    cfg = ref_scaled_down(ref_get_config(ARCH))
    params = ref_init_params(jax.random.key(0), cfg)   # param_seed 0
    return runs, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("mode", list(MODES))
def test_execute_emits_reference_tokens(exec_ref, mode, fused):
    runs, np_params = exec_ref
    ref = runs[mode]
    got = serve_workload(WorkloadSpec(**EXEC_SPEC), config=ServeConfig(
        arch=ARCH, reduced=True, fused_decode=fused, device="cpu",
        params=params_from_numpy(np_params, "cpu"), **MODES[mode]))
    want = _tokens(ref)
    have = _tokens(got)
    assert have.keys() == want.keys() and len(want) > 0
    for rid in want:
        np.testing.assert_array_equal(have[rid], want[rid], err_msg=str(rid))
    # The schedule is the reference's too: same admissions and plans.
    assert _dump([dataclasses.asdict(p) for p in got["plans"]]) == \
        _dump([dataclasses.asdict(p) for p in ref["plans"]])
    m = got["metrics"]
    assert m.completed == ref["metrics"].completed
    if mode == "continuous":
        assert m.mid_wave_admissions > 0      # slots really mixed
    if mode == "pipeline":
        assert m.pipelined_prefills > 0


def test_execute_takes_a_model_config(exec_ref):
    from repro_torch.configs import get_config
    from repro_torch.models import scaled_down

    _, np_params = exec_ref
    runs = [serve_workload(WorkloadSpec(**EXEC_SPEC), config=ServeConfig(
        arch=arch, reduced=reduced, device="cpu",
        params=params_from_numpy(np_params, "cpu")))
        for arch, reduced in ((ARCH, True),
                              (scaled_down(get_config(ARCH)), False))]
    want, have = _tokens(runs[0]), _tokens(runs[1])
    assert have.keys() == want.keys() and want
    for rid in want:
        np.testing.assert_array_equal(have[rid], want[rid])


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-370m"])
def test_execute_other_families_match_reference(arch):
    """The CLI's trace at ``--requests 8`` (prompts of 256-1024 tokens) on
    a reduced MoE and a reduced SSM: the reference's summary (but for the
    engine's measured seconds), admissions, plans and per-request
    tokens."""
    spec = dict(num_requests=8)
    ref = ref_serve_workload(RefWorkloadSpec(**spec),
                             config=RefServeConfig(arch=arch, reduced=True))
    params = ref_init_params(jax.random.key(0),
                             ref_scaled_down(ref_get_config(arch)))
    got = serve_workload(WorkloadSpec(**spec), config=ServeConfig(
        arch=arch, reduced=True, device="cpu", fused_decode=True,
        params=params_from_numpy(jax.tree.map(np.asarray, params), "cpu")))
    want, have = _outcome(ref), _outcome(got)
    for key in ("admissions", "plans", "calibration", "requests"):
        assert have[key] == want[key], key
    # Every summary line but the engine's measured wall-clock seconds.
    summaries = [out["metrics"].summary() for out in (ref, got)]
    for summ in summaries:
        del summ["wall"]
    assert _dump(summaries[1]) == _dump(summaries[0])
    lines = [[ln for ln in out["metrics"].format_summary().splitlines()
              if not ln.startswith("engine wall:")] for out in (ref, got)]
    assert lines[1] == lines[0]
    want_tok, have_tok = _tokens(ref), _tokens(got)
    assert have_tok.keys() == want_tok.keys() and want_tok
    for rid in want_tok:
        np.testing.assert_array_equal(have_tok[rid], want_tok[rid])
    m = got["metrics"]
    assert m.completed == m.admitted == ref["metrics"].admitted > 0


def test_moe_rows_couple_only_through_capacity():
    """With one routing group, an MoE batch's rows share the experts'
    capacity, so loops that batch other rows together may emit other
    tokens (ROADMAP C12, the reference's behaviour too).  With capacity to
    spare, no copy overflows and every loop gives the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, scaled_down

    def differing(capacity_factor):
        cfg = dataclasses.replace(
            scaled_down(get_config("qwen3-moe-30b-a3b")),
            capacity_factor=capacity_factor)
        params = init_params(cfg, seed=0, device="cpu")
        runs = [_tokens(serve_workload(WorkloadSpec(**EXEC_SPEC),
                                       config=ServeConfig(
            arch=cfg, reduced=False, device="cpu", params=params, **kw)))
            for kw in MODES.values()]
        assert runs[0] and all(r.keys() == runs[0].keys() for r in runs)
        return sum(not np.array_equal(r[rid], runs[0][rid])
                   for r in runs[1:] for rid in runs[0])

    assert differing(100.0) == 0
    assert differing(1.25) > 0      # the reference's capacity factor


# --------------------------------------------------------------------------- #
# (h) the wall-clock fabric on the CPU
# --------------------------------------------------------------------------- #
def test_wallclock_fabric_on_cpu_calibrates():
    out = serve_workload(WorkloadSpec(**EXEC_SPEC), config=ServeConfig(
        arch=ARCH, reduced=True, fabric="wallclock", fused_decode=True,
        device="cpu"))
    snap = out["calibration"]
    m = out["metrics"]
    assert snap.n_samples > 0 and snap.n_observed == m.prefill_jobs + \
        m.decode_jobs
    assert len(m.step_wall_s) == m.prefill_jobs + m.decode_jobs
    assert m.completed == m.admitted > 0
    assert m.host_jobs == 0     # wallclock: every job runs on the engine
    for r in out["requests"]:
        if r.state is RequestState.DONE:
            assert len(r.generated) == r.gen_len


# --------------------------------------------------------------------------- #
# (c) the discrete-event engine and the overlap-aware fit
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("buffering", ["single", "double"])
def test_offload_engine_bit_identical(buffering):
    for dvfs in (None, "eco"):
        a = eng.OffloadEngine(buffering=buffering, dvfs=dvfs)
        b = ref_eng.OffloadEngine(buffering=buffering, dvfs=dvfs)
        rng = np.random.default_rng(7)
        for i in range(40):
            n = int(rng.choice([16, 256, 1024, 4096]))
            m = int(rng.choice([1, 2, 4, 8, 16, 32]))
            offload = bool(rng.random() > 0.2)
            sync = "poll" if i % 7 == 3 else "credit"
            t = float(rng.integers(0, 20000))
            ra = a.submit(n, m_clusters=m, sync=sync, kernel=sim.DAXPY,
                          t_submit=t, offload=offload, exec_scale=1.01)
            rb = b.submit(n, m_clusters=m, sync=sync, kernel=ref_sim.DAXPY,
                          t_submit=t, offload=offload, exec_scale=1.01)
            assert dataclasses.asdict(ra) == dataclasses.asdict(rb)
        assert a.utilization() == b.utilization()
        assert [r.job_id for r in a.poll(1e9)] == \
            [r.job_id for r in b.poll(1e9)]
        assert [dataclasses.asdict(r) for r in a.halt(5e4)] == \
            [dataclasses.asdict(r) for r in b.halt(5e4)]
    grid = eng.steady_sweep([1, 8, 32], [64, 1024], buffering=buffering)
    assert grid == ref_eng.steady_sweep([1, 8, 32], [64, 1024],
                                        buffering=buffering)
    assert eng.effective_alpha_floor() == ref_eng.effective_alpha_floor()


@pytest.mark.parametrize("buffering", ["single", "double"])
def test_fit_pipelined_from_engine_bit_identical(buffering):
    got, got_mape = rm.fit_pipelined_from_engine(buffering=buffering)
    want, want_mape = ref_rm.fit_pipelined_from_engine(buffering=buffering)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got_mape == want_mape
    hw = sim.scaled_hw(8)
    got8 = rm.fit_pipelined_from_engine(ms=sim.extent_grid(8), hw=hw)
    want8 = ref_rm.fit_pipelined_from_engine(ms=ref_sim.extent_grid(8),
                                             hw=ref_sim.scaled_hw(8))
    assert dataclasses.asdict(got8[0]) == dataclasses.asdict(want8[0])
    assert got8[1] == want8[1]


# --------------------------------------------------------------------------- #
# (e) the streaming CLI
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("extra", [
    [],
    ["--pipeline", "--verbose"],
    ["--faults", "crash@0:0.45", "--workload", "gamma"],
    ["--sessions", "3", "--affinity", "--tenants", "3", "--tenant-classes",
     "premium,standard,batch", "--priority", "--preempt", "--shed", "2:4"],
], ids=["default", "pipeline-verbose", "crash-gamma", "tenants"])
def test_cli_no_execute_prints_reference_output(capsys, extra):
    argv = ["--no-execute", "--requests", "32", *extra]
    ref_main(argv)
    want = capsys.readouterr().out
    main(argv)
    got = capsys.readouterr().out
    assert got == want
    assert "calibrated model" in got


def test_cli_fleet_prints_reference_output(capsys):
    argv = ["--no-execute", "--fleet", "32,8"]
    ref_main(argv)
    want = capsys.readouterr().out
    main(argv)
    got = capsys.readouterr().out
    assert got == want
    assert "router [model] over fleet 32+8" in got


def test_cli_streaming_on_cpu_with_the_engine(capsys, tmp_path):
    metrics = tmp_path / "m.json"
    out = main(["--arch", ARCH, "--device", "cpu", "--requests", "4",
                "--fused-decode", "--metrics-json", str(metrics)])
    text = capsys.readouterr().out
    assert "engine wall:" in text and "calibrated model" in text
    assert json.loads(metrics.read_text()) == json.loads(
        json.dumps(out["metrics"].summary()))
    assert out["metrics"].completed == out["metrics"].admitted


# --------------------------------------------------------------------------- #
# (f) no jax, no repro
# --------------------------------------------------------------------------- #
def test_port_serving_modules_import_no_jax_and_no_reference():
    code = ("import sys\n"
            "import repro_torch.serve, repro_torch.obs, "
            "repro_torch.launch.serve, repro_torch.core, repro_torch.dse, "
            "repro_torch.serve.fleet, repro_torch.launch.dse, "
            "repro_torch.kernels.ref, repro_torch.configs.shapes, "
            "repro_torch.core.planner, repro_torch.runtime.analytics, "
            "repro_torch.launch.mesh, repro_torch.runtime.sharding, "
            "repro_torch.launch.dryrun, repro_torch.launch.steps, "
            "repro_torch.launch.train\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# --------------------------------------------------------------------------- #
# Prefix-KV handoff and decode-state checkpoints
# --------------------------------------------------------------------------- #
def test_prefix_store_handoff_gives_reference_values(tmp_path):
    import torch

    from repro.serve import PrefixStore as RefPrefixStore
    from repro_torch.serve import PrefixStore

    kv = {"k": np.arange(12, dtype=np.float32).reshape(3, 4),
          "len": np.array([5, 7], np.int64)}
    got, want = PrefixStore(64, ckpt_dir=tmp_path / "p"), \
        RefPrefixStore(64, ckpt_dir=tmp_path / "r")
    for store in (got, want):
        store.attach_kv(7, kv, {"turn": 1})
        assert store.insert(7, 40) == []
    like = {"k": np.zeros((3, 4), np.float32), "len": 0}
    back, ref_back = got.fetch_kv(7, like), want.fetch_kv(7, like)
    for key in kv:
        assert isinstance(back[key], np.ndarray)
        assert back[key].dtype == ref_back[key].dtype
        np.testing.assert_array_equal(back[key], ref_back[key])
    t = got.fetch_kv(7, {"k": torch.zeros(3, 4), "len": 0})
    assert isinstance(t["k"], torch.Tensor)
    np.testing.assert_array_equal(t["k"].numpy(), kv["k"])
    # Eviction drops the payload in both.
    for store in (got, want):
        assert store.insert(8, 60) == [7]
        assert not (store.ckpt_dir / "step_00000007").exists()
    assert (got.hits, got.misses, got.evictions, got.tokens) == \
        (want.hits, want.misses, want.evictions, want.tokens)


def test_batcher_checkpoints_match_reference(tmp_path):
    from repro.ckpt.checkpoint import restore_checkpoint as ref_restore
    from repro.ckpt.checkpoint import CheckpointManager as RefCkpt
    from repro.serve import (ContinuousBatcher as RefBatcher,
                             OffloadAwareScheduler as RefScheduler,
                             OnlineCalibrator as RefCalibrator)
    from repro_torch.ckpt.checkpoint import (CheckpointManager,
                                             list_steps, restore_checkpoint)
    from repro_torch.serve import (ContinuousBatcher, OffloadAwareScheduler,
                                   OnlineCalibrator)

    spec = dict(num_requests=24, seed=2)
    runs = {}
    for who, B, S, C, K, W, restore in (
            ("p", ContinuousBatcher, OffloadAwareScheduler, OnlineCalibrator,
             CheckpointManager, WorkloadSpec, restore_checkpoint),
            ("r", RefBatcher, RefScheduler, RefCalibrator, RefCkpt,
             RefWorkloadSpec, ref_restore)):
        cal = C()
        ckpt = K(tmp_path / who, keep=100)
        b = B(S(cal), cal, ckpt=ckpt, ckpt_every=3)
        out = b.run(W(**spec).build(with_tokens=False))
        ckpt.wait()
        like = {"rids": 0, "emitted": 0, "lens": 0, "gen": 0}
        runs[who] = (_outcome(out), [
            {k: np.asarray(v).tolist() for k, v in
             restore(tmp_path / who, like, step=s)[0].items()}
            for s in list_steps(tmp_path / who)])
    assert list_steps(tmp_path / "p") == list_steps(tmp_path / "r") != []
    assert runs["p"] == runs["r"]
