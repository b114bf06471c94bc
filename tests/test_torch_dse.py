"""The port's co-design explorer (``repro_torch.dse``) and kernel oracles
(``repro_torch.kernels.ref``) against the reference, on the CPU.

  * ``run_sweep`` gives the reference's ``DesignResult``s (grids, refits,
    MAPEs, speedups, break-evens, costs), serially and over a two-worker
    process pool whose workers are shown to have run; the sweep
    reproduces the paper's co-design headline and its front holds the
    co-design point;
  * ``pareto_front``, ``front``, ``rank``, ``feasible_ms``,
    ``deadline_region``, ``design_speedup`` and ``summarize`` equal the
    reference's;
  * the fleet-composition axis: ``evaluate_fleet``, ``sweep_fleets``,
    ``fleet_front`` (capped and uncapped) and ``summarize_fleets`` equal
    the reference's, and ``fleet_cost`` warns as the reference's does;
  * ``serve_workload(design=...)`` matches the reference with
    ``execute=False``, and with ``execute=True`` on reduced chatglm3-6b
    (the reference's weights carried across) emits its tokens;
  * ``python -m repro_torch.launch.dse`` prints the reference's output;
  * ``kernels.ref.daxpy``/``adamw`` equal ``repro.kernels.ref`` within the
    tolerances of tests/test_torch_ops.py.
"""

from __future__ import annotations

import dataclasses
import json
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.dse as R
import repro_torch.dse as P
from repro.configs import get_config as ref_get_config
from repro.core import simulator as ref_sim
from repro.kernels import ref as ref_oracles
from repro.launch.dse import main as ref_main
from repro.models import init_params as ref_init_params
from repro.models import scaled_down as ref_scaled_down
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import WorkloadSpec as RefWorkloadSpec
from repro.serve import serve_workload as ref_serve_workload
from repro_torch.core import simulator as sim
from repro_torch.dse import runner as port_runner
from repro_torch.kernels import ref as oracles
from repro_torch.launch.dse import main
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import ServeConfig, WorkloadSpec, serve_workload

ARCH = "chatglm3-6b"


def _dump(x) -> str:
    return json.dumps(x, sort_keys=True, default=repr)


def _result(r) -> str:
    """A DesignResult as plain values, its grids and model family too."""
    return _dump({**r.as_dict(),
                  "family": type(r.model).__name__,
                  "runtimes": sorted(r.runtimes.items()),
                  "speedups": sorted(r.speedup_vs_baseline.items())})


# Spaces in both packages: (id, DesignSpace kwargs).  The wide one crosses
# a bus axis, double buffering (the event engine's steady-state grids) and
# two kernels (one front per kernel).
SPACES = [
    ("paper", {"kernels": ("daxpy",)}),
    ("wide", {"hw_axes": {"bus_bytes_per_cycle": [48, 96, 192]},
              "buffering": ("single", "double"),
              "kernels": ("daxpy", "fused_adamw")}),
]


@pytest.fixture(scope="module")
def sweeps():
    return {sid: (R.run_sweep(R.DesignSpace(**kw)),
                  P.run_sweep(P.DesignSpace(**kw)))
            for sid, kw in SPACES}


@pytest.mark.parametrize("sid", [s[0] for s in SPACES])
def test_run_sweep_matches_reference(sweeps, sid):
    want, got = sweeps[sid]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert _result(g) == _result(w), w.point.name


class _CountingPool(ProcessPoolExecutor):
    """A process pool that counts the futures its workers completed (the
    runner falls back to a serial sweep when the pool fails)."""

    completed = 0

    def submit(self, *args, **kwargs):
        fut = super().submit(*args, **kwargs)

        def count(f):
            if f.exception() is None:
                type(self).completed += 1
        fut.add_done_callback(count)
        return fut


@pytest.mark.parametrize("sid", [s[0] for s in SPACES])
def test_parallel_sweep_matches_serial_and_reference(sweeps, sid,
                                                     monkeypatch):
    monkeypatch.setattr(port_runner, "ProcessPoolExecutor", _CountingPool)
    _CountingPool.completed = 0
    kw = dict(SPACES)[sid]
    want, serial = sweeps[sid]
    got = P.run_sweep(P.DesignSpace(**kw), workers=2)
    assert _CountingPool.completed == len(serial)   # the workers ran
    assert [_result(r) for r in got] == [_result(r) for r in serial] == \
        [_result(r) for r in want]


def test_sweep_reproduces_codesign_headline_and_front(sweeps):
    want, got = sweeps["paper"]
    ext = next(r for r in got if r.point.is_paper_extended)
    # Paper Fig. 1 right: +47.9 % at (M=32, N=1024), as the reference's
    # tests/test_dse.py asserts of its own sweep.
    assert ext.speedup_vs_baseline[(32, 1024)] == pytest.approx(1.479,
                                                                abs=5e-3)
    assert ext in P.front(got)
    assert [r.point.name for r in P.front(got)] == \
        [r.point.name for r in R.front(want)]


@pytest.mark.parametrize("by", ["t_ref", "best_speedup", "cost", "mape_pct"])
def test_front_and_rank_match_reference(sweeps, by):
    for sid, _ in SPACES:
        want, got = sweeps[sid]
        assert [r.point.name for r in P.front(got)] == \
            [r.point.name for r in R.front(want)]
        assert [r.point.name for r in P.rank(got, by=by)] == \
            [r.point.name for r in R.rank(want, by=by)]
        assert P.summarize(got, top=20) == R.summarize(want, top=20)


def test_pareto_front_and_dominates_match_reference():
    rng = np.random.default_rng(0)
    vecs = [tuple(float(x) for x in rng.integers(0, 6, 3)) for _ in range(64)]
    assert P.pareto_front(vecs, key=lambda v: v) == \
        R.pareto_front(vecs, key=lambda v: v)
    for a, b in zip(vecs, vecs[1:]):
        assert P.dominates(a, b) == R.dominates(a, b)
    with pytest.raises(ValueError):
        P.dominates((1.0,), (1.0, 2.0))


@pytest.mark.parametrize("t_max", [400.0, 700.0, 1500.0, 1e9])
def test_deadline_helpers_match_reference(sweeps, t_max):
    ms, ns = list(P.DEFAULT_M_GRID), list(P.DEFAULT_N_GRID)
    for sid, _ in SPACES:
        want, got = sweeps[sid]
        for g, w in zip(got, want):
            assert P.deadline_region(g, ns, t_max, ms) == \
                R.deadline_region(w, ns, t_max, ms)
            for n in (64, 1024, 8192):
                assert P.feasible_ms(g.model, n, t_max, ms) == \
                    R.feasible_ms(w.model, n, t_max, ms)


def test_design_speedup_matches_reference():
    def point(pkg, dispatch, sync, buffering, bus):
        hw = dataclasses.replace((ref_sim if pkg is R else sim).HWParams(),
                                 bus_bytes_per_cycle=bus)
        return pkg.DesignPoint(dispatch=dispatch, sync=sync,
                               buffering=buffering, hw=hw)

    pairs = [(("multicast", "credit", "single", 96),
              ("unicast", "poll", "single", 96)),
             (("multicast", "credit", "double", 192),
              ("multicast", "poll", "single", 48))]
    for a, b in pairs:
        for m, n in ((32, 1024), (8, 256), (32, 8192)):
            assert P.design_speedup(point(P, *a), point(P, *b), m, n) == \
                R.design_speedup(point(R, *a), point(R, *b), m, n)


def test_sampled_points_and_refits_match_reference():
    kw = dict(hw_axes={"cluster_wakeup": [20, 40, 80],
                       "bus_bytes_per_cycle": [48, 96]},
              buffering=("single", "double"))
    got_pts = P.DesignSpace(**kw).sample(6, seed=1)
    want_pts = R.DesignSpace(**kw).sample(6, seed=1)
    assert [p.name for p in got_pts] == [p.name for p in want_pts]
    for g, w in zip(got_pts, want_pts):
        assert g.as_dict() == w.as_dict()
        for force in (False, True):
            gm, gmape = P.refit_design(g, force_eq1=force)
            wm, wmape = R.refit_design(w, force_eq1=force)
            assert dataclasses.asdict(gm) == dataclasses.asdict(wm)
            assert gmape == wmape and P.design_cost(g) == R.design_cost(w)


# --------------------------------------------------------------------------- #
# The fleet-composition axis
# --------------------------------------------------------------------------- #
FLEET_SPEC = dict(num_requests=48, seed=0)


@pytest.fixture(scope="module")
def fleet_sweeps():
    kw = dict(dvfs_points=("eco", "nominal", "turbo"), routers=("model", "rr"))
    return (R.sweep_fleets(R.FleetSpace(**kw), RefWorkloadSpec(**FLEET_SPEC)),
            P.sweep_fleets(P.FleetSpace(**kw), WorkloadSpec(**FLEET_SPEC)))


def test_evaluate_fleet_matches_reference(fleet_sweeps):
    want, got = fleet_sweeps
    assert len(got) == len(want) == 24
    for g, w in zip(got, want):
        assert _dump(g.as_dict()) == _dump(w.as_dict())
        assert _dump(g.summary) == _dump(w.summary)


@pytest.mark.parametrize("cap", [None, 0.2, 0.01])
def test_fleet_front_matches_reference(fleet_sweeps, cap):
    want, got = fleet_sweeps
    assert [r.design.name for r in P.fleet_front(got, power_cap_w=cap)] == \
        [r.design.name for r in R.fleet_front(want, power_cap_w=cap)]
    assert P.summarize_fleets(got, power_cap_w=cap) == \
        R.summarize_fleets(want, power_cap_w=cap)


def test_fleet_costs_match_reference_and_the_alias_warns():
    for sizes in R.DEFAULT_COMPOSITIONS:
        for buf in ("single", "double"):
            assert P.silicon_area(sizes, buffering=buf) == \
                R.silicon_area(sizes, buffering=buf)
        assert P.composition_name(sizes) == R.composition_name(sizes)
    with pytest.warns(DeprecationWarning, match="silicon_area"):
        assert P.fleet_cost((16, 8, 8)) == R.silicon_area((16, 8, 8))


# --------------------------------------------------------------------------- #
# A swept design point served
# --------------------------------------------------------------------------- #
def _wide(pkg, simulator):
    return pkg.DesignPoint(
        dispatch="multicast", sync="credit",
        hw=dataclasses.replace(simulator.HWParams(), bus_bytes_per_cycle=192))


# (id, WorkloadSpec fields, ServeConfig fields)
DESIGN_CASES = [
    ("wide-bus", {"num_requests": 24, "seed": 1}, {}),
    ("pipelined", {"num_requests": 32, "seed": 2}, {"pipeline": True}),
    ("dvfs-turbo", {"num_requests": 24}, {"dvfs": "turbo"}),
]


@pytest.mark.parametrize("spec_kw,cfg_kw", [c[1:] for c in DESIGN_CASES],
                         ids=[c[0] for c in DESIGN_CASES])
def test_serve_design_point_matches_reference(spec_kw, cfg_kw):
    ref = ref_serve_workload(RefWorkloadSpec(**spec_kw), config=RefServeConfig(
        execute=False, design=_wide(R, ref_sim), **cfg_kw))
    got = serve_workload(WorkloadSpec(**spec_kw), config=ServeConfig(
        execute=False, design=_wide(P, sim), **cfg_kw))
    assert _dump(got["metrics"].summary()) == _dump(ref["metrics"].summary())
    assert _dump([dataclasses.asdict(p) for p in got["plans"]]) == \
        _dump([dataclasses.asdict(p) for p in ref["plans"]])
    assert got["calibration"].as_dict() == ref["calibration"].as_dict()
    # The prior reflects the design's 192 B/cycle bus (beta ~ 24/192).
    assert got["calibration"].beta == pytest.approx(24 / 192, rel=0.25)


def test_serve_design_point_executes_reference_tokens():
    spec = dict(num_requests=8, prompt_lens=(8, 16), gen_lens=(2, 4),
                rate_rps=2e6, seed=3)
    design = dict(dispatch="unicast", sync="credit", buffering="double")
    ref = ref_serve_workload(RefWorkloadSpec(**spec), config=RefServeConfig(
        arch=ARCH, reduced=True, design=R.DesignPoint(**design)))
    params = ref_init_params(jax.random.key(0),
                             ref_scaled_down(ref_get_config(ARCH)))
    np_params = jax.tree.map(np.asarray, params)
    for fused in (False, True):
        got = serve_workload(WorkloadSpec(**spec), config=ServeConfig(
            arch=ARCH, reduced=True, design=P.DesignPoint(**design),
            fused_decode=fused, device="cpu",
            params=params_from_numpy(np_params, "cpu")))
        want = {r.rid: r.generated for r in ref["requests"]
                if r.state.value == "done"}
        have = {r.rid: r.generated for r in got["requests"]
                if r.state.value == "done"}
        assert have.keys() == want.keys() and want
        for rid in want:
            np.testing.assert_array_equal(have[rid], want[rid])
        assert _dump([dataclasses.asdict(p) for p in got["plans"]]) == \
            _dump([dataclasses.asdict(p) for p in ref["plans"]])


# --------------------------------------------------------------------------- #
# The explorer's CLI
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("argv", [
    [],
    ["--fleet", "--dvfs", "eco,nominal,turbo", "--power-cap", "0.2"],
    ["--bus", "48,96,192", "--kernels", "daxpy,fused_adamw", "--deadline",
     "700", "--deadline-n", "1024", "--buffering", "single,double"],
    ["--sample", "6", "--seed", "1", "--axis", "cluster_wakeup=20,40,80",
     "--json", "dse.json"],
    ["--fleet", "--compositions", "32;16,16;16,8,8", "--routers",
     "model,lql", "--requests", "32", "--json", "fleet.json"],
], ids=["default", "fleet-dvfs-cap", "bus-kernels-deadline", "sample-json",
        "fleet-compositions-json"])
def test_dse_cli_prints_reference_output(argv, tmp_path, monkeypatch,
                                         capsys):
    outs = {}
    for who, fn in (("ref", ref_main), ("port", main)):
        (tmp_path / who).mkdir()
        monkeypatch.chdir(tmp_path / who)
        outs[who] = (fn(argv), capsys.readouterr().out)
    assert outs["port"][1] == outs["ref"][1]
    assert _dump(outs["port"][0]) == _dump(outs["ref"][0])
    for name in ("dse.json", "fleet.json"):
        if name in argv:
            assert (tmp_path / "port" / name).read_text() == \
                (tmp_path / "ref" / name).read_text()


# --------------------------------------------------------------------------- #
# kernels.ref: the plain oracles
# --------------------------------------------------------------------------- #
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _tol(dt):
    return dict(rtol=2e-2, atol=2e-2) if dt == "bf16" else \
        dict(rtol=1e-6, atol=1e-6)


def _t(x, dt):
    return torch.from_numpy(np.asarray(x, np.float32)).to(TDT[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(5,), (8, 128), (3, 7, 11)])
def test_ref_daxpy_matches_reference(shape, dt):
    rng = np.random.default_rng(0)
    x, y = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    want = ref_oracles.daxpy(2.5, jnp.asarray(x, JDT[dt]),
                             jnp.asarray(y, JDT[dt]))
    got = oracles.daxpy(2.5, _t(x, dt), _t(y, dt))
    assert got.dtype == TDT[dt] and tuple(got.shape) == shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dt))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("step", [1, 100])
def test_ref_adamw_matches_reference(dt, step):
    rng = np.random.default_rng(1)
    p, g = (rng.standard_normal((4, 128)).astype(np.float32)
            for _ in range(2))
    m = (0.1 * rng.standard_normal((4, 128))).astype(np.float32)
    v = np.abs(0.01 * rng.standard_normal((4, 128))).astype(np.float32)
    hp = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.01, step=step)
    want = ref_oracles.adamw(jnp.asarray(p, JDT[dt]), jnp.asarray(g, JDT[dt]),
                             jnp.asarray(m), jnp.asarray(v), **hp)
    got = oracles.adamw(_t(p, dt), _t(g, dt), torch.from_numpy(m),
                        torch.from_numpy(v), **hp)
    assert got[0].dtype == TDT[dt]
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0], np.float32), **_tol(dt))
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
