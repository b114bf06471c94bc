"""The port's serving path against the reference, on the CPU.

  * one-shot ``serve`` on bridged weights and the reference's prompt batch
    generates the reference's tokens and the same offload decision, with
    the fused decode step off and on;
  * the reference ``ContinuousBatcher``, driven by the port's
    ``ServingEngine``, emits the tokens it emits with the reference engine
    — continuous, ``wave_boundary`` and ``pipeline=True`` loops, fused and
    unfused (the pattern of tests/test_serve.py:238);
  * the credit counter and the dispatchers behave as the reference's;
  * the numpy core (simulator, Eq.-1 fits, Eq.-3 decisions) is
    bit-identical to the reference's on the paper's grids.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import decision as ref_decision
from repro.core import runtime_model as ref_rm
from repro.core import simulator as ref_sim
from repro.launch.serve import serve as ref_serve
from repro.models import init_params as ref_init_params
from repro.models import scaled_down as ref_scaled_down
from repro.serve import (ContinuousBatcher, OffloadAwareScheduler,
                         OnlineCalibrator, Request, SimulatedFabric)
from repro.serve import ServingEngine as RefServingEngine
from repro_torch.core import decision, runtime_model, simulator as sim
from repro_torch.core.dispatch import MulticastDispatcher, SequentialDispatcher
from repro_torch.core.sync import (CreditCounterSync, FaultDetected,
                                   PollingSync, credit_threshold,
                                   emit_credits)
from repro_torch.launch.serve import main, serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import ServingEngine

ARCH = "chatglm3-6b"
AVAILABLE = (1, 2, 4, 8, 16, 32)
CPU = torch.device("cpu")


def _bridge(params):
    return params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


# --------------------------------------------------------------------------- #
# One-shot serve
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def one_shot_ref():
    prompts, prompt_len, gen = 2, 8, 4
    out = ref_serve(ARCH, reduced=True, prompts=prompts,
                    prompt_len=prompt_len, gen=gen)
    cfg = ref_scaled_down(ref_get_config(ARCH))
    tokens = np.asarray(jax.random.randint(
        jax.random.key(1), (prompts, prompt_len), 0, cfg.vocab_size,
        dtype="int32"))  # the reference serve()'s prompt batch
    params = _bridge(ref_init_params(jax.random.key(0), cfg))  # param_seed 0
    return out, tokens, params


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_one_shot_serve_matches_reference(one_shot_ref, fused):
    ref, tokens, params = one_shot_ref
    got = serve(ARCH, reduced=True, prompts=2, prompt_len=8, gen=4,
                device="cpu", params=params, prompt_tokens=tokens,
                fused_decode=fused)
    np.testing.assert_array_equal(got["generated"], ref["generated"])
    assert got["offload_decision"] == ref["offload_decision"]
    assert got["credits"] == [got["credit_threshold"]] * 4
    assert got["arch"] == ref["arch"]
    assert got["prefill_s"] >= 0 and got["decode_tok_s"] > 0


def test_one_shot_default_prompts_are_seeded():
    a = serve(ARCH, prompts=2, prompt_len=4, gen=2, device="cpu")
    b = serve(ARCH, prompts=2, prompt_len=4, gen=2, device="cpu")
    np.testing.assert_array_equal(a["generated"], b["generated"])
    assert a["generated"].shape == (2, 2)


def test_cli_one_shot_and_unported_streaming(capsys):
    """The one-shot CLI, the streaming CLI, and its fleet mode with one
    engine per lane (the name predates the fleet's port)."""
    out = main(["--one-shot", "--arch", ARCH, "--prompts", "2",
                "--prompt-len", "4", "--gen", "2", "--device", "cpu"])
    assert out["generated"].shape == (2, 2)
    assert "offload decision" in capsys.readouterr().out
    out = main(["--arch", ARCH, "--device", "cpu", "--requests", "3"])
    assert out["metrics"].submitted == 3
    assert "calibrated model" in capsys.readouterr().out
    out = main(["--arch", ARCH, "--device", "cpu", "--fleet", "32,8",
                "--requests", "3"])
    assert out["metrics"].summary()["submitted"] == 3
    assert all(lane.engine.device == CPU for lane in out["fleet"].lanes)
    assert "router [model] over fleet 32+8" in capsys.readouterr().out


# --------------------------------------------------------------------------- #
# The reference ContinuousBatcher driving the port's ServingEngine
# --------------------------------------------------------------------------- #
SPEC = [(8, 5, 0.0), (4, 3, 0.0), (8, 2, 1500.0), (4, 6, 3000.0),
        (8, 4, 9000.0)]   # (prompt_len, gen_len, arrival)


def _run_batcher(engine, *, pipeline=False, wave_boundary=False):
    rng = np.random.default_rng(5)
    prompts = {i: rng.integers(0, 128, size=(pl,), dtype=np.int32)
               for i, (pl, _, _) in enumerate(SPEC)}
    cal = OnlineCalibrator()
    sched = OffloadAwareScheduler(cal, available_m=AVAILABLE)
    fabric = SimulatedFabric(jitter_pct=0.0,
                             buffering="double" if pipeline else "single")
    b = ContinuousBatcher(sched, cal, fabric=fabric, engine=engine,
                          pipeline=pipeline, wave_boundary=wave_boundary)
    reqs = [Request(rid=i, arrival=arr, prompt_len=pl, gen_len=g,
                    tokens=prompts[i])
            for i, (pl, g, arr) in enumerate(SPEC)]
    return b.run(reqs)


@pytest.fixture(scope="module")
def batcher_ref():
    engine = RefServingEngine(ARCH, reduced=True, max_batch=3, max_len=16)
    out = _run_batcher(engine)
    assert out["metrics"].mid_wave_admissions > 0   # slots really mixed
    return {r.rid: r.generated for r in out["requests"]}, \
        _bridge(engine.params)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("mode", ["continuous", "wave_boundary", "pipeline"])
def test_reference_batcher_with_port_engine_emits_reference_tokens(
        batcher_ref, mode, fused):
    want, params = batcher_ref
    engine = ServingEngine(ARCH, reduced=True, max_batch=3, max_len=16,
                           params=params, fused_decode=fused, device="cpu")
    out = _run_batcher(engine, pipeline=mode == "pipeline",
                       wave_boundary=mode == "wave_boundary")
    if mode == "pipeline":
        assert out["metrics"].pipelined_prefills > 0
    got = {r.rid: r.generated for r in out["requests"]}
    assert got.keys() == want.keys()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=str(rid))


def test_engine_api_on_cpu():
    engine = ServingEngine(ARCH, max_batch=2, max_len=12, device="cpu")
    engine.warmup([4], slots=True)
    engine.warmup([4])
    caches = engine.init_caches()
    pend = engine.prefill_into_slots_async(
        np.ones((2, 4), np.int32), caches, np.array([True, False]))
    assert engine.step_ready(pend)
    tok, merged, wall = engine.wait_step(pend)
    assert merged is caches and wall >= 0 and tok.shape == (2,)
    assert engine.last_credits == 1


class _CardWork:
    """Stand-in for a step's work on the card's one stream: done at
    ``t_done``; ``synchronize`` (an event recorded after it) waits until
    then, ``item``/``cpu`` (a blocking copy queued behind everything on
    the stream) until ``t_stream``, when the last queued step is done."""

    def __init__(self, t_done, t_stream, value=None):
        self.t_done, self.t_stream, self.value = t_done, t_stream, value

    def _until(self, t):
        time.sleep(max(0.0, t - time.perf_counter()))

    def synchronize(self):
        self._until(self.t_done)

    def query(self):
        return time.perf_counter() >= self.t_done

    def item(self):
        self._until(self.t_stream)
        return self.value.item()

    def cpu(self):
        self._until(self.t_stream)
        return self.value


def test_a_decode_wait_excludes_a_prefill_queued_after_it():
    """ROADMAP C15: on the card a decode's credits and tokens are copied to
    its own pinned host buffers right after it is queued, behind which its
    ``done`` event is recorded, so ``wait_step`` waits for that decode
    alone; a blocking read of the device outputs would also wait for the
    refill prefill the pipelined loop queues after it.  Here the decode is
    done 50 ms from now and the prefill behind it 600 ms from now."""
    from repro_torch.serve.batcher import PendingStep
    engine = ServingEngine(ARCH, max_batch=2, max_len=12, device="cpu")
    now = time.perf_counter()
    t_decode, t_prefill = now + 0.05, now + 0.6
    tokens = torch.tensor([3, 4], dtype=torch.int32)
    pending = PendingStep(
        out={"credits": _CardWork(t_decode, t_prefill, torch.tensor(1)),
             "next_token": _CardWork(t_decode, t_prefill, tokens),
             "caches": engine.init_caches()},
        launch_s=0.001, done=_CardWork(t_decode, t_prefill),
        host={"credits": torch.tensor(1, dtype=torch.int32),
              "next_token": tokens.clone()})
    assert not engine.step_ready(pending)
    tok, _, wall = engine.wait_step(pending)
    np.testing.assert_array_equal(tok, [3, 4])
    assert engine.last_credits == 1
    assert 0.04 <= wall < 0.3, wall           # the decode's 50 ms, not 600
    assert time.perf_counter() < t_prefill
    # The CPU's steps finish before they return: no event, no host copy.
    pend = engine.decode_async(np.ones((2, 1), np.int32),
                               engine.init_caches(), 3)
    assert pend.done is None and pend.host is None


# --------------------------------------------------------------------------- #
# Credit counter and dispatch
# --------------------------------------------------------------------------- #
def test_credit_counter_threshold_fault_and_timing():
    from repro.core.sync import emit_credits as ref_emit
    from repro.launch.mesh import make_mesh
    sync = CreditCounterSync()
    assert sync.threshold == credit_threshold() == 1
    assert sync.host_interactions() == 1
    good = {"logits": torch.randn(2, 3), "tok": torch.zeros(2, dtype=torch.int32)}
    got, secs = sync.timed_wait(emit_credits(good))
    assert got == 1 and secs >= 0.0
    bad = {"logits": torch.tensor([[0.0, float("nan")]])}
    with pytest.raises(FaultDetected):
        sync.wait(emit_credits(bad))
    inf = {"x": torch.tensor([float("inf")])}
    with pytest.raises(FaultDetected):
        sync.timed_wait(emit_credits(inf))
    mesh = make_mesh((1, 1), ("data", "model"))
    for tree in (good, bad, inf):
        ref = ref_emit(jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree),
                       mesh)
        assert int(ref) == int(emit_credits(tree))


def test_polling_sync_polls_each_output():
    assert PollingSync().wait({"a": torch.ones(2), "b": (torch.ones(1),)}) == 2
    # As the reference's, one host interaction per device of its mesh.
    from repro.core.sync import PollingSync as RefPollingSync
    from repro.launch.mesh import make_mesh
    from repro_torch.launch.mesh import AbstractMesh
    assert PollingSync().host_interactions() == 1
    assert PollingSync(AbstractMesh((2, 4), ("data", "model"))
                       ).host_interactions() == 8
    assert RefPollingSync(make_mesh((1, 1), ("data", "model"))
                          ).host_interactions() == 1


@pytest.mark.parametrize("cls", [MulticastDispatcher, SequentialDispatcher])
def test_dispatchers_place_identical_tensors(cls):
    tree = {"tokens": np.arange(12, dtype=np.int32).reshape(3, 4),
            "x": np.linspace(0, 1, 5, dtype=np.float32),
            "m": np.array([True, False, True])}
    out, stats = cls().timed_put(tree, CPU)
    for k, a in tree.items():
        np.testing.assert_array_equal(out[k].numpy(), a)
        assert out[k].device == CPU
    assert stats.seconds >= 0
    assert stats.bytes_moved == sum(a.nbytes for a in tree.values())
    want_calls = 1 if cls is MulticastDispatcher else len(tree)
    assert stats.num_host_calls == want_calls


# --------------------------------------------------------------------------- #
# Numpy core: bit-identical to the reference
# --------------------------------------------------------------------------- #
def test_simulator_bit_identical_on_paper_grids():
    ms = ref_sim.PAPER_M_GRID
    for ns in (ref_sim.PAPER_N_GRID_MODEL, ref_sim.PAPER_N_GRID_SPEEDUP,
               ref_sim.PIPELINE_N_GRID):
        for mc in (True, False):
            assert sim.sweep(ms, ns, multicast=mc) == \
                ref_sim.sweep(ms, ns, multicast=mc)
        for m in ms:
            for n in ns:
                assert sim.speedup(m, n) == ref_sim.speedup(m, n)
                for d, s in (("unicast", "credit"), ("multicast", "poll")):
                    assert dataclasses.asdict(
                        sim.simulate_offload(m, n, dispatch=d, sync=s)) == \
                        dataclasses.asdict(
                            ref_sim.simulate_offload(m, n, dispatch=d,
                                                     sync=s))
                for state in ("eco", "nominal", "turbo"):
                    assert sim.offload_energy(
                        m, n, multicast=True,
                        dvfs=sim.dvfs_state(state)) == ref_sim.offload_energy(
                        m, n, multicast=True, dvfs=ref_sim.dvfs_state(state))
                assert sim.host_runtime(n) == ref_sim.host_runtime(n)
    for c in (1, 3, 8, 32, 64):
        assert sim.extent_grid(c) == ref_sim.extent_grid(c)
        assert dataclasses.asdict(sim.scaled_hw(c)) == \
            dataclasses.asdict(ref_sim.scaled_hw(c))


def test_runtime_model_fits_bit_identical():
    for mc in (True, False):
        assert dataclasses.asdict(runtime_model.fit_from_simulator(
            multicast=mc)) == dataclasses.asdict(
            ref_rm.fit_from_simulator(multicast=mc))
    hw = sim.scaled_hw(8)
    assert dataclasses.asdict(runtime_model.fit_from_simulator(
        ms=sim.extent_grid(8), hw=hw)) == dataclasses.asdict(
        ref_rm.fit_from_simulator(ms=ref_sim.extent_grid(8),
                                  hw=ref_sim.scaled_hw(8)))
    e_got, e_mape = runtime_model.fit_energy_from_simulator()
    e_ref, r_mape = ref_rm.fit_energy_from_simulator()
    assert dataclasses.asdict(e_got) == dataclasses.asdict(e_ref)
    assert e_mape == r_mape
    samples = [(m, n, float(ref_sim.offload_runtime(m, n, multicast=True)))
               for m in ref_sim.PAPER_M_GRID
               for n in ref_sim.PAPER_N_GRID_MODEL]
    model = runtime_model.fit(samples)
    assert runtime_model.mape(model, samples) == ref_rm.mape(
        ref_rm.fit(samples), samples)
    assert runtime_model.mape_by_n(model, samples) == ref_rm.mape_by_n(
        ref_rm.fit(samples), samples)
    pinned = [(32, n, t) for m, n, t in samples if m == 32]
    assert dataclasses.asdict(runtime_model.fit_pinned(
        pinned, runtime_model.PAPER_MODEL)) == dataclasses.asdict(
        ref_rm.fit_pinned(pinned, ref_rm.PAPER_MODEL))


def test_decisions_bit_identical():
    got_m = runtime_model.fit_from_simulator()
    ref_m = ref_rm.fit_from_simulator()
    for n in (16, 256, 1024, 4096, 8192):
        for t_max in (380.0, 700.0, 1500.0, 4000.0):
            assert decision.deadline_report(got_m, n, t_max, AVAILABLE) == \
                ref_decision.deadline_report(ref_m, n, t_max, AVAILABLE)
        assert dataclasses.asdict(decision.should_offload(
            got_m, sim.host_runtime, n, AVAILABLE)) == dataclasses.asdict(
            ref_decision.should_offload(ref_m, ref_sim.host_runtime, n,
                                        AVAILABLE))
    assert decision.breakeven_n(got_m, sim.host_runtime, AVAILABLE) == \
        ref_decision.breakeven_n(ref_m, ref_sim.host_runtime, AVAILABLE)
