"""The serving engine's compiled steps (``launch/compile.py``) on the CPU.

On the CPU a ``CompiledStep`` runs its step eagerly on static input
buffers, with the same copy-in and copy-out as a replayed CUDA graph; the
card's replays are held in ``tests/test_torch_kernels_cuda.py``.

  * the engine's compiled steps emit the reference engine's tokens on the
    streaming trace in the continuous, wave-boundary and pipelined loops
    and on a two-lane fleet, and the engine keeps one compiled prefill per
    prompt length, keyed as the reference's ``_slot_prefill_jit`` and
    ``_prefill_jit``;
  * a decode's ``next_token`` survives a slot prefill queued after it;
  * a step handed caches that are not the engine's raises;
  * mamba2's SSM state advances once per decode call;
  * ``disable_compile()`` calls the step itself each time;
  * the reference's public names the port lacked (``DISPATCHERS``,
    ``replicated_sharding``, ``batch_sharding``, ``SYNCS``,
    ``attach_credits``, ``repeat_kv``) behave as the reference's, and an
    AST diff of the two packages finds no other missing name, and
    ``inspect.signature`` no other missing parameter, but the deliberate
    differences.
"""

from __future__ import annotations

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as ref_get_config
from repro.models import init_params as ref_init_params
from repro.models import scaled_down as ref_scaled_down
from repro.serve import ContinuousBatcher as RefContinuousBatcher
from repro.serve import FleetConfig as RefFleetConfig
from repro.serve import OffloadAwareScheduler as RefScheduler
from repro.serve import OnlineCalibrator as RefCalibrator
from repro.serve import ServingEngine as RefServingEngine
from repro.serve import SimulatedFabric as RefSimulatedFabric
from repro.serve import WorkloadSpec as RefWorkloadSpec
from repro.serve import serve_fleet as ref_serve_fleet
from repro_torch.launch.compile import CompiledStep, disable_compile
from repro_torch.models import decode_step, init_cache
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (ContinuousBatcher, FleetConfig,
                               OffloadAwareScheduler, OnlineCalibrator,
                               ServingEngine, SimulatedFabric, WorkloadSpec,
                               serve_fleet)

REPO = Path(__file__).resolve().parent.parent
ARCH = "chatglm3-6b"
CPU = torch.device("cpu")
# The streaming trace of tests/test_torch_serve_stream.py.
SPEC = dict(num_requests=8, prompt_lens=(8, 16), gen_lens=(2, 4),
            rate_rps=2e6, seed=3)
MAX_LEN = 24
LOOPS = {"continuous": {}, "wave": {"wave_boundary": True},
         "pipelined": {"pipeline": True}}


def _ref_params(arch=ARCH):
    cfg = ref_scaled_down(ref_get_config(arch))
    return jax.tree.map(np.asarray, ref_init_params(jax.random.key(0), cfg))


def _serve(batcher_cls, sched_cls, cal_cls, fabric_cls, spec_cls, engine,
           loop):
    kw = LOOPS[loop]
    cal = cal_cls()
    sched = sched_cls(cal, available_m=(1, 2, 4, 8, 16, 32))
    fabric = fabric_cls(jitter_pct=0.0,
                        buffering="double" if kw.get("pipeline") else "single")
    requests = spec_cls(vocab_size=engine.cfg.vocab_size,
                        **SPEC).build(with_tokens=True)
    out = batcher_cls(sched, cal, fabric=fabric, engine=engine, **kw).run(
        requests)
    return {r.rid: np.asarray(r.generated) for r in out["requests"]
            if r.state.value == "done"}, out["metrics"]


@pytest.fixture(scope="module")
def ref_runs():
    """The reference engine on the trace, one engine per loop."""
    runs = {}
    for loop in LOOPS:
        eng = RefServingEngine(ARCH, reduced=True, max_batch=4,
                               max_len=MAX_LEN)
        toks, _ = _serve(RefContinuousBatcher, RefScheduler, RefCalibrator,
                         RefSimulatedFabric, RefWorkloadSpec, eng, loop)
        runs[loop] = (toks, list(eng._prefill_jit),
                      list(eng._slot_prefill_jit))
    return runs, _ref_params()


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("loop", list(LOOPS))
def test_compiled_engine_emits_reference_tokens_and_keys(ref_runs, loop,
                                                         fused):
    runs, np_params = ref_runs
    want, prefill_keys, slot_keys = runs[loop]
    eng = ServingEngine(ARCH, reduced=True, max_batch=4, max_len=MAX_LEN,
                        fused_decode=fused, device="cpu",
                        params=params_from_numpy(np_params, "cpu"))
    have, _ = _serve(ContinuousBatcher, OffloadAwareScheduler,
                     OnlineCalibrator, SimulatedFabric, WorkloadSpec, eng,
                     loop)
    assert have.keys() == want.keys() and want
    for rid in want:
        np.testing.assert_array_equal(have[rid], want[rid], err_msg=str(rid))
    # One compiled prefill per prompt length, as the reference keeps them.
    assert list(eng._prefill_jit) == prefill_keys
    assert list(eng._slot_prefill_jit) == slot_keys
    assert prefill_keys or slot_keys
    # Each compiled step has one key, and its later calls reuse it.
    for step in eng.compiled_steps():
        assert len(step.keys()) <= 1
    assert eng._dec_jit.stats()[0]["calls"] > 1


def test_two_lane_fleet_compiled_emits_reference_tokens():
    np_params = _ref_params()
    kw = dict(fleet=(32, 8), arch=ARCH, reduced=True, execute=True)
    ref = ref_serve_fleet(RefWorkloadSpec(**SPEC), config=RefFleetConfig(**kw))
    got = serve_fleet(WorkloadSpec(**SPEC), config=FleetConfig(
        device="cpu", params=params_from_numpy(np_params, "cpu"), **kw))
    want = {r.rid: r.generated for r in ref["requests"]
            if r.state.value == "done"}
    have = {r.rid: r.generated for r in got["requests"]
            if r.state.value == "done"}
    assert have.keys() == want.keys() and want
    for rid in want:
        np.testing.assert_array_equal(have[rid], want[rid], err_msg=str(rid))
    for lane, ref_lane in zip(got["fleet"].lanes, ref["fleet"].lanes):
        eng, ref_eng = lane.engine, ref_lane.engine
        assert list(eng._slot_prefill_jit) == list(ref_eng._slot_prefill_jit)
        assert list(eng._prefill_jit) == list(ref_eng._prefill_jit)


# --------------------------------------------------------------------------- #
# Buffer rules
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def engine():
    return ServingEngine(ARCH, max_batch=2, max_len=16, device="cpu")


def _prompt(eng, length=8, seed=0):
    return np.random.default_rng(seed).integers(
        0, eng.cfg.vocab_size, (eng.max_batch, length), dtype=np.int32)


def test_decode_token_survives_a_slot_prefill_queued_after_it(engine):
    eng = engine
    mask = np.array([True, True])
    lens = np.array([8, 8], np.int32)
    # Sequential: decode, read its token, then the slot prefill.
    tok, caches, _ = eng.prefill_into_slots(_prompt(eng), eng.init_caches(),
                                            mask)
    want, _, _ = eng.decode(tok[:, None], caches, lens)
    # Queued: decode, then the slot prefill, then the decode's token read.
    tok, caches, _ = eng.prefill_into_slots(_prompt(eng), eng.init_caches(),
                                            mask)
    pend_d = eng.decode_async(tok[:, None], caches, lens)
    pend_p = eng.prefill_into_slots_async(_prompt(eng, seed=1),
                                          pend_d.out["caches"],
                                          np.array([False, True]))
    got, merged, _ = eng.wait_step(pend_d)
    np.testing.assert_array_equal(got, want)
    assert eng.wait_step(pend_p)[1] is merged is eng.init_caches()


def test_a_graph_owned_output_is_copied_out():
    """An output the step keeps in its own memory (as a graph's outputs
    live in its pool) is copied out, so the first call's result survives
    the second call."""
    buf = torch.zeros(3)

    def step(params, x):
        buf.copy_(x + params)
        return {"y": buf, "params": params}

    params = torch.ones(3)
    step_c = CompiledStep(step, device=CPU, static_argnums=(0,))
    first = step_c(params, torch.full((3,), 1.0))
    second = step_c(params, torch.full((3,), 5.0))
    assert first["y"].tolist() == [2.0] * 3 and second["y"].tolist() == [6.0] * 3
    assert first["y"] is not buf and first["params"] is params


def test_a_step_handed_other_caches_raises(engine):
    eng = engine
    tok = np.zeros((2, 1), np.int32)
    other = init_cache(eng.cfg, eng.max_batch, max_len=eng.max_len,
                       device="cpu")
    with pytest.raises(ValueError, match="this engine's caches"):
        eng.decode(tok, other, 3)
    with pytest.raises(ValueError, match="this engine's caches"):
        eng.prefill_into_slots(_prompt(eng), other, np.array([True, False]))
    # The compiled step itself holds its static arguments by identity.
    eng.decode(tok, eng.init_caches(), 3)
    leaves, spec = pytree.tree_flatten(eng.init_caches())
    swapped = pytree.tree_unflatten([x.clone() for x in leaves], spec)
    with pytest.raises(ValueError, match="static arguments"):
        eng._dec_jit(eng.params, torch.zeros((2, 1), dtype=torch.int32),
                     swapped, torch.full((2,), 3, dtype=torch.int32))


def test_mamba2_state_advances_once_per_decode_call():
    eng = ServingEngine("mamba2-370m", max_batch=2, max_len=16, device="cpu")
    tok, caches, _ = eng.prefill(_prompt(eng))
    want = pytree.tree_map(torch.clone, caches)
    tok = tok[:, None]
    for step in range(3):
        lens = np.full(2, 8 + step, np.int32)
        _, want = decode_step(eng.params, eng.cfg, torch.as_tensor(tok),
                              want, torch.as_tensor(lens))
        tok, caches, _ = eng.decode(tok, caches, lens)
        tok = tok[:, None]
        for a, b in zip(pytree.tree_leaves(caches), pytree.tree_leaves(want)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert eng._dec_jit.stats()[0]["calls"] == 3


def test_disable_compile_calls_the_step_each_time():
    seen = []

    def step(params, x):
        seen.append(x)
        return {"y": x * params}

    params = torch.tensor(2.0)
    step_c = CompiledStep(step, device=CPU, static_argnums=(0,))
    xs = [torch.ones(2), torch.ones(2) * 3]
    with disable_compile():
        outs = [step_c(params, x) for x in xs]
    assert len(seen) == 2 and all(a is b for a, b in zip(seen, xs))
    assert [o["y"].tolist() for o in outs] == [[2.0, 2.0], [6.0, 6.0]]
    assert step_c.keys() == []
    # Compiled: the step runs on its static input buffer, one key a shape.
    seen.clear()
    outs = [step_c(params, x) for x in xs] + [step_c(params, torch.ones(4))]
    assert [o["y"].tolist() for o in outs] == [[2.0, 2.0], [6.0, 6.0],
                                               [2.0] * 4]
    assert seen[0] is seen[1] and all(s is not x for s, x in zip(seen, xs))
    assert len(step_c.keys()) == 2
    assert [s["calls"] for s in step_c.stats()] == [2, 1]


# --------------------------------------------------------------------------- #
# The reference's public names
# --------------------------------------------------------------------------- #
def test_dispatchers_syncs_and_attach_credits_match_reference():
    from repro.core import DISPATCHERS as REF_DISPATCHERS
    from repro.core import attach_credits as ref_attach
    from repro.core.sync import SYNCS as REF_SYNCS
    from repro.launch.mesh import make_mesh
    from repro_torch.core import DISPATCHERS, SYNCS, attach_credits

    assert {k: v.name for k, v in DISPATCHERS.items()} == \
        {k: v.name for k, v in REF_DISPATCHERS.items()}
    assert {k: v.name for k, v in SYNCS.items()} == \
        {k: v.name for k, v in REF_SYNCS.items()}
    mesh = make_mesh((1, 1), ("data", "model"))
    for x in (np.ones(3, np.float32), np.array([1.0, np.nan], np.float32)):
        out, credits = attach_credits(lambda v: {"y": v * 2})(
            torch.from_numpy(x))
        ref_out, ref_credits = ref_attach(lambda v: {"y": v * 2}, mesh)(
            jnp.asarray(x))
        np.testing.assert_array_equal(out["y"].numpy(),
                                      np.asarray(ref_out["y"]))
        assert int(credits) == int(ref_credits)


def test_dispatch_placements_match_reference_specs(tmp_path):
    """``replicated_sharding`` and ``batch_sharding`` give the placements
    of the reference's ``P()`` and ``P(axis)`` over a 1x1 mesh (a gloo
    group of one rank)."""
    import torch.distributed as dist

    from repro.core.dispatch import batch_sharding as ref_batch
    from repro.core.dispatch import replicated_sharding as ref_replicated
    from repro.launch.mesh import make_mesh
    from repro_torch.core.dispatch import batch_sharding, replicated_sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.sharding import P, to_placements

    ref_mesh = make_mesh((1, 1), ("data", "model"))
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        mesh = make_host_mesh(1, 1)
        assert replicated_sharding(mesh) == to_placements(
            P(*ref_replicated(ref_mesh).spec), mesh)
        for axis in ("data", "model"):
            assert batch_sharding(mesh, axis) == to_placements(
                P(*ref_batch(ref_mesh, axis).spec), mesh)
        with pytest.raises(ValueError, match="no 'pod'"):
            batch_sharding(mesh, "pod")
    finally:
        dist.destroy_process_group()


def test_repeat_kv_quantize_kv_and_neg_inf_match_reference():
    from repro.models import layers as ref_layers
    from repro_torch.models import layers

    k = np.random.default_rng(0).standard_normal((2, 3, 2, 4)).astype(
        np.float32)
    for heads in (2, 6):
        np.testing.assert_array_equal(
            layers.repeat_kv(torch.from_numpy(k), heads).numpy(),
            np.asarray(ref_layers.repeat_kv(jnp.asarray(k), heads)))
    q, scale = layers.quantize_kv(torch.from_numpy(k))
    rq, rscale = ref_layers.quantize_kv(jnp.asarray(k))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(rscale))
    assert layers.NEG_INF == ref_layers.NEG_INF


#: Reference names the port leaves out on purpose (ROADMAP A, the list of
#: deliberate differences): the TPU's Pallas entry points and tiling, and
#: XLA's cost and HLO readers; ``runtime/__init__`` imports no submodule
#: (``sharding`` imports the model, which imports ``runtime.flags``).
DELIBERATE = {
    "kernels/daxpy.py": {"daxpy_2d", "LANE", "SUBLANE"},
    "kernels/fused_adamw.py": {"adamw_2d", "LANE"},
    "kernels/ops.py": {"LANE"},
    "kernels/decode_attention.py": {"default_interpret"},
    "launch/dryrun.py": {"cost_analysis_dict", "parse_collectives",
                         "peak_memory_bytes"},
    "runtime/__init__.py": {"batch_specs", "cache_specs", "make_shard_ctx",
                            "opt_specs", "param_specs", "to_shardings"},
}


def _public_names(path: Path, with_imports: bool) -> set[str]:
    """Names a module defines at top level, and with ``with_imports`` the
    names it imports from other modules (a package's exports)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and with_imports:
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_")}


#: Parameters of the reference's public functions and methods that the
#: port's counterparts do not take, on purpose (ROADMAP A, the list of
#: deliberate differences; ROADMAP C16): the dispatchers place on a device,
#: not by shardings; XLA's scan and layout options (``unroll_groups``,
#: ``batch_abstract``, ``specs``) and ``StepBundle``'s ``out_shardings``
#: and ``donate_argnums``; the Pallas kernels' ``interpret``, ``chunk`` and
#: ``block_rows``, and AdamW's ``use_pallas`` (``use_kernel=``); a torch
#: ``Generator`` seed for JAX's PRNG ``key``; ``train.build``'s batch
#: shape and mesh, which the compiled step takes from its first call.
DELIBERATE_PARAMS = {
    "core/dispatch.py": {
        "MulticastDispatcher.put": {"shardings"},
        "MulticastDispatcher.timed_put": {"shardings"},
        "SequentialDispatcher.put": {"shardings"},
        "SequentialDispatcher.put_with_calls": {"shardings"},
        "SequentialDispatcher.timed_put": {"shardings"}},
    "kernels/decode_attention.py": {
        "fused_decode_attention": {"chunk", "interpret"}},
    "kernels/ops.py": {"daxpy": {"block_rows", "interpret"},
                       "adamw_update": {"block_rows", "interpret"}},
    "launch/dryrun.py": {"run_cell": {"unroll_groups"}},
    "launch/steps.py": {
        "make_train_step": {"batch_abstract", "unroll_groups"},
        "make_prefill_step": {"batch_abstract", "unroll_groups"},
        "make_slot_prefill_step": {"batch_abstract"},
        "make_decode_step": {"specs", "unroll_groups"},
        "bundle_for": {"unroll_groups"},
        "StepBundle": {"out_shardings", "donate_argnums"}},
    "launch/train.py": {"build": {"batch", "seq", "mesh_shape"}},
    "models/model.py": {"init_params": {"key"},
                        "forward": {"unroll_groups"}},
    "optim/adamw.py": {"adamw_update": {"use_pallas", "interpret"}},
}


def _callables(path: Path) -> list[str]:
    """Public functions and classes a module defines, and the public
    methods (and ``__init__``) of those classes, as dotted names."""
    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    names = []
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, (*funcs, ast.ClassDef)) or \
                node.name.startswith("_"):
            continue
        names.append(node.name)
        if isinstance(node, ast.ClassDef):
            names += [f"{node.name}.{m.name}" for m in node.body
                      if isinstance(m, funcs) and not m.name.startswith("_")]
    return names


def _parameters(module, dotted: str) -> set[str] | None:
    """Parameter names of ``module.dotted`` (None where the port has no
    such callable: the name check covers that)."""
    import inspect
    obj = module
    for part in dotted.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    return {n for n in sig.parameters if n not in ("self", "cls")}


def test_ast_diff_finds_no_missing_public_name():
    """No public name of the reference is missing from the port, and no
    parameter of a public function, class or method is, but the
    deliberate differences (``DELIBERATE``, ``DELIBERATE_PARAMS``)."""
    import importlib
    ref_root, port_root = REPO / "src" / "repro", REPO / "src" / "repro_torch"
    missing, lost_params = {}, {}
    for ref in sorted(ref_root.rglob("*.py")):
        rel = ref.relative_to(ref_root).as_posix()
        port = port_root / rel
        assert port.is_file(), rel
        lost = (_public_names(ref, ref.name == "__init__.py")
                - _public_names(port, True)
                - DELIBERATE.get(rel, set()))
        if lost:
            missing[rel] = sorted(lost)
        mod = rel[:-3].replace("/", ".").removesuffix(".__init__")
        ref_mod = importlib.import_module(f"repro.{mod}".rstrip("."))
        port_mod = importlib.import_module(f"repro_torch.{mod}".rstrip("."))
        for name in _callables(ref):
            want = _parameters(ref_mod, name)
            got = _parameters(port_mod, name)
            if want is None or got is None:
                continue
            gone = want - got - DELIBERATE_PARAMS.get(rel, {}).get(name,
                                                                   set())
            if gone:
                lost_params[f"{rel}:{name}"] = sorted(gone)
    assert missing == {}
    assert lost_params == {}
    # The allowed lists hold differences that exist, nothing more.
    for rel, entries in DELIBERATE_PARAMS.items():
        mod = rel[:-3].replace("/", ".")
        ref_mod = importlib.import_module(f"repro.{mod}")
        port_mod = importlib.import_module(f"repro_torch.{mod}")
        for name, params in entries.items():
            assert params <= _parameters(ref_mod, name) - \
                _parameters(port_mod, name), (rel, name)
