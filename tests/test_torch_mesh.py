"""The port's multi-device layers: ``launch/mesh.py``, ``runtime/sharding.py``
and the mesh path of the steps, the model's ``ShardCtx``, checkpoints and
credits.

  * Spec parity: for every ``ARCH_IDS`` entry at full width (on the meta
    device), ``param_specs``, ``cache_specs`` and ``batch_specs`` equal the
    reference's entry for entry on 2x4, 4x2 and 2x2x2 (pod, data, model)
    meshes, with ``REPRO_BASELINE`` on and off (the reference's specs come
    from a ``jax.sharding.AbstractMesh``).
  * Four gloo processes on a 2x2 (data, model) mesh (``torch.distributed``
    over a ``FileStore`` under ``tmp_path``), one spawn for the file:
    chatglm3-6b reduced (f32) prefills, decodes (fused and unfused) and
    takes a train step, qwen3-moe-30b-a3b and mamba2-370m reduced prefill
    and decode (mamba2 trains too: its SSD runs on each device's heads),
    chatglm3-6b and mamba2-370m take two steps of ``launch.train.build``'s
    compiled train step, and each result is held against the same call on
    one device: tokens equal, logits, caches, loss, grad norm, params and
    the first moment (the gradients: m = 0.1 g after one step) within the
    tolerances below; credits equal the mesh's 4 devices.  A checkpoint
    saved from the 2x2 mesh restores onto a 4x1 mesh bit for bit, and a
    spec over ``("pod", "data")`` puts block ``2 p + d`` on device (p, d),
    the reference's major-to-minor layout.  A fault planted in a supervised
    run on the 2x2 mesh, while rank 0 is still writing the periodic
    checkpoint, rolls every rank back to that same checkpoint.
  * In the same spawn, a 1x4 (data, model) mesh, where the model axis
    divides chatglm3-6b's q heads (4) but not its KV heads (2): prefill,
    decode and the train steps equal one device within the same
    tolerances, greedy tokens identical, and each device's attention holds
    H/4 q heads over as many repeated KV heads.
  * Under ``CommDebugMode``, a decode step (fused and unfused) on the 2x2
    and the 1x4 mesh moves no cache-sized collective: its cache attention
    issues three all-reduces per attention layer over the model axis, of
    (B_local, H) and (B_local, H, D) elements, and otherwise gathers at
    most the new token's k and v.
"""

from __future__ import annotations

import functools
import json
import os
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as RefAbstractMesh
from jax.sharding import PartitionSpec as RefP
from torch.utils import _pytree as pytree

from repro.configs import get_config as ref_get_config
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.runtime import sharding as ref_sharding
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPE_NAMES, input_specs
from repro_torch.configs import shapes as port_shapes
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import init_cache, init_params
from repro_torch.runtime import sharding
from repro.configs import shapes as ref_shapes

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}

# Four-process parity tolerances (f32, reduced configs; the mesh changes
# the order of reductions only).  Measured worst cases on the CPU were
# 4e-6 (caches), 4e-5 (MoE loss), so a tenfold margin and more.
ATOL = 1e-4
RTOL = 1e-4


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RefP))
    return {jax.tree_util.keystr(p): tuple(x) for p, x in flat}


def _flat(tree) -> dict:
    flat, _ = pytree.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, sharding.PartitionSpec))
    return {pytree.keystr(p): tuple(x) for p, x in flat}


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch: str):
    cfg = ref_get_config(arch)
    params = jax.eval_shape(lambda: ref_init_params(jax.random.key(0), cfg))
    caches = jax.eval_shape(lambda: ref_init_cache(cfg, 8, max_len=64))
    return params, caches


@functools.lru_cache(maxsize=None)
def _abstract(arch: str):
    cfg = get_config(arch)
    return (init_params(cfg, device="meta"),
            init_cache(cfg, 8, max_len=64, device="meta"))


@pytest.mark.parametrize("baseline", [False, True], ids=["opt", "baseline"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference(arch, mesh, baseline, monkeypatch):
    monkeypatch.setenv("REPRO_BASELINE", "1" if baseline else "0")
    shape, axes = MESHES[mesh]
    ref_mesh, port_mesh = RefAbstractMesh(shape, axes), \
        AbstractMesh(shape, axes)
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    params, caches = _abstract(arch)
    ref_params, ref_caches = _ref_abstract(arch)
    got = _flat(sharding.param_specs(params, cfg, port_mesh))
    want = _ref_flat(ref_sharding.param_specs(ref_params, ref_cfg, ref_mesh))
    assert got == want
    assert _flat(sharding.opt_specs(sharding.param_specs(
        params, cfg, port_mesh))) == _ref_flat(ref_sharding.opt_specs(
            ref_sharding.param_specs(ref_params, ref_cfg, ref_mesh)))
    assert _flat(sharding.cache_specs(caches, cfg, port_mesh)) == \
        _ref_flat(ref_sharding.cache_specs(ref_caches, ref_cfg, ref_mesh))
    for shape_name in SHAPE_NAMES:
        if not port_shapes.shape_applicable(cfg, shape_name)[0]:
            continue
        specs = {k: v for k, v in input_specs(cfg, shape_name).items()
                 if k != "caches"}
        ref_specs = {k: v for k, v in
                     ref_shapes.input_specs(ref_cfg, shape_name).items()
                     if k != "caches"}
        assert _flat(sharding.batch_specs(specs, port_mesh)) == \
            _ref_flat(ref_sharding.batch_specs(ref_specs, ref_mesh))
    for dim in (1, 6, 8, 128):
        assert sharding.data_spec_for(dim, port_mesh) == \
            ref_sharding.data_spec_for(dim, ref_mesh)
    ctx = sharding.make_shard_ctx(port_mesh)
    ref_ctx = ref_sharding.make_shard_ctx(ref_mesh)
    assert (ctx.dp, ctx.tp, ctx.active) == \
        (ref_ctx.dp, ref_ctx.tp, ref_ctx.active)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    P = sharding.P
    assert sharding.to_placements(P(("pod", "data"), None, "model"), mesh) \
        == (Shard(0), Shard(0), Shard(2))
    assert sharding.to_placements(P(None, "model"), mesh) == \
        (Replicate(), Replicate(), Shard(1))
    assert sharding.to_placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        sharding.to_placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="twice"):
        sharding.to_placements(P("data", "data"), mesh)
    with pytest.raises(ValueError, match="lacks"):
        sharding.to_placements(P("expert"), mesh)


def test_mesh_needs_a_process_group():
    from repro_torch.launch import mesh
    assert mesh.host_mesh((1, 1)) is None
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_host_mesh(2, 2)
    assert mesh.num_data_shards(AbstractMesh((2, 2, 4),
                                             ("pod", "data", "model"))) == 4


def test_a_process_group_neither_places_nor_moves_the_default_path():
    """Inside a process group of 4 ranks, ``(1, 1)`` stays the plain
    one-device path (a rank serves on its own device); a mesh is built
    only when asked for, and never replaces the device asked for."""
    from repro_torch.launch import dryrun, mesh
    from repro_torch.serve.batcher import ServingEngine
    with dryrun.fake_group(4):
        assert mesh.host_mesh((1, 1), "cpu") is None
        eng = ServingEngine("chatglm3-6b", device="cpu")
        assert eng.mesh is None and eng.device == torch.device("cpu")
        assert eng.sync.threshold == 1
        m = mesh.host_mesh((2, 2), "cpu")
        assert (m.device_type, tuple(m.shape)) == ("cpu", (2, 2))
        assert mesh.host_mesh((2, 2), mesh=m) is m
        with pytest.raises(ValueError, match="'cpu' but device 'cuda'"):
            mesh.host_mesh((2, 2), "cuda")
        with pytest.raises(ValueError, match="'cpu' but device 'cuda'"):
            mesh.host_mesh((2, 2), "cuda", mesh=m)
        with pytest.raises(ValueError, match="does not match"):
            mesh.host_mesh((1, 1), mesh=m)


# --------------------------------------------------------------------------- #
# Four gloo processes on a 2x2 mesh
# --------------------------------------------------------------------------- #
ARCHS = ("chatglm3-6b", "qwen3-moe-30b-a3b", "mamba2-370m")
TRAIN_ARCHS = ("chatglm3-6b", "mamba2-370m")


def _cfg(arch):
    from repro_torch.models import scaled_down
    return scaled_down(get_config(arch))


def _tokens(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape,
                                         dtype=np.int32))


def _whole(tree):
    from torch.distributed.tensor import DTensor
    return pytree.tree_map(
        lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


def _run(arch, mesh):
    """Prefill, two decode steps (unfused, fused) and, for chatglm3, one
    train step; on one device when ``mesh`` is None.  Whole tensors."""
    from repro_torch.launch import steps
    from repro_torch.models import decode_step, prefill
    from repro_torch.optim import init_opt_state
    from repro_torch.runtime.sharding import (make_shard_ctx, param_specs,
                                              to_shardings)
    from repro_torch.models import NO_SHARD
    cfg = _cfg(arch)
    cpu = torch.device("cpu")
    params = init_params(cfg, seed=0, device="cpu")
    ctx = NO_SHARD
    if mesh is not None:
        params = to_shardings(params, param_specs(params, cfg, mesh), mesh)
        ctx = make_shard_ctx(mesh)
    tok = _tokens(cfg, (4, 16), 1)
    out = {}
    caches = steps._fresh_caches(cfg, 4, 32, cpu, mesh)
    logits, caches = prefill(params, cfg, caches=caches, tokens=tok, ctx=ctx)
    out["prefill_logits"] = logits
    lens = torch.full((4,), 16, dtype=torch.int32)
    for fused in (False, True):
        nxt = _tokens(cfg, (4, 1), 2 + fused)
        logits, caches = decode_step(params, cfg, nxt, caches, lens,
                                     fused=fused, ctx=ctx)
        out[f"decode_logits_{fused}"] = logits
        lens = lens + 1
    out["caches"] = caches
    pre = steps.make_prefill_step(cfg, 4, max_len=32, device=cpu, mesh=mesh)
    res = pre(params, {"tokens": tok})
    dec = steps.make_decode_step(cfg, fused=True, mesh=mesh)(
        params, res["next_token"][:, None].to(torch.int32), res["caches"],
        torch.full((4,), 16, dtype=torch.int32))
    out["step_tokens"] = torch.stack([res["next_token"],
                                      dec["next_token"]])
    out["credits"] = torch.stack([res["credits"], dec["credits"]])
    if arch in TRAIN_ARCHS:
        opt = init_opt_state(params)
        params, opt, metrics = steps.make_train_step(cfg, mesh=mesh)(
            params, opt, {"tokens": _tokens(cfg, (4, 16), 5)})
        out.update(loss=metrics["loss"], grad_norm=metrics["grad_norm"],
                   params=params, m=opt["m"],
                   train_credits=metrics["credits"])
        out.update(_compiled_train(cfg, mesh))
    return _whole(out)


def _compiled_train(cfg, mesh) -> dict:
    """Two steps of ``train.build``'s compiled step from fresh weights (on
    the CPU it runs eagerly on its static buffers, DTensors on a mesh)."""
    from repro_torch.launch import train
    from repro_torch.optim import init_opt_state
    from repro_torch.runtime.sharding import param_specs, to_shardings
    _, _, step = train.build(cfg, reduced=False, device="cpu", mesh=mesh)
    params = init_params(cfg, seed=0, device="cpu")
    if mesh is not None:
        params = to_shardings(params, param_specs(params, cfg, mesh), mesh)
    opt = init_opt_state(params)
    metrics = [step(params, opt, {"tokens": _tokens(cfg, (4, 16), 6 + i)})[2]
               for i in range(2)]
    return {f"compiled_{k}": torch.stack([_whole(m[k]) for m in metrics])
            for k in ("loss", "grad_norm", "credits")}


def _save(tree, path):
    leaves = {pytree.keystr(p): x.detach().numpy() for p, x in
              pytree.tree_flatten_with_path(tree)[0]}
    np.savez(path, **leaves)


def _rollback_step(mesh, directory) -> int:
    """A supervised run on ``mesh`` (checkpoints every 2 steps) whose step
    3 reports a fault while rank 0 still writes step 2's checkpoint; the
    step this rank rolled back to."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.ckpt import checkpoint as ckpt_mod
    from repro_torch.runtime.fault import StepSupervisor, SupervisorConfig
    from repro_torch.runtime.sharding import P, to_shardings

    write = ckpt_mod._HostLeaf.save

    def write_slowly(leaf, path):
        time.sleep(0.5)
        write(leaf, path)

    def step_fn(state, batch):
        credits = torch.tensor(0 if batch == 3 else mesh.size())
        return {"w": state["w"] + 1}, {"credits": credits}

    spec = {"w": P("data", "model")}
    state = to_shardings({"w": torch.zeros(4, 4)}, spec, mesh)
    ckpt = CheckpointManager(directory, keep=2)
    restored = []
    restore = ckpt.restore_latest
    ckpt.restore_latest = lambda *a, **k: (restored.append(
        restore(*a, **k)), restored[-1])[1]
    ckpt_mod._HostLeaf.save = write_slowly
    try:
        sup = StepSupervisor(step_fn, ckpt, SupervisorConfig(ckpt_every=2),
                             credit_threshold=mesh.size())
        sup.run(state, iter(range(10)), 5, shardings=spec, mesh=mesh)
    finally:
        ckpt_mod._HostLeaf.save = write
    (_, rolled, _), = restored
    return rolled


def _decode_comms(mesh) -> dict:
    """One unfused and one fused decode step of chatglm3-6b (reduced) on
    ``mesh`` after a prefill: ``CommDebugMode``'s all-reduce count, and
    each functional collective's kind and operand shape, split into those
    issued inside the cache attention (``_decode_on_slot_blocks``) and the
    rest of the step."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import decode_step, layers, prefill
    from repro_torch.launch import steps
    from repro_torch.runtime.sharding import (make_shard_ctx, param_specs,
                                              to_shardings)
    cfg = _cfg("chatglm3-6b")
    params = init_params(cfg, seed=0, device="cpu")
    params = to_shardings(params, param_specs(params, cfg, mesh), mesh)
    ctx = make_shard_ctx(mesh)
    caches = steps._fresh_caches(cfg, 4, 32, torch.device("cpu"), mesh)
    _, caches = prefill(params, cfg, caches=caches, tokens=_tokens(
        cfg, (4, 16), 1), ctx=ctx)
    ops = {"attention": [], "other": []}
    where = ["other"]

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if func.namespace == "_c10d_functional" and func._opname not \
                    in ("wait_tensor", "_wrap_tensor_autograd"):
                ops[where[0]].append((func._opname, list(args[0].shape)))
            return func(*args, **(kwargs or {}))

    inner = layers._decode_on_slot_blocks

    def tapped(*a, **k):
        where[0] = "attention"
        try:
            return inner(*a, **k)
        finally:
            where[0] = "other"

    layers._decode_on_slot_blocks = tapped
    try:
        with CommDebugMode() as comm, Spy():
            for i, fused in enumerate((False, True)):
                _, caches = decode_step(
                    params, cfg, _tokens(cfg, (4, 1), 9), caches,
                    torch.full((4,), 16 + i, dtype=torch.int32),
                    fused=fused, ctx=ctx)
    finally:
        layers._decode_on_slot_blocks = inner
    counts = {str(k).split(".")[-1]: v
              for k, v in comm.get_comm_counts().items()}
    return {"comm_all_reduce": counts.get("all_reduce", 0), **ops}


def _worker(rank, world, store, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.tensor import DTensor
        from repro_torch.ckpt import restore_checkpoint, save_checkpoint
        from repro_torch.launch.mesh import make_host_mesh, make_mesh
        from repro_torch.runtime.sharding import (P, distribute, param_specs,
                                                  to_shardings)
        from repro_torch.models import layers
        mesh = make_host_mesh(2, 2)
        for arch in ARCHS:
            res = _run(arch, mesh)
            if rank == 0:
                _save(res, os.path.join(out_dir, f"{arch}.npz"))
        # The model axis divides the q heads but not the KV heads.
        mesh14 = make_host_mesh(1, 4)
        heads, attend = [], layers.chunked_attention
        layers.chunked_attention = lambda q, k, v, **kw: (
            heads.append((q.shape[2], k.shape[2])), attend(q, k, v, **kw))[1]
        try:
            res = _run("chatglm3-6b", mesh14)
        finally:
            layers.chunked_attention = attend
        comms = {name: _decode_comms(m)
                 for name, m in (("2x2", mesh), ("1x4", mesh14))}
        if rank == 0:
            _save(res, os.path.join(out_dir, "chatglm3-6b_1x4.npz"))
            with open(os.path.join(out_dir, "mesh_1x4.json"), "w") as f:
                json.dump({"heads": sorted(set(heads)), "comms": comms}, f)
        # Elastic restore: saved from 2x2, restored onto 4x1.
        cfg = _cfg("chatglm3-6b")
        params = init_params(cfg, seed=7, device="cpu")
        placed = to_shardings(params, param_specs(params, cfg, mesh), mesh)
        save_checkpoint(os.path.join(out_dir, "ckpt"), 3, placed)
        dist.barrier()
        other = make_host_mesh(4, 1)
        got, step, _ = restore_checkpoint(
            os.path.join(out_dir, "ckpt"), params,
            shardings=param_specs(params, cfg, other), mesh=other)
        same = all(isinstance(g, DTensor) and g.device_mesh is other
                   and torch.equal(g.full_tensor(), w)
                   for g, w in zip(pytree.tree_leaves(got),
                                   pytree.tree_leaves(params)))
        # Axis order: block 2 p + d of dim 0 lives on device (p, d).
        pdm = make_mesh((2, 2, 1), ("pod", "data", "model"))
        x = torch.arange(8 * 3).reshape(8, 3)
        local = distribute(x, P(("pod", "data"), None), pdm).to_local()
        p, d, _ = pdm.get_coordinate()
        layout = torch.equal(local, x[2 * (2 * p + d):2 * (2 * p + d) + 2])
        rolled = _rollback_step(mesh, os.path.join(out_dir, "sup"))
        steps_seen = [None] * world
        dist.all_gather_object(steps_seen, rolled)
        agreed = steps_seen == [2] * world
        flags = torch.tensor([same and step == 3, layout, agreed],
                             dtype=torch.int32)
        dist.all_reduce(flags)
        if rank == 0:
            np.save(os.path.join(out_dir, "flags.npy"), flags.numpy())
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    import torch.multiprocessing as mp
    out = tmp_path_factory.mktemp("mesh")
    mp.start_processes(_worker, args=(4, str(out / "store"), str(out)),
                       nprocs=4, join=True, start_method="spawn")
    return out


@pytest.fixture(scope="module")
def plain():
    return {arch: _run(arch, None) for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_prefill_and_decode_match_one_device(arch, gloo_run, plain):
    got = np.load(gloo_run / f"{arch}.npz")
    want = {pytree.keystr(p): x.detach().numpy() for p, x in
            pytree.tree_flatten_with_path(plain[arch])[0]}
    assert sorted(got.files) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if "tokens" in key:
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif "credits" in key:
            np.testing.assert_array_equal(g, 4)
            np.testing.assert_array_equal(w, 1)
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                       err_msg=key)


def _assert_matches(got, want: dict) -> None:
    assert sorted(got.files) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if "tokens" in key:
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif "credits" in key:
            np.testing.assert_array_equal(g, 4)
            np.testing.assert_array_equal(w, 1)
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                       err_msg=key)


def test_mesh_1x4_matches_one_device(gloo_run, plain):
    """Prefill and decode logits, caches, greedy tokens, the train step's
    loss, grad norm, params and first moment, and the compiled train
    step, with the KV heads repeated over a model axis they do not
    divide."""
    got = np.load(gloo_run / "chatglm3-6b_1x4.npz")
    _assert_matches(got, {pytree.keystr(p): x.detach().numpy() for p, x in
                          pytree.tree_flatten_with_path(
                              plain["chatglm3-6b"])[0]})


def test_mesh_1x4_attention_splits_over_q_heads(gloo_run):
    # chatglm3-6b reduced: H = 4 q heads, K = 2 KV heads; model axis of 4.
    rec = json.loads((gloo_run / "mesh_1x4.json").read_text())
    assert rec["heads"] == [[1, 1]]


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_mesh_decode_moves_no_cache_sized_collective(mesh, gloo_run):
    cfg = _cfg("chatglm3-6b")
    data = {"2x2": 2, "1x4": 1}[mesh]
    rows, h, d = 4 // data, cfg.num_heads, cfg.qk_head_dim
    rec = json.loads((gloo_run / "mesh_1x4.json").read_text())["comms"][mesh]
    layers = cfg.num_layers * 2             # two decode steps
    # The cache attention: per layer, the softmax's max and sum and the
    # partial p@V, all-reduced over the model axis ...
    reduces = [op for op in rec["attention"] if op[0] == "all_reduce"]
    assert reduces == [["all_reduce", [rows, h]], ["all_reduce", [rows, h]],
                       ["all_reduce", [rows, h, d]]] * layers
    # ... and otherwise moves the new token's k and v alone; no collective
    # of the step moves slots of the cache: every operand in the heads
    # layout (B, positions, heads, D) holds one position.
    shapes = [shape for _, shape in rec["attention"] + rec["other"]]
    assert all(op[0] == "all_reduce" or op[1][1] == 1
               for op in rec["attention"])
    assert all(len(shape) != 4 or shape[1] == 1 for shape in shapes)
    assert rec["comm_all_reduce"] == sum(
        op[0] == "all_reduce" for op in rec["attention"] + rec["other"])


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_mesh_train_step_matches_one_device(arch, gloo_run, plain):
    got = np.load(gloo_run / f"{arch}.npz")
    for key in ("['loss']", "['grad_norm']"):
        np.testing.assert_allclose(got[key], plain[arch][
            key[2:-2]].numpy(), rtol=RTOL)
    assert any(k.startswith("['m']") for k in got.files)
    assert int(got["['train_credits']"]) == 4


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_mesh_compiled_train_step_matches_one_device(arch, gloo_run, plain):
    got = np.load(gloo_run / f"{arch}.npz")
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[f"['compiled_{key}']"],
                                   plain[arch][f"compiled_{key}"].numpy(),
                                   rtol=RTOL)
    np.testing.assert_array_equal(got["['compiled_credits']"], [4, 4])


def test_elastic_restore_and_axis_order(gloo_run):
    # Summed over the 4 ranks: every rank restored bit for bit, and every
    # rank holds the reference's block of a ("pod", "data")-sharded dim.
    np.testing.assert_array_equal(np.load(gloo_run / "flags.npy")[:2],
                                  [4, 4])


def test_fault_rolls_every_rank_back_to_one_step(gloo_run):
    # Every rank restored step 2, the checkpoint rank 0 was still writing.
    assert np.load(gloo_run / "flags.npy")[2] == 4


def test_one_device_path_runs_no_dtensor_op():
    """With NO_SHARD (the default), a step dispatches no DTensor op."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch import steps

    seen = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(any(issubclass(t, DTensor) for t in types))
            return func(*args, **(kwargs or {}))

    cfg = _cfg("chatglm3-6b")
    params = init_params(cfg, device="cpu")
    caches = init_cache(cfg, 4, 32, device="cpu")
    with Spy():
        steps.make_decode_step(cfg, fused=True)(
            params, _tokens(cfg, (4, 1), 0), caches,
            torch.full((4,), 3, dtype=torch.int32))
    assert seen and not any(seen)
