"""The port's training substrates against the reference's: the data stream,
the checkpoint format, fault injection and the step supervisor.

  * ``synthetic_documents`` / ``packed_batches`` are bit-identical to the
    reference on the same seed, and ``DataPipeline`` places the same
    batches;
  * a checkpoint written by either package restores in the other, in f32
    and bf16, bit for bit (the reference returns its own bf16 leaves as raw
    2-byte voids, so those are compared as bits), with equal manifests;
  * the supervisor tests mirror tests/test_substrates.py's, plus a
    rollback after a real train step on a NaN batch;
  * ``import repro_torch.launch.train`` loads no ``jax`` and nothing of
    ``repro``.
"""

import json
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as ref_restore
from repro.ckpt import save_checkpoint as ref_save
from repro.data import DataConfig as RefDataConfig
from repro.data import packed_batches as ref_packed_batches
from repro.data import synthetic_documents as ref_documents
from repro.runtime.fault import FaultInjector as RefFaultInjector
from repro_torch.ckpt import (CheckpointManager, latest_step, list_steps,
                              restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.core.sync import FaultDetected, credit_threshold
from repro_torch.data import (DataConfig, DataPipeline, packed_batches,
                              synthetic_documents)
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params, scaled_down
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.runtime.fault import (FaultInjector, StepSupervisor,
                                       SupervisorConfig)

DATA_CFGS = [dict(vocab_size=97, seq_len=64, global_batch=4, seed=3),
             dict(vocab_size=128, seq_len=16, global_batch=2, seed=1),
             dict(vocab_size=65024, seq_len=512, global_batch=4, seed=1),
             dict(vocab_size=97, seq_len=512, global_batch=2, seed=1,
                  mean_doc_len=40)]


# --------------------------------------------------------------------------- #
# Data
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", DATA_CFGS)
def test_packed_batches_bit_identical(kw):
    got, want = packed_batches(DataConfig(**kw)), \
        ref_packed_batches(RefDataConfig(**kw))
    for _ in range(3):
        g, w = next(got), next(want)
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_synthetic_documents_bit_identical():
    got = synthetic_documents(DataConfig(vocab_size=50, seq_len=8,
                                         global_batch=1, seed=9))
    want = ref_documents(RefDataConfig(vocab_size=50, seq_len=8,
                                       global_batch=1, seed=9))
    for _ in range(20):
        np.testing.assert_array_equal(next(got), next(want))


@pytest.mark.parametrize("dispatcher", ["multicast", "sequential"])
def test_pipeline_places_reference_batches(dispatcher):
    kw = dict(vocab_size=50, seq_len=16, global_batch=2, seed=0)
    pipe = DataPipeline(DataConfig(**kw), "cpu", dispatcher=dispatcher)
    want = ref_packed_batches(RefDataConfig(**kw))
    try:
        for _ in range(3):
            x = next(pipe)
            assert isinstance(x, torch.Tensor) and x.dtype == torch.int32
            np.testing.assert_array_equal(x.numpy(), next(want))
    finally:
        pipe.close()


# --------------------------------------------------------------------------- #
# Checkpoints, across the two packages
# --------------------------------------------------------------------------- #
def _ref_tree(dtype):
    rng = np.random.default_rng(0)
    return {"w": jnp.asarray(rng.standard_normal((3, 4)), dtype),
            "groups": ({"a": jnp.asarray(rng.standard_normal((2, 5)), dtype),
                        "b": jnp.ones((2,), jnp.float32)},),
            "nested": {"b": jnp.ones((5,), dtype), "step": jnp.int32(7)}}


def _bits(x):
    """Raw bits of a leaf from either package, as a numpy array."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 and \
        a.dtype.kind in "Vf" else a


def _assert_bits_equal(got, want):
    g, w = jax.tree.leaves(got, is_leaf=torch.is_tensor), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_port(tmp_path, dt):
    tree = _ref_tree(jnp.dtype(dt))
    ref_save(tmp_path, 5, tree, {"note": "ref"})
    like = params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
    got, step, extra = restore_checkpoint(tmp_path, like)
    assert step == 5 and extra == {"note": "ref"}
    assert got["w"].dtype == like["w"].dtype
    _assert_bits_equal(got, tree)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_reference(tmp_path, dt):
    tree = _ref_tree(jnp.dtype(dt))
    port_tree = params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
    save_checkpoint(tmp_path / "port", 5, port_tree, {"note": "port"})
    ref_save(tmp_path / "ref", 5, tree, {"note": "port"})
    got, step, extra = ref_restore(tmp_path / "port", tree)
    assert step == 5 and extra == {"note": "port"}
    _assert_bits_equal(got, tree)
    # The same manifest and byte-identical .npy files (bf16 as '<V2').
    mp, mr = (json.loads((tmp_path / d / "step_00000005" / "manifest.json")
                         .read_text()) for d in ("port", "ref"))
    assert mp == mr
    for leaf in mp["leaves"]:
        fp, fr = (tmp_path / d / "step_00000005" / leaf["file"]
                  for d in ("port", "ref"))
        assert fp.read_bytes() == fr.read_bytes(), leaf


def test_port_round_trip_params_and_opt_state(tmp_path):
    cfg = scaled_down(get_config("chatglm3-6b"), dtype="bfloat16")
    params = init_params(cfg, seed=1, device="cpu")
    state = init_opt_state(params)
    state["m"]["embed"].normal_()
    save_checkpoint(tmp_path, 3, (params, state))
    like = (init_params(cfg, seed=2, device="cpu"), init_opt_state(params))
    (p2, s2), step, _ = restore_checkpoint(tmp_path, like)
    assert step == 3 and p2["embed"].dtype == torch.bfloat16
    got = jax.tree.leaves((p2, s2), is_leaf=torch.is_tensor)
    want = jax.tree.leaves((params, state), is_leaf=torch.is_tensor)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError):      # a saved leaf of another shape
        restore_checkpoint(tmp_path, ({"embed": torch.zeros(3)},))
    with pytest.raises(KeyError):
        restore_checkpoint(tmp_path, ({"missing": torch.zeros(1)},))


def test_manager_async_save_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    w = torch.arange(4.0)
    for s in (1, 2, 3):
        mgr.save(s, {"w": w})
        w.add_(100.0)          # in-place update while the write may run
    mgr.wait()
    assert list_steps(tmp_path) == [2, 3] and latest_step(tmp_path) == 3
    got, step, _ = mgr.restore_latest({"w": torch.zeros(4)})
    assert step == 3
    assert torch.equal(got["w"], torch.arange(4.0) + 200.0)


# --------------------------------------------------------------------------- #
# Fault injection (numpy, copied)
# --------------------------------------------------------------------------- #
def test_fault_injector_matches_reference():
    spec = "crash@1:0.45,stall@0:0.2+0.1,skew@2:0.3+0.4x3.5,random:4"
    kw = dict(horizon=1e6, num_lanes=3, seed=11)
    got, want = FaultInjector.parse(spec, **kw), RefFaultInjector.parse(spec,
                                                                        **kw)
    assert [vars(e) if hasattr(e, "__dict__") else e for e in got.events] \
        == [vars(e) if hasattr(e, "__dict__") else e for e in want.events]
    assert got.crashed_lanes() == want.crashed_lanes()
    for lane in range(3):
        assert got.detect_time(lane) == want.detect_time(lane)
        assert got.skew_factor(lane, 4e5) == want.skew_factor(lane, 4e5)


# --------------------------------------------------------------------------- #
# Supervisor (mirrors tests/test_substrates.py)
# --------------------------------------------------------------------------- #
def _counter_batches():
    i = 0
    while True:
        yield i
        i += 1


def _one(v):
    return torch.ones((), dtype=torch.int32) * v


def test_supervisor_runs_and_checkpoints(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=2)

    def step(state, batch):
        return state + 1, {"loss": torch.tensor(1.0), "credits": _one(1)}

    sup = StepSupervisor(step, ckpt, SupervisorConfig(ckpt_every=4),
                         credit_threshold=credit_threshold())
    state, rep = sup.run(_one(0), _counter_batches(), 10)
    assert rep.steps_done == 10 and int(state) == 10
    assert latest_step(tmp_path) == 8 and len(rep.step_seconds) == 10


def test_supervisor_rolls_back_on_fault(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=3)

    def step(state, batch):
        poisoned = batch == 6  # one poisoned batch
        return state + 1, {"loss": 1.0, "credits": _one(0 if poisoned else 1)}

    sup = StepSupervisor(step, ckpt, SupervisorConfig(ckpt_every=2),
                         credit_threshold=1)
    state, rep = sup.run(_one(0), _counter_batches(), 10)
    assert rep.steps_done >= 10 - 1
    assert len(rep.faults) == 1 and rep.faults[0]["error"]
    assert rep.restarts == 1


def test_supervisor_raises_after_max_restarts(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=2)

    def step(state, batch):
        return state, {"credits": _one(0)}  # always poisoned

    sup = StepSupervisor(step, ckpt,
                         SupervisorConfig(ckpt_every=100, max_restarts=2),
                         credit_threshold=1)
    with pytest.raises(FaultDetected):
        sup.run(_one(0), _counter_batches(), 5)


def test_supervisor_detects_stragglers(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=1)
    times = iter([0.01] * 6 + [0.2] + [0.01] * 3)

    def step(state, batch):
        time.sleep(next(times))
        return state, {"credits": _one(1)}

    sup = StepSupervisor(step, ckpt,
                         SupervisorConfig(ckpt_every=100,
                                          straggler_factor=5.0),
                         credit_threshold=1)
    _, rep = sup.run(_one(0), _counter_batches(), 10)
    assert len(rep.stragglers) == 1
    assert rep.stragglers[0]["step"] == 6


def test_supervisor_preemption_checkpoints_and_exits(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=2)

    def step(state, batch):
        return state + 1, {"credits": _one(1)}

    sup = StepSupervisor(step, ckpt, SupervisorConfig(ckpt_every=1000),
                         credit_threshold=1)

    def preempt_later():
        time.sleep(0.05)
        sup._preempt = True

    t = threading.Thread(target=preempt_later)
    t.start()

    def slow_batches():
        i = 0
        while True:
            time.sleep(0.01)
            yield i
            i += 1

    state, rep = sup.run(_one(0), slow_batches(), 10_000)
    t.join(timeout=5)
    assert not t.is_alive()
    assert rep.preempted and rep.steps_done < 10_000
    assert latest_step(tmp_path) == rep.steps_done
    got, _, extra = restore_checkpoint(tmp_path, _one(0))
    assert int(got) == int(state) and extra == {"preempted": True}


def _train_with_a_nan_batch(tmp_path, *, nan_at, ckpt_every, steps,
                            compiled=False):
    """A supervised run with a NaN batch at ``nan_at``: through the eager
    train step, or with ``compiled`` through ``launch.train.build``'s
    compiled step.  Returns the report, the final state and the state's
    leaves as drawn."""
    cfg = scaled_down(get_config("chatglm3-6b"))
    if compiled:
        from repro_torch.launch import train
        _, _, step_fn = train.build(cfg, reduced=False,
                                    opt=AdamWConfig(lr=1e-3),
                                    fused_adamw=True, device="cpu")
    else:
        step_fn = make_train_step(cfg, opt_cfg=AdamWConfig(lr=1e-3),
                                  remat=False, fused_adamw=True)
    tokens = packed_batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                       global_batch=2, seed=1))

    def batches():
        for i in range(100):
            b = {"tokens": torch.from_numpy(next(tokens))}
            if i == nan_at:     # embeddings of NaN in place of tokens
                b = {"embeds": torch.full((2, 16, cfg.d_model), float("nan")),
                     "labels": b["tokens"]}
            yield b

    def step(state, batch):
        p, o, metrics = step_fn(*state, batch)
        return (p, o), metrics

    params = init_params(cfg, seed=0, device="cpu")
    state = (params, init_opt_state(params))
    drawn = jax.tree.leaves(state, is_leaf=torch.is_tensor)
    ckpt = CheckpointManager(tmp_path, keep=2)
    sup = StepSupervisor(step, ckpt, SupervisorConfig(ckpt_every=ckpt_every),
                         credit_threshold=credit_threshold())
    (p, o), rep = sup.run(state, batches(), steps)
    assert rep.restarts == 1 and len(rep.faults) == 1
    assert rep.faults[0]["step"] == nan_at
    assert all(bool(torch.isfinite(t).all())
               for t in jax.tree.leaves(p, is_leaf=torch.is_tensor))
    assert int(o["step"]) == steps
    assert torch.isfinite(rep.final_metrics["loss"])
    return rep, (p, o), drawn


def test_supervisor_rolls_back_a_train_step_on_a_nan_batch(tmp_path):
    """A NaN batch poisons the in-place update; the credit counter catches
    it and the supervisor restores the last checkpoint and skips it."""
    rep, _, _ = _train_with_a_nan_batch(tmp_path, nan_at=3, ckpt_every=2,
                                        steps=6)
    assert rep.steps_done == 7          # steps 0-2, rollback to 2, 2-5


def test_supervisor_rolls_back_to_its_start_on_an_early_nan_batch(tmp_path):
    """Before the first periodic checkpoint the rollback point is the one
    the supervisor saved at its start."""
    rep, _, _ = _train_with_a_nan_batch(tmp_path, nan_at=1, ckpt_every=100,
                                        steps=4)
    assert rep.steps_done == 5          # step 0, rollback to 0, 0-3


# --------------------------------------------------------------------------- #
# No jax behind the training entry point
# --------------------------------------------------------------------------- #
def test_train_entry_point_imports_no_jax(repo_root):
    code = ("import sys\n"
            "import repro_torch.launch.train, repro_torch.kernels.ops\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {"PYTHONPATH": str(repo_root / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
