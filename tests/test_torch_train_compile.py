"""The compiled train step (``launch.train.build``) against the reference's
``jax.jit`` of the train step, on the CPU, where a ``CompiledStep`` runs
the step eagerly on its static buffers and the fused AdamW kernel's plain
version stands in for the kernel.

  * six steps of reduced chatglm3-6b from the reference's weights and
    batches, plain and fused AdamW: every loss and grad_norm against the
    reference's ``jax.jit(bundle.fn)`` (``src/repro/launch/steps.py``)
    within ``LOSS_RTOL`` and ``GNORM_RTOL``, and the step count at every
    step;
  * one step of qwen3-moe-30b-a3b, mamba2-370m and zamba2-1.2b, reduced:
    loss ``rtol=1e-6``, grad_norm ``rtol=1e-5`` (tests/test_torch_train.py's
    one-step tolerances);
  * the step count is one tensor, advanced in place, and the learning rate
    and bias corrections the update used are the reference's
    ``cosine_schedule`` and ``1 / (1 - b ** k)`` at that count;
  * a supervised run with a NaN batch rolls back into the state's own
    tensors, compiled as eagerly: the same restarts and the same final
    params, bit for bit;
  * a compiled step handed another state raises;
  * the train CLI gives the same losses compiled as under
    ``disable_compile()``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import DataConfig as RefDataConfig
from repro.data import packed_batches as ref_packed_batches
from repro.launch import steps as rsteps
from repro.launch.mesh import make_host_mesh
from repro.models import init_params as ref_init_params
from repro.models import scaled_down as ref_scaled_down
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import cosine_schedule as ref_cosine_schedule
from repro.optim import init_opt_state as ref_init_opt_state
from repro_torch.launch import train as ttrain
from repro_torch.launch.compile import CompiledStep, disable_compile
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.optim import AdamWConfig
from test_torch_substrates import _train_with_a_nan_batch

ARCH = "chatglm3-6b"
B, S = 2, 16
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=6)
# tests/test_torch_train.py's one-step tolerances, held at every one of
# the six steps (f32 reductions taken in another order).
LOSS_RTOL = 1e-6
GNORM_RTOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=torch.is_tensor)


def _reference(arch, batches):
    """The reference's jitted train step from its own weights: (params,
    opt state, per-step metrics as floats)."""
    cfg_r = ref_scaled_down(ref_get_config(arch))
    params = ref_init_params(jax.random.key(0), cfg_r)
    state = ref_init_opt_state(params)
    mesh = make_host_mesh(1, 1)
    bundle = rsteps.make_train_step(
        cfg_r, mesh, {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)},
        RefAdamWConfig(**OPT), remat=False)
    fn = jax.jit(bundle.fn)
    out, p, o = [], params, state
    with mesh:
        for b in batches:
            p, o, met = fn(p, o, {"tokens": jnp.asarray(b)})
            out.append({"loss": float(met["loss"]),
                        "grad_norm": float(met["grad_norm"]),
                        "step": int(o["step"])})
    return params, state, out


def _batches(arch, n):
    cfg_r = ref_scaled_down(ref_get_config(arch))
    it = ref_packed_batches(RefDataConfig(vocab_size=cfg_r.vocab_size,
                                          seq_len=S, global_batch=B, seed=1))
    return [next(it) for _ in range(n)]


def _compiled(arch, params, state, *, fused):
    _, _, step = ttrain.build(arch, reduced=True, opt=AdamWConfig(**OPT),
                              fused_adamw=fused, device="cpu")
    assert isinstance(step, CompiledStep)
    return step, params_from_numpy(_np(params), "cpu"), \
        opt_state_from_numpy(_np(state), "cpu")


# --------------------------------------------------------------------------- #
# Against the reference's jax.jit
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_compiled_steps_match_reference_jit(fused):
    batches = _batches(ARCH, 6)
    params, state, want = _reference(ARCH, batches)
    step, p, o = _compiled(ARCH, params, state, fused=fused)
    count = o["step"]
    for b, w in zip(batches, want):
        p, o, met = step(p, o, {"tokens": torch.from_numpy(b)})
        assert o["step"] is count and int(count) == w["step"]
        np.testing.assert_allclose(float(met["loss"]), w["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(met["grad_norm"]), w["grad_norm"],
                                   rtol=GNORM_RTOL)
        assert int(met["credits"]) == 1
    [st] = step.stats()
    assert st["calls"] == 6 and not st["captured"]


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-370m",
                                  "zamba2-1.2b"])
def test_other_families_compiled_step_matches_reference_jit(arch):
    batches = _batches(arch, 1)
    params, state, [want] = _reference(arch, batches)
    step, p, o = _compiled(arch, params, state, fused=True)
    _, o, met = step(p, o, {"tokens": torch.from_numpy(batches[0])})
    np.testing.assert_allclose(float(met["loss"]), want["loss"], rtol=1e-6)
    np.testing.assert_allclose(float(met["grad_norm"]), want["grad_norm"],
                               rtol=1e-5)
    assert int(o["step"]) == want["step"] == 1


# --------------------------------------------------------------------------- #
# The step count, in place
# --------------------------------------------------------------------------- #
def test_step_count_advances_in_place_and_drives_the_schedule(monkeypatch):
    from repro_torch.optim import adamw as tadamw

    used = []
    update = tadamw.ops.adamw_update

    def tap(p, g, m, v, hp):
        used.append(hp.reshape(8).tolist())
        return update(p, g, m, v, hp)

    monkeypatch.setattr(tadamw.ops, "adamw_update", tap)
    batches = _batches(ARCH, 5)
    params = ref_init_params(jax.random.key(0),
                             ref_scaled_down(ref_get_config(ARCH)))
    step, p, o = _compiled(ARCH, params, ref_init_opt_state(params),
                           fused=True)
    count = o["step"]
    ref_cfg = RefAdamWConfig(**OPT)
    for k, b in enumerate(batches, start=1):
        used.clear()
        p, o, _ = step(p, o, {"tokens": torch.from_numpy(b)})
        assert o["step"] is count and int(count) == k
        lr, b1, b2, _, _, c1, c2, _ = used[0]
        assert all(u == used[0] for u in used)      # one hp per step
        np.testing.assert_allclose(
            lr, float(ref_cosine_schedule(ref_cfg, jnp.int32(k))), rtol=1e-6)
        np.testing.assert_allclose(c1, 1 / (1 - b1 ** k), rtol=1e-6)
        np.testing.assert_allclose(c2, 1 / (1 - b2 ** k), rtol=1e-6)


# --------------------------------------------------------------------------- #
# The supervisor's rollback into the held leaves
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def nan_runs(tmp_path_factory):
    return {c: _train_with_a_nan_batch(tmp_path_factory.mktemp(c),
                                       nan_at=3, ckpt_every=2, steps=6,
                                       compiled=c == "compiled")
            for c in ("eager", "compiled")}


@pytest.mark.parametrize("mode", ["eager", "compiled"])
def test_rollback_restores_into_the_held_leaves(nan_runs, mode):
    rep, state, drawn = nan_runs[mode]
    assert rep.restarts == 1 and rep.faults[0]["step"] == 3
    assert all(a is b for a, b in zip(_leaves(state), drawn))
    other = nan_runs["eager" if mode == "compiled" else "compiled"]
    assert rep.steps_done == other[0].steps_done
    for a, b in zip(_leaves(state), _leaves(other[1])):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# The static arguments
# --------------------------------------------------------------------------- #
def test_compiled_step_handed_another_state_raises():
    from repro_torch.models import init_params
    from repro_torch.optim import init_opt_state

    cfg, _, step = ttrain.build(ARCH, reduced=True, device="cpu")
    p = init_params(cfg, seed=0, device="cpu")
    o = init_opt_state(p)
    batch = {"tokens": torch.from_numpy(_batches(ARCH, 1)[0])}
    step(p, o, batch)
    step(p, o, batch)
    with pytest.raises(ValueError, match="static arguments"):
        step(init_params(cfg, seed=0, device="cpu"), o, batch)
    with pytest.raises(ValueError, match="static arguments"):
        step(p, {**o, "step": o["step"].clone()}, batch)
    assert int(o["step"]) == 2


def test_train_cli_same_losses_compiled_and_eager(tmp_path):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "4",
            "--batch", "2", "--seq", "16", "--log-every", "1",
            "--fused-adamw"]
    got = ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "c")])
    with disable_compile():
        want = ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "e")])
    assert got["losses"] == want["losses"] and len(got["losses"]) == 4
    for a, b in zip(_leaves(got["params"]), _leaves(want["params"])):
        assert torch.equal(a, b)
