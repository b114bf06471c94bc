"""The port's training path against the reference's, reduced chatglm3-6b
in f32, with the reference's parameters and optimizer state carried across.

  * ``cross_entropy``, both ``REPRO_BASELINE`` branches, value and gradient:
    ``rtol=1e-6`` (f32 reductions taken in another order);
  * one train step: loss ``rtol=1e-6``, grad_norm ``rtol=1e-5``, and every
    gradient leaf ``rtol=1e-4, atol=1e-6`` (f32 backward through matmuls
    and softmax summed in another order), against the reference's
    ``make_train_step`` on a ``make_host_mesh(1, 1)`` mesh;
  * ``adamw_update`` with ``use_kernel`` on and off against the reference
    with ``use_pallas`` on and off, given the same gradients and state:
    m and v ``rtol=1e-5, atol=1e-7`` (tests/test_kernels.py's contract), p
    ``rtol=1e-6, atol=1e-7`` (the paths differ in the last bits of lr and
    the bias corrections);
  * six steps from the same weights and batches: every loss within
    ``rtol=1e-4`` of the reference's, and falling — params are not
    compared element for element after free-running steps, since Adam's
    first step moves each parameter by ``lr * sign(g)`` and a gradient
    near 0 can take either sign in the two frameworks;
  * ``remat`` gradients equal the non-remat gradients exactly;
  * qwen3-moe-30b-a3b, mamba2-370m and zamba2-1.2b, reduced: loss and
    gradients as above, with ``atol`` scaled by a leaf's largest gradient
    where that exceeds 1 (zamba2's ``shared`` block included), and one
    train step's loss and grad_norm (the port's with remat and the fused
    AdamW kernel's plain version);
  * the train CLI on the CPU, with and without ``--fused-adamw``, and a
    resume from its own checkpoint; its default arch is the reference's.
"""

import functools

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
from repro.models import NO_SHARD
from repro.models import cross_entropy as ref_cross_entropy
from repro.models import init_params as ref_init_params
from repro.models import scaled_down as ref_scaled_down
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import init_opt_state as ref_init_opt_state
from repro_torch.configs import get_config
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import cross_entropy, scaled_down
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.optim import AdamWConfig, adamw_update, global_norm

ARCH = "chatglm3-6b"
B, S = 2, 16
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return params_from_numpy(_np(tree), "cpu")


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=torch.is_tensor)


def _close(got_tree, want_tree, **tol):
    got, want = _leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32), **tol)


@pytest.fixture(scope="module")
def setup():
    cfg_r = ref_scaled_down(ref_get_config(ARCH))
    cfg_t = scaled_down(get_config(ARCH))
    params = ref_init_params(jax.random.key(0), cfg_r)
    it = ref_packed_batches(RefDataConfig(vocab_size=cfg_r.vocab_size,
                                          seq_len=S, global_batch=B, seed=1))
    batches = [next(it) for _ in range(6)]
    return cfg_r, cfg_t, params, batches


def _ref_grads(cfg_r, params, tokens):
    loss_fn = functools.partial(rsteps._loss_fn, cfg=cfg_r, ctx=NO_SHARD,
                                remat=False)
    return jax.jit(jax.value_and_grad(loss_fn))(params,
                                                {"tokens": tokens})


def _port_grads(cfg_t, params, tokens, *, remat=False):
    leaves, spec = torch.utils._pytree.tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss = tsteps._loss_fn(torch.utils._pytree.tree_unflatten(live, spec),
                           {"tokens": torch.from_numpy(tokens)}, cfg_t,
                           remat=remat)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), torch.utils._pytree.tree_unflatten(list(grads),
                                                             spec)


# --------------------------------------------------------------------------- #
# cross_entropy
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("baseline", ["0", "1"])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(monkeypatch, baseline, masked):
    monkeypatch.setenv("REPRO_BASELINE", baseline)
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 9, 37)) * 4).astype(np.float32)
    targets = rng.integers(0, 37, (3, 9)).astype(np.int32)
    mask = (rng.random((3, 9)) > 0.3).astype(np.float32) if masked else None

    def ref_loss(lg):
        return ref_cross_entropy(lg, jnp.asarray(targets),
                                 None if mask is None else jnp.asarray(mask))

    want, want_grad = jax.value_and_grad(ref_loss)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = cross_entropy(lt, torch.from_numpy(targets),
                        None if mask is None else torch.from_numpy(mask))
    (got_grad,) = torch.autograd.grad(got, lt)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-9)


# --------------------------------------------------------------------------- #
# One train step
# --------------------------------------------------------------------------- #
def test_loss_and_grads_match_reference(setup):
    cfg_r, cfg_t, params, batches = setup
    want_loss, want_grads = _ref_grads(cfg_r, params, batches[0])
    got_loss, got_grads = _port_grads(cfg_t, _torch(params), batches[0])
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    _close(got_grads, want_grads, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_train_step_matches_reference(setup, fused):
    cfg_r, cfg_t, params, batches = setup
    opt_r, opt_t = RefAdamWConfig(**OPT), AdamWConfig(**OPT)
    mesh = make_host_mesh(1, 1)
    bundle = rsteps.make_train_step(
        cfg_r, mesh, {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)},
        opt_r, remat=False)
    with mesh:
        _, _, want = jax.jit(bundle.fn)(params, ref_init_opt_state(params),
                                        {"tokens": jnp.asarray(batches[0])})
    step = tsteps.make_train_step(cfg_t, opt_cfg=opt_t, remat=False,
                                  fused_adamw=fused)
    p = _torch(params)
    state = opt_state_from_numpy(_np(ref_init_opt_state(params)), "cpu")
    p2, state2, got = step(p, state, {"tokens": torch.from_numpy(batches[0])})
    assert p2 is p and int(state2["step"]) == 1
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]), rtol=1e-5)
    assert int(got["credits"]) == int(want["credits"]) == 1


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_adamw_update_matches_reference_given_grads(setup, kernel):
    cfg_r, cfg_t, params, batches = setup
    _, grads = _ref_grads(cfg_r, params, batches[0])
    rng = np.random.default_rng(7)
    state = {"m": jax.tree.map(lambda p: jnp.asarray(
                 rng.standard_normal(p.shape) * 1e-3, jnp.float32), params),
             "v": jax.tree.map(lambda p: jnp.asarray(
                 rng.random(p.shape) * 1e-6, jnp.float32), params),
             "step": jnp.int32(3)}
    cfg = dict(lr=1e-3, warmup_steps=2, total_steps=50)
    want_p, want_s = ref_adamw_update(params, grads, state,
                                      RefAdamWConfig(**cfg),
                                      use_pallas=kernel, interpret=True)
    p = _torch(params)
    st = opt_state_from_numpy(_np(state), "cpu")
    got_p, got_s = adamw_update(p, _torch(grads), st, AdamWConfig(**cfg),
                                use_kernel=kernel)
    assert int(got_s["step"]) == int(want_s["step"]) == 4
    _close(got_s["m"], want_s["m"], rtol=1e-5, atol=1e-7)
    _close(got_s["v"], want_s["v"], rtol=1e-5, atol=1e-7)
    _close(got_p, want_p, rtol=1e-6, atol=1e-7)


def test_losses_over_six_steps_track_reference_and_fall(setup):
    cfg_r, cfg_t, params, batches = setup
    mesh = make_host_mesh(1, 1)
    bundle = rsteps.make_train_step(
        cfg_r, mesh, {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)},
        RefAdamWConfig(**OPT), remat=False)
    fn = jax.jit(bundle.fn)
    rp, ro, want = params, ref_init_opt_state(params), []
    with mesh:
        for b in batches:
            rp, ro, met = fn(rp, ro, {"tokens": jnp.asarray(b)})
            want.append(float(met["loss"]))
    step = tsteps.make_train_step(cfg_t, opt_cfg=AdamWConfig(**OPT),
                                  remat=False, fused_adamw=True)
    p = _torch(params)
    st = opt_state_from_numpy(_np(ref_init_opt_state(params)), "cpu")
    got = []
    for b in batches:
        p, st, met = step(p, st, {"tokens": torch.from_numpy(b)})
        got.append(float(met["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0] and want[-1] < want[0]


def test_remat_grads_equal_plain_grads(setup):
    _, cfg_t, params, batches = setup
    l0, g0 = _port_grads(cfg_t, _torch(params), batches[1], remat=False)
    l1, g1 = _port_grads(cfg_t, _torch(params), batches[1], remat=True)
    assert torch.equal(l0, l1)
    for a, b in zip(_leaves(g0), _leaves(g1)):
        assert torch.equal(a, b)
    assert float(global_norm(g0)) > 0


def test_grads_reach_every_stacked_leaf(setup):
    """Views of the stacked group leaves accumulate into one gradient."""
    _, cfg_t, params, batches = setup
    _, grads = _port_grads(cfg_t, _torch(params), batches[2])
    wq = grads["groups"][0]["attn"]["wq"]
    assert wq.shape[0] == cfg_t.full_groups == 2
    assert all(float(wq[g].abs().sum()) > 0 for g in range(2))


# --------------------------------------------------------------------------- #
# The MoE, SSM and hybrid families
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-370m",
                                  "zamba2-1.2b"])
def test_other_families_train_step_matches_reference(arch):
    """Loss and every gradient leaf as in the dense test; zamba2's
    ``shared`` block gathers its gradient from all its invocations."""
    cfg_r = ref_scaled_down(ref_get_config(arch))
    cfg_t = scaled_down(get_config(arch))
    params = ref_init_params(jax.random.key(0), cfg_r)
    tokens = next(ref_packed_batches(RefDataConfig(
        vocab_size=cfg_r.vocab_size, seq_len=S, global_batch=B, seed=1)))
    want_loss, want_grads = _ref_grads(cfg_r, params, tokens)
    got_loss, got_grads = _port_grads(cfg_t, _torch(params), tokens)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    # atol 1e-6 per unit of the leaf's largest gradient where that exceeds
    # 1: the embedding's, behind each block's RMSNorm, reaches ~17 on
    # zamba2, where f32 sums in another order move a small entry by 1e-5
    # (2e-6 of the leaf's largest).
    got, want = _leaves(got_grads), jax.tree.leaves(want_grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(w).max()))
    if cfg_t.uses_shared_block:
        wq = got_grads["shared"]["attn"]["wq"]
        assert wq.shape == want_grads["shared"]["attn"]["wq"].shape
        assert float(wq.abs().sum()) > 0

    mesh = make_host_mesh(1, 1)
    bundle = rsteps.make_train_step(
        cfg_r, mesh, {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)},
        RefAdamWConfig(**OPT), remat=False)
    with mesh:
        _, _, want = jax.jit(bundle.fn)(params, ref_init_opt_state(params),
                                        {"tokens": jnp.asarray(tokens)})
    step = tsteps.make_train_step(cfg_t, opt_cfg=AdamWConfig(**OPT),
                                  remat=True, fused_adamw=True)
    p = _torch(params)
    state = opt_state_from_numpy(_np(ref_init_opt_state(params)), "cpu")
    _, _, got = step(p, state, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]), rtol=1e-5)


# --------------------------------------------------------------------------- #
# The train CLI
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_train_cli_on_cpu(tmp_path, capsys, fused):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "4",
            "--batch", "2", "--seq", "16", "--log-every", "2",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    out = ttrain.main(argv + (["--fused-adamw"] if fused else []))
    assert out["steps"] == 4 and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"])) and not out["faults"]
    assert len(out["step_seconds"]) == 4
    assert "step     4" in capsys.readouterr().out
    resumed = ttrain.main(argv[:6] + ["6"] + argv[7:] + ["--resume"])
    assert "resumed from step 4" in capsys.readouterr().out
    assert resumed["steps"] == 6 and len(resumed["losses"]) == 1


def test_train_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        ttrain.main(["--reduced", "--steps", "1"])


def test_train_cli_default_arch_is_the_references(tmp_path):
    out = ttrain.main(["--reduced", "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--log-every", "1",
                       "--ckpt-dir", str(tmp_path)])
    assert out["cfg"] == "mamba2-370m"
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
