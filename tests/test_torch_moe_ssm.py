"""The port's MoE and Mamba2 layers against the reference, f32 on the CPU.

  * ``moe_block``: the chosen experts (``top_ids``), the gates, each copy's
    dispatch row (``dst``) and ``keep`` identical to the reference's (read
    from the reference's own ``lax.top_k`` and ``route_group`` while it
    runs), the output within ``rtol=atol=1e-5``; also with a small
    ``capacity_factor`` that forces overflow drops, with exactly equal
    router logits (ties broken in expert order, as ``lax.top_k`` does),
    and with two routing groups;
  * ``kernels.moe_route.expert_slots_plain`` (the router's rank in expert)
    equal to a walk over the copies with running per-expert counters, at
    the decode shapes, the kernel's tile edges, with drops and two groups;
    ``expert_slots`` on CPU tensors runs it and launches nothing;
  * ``kernels.moe_experts.expert_ffn_plain`` (the expert FFN) equal bit
    for bit to ``moe_block``'s einsum chain at stand-ins of the decode
    calls' shapes (bf16 and f32), an expert with no copy exactly 0, and
    ``expert_ffn`` on CPU tensors runs it; ``moe_block`` takes the kernel
    (the card faked) only off a mesh, in bf16 with SiLU, at most 16 slots
    an expert and no gradient, with the same output either way;
  * ``ssd_chunked`` against the reference (``rtol=atol=1e-5``) and against
    a step-by-step f64 recurrence of the SSM (``rtol=1e-4, atol=1e-5``: f32
    chunk sums against a sequential scan);
  * ``_causal_conv``: one-token steps with the carried state give the
    full-sequence conv (``rtol=atol=1e-6``);
  * ``mamba_block``: a prefill of S tokens, then decode steps, gives what a
    prefill of the longer sequence gives at those positions, and the same
    SSM state (``rtol=1e-4, atol=1e-5``: the recurrent update against the
    chunked form) and conv tail (``rtol=1e-5, atol=1e-6``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro.models import scaled_down as ref_scaled_down
from repro_torch.configs import get_config
from repro_torch.kernels import moe_experts, moe_route
from repro_torch.kernels._build import LAUNCHES
from repro_torch.models import layers, scaled_down


def _cfgs(arch, **kw):
    return (ref_scaled_down(ref_get_config(arch), **kw),
            scaled_down(get_config(arch), **kw))


def _moe_params(cfg, rng, tied: bool = False):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"w_router": rng.standard_normal((d, e)) / np.sqrt(d),
         "w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_in": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_out": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    if tied:   # small integers, experts 2j and 2j+1 share a router column
        p["w_router"] = np.repeat(rng.integers(-1, 2, (d, e // 2)), 2, 1)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _ref_moe_routing(x, p, cfg, monkeypatch):
    """The reference's output and its own top-k and route_group values."""
    seen = {}
    top_k, vmap = jax.lax.top_k, jax.vmap

    def recording_top_k(v, k):
        seen["top"] = top_k(v, k)
        return seen["top"]

    def recording_vmap(fn, *a, **kw):
        mapped = vmap(fn, *a, **kw)
        if fn.__name__ != "route_group":
            return mapped

        def run(*args):
            seen["route"] = mapped(*args)
            return seen["route"]
        return run

    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    monkeypatch.setattr(jax, "vmap", recording_vmap)
    y = ref_layers.moe_block(jnp.asarray(x), p, cfg, ref_layers.NO_SHARD)
    monkeypatch.undo()
    _, dst, keep = seen["route"]
    top_logits, top_ids = seen["top"]
    gates = jax.nn.softmax(top_logits.astype(jnp.float32), axis=-1)
    return (np.asarray(y), np.asarray(top_ids), np.asarray(gates),
            np.asarray(dst), np.asarray(keep))


MOE_CASES = {
    "default": ({}, False, (3, 16)),
    "overflow": ({"capacity_factor": 0.25}, False, (3, 16)),
    "tied-logits": ({}, True, (2, 12)),
    "two-groups": ({"moe_groups": 2}, False, (4, 8)),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_block_routes_like_reference(case, monkeypatch):
    kw, tied, (b, s) = MOE_CASES[case]
    rcfg, cfg = _cfgs("qwen3-moe-30b-a3b", **kw)
    rng = np.random.default_rng(11)
    p = _moe_params(cfg, rng, tied)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if tied:
        x = rng.integers(-2, 3, x.shape).astype(np.float32)
    y, top_ids, gates, dst, keep = _ref_moe_routing(x, p, rcfg, monkeypatch)

    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    g = cfg.moe_groups
    tg = b * s // g
    cap = layers.moe_capacity(tg, cfg)
    got_ids, got_gates, got_dst, got_keep = layers.moe_route(
        torch.from_numpy(x).reshape(g, tg, -1), tp["w_router"], cfg, cap)
    np.testing.assert_array_equal(got_ids.numpy(), top_ids)
    np.testing.assert_array_equal(got_dst.numpy(), dst)
    np.testing.assert_array_equal(got_keep.numpy(), keep)
    np.testing.assert_allclose(got_gates.numpy(), gates, rtol=1e-6,
                               atol=1e-7)
    got = layers.moe_block(torch.from_numpy(x), tp, cfg)
    np.testing.assert_allclose(got.numpy(), y, rtol=1e-5, atol=1e-5)
    if case == "overflow":
        assert 0 < (~keep).sum() < keep.size      # some copies dropped
    if tied:   # equal logits at the k-th place, broken by expert index
        logits = x.reshape(-1, cfg.d_model) @ p["w_router"]
        srt = np.sort(logits, axis=-1)[:, ::-1]
        k = cfg.num_experts_per_tok
        assert (srt[:, k - 1] == srt[:, k]).any()


def _slots_by_loop(ids, e, cap):
    """dst and keep of ids (G, N) by a walk over each group's copies with
    one running counter per expert."""
    dst = np.empty(ids.shape, np.int64)
    keep = np.empty(ids.shape, bool)
    for g, row in enumerate(ids.tolist()):
        seen = [0] * e
        for i, x in enumerate(row):
            rank, seen[x] = seen[x], seen[x] + 1
            keep[g, i] = rank < cap
            dst[g, i] = x * cap + rank if rank < cap else e * cap
    return dst, keep


T = moe_route.TILE
# (groups, copies, experts, cap): the decode calls of granite-4.0-h-small
# (4 tokens x 10 of 72) and qwen3-moe-30b-a3b (8 x 8 of 128), the kernel's
# tile edges and a ragged last tile, caps of capacity factor 0.25 that drop
# copies, two groups.
SLOT_CASES = {
    "decode-granite": (1, 40, 72, 10),
    "decode-qwen3-moe": (1, 64, 128, 8),
    "tile-less-one": (1, T - 1, 72, 36),
    "one-tile": (1, T, 72, 36),
    "tile-plus-one": (1, T + 1, 72, 36),
    "ragged-last-tile": (1, 3 * T + 517, 128, 60),
    "overflow": (1, 2 * T + 100, 72, 15),
    "two-groups": (2, T + 300, 72, 40),
}


@pytest.mark.parametrize("case", list(SLOT_CASES))
def test_expert_slots_plain_equals_a_loop_over_the_copies(case):
    g, n, e, cap = SLOT_CASES[case]
    rng = np.random.default_rng(5)
    weight = rng.random(e) ** 3 + 0.02          # some experts far more popular
    ids = rng.choice(e, size=(g, n), p=weight / weight.sum())
    dst, keep = moe_route.expert_slots_plain(torch.from_numpy(ids), e, cap)
    want_dst, want_keep = _slots_by_loop(ids, e, cap)
    assert dst.dtype == torch.int64 and keep.dtype == torch.bool
    np.testing.assert_array_equal(dst.numpy(), want_dst)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if case == "overflow":
        assert 0 < (~want_keep).sum() < want_keep.size


def test_expert_slots_on_the_cpu_run_the_plain_version(monkeypatch):
    monkeypatch.setitem(LAUNCHES, "moe_route", 0)
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, 72, (2, 2 * T + 5)))
    got = moe_route.expert_slots(ids, 72, 30)
    want = moe_route.expert_slots_plain(ids, 72, 30)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert LAUNCHES["moe_route"] == 0


def _einsum_chain(buf, w_gate, w_in, w_out, act):
    """moe_block's dense expert FFN off a mesh: ``_expert_einsum`` under
    ``NO_SHARD``, the activation and the product."""
    ctx = layers.NO_SHARD
    h = layers._ACTS[act](layers._expert_einsum(
        ctx, "gecd,edf->gecf", buf, w_gate)) \
        * layers._expert_einsum(ctx, "gecd,edf->gecf", buf, w_in)
    return layers._expert_einsum(ctx, "gecf,efd->gecd", h, w_out)


def _ffn_inputs(g, e, c, d, f, dtype, seed=3):
    """A dispatch buffer as the router leaves it (each expert's first
    slots hold copies, the rest and a third of the experts all zeros), the
    weights, and dst and keep naming the live slots."""
    gen = torch.Generator().manual_seed(seed)
    counts = torch.randint(0, c + 1, (g, e), generator=gen)
    counts[:, torch.randperm(e, generator=gen)[:e // 3]] = 0
    live = torch.arange(c)[None, None] < counts[..., None]      # (G, E, C)
    buf = torch.randn(g, e, c, d, generator=gen) * live[..., None]
    ws = [torch.randn(e, d, f, generator=gen) / d ** 0.5,
          torch.randn(e, d, f, generator=gen) / d ** 0.5,
          torch.randn(e, f, d, generator=gen) / f ** 0.5]
    slots = live.reshape(g, e * c)
    dst = torch.where(slots, torch.arange(e * c), e * c)
    return (buf.to(dtype), *(w.to(dtype) for w in ws), dst, slots)


# (G, E, C, D, F): the decode calls' (G, E, C) of qwen3-moe-30b-a3b (8
# tokens x top-8 of 128 experts) and granite-4.0-h-small (4 x top-10 of
# 72), with D and F cut from 2048 / 4096 and 768 for the CPU; two groups.
FFN_CASES = {
    "decode-qwen3-moe": (1, 128, 8, 128, 64),
    "decode-granite": (1, 72, 10, 256, 64),
    "two-groups": (2, 16, 12, 64, 128),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(FFN_CASES))
def test_expert_ffn_plain_equals_the_einsum_chain(case, dtype, monkeypatch):
    """``expert_ffn_plain`` is moe_block's einsum chain bit for bit, and
    ``expert_ffn`` on CPU tensors runs it and launches nothing."""
    monkeypatch.setitem(LAUNCHES, "moe_experts", 0)
    buf, wg, wi, wo, dst, keep = _ffn_inputs(*FFN_CASES[case], dtype)
    want = _einsum_chain(buf, wg, wi, wo, "silu")
    assert torch.equal(moe_experts.expert_ffn_plain(buf, wg, wi, wo, "silu"),
                       want)
    assert torch.equal(moe_experts.expert_ffn(buf, wg, wi, wo, dst, keep,
                                              "silu"), want)
    # An expert with no copy gives exact zeros, which the kernel writes.
    dead = buf.flatten(2).eq(0).all(-1)
    assert dead.any() and not want[dead].any()
    assert LAUNCHES["moe_experts"] == 0


# route: (card faked, dtype, batch rows, act, weights need grad, kernel
# calls).  The MoE stand-in has 8 experts of top-2 at capacity factor 1.25:
# 3 x 16 tokens give 15 slots an expert, 4 x 16 give 20.
EXPERT_ROUTES = {
    "kernel": (True, "bfloat16", 3, "silu", False, 1),
    "cpu-tensor": (False, "bfloat16", 3, "silu", False, 0),
    "f32": (True, "float32", 3, "silu", False, 0),
    "capacity-above-16": (True, "bfloat16", 4, "silu", False, 0),
    "requires-grad": (True, "bfloat16", 3, "silu", True, 0),
    "gelu": (True, "bfloat16", 3, "gelu", False, 0),
}


@pytest.mark.parametrize("route", list(EXPERT_ROUTES))
def test_moe_block_takes_the_expert_kernel_only_where_it_should(route,
                                                                monkeypatch):
    """The card is faked (``_on_card``) and the kernel's wrapper replaced
    by a counter that runs the plain version; the dense chain's einsums
    counted.  Either route gives the same output."""
    on_card, dtype, b, act, grad, want = EXPERT_ROUTES[route]
    _, cfg = _cfgs("qwen3-moe-30b-a3b", dtype=dtype, act=act)
    rng = np.random.default_rng(4)
    p = {k: torch.from_numpy(v).to(getattr(torch, dtype)).requires_grad_(grad)
         for k, v in _moe_params(cfg, rng).items()}
    x = torch.from_numpy(rng.standard_normal((b, 16, cfg.d_model))
                         ).to(getattr(torch, dtype))
    cap = layers.moe_capacity(b * 16, cfg)
    assert (cap <= moe_experts.MAX_ROWS) == (b == 3)
    y_dense = layers.moe_block(x, p, cfg)
    monkeypatch.setitem(LAUNCHES, "moe_experts", 0)
    if on_card:
        monkeypatch.setattr(moe_experts, "_on_card", lambda t: True)
    entered, dense = [], []
    monkeypatch.setattr(moe_experts, "expert_ffn",
                        lambda buf, wg, wi, wo, dst, keep, a:
                        (entered.append(buf.shape),
                         moe_experts.expert_ffn_plain(buf, wg, wi, wo, a))[1])
    einsum = layers._expert_einsum
    monkeypatch.setattr(layers, "_expert_einsum", lambda *a:
                        (dense.append(a[1]), einsum(*a))[1])
    y = layers.moe_block(x, p, cfg)
    assert len(entered) == want and len(dense) == 3 * (1 - want)
    assert entered == [(1, cfg.num_experts, cap, cfg.d_model)] * want
    assert torch.equal(y.detach(), y_dense.detach())
    assert y.requires_grad == grad
    assert LAUNCHES["moe_experts"] == 0


def test_expert_kernel_rule_keeps_a_mesh_on_the_einsums(monkeypatch):
    monkeypatch.setattr(moe_experts, "_on_card", lambda t: True)
    buf, *weights, _, _ = _ffn_inputs(1, 8, 4, 64, 64, torch.bfloat16)
    assert layers._experts_kernel(buf, weights, "silu", layers.NO_SHARD)
    assert not layers._experts_kernel(
        buf, weights, "silu", layers.ShardCtx(tp="model", active=True))


def _ssd_inputs(seed, b=2, t=32, h=3, pdim=4, n=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, pdim)).astype(np.float32)
    dt_a = -rng.random((b, t, h)).astype(np.float32) * 0.5
    bm = rng.standard_normal((b, t, n)).astype(np.float32)
    cm = rng.standard_normal((b, t, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, pdim, n)).astype(np.float32)
    return x, dt_a, bm, cm, s0


@pytest.mark.parametrize("chunk", [1, 8, 32])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference_and_recurrence(chunk, with_state):
    x, dt_a, bm, cm, s0 = _ssd_inputs(chunk)
    init = s0 if with_state else None
    y_ref, st_ref = ref_layers.ssd_chunked(
        x, dt_a, bm, cm, chunk=chunk,
        init_state=None if init is None else jnp.asarray(init))
    y, st = layers.ssd_chunked(
        *map(torch.from_numpy, (x, dt_a, bm, cm)), chunk=chunk,
        init_state=None if init is None else torch.from_numpy(init))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_ref), rtol=1e-5,
                               atol=1e-5)
    # S_t = exp(dt_a_t) S_{t-1} + x_t (x) B_t ; y_t = C_t . S_t
    state = (np.zeros(s0.shape) if init is None else s0).astype(np.float64)
    want = np.zeros(x.shape)
    for i in range(x.shape[1]):
        state = np.exp(dt_a[:, i])[..., None, None] * state \
            + np.einsum("bhp,bn->bhpn", x[:, i], bm[:, i])
        want[:, i] = np.einsum("bn,bhpn->bhp", cm[:, i], state)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(st.numpy(), state, rtol=1e-4, atol=1e-5)


def test_ssd_chunked_pads_a_ragged_chunk():
    """A ragged last chunk is padded with positions that leave the state
    as it is (x = 0, dt = 0): the outputs are those of a whole-chunk call
    over a longer input."""
    x, dt_a, bm, cm, _ = _ssd_inputs(0, t=12)
    args = list(map(torch.from_numpy, (x, dt_a, bm, cm)))
    y, state = layers.ssd_chunked(*args, chunk=8)
    assert y.shape[1] == 12
    longer = [torch.cat([a, torch.zeros_like(a[:, :4])], 1) for a in args]
    y16, state16 = layers.ssd_chunked(*longer, chunk=8)
    torch.testing.assert_close(y, y16[:, :12], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(state, state16, rtol=1e-6, atol=1e-6)


def test_causal_conv_decode_steps_equal_prefill():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 10, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    full, none = layers._causal_conv(x, w, None)
    assert none is None
    ref, _ = ref_layers._causal_conv(jnp.asarray(x.numpy()),
                                     jnp.asarray(w.numpy()), None)
    np.testing.assert_allclose(full.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    state = torch.zeros((2, 3, 6))
    for t in range(10):
        y, state = layers._causal_conv(x[:, t:t + 1], w, state)
        torch.testing.assert_close(y[:, 0], full[:, t], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(state, x[:, -3:])


def _mamba_params(cfg, rng):
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_num_heads
    p = {"w_z": rng.standard_normal((d, di)) / np.sqrt(d),
         "w_x": rng.standard_normal((d, di)) / np.sqrt(d),
         "w_bc": rng.standard_normal((d, 2 * n)) / np.sqrt(d),
         "w_dt": rng.standard_normal((d, h)) / np.sqrt(d),
         "w_conv": rng.standard_normal((cfg.conv_width, di + 2 * n)) / 2,
         "a_log": rng.standard_normal(h) * 0.5,
         "dt_bias": rng.standard_normal(h) - 2.0,
         "d_skip": rng.standard_normal(h),
         "w_norm": rng.standard_normal(di) * 0.1,
         "w_out": rng.standard_normal((di, d)) / np.sqrt(di)}
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}


def _mamba_cache(cfg, b):
    h = cfg.ssm_num_heads
    return {"ssm": torch.zeros((b, h, cfg.d_inner // h, cfg.ssm_state)),
            "conv": torch.zeros((b, cfg.conv_width - 1,
                                 cfg.d_inner + 2 * cfg.ssm_state)),
            "len": 0}


@pytest.mark.parametrize("s,steps,chunk", [(15, 1, 32), (16, 8, 8)])
def test_mamba_prefill_then_decode_equals_longer_prefill(s, steps, chunk):
    cfg = dataclasses.replace(scaled_down(get_config("mamba2-370m")),
                              ssm_chunk=chunk)
    rng = np.random.default_rng(9)
    p = _mamba_params(cfg, rng)
    b = 2
    x = torch.from_numpy(rng.standard_normal(
        (b, s + steps, cfg.d_model)).astype(np.float32))
    want, want_cache = layers.mamba_block(x, p, cfg,
                                          cache=_mamba_cache(cfg, b))
    cache = _mamba_cache(cfg, b)
    ssm, conv = cache["ssm"], cache["conv"]
    y, got_cache = layers.mamba_block(x[:, :s], p, cfg, cache=cache)
    assert got_cache["ssm"] is ssm and got_cache["len"] == s   # in place
    outs = []
    for t in range(s, s + steps):
        yt, _ = layers.mamba_block(x[:, t:t + 1], p, cfg, cache=cache)
        outs.append(yt)
    torch.testing.assert_close(y, want[:, :s], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat(outs, 1), want[:, s:], rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(ssm, want_cache["ssm"], rtol=1e-4, atol=1e-5)
    # The conv tail holds input projections, one token's matmul against
    # the whole sequence's: equal up to the last bits.
    torch.testing.assert_close(conv, want_cache["conv"], rtol=1e-5,
                               atol=1e-6)
