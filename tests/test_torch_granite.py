"""The port's granite-4.0-h pieces, one at a time, on the CPU in float32:
NoPE attention at a softmax scale of its own, the shared expert, the
embedding, residual and logits multipliers, the Mamba-2 conv bias, the
``mamba_moe`` block, and ``ssd_chunked`` at any length.  The whole model
is held against the plain reference in ``bench/test_bench_hybrid.py``.

Tolerances: 1e-5 absolute and relative on float32 values of order one,
where the two sides differ only in the order of their sums."""

from __future__ import annotations

import dataclasses
import math

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.decode_attention import fused_decode_attention
from repro_torch.models import (forward, init_cache, init_params,
                                scaled_down)
from repro_torch.models.config import MAMBA_KINDS, ModelConfig
from repro_torch.models.layers import (attention_block, mamba_block,
                                       mlp_block, moe_block, rope_cos_sin,
                                       ssd_chunked)
from repro_torch.models.model import (_apply_block, embed_tokens,
                                      logits_from_hidden)

TOL = dict(rtol=1e-5, atol=1e-5)

GRANITE = ModelConfig(
    name="granite-tiny", family="hybrid_moe", num_layers=10, d_model=32,
    d_ff=16, vocab_size=64, num_heads=4, num_kv_heads=2, head_dim=8,
    rope_variant="none",
    pattern=("mamba_moe",) * 5 + ("attn_moe",) + ("mamba_moe",) * 4,
    num_experts=4, num_experts_per_tok=2, capacity_factor=100.0,
    shared_expert_ff=24, ssm_state=8, ssm_head_dim=8, ssm_chunk=4,
    conv_bias=True, tie_embeddings=True, embedding_multiplier=12.0,
    residual_multiplier=0.22, attention_multiplier=1 / 128,
    logits_scaling=16.0, dtype="float32")

#: The fields the port adds to the reference's ``ModelConfig``, at the
#: values that leave a configuration as the reference has it.
NEUTRAL = {"shared_expert_ff": 0, "conv_bias": False,
           "embedding_multiplier": 1.0, "residual_multiplier": 1.0,
           "attention_multiplier": 0.0, "logits_scaling": 1.0}


def params(seed=0):
    return init_params(GRANITE, seed=seed, device="cpu")


def randn(*shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def plain_attention(q, k, v, scale):
    """Causal GQA, no rotary: q (B, S, H, D), k/v (B, S, K, D)."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    k, v = (t.repeat_interleave(rep, 2) for t in (k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    p = torch.softmax(sc.masked_fill(~mask, float("-inf")), -1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, h * d)


@pytest.mark.parametrize("path", ["prefill", "train", "decode_plain",
                                  "decode_fused"])
def test_nope_attention_at_the_configured_scale(path):
    """q.k times 1/128 (not 1/sqrt(8)), no rotation, on every path: the
    prefill into a cache, the cacheless forward, and a decode step
    through the plain ops and through the fused kernel's plain version
    with its identity angles."""
    p = params()["groups"][5]["attn"]
    p = {k: v[0] for k, v in p.items()}
    x = randn(2, 6, GRANITE.d_model, seed=1)
    q = (x @ p["wq"]).reshape(2, 6, 4, 8)
    k = (x @ p["wk"]).reshape(2, 6, 2, 8)
    v = (x @ p["wv"]).reshape(2, 6, 2, 8)
    want = plain_attention(q, k, v, 1 / 128) @ p["wo"]
    pos = torch.arange(6)[None].expand(2, 6)
    if path in ("prefill", "train"):
        cache = None
        if path == "prefill":
            c = init_cache(GRANITE, 2, 8, device="cpu")["groups"][5]
            cache = {"k": c["k"][0], "v": c["v"][0], "len": 0}
        got, _ = attention_block(x, p, GRANITE, positions=pos, cache=cache)
        torch.testing.assert_close(got, want, **TOL)
        return
    c = init_cache(GRANITE, 2, 8, device="cpu")["groups"][5]
    cache = {"k": c["k"][0], "v": c["v"][0], "len": 0}
    attention_block(x[:, :5], p, GRANITE, positions=pos[:, :5], cache=cache)
    cache["len"] = torch.full((2,), 5, dtype=torch.int32)
    got, _ = attention_block(x[:, 5:], p, GRANITE, positions=pos[:, 5:],
                             cache=cache, fused=path == "decode_fused")
    torch.testing.assert_close(got[:, 0], want[:, 5], **TOL)


def test_nope_angles_are_the_identity_rotation():
    cos, sin = rope_cos_sin(torch.arange(5)[None], 8, GRANITE)
    assert cos.shape == (1, 5, 4) and torch.equal(cos, torch.ones_like(cos))
    assert torch.equal(sin, torch.zeros_like(sin))
    q, kv = randn(1, 1, 4, 8, seed=2), randn(1, 1, 2, 8, seed=3)
    kc, vc = torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8)
    fused_decode_attention(q, kv, kv, kc, vc, 0, cos[:, 0], sin[:, 0])
    assert torch.equal(kc[:, 0], kv[:, 0])     # written as given: no rotation


def test_the_shared_expert_adds_to_the_routed_experts():
    p = params()["groups"][0]["moe"]
    p = {k: (v[0] if torch.is_tensor(v) else {kk: vv[0] for kk, vv in
                                               v.items()})
         for k, v in p.items()}
    x = randn(2, 5, GRANITE.d_model, seed=4)
    routed = moe_block(x, {k: v for k, v in p.items() if k != "shared"},
                       GRANITE)
    s = p["shared"]
    want = routed + (F.silu(x @ s["w_gate"]) * (x @ s["w_in"])) @ s["w_out"]
    torch.testing.assert_close(moe_block(x, p, GRANITE), want, **TOL)
    torch.testing.assert_close(mlp_block(x, s, GRANITE), want - routed, **TOL)


def test_the_embedding_multiplier_and_the_tied_head_scaling():
    w = params()
    tok = torch.tensor([[3, 7, 63]])
    torch.testing.assert_close(embed_tokens(w, tok, GRANITE),
                               w["embed"][tok] * 12.0)
    assert torch.equal(embed_tokens(w, tok), w["embed"][tok])
    h = randn(1, 3, GRANITE.d_model, seed=5)
    xn = h * torch.rsqrt((h * h).mean(-1, keepdim=True) + GRANITE.norm_eps) \
        * (1 + w["final_norm"])
    torch.testing.assert_close(logits_from_hidden(w, h, GRANITE),
                               xn @ w["embed"].T / 16.0, **TOL)


def test_the_residual_multiplier_scales_both_branches():
    """A ``mamba_moe`` block: h + 0.22 * mixer(norm1(h)), then + 0.22 *
    MoE(norm2(.))."""
    from repro_torch.models.layers import rms_norm
    bp = {k: (v[0] if torch.is_tensor(v) else
              {kk: (vv[0] if torch.is_tensor(vv) else
                    {a: b[0] for a, b in vv.items()})
               for kk, vv in v.items()})
          for k, v in params()["groups"][0].items()}
    h = randn(2, 8, GRANITE.d_model, seed=6)
    got, _ = _apply_block(h, bp, "mamba_moe", GRANITE, positions=None)
    mix, _ = mamba_block(rms_norm(h, bp["norm1"], 1e-5), bp["mamba"], GRANITE)
    mid = h + 0.22 * mix
    want = mid + 0.22 * moe_block(rms_norm(mid, bp["norm2"], 1e-5),
                                  bp["moe"], GRANITE)
    torch.testing.assert_close(got, want, **TOL)


def test_the_conv_bias_enters_prefill_and_decode_alike():
    """The prefill's last position equals a decode step from the state of
    the prefill before it, with the bias on both paths; the bias moves the
    output."""
    p = {k: v[0] for k, v in params()["groups"][0]["mamba"].items()}
    p["conv_bias"] = randn(*p["conv_bias"].shape, seed=8)  # init: zeros
    x = randn(2, 9, GRANITE.d_model, seed=7)
    c = init_cache(GRANITE, 2, 16, device="cpu")["groups"][0]
    full, _ = mamba_block(x, p, GRANITE)
    cache = {"ssm": c["ssm"][0], "conv": c["conv"][0], "len": 0}
    mamba_block(x[:, :8], p, GRANITE, cache=cache)
    step, _ = mamba_block(x[:, 8:], p, GRANITE, cache=cache)
    torch.testing.assert_close(step[:, 0], full[:, 8], **TOL)
    unbiased = {k: v for k, v in p.items() if k != "conv_bias"}
    assert not torch.allclose(mamba_block(x, unbiased, GRANITE)[0], full,
                              **TOL)


def recurrence(x, dt_a, b, c, state=None):
    """The SSM stepped position by position: h <- exp(dt A) h + x (x) B,
    y = C.h (x already times dt)."""
    bsz, t, h, p = x.shape
    hs = torch.zeros(bsz, h, p, b.shape[-1]) if state is None else \
        state.clone()
    ys = []
    for i in range(t):
        hs = torch.exp(dt_a[:, i])[..., None, None] * hs \
            + x[:, i, :, :, None] * b[:, i, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", hs, c[:, i]))
    return torch.stack(ys, 1), hs


def ssd_inputs(t, seed):
    x = randn(2, t, 3, 4, seed=seed)
    dt_a = -torch.rand(2, t, 3, generator=torch.Generator().manual_seed(seed))
    return x, dt_a, randn(2, t, 5, seed=seed + 1), randn(2, t, 5, seed=seed + 2)


@pytest.mark.parametrize("t", [1, 5, 7, 9, 13])
def test_ssd_chunked_takes_any_length(t):
    """A length that is not a multiple of the chunk: the stepped
    recurrence's outputs and final state, from a given state."""
    x, dt_a, b, c = ssd_inputs(t, 10 + t)
    init = randn(2, 3, 4, 5, seed=9)
    y, state = ssd_chunked(x, dt_a, b, c, chunk=4, init_state=init)
    want_y, want_state = recurrence(x, dt_a, b, c, init)
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(state, want_state, **TOL)


def test_ssd_chunked_padding_leaves_a_multiple_as_it_was():
    """At a multiple of the chunk nothing is padded; the padded form's
    first chunks are the unpadded form's exactly."""
    x, dt_a, b, c = ssd_inputs(12, 3)
    y, state = ssd_chunked(x, dt_a, b, c, chunk=4)
    y9, _ = ssd_chunked(x[:, :9], dt_a[:, :9], b[:, :9], c[:, :9], chunk=4)
    y8, state8 = ssd_chunked(x[:, :8], dt_a[:, :8], b[:, :8], c[:, :8],
                             chunk=4)
    torch.testing.assert_close(y[:, :8], y8, rtol=0, atol=0)
    torch.testing.assert_close(y9[:, :8], y8, rtol=0, atol=0)
    torch.testing.assert_close(y9, y[:, :9], **TOL)
    want_y, want_state = recurrence(x, dt_a, b, c)
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(state, want_state, **TOL)


def test_a_granite_stack_forward_runs_every_kind():
    w = params()
    lg = forward(w, GRANITE, tokens=torch.tensor([[1, 2, 3, 4, 5, 6, 7]]))
    assert lg.shape == (1, 7, 64) and torch.isfinite(lg).all()
    assert set(GRANITE.pattern) <= {"attn_moe", *MAMBA_KINDS}
    assert GRANITE.has_attention
    assert not dataclasses.replace(GRANITE, pattern=("mamba_moe",)) \
        .has_attention


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_the_ports_own_fields_are_neutral_in_every_arch(arch):
    for cfg in (get_config(arch), scaled_down(get_config(arch))):
        assert {k: getattr(cfg, k) for k in NEUTRAL} == NEUTRAL
        assert "mamba_moe" not in cfg.pattern


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _ops(cfg, w, tok):
    with _Count() as c:
        forward(w, cfg, tokens=tok)
    return c.n


def test_neutral_multipliers_add_no_operation():
    """Each multiplier, set, adds exactly its own operations to a forward
    pass; at its neutral value it adds none."""
    base = scaled_down(get_config("chatglm3-6b"))
    w = init_params(base, seed=0, device="cpu")
    tok = torch.tensor([[1, 2, 3, 4]])
    n0 = _ops(base, w, tok)
    layers = base.num_layers
    for field, value, extra in (("embedding_multiplier", 12.0, 1),
                                ("logits_scaling", 16.0, 1),
                                ("residual_multiplier", 0.22, 2 * layers),
                                ("attention_multiplier", 0.01, layers)):
        cfg = dataclasses.replace(base, **{field: value})
        assert _ops(cfg, w, tok) == n0 + extra, field
    assert math.isclose(GRANITE.attention_multiplier * 128, 1.0)


@pytest.mark.parametrize("per", [1, 2, 3])
def test_ssd_chunked_slices_a_long_call_without_changing_it(per,
                                                             monkeypatch):
    """Over ``SSD_SLICE_BYTES`` the intra-chunk term runs over slices of
    ``per`` chunks: the same outputs and state, bit for bit."""
    from repro_torch.models import layers
    x, dt_a, b, c = ssd_inputs(21, 4)
    whole = ssd_chunked(x, dt_a, b, c, chunk=4)
    monkeypatch.setattr(layers, "SSD_SLICE_BYTES", 2 * 3 * 4 * 4 * 4 * per)
    sliced = ssd_chunked(x, dt_a, b, c, chunk=4)
    for a, w in zip(sliced, whole):
        assert torch.equal(a, w)


@pytest.mark.parametrize("arch", ["granite", "chatglm3-6b"])
def test_the_slot_prefill_runs_the_head_on_the_last_position(arch,
                                                             monkeypatch):
    """``prefill(last_only=True)`` gives the full prefill's last logits,
    and the slot-prefill step hands the head that one position alone, so
    a long refill holds no logits over its prompt."""
    from repro_torch.launch import steps
    from repro_torch.models import model as model_mod
    from repro_torch.models import prefill
    cfg = (GRANITE if arch == "granite"
           else scaled_down(get_config(arch), dtype="float32"))
    w = init_params(cfg, seed=3, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(5))
    full, _ = prefill(w, cfg, caches=init_cache(cfg, 2, 16, device="cpu"),
                      tokens=toks)
    last, _ = prefill(w, cfg, caches=init_cache(cfg, 2, 16, device="cpu"),
                      tokens=toks, last_only=True)
    assert last.shape == (2, 1, full.shape[-1])
    torch.testing.assert_close(last, full[:, -1:], **TOL)
    rows = []
    head = model_mod.logits_from_hidden

    def spy(p, h, *a, **k):
        rows.append(h.shape[1])
        return head(p, h, *a, **k)
    monkeypatch.setattr(model_mod, "logits_from_hidden", spy)
    step = steps.make_slot_prefill_step(cfg, 2, max_len=16,
                                        device=torch.device("cpu"))
    live = init_cache(cfg, 2, 16, device="cpu")
    out = step(w, {"tokens": toks}, live, torch.tensor([True, False]))
    assert rows == [1]
    assert out["next_token"].tolist() == full[:, -1].argmax(-1).tolist()
