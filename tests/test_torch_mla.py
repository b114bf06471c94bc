"""The port's DeepSeek-V3 pieces (kanana-2-30b-a3b), one at a time, on the
CPU in float32: multi-head latent attention's absorbed decode against its
decompressed form, the latent cache, interleaved rotary pairs, the sigmoid
router with its score-correction bias and scaling, the leading dense layer,
the parameter count at published widths, the cache bytes a call moves, and
the prefill's route to the prefill-attention kernel at widths (192, 128)
and the decode's to the latent decode-attention kernels at (576, 512)
(which the ``cuda`` cases hold against their plain version on the card).
The whole model is held against the plain reference in
``bench/test_bench_mla.py``.

Tolerances: 1e-5 absolute and relative on float32 values of order one,
where the two sides differ only in the order of their sums (the absorbed
decode reassociates q.(c W_uk) as (q W_uk^T).c and p.(c W_uv) as
(p.c) W_uv; the largest difference read 1.2e-6 when these tests were
written)."""

from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from repro_torch.configs import ARCH_IDS, PORT_ARCH_IDS, get_config
from repro_torch.configs.kanana_2_30b_a3b import CONFIG, SCALED_DOWN
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import prefill_attention as PA
from repro_torch.models import (cache_bytes, decode_step, forward,
                                init_cache, init_params, prefill, scaled_down)
from repro_torch.models import layers
from repro_torch.models.config import MLA_KINDS, MOE_KINDS, ModelConfig
from repro_torch.models.layers import apply_rope, mla_block, moe_route

TOL = dict(rtol=1e-5, atol=1e-5)

#: The fields this configuration adds to ``ModelConfig``, at the values
#: that leave every other configuration as it was.
NEUTRAL = {"router_scoring": "softmax", "routed_scaling": 1.0,
           "dense_d_ff": 0, "kv_lora_rank": 0, "qk_nope_head_dim": 0,
           "qk_rope_head_dim": 0, "v_head_dim": 0, "rope_interleave": False}


def randn(*shape, seed=0, scale=1.0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)) \
        * scale


def mla_params(cfg, seed=0):
    """One layer's MLA leaves, drawn at fan-in scales, the latent's norm
    scale away from 0 (init_params draws it 0)."""
    w = init_params(cfg, seed=seed, device="cpu")
    p = {k: v[0].clone() for k, v in w["groups"][1]["mla"].items()}
    p["kv_norm"] = randn(cfg.kv_lora_rank, seed=seed + 1, scale=0.1)
    return p


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_the_new_fields_are_neutral_in_every_arch(arch):
    for cfg in (get_config(arch), scaled_down(get_config(arch))):
        assert {k: getattr(cfg, k) for k in NEUTRAL} == NEUTRAL
        assert not set(cfg.pattern) & set(MLA_KINDS)


def test_the_config_holds_the_published_parameter_count():
    """30.67 B at published widths: 48 MLA layers (q 32 x 192 from the
    hidden state, a 512 latent and a 64 shared key, keys and values 32 x
    (128 + 128) from the latent, out 32 x 128), one dense FFN of 6144, 47
    MoE FFNs (a router of 128 and its bias, 128 experts of 768, a shared
    expert of 1536), an untied head over 128,256."""
    assert get_config("kanana-2-30b-a3b") is CONFIG
    assert PORT_ARCH_IDS == ("kanana-2-30b-a3b",)
    d, v = 2048, 128_256
    mla = (d * 32 * 192 + d * 576 + 512 + 512 * 32 * 256 + 32 * 128 * d)
    moe = d * 128 + 128 + 128 * 3 * d * 768 + 3 * d * 1536
    want = (2 * v * d + d + 48 * (mla + 2 * d) + 3 * d * 6144 + 47 * moe)
    assert CONFIG.param_count() == want == 30_670_815_104
    assert CONFIG.active_param_count() == \
        want - 47 * (128 - 6) * 3 * d * 768
    tree = init_params(CONFIG, device="meta")
    n = sum(t.numel() for t in _leaves(tree))
    assert n == want


def _leaves(t):
    if isinstance(t, torch.Tensor):
        return [t]
    items = t.values() if isinstance(t, dict) else t
    return [x for v in items for x in _leaves(v)]


def test_the_leading_layer_is_dense_at_its_own_width():
    tree = init_params(CONFIG, device="meta")
    first, rest = tree["groups"][0], tree["groups"][1]
    assert set(first) == {"norm1", "norm2", "mla", "mlp"}
    assert tuple(first["mlp"]["w_gate"].shape) == (1, 2048, 6144)
    assert tuple(first["mlp"]["w_out"].shape) == (1, 6144, 2048)
    assert set(rest) == {"norm1", "norm2", "mla", "moe"}
    assert tuple(rest["moe"]["w_gate"].shape) == (1, 128, 2048, 768)
    assert tuple(rest["moe"]["router_bias"].shape) == (1, 128)
    assert tuple(rest["moe"]["shared"]["w_in"].shape) == (1, 2048, 1536)
    assert CONFIG.pattern.count("mla") == 1 and CONFIG.full_groups == 1
    assert sum(k in MOE_KINDS for k in CONFIG.pattern) == 47


def test_the_cache_holds_one_latent_a_position_and_nothing_per_head():
    caches = init_cache(CONFIG, 4, 8256, device="meta")
    for entry in caches["groups"]:
        assert set(entry) == {"latent"}
        assert tuple(entry["latent"].shape) == (1, 4, 8256, 576)
        assert entry["latent"].dtype == torch.bfloat16
    per_position = 48 * 576 * 2
    assert cache_bytes(CONFIG, [0], 1) == per_position == 55_296
    with pytest.raises(ValueError):
        init_cache(dataclasses.replace(CONFIG, kv_quant=True), 1, 8,
                   device="meta")


def test_cache_bytes_counts_every_kind():
    """Keys and values (a local layer's window of them), the latent, the
    SSM state and conv window, by hand."""
    glm = get_config("chatglm3-6b")
    kv = 2 * 2 * 128 * 2
    assert cache_bytes(glm, [10, 20], 1) == 28 * kv * (11 + 21)
    assert cache_bytes(glm, [0, 0], 64) == 28 * kv * 128
    gemma = get_config("gemma3-12b")
    kinds = list(gemma.pattern) * gemma.full_groups + list(gemma.tail)
    per = 2 * gemma.num_kv_heads * gemma.qk_head_dim * 2
    want = sum(per * ((min(5000, gemma.sliding_window) if k == "local"
                       else 5000) + 1) for k in kinds)
    assert cache_bytes(gemma, [5000], 1) == want
    mamba = get_config("mamba2-370m")
    h = mamba.ssm_num_heads
    state = (h * (mamba.d_inner // h) * mamba.ssm_state * 4
             + 3 * (mamba.d_inner + 2 * mamba.ssm_state) * 2)
    assert cache_bytes(mamba, [7, 9, 0], 1) == 48 * state * 3 * 2
    assert cache_bytes(mamba, [0, 0], 100) == 48 * state * 2
    assert cache_bytes(CONFIG, [0] * 4, 8192) == 4 * 8192 * 55_296


def test_the_config_refuses_mla_without_its_widths():
    with pytest.raises(ValueError):
        dataclasses.replace(CONFIG, kv_lora_rank=0)
    with pytest.raises(ValueError):
        dataclasses.replace(CONFIG, router_scoring="softplus")


def test_interleaved_rope_rotates_pairs_in_place():
    """Gathering the even dims before the odd ones and rotating halves
    gives every q.k of rotating each pair (2i, 2i+1) in place."""
    cfg = dataclasses.replace(SCALED_DOWN, rope_theta=10_000.0)
    q, k = randn(1, 5, 2, 8, seed=1), randn(1, 5, 1, 8, seed=2)
    pos = torch.arange(5)[None]
    got = torch.einsum("bqhd,bskd->bhqs", apply_rope(q, pos, cfg),
                       apply_rope(k, pos, cfg))

    def in_place(x):
        inv = 1.0 / (10_000.0 ** (torch.arange(4) / 4))
        ang = torch.arange(5)[:, None] * inv               # (S, 4)
        c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x0, x1 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], -1).flatten(-2)

    want = torch.einsum("bqhd,bskd->bhqs", in_place(q), in_place(k))
    torch.testing.assert_close(got, want, **TOL)
    plain = dataclasses.replace(cfg, rope_interleave=False)
    assert not torch.allclose(
        torch.einsum("bqhd,bskd->bhqs", apply_rope(q, pos, plain),
                     apply_rope(k, pos, plain)), want, **TOL)


@pytest.mark.parametrize("prompt", [1, 6])
def test_the_absorbed_decode_equals_the_decompressed_attention(prompt):
    """A prefill of ``prompt`` positions into the latent cache, then
    decode steps at per-row lengths, against the decompressed attention
    (no cache) over the whole sequence: every position of every row."""
    cfg = SCALED_DOWN
    p = mla_params(cfg, seed=3)
    x = randn(2, 11, cfg.d_model, seed=4)
    pos = torch.arange(11)[None].expand(2, 11)
    want, none = mla_block(x, p, cfg, positions=pos)
    assert none is None
    cache = {"latent": torch.zeros(2, 16, cfg.mla_latent_dim), "len": 0}
    y, cache = mla_block(x[:, :prompt], p, cfg, positions=pos[:, :prompt],
                         cache=cache)
    outs = [y]
    for t in range(prompt, 11):
        y, cache = mla_block(x[:, t:t + 1], p, cfg,
                             positions=pos[:, t:t + 1], cache=cache)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), want, **TOL)
    assert cache["len"].tolist() == [11, 11]
    # The cache holds each position's normed latent and roped shared key.
    assert bool(cache["latent"][:, :11].abs().sum(-1).gt(0).all())
    assert bool(cache["latent"][:, 11:].eq(0).all())


def test_the_decode_reads_only_the_latent_cache():
    """Rows at other lengths: each row's step sees its own prefix alone,
    and a cache position past a row's length changes nothing."""
    cfg = SCALED_DOWN
    p = mla_params(cfg, seed=5)
    x = randn(2, 1, cfg.d_model, seed=6)
    lat = randn(2, 12, cfg.mla_latent_dim, seed=7)
    lens = torch.tensor([3, 9], dtype=torch.int32)
    pos = lens[:, None]
    a, _ = mla_block(x, p, cfg, positions=pos,
                     cache={"latent": lat.clone(), "len": lens})
    junk = lat.clone()
    junk[0, 4:] = 1e3
    junk[1, 10:] = -1e3
    b, _ = mla_block(x, p, cfg, positions=pos,
                     cache={"latent": junk, "len": lens})
    assert torch.equal(a, b)


def _router_cfg(**kw):
    return dataclasses.replace(SCALED_DOWN, num_experts=8,
                               num_experts_per_tok=2, **kw)


def test_the_sigmoid_router_picks_and_weighs_as_published():
    """The k largest sigmoid(logit) + bias pick; the unbiased scores weigh,
    over their sum, times the scaling; logits in f32."""
    cfg = _router_cfg()
    x = randn(1, 5, cfg.d_model, seed=8)
    w = randn(cfg.d_model, 8, seed=9, scale=cfg.d_model ** -0.5)
    bias = randn(8, seed=10, scale=0.05)
    ids, gates, dst, keep = moe_route(x, w, cfg, cap=10, bias=bias)
    scores = torch.sigmoid(x[0] @ w)
    want = torch.argsort(scores + bias, dim=-1, descending=True,
                         stable=True)[:, :2]
    assert torch.equal(ids[0], want)
    picked = scores.gather(1, want)
    torch.testing.assert_close(
        gates[0], picked / picked.sum(-1, keepdim=True) * 2.448, **TOL)
    assert gates.dtype == torch.float32 and bool(keep.all())


def test_the_bias_changes_the_pick_and_not_the_weights():
    """A bias large enough to move one expert into a token's top two: the
    pick changes, and that expert is weighed by its own sigmoid score."""
    cfg = _router_cfg()
    x = randn(1, 1, cfg.d_model, seed=11)
    w = randn(cfg.d_model, 8, seed=12, scale=cfg.d_model ** -0.5)
    scores = torch.sigmoid(x[0, 0] @ w)
    order = torch.argsort(scores, descending=True)
    last = int(order[-1])
    bias = torch.zeros(8)
    bias[last] = 2.0
    plain, _, _, _ = moe_route(x, w, cfg, cap=2)
    ids, gates, _, _ = moe_route(x, w, cfg, cap=2, bias=bias)
    assert plain[0, 0].tolist() == order[:2].tolist()
    assert ids[0, 0].tolist() == [last, int(order[0])]
    s = scores[[last, int(order[0])]]
    torch.testing.assert_close(gates[0, 0], s / s.sum() * 2.448, **TOL)


def test_the_softmax_router_is_unchanged():
    """The softmax branch: a softmax over the top-k logits, whatever the
    sigmoid fields hold elsewhere."""
    cfg = dataclasses.replace(_router_cfg(), router_scoring="softmax",
                              routed_scaling=1.0)
    x = randn(1, 4, cfg.d_model, seed=13)
    w = randn(cfg.d_model, 8, seed=14)
    ids, gates, _, _ = moe_route(x, w, cfg, cap=8)
    top, want = torch.sort(x[0] @ w, dim=-1, descending=True, stable=True)
    assert torch.equal(ids[0], want[:, :2])
    torch.testing.assert_close(gates[0], torch.softmax(top[:, :2], -1),
                               **TOL)


def test_prefill_then_decode_equals_the_forward_pass():
    """The model through the latent cache (dropless capacity) against its
    own forward pass, every position: the dense layer and the MoE layers
    with the bias and scaling in place."""
    cfg = dataclasses.replace(SCALED_DOWN, capacity_factor=100.0)
    w = init_params(cfg, seed=15, device="cpu")
    for g in w["groups"][1:]:
        g["moe"]["router_bias"].normal_(0.0, 0.05,
                                        generator=torch.Generator()
                                        .manual_seed(16))
    toks = torch.randint(0, cfg.vocab_size, (2, 14),
                         generator=torch.Generator().manual_seed(17))
    full = forward(w, cfg, tokens=toks)
    caches = init_cache(cfg, 2, 16, device="cpu")
    lg, caches = prefill(w, cfg, caches=caches, tokens=toks[:, :9])
    got = [lg[:, -1]]
    for t in range(9, 14):
        lg, caches = decode_step(w, cfg, toks[:, t:t + 1], caches, t)
        got.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(got, 1), full[:, 8:], **TOL)


def _published_widths_tiny():
    """The published head widths (q and k 128 + 64, v 128), bf16, two
    heads, a narrow model around them."""
    return dataclasses.replace(
        SCALED_DOWN, d_model=64, num_heads=2, num_kv_heads=2, head_dim=192,
        kv_lora_rank=32, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, dtype="bfloat16")


@pytest.mark.parametrize("on_card,cached,want", [
    (True, True, 1), (False, True, 0), (True, False, 0)])
def test_the_prefill_takes_the_kernel_at_its_widths(on_card, cached, want,
                                                    monkeypatch):
    """The card faked (``_on_card``) and the kernel's entry counted: an MLA
    prefill into a cache hands the kernel q, k (B, S, H, 192) and v
    (B, S, H, 128); a CPU tensor and a forward pass without a cache run
    ``chunked_attention``; the route changes nothing but the function."""
    cfg = _published_widths_tiny()
    if on_card:
        monkeypatch.setattr(PA, "_on_card", lambda t: True)
    entered, plain = [], []
    monkeypatch.setattr(layers, "prefill_attention", lambda q, k, v:
                        (entered.append((q.shape, k.shape, v.shape)),
                         PA.prefill_attention_plain(q, k, v))[1])
    attend = layers.chunked_attention
    monkeypatch.setattr(layers, "chunked_attention", lambda q, k, v, **kw:
                        (plain.append(q.shape), attend(q, k, v, **kw))[1])
    p = {k: v.bfloat16() for k, v in mla_params(
        dataclasses.replace(cfg, dtype="float32"), seed=18).items()}
    x = randn(2, 24, 64, seed=19).bfloat16()
    pos = torch.arange(24)[None].expand(2, 24)
    cache = ({"latent": torch.zeros(2, 24, 96, dtype=torch.bfloat16),
              "len": 0} if cached else None)
    y, _ = mla_block(x, p, cfg, positions=pos, cache=cache)
    assert len(entered) == want and len(plain) == 1 - want
    if want:
        assert entered == [((2, 24, 2, 192), (2, 24, 2, 192),
                            (2, 24, 2, 128))]
        assert PA.takes(*(torch.empty(s, dtype=torch.bfloat16)
                          for s in entered[0]))
    monkeypatch.setattr(PA, "_on_card", lambda t: False)
    y_plain, _ = mla_block(x, p, cfg, positions=pos,
                           cache=None if cache is None else
                           dict(cache, latent=cache["latent"].clone()))
    assert torch.equal(y, y_plain)


def test_the_kernel_widths_and_the_plain_version_take_a_narrower_v():
    """``WIDTHS`` adds (192, 128) to the equal widths; the plain version
    attends with v narrower than q and k, as a reference loop does."""
    assert PA.WIDTHS == ((64, 64), (128, 128), (256, 256), (192, 128))
    q, k = randn(1, 9, 2, 12, seed=20), randn(1, 9, 2, 12, seed=21)
    v = randn(1, 9, 2, 5, seed=22)
    got = PA.prefill_attention_plain(q, k, v, kv_chunk=4)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(12)
    s = s.masked_fill(torch.ones(9, 9, dtype=torch.bool).triu(1), -math.inf)
    want = torch.einsum("bhqk,bkhv->bqhv", torch.softmax(s, -1), v)
    torch.testing.assert_close(got, want, **TOL)
    with pytest.raises(ValueError):
        PA._check(*(torch.empty(s, dtype=torch.bfloat16) for s in
                    ((1, 8, 2, 192), (1, 8, 2, 192), (1, 8, 2, 64))), 0)
    PA._check(*(torch.empty(s, dtype=torch.bfloat16) for s in
                ((1, 8, 2, 192), (1, 8, 2, 192), (1, 8, 2, 128))), 0)


def test_the_scaled_down_config_keeps_every_kind():
    assert SCALED_DOWN.pattern == ("mla", "mla_moe", "mla_moe", "mla_moe")
    assert SCALED_DOWN.dtype == "float32"
    assert SCALED_DOWN.router_scoring == "sigmoid"
    assert (SCALED_DOWN.kv_lora_rank, SCALED_DOWN.qk_nope_head_dim,
            SCALED_DOWN.qk_rope_head_dim, SCALED_DOWN.v_head_dim,
            SCALED_DOWN.dense_d_ff) == (32, 16, 8, 16, 192)
    assert isinstance(SCALED_DOWN, ModelConfig)


def _latent_case(b, h, slots, lens, seed, dtype=torch.float32):
    """q (B, H, 576) and a latent cache (B, slots, 576) of order-one values,
    and the live rows ``lens`` (B,) int32."""
    q = randn(b, h, 576, seed=seed).to(dtype)
    lat = randn(b, slots, 576, seed=seed + 1).to(dtype)
    return q, lat, torch.tensor(lens, dtype=torch.int32)


def test_the_latent_attention_is_one_softmax_over_the_live_rows():
    """Off the card the plain version runs: per head one softmax of
    q.row / scale over the row's live positions, and its weights times
    the rows' leading 512 values (the latent, not the shared key)."""
    q, lat, lens = _latent_case(2, 4, 40, [1, 33], seed=30)
    assert not DA.latent_kernel_takes(q, lat, lens, 512)
    got = DA.latent_decode_attention(q, lat, lens, 512, math.sqrt(192))
    assert torch.equal(got, DA.latent_decode_attention_plain(
        q, lat, lens, 512, math.sqrt(192)))
    for i, n in enumerate(lens.tolist()):
        w = torch.softmax(q[i] @ lat[i, :n].T / math.sqrt(192), -1)
        torch.testing.assert_close(got[i], w @ lat[i, :n, :512], **TOL)


def test_the_decode_hands_the_latent_attention_its_query_and_cache(
        monkeypatch):
    """A decode step attends through ``latent_decode_attention``: every
    head's query over the latent and shared key, the whole latent cache,
    the lengths counting the new token, R and 1/sqrt(Dn + Dr)."""
    cfg = SCALED_DOWN
    seen = []

    def spy(q, latent, lens, dv, scale):
        seen.append((tuple(q.shape), tuple(latent.shape), lens.tolist(),
                     dv, scale))
        return DA.latent_decode_attention_plain(q, latent, lens, dv, scale)

    monkeypatch.setattr(layers, "latent_decode_attention", spy)
    p = mla_params(cfg, seed=31)
    lens = torch.tensor([3, 9], dtype=torch.int32)
    mla_block(randn(2, 1, cfg.d_model, seed=32), p, cfg,
              positions=lens[:, None],
              cache={"latent": randn(2, 12, cfg.mla_latent_dim, seed=33),
                     "len": lens})
    r, dn, dr = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    assert seen == [((2, cfg.num_heads, r + dr), (2, 12, r + dr), [4, 10],
                     r, math.sqrt(dn + dr))]


@pytest.mark.parametrize("b,groups,slots,sms,want", [
    (4, 1, 8256, 132, (33, 256)), (4, 1, 2112, 132, (33, 64)),
    (1, 1, 100, 132, (2, 64)), (8, 4, 8256, 132, (4, 2112)),
    (64, 4, 640, 132, (1, 640))])
def test_the_latent_split_covers_the_slots_in_whole_tiles(b, groups, slots,
                                                          sms, want):
    """About one CTA per SM over the (row, head group) pairs, chunks of
    whole 64-row tiles, no chunk empty, from shapes alone."""
    nsplit, chunk = DA.latent_split_plan(b, groups, slots, sms)
    assert (nsplit, chunk) == want
    assert chunk % 64 == 0 and (nsplit - 1) * chunk < slots <= nsplit * chunk
    with pytest.raises(ValueError):
        DA.latent_split_plan(0, 1, 8, 132)


# --------------------------------------------------------------------------- #
# Card
# --------------------------------------------------------------------------- #
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip: see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


#: (B, H, slots, live rows): kanana-2-30b-a3b's decode call at the cell's
#: lengths, one row past a chunk's edge and one on it, 16 heads (one m16
#: tile a CTA), every slot live, one live row.
LATENT_CASES = [(4, 32, 8256, [2049, 4097, 6145, 8193]),
                (2, 32, 700, [257, 256]), (3, 16, 640, [640, 1, 65]),
                (1, 32, 64, [64])]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,slots,lens", LATENT_CASES,
                         ids=[f"B{c[0]}-H{c[1]}-S{c[2]}" for c in LATENT_CASES])
def test_the_latent_kernels_match_the_plain_version(card, b, h, slots, lens):
    """Within 2**-6 absolute and relative on outputs of order one: two
    bf16 steps at 1 (the kernels round p under a running max of 64 rows,
    the plain version under the row's max, and each output is rounded
    once to bf16).  Dead rows hold NaN and change nothing; a captured call
    replayed gives the eager call's bits and counts one launch."""
    q, lat, lens_t = (t.to(card) for t in _latent_case(
        b, h, slots, lens, seed=slots, dtype=torch.bfloat16))
    for i, n in enumerate(lens):
        lat[i, n:] = float("nan")
    assert DA.latent_kernel_takes(q, lat, lens_t, 512)
    scale = math.sqrt(192)
    want = DA.latent_decode_attention_plain(
        q, torch.nan_to_num(lat), lens_t, 512, scale)
    before = _build.LAUNCHES["decode_attention_latent"]
    got = DA.latent_decode_attention(q, lat, lens_t, 512, scale)
    assert _build.LAUNCHES["decode_attention_latent"] == before + 1
    assert got.dtype == torch.bfloat16 and bool(got.isfinite().all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -6,
                               atol=2 ** -6)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = DA.latent_decode_attention(q, lat, lens_t, 512, scale)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, got)
