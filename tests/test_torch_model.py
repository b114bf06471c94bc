"""The port's model against the reference on bridged weights.

For every ``ARCH_IDS`` entry — chatglm3-6b (half rope), granite-3-8b (full
rope, GQA 4:1), starcoder2-15b (non-gated gelu MLP), gemma3-12b (5:1 local
ring caches), qwen2-vl-72b (M-RoPE), musicgen-large (MHA, gelu), the two
qwen3 MoEs (top-k with capacity), mamba2-370m (SSD) and zamba2-1.2b (mamba
plus one shared attention block) — all ``scaled_down`` and f32, with and
without int8 KV caches where the arch has attention:

  * prefill logits and caches agree (``rtol=1e-5, atol=1e-5``, the SSM
    state and conv tail included; int8 codes at most one step apart);
  * 8 greedy decode steps over per-slot lens that differ by row give the
    reference's tokens, on the unfused path and on the fused path (the
    kernel's plain version, as the wrapper runs it on the CPU);
  * the ``embeds=`` path (qwen2-vl-72b with three distinct M-RoPE position
    streams, musicgen-large's frame stub) gives the reference's logits and
    caches;
  * the bridge carries MoE, mamba and shared trees of a bf16 model bit for
    bit, f32 leaves (router, SSM constants, norms) included, and the
    port's own init draws trees of the reference's layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import decode_step as ref_decode
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models import scaled_down as ref_scaled_down
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, merge_cache_slots, prefill,
                                scaled_down)
from repro_torch.models.convert import caches_from_numpy, params_from_numpy

ARCHS = list(ARCH_IDS)
# (arch, kv_quant): int8 KV caches only where the arch has attention.
CASES = [(a, q) for a in ARCHS for q in (False, True)
         if not q or get_config(a).has_attention]
B, P, STEPS = 3, 16, 8
LEN_OFFSETS = np.array([0, -3, -6], np.int32)   # per-slot lens differ


def _to_torch(tree):
    return caches_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _leaves(tree):
    return jax.tree.flatten(tree, is_leaf=torch.is_tensor)


def _clone(tree):
    return jax.tree.map(lambda t: t.clone(), tree, is_leaf=torch.is_tensor)


def _assert_caches_close(got, ref):
    (g_leaves, g_def), (r_leaves, r_def) = _leaves(got), _leaves(ref)
    assert g_def == r_def
    for g, r in zip(g_leaves, r_leaves):
        assert g.dtype == r.dtype and g.shape == r.shape
        if g.dtype == torch.int8:
            assert int((g.int() - r.int()).abs().max()) <= 1
        else:
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,kv_quant", CASES,
                         ids=[f"{a}-{'int8kv' if q else 'f32kv'}"
                              for a, q in CASES])
def test_prefill_and_greedy_decode_match_reference(arch, kv_quant):
    rcfg = ref_scaled_down(ref_get_config(arch), kv_quant=kv_quant)
    cfg = scaled_down(get_config(arch), kv_quant=kv_quant)
    rparams = ref_init_params(jax.random.key(0), rcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    max_len = P + STEPS

    # Prefill.
    r_logits, r_caches = jax.jit(
        lambda p, c, t: ref_prefill(p, rcfg, caches=c, tokens=t))(
        rparams, ref_init_cache(rcfg, B, max_len=max_len), tokens)
    logits, caches = prefill(params, cfg,
                             caches=init_cache(cfg, B, max_len, device="cpu"),
                             tokens=torch.from_numpy(tokens))
    torch.testing.assert_close(logits, _to_torch(r_logits), rtol=1e-5,
                               atol=1e-5)
    _assert_caches_close(caches, _to_torch(r_caches))

    # Greedy decode, each row at its own offset.
    ref_step = jax.jit(lambda p, t, c, n: ref_decode(p, rcfg, t, c, n))
    lens0 = P + LEN_OFFSETS
    tok0 = np.array(jnp.argmax(r_logits[:, -1], -1), np.int32)[:, None]
    ref_toks, tok, c, lens = [], tok0, r_caches, lens0.copy()
    for _ in range(STEPS):
        lg, c = ref_step(rparams, tok, c, lens)
        tok = np.array(jnp.argmax(lg[:, 0], -1), np.int32)[:, None]
        ref_toks.append(tok[:, 0])
        lens = lens + 1

    for fused in (False, True):
        toks, tok, c, lens = [], tok0, _clone(caches), lens0.copy()
        for _ in range(STEPS):
            lg, c = decode_step(params, cfg, torch.from_numpy(tok), c,
                                torch.from_numpy(lens), fused=fused)
            tok = lg[:, 0].argmax(-1).to(torch.int32).numpy()[:, None]
            toks.append(tok[:, 0])
            lens = lens + 1
        np.testing.assert_array_equal(np.stack(toks), np.stack(ref_toks),
                                      err_msg=f"fused={fused}")


def test_forward_matches_prefill_logits():
    cfg = scaled_down(get_config("chatglm3-6b"))
    rcfg = ref_scaled_down(ref_get_config("chatglm3-6b"))
    params = params_from_numpy(jax.tree.map(
        np.asarray, ref_init_params(jax.random.key(1), rcfg)), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
    full = forward(params, cfg, tokens=tokens)
    pre, _ = prefill(params, cfg, caches=init_cache(cfg, 2, 8, device="cpu"),
                     tokens=tokens)
    torch.testing.assert_close(full, pre, rtol=0, atol=0)


def test_padded_vocab_is_masked():
    from dataclasses import replace
    cfg = replace(scaled_down(get_config("chatglm3-6b")), vocab_size=120,
                  vocab_pad_to=64)
    from repro_torch.models import init_params
    params = init_params(cfg, seed=0, device="cpu")
    logits = forward(params, cfg, tokens=torch.zeros((1, 4), dtype=torch.int32))
    assert logits.shape[-1] == 128
    assert (logits[..., 120:] == -1e30).all()


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "musicgen-large"])
def test_embeds_path_matches_reference(arch):
    from repro.models import forward as ref_forward

    rcfg = ref_scaled_down(ref_get_config(arch))
    cfg = scaled_down(get_config(arch))
    rparams = ref_init_params(jax.random.key(3), rcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    rng = np.random.default_rng(5)
    embeds = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
    pos = None
    if cfg.rope_variant == "mrope":   # (t, h, w) streams that differ
        pos = np.stack([np.arange(P)[None].repeat(B, 0),
                        rng.integers(0, 4, (B, P)),
                        rng.integers(0, 4, (B, P))], -1).astype(np.int32)
    want = ref_forward(rparams, rcfg, embeds=embeds, positions=pos)
    got = forward(params, cfg, embeds=torch.from_numpy(embeds),
                  positions=None if pos is None else torch.from_numpy(pos))
    torch.testing.assert_close(got, _to_torch(want), rtol=1e-5, atol=1e-5)

    r_logits, r_caches = ref_prefill(rparams, rcfg, embeds=embeds,
                                     caches=ref_init_cache(rcfg, B, P + 4))
    logits, caches = prefill(params, cfg, embeds=torch.from_numpy(embeds),
                             caches=init_cache(cfg, B, P + 4, device="cpu"))
    torch.testing.assert_close(logits, _to_torch(r_logits), rtol=1e-5,
                               atol=1e-5)
    _assert_caches_close(caches, _to_torch(r_caches))


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-370m",
                                  "zamba2-1.2b"])
def test_bridge_carries_moe_mamba_and_shared_trees(arch):
    """A bf16 reference tree crosses bit for bit, its f32 leaves too."""
    rcfg = ref_scaled_down(ref_get_config(arch), dtype="bfloat16")
    ref = jax.tree.map(np.asarray, ref_init_params(jax.random.key(0), rcfg))
    got = params_from_numpy(ref, "cpu")
    (r_leaves, r_def), (g_leaves, g_def) = jax.tree.flatten(ref), \
        _leaves(got)
    assert g_def == r_def
    f32 = 0
    for a, t in zip(r_leaves, g_leaves):
        assert t.shape == a.shape
        assert str(t.dtype).removeprefix("torch.") == str(a.dtype)
        want = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        np.testing.assert_array_equal(_bits(t), want)
        f32 += t.dtype == torch.float32
    assert f32 > 0
    block = got["groups"][0]
    if arch.startswith("qwen3"):
        assert block["moe"]["w_router"].dtype == torch.float32
        assert block["moe"]["w_gate"].dtype == torch.bfloat16
    else:
        for name in ("a_log", "dt_bias", "d_skip", "w_norm"):
            assert block["mamba"][name].dtype == torch.float32
    if arch.startswith("zamba2"):
        assert got["shared"]["attn"]["wq"].dtype == torch.bfloat16
        assert block == {"norm1": block["norm1"], "mamba": block["mamba"]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-370m",
                                  "zamba2-1.2b"])
def test_port_init_has_reference_layout(arch, dtype):
    rcfg = ref_scaled_down(ref_get_config(arch), dtype=dtype)
    ref = jax.eval_shape(lambda: ref_init_params(jax.random.key(0), rcfg))
    got = init_params(scaled_down(get_config(arch), dtype=dtype), seed=0,
                      device="cpu")
    (r_leaves, r_def), (g_leaves, g_def) = jax.tree.flatten(ref), \
        _leaves(got)
    assert g_def == r_def
    for r, g in zip(r_leaves, g_leaves):
        assert tuple(g.shape) == r.shape
        assert str(g.dtype).removeprefix("torch.") == str(r.dtype)
    # The reference's constants: a_log 0, dt_bias -2, d_skip 1.
    if "mamba" in got["groups"][0]:
        m = got["groups"][0]["mamba"]
        assert (m["a_log"] == 0).all() and (m["dt_bias"] == -2).all()
        assert (m["d_skip"] == 1).all() and (m["w_norm"] == 0).all()


def test_merge_cache_slots_selects_rows_in_place():
    live = {"groups": ({"k": torch.zeros((2, 3, 4, 5))},),   # (G, B, ...)
            "tail": ({"k": torch.zeros((3, 4))},)}           # (B, ...)
    fresh = {"groups": ({"k": torch.ones((2, 3, 4, 5))},),
             "tail": ({"k": torch.ones((3, 4))},)}
    keep = live["groups"][0]["k"]
    merged = merge_cache_slots(live, fresh, np.array([True, False, True]))
    g, t = merged["groups"][0]["k"], merged["tail"][0]["k"]
    assert g is keep
    assert (g[:, 0] == 1).all() and (g[:, 2] == 1).all()
    assert (g[:, 1] == 0).all()
    assert (t[0] == 1).all() and (t[2] == 1).all() and (t[1] == 0).all()


def _merge_by_boolean_index(live, fresh, slot_mask):
    """The earlier merge: boolean-mask indexing of each leaf's batch axis."""
    mask = torch.as_tensor(slot_mask, dtype=torch.bool)
    n_groups = len(live["groups"])
    entries = list(zip(live["groups"], fresh["groups"])) + \
        list(zip(live["tail"], fresh["tail"]))
    for i, (le, fe) in enumerate(entries):
        rows = (slice(None), mask) if i < n_groups else (mask,)
        for k in le:
            le[k][rows] = fe[k][rows].to(le[k].dtype)
    return live


@pytest.mark.parametrize("arch,kv_quant", [("zamba2-1.2b", False),
                                           ("gemma3-12b", True),
                                           ("qwen3-moe-30b-a3b", True)])
def test_merge_cache_slots_equals_boolean_index_merge(arch, kv_quant):
    """Every leaf kind (KV, int8 codes and scales, ring, SSM state, conv
    tail; group and tail leaves) on every mask of three rows."""
    cfg = scaled_down(get_config(arch), kv_quant=kv_quant)
    gen = torch.Generator().manual_seed(0)

    def filled():
        tree = init_cache(cfg, 3, 16, device="cpu")
        for leaf in _leaves(tree)[0]:
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen))
            else:
                leaf.copy_(torch.randn(leaf.shape, generator=gen))
        return tree

    live, fresh = filled(), filled()
    if kv_quant:
        assert any(leaf.dtype == torch.int8 for leaf in _leaves(live)[0])
    for bits in range(8):
        mask = np.array([bool(bits & (1 << r)) for r in range(3)])
        want = _merge_by_boolean_index(_clone(live), fresh, mask)
        got = _clone(live)
        keep = _leaves(got)[0]
        merged = merge_cache_slots(got, fresh, mask)
        for a, b, same in zip(_leaves(merged)[0], _leaves(want)[0], keep):
            assert a is same and torch.equal(a, b)
