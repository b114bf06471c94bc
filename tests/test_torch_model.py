"""The port's dense model against the reference on bridged weights.

For chatglm3-6b (half rope), granite-3-8b (full rope, GQA 4:1),
starcoder2-15b (non-gated gelu MLP) and gemma3-12b (5:1 local ring
caches), all ``scaled_down`` and f32, with and without int8 KV caches:

  * prefill logits and caches agree (``rtol=1e-5, atol=1e-5``; int8 codes
    at most one step apart);
  * 8 greedy decode steps over per-slot lens that differ by row give the
    reference's tokens, on the unfused path and on the fused path (the
    kernel's plain version, as the wrapper runs it on the CPU).
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
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, forward, init_cache,
                                merge_cache_slots, prefill, scaled_down)
from repro_torch.models.convert import caches_from_numpy, params_from_numpy

ARCHS = ["chatglm3-6b", "granite-3-8b", "starcoder2-15b", "gemma3-12b"]
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


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32kv", "int8kv"])
@pytest.mark.parametrize("arch", ARCHS)
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
