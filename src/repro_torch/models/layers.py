"""Neural-net layers of the dense decoder stack, in PyTorch.

The port of ``repro/models/layers.py`` for the attention and dense-MLP
blocks.  Parameters are explicit dicts of tensors with the reference's
layouts: activations are ``(B, S, d)``, heads ``(B, S, H, D)`` and KV
caches ``(B, slots, K, D)``.  The reference's ``ShardCtx`` has no
counterpart: the port runs on one device.

Where the reference asks for ``preferred_element_type=float32`` the port
upcasts both operands to f32 before the product, which computes the same
f32-accumulated result.  KV caches are updated in place — the port's
counterpart of the reference's donated, functionally updated caches.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import (NEG_INF,
                                                  fused_decode_attention,
                                                  quantize_kv)

from .config import ModelConfig

__all__ = ["rms_norm", "rope_cos_sin", "apply_rope", "NEG_INF",
           "chunked_attention", "decode_attention", "quantize_kv",
           "dequantize_kv", "attention_block", "mlp_block", "moe_block",
           "mamba_block"]


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


# --------------------------------------------------------------------------- #
# Rotary position embeddings (standard / half / M-RoPE)
# --------------------------------------------------------------------------- #
def _rope_angles(positions: torch.Tensor, dim_half: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin (..., S, dim_half), f32."""
    ar = torch.arange(dim_half, dtype=torch.float32, device=positions.device)
    inv = 1.0 / (theta ** (ar / dim_half))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved-as-halves pairs: x (..., 2*dim_half)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    if x.ndim == cos.ndim + 1:
        cos, sin = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, d: int, cfg: ModelConfig,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rope angles for a head dim ``d``: cos/sin (..., S, W), f32.

    All three variants collapse to one rotation of the leading ``2 * W``
    dims, which is what the fused decode kernel takes: W is ``d // 4`` for
    ChatGLM's "half" variant and ``d // 2`` otherwise.
    """
    if cfg.rope_variant == "half":
        # ChatGLM 2D-RoPE: rotary on the first half of the head dim only.
        return _rope_angles(positions, d // 4, cfg.rope_theta)
    if cfg.rope_variant == "mrope":
        # Qwen2-VL multimodal RoPE: the d/2 frequency slots are split into
        # (t, h, w) sections, each driven by its own position stream.
        secs = cfg.mrope_sections or (d // 4, d // 8, d // 8)
        if sum(secs) != d // 2:
            raise ValueError("mrope sections must sum to head_dim/2")
        if positions.ndim == 2:  # text-only: all three streams identical
            positions = positions[..., None].expand(*positions.shape, 3)
        parts = [_rope_angles(positions[..., i], s, cfg.rope_theta)
                 for i, s in enumerate(secs)]
        return (torch.cat([c for c, _ in parts], dim=-1),
                torch.cat([s for _, s in parts], dim=-1))
    return _rope_angles(positions, d // 2, cfg.rope_theta)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (B, S, 3) for M-RoPE."""
    d = x.shape[-1]
    cos, sin = rope_cos_sin(positions, d, cfg)
    rot = 2 * cos.shape[-1]
    if rot < d:
        return torch.cat([_rotate(x[..., :rot], cos, sin), x[..., rot:]],
                         dim=-1)
    return _rotate(x, cos, sin)


# --------------------------------------------------------------------------- #
# Attention (GQA, causal, optional sliding window, flash-style chunking)
# --------------------------------------------------------------------------- #
def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_offset: int = 0, window: int = 0,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Causal GQA attention with online softmax over KV chunks.

    q (B, Sq, H, D), k/v (B, Skv, K, D).  Grouped K-major GQA: q head h
    reads kv head ``h // (H/K)`` without materialising repeated KV.
    """
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, d).float()
    scale = 1.0 / math.sqrt(d)

    kv_chunk = min(kv_chunk, skv)  # never pad beyond the sequence
    n_chunks = -(-skv // kv_chunk)
    pad = n_chunks * kv_chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev)

    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
    lse = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    for j in range(n_chunks):
        kj = k[:, j * kv_chunk:(j + 1) * kv_chunk]
        vj = v[:, j * kv_chunk:(j + 1) * kv_chunk]
        kv_pos = j * kv_chunk + torch.arange(kv_chunk, device=dev)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kj.float()) * scale
        s = s.reshape(b, h, sq, kv_chunk)
        mask = kv_pos[None, :] <= q_pos[:, None]  # causal
        mask &= kv_pos[None, :] < skv             # padding
        if window:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        lse = lse * corr + p.sum(dim=-1)
        pv = torch.einsum(
            "bkgqs,bskd->bqkgd",
            p.reshape(b, kh, g, sq, kv_chunk).to(vj.dtype).float(), vj.float())
        acc = acc * corr.transpose(1, 2)[..., None] + pv.reshape(b, sq, h, d)
        m = m_new
    out = acc / torch.clamp_min(lse, 1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token attention over a (possibly windowed) KV cache.

    q (B, 1, H, D); caches (B, S, K, D); ``cache_len`` counts the valid
    positions including the new one, a scalar or a per-slot (B,) vector.
    """
    b, sq, h, d = q.shape
    skv, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                     k_cache.float()) / math.sqrt(d)
    pos = torch.arange(skv, device=q.device)
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device)
    if lens.ndim == 0:
        lens = lens.expand(b)
    mask = pos[None, :] < lens[:, None]                     # (B, S)
    if window:
        mask &= pos[None, :] > lens[:, None] - 1 - window
    s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


# --------------------------------------------------------------------------- #
# Int8 KV-cache quantization (per-vector symmetric scales)
# --------------------------------------------------------------------------- #
def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


# --------------------------------------------------------------------------- #
# Attention block (projections + rope + attention)
# --------------------------------------------------------------------------- #
def attention_block(x: torch.Tensor, p: dict, cfg: ModelConfig, *,
                    positions: torch.Tensor, window: int = 0,
                    cache: dict | None = None,
                    fused: bool = False) -> tuple[torch.Tensor, dict | None]:
    """Projections + rope + attention; returns ``(y, cache)``.

    ``cache`` is ``{"k", "v": (B, slots, K, D), "len"}`` (plus f32
    ``k_scale``/``v_scale`` for int8 caches) and is written in place.
    ``fused=True`` runs a one-token decode step through the fused
    decode-attention kernel.
    """
    b, s, _ = x.shape
    hd = cfg.qk_head_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
    use_fused = fused and cache is not None and s == 1
    if not use_fused:
        # The fused kernel rotates q/k itself from precomputed angles.
        k = apply_rope(k, positions, cfg)
        q = apply_rope(q, positions, cfg)

    quant = "k_scale" in (cache or {})

    def load(name):
        if quant:
            return dequantize_kv(cache[name], cache[f"{name}_scale"], x.dtype)
        return cache[name]

    new_cache = None
    if cache is None:
        out = chunked_attention(q, k, v, window=window)
    elif s > 1:
        # Prefill: full-sequence attention AND populate the cache.
        slots = cache["k"].shape[1]
        kk, vv = k, v
        if slots < s:  # ring buffer (local layers): keep the last `slots`
            # Ring invariant: token at absolute position p lives in slot
            # p % slots — holds for the plain copy below iff slots | s.
            if s % slots:
                raise ValueError("prefill length must be a multiple of the "
                                 "ring-buffer window")
            kk, vv = k[:, s - slots:], v[:, s - slots:]
        n = kk.shape[1]
        for name, val in (("k", kk), ("v", vv)):
            if quant:
                qv, sc = quantize_kv(val)
                cache[name][:, :n] = qv
                cache[f"{name}_scale"][:, :n] = sc
            else:
                cache[name][:, :n] = val.to(cache[name].dtype)
        out = chunked_attention(q, k, v, window=window)
        new_cache = dict(cache, len=cache["len"] + s)
    else:
        # Per-slot decode: each row writes its new token at its own
        # position and masks its own prefix.
        idx = torch.as_tensor(cache["len"], dtype=torch.int32, device=x.device)
        if idx.ndim == 0:
            idx = idx.expand(b)
        slots = cache["k"].shape[1]
        # Local layers keep a ring buffer of exactly `window` slots: every
        # resident slot is in-window by construction, so no window mask.
        is_ring = bool(window) and slots <= window
        if use_fused:
            cos, sin = rope_cos_sin(positions, hd, cfg)
            res = fused_decode_attention(
                q, k, v, cache["k"], cache["v"], idx, cos, sin,
                cache.get("k_scale"), cache.get("v_scale"),
                window=0 if is_ring else window, is_ring=is_ring)
            out = res[0]
        else:
            write = (idx % slots if is_ring else idx).long()
            rows = torch.arange(b, device=x.device)
            for name, val in (("k", k), ("v", v)):
                if quant:
                    qv, sc = quantize_kv(val)
                    cache[name][rows, write] = qv[:, 0]
                    cache[f"{name}_scale"][rows, write] = sc[:, 0]
                else:
                    cache[name][rows, write] = val[:, 0].to(cache[name].dtype)
            out = decode_attention(q, load("k"), load("v"), idx + 1,
                                   window=0 if is_ring else window)
        new_cache = dict(cache, len=idx + 1)

    out = out.reshape(b, s, cfg.num_heads * hd)
    return out @ p["wo"], new_cache


# --------------------------------------------------------------------------- #
# Dense FFN
# --------------------------------------------------------------------------- #
_ACTS = {"silu": F.silu,
         "gelu": lambda t: F.gelu(t, approximate="tanh")}


def mlp_block(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    act = _ACTS[cfg.act]
    if cfg.gated_mlp:
        h = act(x @ p["w_gate"]) * (x @ p["w_in"])
    else:
        h = act(x @ p["w_in"])
    return h @ p["w_out"]


def moe_block(x, p, cfg):
    raise NotImplementedError("moe_block is not ported yet (ROADMAP A9)")


def mamba_block(x, p, cfg, *, cache=None):
    raise NotImplementedError("mamba_block is not ported yet (ROADMAP A9)")
