"""Neural-net layers of every block kind, in PyTorch.

The port of ``repro/models/layers.py``: attention, the dense MLP, the
top-k MoE with capacity and the Mamba2 (SSD) block.  Parameters are
explicit dicts of tensors with the reference's layouts: activations are
``(B, S, d)``, heads ``(B, S, H, D)``, KV caches ``(B, slots, K, D)`` and
SSM caches ``{"ssm": (B, H, P, N) f32, "conv": (B, W-1, C)}``.  The
reference's ``ShardCtx`` has no counterpart: the port runs on one device.

Where the reference asks for ``preferred_element_type=float32`` the port
upcasts both operands to f32 before the product, which computes the same
f32-accumulated result; where a reference einsum mixes dtypes, the port
casts to the type JAX promotes to.  Caches are updated in place — the
port's counterpart of the reference's donated, functionally updated
caches.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import (NEG_INF,
                                                  fused_decode_attention,
                                                  quantize_kv, write_slots)

from .config import ModelConfig

__all__ = ["rms_norm", "gated_rms_norm", "rope_cos_sin", "apply_rope",
           "NEG_INF", "chunked_attention", "decode_attention", "quantize_kv",
           "dequantize_kv", "attention_block", "mlp_block", "moe_capacity",
           "moe_route", "moe_block", "ssd_chunked", "mamba_block"]


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


def gated_rms_norm(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Mamba2's output norm: RMSNorm(x * silu(z))."""
    return rms_norm(x * F.silu(z.float()).to(x.dtype), w, eps)


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
                    write_slots(cache[name], rows, write, qv[:, 0])
                    write_slots(cache[f"{name}_scale"], rows, write, sc[:, 0])
                else:
                    write_slots(cache[name], rows, write, val[:, 0])
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


# --------------------------------------------------------------------------- #
# Mixture of Experts (top-k, capacity-based, scatter dispatch)
# --------------------------------------------------------------------------- #
def moe_capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    """Slots per expert in one routing group: ``max(ceil(Tg*k/E*cf), k)``."""
    k = cfg.num_experts_per_tok
    return max(int(math.ceil(tokens_per_group * k / cfg.num_experts
                             * cfg.capacity_factor)), k)


def moe_route(xg: torch.Tensor, w_router: torch.Tensor, cfg: ModelConfig,
              cap: int) -> tuple[torch.Tensor, ...]:
    """Route each group's tokens: xg (G, Tg, d) -> (top_ids, gates, dst, keep).

    ``top_ids`` (G, Tg, K) are the chosen experts, ``gates`` (G, Tg, K) f32
    their softmax weights.  ``dst`` and ``keep`` (G, Tg*K) follow the
    token-major (token, k) order: ``dst`` is the copy's row in the
    (E*cap + 1)-row dispatch buffer, whose last row takes the copies that
    overflow their expert's capacity (``keep`` False).
    """
    g, tg, _ = xg.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    # The router stays in the activation dtype, as in the reference.
    logits = xg @ w_router.to(xg.dtype)                       # (G, Tg, E)
    # lax.top_k puts equal logits in index order, and so does a stable
    # descending sort; torch.topk promises no order among ties.
    top_logits, top_ids = torch.sort(logits, dim=-1, descending=True,
                                     stable=True)
    top_logits, top_ids = top_logits[..., :k], top_ids[..., :k]
    gates = torch.softmax(top_logits.float(), dim=-1)
    ids = top_ids.reshape(g, tg * k)
    # The one-hot in int32, as the reference's (F.one_hot gives int64).
    oh = (ids[..., None] == torch.arange(e, device=xg.device)).to(torch.int32)
    pos = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh     # rank in expert
    posf = torch.gather(pos, 2, ids[..., None])[..., 0]
    keep = posf < cap
    dst = torch.where(keep, ids * cap + posf, e * cap)
    return top_ids, gates, dst, keep


def moe_block(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """Top-k MoE: route, scatter into per-expert capacity slots, the gated
    expert FFN on every slot (``gecd,edf``/``gecf,efd``), gated combine.

    Tokens split into ``cfg.moe_groups`` routing groups, each with its own
    capacity; with one group, every row of the batch competes for the same
    slots, as in the reference.
    """
    b, s, d = x.shape
    e, k, g = cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_groups
    tokens = b * s
    if tokens % g:
        raise ValueError(f"tokens ({tokens}) must divide moe_groups ({g})")
    tg = tokens // g
    cap = moe_capacity(tg, cfg)
    xg = x.reshape(g, tg, d)
    _, gates, dst, keep = moe_route(xg, p["w_router"], cfg, cap)

    # Dispatch.  Every row of the buffer but the overflow row receives at
    # most one copy, added onto an exact 0, so the result does not depend
    # on the order in which index_add's atomic adds land on the card; the
    # overflow row, which may take many, is dropped.
    rows = e * cap + 1
    base = torch.arange(g, device=x.device)[:, None]
    xrep = xg[:, :, None].expand(g, tg, k, d)                 # (G, Tg, K, d)
    buf = x.new_zeros((g * rows, d)).index_add(
        0, (dst + base * rows).reshape(-1), xrep.reshape(-1, d))
    buf = buf.reshape(g, rows, d)[:, :-1].reshape(g, e, cap, d)

    act = _ACTS[cfg.act]
    h = act(torch.einsum("gecd,edf->gecf", buf, p["w_gate"])) \
        * torch.einsum("gecd,edf->gecf", buf, p["w_in"])
    y_e = torch.einsum("gecf,efd->gecd", h, p["w_out"])

    # Combine: each copy reads its slot back (an overflowed copy reads the
    # last real slot and is zeroed by ``keep``), weighted by its gate.
    src = torch.clamp_max(dst, e * cap - 1) + base * (e * cap)
    out = y_e.reshape(g * e * cap, d).index_select(0, src.reshape(-1))
    out = out.reshape(g, tg * k, d)
    out = out * keep[..., None].to(out.dtype)
    out = out * gates.reshape(g, tg * k)[..., None].to(out.dtype)
    return out.reshape(g, tg, k, d).sum(dim=2).reshape(b, s, d)


# --------------------------------------------------------------------------- #
# Mamba2 (state-space duality, chunked)
# --------------------------------------------------------------------------- #
def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., Q) -> (..., Q, Q) lower-triangular segment sums (-inf above
    the diagonal): the reference's difference of cumulative sums."""
    q = x.shape[-1]
    cum = torch.cumsum(x, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt_a: torch.Tensor, bmat: torch.Tensor,
                cmat: torch.Tensor, *, chunk: int,
                init_state: torch.Tensor | None = None,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD "chunked dual" form (Mamba2): quadratic within chunks, a linear
    recurrence over chunk states.

    x (B, T, H, P) already times dt; dt_a (B, T, H) = dt * A (negative);
    bmat/cmat (B, T, N); init_state (B, H, P, N).  Returns (y (B, T, H, P),
    final_state (B, H, P, N)), both in x's dtype.  The decays and the C.B
    product are f32; the state runs in x's dtype, as in the reference.
    """
    b, t, h, pdim = x.shape
    n = bmat.shape[-1]
    if t % chunk:
        raise ValueError(f"T ({t}) must divide chunk ({chunk})")
    c = t // chunk
    xr = x.reshape(b, c, chunk, h, pdim)
    ar = dt_a.reshape(b, c, chunk, h).float()
    br = bmat.reshape(b, c, chunk, n)
    cr = cmat.reshape(b, c, chunk, n)

    a_cum = torch.cumsum(ar, dim=2)                           # (B,C,Q,H)
    # Intra-chunk (quadratic) term.
    decay = torch.exp(_segsum(ar.transpose(2, 3)))            # (B,C,H,Q,Q)
    cb = torch.einsum("bcqn,bckn->bcqk", cr.float(), br.float())
    w = cb[:, :, None] * decay                                # (B,C,H,Q,Q)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", w.to(x.dtype), xr)

    # Per-chunk input state.
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)     # (B,C,Q,H)
    s_chunk = torch.einsum("bckn,bckh,bckhp->bchpn", br,
                           decay_to_end.to(br.dtype), xr)

    # Inter-chunk recurrence over chunk states; prev[i] is the state
    # entering chunk i.
    chunk_decay = torch.exp(a_cum[:, :, -1, :])               # (B,C,H)
    state = (init_state.to(x.dtype) if init_state is not None else
             x.new_zeros((b, h, pdim, n)))
    prev = []
    for i in range(c):
        prev.append(state)
        state = s_chunk[:, i] + chunk_decay[:, i, :, None, None].to(
            s_chunk.dtype) * state
    prev_states = torch.stack(prev, dim=1)                    # (B,C,H,P,N)

    in_decay = torch.exp(a_cum)                               # (B,C,Q,H)
    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", cr,
                           in_decay.to(cr.dtype), prev_states)
    return (y_intra + y_inter).reshape(b, t, h, pdim), state


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor | None,
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Depthwise causal conv of width W: x (B, T, C), w (W, C).

    With ``state`` (B, W-1, C), one decode step (T == 1): returns y and the
    new state, the window's last W-1 inputs.
    """
    width = w.shape[0]
    if state is not None:
        window = torch.cat([state, x], dim=1)                 # (B, W, C)
        y = torch.einsum("bwc,wc->bc", window, w)[:, None]
        return y, window[:, 1:]
    t = x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    return sum(pad[:, i:i + t] * w[i] for i in range(width)), None


def mamba_block(x: torch.Tensor, p: dict, cfg: ModelConfig, *,
                cache: dict | None = None) -> tuple[torch.Tensor, dict | None]:
    """Mamba2 block; returns ``(y, cache)``.

    ``cache`` is ``{"ssm": (B, H, P, N) f32, "conv": (B, W-1, C)}`` (plus
    ``len``) and is written in place: a prefill (S > 1) stores the final
    SSM state and the last W-1 conv inputs, a decode step (S == 1) runs
    the one-token recurrence ``S <- exp(dt*A) S + (dt*x) (x) B; y = C.S``.
    """
    b, s, _ = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    h = cfg.ssm_num_heads
    pdim = di // h
    width = p["w_conv"].shape[0]

    z = x @ p["w_z"]
    xin = x @ p["w_x"]
    bc = x @ p["w_bc"]
    dt = x @ p["w_dt"]

    conv_in = torch.cat([xin, bc], dim=-1)
    decoding = cache is not None and s == 1
    conv_out, new_conv = _causal_conv(conv_in, p["w_conv"],
                                      cache["conv"] if decoding else None)
    conv_out = F.silu(conv_out.float()).to(x.dtype)
    xin, bmat, cmat = torch.split(conv_out, [di, n, n], dim=-1)

    a = -torch.exp(p["a_log"].float())                        # (H,)
    dt = F.softplus(dt.float() + p["dt_bias"].float())        # (B, S, H)
    xh = xin.reshape(b, s, h, pdim)
    x_dt = xh * dt[..., None].to(x.dtype)
    dt_a = dt * a                                             # (B, S, H)

    if not decoding:
        y, final_state = ssd_chunked(
            x_dt, dt_a, bmat, cmat, chunk=min(cfg.ssm_chunk, s),
            init_state=cache["ssm"] if cache is not None else None)
        if cache is not None:   # prefill: persist the SSM state, conv tail
            if s < width - 1:
                raise ValueError(f"prefill of {s} tokens is shorter than "
                                 f"the conv window's {width - 1}")
            cache["ssm"].copy_(final_state)
            cache["conv"].copy_(conv_in[:, s - (width - 1):])
            cache = dict(cache, len=cache["len"] + s)
    else:
        s_prev = cache["ssm"]
        da = torch.exp(dt_a[:, 0])                            # (B, H)
        outer = torch.einsum("bhp,bn->bhpn", x_dt[:, 0], bmat[:, 0])
        s_new = da[..., None, None].to(s_prev.dtype) * s_prev \
            + outer.to(s_prev.dtype)
        y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].to(s_new.dtype), s_new)
        y = y.reshape(b, 1, h, pdim).to(x.dtype)
        s_prev.copy_(s_new)
        cache["conv"].copy_(new_conv)

    y = y + xh * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = gated_rms_norm(y.reshape(b, s, di), z, p["w_norm"], cfg.norm_eps)
    return y @ p["w_out"], cache
