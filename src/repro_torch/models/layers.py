"""Neural-net layers of every block kind, in PyTorch.

The port of ``repro/models/layers.py``: attention, the dense MLP, the
top-k MoE with capacity and the Mamba2 (SSD) block; and, beyond the
reference, multi-head latent attention (``mla_block``) and DeepSeek-V3's
sigmoid router.  Parameters are
explicit dicts of tensors with the reference's layouts: activations are
``(B, S, d)``, heads ``(B, S, H, D)``, KV caches ``(B, slots, K, D)`` and
SSM caches ``{"ssm": (B, H, P, N) f32, "conv": (B, W-1, C)}``.

Sharding hints go through a ``ShardCtx`` at the reference's call sites.
``NO_SHARD`` (the default) makes ``constrain`` return its input, so the
one-device path runs no DTensor op.  An active context (built by
``runtime.sharding.make_shard_ctx`` over a ``DeviceMesh``) redistributes
the DTensor activations to the spec's placements; DTensor's own sharding
propagation places everything between those points.  A decode step and a
prefill's cache fill run on each device's own block of the cache, its
batch rows and its share of the slots (``cache_specs`` puts the slots on
the model axis), as the reference's partitioner splits them
(flash-decoding, ``_decode_on_slot_blocks``): the new token is written by the
block that holds its slot, and the softmax's max and sum and the partial
p@V are all-reduced over the model axis.  No device gathers the cache.
Where the model axis does not divide the KV heads but divides the q
heads, the KV heads are repeated to the q heads (``repeat_kv``) and the
attention splits over q heads, as the reference's layout does.

Where the reference asks for ``preferred_element_type=float32`` the port
upcasts both operands to f32 before the product, which computes the same
f32-accumulated result; where a reference einsum mixes dtypes, the port
casts to the type JAX promotes to.  Caches are updated in place — the
port's counterpart of the reference's donated, functionally updated
caches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import moe_experts
from repro_torch.kernels.decode_attention import (NEG_INF,
                                                  bmm_f32 as _bmm_f32,
                                                  decode_attention_shard,
                                                  fused_decode_attention,
                                                  latent_decode_attention,
                                                  live_slots, quantize_kv,
                                                  shard_softmax_pv,
                                                  write_slots)
from repro_torch.kernels.moe_route import expert_slots
from repro_torch.kernels.prefill_attention import (
    prefill_attention, prefill_attention_plain as chunked_attention,
    takes as prefill_attention_takes)
from repro_torch.runtime.flags import baseline_mode

from .config import ModelConfig

__all__ = ["ShardCtx", "NO_SHARD", "rms_norm", "gated_rms_norm",
           "rope_cos_sin", "apply_rope", "NEG_INF", "repeat_kv",
           "chunked_attention", "decode_attention", "quantize_kv",
           "dequantize_kv", "attention_block", "mla_block", "mlp_block",
           "moe_capacity", "moe_route", "moe_block", "ssd_chunked",
           "mamba_block"]


# --------------------------------------------------------------------------- #
# Sharding context
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Mesh axes for activation sharding constraints.

    ``dp`` are the data-parallel axes (maybe with ``pod``), ``tp`` the
    model axis, ``mesh`` the ``DeviceMesh`` the constraints refer to.
    """

    dp: tuple[str, ...] = ()
    tp: str | None = None
    active: bool = False
    mesh: Any = None

    def constrain(self, x, *spec):
        """``x`` redistributed to ``spec``'s placements (``x`` if inactive).

        A dim that its axes do not divide stays replicated: GSPMD pads an
        uneven shard, but DTensor cannot reshape one (the MoE's single
        routing group over four devices, say).
        """
        if not self.active:
            return x
        from torch.distributed.tensor import DTensor, Replicate

        from repro_torch.runtime.sharding import axis_size, to_placements
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, self.mesh,
                                   [Replicate()] * self.mesh.ndim,
                                   run_check=False)
        spec = tuple(a if x.shape[d] % axis_size(self.mesh, a) == 0 else None
                     for d, a in enumerate(spec))
        # Contiguous local shards: DTensor's einsum views the MoE buffers.
        return x.redistribute(self.mesh,
                              to_placements(spec, self.mesh)).contiguous()

    def tp_size(self) -> int:
        from repro_torch.runtime.sharding import axis_size
        return axis_size(self.mesh, self.tp) if self.active else 1

    def scope(self):
        """Where plain tensors made inside the model (positions, masks,
        rope tables) meet DTensors: DTensor treats them as replicated."""
        if not self.active:
            return contextlib.nullcontext()
        return _implicit_replication()


@contextlib.contextmanager
def _implicit_replication():
    """``torch.distributed.tensor.experimental.implicit_replication`` that
    nests: it restores the flag it found (the library's sets it to False
    on exit, which would end an enclosing scope, such as the train step's
    around its backward pass)."""
    from torch.distributed.tensor import DTensor
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


NO_SHARD = ShardCtx()


def _on_local_blocks(ctx: ShardCtx, fn, args, placements=None):
    """``fn`` on each device's blocks: ``fn(*local args) -> outputs``;
    ``fn(*args)`` itself when ``ctx`` is inactive.

    ``args`` are DTensors evenly sharded (``ShardCtx.constrain`` keeps
    shards even) over blocks that ``fn`` computes independently (batch
    rows, heads).  Each output is placed like ``args[0]``, or as
    ``placements(args[0].placements)`` gives (one per output).  Each
    device's outputs depend on its own blocks alone, so the gradients keep
    the inputs' placements, except where an input is replicated over a
    mesh axis that splits ``args[0]`` (the SSD's B and C, shared by heads
    on other devices; a weight, shared by other rows): there its gradient
    is a partial sum.  DTensor's own einsum merges a batch sharded over
    one mesh axis with heads sharded over another into one strided shard,
    which it cannot propagate under fake tensors (the dry run).
    """
    if not ctx.active:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    lead = args[0].placements

    def local(a):
        if a is None:
            return None
        if not isinstance(a, DTensor):    # a plain tensor: replicated
            return a
        return a.to_local(grad_placements=[
            Partial() if isinstance(lp, Shard) and isinstance(ap, Replicate)
            else ap for lp, ap in zip(lead, a.placements)])

    outs = fn(*(local(a) for a in args))
    single = isinstance(outs, torch.Tensor)
    outs = (outs,) if single else outs
    places = (lead,) * len(outs) if placements is None else placements(lead)
    placed = tuple(DTensor.from_local(o, ctx.mesh, p, run_check=False)
                   for o, p in zip(outs, places))
    return placed[0] if single else placed


class _SlotBlocks:
    """This device's block of a cache whose batch rows lie over the data
    axes and whose slots lie over the model axis (``cache_specs``): the
    local leaves, their global slot range, the rows of an activation that
    go with them, and the model axis's all-reduces.  Every device holds
    the same number of slots (DTensor's ``Shard`` cut: blocks of
    ``ceil(slots / |model|)``, the last ones shorter or empty)."""

    def __init__(self, ctx: ShardCtx, cache: dict):
        self.ctx = ctx
        self.names = [n for n in ("k", "v", "k_scale", "v_scale")
                      if n in cache]
        first = cache["k"]
        self.rows_placements = tuple(
            p if p.is_shard(0) else _replicate() for p in first.placements)
        self.batch = first.shape[0]
        self.slots = first.shape[1]
        self.local = {n: cache[n].to_local() for n in self.names}
        n = ctx.tp_size()
        chunk = -(-self.slots // n)
        coord = ctx.mesh.get_local_rank(ctx.tp) if n > 1 else 0
        self.base = min(coord * chunk, self.slots)
        self.group = ctx.mesh.get_group(ctx.tp).group_name if n > 1 else None

    def rows(self, x):
        """This device's batch rows of ``x`` (B, ...), all of every other
        dim (a plain tensor is taken as replicated)."""
        return self.ctx.constrain(x, self.ctx.dp,
                                  *(None,) * (x.ndim - 1)).to_local()

    def all_reduce(self, op: str):
        """``op`` ("max" or "sum") over the model axis, a functional
        collective; None (the identity) on a model axis of one device."""
        if self.group is None:
            return None
        group = self.group

        def reduce(t):
            c10d = torch.ops._c10d_functional
            return c10d.wait_tensor(c10d.all_reduce(t.contiguous(), op,
                                                    group))
        return reduce

    def placed(self, out):
        """A (B_local, ...) result as a DTensor over all B rows."""
        from torch.distributed.tensor import DTensor
        shape = (self.batch, *out.shape[1:])
        return DTensor.from_local(out, self.ctx.mesh, self.rows_placements,
                                  run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta")
                                  .stride())


def _replicate():
    from torch.distributed.tensor import Replicate
    return Replicate()


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
    ChatGLM's "half" variant and ``d // 2`` otherwise.  NoPE ("none")
    gives the identity rotation (cos 1, sin 0), which the kernel applies
    exactly.
    """
    if cfg.rope_variant == "none":
        shape = (*positions.shape, d // 2)
        return (torch.ones(shape, dtype=torch.float32,
                           device=positions.device),
                torch.zeros(shape, dtype=torch.float32,
                            device=positions.device))
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
    """x: (B, S, H, D); positions: (B, S) or (B, S, 3) for M-RoPE.

    With ``cfg.rope_interleave`` the rotated pairs are (2i, 2i + 1): x's
    even dims are gathered before its odd ones and rotated as halves, and
    the result stays in that order (DeepSeek-V3's
    ``apply_rotary_pos_emb_interleave``).  A q and a k rotated alike give
    the dot products of rotating each pair in place."""
    d = x.shape[-1]
    if cfg.rope_interleave:
        x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    cos, sin = rope_cos_sin(positions, d, cfg)
    rot = 2 * cos.shape[-1]
    if rot < d:
        return torch.cat([_rotate(x[..., :rot], cos, sin), x[..., rot:]],
                         dim=-1)
    return _rotate(x, cos, sin)


# --------------------------------------------------------------------------- #
# Attention (GQA, causal, optional sliding window, flash-style chunking)
# --------------------------------------------------------------------------- #
# ``chunked_attention`` is ``kernels.prefill_attention``'s plain version
# (``prefill_attention_plain``), kept under the reference's name:
# ``attention_block`` resolves it here at each call.
def repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, K, D) -> (B, S, H, D), each KV head repeated H/K times in
    K-major order (q head h reads KV head h // rep)."""
    rep = num_heads // k.shape[2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token attention over a (possibly windowed) KV cache.

    q (B, 1, H, D); caches (B, S, K, D); ``cache_len`` counts the valid
    positions including the new one, a scalar or a per-slot (B,) vector.
    """
    b, sq, h, d = q.shape
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device)
    if lens.ndim == 0:
        lens = lens.expand(b)
    p = torch.softmax(_masked_scores(q, k_cache, lens, window=window), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def _masked_scores(q: torch.Tensor, k_cache: torch.Tensor,
                   lens: torch.Tensor, *, window: int,
                   slot_base: int = 0) -> torch.Tensor:
    """The f32 scores (B, K, G, Sq, S) of q (B, Sq, H, D) over a cache
    block (B, S, K, D) holding global slots ``slot_base ...``, masked to
    the live slots (``live_slots``; ``lens`` (B,) counts the new token)."""
    b, sq, h, d = q.shape
    kh = k_cache.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                     k_cache.float()) / math.sqrt(d)
    mask = live_slots(lens, k_cache.shape[1], slot_base=slot_base,
                      window=window)
    return torch.where(mask[:, None, None, None, :], s, NEG_INF)


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
                    cache: dict | None = None, fused: bool = False,
                    ctx: ShardCtx = NO_SHARD,
                    ) -> tuple[torch.Tensor, dict | None]:
    """Projections + rope + attention; returns ``(y, cache)``.

    ``cache`` is ``{"k", "v": (B, slots, K, D), "len"}`` (plus f32
    ``k_scale``/``v_scale`` for int8 caches) and is written in place.
    ``fused=True`` runs a one-token decode step through the fused
    decode-attention kernel.
    """
    b, s, _ = x.shape
    hd = cfg.qk_head_dim
    # The KV heads are replicated when the model axis does not divide them
    # (``sharding._rule``), and DTensor can neither regroup model-sharded q
    # heads into (K, G) nor split a model-sharded K*D into K heads.  Where
    # the model axis divides the q heads, k and v are then repeated to the
    # q heads (``repeat_kv``, as the reference's layout keeps the head dim
    # shardable) and the attention splits over q heads, one KV head each;
    # otherwise q, k and v (and, in the backward pass, the output's
    # gradient) are gathered over the model axis, whose devices all run
    # the attention.  (Splitting the query positions instead makes
    # DTensor's propagation read data under fake tensors.)
    tp = ctx.tp_size()
    split_kv = cfg.num_kv_heads % tp == 0
    repeat = not split_kv and cfg.num_heads % tp == 0
    gather_heads = not split_kv and not repeat

    def kv(w):
        y = x @ w
        if not split_kv:
            y = ctx.constrain(y, ctx.dp, None, None)
        y = y.reshape(b, s, cfg.num_kv_heads, hd)
        return y if split_kv else ctx.constrain(y, ctx.dp, None, None, None)

    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, hd)
    if cfg.attention_multiplier:
        # A softmax scale other than 1/sqrt(D), folded into q: every
        # attention path (the kernels too) then applies its own 1/sqrt(D).
        q = q * (cfg.attention_multiplier * math.sqrt(hd))
    k, v = kv(p["wk"]), kv(p["wv"])
    q = ctx.constrain(q, ctx.dp, None, ctx.tp, None)
    if gather_heads:
        q = ctx.constrain(q, ctx.dp, None, None, None)
    use_fused = fused and cache is not None and s == 1
    if not use_fused and cfg.rope_variant != "none":
        # The fused kernel rotates q/k itself from precomputed angles.
        k = apply_rope(k, positions, cfg)
        q = apply_rope(q, positions, cfg)

    quant = "k_scale" in (cache or {})

    def attend(q, k, v):
        # On a mesh each device attends its batch rows and its heads: its
        # KV-head groups, its q heads over repeated KV heads, or all heads.
        if repeat:
            k, v = (_on_local_blocks(ctx, functools.partial(
                repeat_kv, num_heads=cfg.num_heads), (t,)) for t in (k, v))
        heads = None if gather_heads else ctx.tp
        q, k, v = (ctx.constrain(t, ctx.dp, None, heads, None)
                   for t in (q, k, v))
        return _on_local_blocks(ctx, functools.partial(
            chunked_attention, window=window), (q, k, v))

    new_cache = None
    if cache is None:
        out = attend(q, k, v)
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
        c, lo, n = cache, 0, kk.shape[1]
        if ctx.active:
            # Each device writes the positions inside its own slots.
            blocks = _SlotBlocks(ctx, cache)
            c, lo = blocks.local, blocks.base
            n = max(0, min(n - lo, c["k"].shape[1]))
            kk, vv = (blocks.rows(t)[:, lo:lo + n] for t in (kk, vv))
        for name, val in (("k", kk), ("v", vv)):
            if quant:
                qv, sc = quantize_kv(val)
                c[name][:, :n] = qv
                c[f"{name}_scale"][:, :n] = sc
            else:
                c[name][:, :n] = val.to(c[name].dtype)
        # One device: the prefill-attention kernel, where it takes the call.
        out = (prefill_attention(q, k, v, window=window)
               if _prefill_kernel(q, k, v, ctx) else attend(q, k, v))
        new_cache = dict(cache, len=cache["len"] + s)
    else:
        # Per-slot decode: each row writes its new token at its own
        # position and masks its own prefix.
        idx = torch.as_tensor(cache["len"], dtype=torch.int32, device=x.device)
        if idx.ndim == 0:
            idx = idx.expand(b)
        # Local layers keep a ring buffer of exactly `window` slots: every
        # resident slot is in-window by construction, so no window mask.
        is_ring = bool(window) and cache["k"].shape[1] <= window
        win = 0 if is_ring else window
        # Flash-decoding layout (the reference's non-baseline path): the
        # one query token is replicated over the model axis.
        if ctx.active and not baseline_mode():
            q = ctx.constrain(q, ctx.dp, None, None, None)
        if ctx.active:
            out = _decode_on_slot_blocks(ctx, cache, q, k, v, idx,
                                         positions, cfg, fused=use_fused,
                                         window=win, is_ring=is_ring)
        elif use_fused:
            cos, sin = rope_cos_sin(positions, hd, cfg)
            out = fused_decode_attention(
                q, k, v, cache["k"], cache["v"], idx, cos, sin,
                cache.get("k_scale"), cache.get("v_scale"), window=win,
                is_ring=is_ring)[0]
        else:
            slots = cache["k"].shape[1]
            k_use, v_use = _write_new_token(
                cache, k, v, (idx % slots if is_ring else idx).long(),
                x.dtype)
            out = decode_attention(q, k_use, v_use, idx + 1, window=win)
        if ctx.active and not baseline_mode():
            out = ctx.constrain(out, ctx.dp, None, None, None)
        new_cache = dict(cache, len=idx + 1)

    if gather_heads:
        out = ctx.constrain(out, ctx.dp, None, None, None)
    out = out.reshape(b, s, cfg.num_heads * hd)
    return ctx.constrain(out @ p["wo"], ctx.dp, None, None), new_cache


def _prefill_kernel(q, k, v, ctx: ShardCtx) -> bool:
    """Whether a prefill's attention runs the prefill-attention kernel: on
    one device (no active mesh), for a call the kernel takes (CUDA
    tensors, its dtypes and head dims: ``prefill_attention.takes``).  The
    train step (no cache), a mesh's prefill and everything else run
    ``chunked_attention``."""
    return not ctx.active and prefill_attention_takes(q, k, v)


def _write_new_token(c: dict, k, v, write, dtype):
    """Scatter the new token's k, v (B, 1, K, D) into the caches ``c`` at
    the rows' slots ``write`` (quantised for int8 caches; a slot outside
    the caches is dropped); returns the caches as keys and values in
    ``dtype``."""
    rows = torch.arange(k.shape[0], device=k.device)
    quant = "k_scale" in c
    for name, val in (("k", k), ("v", v)):
        if quant:
            qv, sc = quantize_kv(val)
            write_slots(c[name], rows, write, qv[:, 0])
            write_slots(c[f"{name}_scale"], rows, write, sc[:, 0])
        else:
            write_slots(c[name], rows, write, val[:, 0])
    if quant:
        return tuple(dequantize_kv(c[n], c[f"{n}_scale"], dtype)
                     for n in ("k", "v"))
    return c["k"], c["v"]


def _decode_on_slot_blocks(ctx: ShardCtx, cache: dict, q, k, v, idx,
                           positions, cfg: ModelConfig, *, fused: bool,
                           window: int, is_ring: bool):
    """A decode step's attention on this device's block of the cache (its
    rows, its slots): the new token written by the block holding its slot,
    the softmax's max and sum and the partial p@V all-reduced over the
    model axis, one cast.  ``fused`` runs the decode kernel's slot-shard
    form (q, k un-roped), else the same decomposition in plain ops.
    Returns the (B, 1, H, D) output over every row."""
    blocks = _SlotBlocks(ctx, cache)
    c, base, slots = blocks.local, blocks.base, blocks.slots
    q, k, v, idx = (blocks.rows(t) for t in (q, k, v, idx))
    all_max, all_sum = blocks.all_reduce("max"), blocks.all_reduce("sum")
    if fused:
        cos, sin = rope_cos_sin(blocks.rows(positions), cfg.qk_head_dim, cfg)
        out = decode_attention_shard(
            q, k, v, c["k"], c["v"], idx, cos, sin, c.get("k_scale"),
            c.get("v_scale"), slot_base=base, slots=slots, window=window,
            is_ring=is_ring, all_max=all_max, all_sum=all_sum)[0]
        return blocks.placed(out)
    write = (idx % slots if is_ring else idx).long() - base
    k_use, v_use = _write_new_token(c, k, v, write, q.dtype)
    # ``decode_attention``'s scores and masks on this block's slots.
    sc = _masked_scores(q, k_use, idx + 1, window=window,
                        slot_base=base)[:, :, :, 0]
    return blocks.placed(shard_softmax_pv(sc, v_use, q.dtype, all_max,
                                          all_sum))


# --------------------------------------------------------------------------- #
# Multi-head latent attention (DeepSeek-V2/V3)
# --------------------------------------------------------------------------- #
def mla_block(x: torch.Tensor, p: dict, cfg: ModelConfig, *,
              positions: torch.Tensor, cache: dict | None = None,
              ctx: ShardCtx = NO_SHARD,
              ) -> tuple[torch.Tensor, dict | None]:
    """Multi-head latent attention; returns ``(y, cache)``.

    ``p``: ``wq`` (d, H*(Dn+Dr)), q straight from the hidden state;
    ``w_kv_a`` (d, R+Dr), the latent and the shared rotary key;
    ``kv_norm`` (R,), the latent's RMSNorm; ``w_kv_b`` (R, H*(Dn+Dv)), each
    head's key (its Dn dims without rotary) and value from the latent;
    ``wo`` (H*Dv, d).  ``cache`` is ``{"latent": (B, slots, R+Dr), "len"}``:
    each position's normed latent and roped shared key, written in place,
    and nothing per head.

    A prefill (S > 1, or no cache) decompresses the latent into every
    head's keys and values and attends with softmax scale 1/sqrt(Dn+Dr):
    the prefill-attention kernel where it takes the call (one device, CUDA,
    bf16, widths (192, 128)), ``chunked_attention`` otherwise.  A decode
    step absorbs ``w_kv_b`` instead: q's Dn dims times each head's key
    block give a query over the latent, the scores are taken over the
    cached latents and shared keys, and the weighted latent times each
    head's value block is the head's output.  The two compute one function
    in another order of sums; the decode reads only the latent cache.  The
    decode's products take operands in the cache's dtype (the query over
    the latent, p and the weighted latent rounded to it) and sum in f32;
    the scores and the softmax are f32.  Its attention over the latent is
    ``latent_decode_attention``: the latent kernels of
    ``decode_attention.cu`` where they take the call (the card, bf16,
    widths (576, 512)), the plain version otherwise.
    """
    if ctx.active:
        raise NotImplementedError("multi-head latent attention runs on one "
                                  "device (no mesh)")
    b, s, _ = x.shape
    h, r = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = (x @ p["wq"]).reshape(b, s, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    kv = x @ p["w_kv_a"]                                     # (B, S, R+Dr)
    c_kv = rms_norm(kv[..., :r], p["kv_norm"], cfg.norm_eps)
    k_pe = kv[..., r:][:, :, None]                           # (B, S, 1, Dr)
    if cfg.rope_variant != "none":
        q_pe = apply_rope(q_pe, positions, cfg)
        k_pe = apply_rope(k_pe, positions, cfg)
    new_cache = None
    if cache is None or s > 1:
        if cache is not None:
            cache["latent"][:, :s] = torch.cat(
                [c_kv, k_pe[:, :, 0]], -1).to(cache["latent"].dtype)
            new_cache = dict(cache, len=cache["len"] + s)
        kvb = (c_kv @ p["w_kv_b"]).reshape(b, s, h, dn + dv)
        k = torch.cat([kvb[..., :dn], k_pe.expand(b, s, h, dr)], -1)
        v = kvb[..., dn:]
        del kvb
        qq = torch.cat([q_nope, q_pe], -1)
        out = (prefill_attention(qq, k, v) if cache is not None
               and _prefill_kernel(qq, k, v, ctx)
               else chunked_attention(qq, k, v))
        del qq, k, v
    else:
        idx = torch.as_tensor(cache["len"], dtype=torch.int32,
                              device=x.device)
        if idx.ndim == 0:
            idx = idx.expand(b)
        latent = cache["latent"]
        write_slots(latent, torch.arange(b, device=x.device), idx.long(),
                    torch.cat([c_kv[:, 0], k_pe[:, 0, 0]], -1)
                    .to(latent.dtype))
        # Each head's query over the latent: q's Dn dims times its key block.
        w_kv_b = p["w_kv_b"].reshape(r, h, dn + dv)
        q_lat = _bmm_f32(q_nope[:, 0].transpose(0, 1),
                         w_kv_b[..., :dn].permute(1, 2, 0)).transpose(0, 1)
        qc = torch.cat([q_lat, q_pe[:, 0].float()], -1).to(latent.dtype)
        o_lat = latent_decode_attention(qc, latent, idx + 1, r,
                                        math.sqrt(dn + dr))
        # ... and the weighted latent times each head's value block.
        out = _bmm_f32(o_lat.transpose(0, 1),
                       w_kv_b[..., dn:].permute(1, 0, 2)).transpose(0, 1)
        out = out[:, None].to(x.dtype)                       # (B, 1, H, Dv)
        new_cache = dict(cache, len=idx + 1)
    return out.reshape(b, s, h * dv) @ p["wo"], new_cache


# --------------------------------------------------------------------------- #
# Dense FFN
# --------------------------------------------------------------------------- #
_ACTS = moe_experts.ACTS


def mlp_block(x: torch.Tensor, p: dict, cfg: ModelConfig, *,
              ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    act = _ACTS[cfg.act]
    if cfg.gated_mlp:
        h = act(x @ p["w_gate"]) * (x @ p["w_in"])
    else:
        h = act(x @ p["w_in"])
    h = ctx.constrain(h, ctx.dp, None, ctx.tp)
    return ctx.constrain(h @ p["w_out"], ctx.dp, None, None)


# --------------------------------------------------------------------------- #
# Mixture of Experts (top-k, capacity-based, scatter dispatch)
# --------------------------------------------------------------------------- #
def moe_capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    """Slots per expert in one routing group: ``max(ceil(Tg*k/E*cf), k)``."""
    k = cfg.num_experts_per_tok
    return max(int(math.ceil(tokens_per_group * k / cfg.num_experts
                             * cfg.capacity_factor)), k)


def moe_route(xg: torch.Tensor, w_router: torch.Tensor, cfg: ModelConfig,
              cap: int, bias: torch.Tensor | None = None,
              ) -> tuple[torch.Tensor, ...]:
    """Route each group's tokens: xg (G, Tg, d) -> (top_ids, gates, dst, keep).

    ``top_ids`` (G, Tg, K) are the chosen experts, ``gates`` (G, Tg, K) f32
    their weights: a softmax over the top-k logits, or, where
    ``cfg.router_scoring`` is "sigmoid" (DeepSeek-V3), the k largest of
    sigmoid(logit) + ``bias`` (the score-correction bias, which picks but
    does not weigh), weighted by their sigmoid scores over the scores' sum
    (plus 1e-20) times ``cfg.routed_scaling``; the sigmoid router's logits
    are f32 products, as DeepSeek-V3 computes them.  ``dst`` and ``keep``
    (G, Tg*K) follow the
    token-major (token, k) order: ``dst`` is the copy's row in the
    (E*cap + 1)-row dispatch buffer, whose last row takes the copies that
    overflow their expert's capacity (``keep`` False); both come from
    ``kernels.moe_route.expert_slots`` (the kernel on a CUDA device).
    """
    g, tg, _ = xg.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    if cfg.router_scoring == "sigmoid":
        scores = torch.sigmoid(xg.float() @ w_router.float())
        choice = scores if bias is None else scores + bias.float()
        top_ids = torch.sort(choice, dim=-1, descending=True,
                             stable=True)[1][..., :k]
        w = scores.gather(-1, top_ids)
        gates = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling
    else:
        # The router stays in the activation dtype, as in the reference.
        logits = xg @ w_router.to(xg.dtype)                   # (G, Tg, E)
        # lax.top_k puts equal logits in index order, and so does a stable
        # descending sort; torch.topk promises no order among ties.
        top_logits, top_ids = torch.sort(logits, dim=-1, descending=True,
                                         stable=True)
        top_logits, top_ids = top_logits[..., :k], top_ids[..., :k]
        gates = torch.softmax(top_logits.float(), dim=-1)
    dst, keep = expert_slots(top_ids.reshape(g, tg * k), e, cap)
    return top_ids, gates, dst, keep


def _expert_einsum(ctx: ShardCtx, eq: str, a: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, w)`` of the expert FFN: a (G, E, C, .) and an
    expert-major weight w (E, ., .).

    On a mesh each device multiplies its (group, expert) block by its
    experts' whole weights (the FSDP dim gathered) on local tensors, and
    the weights' gradient is summed over the devices that hold other
    groups: DTensor's own einsum views non-contiguous shards in the
    backward pass, which fails.
    """
    if not ctx.active:
        return torch.einsum(eq, a, w)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    def on(dim):
        return [isinstance(pl, Shard) and pl.dim == dim for pl in a.placements]

    experts, groups = on(1), on(0)
    w_local = w.redistribute(ctx.mesh, [
        Shard(0) if ex else Replicate() for ex in experts]).to_local(
        grad_placements=[Shard(0) if ex else Partial() if gr else Replicate()
                         for ex, gr in zip(experts, groups)])
    y = torch.einsum(eq, a.to_local(), w_local)
    shape = (*a.shape[:3], w.shape[-1])
    return DTensor.from_local(y, ctx.mesh, a.placements, run_check=False,
                              shape=shape, stride=torch.empty(
                                  shape, device="meta").stride())


def _experts_kernel(buf: torch.Tensor, weights: tuple, act: str,
                    ctx: ShardCtx) -> bool:
    """Whether the expert FFN runs as the kernel: off a mesh, where
    ``moe_experts.takes`` the call (a mesh keeps the einsums)."""
    return not ctx.active and moe_experts.takes(buf, *weights, act)


def moe_block(x: torch.Tensor, p: dict, cfg: ModelConfig, *,
              ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """Top-k MoE: route, scatter into per-expert capacity slots, the gated
    expert FFN on every slot (``gecd,edf``/``gecf,efd``), gated combine.

    Tokens split into ``cfg.moe_groups`` routing groups, each with its own
    capacity; with one group, every row of the batch competes for the same
    slots, as in the reference.  On a mesh the groups shard over every
    axis for routing and the experts over the model axis for the FFN, at
    the reference's constraint points.  A ``"shared"`` expert (a gated MLP
    every token runs, ``cfg.shared_expert_ff`` wide) adds its output to the
    routed experts'.  Off a mesh, a call that ``kernels.moe_experts.takes``
    (CUDA, bf16, SiLU, at most 16 slots an expert, no gradient: a decode
    step) runs the expert FFN as the hand-written kernel, which reads only
    the experts some kept copy chose; every other call runs the einsums.
    """
    b, s, d = x.shape
    e, k, g = cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_groups
    tokens = b * s
    if tokens % g:
        raise ValueError(f"tokens ({tokens}) must divide moe_groups ({g})")
    tg = tokens // g
    cap = moe_capacity(tg, cfg)
    xg = x.reshape(g, tg, d)
    all_axes = (*ctx.dp, *((ctx.tp,) if ctx.tp else ()))
    xg = ctx.constrain(xg, all_axes, None, None)

    def dispatch(xg, w_router):
        # Every row of the buffer but the overflow row receives at most one
        # copy, added onto an exact 0, so the result does not depend on the
        # order in which index_add's atomic adds land on the card; the
        # overflow row, which may take many, is dropped.
        g = xg.shape[0]
        _, gates, dst, keep = moe_route(xg, w_router, cfg, cap,
                                        p.get("router_bias"))
        rows = e * cap + 1
        base = torch.arange(g, device=xg.device)[:, None]
        xrep = xg[:, :, None].expand(g, tg, k, d)             # (G, Tg, K, d)
        buf = xg.new_zeros((g * rows, d)).index_add_(
            0, (dst + base * rows).reshape(-1), xrep.reshape(-1, d))
        return (buf.reshape(g, rows, d)[:, :-1].reshape(g, e, cap, d),
                gates, dst, keep)

    def combine(y_e, gates, dst, keep):
        # Each copy reads its slot back (an overflowed copy reads the last
        # real slot and is zeroed by ``keep``), weighted by its gate.
        g = y_e.shape[0]
        base = torch.arange(g, device=y_e.device)[:, None]
        src = torch.clamp_max(dst, e * cap - 1) + base * (e * cap)
        out = y_e.reshape(g * e * cap, d).index_select(0, src.reshape(-1))
        out = out.reshape(g, tg * k, d)
        out = out * keep[..., None].to(out.dtype)
        out = out * gates.reshape(g, tg * k)[..., None].to(out.dtype)
        return out.reshape(g, tg, k, d).sum(dim=2)

    # On a mesh each device routes, dispatches and combines its own groups
    # on local tensors (DTensor's index_add loses track of a batch split
    # over two mesh axes); the expert FFN between runs expert-sharded.
    buf, gates, dst, keep = _on_local_blocks(ctx, dispatch,
                                             (xg, p["w_router"]))
    if not baseline_mode():
        buf = ctx.constrain(buf, all_axes, None, None, None)
    buf = ctx.constrain(buf, ctx.dp, ctx.tp, None, None)   # the EP all-to-all

    weights = (p["w_gate"], p["w_in"], p["w_out"])
    if _experts_kernel(buf, weights, cfg.act, ctx):
        # Decode-sized capacity on one card: the kernel reads only the
        # weights of the experts a kept copy chose (dst, keep on the device).
        y_e = moe_experts.expert_ffn(buf, *weights, dst, keep, cfg.act)
    else:
        act = _ACTS[cfg.act]
        h = act(_expert_einsum(ctx, "gecd,edf->gecf", buf, p["w_gate"])) \
            * _expert_einsum(ctx, "gecd,edf->gecf", buf, p["w_in"])
        h = ctx.constrain(h, ctx.dp, ctx.tp, None, None)
        y_e = _expert_einsum(ctx, "gecf,efd->gecd", h, p["w_out"])
        y_e = ctx.constrain(y_e, ctx.dp, ctx.tp, None, None)
        del h
    y_e = ctx.constrain(y_e, all_axes, None, None, None)   # xg's placements
    # The dispatch buffer and the slots' hidden values are dead once the
    # experts have run: freed before the combine's copies are made (a long
    # prefill's largest transients).
    del buf
    y = _on_local_blocks(ctx, combine, (y_e, gates, dst, keep))
    # Groups back over the data axes alone before they merge into rows,
    # which the model axis does not split.
    y = ctx.constrain(y, ctx.dp, None, None)
    y = ctx.constrain(y.reshape(b, s, d), ctx.dp, None, None)
    if "shared" in p:
        y = y + mlp_block(x, p["shared"], cfg, ctx=ctx)
    return y


# --------------------------------------------------------------------------- #
# Mamba2 (state-space duality, chunked)
# --------------------------------------------------------------------------- #
#: The most bytes one pass of the SSD's intra-chunk term may give its f32
#: (B, chunks, H, Q, Q) decays: a longer call runs the term over slices of
#: its chunks, so that a long prefill's transients stay within a few GiB
#: (granite-4.0-h at 4 x 4096: 2.1 GB a tensor whole, 0.5 GB a slice).
SSD_SLICE_BYTES = 1 << 29


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
    A T that is not a multiple of ``chunk`` pads the last chunk with x = 0
    and dt = 0, positions that leave the state as it is (decay 1, no
    input), and drops their outputs.
    """
    b, t, h, pdim = x.shape
    n = bmat.shape[-1]
    if t % chunk:
        pad = chunk - t % chunk
        y, state = ssd_chunked(
            *(F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
              for a in (x, dt_a, bmat, cmat)),
            chunk=chunk, init_state=init_state)
        return y[:, :t], state
    c = t // chunk
    xr = x.reshape(b, c, chunk, h, pdim)
    ar = dt_a.reshape(b, c, chunk, h).float()
    br = bmat.reshape(b, c, chunk, n)
    cr = cmat.reshape(b, c, chunk, n)

    a_cum = torch.cumsum(ar, dim=2)                           # (B,C,Q,H)

    def intra(sl):
        # Intra-chunk (quadratic) term of the chunks ``sl``.
        decay = torch.exp(_segsum(ar[:, sl].transpose(2, 3)))  # (B,c,H,Q,Q)
        cb = torch.einsum("bcqn,bckn->bcqk", cr[:, sl].float(),
                          br[:, sl].float())
        w = cb[:, :, None] * decay                            # (B,c,H,Q,Q)
        return torch.einsum("bchqk,bckhp->bcqhp", w.to(x.dtype), xr[:, sl])

    per = max(1, SSD_SLICE_BYTES // (b * h * chunk * chunk * 4))
    y_intra = (intra(slice(None)) if per >= c else torch.cat(
        [intra(slice(i, i + per)) for i in range(0, c, per)], dim=1))

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


def _ssd_placements(x_placements):
    """The SSD's outputs' placements on a mesh: y (B, S, H, P) like x, the
    state (B, H, P, N) with x's heads dim moved to dim 1."""
    from torch.distributed.tensor import Shard
    return x_placements, tuple(Shard(1) if p == Shard(2) else p
                               for p in x_placements)


def mamba_block(x: torch.Tensor, p: dict, cfg: ModelConfig, *,
                cache: dict | None = None, ctx: ShardCtx = NO_SHARD,
                ) -> tuple[torch.Tensor, dict | None]:
    """Mamba2 block; returns ``(y, cache)``.

    ``cache`` is ``{"ssm": (B, H, P, N) f32, "conv": (B, W-1, C)}`` (plus
    ``len``) and is written in place: a prefill (S > 1) stores the final
    SSM state and the last W-1 conv inputs, a decode step (S == 1) runs
    the one-token recurrence ``S <- exp(dt*A) S + (dt*x) (x) B; y = C.S``.
    A ``conv_bias`` leaf (C,) is added to the conv's output before SiLU.
    """
    b, s, _ = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    h = cfg.ssm_num_heads
    pdim = di // h
    width = p["w_conv"].shape[0]

    z = ctx.constrain(x @ p["w_z"], ctx.dp, None, ctx.tp)
    xin = ctx.constrain(x @ p["w_x"], ctx.dp, None, ctx.tp)
    bc = x @ p["w_bc"]
    dt = x @ p["w_dt"]

    conv_in = torch.cat([xin, bc], dim=-1)
    decoding = cache is not None and s == 1
    # On a mesh each device convolves its batch rows on local tensors
    # (DTensor's pad loses track of a batch split over two mesh axes).
    conv_in = ctx.constrain(conv_in, ctx.dp, None, None)
    if decoding:
        state = ctx.constrain(cache["conv"], ctx.dp, None, None)
        conv_out, new_conv = _on_local_blocks(
            ctx, _causal_conv, (conv_in, p["w_conv"], state))
    else:
        conv_out, new_conv = _on_local_blocks(
            ctx, lambda c, w: _causal_conv(c, w, None)[0],
            (conv_in, p["w_conv"])), None
    conv_out = conv_out.float()
    if "conv_bias" in p:
        conv_out = conv_out + p["conv_bias"].float()
    conv_out = F.silu(conv_out).to(x.dtype)
    xin, bmat, cmat = torch.split(conv_out, [di, n, n], dim=-1)

    a = -torch.exp(p["a_log"].float())                        # (H,)
    dt = F.softplus(dt.float() + p["dt_bias"].float())        # (B, S, H)
    xh = xin.reshape(b, s, h, pdim)
    x_dt = xh * dt[..., None].to(x.dtype)
    dt_a = dt * a                                             # (B, S, H)

    if not decoding:
        ssd = functools.partial(ssd_chunked, chunk=min(cfg.ssm_chunk, s))
        init = cache["ssm"] if cache is not None else None
        # On a mesh each device runs its batch rows and heads (see
        # ``_on_local_blocks``); the state (B, H, P, N) follows x's
        # placements (B, S, H, P).
        x_dt = ctx.constrain(x_dt, ctx.dp, None, ctx.tp, None)
        dt_a = ctx.constrain(dt_a, ctx.dp, None, ctx.tp)
        bmat = ctx.constrain(bmat, ctx.dp, None, None)
        cmat = ctx.constrain(cmat, ctx.dp, None, None)
        if init is not None:
            init = ctx.constrain(init, ctx.dp, ctx.tp, None, None)
        y, final_state = _on_local_blocks(
            ctx, lambda *a: ssd(*a[:4], init_state=a[4]),
            (x_dt, dt_a, bmat, cmat, init), _ssd_placements)
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
    return ctx.constrain(y @ p["w_out"], ctx.dp, None, None), cache
