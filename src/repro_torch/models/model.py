"""Decoder-only LM over every block kind, in PyTorch.

The port of ``repro/models/model.py``.  Parameters and caches are nested
dicts/tuples of tensors with the reference's layout: the blocks of
``cfg.pattern`` are stacked along a leading ``full_groups`` axis under
``"groups"`` and the ``cfg.tail`` blocks sit apart under ``"tail"``, so a
reference pytree converts leaf by leaf (``models.convert``).  Where the
reference scans over the stacked groups, the port loops over them in
Python.  Hybrid archs (Zamba2) invoke one ``params["shared"]`` attention
block from each ``shared_attn`` position; its weights are stored once,
and each invocation has its own KV cache.  Multi-head latent attention
blocks (``mla``, ``mla_moe``) cache one latent per position, shared by
every head.

Entry points (each takes ``ctx=NO_SHARD``, a ``ShardCtx``; an active one
runs the same code on DTensors placed over a ``DeviceMesh``):
  init_params(cfg, seed=, device=)              -> param tree
  forward(params, cfg, tokens=, remat=)         -> logits (B, S, V) f32
  cross_entropy(logits, targets, mask=)         -> mean next-token loss
  init_cache(cfg, batch, max_len, device=)      -> decode cache tree
  prefill(params, cfg, caches=, tokens=)        -> (logits, caches)
  decode_step(params, cfg, tokens, caches, cache_len, fused=)
                                                -> (logits (B,1,V), caches)
  cache_bytes(cfg, lens, new)                   -> cache bytes a call moves

Caches are written in place; the functions also return them, as the
reference returns its donated caches.  ``forward`` without caches is
differentiable: the per-group views of a stacked leaf accumulate into that
leaf's gradient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.device import resolve_device

from .config import MAMBA_KINDS, MLA_KINDS, ModelConfig
from .layers import (NO_SHARD, ShardCtx, attention_block, mamba_block,
                     mla_block, mlp_block, moe_block, rms_norm)

Params = dict[str, Any]


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def _index(tree, g: int):
    """The ``g``-th entry of every leaf of a stacked block tree (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #
class _Init:
    """Draws the reference's distributions from one ``torch.Generator``.

    ``lead`` is the stacked ``full_groups`` axis (empty for tail blocks);
    each stacked leaf is drawn one group at a time to bound peak memory.
    """

    def __init__(self, gen: torch.Generator, device: torch.device,
                 dt: torch.dtype, lead: tuple[int, ...] = ()):
        self.gen, self.device, self.dt, self.lead = gen, device, dt, lead

    def normal(self, shape, scale: float,
               dtype: torch.dtype | None = None) -> torch.Tensor:
        """N(0, 1) * scale in ``dtype`` (default: the model's)."""
        dt = dtype or self.dt
        out = torch.empty((*self.lead, *shape), dtype=dt, device=self.device)
        flat = out.reshape(-1, *shape) if self.lead else out[None]
        for i in range(flat.shape[0]):
            flat[i] = (torch.randn(shape, generator=self.gen,
                                   device=self.device) * scale).to(dt)
        return out

    def full(self, shape, value: float) -> torch.Tensor:
        """An f32 leaf filled with ``value`` (norms, SSM constants)."""
        return torch.full((*self.lead, *shape), value, dtype=torch.float32,
                          device=self.device)

    def zeros(self, shape) -> torch.Tensor:
        return self.full(shape, 0.0)


def _init_attn(ini: _Init, cfg: ModelConfig) -> dict:
    hd, d = cfg.qk_head_dim, cfg.d_model
    s = 1.0 / math.sqrt(d)
    so = 1.0 / math.sqrt(cfg.num_heads * hd)
    return {"wq": ini.normal((d, cfg.num_heads * hd), s),
            "wk": ini.normal((d, cfg.num_kv_heads * hd), s),
            "wv": ini.normal((d, cfg.num_kv_heads * hd), s),
            "wo": ini.normal((cfg.num_heads * hd, d), so)}


def _init_mlp(ini: _Init, cfg: ModelConfig, f: int | None = None) -> dict:
    """A dense FFN of width ``f`` (``cfg.d_ff`` where None)."""
    d, f = cfg.d_model, f or cfg.d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"w_in": ini.normal((d, f), s_in), "w_out": ini.normal((f, d), s_out)}
    if cfg.gated_mlp:
        p["w_gate"] = ini.normal((d, f), s_in)
    return p


def _init_moe(ini: _Init, cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"w_router": ini.normal((d, e), s_in, torch.float32),
         "w_gate": ini.normal((e, d, f), s_in),
         "w_in": ini.normal((e, d, f), s_in),
         "w_out": ini.normal((e, f, d), s_out)}
    if cfg.router_scoring == "sigmoid":
        p["router_bias"] = ini.zeros((e,))
    if cfg.shared_expert_ff:
        p["shared"] = _init_mlp(ini, dataclasses.replace(
            cfg, d_ff=cfg.shared_expert_ff, gated_mlp=True))
    return p


def _init_mla(ini: _Init, cfg: ModelConfig) -> dict:
    d, h, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    dkv = cfg.qk_nope_head_dim + cfg.v_head_dim
    s = 1.0 / math.sqrt(d)
    return {"wq": ini.normal((d, h * dq), s),
            "w_kv_a": ini.normal((d, cfg.mla_latent_dim), s),
            "kv_norm": ini.zeros((r,)),
            "w_kv_b": ini.normal((r, h * dkv), 1.0 / math.sqrt(r)),
            "wo": ini.normal((h * cfg.v_head_dim, d),
                             1.0 / math.sqrt(h * cfg.v_head_dim))}


def _init_mamba(ini: _Init, cfg: ModelConfig) -> dict:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h = cfg.ssm_num_heads
    s = 1.0 / math.sqrt(d)
    return {"w_z": ini.normal((d, di), s),
            "w_x": ini.normal((d, di), s),
            "w_bc": ini.normal((d, 2 * n), s),
            "w_dt": ini.normal((d, h), s),
            "w_conv": ini.normal((cfg.conv_width, di + 2 * n),
                                 1.0 / math.sqrt(cfg.conv_width)),
            **({"conv_bias": ini.zeros((di + 2 * n,))} if cfg.conv_bias
               else {}),
            "a_log": ini.zeros((h,)),
            "dt_bias": ini.full((h,), -2.0),   # softplus ~= 0.12
            "d_skip": ini.full((h,), 1.0),
            "w_norm": ini.zeros((di,)),
            "w_out": ini.normal((di, d), 1.0 / math.sqrt(di))}


def _init_block(ini: _Init, kind: str, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    if kind == "mamba":
        return {"norm1": ini.zeros((d,)), "mamba": _init_mamba(ini, cfg)}
    if kind == "mamba_moe":
        return {"norm1": ini.zeros((d,)), "mamba": _init_mamba(ini, cfg),
                "norm2": ini.zeros((d,)), "moe": _init_moe(ini, cfg)}
    if kind == "shared_attn":
        return {}   # the weights live once, in params["shared"]
    if kind in MLA_KINDS:
        p = {"norm1": ini.zeros((d,)), "norm2": ini.zeros((d,)),
             "mla": _init_mla(ini, cfg)}
        if kind == "mla_moe":
            p["moe"] = _init_moe(ini, cfg)
        else:
            p["mlp"] = _init_mlp(ini, cfg, cfg.dense_d_ff)
        return p
    p = {"norm1": ini.zeros((d,)), "norm2": ini.zeros((d,)),
         "attn": _init_attn(ini, cfg)}
    if kind == "attn_moe":
        p["moe"] = _init_moe(ini, cfg)
    else:
        p["mlp"] = _init_mlp(ini, cfg)
    return p


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: str | torch.device = "cuda") -> Params:
    """Random parameters with the reference's distributions and scales,
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    # On the meta device (shapes and dtypes only) there is nothing to draw.
    gen = (None if dev.type == "meta" else
           torch.Generator(device=dev).manual_seed(seed))
    dt = _dtype(cfg.dtype)
    d, vp = cfg.d_model, cfg.vocab_padded
    stacked = _Init(gen, dev, dt, (cfg.full_groups,))
    single = _Init(gen, dev, dt)
    params: Params = {
        "embed": single.normal((vp, d), 0.02),
        "groups": tuple(_init_block(stacked, kind, cfg)
                        for kind in cfg.pattern),
        "tail": tuple(_init_block(single, kind, cfg) for kind in cfg.tail),
        "final_norm": single.zeros((d,)),
    }
    if cfg.uses_shared_block:
        params["shared"] = _init_block(single, "attn", cfg)
    if not cfg.tie_embeddings:
        params["lm_head"] = single.normal((d, vp), 1.0 / math.sqrt(d))
    return params


# --------------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------------- #
def _apply_block(h, bp, kind, cfg: ModelConfig, *, positions, cache=None,
                 shared=None, fused=False, ctx: ShardCtx = NO_SHARD):
    """One decoder block; returns (h, cache).  A ``shared_attn`` block runs
    the ``shared`` attention block's weights.  Each branch's output joins
    the residual times ``cfg.residual_multiplier``."""
    if kind == "shared_attn":
        bp, kind = shared, "attn"
    window = cfg.sliding_window if kind == "local" else 0
    mixer_in = rms_norm(h, bp["norm1"], cfg.norm_eps)
    if kind in MAMBA_KINDS:
        m_out, new_cache = mamba_block(mixer_in, bp["mamba"], cfg,
                                       cache=cache, ctx=ctx)
    elif kind in MLA_KINDS:
        m_out, new_cache = mla_block(mixer_in, bp["mla"], cfg,
                                     positions=positions, cache=cache,
                                     ctx=ctx)
    else:
        m_out, new_cache = attention_block(mixer_in, bp["attn"], cfg,
                                           positions=positions, window=window,
                                           cache=cache, fused=fused, ctx=ctx)
    h = _residual(h, m_out, cfg)
    if kind == "mamba":
        return h, new_cache
    f_in = rms_norm(h, bp["norm2"], cfg.norm_eps)
    if "moe" in bp:
        f_out = moe_block(f_in, bp["moe"], cfg, ctx=ctx)
    else:
        f_out = mlp_block(f_in, bp["mlp"], cfg, ctx=ctx)
    return _residual(h, f_out, cfg), new_cache


def _residual(h, out, cfg: ModelConfig):
    """``h + m * out`` with Granite's residual multiplier m; a multiplier
    of 1 adds no operation."""
    m = cfg.residual_multiplier
    return h + (out if m == 1.0 else out * m)


def _run_stack(params, h, cfg: ModelConfig, *, positions, caches=None,
               cache_len=None, fused=False, remat=False,
               ctx: ShardCtx = NO_SHARD):
    """The full groups in order, then the tail.  Returns (h, caches).

    ``remat=True`` recomputes each group's activations in the backward
    pass instead of keeping them (``torch.utils.checkpoint`` per group, the
    reference's ``jax.checkpoint`` with ``nothing_saveable``).
    """
    shared = params.get("shared")

    def with_len(entry):
        return None if entry is None else dict(entry, len=cache_len)

    def group_body(hh, g: int):
        for i, kind in enumerate(cfg.pattern):
            entry = (_index(caches["groups"][i], g)
                     if caches is not None else None)
            hh, _ = _apply_block(hh, _index(params["groups"][i], g), kind,
                                 cfg, positions=positions,
                                 cache=with_len(entry), shared=shared,
                                 fused=fused, ctx=ctx)
        return hh

    for g in range(cfg.full_groups):
        if remat:
            h = checkpoint(group_body, h, g, use_reentrant=False)
        else:
            h = group_body(h, g)
    for i, kind in enumerate(cfg.tail):
        entry = caches["tail"][i] if caches is not None else None
        h, _ = _apply_block(h, params["tail"][i], kind, cfg,
                            positions=positions, cache=with_len(entry),
                            shared=shared, fused=fused, ctx=ctx)
    return h, caches


# --------------------------------------------------------------------------- #
# Forward (prefill)
# --------------------------------------------------------------------------- #
def embed_tokens(params, tokens: torch.Tensor,
                 cfg: ModelConfig | None = None,
                 ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """The embedding rows of ``tokens``, times ``cfg``'s embedding
    multiplier (none without ``cfg``, or at 1)."""
    if not ctx.active:
        h = params["embed"][tokens.long()]
    else:
        h = ctx.constrain(_embed_on_shards(params["embed"], tokens, ctx),
                          ctx.dp, None, None)
    if cfg is not None and cfg.embedding_multiplier != 1.0:
        h = h * cfg.embedding_multiplier
    return h


def _embed_on_shards(table, tokens, ctx: ShardCtx):
    """The lookup on a mesh: each device looks up its batch rows' tokens in
    its vocabulary block of the table (ids outside the block give zeros),
    a partial sum over the model axis.  DTensor's own index op refuses a
    batch sharded over two mesh axes (``pod`` and ``data``) in some
    releases."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = ctx.mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tokens = ctx.constrain(tokens, ctx.dp, *(None,) * (tokens.ndim - 1))
    split = ctx.tp_size() > 1 and table.shape[0] % ctx.tp_size() == 0
    vocab = [split and n == ctx.tp for n in mesh.mesh_dim_names]
    rows = [isinstance(p, Shard) for p in tokens.placements]
    local = table.redistribute(mesh, [
        Shard(0) if vb else Replicate() for vb in vocab]).to_local(
        grad_placements=[Shard(0) if vb else Partial() if r else Replicate()
                         for vb, r in zip(vocab, rows)])
    ids = tokens.to_local().long()
    if split:
        block = local.shape[0]
        ids = ids - block * mesh.get_local_rank(ctx.tp)
        inside = (ids >= 0) & (ids < block)
        out = local[ids.clamp(0, block - 1)] * inside[..., None].to(
            local.dtype)
    else:
        out = local[ids]
    return DTensor.from_local(out, mesh, [
        Partial() if vb else p for vb, p in zip(vocab, tokens.placements)],
        run_check=False)


class _GradDtypeBarrier(torch.autograd.Function):
    """Identity; casts the cotangent back to the activation dtype.

    The reference places this at the logits boundary so that the f32
    loss's cotangent does not keep the whole decoder backward in f32
    (its ``_grad_dtype_barrier``, a ``jax.custom_vjp``).
    """

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def _grad_dtype_barrier(x: torch.Tensor, dtype_str: str) -> torch.Tensor:
    return _GradDtypeBarrier.apply(x, _dtype(dtype_str))


def logits_from_hidden(params, h, cfg: ModelConfig,
                       ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    h = _grad_dtype_barrier(h, cfg.dtype)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps).float()
    if cfg.logits_scaling != 1.0:
        # Granite's logits divisor, taken on the hidden state: no second
        # logits-sized tensor (exact for a power of two).
        h = h / cfg.logits_scaling
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = h @ head.float()
    if cfg.vocab_padded != cfg.vocab_size:
        # Mask padded vocabulary columns.
        pad = torch.arange(cfg.vocab_padded, device=h.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return ctx.constrain(logits, ctx.dp, None, ctx.tp)


def _hidden(params, cfg, tokens, embeds, ctx):
    if (tokens is None) == (embeds is None):
        raise ValueError("provide exactly one of tokens/embeds")
    if embeds is None:
        return embed_tokens(params, tokens, cfg, ctx)
    return ctx.constrain(embeds.to(_dtype(cfg.dtype)), ctx.dp, None, None)


def forward(params, cfg: ModelConfig, *, tokens=None, embeds=None,
            positions=None, remat: bool = False,
            ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V)."""
    with ctx.scope():
        h = _hidden(params, cfg, tokens, embeds, ctx)
        b, s = h.shape[:2]
        if positions is None:
            positions = torch.arange(s, device=h.device)[None].expand(b, s)
        h, _ = _run_stack(params, h, cfg, positions=positions, remat=remat,
                          ctx=ctx)
        return logits_from_hidden(params, h, cfg, ctx)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE; logits (B,S,V) f32, targets (B,S) int.

    The reference writes the default branch so that vocab-sharded logits
    are never gathered: an explicit max/sum logsumexp with the max held
    out of the gradient.  The port keeps that formulation, and the
    ``REPRO_BASELINE`` branch's library logsumexp; on one device the gold
    logit is a gather in both (the reference's one-hot einsum picks the
    same f32 value).
    """
    from repro_torch.runtime.flags import baseline_mode
    logits = logits[:, :-1]
    targets = targets[:, 1:].long()
    if baseline_mode():  # paper-faithful baseline: naive CE formulation
        lse = torch.logsumexp(logits, dim=-1)
    else:
        lmax = logits.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.sum(torch.exp(logits - lmax), dim=-1)) \
            + lmax[..., 0]
    if _is_dtensor(logits):
        # Vocab-sharded logits: the reference's one-hot product, which
        # each device computes on its own vocabulary columns.
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        gold = (logits * (targets[..., None] == vocab).to(logits.dtype)
                ).sum(dim=-1)
    else:
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask[:, 1:].to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def prefill(params, cfg: ModelConfig, *, caches, tokens=None, embeds=None,
            last_only: bool = False, ctx: ShardCtx = NO_SHARD):
    """Batched prefill: full-sequence forward that also fills ``caches``.

    Returns (logits (B, S, V), caches); with ``last_only`` the logits of
    the last position alone, (B, 1, V): the head runs on that position.
    """
    with ctx.scope():
        h = _hidden(params, cfg, tokens, embeds, ctx)
        b, s = h.shape[:2]
        positions = torch.arange(s, device=h.device)[None].expand(b, s)
        h, caches = _run_stack(params, h, cfg, positions=positions,
                               caches=caches, cache_len=0, ctx=ctx)
        if last_only:
            h = h[:, -1:]
        return logits_from_hidden(params, h, cfg, ctx), caches


# --------------------------------------------------------------------------- #
# Decode (single-token serve step with caches)
# --------------------------------------------------------------------------- #
def _cache_entry(kind: str, cfg: ModelConfig, lead: tuple[int, ...],
                 batch: int, max_len: int, dt: torch.dtype,
                 device: torch.device) -> dict:
    if kind in MAMBA_KINDS:
        # The SSM state accumulates over the whole sequence: kept in f32.
        h = cfg.ssm_num_heads
        return {"ssm": torch.zeros((*lead, batch, h, cfg.d_inner // h,
                                    cfg.ssm_state), dtype=torch.float32,
                                   device=device),
                "conv": torch.zeros((*lead, batch, cfg.conv_width - 1,
                                     cfg.d_inner + 2 * cfg.ssm_state),
                                    dtype=dt, device=device)}
    if kind in MLA_KINDS:
        # One latent and one shared rotary key per position, no head.
        if cfg.kv_quant:
            raise ValueError("an MLA latent cache has no int8 form")
        return {"latent": torch.zeros((*lead, batch, max_len,
                                       cfg.mla_latent_dim), dtype=dt,
                                      device=device)}
    length = max_len
    if kind == "local" and cfg.sliding_window:
        length = min(max_len, cfg.sliding_window)  # ring buffer
    kv_dt = torch.int8 if cfg.kv_quant else dt
    shape = (*lead, batch, length, cfg.num_kv_heads, cfg.qk_head_dim)
    entry = {"k": torch.zeros(shape, dtype=kv_dt, device=device),
             "v": torch.zeros(shape, dtype=kv_dt, device=device)}
    if cfg.kv_quant:
        sshape = (*shape[:-1], 1)
        entry["k_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                       device=device)
        entry["v_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                       device=device)
    return entry


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: str | None = None, *,
               device: str | torch.device = "cuda"):
    """Zeroed caches: group leaves ``(full_groups, B, ...)``, tail
    ``(B, ...)``; each ``shared_attn`` position has its own attention cache."""
    dev = resolve_device(device)
    dt = _dtype(dtype or cfg.dtype)

    def entry(kind, lead):
        return _cache_entry("attn" if kind == "shared_attn" else kind, cfg,
                            lead, batch, max_len, dt, dev)

    return {"groups": tuple(entry(kind, (cfg.full_groups,))
                            for kind in cfg.pattern),
            "tail": tuple(entry(kind, ()) for kind in cfg.tail)}


def decode_step(params, cfg: ModelConfig, tokens, caches, cache_len, *,
                fused: bool = False, ctx: ShardCtx = NO_SHARD):
    """One decode step: tokens (B, 1) int -> (logits (B,1,V), caches).

    ``cache_len`` is the number of tokens already in the cache, a scalar or
    a per-slot (B,) vector; each row writes its new token there and takes
    it as its rotary position.  ``fused=True`` runs every attention block
    through the fused decode-attention kernel, one launch per layer.
    """
    with ctx.scope():
        h = embed_tokens(params, tokens, cfg, ctx)
        b = tokens.shape[0]
        lens = torch.as_tensor(cache_len, dtype=torch.int32, device=h.device)
        if lens.ndim == 0:
            lens = lens.expand(b)
        lens = lens.contiguous()
        positions = lens[:, None]                   # (B, 1) per-slot position
        h, caches = _run_stack(params, h, cfg, positions=positions,
                               caches=caches, cache_len=lens, fused=fused,
                               ctx=ctx)
        return logits_from_hidden(params, h, cfg, ctx), caches


def cache_bytes(cfg: ModelConfig, lens, new: int) -> int:
    """The bytes of the decode caches one call reads and writes, over every
    layer: each row (one per entry of ``lens``) reads its cache below its
    length ``lens[i]`` (a local layer: its window of it) and writes ``new``
    positions; an attention layer's (a ``shared_attn`` position's too)
    position is its K and V (int8 and
    their f32 scales where ``kv_quant``), an MLA layer's its latent and
    shared rotary key; a Mamba layer writes its row's SSM state (f32) and
    conv window and, in a decode step, reads them first.  A decode step is
    ``new`` 1; a prefill from nothing is ``lens`` 0 and ``new`` its length
    (more than 1), for every row it computes."""
    e = _dtype(cfg.dtype).itemsize
    lens = [int(n) for n in lens]
    total = 0
    for kind in list(cfg.pattern) * cfg.full_groups + list(cfg.tail):
        if kind in MAMBA_KINDS:
            h = cfg.ssm_num_heads
            state = (h * (cfg.d_inner // h) * cfg.ssm_state * 4
                     + (cfg.conv_width - 1)
                     * (cfg.d_inner + 2 * cfg.ssm_state) * e)
            total += state * len(lens) * (2 if new == 1 else 1)
            continue
        if kind in MLA_KINDS:
            per = cfg.mla_latent_dim * e
        elif cfg.kv_quant:
            per = 2 * cfg.num_kv_heads * (cfg.qk_head_dim + 4)
        else:
            per = 2 * cfg.num_kv_heads * cfg.qk_head_dim * e
        keep = (cfg.sliding_window if kind == "local" and cfg.sliding_window
                else None)
        total += per * sum((min(n, keep) if keep else n) + new for n in lens)
    return total


def merge_cache_slots(live, fresh, slot_mask):
    """Copy the ``slot_mask`` rows of ``fresh`` into ``live``, in place.

    Group leaves are ``(full_groups, B, ...)`` (batch axis 1), tail leaves
    ``(B, ...)`` (batch axis 0), whatever the block kind; rows where the
    mask is False keep their live state bit for bit.  The rows are picked
    by ``torch.where`` on a broadcast row mask, so a mask on the device is
    never read back to the host.  Returns ``live``.
    """
    entries = [(le, fe, 1) for le, fe in zip(live["groups"], fresh["groups"])]
    entries += [(le, fe, 0) for le, fe in zip(live["tail"], fresh["tail"])]
    if not entries:
        return live
    device = next(iter(entries[0][0].values())).device
    mask = torch.as_tensor(slot_mask, dtype=torch.bool, device=device)
    for le, fe, axis in entries:
        for k, leaf in le.items():
            rows = mask.reshape((1,) * axis + (-1,)
                                + (1,) * (leaf.ndim - axis - 1))
            leaf.copy_(torch.where(rows, fe[k].to(leaf.dtype), leaf))
    return live
