"""Fused decode-attention step: rope + KV scatter + attend, one call.

The port of ``repro/kernels/decode_attention.py``.  For each batch row it
rotates q and the new k over their leading ``2 * W`` dims from precomputed
f32 angles, quantises the new k/v per vector when the caches are int8,
writes them to slot ``len`` (``len % slots`` for ring caches), and attends
over the row's valid prefix with one softmax over all slots and one p@V.
The caches are updated in place, the counterpart of the reference's
``input_output_aliases``.

Two implementations of the same function live here:

  * the CUDA C++ kernels ``csrc/decode_attention.cu`` for ``sm_90a``, two
    or three launches per call on the caller's stream, each on a (B, K,
    NSPLIT) grid: one CTA per (batch row, kv head, chunk of slots) holding
    all G q heads of its group, so every K and V element is read once per
    call.  The scores pass ropes q, writes the new token (in the one CTA
    whose chunk holds it), and scores its chunk into an f32 scratch with
    each chunk's row maxima; the softmax's sums are taken per chunk and
    added in chunk order, by a stats pass or, for small row groups
    (``fold_stats``), by every CTA of the p@V pass; the p@V pass writes
    f32 partials per chunk, which the group's last CTA sums in chunk order
    and casts once.  The later passes launch programmatically after the
    first.
    bf16 activations whose head dim is a multiple of 16 run both products
    on the tensor cores, others on CUDA cores; tiles are staged through a
    ring of shared-memory stages by ``cp.async``.  NSPLIT and the chunk come
    from the shapes alone (``split_plan``), so nothing is read back from
    the card; the source note says what bounds the step and what the
    design does about it;
  * ``decode_attention_plain``, plain PyTorch that follows the reference's
    ``_decode_kernel`` step for step.  The CPU tests hold it against the
    reference, and the chip smoke run holds the kernels against it.

``fused_decode_attention`` takes the plain version only for tensors that
lie on the CPU; CUDA tensors go to the kernels or raise.  Every call that
launches them adds one to ``_build.LAUNCHES["decode_attention"]`` (one
call, two or three launches), so a serving run counts one per attention
layer and decode step.

The slot-shard form, ``decode_attention_shard`` (and its plain version
``decode_attention_shard_plain``), is the same step on one device's block
of a cache whose slots are split over a mesh's model axis
(flash-decoding): the block's scores, then the softmax's max and sum and
the partial p@V, each reduced over the devices by the caller's
collectives (``all_max``, ``all_sum``), then one cast.  That is the
reference's decode step as its partitioner splits it over the slots, so
no device gathers the cache.  With one block and no collective it is the
whole call, bit for bit.  ``decode_attention_over_shards`` runs several
blocks of one cache side by side on one device, reduced there, which is
how the tests and the chip smoke run hold the form.  Every block whose
kernels launch adds one to ``_build.LAUNCHES["decode_attention_shard"]``
(four launches: scores, max, sum, p@V); an empty block launches none and
counts nothing.

``latent_decode_attention`` is multi-head latent attention's decode step
(``models.layers.mla_block``, absorbed): every head's query over one cached
576-wide row a position, whose leading 512 values are the position's
value.  It has no counterpart in the reference.  The latent kernels of
``csrc/decode_attention.cu`` take it on the card in bf16 (two launches,
one count under ``_build.LAUNCHES["decode_attention_latent"]``), and
``latent_decode_attention_plain`` everywhere else.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import numpy as np
import torch

from . import _build

#: Matches ``models.layers.NEG_INF`` — the mask fill of the unfused path.
NEG_INF = -0.7 * float(np.finfo(np.float32).max)

_ENTRIES = {
    (torch.float32, torch.float32): "decode_attention_f32",
    (torch.bfloat16, torch.bfloat16): "decode_attention_bf16",
    (torch.float32, torch.int8): "decode_attention_q8_f32",
    (torch.bfloat16, torch.int8): "decode_attention_q8_bf16",
}
_MAX_HEAD_DIM = 256          # the largest head dim the kernels take
_MAX_G = 64                  # q heads per kv head the kernels take (kMaxG)
_MAX_SMEM = 227 * 1024       # shared memory one Hopper CTA may use
_STAGES = 3                  # K tiles in a scores CTA's ring (kStages)
_STAGES_PV = 2               # V tiles in a p@V CTA's ring (kStagesPV)
_FOLD_BYTES = 16 * 1024      # kFoldBytes: see fold_stats
_TILE = 64                   # slots per tile on tensor cores (kTileTC); chunks
                             # are whole tiles
_TILE_CC = 32                # slots per tile on CUDA cores (kTileCC)
_CTAS_PER_SM = 4             # CTAs per SM split_plan aims for
_ARGTYPES = ((ctypes.c_void_p,) * 12 + (ctypes.c_longlong,)
             + (ctypes.c_int,) * 10 + (ctypes.c_void_p,))
_SCORES_ARGTYPES = ((ctypes.c_void_p,) * 12 + (ctypes.c_longlong,)
                    + (ctypes.c_int,) * 13 + (ctypes.c_void_p,))
_PV_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_longlong,)
                + (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 11
                + (ctypes.c_void_p,))
_SUM_ARGTYPES = ((ctypes.c_void_p, ctypes.c_longlong) + (ctypes.c_void_p,) * 3
                 + (ctypes.c_int,) * 9 + (ctypes.c_void_p,))
#: True inside ``cuda_core_build()``: bf16 calls take the CUDA-core build.
_CUDA_CORES = False


def split_plan(batch: int, kv_heads: int, slots: int,
               sms: int) -> tuple[int, int]:
    """``(nsplit, chunk)``: how every pass of the kernels cuts the slot axis
    on a card of ``sms`` SMs.

    From shapes alone, never from the row lengths (reading them would sync
    the stream): about ``_CTAS_PER_SM`` CTAs per SM over the ``batch *
    kv_heads`` groups, however many groups there are, in chunks of whole
    ``_TILE``-slot tiles (so never less than a tile's worth of slots, where
    a CTA's fixed cost outweighs its slots).  ``nsplit = ceil(slots /
    chunk)``, and no chunk is empty.
    """
    if min(batch, kv_heads, slots, sms) < 1:
        raise ValueError(f"no split of batch={batch}, kv_heads={kv_heads}, "
                         f"slots={slots} on {sms} SMs")
    tiles = -(-slots // _TILE)
    want = -(-(_CTAS_PER_SM * sms) // (batch * kv_heads))
    chunk = -(-tiles // min(want, tiles)) * _TILE
    return -(-slots // chunk), chunk


def tensor_cores(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether a call of activation ``dtype`` and ``head_dim`` runs on the
    tensor-core build (bf16, whole k16 steps), as the kernels choose it:
    from dtype and shape only (``cuda_core_build()`` asks for the other)."""
    return (dtype == torch.bfloat16 and head_dim % 16 == 0
            and not _CUDA_CORES)


@contextlib.contextmanager
def cuda_core_build():
    """Run the bf16 calls made inside on the kernels' CUDA-core build, so
    that both builds can be held against the plain version on the card."""
    global _CUDA_CORES
    before, _CUDA_CORES = _CUDA_CORES, True
    try:
        yield
    finally:
        _CUDA_CORES = before


def _up(x: int, a: int) -> int:
    return -(-x // a) * a


def fold_stats(g: int, slots: int, nsplit: int) -> bool:
    """Whether a whole call folds the softmax's statistics into its p@V
    pass (two launches; ``fold_stats`` in the kernels): a row group's
    scores and chunk maxima fit in ``_FOLD_BYTES`` of shared memory."""
    return (g * slots + nsplit * g) * 4 <= _FOLD_BYTES


def smem_bytes(g: int, d: int, act_size: int, cache_size: int, *, tc: bool,
               pv: bool, slots: int = 0, nsplit: int = 0,
               fold: bool = False) -> int:
    """Dynamic shared memory of one CTA of the scores pass (``pv`` False)
    or the p@V pass, as the kernels lay it out (``Layout``): the q heads or
    the p tile; the scores pass's inputs (q rows, k_new, v_new, cos, sin)
    or the p@V pass's new v row; a ring of cache tiles (``_STAGES``,
    ``_STAGES_PV`` for p@V; rows padded by 16 bytes), int8 scales and the
    bf16 tile they dequantise into; the new token's k row, or the p@V
    pass's staged scores (folded: the chunk maxima, the group's rows of
    ``slots`` scores and the chunk sums; else score tiles) and its f32
    sums; the row statistics."""
    tile = _TILE if tc else _TILE_CC
    rows = _up(g, 16) if tc else g
    ald = (tile + 8 if tc else tile) if pv else (d + 8 if tc else d + 1)
    quant = cache_size == 1
    stages = _STAGES_PV if pv else _STAGES
    n = _up(rows * ald * (2 if tc else 4), 16)
    if pv:
        n += _up(d * cache_size, 16) + 16
    else:
        n += (_up(g * d * act_size, 16) + 2 * _up(d * act_size, 16)
              + 2 * _up(d // 2 * 4, 16))
    n += stages * tile * (_up(d * cache_size, 16) + 16)
    n += stages * tile * 4 if quant else 0
    n += tile * (d + 8) * 2 if tc and quant else 0
    if pv:
        x = 2 * nsplit * g + g * slots if fold else _STAGES_PV * g * tile
        n += _up(x * 4, 16) + rows * d * 4
    else:
        n += _up(d * cache_size, 16)
    return n + (2 * rows * 4 if pv else 8 * rows * 4)


def workspace_bytes(batch: int, kv_heads: int, g: int, d: int, slots: int,
                    chunk: int) -> int:
    """Bytes of one call's (or one block's) workspace, as the kernels
    carve it (``Workspace``, which refuses a shorter one):
    scores (B, K, G, S), chunk maxima and sums (B, K, NSPLIT, G), the
    whole call's max and sum (B, H), tickets (2, B*K), p@V partials
    (B, K, NSPLIT, G, D); f32 and int32, each part on 256 bytes."""
    rows, ns = batch * kv_heads * g, -(-slots // chunk)
    return sum(_up(n * 4, 256) for n in (rows * slots, rows * ns, rows * ns,
                                         rows, rows, 2 * batch * kv_heads,
                                         rows * ns * d))


def pick_chunk(slots: int) -> int:
    """Largest power-of-two score-chunk size (<=64) dividing ``slots``.

    Kept from the reference, whose TPU kernel scores the cache in chunks of
    this size.  The CUDA kernels cut the slots by ``split_plan`` instead;
    neither chunking changes what a score is.
    """
    for c in (64, 32, 16, 8, 4, 2, 1):
        if slots % c == 0:
            return c
    return 1


def _true_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` rounded once.

    A CUDA tensor divided by a Python scalar is multiplied by the scalar's
    reciprocal instead, which can differ in the last bit; a tensor divisor
    keeps the IEEE quotient the kernel and the reference compute.
    """
    return x / x.new_tensor(divisor)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the leading ``2 * W`` dims of x (B,1,N,D) by cos/sin (B,W).

    ``models.layers._rotate`` per batch row: each product and sum rounds on
    its own in f32 and the result rounds once to x's dtype.
    """
    w = cos.shape[-1]
    cos = cos[:, None, None, :]
    sin = sin[:, None, None, :]
    x1, x2 = x[..., :w], x[..., w:2 * w]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rot.to(x.dtype), x[..., 2 * w:]], dim=-1)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., D) -> int8 codes + f32 scale per vector (amax/127, half-even)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(_true_div(amax, 127.0), 1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _lens(cache_len, b: int, device: torch.device) -> torch.Tensor:
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=device)
    if lens.ndim == 0:
        lens = lens.expand(b)
    return lens.contiguous()


def write_slots(cache: torch.Tensor, rows: torch.Tensor, write: torch.Tensor,
                val: torch.Tensor) -> None:
    """``cache[rows, write] = val`` in place, a write past the cache dropped
    as the reference's scatter and the kernel drop it (a freed slot keeps
    its last length, which runs one past the cache after a request
    restored from a checkpoint finishes at ``max_len``).  A negative
    ``write`` (a slot before a shard's block) is dropped too.  No host
    sync: a dropped row writes its last slot's own value back."""
    slots = cache.shape[1]
    if slots == 0:          # an empty block of a cache holds no slot
        return
    inside = (write >= 0) & (write < slots)
    at = torch.where(inside, write, slots - 1)
    keep = inside.view(-1, *([1] * (val.dim() - 1)))
    cache[rows, at] = torch.where(keep, val.to(cache.dtype), cache[rows, at])


def live_slots(lens: torch.Tensor, size: int, *, slot_base: int = 0,
               window: int = 0) -> torch.Tensor:
    """(B, size) mask of the live slots of a block holding global slots
    ``slot_base ...``: positions before ``lens`` (B,), which counts the new
    token, and within the last ``window`` of them (0: no window)."""
    pos = slot_base + torch.arange(size, device=lens.device)
    mask = pos[None, :] < lens[:, None]
    if window:
        mask &= pos[None, :] > lens[:, None] - 1 - window
    return mask


def _plain_scores(q, k_new, v_new, k_cache, v_cache, lens, cos, sin, k_scale,
                  v_scale, *, window: int, is_ring: bool, slot_base: int,
                  slots: int):
    """Rope, quantise and write the new token, then score the block: the
    masked f32 scores (B, K, G, S_block) and the block's values in the
    activation dtype.  The block holds global slots ``slot_base ...`` of a
    ``slots``-slot cache; it writes the new token only if its slot lies
    inside."""
    b, _, h, d = q.shape
    block, kh = k_cache.shape[1], k_new.shape[2]
    g = h // kh
    write = (lens % slots if is_ring else lens) - slot_base
    w = cos.shape[-1]
    cos2 = cos.float().reshape(b, w)
    sin2 = sin.float().reshape(b, w)
    qr = _rope(q, cos2, sin2)                       # (B, 1, H, D)
    kr = _rope(k_new, cos2, sin2)                   # (B, 1, K, D)
    rows = torch.arange(b, device=q.device)
    if k_scale is not None:
        kq, ksc = quantize_kv(kr)
        vq, vsc = quantize_kv(v_new)
        write_slots(k_cache, rows, write, kq[:, 0])
        write_slots(v_cache, rows, write, vq[:, 0])
        write_slots(k_scale, rows, write, ksc[:, 0])
        write_slots(v_scale, rows, write, vsc[:, 0])
        k_full = (k_cache.float() * k_scale).to(q.dtype)
        v_full = (v_cache.float() * v_scale).to(q.dtype)
    else:
        write_slots(k_cache, rows, write, kr[:, 0])
        write_slots(v_cache, rows, write, v_new[:, 0])
        k_full, v_full = k_cache, v_cache
    qg = qr.reshape(b, kh, g, d)                    # K-major head groups
    s = _true_div(torch.einsum("bkgd,bskd->bkgs", qg.float(), k_full.float()),
                  math.sqrt(d))
    mask = live_slots(lens + 1, block, slot_base=slot_base, window=window)
    return torch.where(mask[:, None, None, :], s, NEG_INF), v_full


def _returned(out, k_cache, v_cache, k_scale, v_scale):
    if k_scale is not None:
        return out, k_cache, v_cache, k_scale, v_scale
    return out, k_cache, v_cache


def decode_attention_plain(q, k_new, v_new, k_cache, v_cache, cache_len, cos,
                           sin, k_scale=None, v_scale=None, *, window: int = 0,
                           is_ring: bool = False):
    """Plain PyTorch version of the kernel, step for step; same signature
    and return value as :func:`fused_decode_attention`."""
    b, _, h, d = q.shape
    lens = _lens(cache_len, b, q.device).long()
    s, v_full = _plain_scores(q, k_new, v_new, k_cache, v_cache, lens, cos,
                              sin, k_scale, v_scale, window=window,
                              is_ring=is_ring, slot_base=0,
                              slots=k_cache.shape[1])
    p = torch.softmax(s, dim=-1)                    # one full-length softmax
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_full.dtype).float(),
                       v_full.float())
    out = out.reshape(b, 1, h, d).to(q.dtype)
    return _returned(out, k_cache, v_cache, k_scale, v_scale)


# --------------------------------------------------------------------------- #
# The slot-shard form
# --------------------------------------------------------------------------- #
def slot_blocks(slots: int, shards: int) -> list[tuple[int, int]]:
    """``(slot_base, size)`` of each of ``shards`` blocks of a ``slots``-slot
    axis, as DTensor's ``Shard`` cuts it: blocks of ``ceil(slots /
    shards)``, the last ones shorter or empty."""
    chunk = -(-slots // shards)
    return [(min(i * chunk, slots), max(0, min(chunk, slots - i * chunk)))
            for i in range(shards)]


def _softmax_pv(s: torch.Tensor, v: torch.Tensor, dtype: torch.dtype):
    """The softmax and p@V of masked block scores s (B, K, G, S_block) f32
    over values v (B, S_block, K, D), as a generator: it yields each
    quantity to reduce over the blocks, ``("max", (B, H))``, ``("sum",
    (B, H))`` and ``("sum", (B, H, D))``, is sent the reduced value, and
    returns the (B, 1, H, D) output in ``dtype``: p = exp(s - M) / SUM
    rounded to v's dtype, the f32 partial p@V, its sum cast once."""
    b, kh, g, block = s.shape
    d = v.shape[-1]
    local_max = (s.amax(dim=-1) if block else
                 s.new_full((b, kh, g), -math.inf))
    m = yield "max", local_max.reshape(b, kh * g)
    e = torch.exp(s - m.reshape(b, kh, g, 1))
    total = yield "sum", e.sum(dim=-1).reshape(b, kh * g)
    p = (e / total.reshape(b, kh, g, 1)).to(v.dtype)
    part = torch.einsum("bkgs,bskd->bkgd", p.float(), v.float())
    out = yield "sum", part.reshape(b, kh * g, d)
    return out.reshape(b, 1, kh * g, d).to(dtype)


def _reduce_with(steps, all_max, all_sum):
    """Run a block's step generator, reducing each yielded quantity with
    ``all_max`` or ``all_sum`` (None: the block is the whole cache)."""
    kind, val = next(steps)
    while True:
        fn = all_max if kind == "max" else all_sum
        try:
            kind, val = steps.send(val if fn is None else fn(val))
        except StopIteration as done:
            return done.value


def shard_softmax_pv(s: torch.Tensor, v: torch.Tensor, dtype: torch.dtype,
                     all_max=None, all_sum=None) -> torch.Tensor:
    """The slot-shard form's softmax and p@V of one block's masked scores
    s (B, K, G, S_block) f32 and values v (B, S_block, K, D): the max and
    the sum of the softmax and the f32 partial p@V reduced over the blocks
    by ``all_max``/``all_sum``; the (B, 1, H, D) output in ``dtype``."""
    return _reduce_with(_softmax_pv(s, v, dtype), all_max, all_sum)


def _plain_shard_steps(q, k_new, v_new, k_cache, v_cache, cache_len, cos, sin,
                       k_scale, v_scale, *, slot_base, slots, window, is_ring):
    lens = _lens(cache_len, q.shape[0], q.device).long()
    s, v_full = _plain_scores(q, k_new, v_new, k_cache, v_cache, lens, cos,
                              sin, k_scale, v_scale, window=window,
                              is_ring=is_ring, slot_base=slot_base,
                              slots=slots)
    return (yield from _softmax_pv(s, v_full, q.dtype))


def decode_attention_shard_plain(q, k_new, v_new, k_cache, v_cache, cache_len,
                                 cos, sin, k_scale=None, v_scale=None, *,
                                 slot_base: int = 0, slots: int | None = None,
                                 window: int = 0, is_ring: bool = False,
                                 all_max=None, all_sum=None):
    """Plain PyTorch version of the slot-shard form, the same decomposition;
    same signature and return value as :func:`decode_attention_shard`."""
    slots = k_cache.shape[1] if slots is None else slots
    out = _reduce_with(_plain_shard_steps(
        q, k_new, v_new, k_cache, v_cache, cache_len, cos, sin, k_scale,
        v_scale, slot_base=slot_base, slots=slots, window=window,
        is_ring=is_ring), all_max, all_sum)
    return _returned(out, k_cache, v_cache, k_scale, v_scale)


def _batch_stride(caches: dict) -> int:
    """The caches' common batch stride in slot rows, where each is
    contiguous but for its batch stride (a block of a larger cache along
    the slot axis, such as ``cache[:, a:b]``); raises otherwise."""
    strides = set()
    for name, t in caches.items():
        b, slots, kh, d = t.shape
        if t.stride()[1:] != (kh * d, d, 1) or t.stride(0) % (kh * d):
            raise ValueError(f"{name} must be contiguous but for its batch "
                             "stride")
        strides.add(t.stride(0) // (kh * d) if b > 1 else slots)
    if len(strides) != 1 or min(strides) < next(iter(caches.values())
                                                ).shape[1]:
        raise ValueError(f"the caches' batch strides differ: {strides}")
    return strides.pop()


def _check(q, k_new, v_new, k_cache, v_cache, lens, cos, sin, k_scale,
           v_scale, window, shard: bool = False) -> int:
    """Raise on anything the CUDA kernel does not take; returns the caches'
    batch stride in slot rows (a shard's blocks may be views of a larger
    cache along the slot axis, a whole call's caches are contiguous)."""
    quant = k_scale is not None
    tensors = {"q": q, "k_new": k_new, "v_new": v_new, "cache_len": lens,
               "cos": cos, "sin": sin}
    caches = {"k_cache": k_cache, "v_cache": v_cache}
    if quant:
        caches.update(k_scale=k_scale, v_scale=v_scale)
    elif v_scale is not None:
        raise ValueError("v_scale given without k_scale")
    if not shard:
        tensors.update(caches)
    for name, t in {**tensors, **caches}.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, one, h, d = q.shape
    slots, kh = k_cache.shape[1], k_cache.shape[2]
    if one != 1:
        raise ValueError(f"q must be (B, 1, H, D), got {tuple(q.shape)}")
    if (q.dtype, k_cache.dtype) not in _ENTRIES:
        raise TypeError(f"unsupported dtypes q={q.dtype} cache={k_cache.dtype}")
    for name, t, shape in (("k_new", k_new, (b, 1, kh, d)),
                           ("v_new", v_new, (b, 1, kh, d)),
                           ("v_cache", v_cache, (b, slots, kh, d)),
                           ("k_cache", k_cache, (b, slots, kh, d))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise TypeError("k_new/v_new must have q's dtype")
    if v_cache.dtype != k_cache.dtype:
        raise TypeError("k_cache and v_cache dtypes differ")
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or tuple(t.shape) != (b, slots, kh, 1):
                raise ValueError(f"{name} must be f32 {(b, slots, kh, 1)}")
    elif k_cache.dtype == torch.int8:
        raise ValueError("int8 caches need k_scale and v_scale")
    if lens.dtype != torch.int32 or tuple(lens.shape) != (b,):
        raise ValueError("cache_len must be int32 (B,)")
    w = cos.shape[-1]
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, w):
            raise ValueError(f"{name} must be f32 (B, W)")
    if h % kh:
        raise ValueError(f"num_heads ({h}) must divide kv heads ({kh})")
    if not 0 < 2 * w <= d:
        raise ValueError(f"rope width 2*W={2 * w} must be in (0, D={d}]")
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {_MAX_HEAD_DIM}")
    if h // kh > _MAX_G:
        raise ValueError(f"{h // kh} q heads per kv head > {_MAX_G}")
    if window < 0:
        raise ValueError("window must be >= 0")
    return _batch_stride(caches) if shard else slots


@functools.lru_cache(maxsize=None)
def _plan(batch: int, kv_heads: int, g: int, d: int, slots: int,
          act_size: int, cache_size: int, tc: bool, sms: int,
          shard: bool) -> tuple[int, int]:
    """``(chunk, workspace bytes)`` of a call (or a shard's block) of these
    shapes on a card of ``sms`` SMs; raises where a CTA's shared memory
    would exceed a Hopper CTA's.  Shapes only, so cached."""
    nsplit, chunk = split_plan(batch, kv_heads, max(slots, 1), sms)
    fold = not shard and fold_stats(g, slots, nsplit)
    smem = max(smem_bytes(g, d, act_size, cache_size, tc=tc, pv=pv,
                          slots=slots, nsplit=nsplit, fold=fold)
               for pv in (False, True))
    if smem > _MAX_SMEM:
        raise ValueError(f"{smem} B of shared memory per CTA exceed "
                         f"{_MAX_SMEM}")
    return chunk, (workspace_bytes(batch, kv_heads, g, d, slots, chunk)
                   if slots else 0)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(q, k_new, v_new, k_cache, v_cache, lens, cos, sin, k_scale,
            v_scale, window: int, is_ring: bool) -> torch.Tensor:
    b, _, h, d = q.shape
    slots, kh = k_cache.shape[1], k_cache.shape[2]
    _check(q, k_new, v_new, k_cache, v_cache, lens, cos, sin, k_scale,
           v_scale, window)
    # The SM count is cached by torch; reading it does not sync the stream.
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk, nbytes = _plan(b, kh, h // kh, d, slots, q.element_size(),
                          k_cache.element_size(), tensor_cores(q.dtype, d),
                          sms, False)
    out = torch.empty_like(q)
    work = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
    _build.launch("decode_attention", _ENTRIES[(q.dtype, k_cache.dtype)],
                  _ARGTYPES, q.device, _ptr(q), _ptr(k_new), _ptr(v_new),
                  _ptr(k_cache), _ptr(v_cache), _ptr(k_scale), _ptr(v_scale),
                  _ptr(lens), _ptr(cos), _ptr(sin), _ptr(out), _ptr(work),
                  nbytes, b, slots, h, kh, d, cos.shape[-1], int(window),
                  int(bool(is_ring)), chunk, int(_CUDA_CORES),
                  count="decode_attention")
    return out


def fused_decode_attention(q, k_new, v_new, k_cache, v_cache, cache_len, cos,
                           sin, k_scale=None, v_scale=None, *, window: int = 0,
                           is_ring: bool = False):
    """One fused decode-attention step; returns ``(out, caches...)``.

    q (B,1,H,D) and k_new/v_new (B,1,K,D) are pre-rope; caches (B,S,K,D)
    are f32/bf16 or int8 with f32 scales (B,S,K,1); ``cache_len`` holds the
    pre-write lengths, an int or (B,) int32; cos/sin (B,...,W) f32.  Plain
    caches return ``(out, k_cache, v_cache)`` and quantised caches also the
    scales, all updated in place.  CPU tensors run the plain version; CUDA
    tensors launch the kernels (one count).
    """
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_new, v_new, k_cache, v_cache,
                                      cache_len, cos, sin, k_scale, v_scale,
                                      window=window, is_ring=is_ring)
    if q.device.type != "cuda":
        raise ValueError(f"no decode-attention kernel for {q.device}")
    b = q.shape[0]
    w = cos.shape[-1]
    lens = _lens(cache_len, b, q.device)
    cos2 = cos.to(torch.float32).reshape(b, w).contiguous()
    sin2 = sin.to(torch.float32).reshape(b, w).contiguous()
    out = _launch(q, k_new, v_new, k_cache, v_cache, lens, cos2, sin2,
                  k_scale, v_scale, window, is_ring)
    return _returned(out, k_cache, v_cache, k_scale, v_scale)


def _kernel_shard_steps(q, k_new, v_new, k_cache, v_cache, cache_len, cos,
                        sin, k_scale, v_scale, *, slot_base, slots, window,
                        is_ring):
    """The slot-shard form on the card, as a generator like
    :func:`_softmax_pv`: the scores pass and the local max, the local sum
    under the reduced max, the f32 partial p@V under the reduced max and
    sum.  A block that launched its kernels counts one, under
    ``decode_attention_shard``, after its last."""
    b, _, h, d = q.shape
    block, kh = k_cache.shape[1], k_cache.shape[2]
    w = cos.shape[-1]
    lens = _lens(cache_len, b, q.device)
    cos2 = cos.to(torch.float32).reshape(b, w).contiguous()
    sin2 = sin.to(torch.float32).reshape(b, w).contiguous()
    ldb = _check(q, k_new, v_new, k_cache, v_cache, lens, cos2, sin2,
                 k_scale, v_scale, window, shard=True)
    # The SM count is cached by torch; reading it does not sync the stream.
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk, nbytes = _plan(b, kh, h // kh, d, block, q.element_size(),
                          k_cache.element_size(), tensor_cores(q.dtype, d),
                          sms, True)
    if not 0 <= slot_base <= slot_base + block <= slots:
        raise ValueError(f"block of {block} slots from {slot_base} is not "
                         f"inside a cache of {slots}")
    f32 = dict(dtype=torch.float32, device=q.device)
    name = _ENTRIES[(q.dtype, k_cache.dtype)]
    if block:      # the kernels write every element
        local_max, local_sum, part = (torch.empty(shape, **f32) for shape in
                                      ((b, h), (b, h), (b, h, d)))
    else:          # an empty block holds nothing: max -inf, sums 0
        local_max = torch.full((b, h), -math.inf, **f32)
        local_sum, part = torch.zeros((b, h), **f32), torch.zeros((b, h, d),
                                                                  **f32)
    work = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
    cores = int(_CUDA_CORES)

    def launch(symbol, argtypes, *args, count=None):
        if block:
            _build.launch("decode_attention", symbol, argtypes, q.device,
                          *args, count=count)

    launch(name + "_shard_scores", _SCORES_ARGTYPES,
           _ptr(q), _ptr(k_new), _ptr(v_new), _ptr(k_cache), _ptr(v_cache),
           _ptr(k_scale), _ptr(v_scale), _ptr(lens), _ptr(cos2), _ptr(sin2),
           _ptr(local_max), _ptr(work), nbytes, b, block, ldb, slot_base,
           slots, h, kh, d, w, int(window), int(bool(is_ring)), chunk, cores)
    m = (yield "max", local_max).to(torch.float32).contiguous()
    launch("decode_attention_shard_sum", _SUM_ARGTYPES, _ptr(work), nbytes,
           _ptr(m), _ptr(local_sum), _ptr(lens), b, block, slot_base, slots,
           h, kh, d, int(window), chunk)
    total = (yield "sum", local_sum).to(torch.float32).contiguous()
    launch(name + "_shard_pv", _PV_ARGTYPES, _ptr(k_cache), _ptr(v_cache),
           _ptr(v_scale), _ptr(lens), _ptr(part), _ptr(work), nbytes, _ptr(m),
           _ptr(total), b, block, ldb, slot_base, slots, h, kh, d,
           int(window), chunk, cores, count="decode_attention_shard")
    out = yield "sum", part
    return out.reshape(b, 1, h, d).to(q.dtype)


def _shard_steps(q, *args, **kw):
    """The block's step generator: the kernels' for CUDA tensors, the
    plain version's for CPU tensors."""
    if q.device.type == "cpu":
        return _plain_shard_steps(q, *args, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"no decode-attention kernel for {q.device}")
    return _kernel_shard_steps(q, *args, **kw)


def decode_attention_shard(q, k_new, v_new, k_cache, v_cache, cache_len, cos,
                           sin, k_scale=None, v_scale=None, *,
                           slot_base: int = 0, slots: int | None = None,
                           window: int = 0, is_ring: bool = False,
                           all_max=None, all_sum=None):
    """One fused decode-attention step on a block of a cache's slots;
    returns ``(out, caches...)`` like :func:`fused_decode_attention`.

    The caches are one device's (B, S_block, K, D) block (and scales) of a
    cache of ``slots`` slots (default: the block is the whole cache),
    holding global slots ``slot_base ...``; views of a larger cache along
    the slot axis are taken.  The new token is written only by the block
    that holds its slot.  ``all_max`` and ``all_sum`` reduce a tensor over
    the devices holding the cache's other blocks (a collective over the
    model axis); None is the identity, right for a block that is the whole
    cache, which then gives the whole call's values bit for bit.  CPU
    tensors run the plain version; CUDA tensors launch the kernels (one
    count under ``decode_attention_shard``; an empty block launches and
    counts nothing).
    """
    slots = k_cache.shape[1] if slots is None else slots
    out = _reduce_with(_shard_steps(
        q, k_new, v_new, k_cache, v_cache, cache_len, cos, sin, k_scale,
        v_scale, slot_base=slot_base, slots=slots, window=window,
        is_ring=is_ring), all_max, all_sum)
    return _returned(out, k_cache, v_cache, k_scale, v_scale)


def decode_attention_over_shards(q, k_new, v_new, k_cache, v_cache, cache_len,
                                 cos, sin, k_scale=None, v_scale=None, *,
                                 shards: int, window: int = 0,
                                 is_ring: bool = False, plain: bool = False):
    """The slot-shard form over ``shards`` blocks (``slot_blocks``) of one
    device's whole cache, views of it, run side by side and reduced on
    that device with ``torch.stack(...).amax/sum``: the mesh's
    decomposition without a mesh.  ``plain`` runs the plain version on any
    device.  Returns ``(out, caches...)`` like the whole call; each
    non-empty block whose kernels launch counts one under
    ``decode_attention_shard``."""
    slots = k_cache.shape[1]
    steps = []
    for base, size in slot_blocks(slots, shards):
        view = [None if t is None else t[:, base:base + size]
                for t in (k_cache, v_cache, k_scale, v_scale)]
        args = (q, k_new, v_new, view[0], view[1], cache_len, cos, sin,
                view[2], view[3])
        kw = dict(slot_base=base, slots=slots, window=window,
                  is_ring=is_ring)
        steps.append(_plain_shard_steps(*args, **kw) if plain
                     else _shard_steps(*args, **kw))
    vals = [next(st) for st in steps]
    while True:
        kind = vals[0][0]
        stacked = torch.stack([v for _, v in vals])
        red = stacked.amax(dim=0) if kind == "max" else stacked.sum(dim=0)
        try:
            vals = [st.send(red) for st in steps]
        except StopIteration as done:
            out = done.value
            break
    return _returned(out, k_cache, v_cache, k_scale, v_scale)


# --------------------------------------------------------------------------- #
# Absorbed multi-head latent attention over a latent cache
# --------------------------------------------------------------------------- #
#: (DK, DV) the latent kernels are built for: a 512-wide latent and a 64-wide
#: shared rotary key (kanana-2-30b-a3b, DeepSeek-V2/V3).
LATENT_WIDTHS = ((576, 512),)
_LATENT_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_longlong,)
                    + (ctypes.c_int,) * 5 + (ctypes.c_float, ctypes.c_int,
                                             ctypes.c_void_p))


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched) with f32 sums of a's and b's own values: on the
    card a bf16 product summed in f32 without an f32 copy of either."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def latent_decode_attention_plain(q: torch.Tensor, latent: torch.Tensor,
                                  lens: torch.Tensor, dv: int,
                                  scale: float) -> torch.Tensor:
    """One decode step of absorbed latent attention in plain PyTorch.

    q (B, H, DK) holds each head's query over a cached row, in the cache's
    dtype; latent (B, S, DK) the cached rows, whose leading ``dv`` values are
    a position's value; ``lens`` (B,) the live rows, the new one included.
    Scores ``q.row / scale`` and the softmax in f32, the probabilities
    rounded to the cache's dtype, p@V summed in f32 and returned (B, H, dv)
    in the cache's dtype."""
    sc = bmm_f32(q, latent.transpose(1, 2)) / scale
    mask = live_slots(lens, latent.shape[1])
    prob = torch.softmax(torch.where(mask[:, None], sc, NEG_INF), -1)
    return bmm_f32(prob.to(latent.dtype), latent[..., :dv]).to(latent.dtype)


def latent_split_plan(batch: int, groups: int, slots: int,
                      sms: int) -> tuple[int, int]:
    """``(nsplit, chunk)`` of the latent kernels: about one CTA per SM over
    the ``batch * groups`` (row, head group) pairs, in chunks of whole
    ``_TILE``-row tiles.  From shapes alone."""
    if min(batch, groups, slots, sms) < 1:
        raise ValueError(f"no split of batch={batch}, groups={groups}, "
                         f"slots={slots} on {sms} SMs")
    tiles = -(-slots // _TILE)
    want = max(1, sms // (batch * groups))
    chunk = -(-tiles // min(want, tiles)) * _TILE
    return -(-slots // chunk), chunk


def latent_kernel_takes(q: torch.Tensor, latent: torch.Tensor,
                        lens: torch.Tensor, dv: int) -> bool:
    """Whether the latent kernels take the call: CUDA, bf16, contiguous and
    16-byte aligned, widths in ``LATENT_WIDTHS``, heads a multiple of 16."""
    if not (q.is_cuda and latent.device == q.device == lens.device):
        return False
    if q.dtype != torch.bfloat16 or latent.dtype != torch.bfloat16:
        return False
    if q.ndim != 3 or latent.ndim != 3 or lens.dtype != torch.int32:
        return False
    b, h, dk = q.shape
    if (latent.shape[0] != b or latent.shape[2] != dk
            or tuple(lens.shape) != (b,) or (dk, dv) not in LATENT_WIDTHS
            or h % 16):
        return False
    return all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, latent)) and lens.is_contiguous()


def latent_decode_attention(q: torch.Tensor, latent: torch.Tensor,
                            lens: torch.Tensor, dv: int,
                            scale: float) -> torch.Tensor:
    """``latent_decode_attention_plain``'s function: the kernels of
    ``csrc/decode_attention.cu`` where ``latent_kernel_takes`` the call
    (two launches, one count under ``decode_attention_latent``), the plain
    version otherwise.  The kernels take p under a running max, so they
    agree with the plain version to the cache dtype's rounding."""
    if not latent_kernel_takes(q, latent, lens, dv):
        return latent_decode_attention_plain(q, latent, lens, dv, scale)
    b, h, dk = q.shape
    slots = latent.shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    nsplit, chunk = latent_split_plan(b, h // (32 if h % 32 == 0 else 16),
                                      slots, sms)
    rows = b * nsplit * h
    part = -(-rows * dv * 4 // 256) * 256
    nbytes = part + rows * 2 * 4
    out = torch.empty((b, h, dv), dtype=q.dtype, device=q.device)
    work = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
    _build.launch("decode_attention", "decode_attention_latent_bf16",
                  _LATENT_ARGTYPES, q.device, _ptr(q), _ptr(latent),
                  _ptr(lens), _ptr(out), _ptr(work), nbytes, b, slots, h, dk,
                  dv, float(scale), chunk, count="decode_attention_latent")
    return out


__all__ = ["fused_decode_attention", "decode_attention_plain",
           "decode_attention_shard", "decode_attention_shard_plain",
           "decode_attention_over_shards", "shard_softmax_pv", "slot_blocks",
           "live_slots", "pick_chunk", "quantize_kv", "split_plan",
           "tensor_cores", "cuda_core_build", "fold_stats", "smem_bytes",
           "workspace_bytes", "latent_decode_attention",
           "latent_decode_attention_plain", "latent_kernel_takes",
           "latent_split_plan", "LATENT_WIDTHS", "bmm_f32", "NEG_INF"]
