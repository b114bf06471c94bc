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
    launches per call on the caller's stream.  Kernel A, on a
    (B, K, NSPLIT) grid, ropes q, writes the new token (in the one CTA
    whose chunk of slots holds it) and scores its chunk of slots into an
    f32 scratch; kernel B, one CTA per q head, takes the softmax over the
    whole score row and p@V.  NSPLIT comes from the shapes alone
    (``split_plan``), so nothing is read back from the card.  At the
    serving shape the step is bound by latency and by how many SMs it
    keeps busy, not by bytes; the source note says what the split does
    about it;
  * ``decode_attention_plain``, plain PyTorch that follows the reference's
    ``_decode_kernel`` step for step.  The CPU tests hold it against the
    reference, and the chip smoke run holds the kernels against it.

``fused_decode_attention`` takes the plain version only for tensors that
lie on the CPU; CUDA tensors go to the kernels or raise.  Every call that
launches them adds one to ``LAUNCHES`` (one call, two launches), so a
serving run counts one per attention layer and decode step.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build

#: Matches ``models.layers.NEG_INF`` — the mask fill of the unfused path.
NEG_INF = -0.7 * float(np.finfo(np.float32).max)

#: Kernel launches since import (or since a caller last set it to 0).
LAUNCHES = 0

_ENTRIES = {
    (torch.float32, torch.float32): "decode_attention_f32",
    (torch.bfloat16, torch.bfloat16): "decode_attention_bf16",
    (torch.float32, torch.int8): "decode_attention_q8_f32",
    (torch.bfloat16, torch.int8): "decode_attention_q8_bf16",
}
_MAX_HEAD_DIM = 256          # kMaxHeadDim in the kernels
_MAX_SMEM = 227 * 1024       # shared memory one Hopper CTA may use
_STAGE = 32                  # K rows kernel A stages at a time (kStage)
_MIN_CHUNK = 8               # about the fewest slots worth a CTA of kernel A
_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def split_plan(batch: int, kv_heads: int, slots: int,
               sms: int) -> tuple[int, int]:
    """``(nsplit, chunk)``: how kernel A cuts the slot axis on a card of
    ``sms`` SMs.

    From shapes alone, never from the row lengths (reading them would sync
    the stream): about one CTA per SM over the ``batch * kv_heads`` groups,
    but no more than ``ceil(slots / _MIN_CHUNK)`` chunks.  ``chunk =
    ceil(slots / nsplit)``, as the kernel derives it from its grid, and no
    chunk is empty.
    """
    if min(batch, kv_heads, slots, sms) < 1:
        raise ValueError(f"no split of batch={batch}, kv_heads={kv_heads}, "
                         f"slots={slots} on {sms} SMs")
    want = min(-(-slots // _MIN_CHUNK), max(1, sms // (batch * kv_heads)))
    chunk = -(-slots // want)
    return -(-slots // chunk), chunk


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


def decode_attention_plain(q, k_new, v_new, k_cache, v_cache, cache_len, cos,
                           sin, k_scale=None, v_scale=None, *, window: int = 0,
                           is_ring: bool = False):
    """Plain PyTorch version of the kernel, step for step; same signature
    and return value as :func:`fused_decode_attention`."""
    b, _, h, d = q.shape
    slots, kh = k_cache.shape[1], k_new.shape[2]
    g = h // kh
    quant = k_scale is not None
    lens = _lens(cache_len, b, q.device).long()
    write = lens % slots if is_ring else lens
    w = cos.shape[-1]
    cos2 = cos.float().reshape(b, w)
    sin2 = sin.float().reshape(b, w)
    qr = _rope(q, cos2, sin2)                       # (B, 1, H, D)
    kr = _rope(k_new, cos2, sin2)                   # (B, 1, K, D)
    rows = torch.arange(b, device=q.device)
    if quant:
        kq, ksc = quantize_kv(kr)
        vq, vsc = quantize_kv(v_new)
        k_cache[rows, write] = kq[:, 0]
        v_cache[rows, write] = vq[:, 0]
        k_scale[rows, write] = ksc[:, 0]
        v_scale[rows, write] = vsc[:, 0]
        k_full = (k_cache.float() * k_scale).to(q.dtype)
        v_full = (v_cache.float() * v_scale).to(q.dtype)
    else:
        k_cache[rows, write] = kr[:, 0].to(k_cache.dtype)
        v_cache[rows, write] = v_new[:, 0].to(v_cache.dtype)
        k_full, v_full = k_cache, v_cache
    qg = qr.reshape(b, kh, g, d)                    # K-major head groups
    s = _true_div(torch.einsum("bkgd,bskd->bkgs", qg.float(), k_full.float()),
                  math.sqrt(d))
    pos = torch.arange(slots, device=q.device)
    mask = pos[None, :] < (lens + 1)[:, None]
    if window:
        mask &= pos[None, :] > (lens - window)[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)                    # one full-length softmax
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_full.dtype).float(),
                       v_full.float())
    out = out.reshape(b, 1, h, d).to(q.dtype)
    if quant:
        return out, k_cache, v_cache, k_scale, v_scale
    return out, k_cache, v_cache


def _check(q, k_new, v_new, k_cache, v_cache, lens, cos, sin, k_scale,
           v_scale, window) -> None:
    """Raise on anything the CUDA kernel does not take."""
    quant = k_scale is not None
    tensors = {"q": q, "k_new": k_new, "v_new": v_new, "k_cache": k_cache,
               "v_cache": v_cache, "cache_len": lens, "cos": cos, "sin": sin}
    if quant:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    elif v_scale is not None:
        raise ValueError("v_scale given without k_scale")
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
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
    if (h // kh + _STAGE) * (d + 1) * 4 > _MAX_SMEM:
        raise ValueError(f"(G + {_STAGE}) * (D + 1) = "
                         f"{(h // kh + _STAGE) * (d + 1)} floats exceed "
                         "shared memory")
    if window < 0:
        raise ValueError("window must be >= 0")


def _launch(q, k_new, v_new, k_cache, v_cache, lens, cos, sin, k_scale,
            v_scale, window: int, is_ring: bool) -> torch.Tensor:
    global LAUNCHES
    _check(q, k_new, v_new, k_cache, v_cache, lens, cos, sin, k_scale,
           v_scale, window)
    b, _, h, d = q.shape
    slots, kh = k_cache.shape[1], k_cache.shape[2]
    lib = _build.library("decode_attention")
    fn = getattr(lib, _ENTRIES[(q.dtype, k_cache.dtype)])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty_like(q)
    scratch = torch.empty((b, kh, h // kh, slots), dtype=torch.float32,
                          device=q.device)
    # The SM count is cached by torch; reading it does not sync the stream.
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    nsplit, _ = split_plan(b, kh, slots, sms)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(ptr(q), ptr(k_new), ptr(v_new), ptr(k_cache), ptr(v_cache),
                ptr(k_scale), ptr(v_scale), ptr(lens), ptr(cos), ptr(sin),
                ptr(out), ptr(scratch), b, slots, h, kh, d, cos.shape[-1],
                int(window), int(bool(is_ring)), nsplit, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 1
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
    tensors launch the two kernels (one count in ``LAUNCHES``).
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
    if k_scale is not None:
        return out, k_cache, v_cache, k_scale, v_scale
    return out, k_cache, v_cache


__all__ = ["fused_decode_attention", "decode_attention_plain", "pick_chunk",
           "quantize_kv", "split_plan", "NEG_INF"]
