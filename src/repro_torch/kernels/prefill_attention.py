"""Causal GQA attention over a prompt: the prefill's attention, one call.

q (B, L, H, D) attends over k (B, L, K, D) and v (B, L, K, Dv), causally
and, for local layers, within a sliding ``window``; q head h reads kv head
``h // (H/K)`` (K-major), without repeating the kv heads.  Dv is D but for
multi-head latent attention's decompressed prefill, whose q and k are 192
wide (128 + 64 rotary) and v 128.  Two implementations of the same
function live here:

  * the CUDA C++ kernel ``csrc/prefill_attention.cu`` for ``sm_90a``, one
    launch per call on the caller's stream: one CTA per (batch row, q
    head, 128 query positions), q.K^T and p@V on the tensor cores (bf16
    operands, f32 sums), K and V tiles of 64 keys staged by ``cp.async``,
    the online softmax held in registers, tiles that no row of the CTA can
    see skipped.  No score reaches device memory.  The source note says
    what bounds it and what the design does about that;
  * ``prefill_attention_plain``, plain PyTorch: the reference's
    ``chunked_attention`` (``repro/models/layers.py``), the online softmax
    over chunks of ``kv_chunk`` keys with the reference's
    ``preferred_element_type=float32`` carried out by upcasting both
    operands.  ``models.layers.chunked_attention`` is this function: the
    train step, a mesh's attention and every call the kernel does not take
    run it, and the chip smoke run holds the kernel against it.

Both round where the reference rounds (f32 scores of bf16 products, the
scale, max, sum and correction in f32, p rounded to the value dtype before
p@V, one cast of the output); only the order of the sums and the running
max's tile width differ.

``prefill_attention`` takes the plain version for tensors on the CPU;
CUDA tensors go to the kernel or raise.  ``takes`` says whether the kernel
takes a call (a CUDA tensor, bf16, built widths), which is how
``models.layers.attention_block`` routes a one-device prefill.  Every
launch adds one to ``_build.LAUNCHES["prefill_attention"]``, so a prefill
counts one per attention layer.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build
from .decode_attention import NEG_INF

#: What the kernel is built for: bf16 activations and these head dims,
#: q, k and v of one width ...
HEAD_DIMS = (64, 128, 256)
#: ... or these (q and k width, v width) pairs.
WIDTHS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)


def prefill_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, q_offset: int = 0,
                            window: int = 0,
                            kv_chunk: int = 1024) -> torch.Tensor:
    """Causal GQA attention with online softmax over KV chunks.

    q (B, Sq, H, D), k (B, Skv, K, D), v (B, Skv, K, Dv); returns
    (B, Sq, H, Dv).  Grouped K-major GQA: q head h reads kv head
    ``h // (H/K)`` without materialising repeated KV.
    """
    b, sq, h, d = q.shape
    skv, kh, dv = k.shape[1], k.shape[2], v.shape[-1]
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

    acc = torch.zeros((b, sq, h, dv), dtype=torch.float32, device=dev)
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
        acc = acc * corr.transpose(1, 2)[..., None] + pv.reshape(b, sq, h, dv)
        m = m_new
    out = acc / torch.clamp_min(lse, 1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernel takes this call: CUDA tensors in bf16 with built
    widths.  From dtypes and shapes only."""
    return (_on_card(q) and q.dtype == k.dtype == v.dtype == torch.bfloat16
            and k.shape[-1] == q.shape[-1]
            and (q.shape[-1], v.shape[-1]) in WIDTHS)


def _check(q, k, v, window: int) -> None:
    """Raise on anything the kernel does not take."""
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"no prefill-attention kernel for {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            k.shape[:-1] != v.shape[:-1]:
        raise ValueError("q must be (B, L, H, D), k (B, L, K, D) and v "
                         f"(B, L, K, Dv), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, length, h, d = q.shape
    kh, dv = k.shape[2], v.shape[-1]
    if tuple(k.shape) != (b, length, kh, d):
        raise ValueError(f"k must be {(b, length, kh, d)}, got "
                         f"{tuple(k.shape)}")
    if (d, dv) not in WIDTHS:
        raise ValueError(f"widths (q/k {d}, v {dv}) not among the kernel's "
                         f"{WIDTHS}")
    if kh < 1 or h % kh:
        raise ValueError(f"kv heads ({kh}) must divide num_heads ({h})")
    if min(b, length) < 1:
        raise ValueError(f"empty call: B={b}, L={length}")
    if window < 0:
        raise ValueError("window must be >= 0")


def _launch(q, k, v, window: int) -> torch.Tensor:
    _check(q, k, v, window)
    q, k, v = (t.contiguous() for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")
    b, length, h, d = q.shape
    dv = v.shape[-1]
    out = q.new_empty((b, length, h, dv))
    _build.launch("prefill_attention", "prefill_attention_bf16", _ARGTYPES,
                  q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), b, length, h, k.shape[2], d, dv,
                  int(window), count="prefill_attention")
    return out


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int = 0) -> torch.Tensor:
    """Causal GQA attention of a prompt from position 0; returns the
    (B, L, H, Dv) output in q's dtype.

    q (B, L, H, D), k (B, L, K, D) and v (B, L, K, Dv), already roped
    (``WIDTHS`` lists the (D, Dv) the kernel takes); ``window`` 0 (none)
    or the sliding window of local layers.  CPU tensors run the plain
    version; CUDA tensors launch the kernel (one count) or raise on what it
    does not take.
    """
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k, v, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no prefill-attention kernel for {q.device}")
    return _launch(q, k, v, window)


__all__ = ["prefill_attention", "prefill_attention_plain", "takes",
           "HEAD_DIMS", "WIDTHS"]
