"""Fused AdamW parameter update: one pass over p, g, m and v.

The port of ``repro/kernels/fused_adamw.py``.  The update, with the math in
f32, p and g in f32 or bf16 and m and v in f32:

    m <- b1*m + (1-b1)*g
    v <- b2*v + (1-b2)*g^2
    p <- p - lr * ( m_hat / (sqrt(v_hat) + eps) + wd * p )

``hp`` is the packed scalar vector ``[lr, b1, b2, eps, wd, 1/(1-b1^t),
1/(1-b2^t), 0]`` (f32, shape (1, 8)) from :func:`pack_hparams`; it stays
on the device, and the kernel reads it through a pointer.

Two implementations of the same function live here:

  * the CUDA C++ kernel ``csrc/fused_adamw.cu`` for ``sm_90a``: a
    grid-stride loop over the flat tensors that updates p, m and v in
    place.  Its source note gives its bound on the card (bytes) and what
    the design does about it;
  * ``adamw_plain``, plain PyTorch that follows the reference's
    ``_adamw_kernel`` operation for operation, including ``1 - b1`` taken
    in f32 from ``hp``.

``fused_adamw`` updates p, m and v in place — the counterpart of the
reference's donated buffers — and takes the plain version only for
tensors that lie on the CPU; CUDA tensors go to the kernel or raise.
Every launch adds one to ``_build.LAUNCHES["fused_adamw"]``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ENTRIES = {torch.float32: "fused_adamw_f32", torch.bfloat16: "fused_adamw_bf16"}
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int64, ctypes.c_void_p)


def pack_hparams(lr, b1: float, b2: float, eps: float, wd: float, step, *,
                 device: str | torch.device) -> torch.Tensor:
    """Fold the bias corrections into the (1, 8) f32 scalar vector on
    ``device``.

    ``lr`` and ``step`` may be tensors on ``device``; nothing is read back.
    """
    dev = torch.device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(())

    step = f32(step)
    c1 = 1.0 / (1.0 - f32(b1) ** step)
    c2 = 1.0 / (1.0 - f32(b2) ** step)
    return torch.stack([f32(lr), f32(b1), f32(b2), f32(eps), f32(wd), c1, c2,
                        f32(0.0)]).reshape(1, 8)


def adamw_plain(p, g, m, v, hp):
    """Plain PyTorch version of the kernel; returns new ``(p, m, v)``."""
    lr, b1, b2, eps, wd, c1, c2 = hp.reshape(8)[:7].unbind()
    g32 = g.float()
    p32 = p.float()
    m_new = b1 * m + (1.0 - b1) * g32
    v_new = b2 * v + (1.0 - b2) * g32 * g32
    m_hat = m_new * c1
    v_hat = v_new * c2
    update = m_hat / (torch.sqrt(v_hat) + eps) + wd * p32
    return (p32 - lr * update).to(p.dtype), m_new, v_new


def _check(p, g, m, v, hp) -> None:
    """Raise on anything the CUDA kernel does not take."""
    tensors = {"p": p, "g": g, "m": m, "v": v, "hp": hp}
    for name, t in tensors.items():
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if p.dtype not in _ENTRIES or g.dtype != p.dtype:
        raise TypeError(f"p and g must be f32 or bf16 of one dtype, got "
                        f"{p.dtype} and {g.dtype}")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError("m and v must be f32")
    if hp.dtype != torch.float32:
        raise TypeError("hp must be f32")


def fused_adamw(p, g, m, v, hp):
    """One AdamW step over p, g, m, v of any one shape, in place.

    ``hp`` comes from :func:`pack_hparams` (bias corrections pre-folded).
    Returns ``(p, m, v)``, the same tensors.  CPU tensors run
    ``adamw_plain`` and copy its result back; CUDA tensors launch the
    kernel.
    """
    if not p.shape == g.shape == m.shape == v.shape:
        raise ValueError(f"p, g, m and v must have equal shapes, got "
                         f"{[tuple(t.shape) for t in (p, g, m, v)]}")
    if tuple(hp.shape) != (1, 8):
        raise ValueError("hp must be (1, 8)")
    if p.device.type == "cpu":
        p_new, m_new, v_new = adamw_plain(p, g, m, v, hp)
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)
        return p, m, v
    if p.device.type != "cuda":
        raise ValueError(f"no fused AdamW kernel for {p.device}")
    _check(p, g, m, v, hp)
    if p.numel() == 0:
        return p, m, v
    _build.launch("fused_adamw", _ENTRIES[p.dtype], _ARGTYPES, p.device,
                  hp.data_ptr(), p.data_ptr(), g.data_ptr(), m.data_ptr(),
                  v.data_ptr(), p.numel(), count="fused_adamw")
    return p, m, v


__all__ = ["fused_adamw", "adamw_plain", "pack_hparams"]
