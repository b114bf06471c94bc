"""Plain PyTorch oracles for the kernels (the correctness reference).

The port of ``repro/kernels/ref.py``: the same formulas, written with
torch ops, on whatever device the tensors lie.
"""

from __future__ import annotations

import torch


def daxpy(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y <- a*x + y, any shape/dtype."""
    return torch.as_tensor(a, dtype=x.dtype, device=x.device) * x + y


def adamw(p, g, m, v, *, lr, b1, b2, eps, wd, step):
    """Reference AdamW update with bias correction; returns (p, m, v).

    m/v are f32; p/g may be lower precision (update math in f32).
    """
    step = torch.as_tensor(step, dtype=torch.float32, device=p.device)
    g32 = g.to(torch.float32)
    p32 = p.to(torch.float32)
    m_new = b1 * m + (1.0 - b1) * g32
    v_new = b2 * v + (1.0 - b2) * g32 * g32

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=p.device)
    c1 = 1.0 / (1.0 - f32(b1) ** step)
    c2 = 1.0 / (1.0 - f32(b2) ** step)
    update = (m_new * c1) / (torch.sqrt(v_new * c2) + eps) + wd * p32
    p_new = (p32 - lr * update).to(p.dtype)
    return p_new, m_new, v_new
