"""AdamW with f32 moments, decoupled weight decay, global-norm clipping.

The port of ``repro/optim/adamw.py``.  Two execution paths for the
parameter update:
  * plain torch (default): ``_update_leaf``, the reference's elementwise
    chain, one eager op at a time;
  * the fused CUDA kernel (``use_kernel=True``, the counterpart of the
    reference's ``use_pallas``): one pass per tensor through
    ``repro_torch.kernels.ops.adamw_update``, for every leaf with
    ``ndim >= 1`` and at least 128 elements; smaller leaves take the plain
    path, as in the reference.

Moments are stored in f32 regardless of param dtype; update math is f32.
The step count, the learning rate and the bias corrections stay on the
device, so a step never waits for the host.  The step count is advanced
in place, as the moments are updated: a train step captured into a CUDA
graph then reads the new count at every replay (a new tensor would leave
the replay reading the count it was captured with).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import ops


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _local(x: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _leaves(tree: Any) -> list[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def init_opt_state(params: Any) -> dict:
    """Zero f32 moments shaped (and, for DTensors, placed) like ``params``,
    and a device step count."""
    def zeros32(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)

    device = _leaves(params)[0].device
    return {
        "m": pytree.tree_map(zeros32, params),
        "v": pytree.tree_map(zeros32, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, on the device."""
    sums = [torch.sum(torch.square(x.float())) for x in _leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    # A tensor numerator keeps one IEEE division (a Python one would be
    # multiplied by the reciprocal).
    scale = torch.clamp(norm.new_full((), max_norm)
                        / torch.clamp(norm, min=1e-12), max=1.0)
    return pytree.tree_map(lambda g: (g.float() * scale).to(g.dtype),
                           grads), norm


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _update_leaf(p, g, m, v, lr, cfg: AdamWConfig, c1, c2):
    """The reference's elementwise update; returns new (p, m, v)."""
    g32 = g.float()
    p32 = p.float()
    m_new = cfg.b1 * m + (1 - cfg.b1) * g32
    v_new = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
    upd = (m_new * c1) / (torch.sqrt(v_new * c2) + cfg.eps) \
        + cfg.weight_decay * p32
    return (p32 - lr * upd).to(p.dtype), m_new, v_new


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig,
                 *, use_kernel: bool = False) -> tuple[Any, dict]:
    """One AdamW step (grads assumed already clipped/averaged).

    Updates the leaves of ``params``, of ``state["m"]``/``state["v"]``
    and the step count ``state["step"]`` in place — the counterpart of the
    reference's ``donate_argnums=(0, 1)`` — and returns them.
    """
    step = state["step"].add_(1)
    lr = cosine_schedule(cfg, step)
    stepf = step.float()
    c1 = 1.0 / (1.0 - cfg.b1 ** stepf)
    c2 = 1.0 / (1.0 - cfg.b2 ** stepf)
    hp = None
    if use_kernel:
        # Filled on the device: a host scalar copied in would sync.
        consts = [lr.new_full((), x) for x in
                  (cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay)]
        hp = torch.stack([lr, *consts, c1, c2,
                          lr.new_zeros(())]).reshape(1, 8)

    p_leaves, spec = pytree.tree_flatten(params)
    trees = [pytree.tree_flatten(t) for t in (grads, state["m"], state["v"])]
    if any(s != spec for _, s in trees):
        raise ValueError("grads and moments must have the params' structure")
    (g_leaves, _), (m_leaves, _), (v_leaves, _) = trees
    for p, g, m, v in zip(p_leaves, g_leaves, m_leaves, v_leaves):
        if use_kernel and p.ndim >= 1 and p.numel() >= 128:
            # On a mesh p, g, m and v share one placement: the kernel
            # updates each device's shards.
            ops.adamw_update(*(_local(x) for x in (p, g, m, v, hp)))
        else:
            p_new, m_new, v_new = _update_leaf(p, g, m, v, lr, cfg, c1, c2)
            p.copy_(p_new)
            m.copy_(m_new)
            v.copy_(v_new)
    return params, {"m": state["m"], "v": state["v"], "step": step}
