"""The MoE router's expert slots: each routed copy's row in the dispatch
buffer.

ids (G, N) are the chosen experts of each routing group's copies, in the
token-major (token, k) order of ``models.layers.moe_route``.  A copy's rank
is the number of earlier copies in its group with the same expert; it keeps
its slot if the rank is below ``cap`` (``keep``), and ``dst`` is
``id * cap + rank`` then, else ``E * cap``, the dispatch buffer's overflow
row.  Two implementations of the same function live here:

  * the CUDA C++ kernel ``csrc/moe_route.cu`` for ``sm_90a``: one CTA per
    (group, tile of 2048 copies), the ranks inside a warp by
    ``__match_any_sync``, across the warps of a tile by a prefix of
    per-warp counters in shared memory, across tiles from a count pass's
    per-tile totals; one launch when N fits a tile (every decode call), two
    otherwise, on the caller's stream.  Its source note says what bounds it
    and what the design does about that;
  * ``expert_slots_plain``, plain PyTorch: the reference's ``route_group``
    (``repro/models/layers.py``), an int32 one-hot over (copies, experts),
    its cumsum along the copies and a gather.

Every output is an integer, so the two are bit-equal.  ``expert_slots``
takes the plain version for any tensor not on a CUDA device (the CPU, the
dry run's fake tensors); a CUDA call launches the kernel or raises.  Every
call that launches adds one to ``_build.LAUNCHES["moe_route"]``, so a step
counts one per MoE layer.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

#: Copies per CTA of the kernel (``kTile`` in ``csrc/moe_route.cu``): a call
#: of more copies launches the count pass too.
TILE = 2048

_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_int64,
                                      ctypes.c_int, ctypes.c_int64,
                                      ctypes.c_void_p)


def expert_slots_plain(ids: torch.Tensor, num_experts: int,
                       cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(dst, keep) of ids (G, N) by the one-hot and its cumsum."""
    # The one-hot in int32, as the reference's (F.one_hot gives int64).
    oh = (ids[..., None] == torch.arange(num_experts, device=ids.device)
          ).to(torch.int32)
    pos = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh     # rank in expert
    posf = torch.gather(pos, 2, ids[..., None])[..., 0]
    keep = posf < cap
    dst = torch.where(keep, ids * cap + posf, num_experts * cap)
    return dst, keep


@functools.cache
def _max_experts() -> int:
    """The largest E the kernel takes, once its tile is checked against
    ``TILE``."""
    tile = _build.entry("moe_route", "moe_route_tile")()
    if tile != TILE:
        raise RuntimeError(f"moe_route.cu tiles {tile} copies, the wrapper "
                           f"{TILE}")
    return _build.entry("moe_route", "moe_route_max_experts")()


def _launch(ids: torch.Tensor, num_experts: int,
            cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    if ids.dim() != 2 or ids.dtype != torch.int64:
        raise TypeError(f"ids must be (G, N) int64, got {tuple(ids.shape)} "
                        f"{ids.dtype}")
    max_experts = _max_experts()
    if not 1 <= num_experts <= max_experts:
        raise ValueError(f"num_experts {num_experts} outside the kernel's "
                         f"1..{max_experts}")
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    g, n = ids.shape
    if not 1 <= g <= 65535:
        raise ValueError(f"{g} groups: the kernel takes 1..65535")
    ids = ids.contiguous()
    dst = torch.empty_like(ids)
    keep = torch.empty(ids.shape, dtype=torch.bool, device=ids.device)
    tiles = -(-n // TILE)
    totals = (torch.empty((g, tiles - 1, num_experts), dtype=torch.int32,
                          device=ids.device) if tiles > 1 else None)
    _build.launch("moe_route", "moe_route_slots", _ARGTYPES, ids.device,
                  ids.data_ptr(), dst.data_ptr(), keep.data_ptr(),
                  None if totals is None else totals.data_ptr(), g, n,
                  num_experts, cap, count="moe_route")
    return dst, keep


def expert_slots(ids: torch.Tensor, num_experts: int,
                 cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(dst (G, N) int64, keep (G, N) bool) of the copies' experts ids
    (G, N), each group's slots ``cap`` per expert.

    Tensors not on a CUDA device run the plain version; CUDA tensors launch
    the kernel (one count) or raise on what it does not take.
    """
    if ids.device.type != "cuda":
        return expert_slots_plain(ids, num_experts, cap)
    return _launch(ids, num_experts, cap)


__all__ = ["expert_slots", "expert_slots_plain"]
