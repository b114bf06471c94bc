"""Carry reference (JAX) parameter, cache and optimizer-state trees across
to the port.

The caller passes the reference tree through ``np.asarray`` leaf by leaf
(``jax.tree.map(np.asarray, tree)``); this module turns each numpy leaf
into a tensor on ``device`` and keeps the nesting of dicts, tuples and
lists, so the ``"groups"`` leaves keep their leading ``full_groups`` axis.
Nothing here knows a block kind: MoE blocks (``"moe"``: an f32
``w_router`` beside ``(E, d, f)`` experts), mamba blocks (``"mamba"``:
f32 ``a_log``, ``dt_bias``, ``d_skip`` and ``w_norm`` beside the model-dtype
projections), the hybrid's ``"shared"`` block and the empty dicts of its
``shared_attn`` positions, and SSM caches (f32 ``ssm``, model-dtype
``conv``) cross like any other tree, each leaf in its own dtype.

bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` rejects.  They are detected by dtype name (no import
of ``ml_dtypes``) and reinterpreted bit for bit: uint16 view -> int16 ->
``view(torch.bfloat16)``.  Arrays that come from JAX are read-only, so
every leaf is copied before ``torch.from_numpy`` shares its memory.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.device import resolve_device


def _leaf(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = a.view(np.uint16).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _convert(tree, device: torch.device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_convert(v, device) for v in tree)
    return _leaf(tree, device)


def params_from_numpy(tree, device: str | torch.device = "cuda"):
    """A reference parameter tree of numpy leaves -> the port's tree."""
    return _convert(tree, resolve_device(device))


def caches_from_numpy(tree, device: str | torch.device = "cuda"):
    """A reference cache tree of numpy leaves -> the port's cache tree."""
    return _convert(tree, resolve_device(device))


def opt_state_from_numpy(state, device: str | torch.device = "cuda"):
    """A reference optimizer state ``{"m", "v", "step"}`` of numpy leaves ->
    the port's: f32 moment trees and a 0-dim int32 step tensor."""
    dev = resolve_device(device)
    return {"m": _convert(state["m"], dev), "v": _convert(state["v"], dev),
            "step": torch.as_tensor(np.array(state["step"]),
                                    dtype=torch.int32, device=dev).reshape(())}
