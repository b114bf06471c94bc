"""The MoE's expert FFN over the dispatch buffer: the gated FFN of every
expert's capacity slots.

buf (G, E, C, D) holds each routing group's copies in their experts' slots
(zeros where no copy landed); w_gate, w_in (E, D, F) and w_out (E, F, D) are
the experts' weights; dst and keep (G, Tg*K) are the router's slots
(``kernels.moe_route``).  The result y_e (G, E, C, D) is
``act(buf @ w_gate) * (buf @ w_in) @ w_out`` per expert, rounded as the
plain einsums round.  Two implementations of the same function live here:

  * the CUDA C++ kernel ``csrc/moe_experts.cu`` for ``sm_90a``: a gate/in
    pass and an out pass, each a CTA per (group, expert, 64 weight
    columns), which reads dst and keep on the device and loads an expert's
    weights only where a kept copy chose that expert; TMA rings and
    ``mma.sync`` with the <= 16 token rows on the N side.  Its source note
    says what bounds it and what the design does about that;
  * ``expert_ffn_plain``, plain PyTorch: the einsum, activation, multiply,
    einsum chain over every expert (the reference's ``moe_block``,
    ``repro/models/layers.py``).

``expert_ffn`` takes the plain version for any tensor not on a CUDA device;
a CUDA call launches the kernel or raises on what it does not take.
``takes`` says, from devices, dtypes, shapes and autograd alone, whether a
call is the kernel's: ``models.layers.moe_block`` asks it before calling
(decode-sized capacity, bf16, SiLU, no gradient wanted).  Every call that
launches adds one to ``_build.LAUNCHES["moe_experts"]``, so a decode step
counts one per MoE layer.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

#: The activations the expert FFN and the dense MLP take, by config name.
ACTS = {"silu": F.silu,
        "gelu": lambda t: F.gelu(t, approximate="tanh")}

#: The most slots an expert (C) the kernel takes: two n8 tiles of rows.
MAX_ROWS = 16
#: D and F must be multiples of the kernel's 64-column boxes.
COLUMNS = 64

_ARGTYPES = ((ctypes.c_void_p, ctypes.c_int64) + (ctypes.c_void_p,) * 7
             + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))


def expert_ffn_plain(buf: torch.Tensor, w_gate: torch.Tensor,
                     w_in: torch.Tensor, w_out: torch.Tensor,
                     act: str) -> torch.Tensor:
    """y_e (G, E, C, D) of buf (G, E, C, D) by the dense einsums."""
    h = ACTS[act](torch.einsum("gecd,edf->gecf", buf, w_gate)) \
        * torch.einsum("gecd,edf->gecf", buf, w_in)
    return torch.einsum("gecf,efd->gecd", h, w_out)


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def takes(buf: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor,
          w_out: torch.Tensor, act: str) -> bool:
    """Whether the kernel takes this call: CUDA tensors in bf16, SiLU, at
    most ``MAX_ROWS`` slots an expert, D and F multiples of ``COLUMNS``,
    and no operand that autograd would record."""
    ts = (buf, w_gate, w_in, w_out)
    return (_on_card(buf) and act == "silu"
            and all(t.dtype == torch.bfloat16 for t in ts)
            and buf.dim() == 4 and buf.shape[2] <= MAX_ROWS
            and buf.shape[3] % COLUMNS == 0
            and w_gate.shape[-1] % COLUMNS == 0
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in ts)))


@functools.cache
def _max_rows() -> int:
    """The kernel's own row limit, checked once against ``MAX_ROWS``."""
    rows = _build.entry("moe_experts", "moe_experts_max_rows")()
    if rows != MAX_ROWS:
        raise RuntimeError(f"moe_experts.cu takes {rows} rows, the wrapper "
                           f"{MAX_ROWS}")
    return rows


def _check(buf, w_gate, w_in, w_out, dst, keep, act: str) -> None:
    """Raise on anything the kernel does not take."""
    if act != "silu":
        raise ValueError(f"no expert-FFN kernel for act {act!r}")
    for name, t in (("buf", buf), ("w_gate", w_gate), ("w_in", w_in),
                    ("w_out", w_out)):
        if t.device != buf.device:
            raise ValueError(f"{name} is on {t.device}, buf on {buf.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} is {t.dtype}: the kernel takes bf16")
    if buf.dim() != 4:
        raise ValueError(f"buf must be (G, E, C, D), got {tuple(buf.shape)}")
    g, e, c, d = buf.shape
    f = w_gate.shape[-1]
    if not 1 <= c <= _max_rows():
        raise ValueError(f"{c} slots an expert: the kernel takes 1.."
                         f"{MAX_ROWS}")
    if d % COLUMNS or f % COLUMNS:
        raise ValueError(f"D ({d}) and F ({f}) must be multiples of "
                         f"{COLUMNS}")
    if not (1 <= g <= 65535 and 1 <= e <= 65535):
        raise ValueError(f"G={g}, E={e}: the kernel takes 1..65535 of each")
    for name, t, shape in (("w_gate", w_gate, (e, d, f)),
                           ("w_in", w_in, (e, d, f)),
                           ("w_out", w_out, (e, f, d))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if buf[0].stride() != (c * d, d, 1) or (g > 1 and buf.stride(0) % 8):
        raise ValueError(f"buf's rows must be contiguous within a group "
                         f"(strides {buf.stride()})")
    if dst.shape != keep.shape or dst.dim() != 2 or dst.shape[0] != g \
            or dst.shape[1] < 1:
        raise ValueError(f"dst and keep must be (G={g}, N), got "
                         f"{tuple(dst.shape)} and {tuple(keep.shape)}")
    if dst.dtype != torch.int64 or keep.dtype != torch.bool:
        raise TypeError(f"dst must be int64 and keep bool, got {dst.dtype} "
                        f"and {keep.dtype}")
    if not (dst.is_contiguous() and keep.is_contiguous()):
        raise ValueError("dst and keep must be contiguous")
    if any(t.data_ptr() % 16 for t in (buf, w_gate, w_in, w_out)):
        raise ValueError("buf and the weights must start on a 16-byte "
                         "boundary")


def _launch(buf, w_gate, w_in, w_out, dst, keep, act: str) -> torch.Tensor:
    _check(buf, w_gate, w_in, w_out, dst, keep, act)
    g, e, c, d = buf.shape
    f = w_gate.shape[-1]
    h = torch.empty((g, e, c, f), dtype=buf.dtype, device=buf.device)
    y = torch.empty((g, e, c, d), dtype=buf.dtype, device=buf.device)
    _build.launch("moe_experts", "moe_experts_ffn", _ARGTYPES, buf.device,
                  buf.data_ptr(), buf.stride(0) if g > 1 else e * c * d,
                  w_gate.data_ptr(), w_in.data_ptr(), w_out.data_ptr(),
                  dst.data_ptr(), keep.data_ptr(), h.data_ptr(),
                  y.data_ptr(), g, e, c, d, f, dst.shape[1],
                  count="moe_experts")
    return y


def expert_ffn(buf: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor,
               w_out: torch.Tensor, dst: torch.Tensor, keep: torch.Tensor,
               act: str) -> torch.Tensor:
    """y_e (G, E, C, D): the gated FFN ``act`` of every expert's slots in
    buf (G, E, C, D), with the router's dst and keep (G, N).

    Tensors not on a CUDA device run the plain version (every expert);
    CUDA tensors launch the kernel (one count), which skips the experts no
    kept copy chose, or raise on what it does not take.
    """
    if buf.device.type != "cuda":
        return expert_ffn_plain(buf, w_gate, w_in, w_out, act)
    return _launch(buf, w_gate, w_in, w_out, dst, keep, act)


__all__ = ["ACTS", "MAX_ROWS", "expert_ffn", "expert_ffn_plain", "takes"]
