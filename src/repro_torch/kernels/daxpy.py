"""DAXPY, ``o = a*x + y`` — the paper's offloaded kernel.

The port of ``repro/kernels/daxpy.py``.  The paper offloads DAXPY to M
accelerator clusters; the TPU kernel streams ``(rows, 128)`` blocks through
VMEM.  Two implementations of the same function live here:

  * the CUDA C++ kernel ``csrc/daxpy.cu`` for ``sm_90a``: one tile per
    block over the flat tensors, each thread with two independent 16-byte
    loads of x and two of y in flight.  Its source note gives its bound on
    the card (bytes) and what the design does about it;
  * ``daxpy_plain``, plain PyTorch: the counterpart of ``kernels/ref.py``'s
    ``daxpy``.  ``a`` is rounded to x's dtype first, then ``a * x + y``
    runs as two eager ops.

``daxpy`` takes the plain version only for tensors that lie on the CPU;
CUDA tensors go to the kernel or raise.  Every launch adds one to
``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: Kernel launches since import (or since a caller last set it to 0).
LAUNCHES = 0

_ENTRIES = {torch.float32: "daxpy_f32", torch.bfloat16: "daxpy_bf16"}
_ARGTYPES = [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_void_p]


def daxpy_plain(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``a*x + y`` for any shape, ``a`` rounded to x's dtype first."""
    return torch.as_tensor(a, dtype=x.dtype, device=x.device) * x + y


def _scalar(a, dtype: torch.dtype) -> float:
    """``a`` rounded to ``dtype`` as the plain version rounds it, as a float.

    A CUDA scalar tensor is read back to the host once.
    """
    return float(torch.as_tensor(a, dtype=dtype))


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if y.device != x.device:
        raise ValueError(f"y is on {y.device}, x on {x.device}")
    if x.dtype not in _ENTRIES or y.dtype != x.dtype:
        raise TypeError(f"daxpy takes f32 or bf16 x and y of one dtype, got "
                        f"{x.dtype} and {y.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("x and y must be contiguous")


def daxpy(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``a*x + y`` for any-shaped x/y of one dtype (f32 or bf16): the
    paper's offloaded kernel.

    CPU tensors run ``daxpy_plain``; CUDA tensors launch the kernel, which
    writes a new tensor.
    """
    global LAUNCHES
    if x.shape != y.shape:
        raise ValueError(f"x and y must have equal shapes, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.device.type == "cpu":
        return daxpy_plain(a, x, y)
    if x.device.type != "cuda":
        raise ValueError(f"no daxpy kernel for {x.device}")
    _check(x, y)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = getattr(_build.library("daxpy"), _ENTRIES[x.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(_scalar(a, x.dtype), x.data_ptr(), y.data_ptr(), out.data_ptr(),
                x.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"daxpy kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


__all__ = ["daxpy", "daxpy_plain"]
