"""The kernels' public entry points + the kernel registry.

The port of ``repro/kernels/ops.py``.  ``daxpy`` (``kernels.daxpy``) and
``adamw_update`` (``kernels.fused_adamw.fused_adamw``) take tensors of any
shape and raise the reference's ``ValueError``s.  The reference flattens
and zero-pads its operands to whole ``(block_rows, 128)`` VMEM blocks; that
layout is the TPU's, and the CUDA kernels read the flat tensors instead,
so nothing is padded.  CPU tensors run each kernel's plain version, CUDA
tensors the kernel.

The registry (``KERNELS`` / :func:`get_kernel` / :func:`register_kernel`)
maps kernel names to the offload-runtime view of each kernel, the
:class:`repro_torch.core.simulator.KernelSpec` traffic/compute
coefficients of the Manticore cycle model.  Its entries equal the
reference's; the coefficient provenance is documented per entry.
"""

from __future__ import annotations

from repro_torch.core.simulator import DAXPY, KernelSpec

from .daxpy import daxpy
from .decode_attention import fused_decode_attention
from .fused_adamw import fused_adamw as adamw_update
from .fused_adamw import pack_hparams


# --------------------------------------------------------------------------- #
# Kernel registry: name -> simulator-facing KernelSpec.
# --------------------------------------------------------------------------- #

def decode_attention_spec(*, head_dim: int = 64, num_heads: int = 8,
                          kv_heads: int = 2, cache_len: int = 256,
                          dtype_bytes: int = 2, quant: bool = False,
                          name: str = "decode_attention") -> KernelSpec:
    """Offload-runtime view of the fused decode-attention step.

    One *element* is one decode slot (batch row): the fused kernel streams
    that row's K+V cache once, scatter-writes the new token, and moves the
    q/out head vectors — so bytes/elem scales with ``cache_len * kv_heads *
    head_dim`` and cycles/elem with the qk+pv MACs, derived from the same
    shape knobs the model layer uses instead of hand-picked constants.
    Quantized caches carry 1 B/value plus the amortized f32 per-vector
    scale.  Worker cycles assume one fused MAC per cycle; the scalar host
    core has no vector MACs and pays ~2x (same flavor of penalty as the
    fused_adamw entry).
    """
    d, s, kh, h = head_dim, cache_len, kv_heads, num_heads
    kv_bytes = (1.0 + 4.0 / d) if quant else float(dtype_bytes)
    cache_pass = 2 * s * kh * d * kv_bytes      # one pass over K and V
    token_write = 2 * kh * d * kv_bytes         # scatter of the new token
    q_out = 2 * h * d * dtype_bytes             # q in + attn out
    flops = 4 * s * h * d + 10 * s * h          # qk+pv MACs + softmax chain
    return KernelSpec(name=name,
                      bytes_per_elem=int(round(cache_pass + token_write
                                               + q_out)),
                      cycles_per_elem=flops / 2.0,
                      host_cycles_per_elem=float(flops))


KERNELS: dict[str, KernelSpec] = {
    # The paper's kernel: read x,y (16 B) + write y (8 B); 2.6 cy/elem/core.
    "daxpy": DAXPY,
    # Fused AdamW update: read p,g,m,v (32 B) + write p,m,v (24 B); the
    # rsqrt/div chain costs ~9 worker cycles per element and is far worse on
    # the scalar host core.
    "fused_adamw": KernelSpec(name="fused_adamw", bytes_per_elem=56,
                              cycles_per_elem=9.0,
                              host_cycles_per_elem=14.0),
    # Pure streaming copy: read + write 8 B each; one load+store pair per
    # element keeps the worker cores nearly idle.
    "memcpy": KernelSpec(name="memcpy", bytes_per_elem=16,
                         cycles_per_elem=0.75, host_cycles_per_elem=2.0),
    # Dot-product style reduction: read two 8 B operands, accumulate in
    # registers (no streamed writeback).
    "dot": KernelSpec(name="dot", bytes_per_elem=16, cycles_per_elem=1.0,
                      host_cycles_per_elem=2.5),
    # Fused decode-attention step at the reference benchmark's smoke shape —
    # coefficients derived from the attention shape, not hand-picked; see
    # decode_attention_spec.
    "decode_attention": decode_attention_spec(),
}


def get_kernel(name: str) -> KernelSpec:
    """Look up a registered kernel by name."""
    try:
        return KERNELS[name]
    except KeyError:
        raise KeyError(f"unknown kernel {name!r}; registered: "
                       f"{sorted(KERNELS)}") from None


def register_kernel(spec: KernelSpec, *, overwrite: bool = False) -> KernelSpec:
    """Add a kernel to the registry (e.g. from an experiment script)."""
    if spec.name in KERNELS and not overwrite:
        raise ValueError(f"kernel {spec.name!r} already registered "
                         "(pass overwrite=True to replace)")
    KERNELS[spec.name] = spec
    return spec


def kernel_names() -> tuple[str, ...]:
    return tuple(sorted(KERNELS))


__all__ = ["daxpy", "adamw_update", "pack_hparams", "KERNELS", "get_kernel",
           "register_kernel", "kernel_names", "decode_attention_spec",
           "fused_decode_attention"]
