"""Hand-written CUDA kernels of the port, each beside its plain version.

  decode_attention — the fused decode-attention step (serving);
  prefill_attention — the prompt's causal attention (serving prefills);
  moe_route        — the MoE router's expert slots (every MoE layer);
  moe_experts      — the MoE's expert FFN at decode-sized capacity;
  daxpy            — ``a*x + y``, the paper's offloaded kernel;
  fused_adamw      — the AdamW update (training);
  ops              — any-shape wrappers and the ``KERNELS`` registry;
  ref              — plain PyTorch oracles for daxpy and AdamW.

Nothing is compiled on import: a kernel's shared library is built by
``nvcc`` at its first launch.  ``kernels._build`` is the one way into the
libraries; its ``LAUNCHES`` counts every kernel's calls, keyed by kernel.

The package exports are the reference's (``repro/kernels/__init__.py``).
As there, the exported ``daxpy`` function shadows the ``daxpy`` submodule
as a package attribute: reach the module (its plain version) with
``importlib.import_module("repro_torch.kernels.daxpy")`` or ``from
repro_torch.kernels.daxpy import ...``.
"""

from . import ops, ref
from .ops import (KERNELS, adamw_update, daxpy, decode_attention_spec,
                  fused_decode_attention, get_kernel, kernel_names,
                  pack_hparams, register_kernel)

__all__ = ["ops", "ref", "daxpy", "adamw_update", "pack_hparams",
           "KERNELS", "get_kernel", "register_kernel", "kernel_names",
           "decode_attention_spec", "fused_decode_attention"]
