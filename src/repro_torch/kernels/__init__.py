"""Hand-written CUDA kernels of the port, each beside its plain version.

  decode_attention — the fused decode-attention step (serving);
  daxpy            — ``a*x + y``, the paper's offloaded kernel;
  fused_adamw      — the AdamW update (training);
  ops              — any-shape wrappers and the ``KERNELS`` registry.

Nothing is compiled on import: a kernel's shared library is built by
``nvcc`` at its first launch (``kernels._build``).
"""
