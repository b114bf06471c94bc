"""Hand-written CUDA kernels of the port, each beside its plain version.

Nothing is compiled on import: a kernel's shared library is built by
``nvcc`` at its first launch (``kernels._build``).
"""
