"""PyTorch port of ``repro`` for one NVIDIA H100.

Each subpackage mirrors the ``repro`` subpackage of the same name, module
for module, and keeps its tensor layouts; ``repro`` stays the reference
the port's tests compare against.  The port imports ``torch`` and
``numpy`` only.  The decode-attention step runs in a CUDA C++ kernel for
``sm_90a`` (``repro_torch.kernels``); everything else is plain torch.

Entry points take ``device=`` and default to ``"cuda"``; they raise when
no card is present instead of running on the CPU (the tests pass
``device="cpu"``).
"""
