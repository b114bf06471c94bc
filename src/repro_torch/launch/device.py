"""Single-device handle: the port's counterpart of ``repro/launch/mesh.py``.

The reference builds a ``(data, model)`` mesh over whatever JAX devices
exist (``make_host_mesh``).  The port runs on one card, so its handle is a
``torch.device``.  A request for ``"cuda"`` on a machine without a usable
card raises instead of running on the CPU: a CPU run is never reported
under a device's name.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``"cuda"``/``"cuda:N"``/``"cpu"`` -> a concrete ``torch.device``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"no CUDA device {dev.index}: "
                           f"{torch.cuda.device_count()} visible")
    return dev

