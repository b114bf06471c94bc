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
    """``"cuda"``/``"cuda:N"``/``"cpu"``/``"meta"`` -> a ``torch.device``.

    ``"meta"`` gives shapes and dtypes without storage (the dry run's
    stand-ins, ``configs.shapes.input_specs``).
    """
    dev = torch.device(device)
    if dev.type in ("cpu", "meta"):
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda', "
                         "'cpu' or 'meta'")
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

