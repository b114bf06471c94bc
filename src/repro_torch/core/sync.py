"""Accelerator -> host completion synchronization (paper §II credit counter).

The port of ``repro/core/sync.py`` for one card.  Manticore's baseline
host busy-polls each cluster's done flag — O(M) host interactions; the
paper's credit counter fires one interrupt when every cluster has
incremented it — O(1).

  * ``PollingSync`` (baseline): the host synchronises once per output.
  * ``CreditCounterSync``: the step emits an extra *credits* output, an
    int32 device scalar equal to the number of devices (one here) iff every
    floating-point output is finite.  The host blocks on that 4-byte scalar
    alone — the interrupt — and a short count is a poisoned output.
"""

from __future__ import annotations

import time
from typing import Any

import torch
from torch.utils import _pytree as pytree


class FaultDetected(RuntimeError):
    """Credits below threshold: the device produced non-finite outputs."""


def credit_threshold() -> int:
    """Credits a healthy step emits: one per device, and the port has one."""
    return 1


def emit_credits(outputs: Any) -> torch.Tensor:
    """An int32 device scalar: the threshold iff all float outputs are finite.

    Computed on the outputs' device without a host sync; the host reads it
    in :meth:`CreditCounterSync.wait`.
    """
    leaves = [x for x in pytree.tree_leaves(outputs)
              if isinstance(x, torch.Tensor)]
    if not leaves:
        raise ValueError("emit_credits needs at least one tensor output")
    ok = torch.ones((), dtype=torch.bool, device=leaves[0].device)
    for leaf in leaves:
        if leaf.is_floating_point():
            ok &= torch.isfinite(leaf).all()
    return ok.to(torch.int32) * credit_threshold()


class CreditCounterSync:
    """Host side of the credit counter: one blocking read of one scalar."""

    name = "credit_counter"

    def __init__(self):
        self.threshold = credit_threshold()

    def wait(self, credits: torch.Tensor) -> int:
        got = int(credits.item())  # single 4-byte device->host readback
        if got != self.threshold:
            raise FaultDetected(
                f"credit counter read {got}, expected {self.threshold}: "
                "a device produced non-finite outputs")
        return got

    def timed_wait(self, credits: torch.Tensor) -> tuple[int, float]:
        """wait() plus the measured host-side blocking time in seconds."""
        t0 = time.perf_counter()
        got = self.wait(credits)
        return got, time.perf_counter() - t0

    def host_interactions(self) -> int:
        return 1


class PollingSync:
    """Baseline: synchronise once per output tensor (O(outputs) host work)."""

    name = "polling"

    def wait(self, outputs: Any) -> int:
        polls = 0
        for leaf in pytree.tree_leaves(outputs):
            if not isinstance(leaf, torch.Tensor):
                continue
            if leaf.device.type == "cuda":
                torch.cuda.current_stream(leaf.device).synchronize()
            polls += 1
        return polls

    def host_interactions(self) -> int:
        return 1

