"""Accelerator -> host completion synchronization (paper §II credit counter).

The port of ``repro/core/sync.py``.  Manticore's baseline
host busy-polls each cluster's done flag — O(M) host interactions; the
paper's credit counter fires one interrupt when every cluster has
incremented it — O(1).

  * ``PollingSync`` (baseline): the host synchronises once per output.
  * ``CreditCounterSync``: the step emits an extra *credits* output, an
    int32 device scalar equal to the number of devices iff every
    floating-point output is finite.  On a ``DeviceMesh`` each device
    checks its own shards and contributes one credit, and one all-reduce
    sums them (the distributed form of the paper's counter); without a
    mesh there is one device.  The host blocks on that 4-byte scalar
    alone — the interrupt — and a short count is a poisoned shard.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree


class FaultDetected(RuntimeError):
    """Credits below threshold: the device produced non-finite outputs."""


def credit_threshold(mesh=None) -> int:
    """Credits a healthy step emits: one per device of ``mesh`` (1 without)."""
    return 1 if mesh is None else int(mesh.size())


def _local(leaf: torch.Tensor) -> torch.Tensor:
    """This device's values of ``leaf`` (a partial sum is reduced first)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(leaf, DTensor):
        return leaf
    if any(p.is_partial() for p in leaf.placements):
        leaf = leaf.redistribute(leaf.device_mesh, [
            Replicate() if p.is_partial() else p for p in leaf.placements])
    return leaf.to_local()


def emit_credits(outputs: Any, mesh=None) -> torch.Tensor:
    """An int32 device scalar: the threshold iff all float outputs are finite.

    Computed on the outputs' device without a host sync; the host reads it
    in :meth:`CreditCounterSync.wait`.  With a ``mesh`` each device checks
    its local shards, and the credits are summed over the mesh.
    """
    leaves = [x for x in pytree.tree_leaves(outputs)
              if isinstance(x, torch.Tensor)]
    if not leaves:
        raise ValueError("emit_credits needs at least one tensor output")
    if mesh is not None:
        leaves = [_local(x) for x in leaves]
    ok = torch.ones((), dtype=torch.bool, device=leaves[0].device)
    for leaf in leaves:
        if leaf.is_floating_point():
            ok &= torch.isfinite(leaf).all()
    if mesh is None:
        return ok.to(torch.int32)
    from torch.distributed.tensor import DTensor, Shard
    one = DTensor.from_local(ok.to(torch.int32).reshape(1), mesh,
                             [Shard(0)] * mesh.ndim, run_check=False)
    return one.sum().full_tensor()   # the all-reduce: a replicated scalar


def attach_credits(step_fn: Callable, mesh=None) -> Callable:
    """Wrap a step function so it also returns the credit scalar."""

    def wrapped(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        return out, emit_credits(out, mesh)

    return wrapped


class CreditCounterSync:
    """Host side of the credit counter: one blocking read of one scalar."""

    name = "credit_counter"

    def __init__(self, mesh=None):
        self.threshold = credit_threshold(mesh)

    def wait(self, credits: torch.Tensor) -> int:
        got = int(credits.item())  # single 4-byte device->host readback
        if got != self.threshold:
            raise FaultDetected(
                f"credit counter read {got}, expected {self.threshold}: "
                "a device produced non-finite outputs")
        return got

    def timed_wait(self, credits: torch.Tensor,
                   ready: torch.cuda.Event | None = None) -> tuple[int, float]:
        """wait() plus the measured host-side blocking time in seconds.

        ``ready``, an event recorded after ``credits`` was copied to the
        host, is waited on first, inside the timer: the read then waits
        for its own step alone, not for whatever was queued behind it.
        """
        t0 = time.perf_counter()
        if ready is not None:
            ready.synchronize()
        got = self.wait(credits)
        return got, time.perf_counter() - t0

    def host_interactions(self) -> int:
        return 1


class PollingSync:
    """Baseline: synchronise once per output tensor (O(outputs) host work).

    ``mesh`` is the ``DeviceMesh`` the outputs live on: the reference polls
    every device's shard, so its host interactions are the mesh's device
    count (1 without a mesh).
    """

    name = "polling"

    def __init__(self, mesh=None):
        self.mesh = mesh

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
        return credit_threshold(self.mesh)


SYNCS = {"credit_counter": CreditCounterSync, "polling": PollingSync}
