"""Host -> device job dispatch (the paper's §II, in PyTorch terms).

The port of ``repro/core/dispatch.py`` for one card.  On Manticore the
baseline offload writes the job descriptor and arguments to each cluster
*sequentially*; the paper's extension multicasts them in one transaction.
Here:

  * ``SequentialDispatcher`` (baseline): one host->device copy per leaf of
    the operand tree, each waited for in turn.
  * ``MulticastDispatcher`` (the paper's extension): the whole tree is
    packed into one pinned host buffer and moved with ONE ``non_blocking``
    copy on a copy stream of its own; ``timed_put`` then blocks on that
    copy alone (an event recorded after it), as the reference blocks on
    the placed arrays alone, so work already queued on the compute stream
    neither delays the copy nor enters its seconds.

Both return the same tensors; only the number of host transactions
differs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

_ALIGN = 16  # byte alignment of each leaf inside the packed buffer


@dataclass
class DispatchStats:
    """Measured cost of one dispatch (the 'offload overhead' being modeled)."""

    seconds: float
    num_host_calls: int
    bytes_moved: int
    t0: float = 0.0        # time.perf_counter() at the dispatch's start


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dt)).dtype


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class MulticastDispatcher:
    """One host transaction per tree: pack, one copy, one sync."""

    name = "multicast"

    def __init__(self):
        self._streams: dict[torch.device, torch.cuda.Stream] = {}
        #: The event recorded after the last ``put``'s copy (CUDA only).
        self.last_copy: torch.cuda.Event | None = None

    def _copy_stream(self, device: torch.device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def put(self, tree: Any, device: torch.device) -> Any:
        leaves, spec = pytree.tree_flatten(tree)
        arrays = [np.ascontiguousarray(x) for x in leaves]
        offsets, total = [], 0
        for a in arrays:
            offsets.append(total)
            total += -(-a.nbytes // _ALIGN) * _ALIGN
        host = torch.empty(max(total, 1), dtype=torch.uint8,
                           pin_memory=device.type == "cuda")
        view = host.numpy()
        for a, off in zip(arrays, offsets):
            view[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        if device.type == "cuda":
            # The caller's stream may still hold queued work; the copy does
            # not wait for it.  Work queued on that stream from here on
            # waits for the copy on the card (no host sync), and
            # record_stream keeps the allocator from reusing the block
            # while that work reads it.  The pinned source comes from
            # PyTorch's caching host allocator, which hands it out again
            # only once this copy has completed.
            compute = torch.cuda.current_stream(device)
            with torch.cuda.stream(self._copy_stream(device)):
                dev = host.to(device, non_blocking=True)
                self.last_copy = torch.cuda.Event()
                self.last_copy.record()
            compute.wait_event(self.last_copy)
            dev.record_stream(compute)
        else:
            dev = host.to(device)
        out = [dev[off:off + a.nbytes].view(_torch_dtype(a.dtype))
               .reshape(a.shape) for a, off in zip(arrays, offsets)]
        return pytree.tree_unflatten(out, spec)

    def timed_put(self, tree: Any,
                  device: torch.device) -> tuple[Any, DispatchStats]:
        """``put`` and block until its copy has landed (the copy alone)."""
        t0 = time.perf_counter()
        out = self.put(tree, device)
        if device.type == "cuda":
            self.last_copy.synchronize()
        dt = time.perf_counter() - t0
        return out, DispatchStats(dt, num_host_calls=1,
                                  bytes_moved=_leaf_bytes(tree), t0=t0)


class SequentialDispatcher:
    """Baseline: one copy per leaf, each waited for before the next."""

    name = "sequential"

    def put_with_calls(self, tree: Any,
                       device: torch.device) -> tuple[Any, int]:
        leaves, spec = pytree.tree_flatten(tree)
        out = []
        for x in leaves:
            out.append(torch.from_numpy(np.array(x)).to(device))
            _sync(device)
        return pytree.tree_unflatten(out, spec), len(leaves)

    def put(self, tree: Any, device: torch.device) -> Any:
        return self.put_with_calls(tree, device)[0]

    def timed_put(self, tree: Any,
                  device: torch.device) -> tuple[Any, DispatchStats]:
        t0 = time.perf_counter()
        out, n_calls = self.put_with_calls(tree, device)
        dt = time.perf_counter() - t0
        return out, DispatchStats(dt, num_host_calls=n_calls,
                                  bytes_moved=_leaf_bytes(tree), t0=t0)


def replicated_sharding(mesh) -> tuple:
    """The multicast target: every device of ``mesh`` holds the full
    operand (DTensor placements, one per mesh dim)."""
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


def batch_sharding(mesh, axis: str = "data") -> tuple:
    """Data-parallel batch placement: dim 0 split over ``axis`` of
    ``mesh`` (DTensor placements, one per mesh dim)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    if axis not in names:
        raise ValueError(f"the mesh's axes {names} have no {axis!r}")
    return tuple(Shard(0) if n == axis else Replicate() for n in names)


DISPATCHERS = {
    "multicast": MulticastDispatcher,
    "sequential": SequentialDispatcher,
}


def _leaf_bytes(tree: Any) -> int:
    return sum(np.asarray(x).nbytes for x in pytree.tree_leaves(tree))

