"""Host -> device job dispatch (the paper's §II, in PyTorch terms).

The port of ``repro/core/dispatch.py`` for one card.  On Manticore the
baseline offload writes the job descriptor and arguments to each cluster
*sequentially*; the paper's extension multicasts them in one transaction.
Here:

  * ``SequentialDispatcher`` (baseline): one host->device copy per leaf of
    the operand tree, each waited for in turn.
  * ``MulticastDispatcher`` (the paper's extension): the whole tree is
    packed into one pinned host buffer and moved with ONE ``non_blocking``
    copy, then a single stream sync.

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


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dt)).dtype


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class MulticastDispatcher:
    """One host transaction per tree: pack, one copy, one sync."""

    name = "multicast"

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
        dev = host.to(device, non_blocking=True)
        out = [dev[off:off + a.nbytes].view(_torch_dtype(a.dtype))
               .reshape(a.shape) for a, off in zip(arrays, offsets)]
        return pytree.tree_unflatten(out, spec)

    def timed_put(self, tree: Any,
                  device: torch.device) -> tuple[Any, DispatchStats]:
        t0 = time.perf_counter()
        out = self.put(tree, device)
        _sync(device)
        dt = time.perf_counter() - t0
        return out, DispatchStats(dt, num_host_calls=1,
                                  bytes_moved=_leaf_bytes(tree))


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
                                  bytes_moved=_leaf_bytes(tree))


def _leaf_bytes(tree: Any) -> int:
    return sum(np.asarray(x).nbytes for x in pytree.tree_leaves(tree))

