"""Per-fabric prefix-KV residency with LRU capacity (DESIGN.md §13).

A session returning to a fabric whose KV cache still holds its context can
skip prefill for the resident portion — the paper's Eq.-1 trade in cache
form: a hit saves the whole offload (dispatch + copy + sync + compute) for
the reused tokens, a miss pays full prefill, and a *handoff* (the prefix is
resident on a peer fabric) pays a pure-streaming ``memcpy`` offload to pull
the KV across before serving the remainder.

``PrefixStore`` is the bookkeeping half: which prefix ids are resident on
this fabric, at what context length, under a token-capacity LRU.  All state
is virtual-clock deterministic — no RNG, no wall clock — so affinity runs
replay bit-identically per seed.

The storage half is :mod:`repro_torch.ckpt.checkpoint`-backed: when a serving
engine is attached, the actual KV pytree of an evicted-to-peer or
handed-off prefix moves through the same atomic ``step_<pid>`` directories
the fault-recovery path uses (one step per prefix id), so a cross-fabric
handoff restores real state, not just an accounting entry.

The port of ``repro/serve/prefix.py`` on the port's checkpoint manager,
whose ``restore_checkpoint`` gives torch tensors.  ``fetch_kv`` gives back a
numpy array wherever ``tree_like`` holds one (or a shapeless placeholder),
as the reference does, and a tensor where it holds a tensor.
"""

from __future__ import annotations

import shutil
from collections import OrderedDict
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager, restore_checkpoint

#: Default residency capacity, in context tokens (~a few dozen sessions at
#: the smoke trace's context lengths; small enough that LRU pressure is
#: actually exercised in tests and benchmarks).
DEFAULT_CAPACITY_TOKENS = 65_536


class PrefixStore:
    """LRU residency map: prefix id -> resident context length (tokens)."""

    def __init__(self, capacity_tokens: int = DEFAULT_CAPACITY_TOKENS, *,
                 ckpt_dir: str | Path | None = None):
        if capacity_tokens < 1:
            raise ValueError("capacity_tokens must be >= 1")
        self.capacity_tokens = capacity_tokens
        self._resident: OrderedDict[int, int] = OrderedDict()
        self._tokens = 0
        self._ckpt = (CheckpointManager(ckpt_dir, keep=1_000_000)
                      if ckpt_dir is not None else None)
        # Counters (virtual-clock domain, deterministic per trace).
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._resident)

    @property
    def tokens(self) -> int:
        """Total resident context tokens (<= capacity after every insert)."""
        return self._tokens

    def resident(self, pid: int | None) -> int:
        """Resident length for ``pid`` without touching LRU order."""
        if pid is None:
            return 0
        return self._resident.get(pid, 0)

    def hit(self, pid: int | None, want_len: int) -> int:
        """Usable hit length: min(resident, want).  Touches LRU + counters."""
        if pid is None or want_len <= 0:
            return 0
        got = self._resident.get(pid, 0)
        n = min(got, want_len)
        if n > 0:
            self._resident.move_to_end(pid)
            self.hits += 1
            self.hit_tokens += n
        else:
            self.misses += 1
        return n

    def insert(self, pid: int | None, length: int) -> list[int]:
        """Record ``pid`` resident at ``length`` tokens; returns evictions.

        Re-inserting an id replaces its length (a later turn extends the
        session's context).  Least-recently-used prefixes are evicted until
        the store fits its token capacity; an oversized single prefix is
        simply not retained (nothing else should be evicted for a context
        that can never fit).
        """
        if pid is None or length <= 0:
            return []
        if length > self.capacity_tokens:
            return []
        if pid in self._resident:
            self._tokens -= self._resident.pop(pid)
        self._resident[pid] = length
        self._tokens += length
        evicted: list[int] = []
        while self._tokens > self.capacity_tokens:
            old_pid, old_len = self._resident.popitem(last=False)
            self._tokens -= old_len
            self.evictions += 1
            evicted.append(old_pid)
            self._drop_kv(old_pid)
        return evicted

    def drop(self, pid: int | None) -> None:
        """Forget a prefix (e.g. the owning lane crashed)."""
        if pid is not None and pid in self._resident:
            self._tokens -= self._resident.pop(pid)
            self._drop_kv(pid)

    # --- checkpoint-backed KV payloads ------------------------------------
    @property
    def ckpt_dir(self) -> Path | None:
        return self._ckpt.directory if self._ckpt is not None else None

    def attach_kv(self, pid: int, tree: Any,
                  extra: dict | None = None) -> None:
        """Persist the prefix's KV pytree (async atomic save, step = pid)."""
        if self._ckpt is None:
            raise RuntimeError("PrefixStore has no checkpoint directory")
        self._ckpt.save(int(pid), tree, extra or {})

    def fetch_kv(self, pid: int, tree_like: Any) -> Any:
        """Restore the prefix's KV pytree (cross-fabric handoff)."""
        if self._ckpt is None:
            raise RuntimeError("PrefixStore has no checkpoint directory")
        self._ckpt.wait()
        tree, _, _ = restore_checkpoint(self._ckpt.directory, tree_like,
                                        step=int(pid))
        return _like(tree, tree_like)

    def _drop_kv(self, pid: int) -> None:
        if self._ckpt is None:
            return
        self._ckpt.wait()
        step_dir = self._ckpt.directory / f"step_{int(pid):08d}"
        if step_dir.exists():
            shutil.rmtree(step_dir)


def _like(tree: Any, tree_like: Any) -> Any:
    """``tree`` with each leaf in the kind of its ``tree_like`` leaf: a
    tensor stays a tensor, anything else becomes a numpy array (bf16
    leaves stay tensors: numpy has no bfloat16)."""
    if isinstance(tree_like, dict):
        return {k: _like(tree[k], v) for k, v in tree_like.items()}
    if isinstance(tree_like, (tuple, list)):
        return type(tree_like)(_like(t, v) for t, v in zip(tree, tree_like))
    if (tree is None or isinstance(tree_like, torch.Tensor)
            or tree.dtype == torch.bfloat16):
        return tree
    return np.asarray(tree.numpy())
