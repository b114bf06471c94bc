"""Deterministic synthetic LM data pipeline with packing and prefetch.

The port of ``repro/data/pipeline.py``.  The host generates documents,
packs them into fixed-length rows with EOS separators, and places each
global batch on the card with ONE multicast dispatch
(``repro_torch.core.dispatch.MulticastDispatcher``: one pinned buffer, one
copy) — the paper's extension applied to the input pipeline; the
sequential per-leaf baseline is kept for A/B runs.

``DataConfig``, ``synthetic_documents`` and ``packed_batches`` are numpy
and copied as they are, so both packages draw the same batches from the
same seed.  The synthetic corpus is an order-2 Markov stream, so a real
model can learn it (loss decreases measurably within a few hundred steps).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.dispatch import MulticastDispatcher, SequentialDispatcher
from repro_torch.launch.device import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 0
    mean_doc_len: int = 96
    prefetch: int = 2


def synthetic_documents(cfg: DataConfig) -> Iterator[np.ndarray]:
    """Endless stream of variable-length docs from a learnable Markov chain.

    Structure: with p=0.85 the next token continues an increment chain
    (next = prev+1 cyclically), else it jumps uniformly. A model that learns
    the chain reaches CE ~= 0.15*ln(V) + H(0.85) << ln(V), so training
    progress is visible within a few hundred steps on CPU.
    """
    rng = np.random.default_rng(cfg.seed)
    v = cfg.vocab_size
    while True:
        n = max(4, int(rng.exponential(cfg.mean_doc_len)))
        doc = np.empty(n, np.int32)
        doc[0] = rng.integers(1, v)
        jumps = rng.random(n) >= 0.85
        for i in range(1, n):
            if jumps[i]:
                doc[i] = rng.integers(1, v)
            else:
                doc[i] = (doc[i - 1] % (v - 1)) + 1
        yield doc


def packed_batches(cfg: DataConfig) -> Iterator[np.ndarray]:
    """Pack documents into (global_batch, seq_len) rows with EOS separators."""
    docs = synthetic_documents(cfg)
    buf = np.empty(0, np.int32)
    while True:
        need = cfg.global_batch * cfg.seq_len
        while buf.size < need:
            d = next(docs)
            buf = np.concatenate(
                [buf, d, np.array([cfg.eos_id], np.int32)])
        rows = buf[:need].reshape(cfg.global_batch, cfg.seq_len)
        buf = buf[need:]
        yield rows


class DataPipeline:
    """Host-side prefetching loader placing batches via multicast dispatch.

    Each ``next`` returns a (global_batch, seq_len) int32 tensor on
    ``device``; with a ``DeviceMesh`` as ``mesh``, a DTensor on the mesh's
    device type with the batch over the data axes (the reference's
    ``P(dp, None)``).  Every rank draws the same batches from the seed and
    keeps its own rows.
    """

    def __init__(self, cfg: DataConfig,
                 device: str | torch.device = "cuda", *, mesh=None,
                 dispatcher: str = "multicast"):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(mesh.device_type if mesh is not None
                                     else device)
        self.dispatcher = (MulticastDispatcher() if dispatcher == "multicast"
                           else SequentialDispatcher())
        self._iter = packed_batches(cfg)
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            batch = next(self._iter)
            try:
                self._q.put(batch, timeout=0.5)
            except queue.Full:
                if self._stop.is_set():
                    return
                self._q.put(batch)

    def __next__(self) -> torch.Tensor:
        batch = self.dispatcher.put(self._q.get(), self.device)
        if self.mesh is None:
            return batch
        from repro_torch.launch.mesh import data_axes
        from repro_torch.runtime.sharding import P, distribute
        return distribute(batch, P(data_axes(self.mesh), None), self.mesh)

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
