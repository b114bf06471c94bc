"""Compiled steps: the port's counterpart of the reference's ``jax.jit``.

The reference runs each step as one compiled executable, kept per input
shape, dispatched by one host call and updating its donated buffers: the
serving engine's decode step and its prefills (one per prompt length), and
the training loop's train step (``launch/train.py``: params and optimizer
state donated, forward, backward, clipping and AdamW in one executable).  A
``CompiledStep`` does the same with CUDA graphs:

  * it keeps one entry per *key*, the shapes and dtypes of the inputs that
    are not static (``static_argnums`` names the static ones, e.g. the
    parameters and the caches); a non-tensor leaf enters the key by value;
  * static inputs stay at their addresses: every call must pass the very
    leaves the entry was built on (the engine's parameters and its own
    caches), or the call raises.  The other inputs are copied into static
    input buffers, allocated once per entry outside any graph;
  * on the card the first call of a key runs the step eagerly on those
    buffers (that call's own execution), then captures it into a
    ``torch.cuda.CUDAGraph``; every later call copies its inputs in and
    replays the graph.  A capture that fails raises;
  * every output that is not a static leaf is copied out of the graph's
    memory right after the replay, so what the host reads outlives the
    next step queued.  The graphs of one owner may share one memory pool
    (``pool=``, a ``torch.cuda.graph_pool_handle()``): only the steps'
    transients live there;
  * the kernels' host-side launch counter (``kernels._build.LAUNCHES``)
    counts a capture as nothing and gets the captured launches back on
    every replay;
  * on CPU tensors (``device="cpu"``) the step runs eagerly on the same
    static buffers each call, with the same copy-in and copy-out.

``disable_compile()`` is the counterpart of ``jax.disable_jit()``: inside
it every ``CompiledStep`` calls its function on the caller's tensors, on
the card too, so a compiled run can be held against an eager one.

``marks``, a list or None (the default), times a call's phases on the
host for a tracer: when it is a list, each call appends ``(phase, start,
end, args)`` with ``time.perf_counter()`` readings, for ``copy_in`` (the
key's look-up and the input-buffer copies), ``replay`` (the graph's
replay, or the eager call on the CPU or under ``disable_compile()``) and
``copy_out`` (the output clones); a key's first call is one ``capture``
mark, with its ``capture_s``.  None reads no clock.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels._build import LAUNCHES


class _Mode:
    disabled = False


_MODE = _Mode()


@contextlib.contextmanager
def disable_compile():
    """Run every ``CompiledStep`` eagerly on its caller's tensors."""
    prev = _MODE.disabled
    _MODE.disabled = True
    try:
        yield
    finally:
        _MODE.disabled = prev


def _leaf_key(x) -> tuple:
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    return ("value", x)


@dataclasses.dataclass
class _Entry:
    """One key's executable: its buffers, its graph and what it cost."""

    static_leaves: list            # the static args' leaves, by identity
    inputs: list                   # static input buffers (None: a value)
    args: tuple                    # the arguments the step runs on
    graph: Any = None              # torch.cuda.CUDAGraph (None: the CPU)
    out: Any = None                # the graph's outputs
    # Kernel calls per replay, by their ``LAUNCHES`` key.
    launches: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    capture_s: float = 0.0
    pool_bytes: int = 0            # the pool's growth during the capture
    calls: int = 0


class CompiledStep:
    """``fn`` compiled per input key; see the module docstring."""

    def __init__(self, fn: Callable, *, device: torch.device,
                 static_argnums: tuple[int, ...] = (), pool=None,
                 name: str = ""):
        self.fn = fn
        self.device = torch.device(device)
        self.static_argnums = tuple(sorted(static_argnums))
        self.pool = pool
        self.name = name or getattr(fn, "__name__", "step")
        self._entries: dict[tuple, _Entry] = {}
        self.marks: list | None = None

    def keys(self) -> list[tuple]:
        """The keys compiled so far, in the order of their first call."""
        return list(self._entries)

    def graphs(self) -> list:
        """The captured graphs, one per key (none on the CPU)."""
        return [e.graph for e in self._entries.values()
                if e.graph is not None]

    def stats(self) -> list[dict]:
        """Per key: capture seconds, pool growth, launches per replay and
        calls (the first one included)."""
        return [{"step": self.name, "key": _key_list(key),
                 "captured": e.graph is not None, "capture_s": e.capture_s,
                 "pool_bytes": e.pool_bytes, "calls": e.calls,
                 "launches_per_replay": dict(e.launches)}
                for key, e in self._entries.items()]

    def __call__(self, *args):
        marks = self.marks
        t = time.perf_counter() if marks is not None else 0.0
        if _MODE.disabled:
            out = self.fn(*args)
            if marks is not None:
                marks.append(("replay", t, time.perf_counter(),
                              {"eager": True}))
            return out
        static = [args[i] for i in self.static_argnums]
        leaves, spec = pytree.tree_flatten(
            [a for i, a in enumerate(args) if i not in self.static_argnums])
        key = (spec, tuple(_leaf_key(x) for x in leaves))
        entry = self._entries.get(key)
        if entry is None:
            out = self._first_call(key, static, leaves, spec)
            if marks is not None:
                marks.append(("capture", t, time.perf_counter(),
                              {"key": _key_list(key),
                               "capture_s": self._entries[key].capture_s}))
            return out
        held = pytree.tree_leaves(static)
        if len(held) != len(entry.static_leaves) or any(
                a is not b for a, b in zip(held, entry.static_leaves)):
            raise ValueError(f"{self.name}: static arguments "
                             f"{self.static_argnums} are not the tensors "
                             "this step was compiled on")
        for buf, x in zip(entry.inputs, leaves):
            if buf is not None:
                buf.copy_(x)
        entry.calls += 1
        if marks is not None:
            t = _mark(marks, "copy_in", t)
        if entry.graph is None:
            out = self.fn(*entry.args)
        else:
            entry.graph.replay()
            LAUNCHES.update(entry.launches)
            out = entry.out
        if marks is not None:
            t = _mark(marks, "replay", t, {"key": _key_list(key)})
        out = self._copy_out(out, entry)
        if marks is not None:
            _mark(marks, "copy_out", t)
        return out

    def _first_call(self, key, static, leaves, spec):
        inputs = [torch.empty_like(x) if isinstance(x, torch.Tensor) else None
                  for x in leaves]
        for buf, x in zip(inputs, leaves):
            if buf is not None:
                buf.copy_(x)
        placed = pytree.tree_unflatten(
            [x if b is None else b for b, x in zip(inputs, leaves)], spec)
        it_static, it_dyn = iter(static), iter(placed)
        n_args = len(static) + len(placed)
        args = tuple(next(it_static) if i in self.static_argnums
                     else next(it_dyn) for i in range(n_args))
        entry = _Entry(static_leaves=pytree.tree_leaves(static),
                       inputs=inputs, args=args, calls=1)
        # This call's own execution: eager, on the static buffers.
        out = self._copy_out(self.fn(*args), entry)
        if self.device.type == "cuda":
            self._capture(entry)
        self._entries[key] = entry
        return out

    def _capture(self, entry: _Entry) -> None:
        """Record the step into a graph; its kernels do not run here."""
        before = LAUNCHES.copy()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                reserved = torch.cuda.memory_reserved(self.device)
                entry.out = self.fn(*entry.args)
            entry.pool_bytes = (torch.cuda.memory_reserved(self.device)
                                - reserved)
            entry.launches = LAUNCHES - before
        finally:
            LAUNCHES.clear()
            LAUNCHES.update(before)
        entry.graph = graph
        entry.capture_s = time.perf_counter() - t0

    @staticmethod
    def _copy_out(out, entry: _Entry):
        """``out`` with every tensor that is not a static leaf copied."""
        held = {id(x) for x in entry.static_leaves}
        leaves, spec = pytree.tree_flatten(out)
        return pytree.tree_unflatten(
            [x.clone() if isinstance(x, torch.Tensor) and id(x) not in held
             else x for x in leaves], spec)


def _key_list(key: tuple) -> list:
    """A key's inputs as JSON: each tensor's shape, each value as is."""
    return [k[1] if k[0] == "value" else list(k[0]) for k in key[1]]


def _mark(marks: list, phase: str, t0: float, args: dict | None = None
          ) -> float:
    """Append ``phase`` from ``t0`` to now; returns now."""
    t1 = time.perf_counter()
    marks.append((phase, t0, t1, args))
    return t1


__all__ = ["CompiledStep", "disable_compile"]
