"""The measured window: a thin wrapper around the program's engine.

``TimedEngine`` stands between ``ContinuousBatcher`` and the
``ServingEngine`` it drives.  It forwards every attribute, stamps the host
clock before and after each engine call, keeps what each call was given and
returned, and ends the window at the first call that starts once the
window's seconds have passed, by raising ``WindowClosed``, which derives
from ``BaseException`` so that no ``except Exception`` in the program can
swallow it.  With a ``trace.Tracer`` it also opens and closes a traced
part of the window between two calls, and stamps the traced calls on the
profiler's clock.

``replay`` follows the slots through the recorded calls, as the batcher
fills and frees them, and returns each request's served tokens and each
decode call's occupied rows: the harness's own count of the work, checked
against the program's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


class WindowClosed(BaseException):
    """Raised at the first engine call after the window's end."""


@dataclass(eq=False)
class Call:
    kind: str                       # "decode" | "prefill"
    t0: float                       # host clock before the call
    t1: float = 0.0                 # host clock after it returned
    tokens: np.ndarray | None = None    # prefill tokens (B, L)
    mask: np.ndarray | None = None      # prefill slot mask (B,)
    lens: np.ndarray | None = None      # decode per-slot cache lengths
    tok: np.ndarray | None = None       # decode input tokens (B,)
    out: np.ndarray | None = None       # next tokens (B,)
    traced: bool = False
    span: tuple = ()                    # traced: (start, end), trace clock
    rows: list = field(default_factory=list)   # (slot, request, position)


class TimedEngine:
    """Forwards to ``engine``; times and records ``decode`` and
    ``prefill_into_slots``; ends the window ``seconds`` after ``start``."""

    def __init__(self, engine, seconds: float, tracer=None):
        self._engine = engine
        self._seconds = seconds
        self._tracer = tracer
        self.t_start: float | None = None
        self.calls: list[Call] = []

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def start(self) -> None:
        self.t_start = time.perf_counter()

    @property
    def t_end(self) -> float:
        return self.calls[-1].t1 if self.calls else self.t_start

    def _open(self, kind: str) -> Call:
        now = time.perf_counter()
        if now - self.t_start >= self._seconds:
            raise WindowClosed
        if self._tracer is not None:
            self._tracer.before(now - self.t_start)
            now = time.perf_counter()
        call = Call(kind, now)
        call.traced = self._tracer is not None and self._tracer.active
        if call.traced:
            call.span = (self._tracer.stamp(),)
        return call

    def _close(self, call: Call) -> None:
        call.t1 = time.perf_counter()
        if call.traced:
            call.span += (self._tracer.stamp(),)
        self.calls.append(call)
        if self._tracer is not None:
            self._tracer.after(call.t1 - self.t_start, call.kind)

    def decode(self, tok, caches, lens):
        call = self._open("decode")
        next_tok, caches, wall = self._engine.decode(tok, caches, lens)
        self._close(call)
        call.tok = np.asarray(tok).reshape(-1).copy()
        call.lens = np.asarray(lens).copy()
        call.out = np.asarray(next_tok).copy()
        return next_tok, caches, wall

    def prefill_into_slots(self, tokens, caches, slot_mask, metrics=None):
        call = self._open("prefill")
        next_tok, caches, wall = self._engine.prefill_into_slots(
            tokens, caches, slot_mask, metrics)
        self._close(call)
        call.tokens = np.asarray(tokens).copy()
        call.mask = np.asarray(slot_mask).copy()
        call.out = np.asarray(next_tok).copy()
        return next_tok, caches, wall


def replay(calls: list[Call], requests, max_batch: int):
    """Follow the slots through ``calls``.

    Returns ``(served, prefill_of, problems)``: each request's served
    tokens by rid (the prefill's first token, then one per decode step),
    the index of the prefill call that placed it, and a list of every
    place where the calls disagree with the batcher's rules (a decode
    length that is not the slot's position, a prefill row that matches no
    request).  Fills each call's ``rows`` with its (slot, request,
    position) triples: for a prefill the placed rows, for a decode the
    occupied ones.
    """
    by_prompt = {r.tokens.tobytes(): r for r in requests}
    slots = [None] * max_batch
    emitted = [0] * max_batch
    served: dict[int, list[int]] = {}
    prefill_of: dict[int, int] = {}
    problems: list[str] = []
    for ci, c in enumerate(calls):
        c.rows = []
        if c.kind == "prefill":
            for i in np.flatnonzero(c.mask):
                r = by_prompt.get(c.tokens[i].tobytes())
                if r is None or slots[i] is not None or r.rid in served:
                    problems.append(f"call {ci}: prefill row {i} places no "
                                    "new request into a free slot")
                    continue
                slots[i], emitted[i] = r, 1
                served[r.rid] = [int(c.out[i])]
                prefill_of[r.rid] = ci
                c.rows.append((int(i), r, r.prompt_len))
        else:
            for i in range(max_batch):
                r = slots[i]
                if r is None:
                    continue
                pos = r.prompt_len + emitted[i] - 1
                if int(c.lens[i]) != pos or int(c.tok[i]) != served[r.rid][-1]:
                    problems.append(
                        f"call {ci}: slot {i} decodes at {int(c.lens[i])} "
                        f"from token {int(c.tok[i])}, the request is at "
                        f"{pos} after token {served[r.rid][-1]}")
                c.rows.append((i, r, pos))
                served[r.rid].append(int(c.out[i]))
                emitted[i] += 1
        for i in range(max_batch):
            if slots[i] is not None and emitted[i] >= slots[i].gen_len:
                slots[i] = None
    return served, prefill_of, problems
