"""Request queue for the offload-aware serving subsystem.

A copy of ``repro/serve/queue.py``; its results are bit-identical to the
reference's on the same inputs.

A ``Request`` is one generation job: a prompt of ``prompt_len`` tokens plus
``gen_len`` tokens to decode, arriving at ``arrival`` (fabric cycles on the
open-loop virtual clock; at the paper's 1 GHz, cycles == ns).  A request may
carry a per-request SLO: an execution-time constraint ``slo_cycles`` on its
prefill offload — exactly the paper's Eq.-3 deadline t_max for a job of
N = prompt_len elements.  Admission control (repro_torch.serve.scheduler) rejects
requests whose deadline no parallel extent can meet.

The queue is arrival-ordered and exposes the two views the batcher needs:
requests that have *arrived* by the current virtual time, and the next
arrival when the system is idle.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"          # waiting for admission + batching
    REJECTED = "rejected"      # admission control: SLO infeasible
    RUNNING = "running"        # member of the active wave
    DONE = "done"
    ORPHANED = "orphaned"      # lane crashed with the request on board
    FAILED = "failed"          # orphaned and unrecoverable (naive drop)


@dataclass
class Request:
    rid: int
    arrival: float                     # fabric cycles (virtual open-loop clock)
    prompt_len: int
    gen_len: int
    slo_cycles: float | None = None    # Eq.-3 deadline for the prefill offload
    tokens: np.ndarray | None = None   # (prompt_len,) int32 prompt ids
    state: RequestState = RequestState.QUEUED
    reject_reason: str | None = None
    # Filled in by the batcher as the request progresses (fabric cycles).
    t_admitted: float | None = None
    t_first_token: float | None = None
    t_done: float | None = None
    generated: np.ndarray | None = None
    slo_met: bool | None = None
    # Fault-recovery bookkeeping (DESIGN.md §10).  A request orphaned by a
    # lane crash is requeued at ``t_enqueued`` (crash detection time); if a
    # checkpoint held its decode state, ``restore_len`` tokens are restored
    # (``restored_tokens``) instead of re-prefilled from scratch.
    t_enqueued: float | None = None
    restore_len: int = 0
    restored_tokens: np.ndarray | None = None
    requeues: int = 0
    # Session / tenant / prefix metadata (DESIGN.md §13).  All inert by
    # default: a single-turn, single-tenant trace carries exactly the PR 1–9
    # request shape.  ``prefix_len`` is the reusable context a warm KV cache
    # holds for this session; ``prefix_hit`` is the portion the batcher
    # actually skipped (set at admission when affinity is on);
    # ``prefix_handoff`` marks a hit whose KV must first be copied from a
    # peer lane (priced as a restore-kind memcpy offload).
    session: int | None = None
    turn: int = 0
    tenant: int = 0
    priority: int = 1                  # TenantClass priority (0 = highest)
    prefix_id: int | None = None
    prefix_len: int = 0
    prefix_hit: int = 0
    prefix_handoff: bool = False
    prefix_resolved: bool = False      # hit/handoff already bound (router)
    preemptions: int = 0

    @property
    def n_prompt_elems(self) -> int:
        """Job size N of the prefill offload (the Eq.-1 problem size)."""
        return self.prompt_len

    @property
    def effective_arrival(self) -> float:
        """Queue-ordering time: the requeue instant for recovered requests
        (they cannot be served before the crash was detected), the original
        arrival otherwise.  Latency/TTFT stay measured from ``arrival`` —
        the client's clock does not reset when a fabric dies."""
        return self.arrival if self.t_enqueued is None else \
            max(self.arrival, self.t_enqueued)

    def latency(self) -> float | None:
        """Sojourn time in cycles: arrival -> last generated token."""
        if self.t_done is None:
            return None
        return self.t_done - self.arrival

    def ttft(self) -> float | None:
        """Time to first token in cycles (arrival -> prefill complete)."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival


class RequestQueue:
    """Arrival-ordered queue with admission bookkeeping.

    With ``priority=True`` the *arrived* view is additionally ordered by
    tenant class (lower ``Request.priority`` first): under overload the
    batcher drains premium traffic before standard before batch.  Waiting
    order (and therefore ``next_arrival``) stays purely temporal — priority
    cannot make a request arrive earlier, only jump the backlog.
    """

    def __init__(self, requests: list[Request] | None = None, *,
                 priority: bool = False):
        self._waiting: list[Request] = sorted(
            requests or [], key=lambda r: (r.effective_arrival, r.rid))
        self.priority = priority
        self.rejected: list[Request] = []
        self.finished: list[Request] = []

    def push(self, req: Request) -> None:
        self._waiting.append(req)
        self._waiting.sort(key=lambda r: (r.effective_arrival, r.rid))

    def __len__(self) -> int:
        return len(self._waiting)

    @property
    def empty(self) -> bool:
        return not self._waiting

    def next_arrival(self) -> float | None:
        return self._waiting[0].effective_arrival if self._waiting else None

    def arrived(self, now: float) -> list[Request]:
        """Requests that have arrived by virtual time ``now`` (not popped).

        The waiting list is arrival-sorted, so the arrived set is a prefix —
        the scan stops at the first future arrival (the continuous loop
        calls this between every decode step, DESIGN.md §6).
        """
        out = []
        for r in self._waiting:
            if r.effective_arrival > now:
                break
            out.append(r)
        if self.priority:
            out.sort(key=lambda r: (r.priority, r.effective_arrival, r.rid))
        return out

    def drain(self) -> list[Request]:
        """Remove and return every waiting request (lane crash: the queue's
        contents are orphaned wholesale, including future arrivals that were
        already routed to this lane — open-loop routing is irrevocable)."""
        out, self._waiting = self._waiting, []
        return out

    def pop(self, req: Request) -> Request:
        self._waiting.remove(req)
        return req

    def reject(self, req: Request, reason: str) -> None:
        self._waiting.remove(req)
        req.state = RequestState.REJECTED
        req.reject_reason = reason
        self.rejected.append(req)

    def finish(self, req: Request, now: float) -> None:
        req.state = RequestState.DONE
        req.t_done = now
        self.finished.append(req)
