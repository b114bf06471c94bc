"""Discrete-event offload engine: overlapped jobs on a host+fabric timeline.

A copy of ``repro/core/engine.py``; its results are bit-identical to the
reference's on the same inputs.

The closed-form simulator (``repro_torch.core.simulator``) prices one *isolated*
offload; the whole serving stack used to execute on top of it one blocking
job at a time, so the host's dispatch of job k+1 never overlapped the
execution of job k — exactly the overhead the source paper quantifies
(α = 367 cycles per offload) and that the follow-up work ("Taming Offload
Overheads in a Massively Parallel Open-Source RISC-V MPSoC", Colagrande &
Benini 2025, see PAPERS.md) removes by double-buffering job descriptors on
the accelerator.

This module decomposes each job into the same four phases as the closed form
— dispatch / wakeup+DMA+compute (execution) / completion signal / host
return — but schedules them on two explicit resources:

  * the **host** (CVA6): busy while constructing+transmitting a descriptor
    and while handling a completion (for ``sync="poll"`` it busy-waits for
    the whole execution, so nothing can overlap);
  * the **fabric** (clusters + shared operand bus): busy from the release
    fence to the last cluster's compute completion; jobs execute FIFO.

The ``buffering`` axis models the accelerator-side job-descriptor queue:

  * ``"single"`` — one descriptor slot: the host may not start dispatching
    job k+1 until job k has fully retired (the blocking behaviour the rest
    of the repo had before this engine; back-to-back totals are exactly the
    sum of closed-form totals);
  * ``"double"`` — two slots: the host dispatches job k+1 into the spare
    descriptor while job k executes, so the dispatch phase (and, in the
    fabric-bound regime, the completion signal + host return as well) hides
    under execution.  Steady-state per-job time collapses from
    α + β·N + γ·N/M to wakeup + β·N + γ·N/M (DESIGN.md §7).

All phase cycle counts come from ``simulator.dispatch_cycles`` /
``exec_schedule`` / ``sync_cycles`` — shared with ``simulate_offload`` — so
a single job on an idle engine reproduces the closed-form total *exactly*
(property-tested in ``tests/test_engine.py``).

Host-fallback jobs (``offload=False``) occupy only the host resource for
``host_runtime`` cycles; the scheduler's "keep tiny jobs on the host"
decisions therefore interleave naturally with in-flight offloads — a host
decode step runs in the host's idle gap while a prefill offload is executing
on the fabric, which is what the pipelined serving loop
(``repro_torch.serve.batcher``) exploits.
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field

from . import simulator as sim
from .simulator import DAXPY, HWParams, KernelSpec

#: Accelerator-side job-descriptor buffering depth (DESIGN.md §7).
BUFFERING_MODES = ("single", "double")

_DEPTH = {"single": 1, "double": 2}


class FabricHalted(RuntimeError):
    """Raised on ``submit`` after :meth:`OffloadEngine.halt` — the fabric
    timeline is dead and can never schedule another job (DESIGN.md §10)."""


@dataclass
class JobRecord:
    """One scheduled job: absolute event times on the engine timeline."""

    job_id: int
    n_elems: int
    m_clusters: int | None          # None for host-fallback jobs
    offload: bool
    dispatch: str | None
    sync: str | None
    kernel: str
    t_submit: float                 # when the caller handed the job over
    dispatch_start: float           # host begins descriptor construction
    dispatch_done: float            # release fence published
    exec_start: float               # fabric begins wakeup+DMA+compute
    exec_done: float                # last cluster's compute complete
    sync_done: float                # completion signal delivered to host
    t_done: float                   # host return handled; job retired
    #: Host-side cycles (dispatch) that ran while the fabric was executing
    #: another job — the overhead double buffering hides.
    overlap: float = 0.0
    #: Fabric idle cycles inserted before this job's execution could start
    #: (the pipeline bubble; 0 when execution follows back-to-back).
    bubble: float = 0.0
    #: Completion-to-completion service time: ``t_done`` minus the previous
    #: fabric job's ``t_done`` when saturated (the steady-state period whose
    #: constant is α_eff), or minus ``dispatch_start`` when isolated (the
    #: closed-form total whose constant is α).  This is the sample the
    #: overlap-aware runtime-model fit consumes (DESIGN.md §7).
    effective: float = 0.0
    #: True when a fabric halt retired the job before its scheduled
    #: completion — its results never materialized (DESIGN.md §10).
    aborted: bool = False
    #: Per-phase joules (DESIGN.md §11), priced from the same cycle counts
    #: the engine scheduled with — host-fallback jobs carry their whole
    #: energy in ``e_exec``.
    e_dispatch: float = 0.0
    e_exec: float = 0.0
    e_sync: float = 0.0

    @property
    def total(self) -> float:
        """Job runtime as a blocking caller would see it (start -> retire)."""
        return self.t_done - self.dispatch_start

    @property
    def energy(self) -> float:
        """Total joules, summed in phase order — for an isolated
        single-buffered job this equals ``simulator.offload_energy`` exactly
        (same helpers, same cycle counts, same summation order)."""
        return self.e_dispatch + self.e_exec + self.e_sync


@dataclass
class _HostTimeline:
    """Busy intervals of the host, supporting gap insertion.

    Jobs are scheduled eagerly at submit time, but a later job's dispatch
    may legally run in the host's idle window between an earlier job's
    dispatch and its completion IRQ — so intervals are kept sorted and new
    work is placed in the earliest gap that fits.
    """

    intervals: list[tuple[float, float]] = field(default_factory=list)

    def earliest(self, t: float, duration: float) -> float:
        """Earliest start >= t such that [start, start+duration) is idle."""
        i = bisect.bisect_left(self.intervals, (t, float("-inf")))
        # The preceding interval may still cover t.
        if i > 0 and self.intervals[i - 1][1] > t:
            t = self.intervals[i - 1][1]
            i = bisect.bisect_left(self.intervals, (t, float("-inf")))
        for start, end in self.intervals[i:]:
            if t + duration <= start:
                break
            t = max(t, end)
        return t

    def conflict_end(self, start: float, end: float) -> float | None:
        """Latest busy-interval end overlapping [start, end), or None."""
        out = None
        for s, e in self.intervals:
            if s >= end:
                break
            if e > start:
                out = e if out is None else max(out, e)
        return out

    def reserve(self, start: float, end: float) -> None:
        if end > start:
            bisect.insort(self.intervals, (start, end))


class OffloadEngine:
    """Event-driven schedule of offload (and host) jobs with overlap.

    The engine is deterministic and eager: ``submit`` computes the job's
    full schedule immediately (jobs execute FIFO on the fabric, and the
    descriptor-buffer depth bounds how far the host may run ahead), so the
    returned :class:`JobRecord` already carries its completion time.
    ``poll``/``complete`` exist for protocol symmetry with measured fabrics,
    where completion times are only known after the fact.
    """

    def __init__(self, *, hw: HWParams = HWParams(),
                 buffering: str = "single", tracer=None,
                 proc: str = "fabric", dvfs: sim.DVFSState | str | None = None):
        if buffering not in BUFFERING_MODES:
            raise ValueError(
                f"buffering must be one of {BUFFERING_MODES}, "
                f"got {buffering!r}")
        self.hw = hw
        self.buffering = buffering
        self.depth = _DEPTH[buffering]
        # Energy operating point (DESIGN.md §11): prices joules only; cycle
        # counts are DVFS-invariant so timelines never depend on it.
        self.dvfs = sim.dvfs_state(dvfs)
        # Optional span tracer (repro_torch.obs): per-job dispatch/exec/sync phase
        # spans on the proc's host/fabric/sync tracks.  None keeps every
        # event site at a single attribute check (the zero-overhead default).
        self.tracer = tracer
        self.proc = proc
        self.jobs: list[JobRecord] = []
        self._host = _HostTimeline()
        self._fabric_free = 0.0         # fabric execution is FIFO
        self._fabric_busy = 0.0         # total fabric-busy cycles
        # Per-phase busy totals (DESIGN.md §9): same decomposition as the
        # traced spans, so trace counters and utilization() agree.
        self._dispatch_busy = 0.0       # host descriptor-construction cycles
        self._sync_busy = 0.0           # exec_done -> t_done cycles per job
        self._host_busy = 0.0           # reserved host cycles (all sources)
        # Per-phase joules attributed to scheduled jobs (DESIGN.md §11).
        self._dispatch_energy = 0.0
        self._exec_energy = 0.0
        self._sync_energy = 0.0
        self._last_exec: tuple[float, float] | None = None
        self._fabric_tdones: list[float] = []   # retire times, FIFO order
        self._completed_upto = 0        # poll() cursor
        self.halted_at: float | None = None     # set by halt()

    # ------------------------------------------------------------------ #
    def submit(self, n_elems: int, *, m_clusters: int | None = None,
               dispatch: str = "multicast", sync: str = "credit",
               kernel: KernelSpec = DAXPY, t_submit: float = 0.0,
               offload: bool = True, exec_scale: float = 1.0) -> JobRecord:
        """Schedule one job; returns its fully-resolved :class:`JobRecord`.

        ``exec_scale`` multiplies the execution (fabric) phase only — the
        hook measured-noise models (fabric jitter) use; dispatch and sync
        constants are host-side and stay exact.
        """
        if self.halted_at is not None:
            raise FabricHalted(
                f"fabric {self.proc!r} halted at {self.halted_at:.0f} cy; "
                f"submit at t={t_submit:.0f} is impossible")
        if offload:
            return self._submit_offload(n_elems, m_clusters, dispatch, sync,
                                        kernel, t_submit, exec_scale)
        return self._submit_host(n_elems, kernel, t_submit, exec_scale)

    def _submit_offload(self, n, m, dispatch, sync, kernel, t_submit,
                        exec_scale) -> JobRecord:
        if m is None or m < 1:
            raise ValueError("offload jobs need m_clusters >= 1")
        d_cycles = sim.dispatch_cycles(m, dispatch, self.hw)
        e_cycles = math.ceil(
            exec_scale * sim.exec_cycles(m, n, self.hw, kernel))
        signal, ret = sim.sync_cycles(sync, self.hw)

        # Descriptor buffering: with depth d, job j may not start dispatching
        # until job j-d has retired (FIFO completions).
        k = len(self._fabric_tdones) - self.depth
        slot_free = self._fabric_tdones[k] if k >= 0 else 0.0

        t0 = max(t_submit, slot_free)
        if sync == "poll":
            # The host busy-waits from dispatch through detection + return,
            # so the *whole* span — not just the dispatch phase — must fit
            # one idle host window (otherwise a previously-reserved interval
            # would be double-booked under the busy-wait).
            d_start = self._host.earliest(t0, d_cycles)
            while True:
                d_done = d_start + d_cycles
                e_start = max(d_done, self._fabric_free)
                e_done = e_start + e_cycles
                sync_done = e_done + signal
                clash = self._host.conflict_end(d_start, sync_done + ret)
                if clash is None:
                    break
                d_start = self._host.earliest(clash, d_cycles)
            ret_start = sync_done
            host_busy = [(d_start, sync_done + ret)]
        else:
            d_start = self._host.earliest(t0, d_cycles)
            d_done = d_start + d_cycles
            e_start = max(d_done, self._fabric_free)
            e_done = e_start + e_cycles
            sync_done = e_done + signal
            ret_start = self._host.earliest(sync_done, ret)
            host_busy = [(d_start, d_done), (ret_start, ret_start + ret)]
        t_done = ret_start + ret

        rec = JobRecord(
            job_id=len(self.jobs), n_elems=n, m_clusters=m, offload=True,
            dispatch=dispatch, sync=sync, kernel=kernel.name,
            t_submit=t_submit, dispatch_start=d_start, dispatch_done=d_done,
            exec_start=e_start, exec_done=e_done, sync_done=sync_done,
            t_done=t_done,
            # Energy is priced from the cycle counts actually scheduled
            # (jittered e_cycles included) — at exec_scale=1 on an idle
            # single-buffered engine the three phases sum to the closed-form
            # offload_energy exactly (DESIGN.md §11).
            e_dispatch=sim.phase_energy(d_cycles, self.hw.e_dispatch_pj,
                                        self.hw, self.dvfs),
            e_exec=sim.phase_energy(e_cycles, self.hw.e_exec_pj,
                                    self.hw, self.dvfs, active=m),
            e_sync=sim.phase_energy(signal + ret, self.hw.e_sync_pj,
                                    self.hw, self.dvfs),
        )
        # Dispatch cycles hidden under another job's execution.
        if self._last_exec is not None:
            lo, hi = self._last_exec
            rec.overlap = max(0.0, min(d_done, hi) - max(d_start, lo))
        # Fabric idle inserted before this execution (0 when back-to-back).
        if self._fabric_tdones or self._last_exec is not None:
            rec.bubble = max(0.0, e_start - self._fabric_free)
        prev_done = self._fabric_tdones[-1] if self._fabric_tdones else None
        rec.effective = t_done - (max(d_start, prev_done)
                                  if prev_done is not None else d_start)

        for start, end in host_busy:
            self._host.reserve(start, end)
            self._host_busy += end - start
        self._fabric_free = e_done
        self._fabric_busy += e_cycles
        self._dispatch_busy += d_cycles
        self._sync_busy += t_done - e_done
        self._dispatch_energy += rec.e_dispatch
        self._exec_energy += rec.e_exec
        self._sync_energy += rec.e_sync
        self._last_exec = (e_start, e_done)
        self._fabric_tdones.append(t_done)
        self.jobs.append(rec)
        if self.tracer is not None:
            self._trace_offload(rec)
        return rec

    def _trace_offload(self, rec: JobRecord) -> None:
        """Phase spans of one offload: dispatch (host), exec (fabric), sync
        (completion signal + host return).  The three durations partition
        [dispatch_start, t_done) exactly for an isolated job, so they sum
        to the Eq.-1 closed form (property-tested in tests/test_obs.py)."""
        t = self.tracer
        ident = {"job": rec.job_id, "n": rec.n_elems, "m": rec.m_clusters}
        t.span(self.proc, "host", "dispatch", rec.dispatch_start,
               rec.dispatch_done - rec.dispatch_start,
               args={**ident, "joules": rec.e_dispatch})
        t.span(self.proc, "fabric", "exec", rec.exec_start,
               rec.exec_done - rec.exec_start,
               args={**ident, "bubble": rec.bubble, "overlap": rec.overlap,
                     "joules": rec.e_exec})
        t.span(self.proc, "sync", "sync", rec.exec_done,
               rec.t_done - rec.exec_done,
               args={**ident, "sync": rec.sync, "joules": rec.e_sync})

    def _submit_host(self, n, kernel, t_submit, exec_scale) -> JobRecord:
        cycles = math.ceil(
            exec_scale * sim.host_runtime(n, hw=self.hw, kernel=kernel))
        start = self._host.earliest(t_submit, cycles)
        done = start + cycles
        rec = JobRecord(
            job_id=len(self.jobs), n_elems=n, m_clusters=None, offload=False,
            dispatch=None, sync=None, kernel=kernel.name, t_submit=t_submit,
            dispatch_start=start, dispatch_done=start, exec_start=start,
            exec_done=done, sync_done=done, t_done=done,
            effective=done - start,
            e_exec=sim.phase_energy(cycles, self.hw.e_host_pj,
                                    self.hw, self.dvfs),
        )
        # A host job overlaps when it runs while the fabric executes.
        if self._last_exec is not None:
            lo, hi = self._last_exec
            rec.overlap = max(0.0, min(done, hi) - max(start, lo))
        self._host.reserve(start, done)
        self._host_busy += done - start
        self._exec_energy += rec.e_exec
        self.jobs.append(rec)
        if self.tracer is not None:
            self.tracer.span(self.proc, "host", "host", start, done - start,
                             args={"job": rec.job_id, "n": n,
                                   "overlap": rec.overlap,
                                   "joules": rec.e_exec})
        return rec

    # ------------------------------------------------------------------ #
    def poll(self, now: float) -> list[JobRecord]:
        """Jobs newly retired by virtual time ``now`` (submit order)."""
        out = []
        for rec in self.jobs[self._completed_upto:]:
            if rec.t_done > now:
                break
            out.append(rec)
        self._completed_upto += len(out)
        return out

    def complete(self, rec: JobRecord) -> JobRecord:
        """Blocking-protocol shim: the record is already fully scheduled."""
        return rec

    # ------------------------------------------------------------------ #
    def halt(self, t: float) -> list[JobRecord]:
        """Fail the fabric at time ``t``: the timeline ends here.

        Jobs whose retirement lies beyond ``t`` are marked ``aborted`` (their
        results never materialized) and returned; any later ``submit``
        raises :class:`FabricHalted`.

        The engine schedules eagerly — ``submit`` traces a job's phase spans
        the moment it is accepted, because the simulator knows the future.
        A crash retracts the part of that future that never happened: this
        proc's cycle-domain complete spans starting at or after ``t`` are
        dropped from the tracer and spans crossing ``t`` truncated, so the
        exported trace stays consistent with a dead lane
        (``tools/check_trace.py`` enforces that no span on a crashed proc
        starts after its ``fault:crash`` instant; DESIGN.md §10).
        """
        if self.halted_at is not None:
            raise FabricHalted(f"fabric {self.proc!r} already halted at "
                               f"{self.halted_at:.0f} cy")
        self.halted_at = t
        aborted = []
        for rec in self.jobs:
            if rec.t_done > t:
                rec.aborted = True
                aborted.append(rec)
        if self.tracer is not None:
            kept = []
            for e in self.tracer.events:
                if (e.proc == self.proc and e.ph == "X"
                        and e.domain == "cycles"):
                    if e.ts >= t:
                        continue
                    if e.ts + (e.dur or 0.0) > t:
                        e.dur = t - e.ts
                kept.append(e)
            self.tracer.events[:] = kept
        return aborted

    # ------------------------------------------------------------------ #
    def utilization(self) -> dict:
        """Aggregate overlap/bubble + per-phase busy accounting.

        ``fabric_busy`` is the execution-phase total (``exec_total`` is its
        explicit alias); ``dispatch_total``/``sync_total`` are the host-side
        and completion-path phase totals of the same decomposition the
        traced spans use, and ``host_busy`` sums every reserved host
        interval (dispatch + completion handling + host-fallback jobs +
        poll busy-waits) — so trace counters and this dict agree
        (DESIGN.md §9).  A single-instant schedule (every event at one
        timestamp, e.g. only zero-cycle jobs) has ``span == 0``; the
        utilization ratios are defined as 0.0 there, not NaN.
        """
        offloads = [r for r in self.jobs if r.offload]
        span = (max(r.t_done for r in self.jobs)
                - min(r.dispatch_start for r in self.jobs)
                if self.jobs else 0.0)
        single_instant = span <= 0.0
        return {
            "jobs": len(self.jobs),
            "offloads": len(offloads),
            "span": span,
            "fabric_busy": self._fabric_busy,
            "dispatch_total": self._dispatch_busy,
            "exec_total": self._fabric_busy,
            "sync_total": self._sync_busy,
            "host_busy": self._host_busy,
            "fabric_util": (0.0 if single_instant
                            else self._fabric_busy / span),
            "host_util": (0.0 if single_instant
                          else self._host_busy / span),
            "overlap_total": sum(r.overlap for r in self.jobs),
            "bubble_total": sum(r.bubble for r in offloads),
            "aborted": sum(1 for r in self.jobs if r.aborted),
            "halted_at": self.halted_at,
            # Energy decomposition (DESIGN.md §11): per-phase joules summed
            # over scheduled jobs — the energy mirror of the busy totals
            # above (host-fallback energy counts under exec).
            "dispatch_energy_j": self._dispatch_energy,
            "exec_energy_j": self._exec_energy,
            "sync_energy_j": self._sync_energy,
            "energy_j": (self._dispatch_energy + self._exec_energy
                         + self._sync_energy),
        }


# --------------------------------------------------------------------------- #
# Steady-state (back-to-back) runtimes — the throughput domain of a design.
# --------------------------------------------------------------------------- #

def steady_runtime(
    m_clusters: int,
    n_elems: int,
    *,
    dispatch: str = "multicast",
    sync: str = "credit",
    hw: HWParams = HWParams(),
    kernel: KernelSpec = DAXPY,
    buffering: str = "double",
    jobs: int = 8,
) -> float:
    """Steady-state per-job cycles for a saturated back-to-back stream.

    Submits ``jobs`` identical offloads at t=0 and returns the mean
    completion-to-completion period over the second half of the stream (in
    the host-bound margin, where per-job host work D+R exceeds the
    execution phase, the non-preemptive depth-2 schedule settles into an
    alternating short/long pattern — the average is the throughput-relevant
    period).  With ``buffering="single"`` every period equals the
    closed-form ``offload_runtime`` (jobs fully serialize); with
    ``"double"`` the dispatch — and in the fabric-bound regime the
    completion signal and host return too — hides under the neighbouring
    jobs' execution (DESIGN.md §7).
    """
    jobs = max(4, jobs)
    eng = OffloadEngine(hw=hw, buffering=buffering)
    recs = [
        eng.submit(n_elems, m_clusters=m_clusters, dispatch=dispatch,
                   sync=sync, kernel=kernel, t_submit=0.0)
        for _ in range(jobs)
    ]
    half = jobs // 2
    return (recs[-1].t_done - recs[-1 - half].t_done) / half


def steady_sweep(
    ms: list[int],
    ns: list[int],
    *,
    dispatch: str = "multicast",
    sync: str = "credit",
    hw: HWParams = HWParams(),
    kernel: KernelSpec = DAXPY,
    buffering: str = "double",
    jobs: int = 8,
) -> dict[tuple[int, int], float]:
    """Steady-state per-job runtime for every (M, N) cell — the pipelined
    counterpart of :func:`simulator.sweep`, consumed by the DSE refit of
    double-buffered designs and by the overlap-aware model fit."""
    return {
        (m, n): steady_runtime(m, n, dispatch=dispatch, sync=sync, hw=hw,
                               kernel=kernel, buffering=buffering, jobs=jobs)
        for m in ms
        for n in ns
    }


def effective_alpha_floor(hw: HWParams = HWParams()) -> int:
    """The fabric-bound steady-state constant: only the cluster wakeup.

    For back-to-back double-buffered jobs whose execution phase is at least
    as long as the host's per-job work (dispatch + signal + return), the
    period is exactly ``cluster_wakeup + β·N + γ·N/M`` — dispatch and sync
    hide entirely under the neighbouring executions, so
    α_eff = ``cluster_wakeup`` (40 vs the paper's 367 on default hardware).
    Below that regime the descriptor depth of two serializes host and fabric
    phases into alternating pairs and α_eff rises toward the closed-form α;
    the empirical fit (``runtime_model.fit_pipelined_from_engine``) captures
    the whole range.  Derivation: DESIGN.md §7.
    """
    return hw.cluster_wakeup
