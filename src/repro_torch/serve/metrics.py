"""Serving metrics: throughput, latency percentiles, SLO attainment.

A copy of ``repro/serve/metrics.py``; its results are bit-identical to the
reference's on the same inputs.

Two time domains, recorded side by side:

  * *fabric cycles* — the virtual open-loop clock the scheduler plans in
    (Eq.-1 coefficients are cycles; at 1 GHz cycles == ns).  Request
    latency, TTFT, and SLO attainment live here.
  * *wall seconds* — measured host-side durations of the real engine
    steps (DispatchStats.seconds, CreditCounterSync.timed_wait), when an
    engine is attached.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .workload import CYCLES_PER_SECOND


class Recorder:
    """Streaming collection with percentile summaries.

    The default keeps every sample (exact percentiles; ``series()`` is the
    full recording).  ``reservoir=k`` is the bounded mode for long traced
    runs: memory stays flat at k samples while ``len``/``mean``/``total``
    remain *exact* via O(1) streaming accumulators — only percentiles
    become estimates, computed over a uniform reservoir (Vitter's
    Algorithm R, deterministic per recorder).  While the sample count is
    still <= k the reservoir holds every sample, so ``summary()`` output is
    unchanged on small runs (regression-tested in tests/test_obs.py).
    """

    def __init__(self, reservoir: int | None = None):
        if reservoir is not None and reservoir < 1:
            raise ValueError("reservoir must be >= 1 (or None for exact)")
        self._xs: list[float] = []
        self._cap = reservoir
        self._count = 0
        self._total = 0.0
        self._rng = (np.random.default_rng(0) if reservoir is not None
                     else None)

    def add(self, x: float) -> None:
        x = float(x)
        self._count += 1
        self._total += x
        if self._cap is None or len(self._xs) < self._cap:
            self._xs.append(x)
        else:
            j = int(self._rng.integers(0, self._count))
            if j < self._cap:
                self._xs[j] = x

    def __len__(self) -> int:
        return self._count

    def percentile(self, p: float) -> float | None:
        if not self._xs:
            return None
        return float(np.percentile(np.asarray(self._xs), p))

    def mean(self) -> float | None:
        if not self._count:
            return None
        # Exact mode reproduces numpy's pairwise summation bit-for-bit (the
        # identity tests compare summaries across serving paths); bounded
        # mode serves the O(1) streaming accumulator.
        if self._cap is None:
            return float(np.mean(self._xs))
        return self._total / self._count

    def total(self) -> float:
        if self._cap is None:
            return float(np.sum(self._xs)) if self._xs else 0.0
        return self._total

    def series(self) -> list[float]:
        """The raw samples in recording order — or, in bounded mode, the
        current reservoir (a uniform sample of everything observed)."""
        return list(self._xs)


@dataclass
class ServeMetrics:
    # Counters.
    submitted: int = 0
    admitted: int = 0
    rejected: int = 0
    completed: int = 0
    waves: int = 0
    prefill_jobs: int = 0
    decode_jobs: int = 0
    host_jobs: int = 0           # jobs the scheduler kept on the host
    slo_met: int = 0
    slo_missed: int = 0
    # Continuous-batching counters (DESIGN.md §6).
    mid_wave_admissions: int = 0  # requests admitted while others ran
    tokens_generated: int = 0
    goodput_completed: int = 0    # completed with SLO met (or no SLO)
    # Pipelined-serving counters (DESIGN.md §7).
    pipelined_prefills: int = 0   # prefills dispatched under in-flight work
    # Energy accounting (DESIGN.md §11): joules attributed to completed
    # jobs, accumulated from the fabric's deterministic closed-form pricing
    # on every serving path identically.
    energy_j: float = 0.0
    # Fault-tolerance counters (DESIGN.md §10).
    faults_crash: int = 0         # fabric crashes that hit this lane
    stalls: int = 0               # transient stall windows absorbed
    stall_cycles: float = 0.0     # cycles lost to stall windows
    skewed_jobs: int = 0          # jobs whose reported latency was poisoned
    orphaned: int = 0             # requests stranded by a crash on this lane
    requeued: int = 0             # recovered requests re-submitted here
    recovered: int = 0            # requeued requests actually re-served here
    restore_jobs: int = 0         # Eq.-1-priced KV-restore offloads
    dropped: int = 0              # orphans never recovered (naive drop)
    # Session-affinity counters (DESIGN.md §13).  All zero unless prefix
    # reuse is enabled — the affinity-off identity checks rely on that.
    prefix_hits: int = 0          # prefill waves that reused warm KV
    prefix_misses: int = 0        # warm-capable requests served cold
    prefix_hit_tokens: int = 0    # prompt tokens whose prefill was skipped
    prefix_handoffs: int = 0      # hits served via a cross-fabric KV copy
    preempted: int = 0            # running slots evicted for higher priority
    # Fabric-cycle recorders.
    latency_cycles: Recorder = field(default_factory=Recorder)
    ttft_cycles: Recorder = field(default_factory=Recorder)
    job_cycles: Recorder = field(default_factory=Recorder)
    # Continuous-batching series: queue delay per request (arrival ->
    # prefill start, cycles) and occupied-slot fraction per decode job.
    queue_delay_cycles: Recorder = field(default_factory=Recorder)
    slot_occupancy: Recorder = field(default_factory=Recorder)
    # Recovery series (DESIGN.md §10): requeue -> re-prefill delay per
    # recovered request (cycles) — the tax a crash adds on top of the
    # restore offload itself.
    recovery_delay_cycles: Recorder = field(default_factory=Recorder)
    # Pipelined-serving series (DESIGN.md §7), one point per job: host
    # cycles that ran hidden under another job's fabric execution, and
    # fabric idle cycles inserted before the job's execution (the pipeline
    # bubble double buffering is meant to squeeze out).
    overlap_cycles: Recorder = field(default_factory=Recorder)
    bubble_cycles: Recorder = field(default_factory=Recorder)
    # Wall-clock recorders (engine-attached runs only).
    step_wall_s: Recorder = field(default_factory=Recorder)
    dispatch_wall_s: Recorder = field(default_factory=Recorder)
    dispatch_bytes: int = 0
    dispatch_calls: int = 0
    # Clock span of the run (fabric cycles).
    t_start: float = 0.0
    t_end: float = 0.0

    # ------------------------------------------------------------------ #
    def record_dispatch(self, stats) -> None:
        """Accumulate one DispatchStats from the engine's operand placement."""
        self.dispatch_wall_s.add(stats.seconds)
        self.dispatch_bytes += stats.bytes_moved
        self.dispatch_calls += stats.num_host_calls

    def record_job_pipeline(self, job) -> None:
        """Accumulate one CompletedJob's overlap/bubble (pipelined loop)."""
        self.overlap_cycles.add(job.overlap)
        self.bubble_cycles.add(job.bubble)

    def span_cycles(self) -> float:
        return max(self.t_end - self.t_start, 1e-9)

    def summary(self) -> dict:
        span_s = self.span_cycles() / CYCLES_PER_SECOND
        slo_total = self.slo_met + self.slo_missed
        return {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "rejected": self.rejected,
            "completed": self.completed,
            "waves": self.waves,
            "jobs": {"prefill": self.prefill_jobs,
                     "decode": self.decode_jobs,
                     "host": self.host_jobs,
                     "restore": self.restore_jobs},
            "throughput_rps": self.completed / span_s,
            "goodput_rps": self.goodput_completed / span_s,
            "tokens_per_s": self.tokens_generated / span_s,
            "mid_wave_admissions": self.mid_wave_admissions,
            "latency_us": {
                "p50": _us(self.latency_cycles.percentile(50)),
                "p99": _us(self.latency_cycles.percentile(99)),
            },
            "ttft_us": {
                "p50": _us(self.ttft_cycles.percentile(50)),
                "p99": _us(self.ttft_cycles.percentile(99)),
            },
            "queue_delay_us": {
                "p50": _us(self.queue_delay_cycles.percentile(50)),
                "p99": _us(self.queue_delay_cycles.percentile(99)),
            },
            "slot_occupancy": {
                "mean": self.slot_occupancy.mean(),
                "p50": self.slot_occupancy.percentile(50),
            },
            "slo_attainment": (self.slo_met / slo_total
                               if slo_total else None),
            "faults": {
                "crashes": self.faults_crash,
                "stalls": self.stalls,
                "stall_cycles": self.stall_cycles,
                "skewed_jobs": self.skewed_jobs,
            },
            "recovery": {
                "orphaned": self.orphaned,
                "requeued": self.requeued,
                "recovered": self.recovered,
                "dropped": self.dropped,
                "restore_jobs": self.restore_jobs,
                "recovery_delay_us": {
                    "p50": _us(self.recovery_delay_cycles.percentile(50)),
                    "p99": _us(self.recovery_delay_cycles.percentile(99)),
                },
            },
            "pipeline": {
                "pipelined_prefills": self.pipelined_prefills,
                "overlap_total_cycles": self.overlap_cycles.total(),
                "overlap_mean_cycles": self.overlap_cycles.mean(),
                "bubble_total_cycles": self.bubble_cycles.total(),
            },
            "prefix": {
                "hits": self.prefix_hits,
                "misses": self.prefix_misses,
                "hit_tokens": self.prefix_hit_tokens,
                "handoffs": self.prefix_handoffs,
                "preempted": self.preempted,
            },
            "energy": {
                "joules": self.energy_j,
                "watts": self.energy_j / span_s,
                "tokens_per_joule": (self.tokens_generated / self.energy_j
                                     if self.energy_j > 0 else None),
            },
            "wall": {
                "steps": len(self.step_wall_s),
                "step_p50_ms": _ms(self.step_wall_s.percentile(50)),
                "step_total_s": self.step_wall_s.total(),
                "dispatch_total_s": self.dispatch_wall_s.total(),
                "dispatch_bytes": self.dispatch_bytes,
                "dispatch_calls": self.dispatch_calls,
            },
        }

    def format_summary(self) -> str:
        s = self.summary()
        lines = [
            f"requests: {s['submitted']} submitted, {s['admitted']} admitted,"
            f" {s['rejected']} rejected, {s['completed']} completed",
            f"jobs: {s['jobs']['prefill']} prefill + {s['jobs']['decode']} "
            f"decode offloads, {s['jobs']['host']} kept on host "
            f"({s['waves']} waves)",
            f"throughput: {s['throughput_rps']:.0f} req/s (virtual fabric), "
            f"goodput {s['goodput_rps']:.0f} req/s, "
            f"{s['tokens_per_s']:.0f} tok/s",
            f"latency: p50 {_fmt(s['latency_us']['p50'])} us, "
            f"p99 {_fmt(s['latency_us']['p99'])} us; "
            f"ttft p99 {_fmt(s['ttft_us']['p99'])} us; "
            f"queue delay p99 {_fmt(s['queue_delay_us']['p99'])} us",
        ]
        if len(self.slot_occupancy):
            lines.append(
                f"slots: mean occupancy "
                f"{100 * s['slot_occupancy']['mean']:.0f}%, "
                f"{s['mid_wave_admissions']} mid-wave admissions")
        if len(self.overlap_cycles):
            lines.append(
                f"pipeline: {s['pipeline']['pipelined_prefills']} overlapped "
                f"prefills, {s['pipeline']['overlap_total_cycles']:.0f} cy "
                f"hidden, {s['pipeline']['bubble_total_cycles']:.0f} cy "
                "bubble")
        if (self.faults_crash or self.stalls or self.skewed_jobs
                or self.orphaned or self.requeued or self.dropped):
            lines.append(
                f"faults: {self.faults_crash} crash(es), {self.stalls} "
                f"stall(s) ({self.stall_cycles:.0f} cy), "
                f"{self.skewed_jobs} skewed jobs; {self.orphaned} orphaned "
                f"-> {self.recovered} recovered ({self.restore_jobs} KV "
                f"restores), {self.dropped} dropped")
        if self.energy_j > 0:
            tpj = s["energy"]["tokens_per_joule"]
            line = (f"energy: {1e3 * s['energy']['joules']:.3f} mJ "
                    f"({s['energy']['watts']:.3f} W virtual)")
            if tpj is not None:
                line += f", {tpj:.0f} tok/J"
            lines.append(line)
        if self.prefix_hits or self.prefix_misses or self.preempted:
            lines.append(
                f"prefix: {self.prefix_hits} hits / {self.prefix_misses} "
                f"misses ({self.prefix_hit_tokens} tokens skipped, "
                f"{self.prefix_handoffs} handoffs); "
                f"{self.preempted} preempted")
        if s["slo_attainment"] is not None:
            lines.append(f"SLO attainment: {100 * s['slo_attainment']:.1f}% "
                         f"({self.slo_met}/{self.slo_met + self.slo_missed})")
        if s["wall"]["steps"]:
            lines.append(
                f"engine wall: {s['wall']['steps']} steps, "
                f"p50 {_fmt(s['wall']['step_p50_ms'])} ms/step, "
                f"dispatch {s['wall']['dispatch_calls']} calls / "
                f"{s['wall']['dispatch_bytes'] / 2**20:.1f} MiB")
        return "\n".join(lines)


class FleetMetrics:
    """Aggregate view over the per-fabric ``ServeMetrics`` of a fleet run.

    Each lane keeps its own full ``ServeMetrics`` (occupancy, overlap and
    bubble series, wall recorders, ...) — this class does not copy them, it
    merges the *request-level* outcomes (latency/TTFT samples, completion
    counters) into fleet totals and derives the two fleet-level health
    numbers the router A/B cares about (DESIGN.md §8):

      * ``imbalance`` — tail spread: how much of the fleet span the slowest
        fabric keeps running after the fastest finished,
        ``(max t_end - min t_end) / span``.  0 on a perfectly balanced
        fleet; on a heterogeneous fleet a naive router leaves the little
        fabrics draining long after the big one idles.
      * ``load_cv`` — coefficient of variation of per-fabric busy cycles
        (``job_cycles`` totals): dispersion of *work* (not request counts —
        a model-driven router deliberately sends more tokens to faster
        fabrics, so request-count balance is the wrong target).
    """

    def __init__(self, lanes: list[tuple[str, ServeMetrics]]):
        if not lanes:
            raise ValueError("a fleet needs at least one fabric")
        self.lanes = lanes

    # ------------------------------------------------------------------ #
    def _served(self) -> list[ServeMetrics]:
        """Lanes that actually ran work; a never-used lane's default
        ``t_start``/``t_end`` of 0.0 is not a real time and must not enter
        span or imbalance arithmetic."""
        served = [m for _, m in self.lanes if m.completed or len(m.job_cycles)]
        return served or [m for _, m in self.lanes]

    def span_cycles(self) -> float:
        metrics = self._served()
        t0 = min(m.t_start for m in metrics)
        t1 = max(m.t_end for m in metrics)
        return max(t1 - t0, 1e-9)

    def imbalance(self) -> float:
        """Tail spread of per-fabric finish times, as a span fraction
        (over the lanes that served work)."""
        ends = [m.t_end for m in self._served()]
        return (max(ends) - min(ends)) / self.span_cycles()

    def load_cv(self) -> float:
        """Coefficient of variation of per-fabric busy (job) cycles.

        Unlike :meth:`imbalance`, idle lanes count here: zero busy cycles
        is a *real* load of zero, and the dispersion should show it.
        """
        loads = np.array([m.job_cycles.total() for _, m in self.lanes])
        mean = loads.mean()
        return float(loads.std() / mean) if mean > 0 else 0.0

    def _merged(self, attr: str) -> Recorder:
        merged = Recorder()
        for _, m in self.lanes:
            for x in getattr(m, attr).series():
                merged.add(x)
        return merged

    def _total(self, attr: str) -> int:
        return sum(getattr(m, attr) for _, m in self.lanes)

    def summary(self) -> dict:
        span_s = self.span_cycles() / CYCLES_PER_SECOND
        latency = self._merged("latency_cycles")
        ttft = self._merged("ttft_cycles")
        slo_met, slo_missed = (self._total("slo_met"),
                               self._total("slo_missed"))
        return {
            "fabrics": len(self.lanes),
            "submitted": self._total("submitted"),
            "admitted": self._total("admitted"),
            "rejected": self._total("rejected"),
            "completed": self._total("completed"),
            "throughput_rps": self._total("completed") / span_s,
            "goodput_rps": self._total("goodput_completed") / span_s,
            "tokens_per_s": self._total("tokens_generated") / span_s,
            "latency_us": {"p50": _us(latency.percentile(50)),
                           "p99": _us(latency.percentile(99))},
            "ttft_us": {"p50": _us(ttft.percentile(50)),
                        "p99": _us(ttft.percentile(99))},
            "slo_attainment": (slo_met / (slo_met + slo_missed)
                               if slo_met + slo_missed else None),
            "faults": {
                "crashes": self._total("faults_crash"),
                "orphaned": self._total("orphaned"),
                "requeued": self._total("requeued"),
                "recovered": self._total("recovered"),
                "dropped": self._total("dropped"),
                "restore_jobs": self._total("restore_jobs"),
            },
            "prefix": {
                "hits": self._total("prefix_hits"),
                "misses": self._total("prefix_misses"),
                "hit_tokens": self._total("prefix_hit_tokens"),
                "handoffs": self._total("prefix_handoffs"),
                "preempted": self._total("preempted"),
            },
            "imbalance": self.imbalance(),
            "load_cv": self.load_cv(),
            "energy": {
                "joules": self._total("energy_j"),
                "watts": self._total("energy_j") / span_s,
                "tokens_per_joule": (
                    self._total("tokens_generated")
                    / self._total("energy_j")
                    if self._total("energy_j") > 0 else None),
            },
            "per_fabric": {
                name: {
                    "completed": m.completed,
                    "busy_cycles": m.job_cycles.total(),
                    "occupancy_mean": m.slot_occupancy.mean(),
                    "overlap_total_cycles": m.overlap_cycles.total(),
                    "t_end": m.t_end,
                    "energy_j": m.energy_j,
                    "tokens_per_joule": (m.tokens_generated / m.energy_j
                                         if m.energy_j > 0 else None),
                }
                for name, m in self.lanes
            },
        }

    def format_summary(self) -> str:
        s = self.summary()
        lines = [
            f"fleet: {s['fabrics']} fabrics, {s['submitted']} submitted, "
            f"{s['rejected']} rejected, {s['completed']} completed",
            f"throughput: {s['throughput_rps']:.0f} req/s (virtual), "
            f"goodput {s['goodput_rps']:.0f} req/s, "
            f"{s['tokens_per_s']:.0f} tok/s",
            f"latency: p50 {_fmt(s['latency_us']['p50'])} us, "
            f"p99 {_fmt(s['latency_us']['p99'])} us; "
            f"ttft p99 {_fmt(s['ttft_us']['p99'])} us",
            f"balance: imbalance {s['imbalance']:.2f} of span, "
            f"busy-cycle CV {s['load_cv']:.2f}",
        ]
        if s["energy"]["joules"] > 0:
            tpj = s["energy"]["tokens_per_joule"]
            line = (f"energy: {1e3 * s['energy']['joules']:.3f} mJ "
                    f"({s['energy']['watts']:.3f} W virtual)")
            if tpj is not None:
                line += f", {tpj:.0f} tok/J"
            lines.append(line)
        for name, f in s["per_fabric"].items():
            occ = ("n/a" if f["occupancy_mean"] is None
                   else f"{100 * f['occupancy_mean']:.0f}%")
            line = (f"  [{name}] {f['completed']} completed, "
                    f"{f['busy_cycles']:.0f} busy cy, occupancy {occ}")
            if f["tokens_per_joule"] is not None:
                line += f", {f['tokens_per_joule']:.0f} tok/J"
            lines.append(line)
        ft = s["faults"]
        if ft["crashes"] or ft["orphaned"] or ft["dropped"]:
            lines.append(
                f"faults: {ft['crashes']} crash(es), {ft['orphaned']} "
                f"orphaned -> {ft['recovered']} recovered "
                f"({ft['restore_jobs']} KV restores), "
                f"{ft['dropped']} dropped")
        if s["slo_attainment"] is not None:
            lines.append(f"SLO attainment: {100 * s['slo_attainment']:.1f}%")
        return "\n".join(lines)


def _us(cycles: float | None) -> float | None:
    return None if cycles is None else cycles / 1e3   # 1 GHz: cycles == ns


def _ms(seconds: float | None) -> float | None:
    return None if seconds is None else seconds * 1e3


def _fmt(x: float | None) -> str:
    return "n/a" if x is None else f"{x:.1f}"
