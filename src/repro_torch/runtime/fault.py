"""Fault tolerance: deterministic fault injection plus the supervised step
loop (credit-counter health checks, checkpoint/restart, straggler detection
and preemption handling).

The port of ``repro/runtime/fault.py``.  ``FaultEvent`` and
``FaultInjector`` are numpy and are copied as they are; the supervisor
reads the port's credit counter (``repro_torch.core.sync``) and saves
through the port's ``CheckpointManager``.

``FaultInjector`` — a deterministic, seedable schedule of faults against the
*virtual* engine timeline (fabric cycles).  Three fault kinds, one per
failure mode the fleet recovery path must survive (DESIGN.md §10):

  * ``crash`` — the fabric halts at the next job boundary at or after ``t``;
    every in-flight and queued request on the lane is orphaned and the lane
    never serves again.
  * ``stall`` — a transient outage window ``[t, t + duration)``: the lane
    freezes (no dispatch, no progress) until the window passes.
  * ``skew`` — calibrator poisoning: while ``[t, t + duration)`` is active,
    *reported* job latencies are scaled by ``factor`` before they reach the
    online calibrator and the drift telemetry.  The true timeline is
    untouched — only the model's measurement channel lies.

Faults fire at scheduled engine-timeline points but take effect at job/loop
boundaries.

``StepSupervisor`` — the training-loop supervisor.  The credit counter is
the detection mechanism: every step returns a device scalar that equals
the device count iff the step's outputs are finite.  ``credits <
threshold`` means a poisoned (NaN/Inf) output — the supervisor rolls back
to the last checkpoint and skips the offending batch.  Stragglers (wall
time above ``straggler_factor`` x EMA) are logged; SIGTERM/SIGINT
checkpoint and exit cleanly with a resumable state.

The port's train step updates its state in place (``launch/steps.py``), so
a poisoned step has already overwritten the state it was given: a rollback
needs a checkpoint.  A supervisor therefore saves one at ``start_step``,
blocking, before its first step, so that a poisoned step always has a state
to roll back to.  Where the reference carries on from the state before the
poisoned step, the port carries on from the last checkpoint; both skip the
batch.  The rollback restores into the state's own tensors, so a compiled
train step (``launch.compile.CompiledStep``), which holds the parameters
and moments at their addresses, goes on replaying its graph on them.

The supervisor's checkpoint import is lazy so the injector stays
importable on its own.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - type-only import
    from repro_torch.ckpt import CheckpointManager

#: The fault kinds the injector understands (see module docstring).
FAULT_KINDS = ("crash", "stall", "skew")

#: Default crash-detection lag in fabric cycles: the fleet notices a dead
#: lane one health-check period after the halt, not instantaneously.  At the
#: paper's 1 GHz virtual clock this is 50 us — generous for a credit-counter
#: interrupt, tight for a polling watchdog.
DETECTION_CYCLES = 50_000.0


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault against a lane's engine timeline."""

    kind: str                 # one of FAULT_KINDS
    lane: int                 # fleet lane index (0 for single-fabric runs)
    t: float                  # fabric cycles at which the fault fires
    duration: float = 0.0     # window length for stall/skew (cycles)
    factor: float = 1.0       # latency multiplier for skew

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {FAULT_KINDS})")
        if self.lane < 0 or self.t < 0 or self.duration < 0:
            raise ValueError(f"negative lane/t/duration in {self}")
        if self.kind in ("stall", "skew") and self.duration <= 0:
            raise ValueError(f"{self.kind} fault needs duration > 0: {self}")
        if self.kind == "skew" and self.factor == 1.0:
            raise ValueError(f"skew fault with factor 1.0 is a no-op: {self}")

    @property
    def end(self) -> float:
        return self.t + self.duration


class FaultInjector:
    """Deterministic, seedable fault schedule over the virtual timeline.

    The schedule is fixed at construction (sorted by (t, lane, kind)) — the
    same events always produce the same timeline, and ``random(seed=s)``
    produces the same schedule for the same arguments.  The batcher and the
    fleet only *read* the schedule through the accessors below; nothing here
    mutates, so one injector can price a fault-free A/B re-run for free.
    """

    def __init__(self, events: list[FaultEvent] | tuple[FaultEvent, ...] = (),
                 *, detection_cycles: float = DETECTION_CYCLES):
        self.events: tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.t, e.lane, e.kind)))
        crashes = [e for e in self.events if e.kind == "crash"]
        by_lane: dict[int, float] = {}
        for e in crashes:
            by_lane.setdefault(e.lane, e.t)   # earliest crash wins
        self._crash_t = by_lane
        self.detection_cycles = float(detection_cycles)

    # -- construction -----------------------------------------------------

    @classmethod
    def parse(cls, spec: str, *, horizon: float | None = None,
              num_lanes: int | None = None, seed: int = 0,
              detection_cycles: float = DETECTION_CYCLES) -> "FaultInjector":
        """Build an injector from a ``--faults`` CLI spec.

        Grammar (comma-separated items)::

            KIND@LANE:T[+DUR][xFACTOR]      e.g. crash@1:0.45
                                                 stall@0:0.2+0.1
                                                 skew@2:0.3+0.4x3.5
            random:N                        N seeded random faults

        ``T`` and ``DUR`` values <= 1.0 are fractions of ``horizon`` (the
        trace length in cycles — required in that case); larger values are
        absolute cycles.  ``random:N`` needs ``horizon`` and ``num_lanes``.
        """
        events: list[FaultEvent] = []

        def _cycles(v: float, what: str) -> float:
            if v <= 1.0:
                if horizon is None:
                    raise ValueError(
                        f"fractional {what} {v} needs a horizon "
                        f"(absolute cycles are values > 1.0)")
                return v * horizon
            return v

        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if item.startswith("random:"):
                if horizon is None or num_lanes is None:
                    raise ValueError("random:N needs horizon and num_lanes")
                n = int(item.split(":", 1)[1])
                events.extend(cls.random(
                    num_faults=n, num_lanes=num_lanes, horizon=horizon,
                    seed=seed).events)
                continue
            try:
                kind, rest = item.split("@", 1)
                lane_s, t_s = rest.split(":", 1)
                factor = 1.0
                if "x" in t_s:
                    t_s, fac_s = t_s.split("x", 1)
                    factor = float(fac_s)
                dur = 0.0
                if "+" in t_s:
                    t_s, dur_s = t_s.split("+", 1)
                    dur = _cycles(float(dur_s), "duration")
                t = _cycles(float(t_s), "time")
                lane = int(lane_s)
            except ValueError as exc:
                if "needs a horizon" in str(exc):
                    raise
                raise ValueError(
                    f"bad fault spec item {item!r} "
                    f"(expected KIND@LANE:T[+DUR][xFACTOR])") from exc
            events.append(FaultEvent(kind, lane, t, dur, factor))
        return cls(events, detection_cycles=detection_cycles)

    @classmethod
    def random(cls, *, num_faults: int, num_lanes: int, horizon: float,
               seed: int = 0,
               kinds: tuple[str, ...] = FAULT_KINDS,
               detection_cycles: float = DETECTION_CYCLES) -> "FaultInjector":
        """Seeded random schedule: same (args, seed) -> same timeline."""
        rng = np.random.default_rng(seed)
        events = []
        for _ in range(num_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            lane = int(rng.integers(num_lanes))
            t = float(rng.uniform(0.1, 0.8)) * horizon
            dur = float(rng.uniform(0.02, 0.15)) * horizon
            factor = float(rng.uniform(2.0, 6.0))
            if kind == "crash":
                dur, factor = 0.0, 1.0
            events.append(FaultEvent(kind, lane, t, dur, factor))
        return cls(events, detection_cycles=detection_cycles)

    # -- accessors (read-only; the batcher polls these at job boundaries) --

    def __len__(self) -> int:
        return len(self.events)

    def for_lane(self, lane: int) -> tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.lane == lane)

    def crashed_lanes(self) -> tuple[int, ...]:
        return tuple(sorted(self._crash_t))

    def crash_time(self, lane: int) -> float | None:
        """Scheduled crash time for ``lane`` (None = never crashes)."""
        return self._crash_t.get(lane)

    def detect_time(self, lane: int) -> float | None:
        """When the fleet *notices* the crash: crash + detection lag."""
        t = self._crash_t.get(lane)
        return None if t is None else t + self.detection_cycles

    def stall_end(self, lane: int, now: float) -> float | None:
        """End of a stall window containing ``now``, else None.

        Windows are half-open ``[t, t+dur)``; back-to-back windows chain
        (the caller re-polls after advancing to the returned end).
        """
        for e in self.events:
            if e.kind == "stall" and e.lane == lane and e.t <= now < e.end:
                return e.end
        return None

    def skew_factor(self, lane: int, now: float) -> float:
        """Latency-report multiplier active at ``now`` (1.0 = honest)."""
        f = 1.0
        for e in self.events:
            if e.kind == "skew" and e.lane == lane and e.t <= now < e.end:
                f *= e.factor
        return f


@dataclass
class SupervisorConfig:
    ckpt_every: int = 50
    straggler_factor: float = 3.0
    ema_alpha: float = 0.2
    max_restarts: int = 3
    handle_signals: bool = False


@dataclass
class SupervisorReport:
    steps_done: int = 0
    restarts: int = 0
    faults: list = field(default_factory=list)
    stragglers: list = field(default_factory=list)
    preempted: bool = False
    final_metrics: dict = field(default_factory=dict)
    #: Seconds of each completed step: the step function's host time plus
    #: the credit wait (what the straggler EMA reads).
    step_seconds: list = field(default_factory=list)


class StepSupervisor:
    """Runs (state, batch) -> (state, metrics) steps under supervision."""

    def __init__(self, step_fn: Callable, ckpt: CheckpointManager,
                 cfg: SupervisorConfig = SupervisorConfig(), *,
                 credit_threshold: int | None = None):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.cfg = cfg
        self.credit_threshold = credit_threshold
        self._preempt = False
        self._rollback_saved = False
        if cfg.handle_signals:
            signal.signal(signal.SIGTERM, self._on_signal)
            signal.signal(signal.SIGINT, self._on_signal)

    def _on_signal(self, *_):
        self._preempt = True

    def _check_credits(self, metrics: dict) -> None:
        from repro_torch.core.sync import FaultDetected
        credits = metrics.get("credits")
        if credits is None or self.credit_threshold is None:
            return
        got = int(credits)  # blocks on ONE device scalar — the "interrupt"
        if got != self.credit_threshold:
            raise FaultDetected(
                f"credits {got} != threshold {self.credit_threshold}")

    def run(self, state: Any, batches, num_steps: int, *,
            start_step: int = 0, shardings: Any = None,
            mesh=None) -> tuple[Any, SupervisorReport]:
        """Run steps ``start_step .. num_steps - 1``; returns (state, report).

        A rollback restores the last checkpoint into the tensors of the
        state the poisoned step was given (``restore_checkpoint``), so the
        returned state holds the same tensors.  ``shardings`` is passed to
        that restore: the device of any leaf that is not a tensor, or with
        a ``DeviceMesh`` as ``mesh``, the state's spec tree.
        """
        from repro_torch.core.sync import FaultDetected
        rep = SupervisorReport()
        ema = None
        step = start_step
        restarts = 0
        if not self._rollback_saved:
            # The step updates the state in place: keep a rollback point.
            self.ckpt.save(step, state, {"step": step}, blocking=True)
            self._rollback_saved = True
        while step < num_steps:
            if self._preempt:
                self.ckpt.save(step, state, {"preempted": True},
                               blocking=True)
                rep.preempted = True
                break
            batch = next(batches)
            t0 = time.perf_counter()
            try:
                state_new, metrics = self.step_fn(state, batch)
                self._check_credits(metrics)
            except FaultDetected as e:
                rep.faults.append({"step": step, "error": str(e)})
                restarts += 1
                rep.restarts = restarts
                if restarts > self.cfg.max_restarts:
                    raise
                # Roll back to the last good checkpoint, into the state's
                # own tensors; skip this batch.
                state, step, _ = self.ckpt.restore_latest(
                    state, shardings=shardings, mesh=mesh)
                continue
            dt = time.perf_counter() - t0
            if ema is not None and dt > self.cfg.straggler_factor * ema:
                rep.stragglers.append({"step": step, "seconds": dt,
                                       "ema": ema})
            rep.step_seconds.append(dt)
            ema = dt if ema is None else \
                (1 - self.cfg.ema_alpha) * ema + self.cfg.ema_alpha * dt
            state = state_new
            rep.final_metrics = {k: v for k, v in metrics.items()}
            step += 1
            rep.steps_done += 1
            if step % self.cfg.ckpt_every == 0:
                self.ckpt.save(step, state, {"step": step})
        self.ckpt.wait()
        return state, rep
