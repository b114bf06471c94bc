"""Fabric timing sources: where a scheduled job's measured runtime comes from.

A copy of ``repro/serve/fabric.py``; the simulated fabric's timelines and
jitter draws are bit-identical to the reference's.

The scheduler plans in the paper's cycle domain (Eq. 1 coefficients are
cycles), so the serving loop needs a *measured* cycle count per completed job
to (a) advance the open-loop virtual clock, (b) check SLO attainment, and
(c) feed the online calibrator.

Two sources:

  * ``SimulatedFabric`` — the Manticore discrete-event model
    (repro_torch.core.simulator), standing in for the paper's RTL measurements.
    Optional multiplicative jitter models measurement noise; deterministic
    per seed.
  * ``WallClockFabric`` — converts the measured wall-clock seconds of the
    real engine step (dispatch + kernel queueing + CreditCounterSync
    wait) to cycles at a nominal clock.  Used when the serving engine runs on real devices and the
    calibrator should track *that* hardware instead of the simulator.

Both speak the **asynchronous fabric protocol** the pipelined serving loop
(DESIGN.md §7) drives:

    handle = fabric.submit(m, n, t_submit=clock, ...)   # non-blocking
    fabric.ready(handle, now)                           # completion probe
    job    = fabric.complete(handle, ...)               # retire; CompletedJob

``SimulatedFabric.submit`` schedules the job on a persistent
:class:`repro_torch.core.engine.OffloadEngine` timeline (``buffering="double"``
lets the dispatch of job k+1 hide under the execution of job k), so the
handle already carries its resolved completion time.  ``WallClockFabric``
handles wrap the engine's *pending* (queued, not awaited) step: its kernels
are on the card's stream, the credit wait is deferred to ``complete`` — the
wall seconds measured there are the job's effective time.

The legacy blocking calls (``offload``/``host``) remain for the sequential
serving paths and price one isolated job via the closed form.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import simulator as sim
from repro_torch.core.engine import BUFFERING_MODES, OffloadEngine


@dataclass
class CompletedJob:
    """Uniform completion record of the async protocol (both fabrics)."""

    t_done: float        # absolute fabric-cycle completion time
    total: float         # blocking-equivalent runtime (start -> retire)
    effective: float     # completion-to-completion service time (α_eff domain)
    overlap: float = 0.0  # host cycles hidden under another job's execution
    bubble: float = 0.0   # fabric idle inserted before this execution
    energy: float = 0.0   # joules attributed to the job (DESIGN.md §11)


@dataclass
class WallClockHandle:
    """In-flight job of a WallClockFabric: measurement arrives at complete."""

    m: int
    n: int
    t_submit: float
    offload: bool = True
    probe: object = None          # optional callable -> bool (device ready?)
    meta: dict = field(default_factory=dict)


class SimulatedFabric:
    """Measured job runtimes from the Manticore cycle model."""

    name = "simulated"

    def __init__(self, *, hw: sim.HWParams = sim.HWParams(),
                 kernel: sim.KernelSpec = sim.DAXPY, multicast: bool = True,
                 dispatch: str | None = None, sync: str | None = None,
                 jitter_pct: float = 1.0, seed: int = 0,
                 num_clusters: int | None = None,
                 buffering: str = "single", tracer=None,
                 proc: str = "fabric",
                 dvfs: sim.DVFSState | str | None = None):
        # Fabric-size experiments: scale the interconnect parameters to a
        # fabric of ``num_clusters`` clusters (identity at the paper's 32).
        if num_clusters is not None:
            hw = sim.scaled_hw(num_clusters, hw)
        if buffering not in BUFFERING_MODES:
            raise ValueError(f"buffering must be one of {BUFFERING_MODES}, "
                             f"got {buffering!r}")
        self.hw = hw
        self.kernel = kernel
        # dispatch/sync (the DSE axes, DESIGN.md §3) take precedence over the
        # legacy two-design ``multicast`` flag.
        self.dispatch = dispatch or ("multicast" if multicast else "unicast")
        self.sync = sync or ("credit" if multicast else "poll")
        self.jitter_pct = jitter_pct
        self.buffering = buffering
        self._rng = np.random.default_rng(seed)
        self.proc = proc
        # Energy operating point (DESIGN.md §11): prices joules only — the
        # cycle model, the RNG draws, and every timeline are DVFS-invariant.
        self.dvfs = sim.dvfs_state(dvfs)
        # The async protocol's resource timeline, shared by every job this
        # fabric serves (descriptor buffering is a property of the fabric,
        # not of a job).  The engine inherits the tracer, so pipelined jobs
        # get per-phase spans on this fabric's host/fabric/sync tracks.
        self.engine = OffloadEngine(hw=hw, buffering=buffering,
                                    tracer=tracer, proc=proc, dvfs=self.dvfs)

    @classmethod
    def for_design(cls, point, *, jitter_pct: float = 1.0, seed: int = 0):
        """Fabric configured for a swept design point (repro.dse)."""
        from repro_torch.kernels.ops import get_kernel
        return cls(hw=point.hw, kernel=get_kernel(point.kernel_name),
                   dispatch=point.dispatch, sync=point.sync,
                   jitter_pct=jitter_pct, seed=seed,
                   buffering=getattr(point, "buffering", "single"))

    def _jitter(self, t: float) -> float:
        if not self.jitter_pct:
            return float(t)
        scale = 1.0 + self._rng.normal(0.0, self.jitter_pct / 100.0)
        return float(t) * max(scale, 0.5)

    def _jitter_scale(self) -> float:
        if not self.jitter_pct:
            return 1.0
        return max(1.0 + self._rng.normal(0.0, self.jitter_pct / 100.0), 0.5)

    # ---------------------------------------------------------------- #
    # Async protocol (pipelined serving, DESIGN.md §7)
    # ---------------------------------------------------------------- #
    def submit(self, m: int | None, n: int, *, t_submit: float,
               offload: bool = True):
        """Schedule one job on the engine timeline; returns its handle.

        The handle is the engine's fully-resolved
        :class:`~repro_torch.core.engine.JobRecord` (the simulator knows the
        future); jitter perturbs the execution phase only — dispatch and
        sync constants are host-side and deterministic.
        """
        return self.engine.submit(
            n, m_clusters=m, dispatch=self.dispatch, sync=self.sync,
            kernel=self.kernel, t_submit=t_submit, offload=offload,
            exec_scale=self._jitter_scale())

    def ready(self, handle, now: float) -> bool:
        return handle.t_done <= now

    def complete(self, handle) -> CompletedJob:
        return CompletedJob(t_done=handle.t_done, total=handle.total,
                            effective=handle.effective,
                            overlap=handle.overlap, bubble=handle.bubble,
                            energy=handle.energy)

    # ---------------------------------------------------------------- #
    # Legacy blocking protocol (sequential serving paths)
    # ---------------------------------------------------------------- #
    def offload(self, m: int, n: int) -> float:
        """Cycles for an offloaded job of n elements on m clusters."""
        return self._jitter(sim.offload_runtime(
            m, n, dispatch=self.dispatch, sync=self.sync, hw=self.hw,
            kernel=self.kernel))

    def host(self, n: int) -> float:
        """Cycles for the host to run the job itself (no offload)."""
        return self._jitter(sim.host_runtime(n, hw=self.hw,
                                             kernel=self.kernel))

    # ---------------------------------------------------------------- #
    # Energy pricing (DESIGN.md §11) — deterministic closed forms, shared
    # by every serving path.  Deliberately RNG-free: the jitter stream
    # draws exactly one normal per job on the cycle side, and energy
    # accounting must not perturb it (the cycles-only bit-identity).
    # ---------------------------------------------------------------- #
    def offload_energy(self, m: int, n: int) -> float:
        """Joules for an offloaded job of n elements on m clusters."""
        return sim.offload_energy(m, n, dispatch=self.dispatch,
                                  sync=self.sync, hw=self.hw,
                                  kernel=self.kernel, dvfs=self.dvfs)

    def host_energy(self, n: int) -> float:
        """Joules for the host to run the job itself (no offload)."""
        return sim.host_energy(n, hw=self.hw, kernel=self.kernel,
                               dvfs=self.dvfs)


class WallClockFabric:
    """Measured wall seconds of the real engine step, expressed in cycles."""

    name = "wallclock"

    def __init__(self, *, clock_hz: float = 1e9):
        self.clock_hz = clock_hz
        self._last_seconds: float | None = None

    def record(self, seconds: float) -> float:
        """Feed one measured step duration; returns it in cycles."""
        self._last_seconds = seconds
        return seconds * self.clock_hz

    # ---------------------------------------------------------------- #
    # Async protocol: the measurement arrives at complete() — the step's
    # kernels are queued, the credit wait is deferred.
    # ---------------------------------------------------------------- #
    def submit(self, m: int | None, n: int, *, t_submit: float,
               offload: bool = True, probe=None) -> WallClockHandle:
        return WallClockHandle(m=m or 1, n=n, t_submit=t_submit,
                               offload=offload, probe=probe)

    def ready(self, handle: WallClockHandle, now: float) -> bool:
        if handle.probe is None:
            return False        # unknown until the caller blocks on it
        return bool(handle.probe())

    def complete(self, handle: WallClockHandle,
                 wall_s: float | None = None) -> CompletedJob:
        """Retire an in-flight job with its measured wall seconds.

        ``wall_s`` is the host-observed duration of the step *excluding*
        time hidden under other in-flight work (dispatch seconds + residual
        blocking wait), i.e. already an effective measurement.
        """
        if wall_s is None:
            raise RuntimeError("WallClockFabric.complete needs the measured "
                               "wall seconds of the step (attach an engine)")
        cycles = self.record(wall_s)
        return CompletedJob(t_done=handle.t_submit + cycles, total=cycles,
                            effective=cycles)

    # ---------------------------------------------------------------- #
    def offload(self, m: int, n: int) -> float:  # pragma: no cover - passthru
        if self._last_seconds is None:
            raise RuntimeError("WallClockFabric.offload called before "
                               "record(); wire timed_wait() into the batcher")
        return self._last_seconds * self.clock_hz

    def host(self, n: int) -> float:  # pragma: no cover - passthrough
        return self.offload(1, n)
