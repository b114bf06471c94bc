"""Discrete-event cycle model of the Manticore offload path.

A copy of ``repro/core/simulator.py`` (numpy-free Python maths), so the
port's results are bit-identical to the reference's on the same inputs.

Reproduces the paper's RTL measurements (QuestaSim, 1 GHz => cycles == ns):

  * baseline design: sequential per-cluster dispatch + host-side polling,
  * extended design: multicast dispatch + credit-counter completion unit.

The two hardware features are independent axes (see DESIGN.md §3): dispatch
(``"unicast"`` | ``"multicast"``) and completion sync (``"poll"`` |
``"credit"``) can be combined freely, which is what the design-space explorer
(``repro.dse``) sweeps.  The legacy ``multicast`` boolean selects both ends of
the respective axes at once and remains the API of the paper's two published
design points.

The model is event-based per cluster (dispatch arrival, wakeup, shared-bus DMA
grant, compute, completion signal) rather than a closed-form formula, so that
integer work-splitting (``ceil``) produces the same kind of smooth-model error
the paper reports (<1% MAPE for Eq. 1).

Phase ordering note: after writing job arguments, the host executes a release
fence before clusters may read the operand arrays, so the operand-DMA phase
begins only once dispatch has completed (matches the additive structure of the
paper's measured runtimes and of Eq. 1).

Calibration (see DESIGN.md §2.1): the extended design's constant decomposes as
host_setup(250) + tx_multicast(12) + cluster_wakeup(40) + credit_irq(15) +
host_return_irq(50) = 367, the serial term is the 24 B/element DAXPY traffic
over a 96 B/cycle shared bus (= N/4), and the parallel term is 2.6 cycles per
element per worker core with 8 worker cores per cluster (= 2.6*N/(8*M)).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class HWParams:
    """Micro-architectural parameters of the Manticore offload path."""

    # Host side (CVA6).
    host_setup: int = 250          # job-descriptor construction + offload call
    host_return_irq: int = 50      # IRQ service + return to caller (extended)
    host_return_poll: int = 65     # busy-wait exit + return to caller (baseline)
    # Host -> cluster interconnect.
    tx_unicast: int = 9            # one mailbox/arg write transaction per cluster
    tx_multicast: int = 12         # one multicast transaction reaching all clusters
    # Cluster side.
    cluster_wakeup: int = 40       # mailbox IRQ -> handler fetch -> job entry
    cores_per_cluster: int = 8     # 9th core is the cluster DMA core
    # Shared operand bus (HBM-side), serving all clusters.
    bus_bytes_per_cycle: int = 96
    # Completion synchronization.
    credit_irq_latency: int = 15   # counter threshold hit -> host IRQ delivered
    poll_detect: int = 28          # baseline polling-loop detection latency
    # Host fallback execution (CVA6 runs the kernel itself).
    host_cycles_per_elem: float = 4.0
    host_loop_setup: int = 20
    # Energy model (DESIGN.md §11): static leakage + per-phase dynamic rates
    # at the nominal DVFS point.  Exec is priced per ACTIVE cluster; the
    # other phases are host/uncore-side and extent-independent.
    leak_w: float = 0.05           # static leakage of the offload path, W
    e_dispatch_pj: float = 9.0     # host uncore + interconnect, pJ/cycle
    e_exec_pj: float = 3.2         # per active cluster, pJ/cycle
    e_sync_pj: float = 1.1         # completion unit / polling loop, pJ/cycle
    e_host_pj: float = 6.5         # host scalar fallback, pJ/cycle


@dataclass(frozen=True)
class KernelSpec:
    """A data-parallel kernel, as seen by the offload runtime.

    ``host_cycles_per_elem`` overrides the host-fallback per-element cost for
    kernels whose scalar-core cost differs from ``HWParams``' default (e.g.
    the fused optimizer update with its rsqrt/div); ``None`` keeps the
    hardware default.
    """

    name: str = "daxpy"
    bytes_per_elem: int = 24       # daxpy: read x,y (16 B) + write y (8 B)
    cycles_per_elem: float = 2.6   # per worker core, inner-loop issue rate
    host_cycles_per_elem: float | None = None


DAXPY = KernelSpec()

#: Independent hardware axes of the offload path (DESIGN.md §3).
DISPATCH_MODES = ("unicast", "multicast")
SYNC_MODES = ("poll", "credit")


def _resolve_modes(multicast: bool | None, dispatch: str | None,
                   sync: str | None) -> tuple[str, str]:
    """Map the legacy ``multicast`` flag / explicit modes to (dispatch, sync)."""
    if dispatch is None:
        if multicast is None:
            raise TypeError("specify multicast=, or dispatch= and sync=")
        dispatch = "multicast" if multicast else "unicast"
    if sync is None:
        if multicast is None:
            raise TypeError("specify multicast=, or dispatch= and sync=")
        sync = "credit" if multicast else "poll"
    if dispatch not in DISPATCH_MODES:
        raise ValueError(f"dispatch must be one of {DISPATCH_MODES}, "
                         f"got {dispatch!r}")
    if sync not in SYNC_MODES:
        raise ValueError(f"sync must be one of {SYNC_MODES}, got {sync!r}")
    return dispatch, sync


# --------------------------------------------------------------------------- #
# Phase helpers — the single source of truth for per-phase cycle counts.
#
# ``simulate_offload`` (the closed-form single-job path) and the discrete-event
# offload engine (``repro.core.engine``) both compose these, which is what
# guarantees the engine reproduces the closed form exactly for isolated jobs
# (DESIGN.md §7).
# --------------------------------------------------------------------------- #

def dispatch_cycles(m_clusters: int, dispatch: str, hw: HWParams) -> int:
    """Host-side dispatch phase: descriptor construction + transactions.

    Multicast delivers descriptor+args to every cluster in one transaction;
    unicast pays one mailbox/arg write per cluster, sequentially.
    """
    if dispatch == "multicast":
        return hw.host_setup + hw.tx_multicast
    return hw.host_setup + m_clusters * hw.tx_unicast


def exec_schedule(
    m_clusters: int, n_elems: int, hw: HWParams, kernel: KernelSpec,
) -> tuple[list[int], list[int], list[int]]:
    """Fabric-side schedule relative to the release fence.

    Returns per-cluster ``(cluster_start, dma_done, compute_done)`` lists,
    all relative to the fence (the instant the final dispatch write has been
    published).  Every cluster has received its mailbox write by the fence
    (arrival <= fence by construction in both dispatch modes), so wakeup
    starts at the fence; the shared operand bus is then granted in cluster
    order.
    """
    work = _split_work(n_elems, m_clusters)
    cluster_start = [hw.cluster_wakeup] * m_clusters
    dma_done: list[int] = []
    bus_free = 0
    for i in range(m_clusters):
        grant = max(cluster_start[i], bus_free)
        dma = math.ceil(work[i] * kernel.bytes_per_elem
                        / hw.bus_bytes_per_cycle)
        bus_free = grant + dma
        dma_done.append(bus_free)
    compute_done = [
        dma_done[i] + _cluster_compute_cycles(work[i], hw, kernel)
        for i in range(m_clusters)
    ]
    return cluster_start, dma_done, compute_done


def exec_cycles(m_clusters: int, n_elems: int, hw: HWParams,
                kernel: KernelSpec) -> int:
    """Fabric-busy cycles of one job: fence -> last cluster's compute done."""
    _, _, compute_done = exec_schedule(m_clusters, n_elems, hw, kernel)
    return max(compute_done)


def sync_cycles(sync: str, hw: HWParams) -> tuple[int, int]:
    """(completion-signal latency, host return handling) for a sync mode."""
    if sync == "credit":
        return hw.credit_irq_latency, hw.host_return_irq
    return hw.poll_detect, hw.host_return_poll


# --------------------------------------------------------------------------- #
# Energy model (DESIGN.md §11) — every phase cycle count prices to joules.
#
# The cycle model is DVFS-invariant: a DVFS state rescales the time base
# (frequency) and the energy (dynamic ~ V^2, leakage ~ V x time), never the
# cycle counts, so all cycle-domain results are bit-identical across DVFS
# states.  ``phase_energy`` is the single pricing primitive; the closed-form
# ``offload_energy`` and the engine's per-job accounting both compose it from
# the same cycle counts, which is what makes the engine == closed-form energy
# identity exact for isolated single-buffered jobs (mirroring the cycles
# identity above).
# --------------------------------------------------------------------------- #

#: The RTL measurement clock (QuestaSim @ 1 GHz => cycles == ns) — the time
#: base that converts cycle counts to wall seconds at the nominal DVFS point.
CLOCK_HZ = 1.0e9


@dataclass(frozen=True)
class DVFSState:
    """One operating point of the fabric's frequency/voltage axis.

    ``freq_scale`` multiplies the clock (cycles take ``1/freq_scale`` of
    their nominal wall time); ``volt_scale`` multiplies supply voltage, so
    dynamic energy scales with ``volt_scale**2`` and leakage *power* with
    ``volt_scale`` (linear body-effect approximation, as in the lumos MPSoC
    model).  Cycle counts never change.
    """

    name: str = "nominal"
    freq_scale: float = 1.0
    volt_scale: float = 1.0


#: Identity operating point: energy at the HWParams rates, time at CLOCK_HZ.
DVFS_NOMINAL = DVFSState()

#: The swept DVFS axis (an MPSoC-ish eco/nominal/turbo ladder).
DVFS_STATES = {
    "eco": DVFSState("eco", freq_scale=0.60, volt_scale=0.80),
    "nominal": DVFS_NOMINAL,
    "turbo": DVFSState("turbo", freq_scale=1.25, volt_scale=1.15),
}


def dvfs_state(state: "DVFSState | str | None") -> DVFSState:
    """Resolve a DVFS operating point from a name (CLI) or pass one through."""
    if state is None:
        return DVFS_NOMINAL
    if isinstance(state, DVFSState):
        return state
    if state not in DVFS_STATES:
        raise ValueError(f"dvfs must be one of {sorted(DVFS_STATES)}, "
                         f"got {state!r}")
    return DVFS_STATES[state]


def wall_seconds(cycles: float, dvfs: DVFSState = DVFS_NOMINAL) -> float:
    """Wall-clock seconds a cycle count occupies at a DVFS operating point."""
    return cycles / (dvfs.freq_scale * CLOCK_HZ)


def phase_energy(cycles: float, rate_pj: float, hw: HWParams,
                 dvfs: DVFSState = DVFS_NOMINAL, active: int = 1) -> float:
    """Joules of one phase: dynamic switching + static leakage.

    ``rate_pj`` is the phase's dynamic energy per cycle at nominal voltage;
    ``active`` multiplies it for phases that occupy several units at once
    (exec across M clusters).  Leakage is the whole offload path's static
    power integrated over the phase's wall time — attributed per phase, so
    for the sequential phases of one isolated job the sum equals leakage
    over the job's total runtime.
    """
    dynamic = cycles * active * rate_pj * dvfs.volt_scale ** 2 * 1e-12
    leakage = hw.leak_w * dvfs.volt_scale * wall_seconds(cycles, dvfs)
    return dynamic + leakage


def offload_energy(
    m_clusters: int,
    n_elems: int,
    *,
    multicast: bool | None = None,
    dispatch: str | None = None,
    sync: str | None = None,
    hw: HWParams = HWParams(),
    kernel: KernelSpec = DAXPY,
    dvfs: DVFSState = DVFS_NOMINAL,
) -> float:
    """Closed-form joules for one offload — the Eq.-1 energy twin.

    Sums the three phase energies in dispatch/exec/sync order from the same
    cycle helpers the engine schedules with, so the engine's per-job energy
    reproduces this exactly for isolated single-buffered jobs.
    """
    dispatch, sync = _resolve_modes(multicast, dispatch, sync)
    d = dispatch_cycles(m_clusters, dispatch, hw)
    e = exec_cycles(m_clusters, n_elems, hw, kernel)
    signal, ret = sync_cycles(sync, hw)
    return (phase_energy(d, hw.e_dispatch_pj, hw, dvfs)
            + phase_energy(e, hw.e_exec_pj, hw, dvfs, active=m_clusters)
            + phase_energy(signal + ret, hw.e_sync_pj, hw, dvfs))


def host_energy(n_elems: int, *, hw: HWParams = HWParams(),
                kernel: KernelSpec = DAXPY,
                dvfs: DVFSState = DVFS_NOMINAL) -> float:
    """Joules for the host (CVA6) to run the kernel itself — no offload."""
    return phase_energy(host_runtime(n_elems, hw=hw, kernel=kernel),
                        hw.e_host_pj, hw, dvfs)


@dataclass
class OffloadTrace:
    """Cycle-level breakdown of one simulated offload."""

    total: int = 0
    dispatch_done: int = 0
    cluster_start: list = field(default_factory=list)
    dma_done: list = field(default_factory=list)
    compute_done: list = field(default_factory=list)
    makespan: int = 0
    sync_done: int = 0
    phases: dict = field(default_factory=dict)
    #: Joules per accounting phase {dispatch, exec, sync} (DESIGN.md §11).
    energies: dict = field(default_factory=dict)
    #: Total joules of the offload (sum of ``energies`` in phase order).
    energy: float = 0.0


def _split_work(n: int, m: int) -> list[int]:
    """Balanced split of ``n`` elements over ``m`` clusters (first get the rest)."""
    base, rem = divmod(n, m)
    return [base + (1 if i < rem else 0) for i in range(m)]


def _cluster_compute_cycles(n_cluster: int, hw: HWParams, kernel: KernelSpec) -> int:
    """Compute cycles for one cluster: elements split over worker cores."""
    if n_cluster == 0:
        return 0
    per_core = math.ceil(n_cluster / hw.cores_per_cluster)
    return math.ceil(kernel.cycles_per_elem * per_core)


def simulate_offload(
    m_clusters: int,
    n_elems: int,
    *,
    multicast: bool | None = None,
    dispatch: str | None = None,
    sync: str | None = None,
    hw: HWParams = HWParams(),
    kernel: KernelSpec = DAXPY,
    dvfs: DVFSState = DVFS_NOMINAL,
) -> OffloadTrace:
    """Simulate one offload of ``kernel`` over ``n_elems`` to ``m_clusters``.

    ``multicast=True`` models the paper's extended design (multicast dispatch +
    credit-counter completion); ``False`` models the baseline (sequential
    dispatch + polling).  ``dispatch``/``sync`` select the two axes
    independently for design-space exploration (DESIGN.md §3); when given,
    they take precedence over ``multicast``.  ``dvfs`` prices the energy
    side only — cycle counts are DVFS-invariant (DESIGN.md §11).
    """
    dispatch, sync = _resolve_modes(multicast, dispatch, sync)
    if m_clusters < 1:
        raise ValueError("need at least one cluster")
    if n_elems < 1:
        raise ValueError("need at least one element")

    tr = OffloadTrace()

    # --- Phase 1: dispatch -------------------------------------------------
    # Release fence: operand arrays become visible to clusters only after the
    # final dispatch write has completed, so every cluster's wakeup starts at
    # the fence regardless of when its own mailbox write arrived.
    tr.dispatch_done = fence = dispatch_cycles(m_clusters, dispatch, hw)

    # --- Phase 2+3: wakeup + operand DMA on the shared bus + compute -------
    # Bus grants are arbitrated in cluster order; each cluster requests the
    # bus once it has woken (the fence has been published by then).
    start, dma, comp = exec_schedule(m_clusters, n_elems, hw, kernel)
    tr.cluster_start = [fence + c for c in start]
    tr.dma_done = [fence + c for c in dma]
    tr.compute_done = [fence + c for c in comp]
    tr.makespan = max(tr.compute_done)

    # --- Phase 4: completion synchronization -------------------------------
    # Credit counter: last increment trips the threshold; IRQ to host.
    # Polling: the host busy-waits on per-cluster done flags instead.
    signal, ret = sync_cycles(sync, hw)
    tr.sync_done = tr.makespan + signal
    tr.total = tr.sync_done + ret

    tr.phases = {
        "dispatch": tr.dispatch_done,
        "wakeup_dma": max(tr.dma_done) - tr.dispatch_done,
        "compute": tr.makespan - max(tr.dma_done),
        "sync": tr.total - tr.makespan,
    }
    # Energy side (DESIGN.md §11): price the three accounting phases from the
    # same cycle counts; exec = fence -> last compute done across M clusters.
    tr.energies = {
        "dispatch": phase_energy(fence, hw.e_dispatch_pj, hw, dvfs),
        "exec": phase_energy(max(comp), hw.e_exec_pj, hw, dvfs,
                             active=m_clusters),
        "sync": phase_energy(signal + ret, hw.e_sync_pj, hw, dvfs),
    }
    tr.energy = (tr.energies["dispatch"] + tr.energies["exec"]
                 + tr.energies["sync"])
    return tr


def offload_runtime(
    m_clusters: int,
    n_elems: int,
    *,
    multicast: bool | None = None,
    dispatch: str | None = None,
    sync: str | None = None,
    hw: HWParams = HWParams(),
    kernel: KernelSpec = DAXPY,
) -> int:
    """Total cycles for one offload (convenience wrapper)."""
    return simulate_offload(
        m_clusters, n_elems, multicast=multicast, dispatch=dispatch,
        sync=sync, hw=hw, kernel=kernel
    ).total


def host_runtime(n_elems: int, *, hw: HWParams = HWParams(),
                 kernel: KernelSpec = DAXPY) -> int:
    """Cycles for the host (CVA6) to run the kernel itself — no offload."""
    per_elem = (kernel.host_cycles_per_elem
                if kernel.host_cycles_per_elem is not None
                else hw.host_cycles_per_elem)
    return hw.host_loop_setup + math.ceil(per_elem * n_elems)


def speedup(
    m_clusters: int,
    n_elems: int,
    *,
    hw: HWParams = HWParams(),
    kernel: KernelSpec = DAXPY,
    base_dispatch: str = "unicast",
    base_sync: str = "poll",
    base_hw: HWParams | None = None,
    base_kernel: KernelSpec | None = None,
    dispatch: str = "multicast",
    sync: str = "credit",
) -> float:
    """Speedup of one design over another at (M, N).

    With the defaults this is the paper's Fig.-1-right comparison (extended
    multicast+credit design over the unicast+poll baseline on the same
    hardware/kernel).  Both operands accept the same ``dispatch``/``sync``/
    ``hw``/``kernel`` axes as :func:`sweep`; the result is
    ``t_base / t_design``, so any DSE design pair (``repro.dse``'s
    ``design_speedup``) can be expressed, not just the two legacy points.
    Note ``hw``/``kernel`` apply to BOTH operands unless ``base_hw``/
    ``base_kernel`` override the reference side — the legacy same-hardware
    comparison; pass both explicitly for a cross-hardware pair.
    """
    t_base = offload_runtime(m_clusters, n_elems, dispatch=base_dispatch,
                             sync=base_sync, hw=base_hw or hw,
                             kernel=base_kernel or kernel)
    t_ext = offload_runtime(m_clusters, n_elems, dispatch=dispatch,
                            sync=sync, hw=hw, kernel=kernel)
    return t_base / t_ext


def sweep(
    ms: list[int],
    ns: list[int],
    *,
    multicast: bool | None = None,
    dispatch: str | None = None,
    sync: str | None = None,
    hw: HWParams = HWParams(),
    kernel: KernelSpec = DAXPY,
) -> dict[tuple[int, int], int]:
    """Runtime for every (M, N) pair — the paper's measurement grid."""
    return {
        (m, n): offload_runtime(m, n, multicast=multicast, dispatch=dispatch,
                                sync=sync, hw=hw, kernel=kernel)
        for m in ms
        for n in ns
    }


# The paper's measurement grids.
PAPER_M_GRID = [1, 2, 4, 8, 16, 32]
PAPER_N_GRID_MODEL = [256, 512, 768, 1024]      # Eq. 2 validation grid
PAPER_N_GRID_SPEEDUP = [1024, 2048, 4096, 8192]  # Fig. 1 right problem sizes
#: Fit grid for the overlap-aware effective-α model: problem sizes whose
#: execution phase exceeds the host's per-job work at every M of the paper
#: grid, so steady-state periods stay in the (linear) fabric-bound regime
#: (DESIGN.md §7).
PIPELINE_N_GRID = [2048, 4096, 6144, 8192]


#: The paper's published fabric size (288 cores = 32 clusters + host):
#: ``scaled_hw`` is the identity at this reference point.
REFERENCE_CLUSTERS = 32


def extent_grid(num_clusters: int) -> tuple[int, ...]:
    """The configurable parallel extents of a fabric of ``num_clusters``.

    Hardware allocates clusters in power-of-two quanta (the paper's M grid
    1..32 at the reference size); a non-power-of-two fabric additionally
    exposes its full size as the top extent.  This is the ``available_m``
    a fleet lane's scheduler plans over (DESIGN.md §8).
    """
    if num_clusters < 1:
        raise ValueError("need at least one cluster")
    grid = []
    m = 1
    while m <= num_clusters:
        grid.append(m)
        m *= 2
    if grid[-1] != num_clusters:
        grid.append(num_clusters)
    return tuple(grid)


def scaled_hw(num_clusters: int, hw: HWParams = HWParams()) -> HWParams:
    """HWParams for a fabric of ``num_clusters`` clusters.

    The paper's numbers are measured at 32 clusters (288 cores); fabric-size
    experiments scale the interconnect with the cluster count:

      * ``tx_multicast`` — the multicast tree gains a pipeline stage per
        doubling of its fan-out (one extra cycle per level beyond/below the
        reference depth);
      * ``cluster_wakeup`` — the wakeup IRQ distribution network is a tree
        with the same depth scaling (2 cycles per level: request + grant);
      * ``credit_irq_latency`` — the credit-counter reduction tree likewise
        grows/shrinks a cycle per level;
      * ``bus_bytes_per_cycle`` — the shared operand bus is banked with the
        fabric: doubling the clusters adds ~half a reference bus of banked
        bandwidth (sub-linear — bank conflicts and arbitration eat the
        rest), so per-cluster bandwidth *shrinks* as the fabric grows, which
        is the wakeup/DMA contention the event model then serializes.
      * ``leak_w`` — static leakage splits half host/uncore (size-invariant)
        and half fabric (proportional to cluster count), so a little fabric
        leaks less but never below the host floor (DESIGN.md §11).

    ``num_clusters == 32`` returns the published parameters unchanged.
    Per-cluster parameters (cores, unicast mailbox write) are size-invariant.
    """
    if num_clusters < 1:
        raise ValueError("need at least one cluster")
    levels = math.log2(num_clusters / REFERENCE_CLUSTERS)
    depth_delta = int(round(levels))               # tree depth change
    scale = num_clusters / REFERENCE_CLUSTERS
    bus = max(1, round(hw.bus_bytes_per_cycle * (1 + (scale - 1) * 0.5)))
    return replace(
        hw,
        tx_multicast=max(1, hw.tx_multicast + depth_delta),
        cluster_wakeup=max(1, hw.cluster_wakeup + 2 * depth_delta),
        credit_irq_latency=max(1, hw.credit_irq_latency + depth_delta),
        bus_bytes_per_cycle=bus,
        leak_w=hw.leak_w * (0.5 + 0.5 * scale),
    )
