"""Roofline-generalized offload planner (the paper's Eq. 1/Eq. 3 at pod scale).

A copy of ``repro/core/planner.py`` (it imports no JAX), plus
``H100_SXM``, the card's counterpart of the reference's ``TPU_V5E``.
``TPU_V5E`` stays the default and holds the TPU's data-sheet numbers.

The paper models an offloaded job as

    t̂(M, N) = alpha + beta*N + gamma*N/M

(constant overhead + serial term + parallel term). At TPU-pod scale the same
structure holds per training/serving step, with the terms instantiated from
hardware datasheet numbers and compiled-module statistics:

    alpha     -> step dispatch overhead (one multicast host call; the baseline
                 sequential dispatch adds a per-device term, exactly like the
                 paper's baseline design),
    beta*N    -> host->fabric input bytes over the ingest link (serial),
    gamma*N/M -> max(FLOPs / (M * peak), HBM bytes / (M * bw))  [parallel],
    + t_coll(M) -> collective bytes over ICI (the term with no Manticore
                 analogue; on a pod the reduction/gather traffic scales with
                 the sharding, so the planner accounts for it explicitly).

``choose_extent`` then answers the paper's offload-decision problem — how many
devices to give a job, or whether to run it on the host at all — using the
same argmin / deadline-inversion logic as ``repro_torch.core.decision``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence


@dataclass(frozen=True)
class ChipSpec:
    """Datasheet numbers for one accelerator chip (defaults: TPU v5e)."""

    name: str = "tpu-v5e"
    peak_flops: float = 197e12      # bf16 FLOP/s
    hbm_bw: float = 819e9           # B/s
    ici_bw: float = 50e9            # B/s per link
    hbm_bytes: float = 16e9         # capacity
    # Host-side offload overheads (the alpha of Eq. 1, measured at the
    # jax dispatch layer; see benchmarks/dispatch_microbench.py).
    step_launch_s: float = 100e-6   # one jitted-step dispatch (multicast)
    per_device_dispatch_s: float = 25e-6  # baseline sequential extra, per dev
    host_ingest_bw: float = 25e9    # B/s host->fabric (PCIe-class, serial)
    # Board power envelope (W/chip) for energy-at-bound estimates
    # (DESIGN.md §11): a cell running at its binding roofline term draws at
    # most the TDP, so bound_s * chips * tdp_w upper-bounds its joules.
    tdp_w: float = 200.0


TPU_V5E = ChipSpec()

#: NVIDIA H100 SXM5 80GB at its 700 W power limit.  Rates are the data
#: sheet's: dense bf16 989.4 TFLOP/s, HBM3 3.35 TB/s, NVLink 4 450 GB/s per
#: direction, PCIe Gen5 x16 64 GB/s host ingest.  The two host overheads
#: were measured by ``chip_smoke.py`` (phase 12) on NVIDIA H100 80GB HBM3,
#: 700.00 W: ``step_launch_s`` is the median queue-plus-credit time of an
#: empty step (``MulticastDispatcher.timed_put`` of one int32 token, then
#: ``CreditCounterSync.timed_wait``); ``per_device_dispatch_s`` the median
#: extra ``SequentialDispatcher`` put of one more leaf.
H100_SXM = ChipSpec(
    name="h100-sxm",
    peak_flops=989.4e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    hbm_bytes=80 * 2**30,
    step_launch_s=302.16e-6,          # NVIDIA H100 80GB HBM3, 700.00 W
    per_device_dispatch_s=20.72e-6,   # NVIDIA H100 80GB HBM3, 700.00 W
    host_ingest_bw=64e9,
    tdp_w=700.0,
)


@dataclass(frozen=True)
class JobStats:
    """Per-step statistics of one offloadable job (from cost_analysis / HLO)."""

    name: str
    flops: float
    hbm_bytes: float
    host_in_bytes: float = 0.0
    # Collective bytes as a function of the parallel extent M. For a fixed
    # compiled module this is a constant; for planning it scales with M.
    coll_bytes: Callable[[int], float] | None = None

    def coll(self, m: int) -> float:
        return float(self.coll_bytes(m)) if self.coll_bytes else 0.0


@dataclass(frozen=True)
class RooflineTerms:
    """The three §Roofline terms, in seconds, for a given (job, extent)."""

    t_compute: float
    t_memory: float
    t_collective: float
    t_overhead: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound(self) -> float:
        """Step-time lower bound: overlapped execution => max of the terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def additive(self) -> float:
        """Pessimistic (no-overlap) estimate, Eq.-1 style."""
        return (self.t_overhead + self.t_compute + self.t_memory
                + self.t_collective)


def roofline(stats: JobStats, m: int, chip: ChipSpec = TPU_V5E) -> RooflineTerms:
    """The three roofline terms for running ``stats`` on ``m`` chips."""
    return RooflineTerms(
        t_compute=stats.flops / (m * chip.peak_flops),
        t_memory=stats.hbm_bytes / (m * chip.hbm_bw),
        t_collective=stats.coll(m) / (m * chip.ici_bw),
        t_overhead=chip.step_launch_s + stats.host_in_bytes / chip.host_ingest_bw,
    )


def step_time(stats: JobStats, m: int, chip: ChipSpec = TPU_V5E,
              *, multicast: bool = True, overlap: bool = True) -> float:
    """Predicted step time — the pod-scale instantiation of Eq. 1."""
    terms = roofline(stats, m, chip)
    alpha = chip.step_launch_s
    if not multicast:
        alpha += m * chip.per_device_dispatch_s
    serial = stats.host_in_bytes / chip.host_ingest_bw
    parallel = terms.bound if overlap else (
        terms.t_compute + terms.t_memory + terms.t_collective)
    return alpha + serial + parallel


def choose_extent(
    stats: JobStats,
    candidates: Sequence[int],
    chip: ChipSpec = TPU_V5E,
    *,
    deadline_s: float | None = None,
    multicast: bool = True,
) -> dict:
    """Offload decision at pod scale (paper Eq. 3 analogue).

    Returns the extent minimizing predicted step time, plus — when a deadline
    is given — the *minimum* extent meeting it (the paper's M_min).
    """
    if not candidates:
        raise ValueError("no extents to choose from")
    times = {m: step_time(stats, m, chip, multicast=multicast)
             for m in candidates}
    best = min(times, key=lambda m: (times[m], m))
    m_min = None
    if deadline_s is not None:
        feasible = sorted(m for m in candidates if times[m] <= deadline_s)
        m_min = feasible[0] if feasible else None
    return {"best_m": best, "t_best": times[best], "m_min": m_min,
            "times": times}


def mfu(stats: JobStats, m: int, step_seconds: float,
        chip: ChipSpec = TPU_V5E, *, model_flops: float | None = None) -> float:
    """Model-FLOPs utilization given an (estimated or measured) step time."""
    useful = model_flops if model_flops is not None else stats.flops
    return useful / (step_seconds * m * chip.peak_flops)
