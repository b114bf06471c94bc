"""Fleet-composition axis of the design-space explorer (DESIGN.md §8.3).

The port of ``repro/dse/fleet.py``, copied with its imports renamed: the
same results as the reference's on the same inputs.

The single-fabric sweep (``repro_torch.dse.runner``) asks which *one* fabric to
build; at fleet scale the question becomes how to *partition* a fixed
silicon budget: one big 32-cluster fabric, two mediums, four littles, or a
heterogeneous big+little mix?  Each composition is served end to end on the
same open-loop trace (``repro_torch.serve.serve_fleet`` — every fabric with its
own scaled hardware, its own Eq.-1 prior, its own online calibrator, behind
the model-driven router) and scored on the three fleet objectives:

    (throughput, p99 latency, watts)

with the Pareto front reported under (maximize, minimize, minimize) — the
fleet-level analogue of the (t_ref, cost) front of DESIGN.md §3.3, with the
power draw of actually *serving the trace* (DESIGN.md §11: per-phase joules
over the served span, at the composition's DVFS point) as the third axis.
``power_cap_w`` turns the sweep into the power-capped DSE: compositions
whose draw exceeds the cap are excluded before the front is formed.

Silicon area stays reported per composition (:func:`silicon_area` — the
static build-cost proxy, distinct from the operational watts axis): compute
area scales with the cluster count, the banked operand bus with its
*scaled* width (sub-linear, ``simulator.scaled_hw``), and every fabric pays
a fixed per-fabric increment for its own host core and fabric port — which
is why splitting a budget into many little fabrics costs more silicon than
one big one, and why the composition question is not answered by
throughput alone.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Iterator, Sequence

from repro_torch.core import simulator as sim
from repro_torch.serve import FleetConfig
from repro_torch.serve.fleet import ROUTER_POLICIES, serve_fleet
from repro_torch.serve.workload import WorkloadSpec

from .pareto import pareto_front

#: Per-fabric fixed cost: host core (CVA6) + completion unit + fabric port.
PER_FABRIC_COST = 0.20
#: Default compositions of the paper's 32-cluster budget (DESIGN.md §8.3).
DEFAULT_COMPOSITIONS = ((32,), (16, 16), (8, 8, 8, 8), (16, 8, 8))


def composition_name(sizes: Sequence[int]) -> str:
    """Compact composition label: ``2x16``, ``16+8+8``, ``1x32``."""
    sizes = tuple(sizes)
    if len(set(sizes)) == 1:
        return f"{len(sizes)}x{sizes[0]}"
    return "+".join(str(s) for s in sizes)


def fabric_cost(num_clusters: int, *, buffering: str = "double") -> float:
    """Silicon-cost proxy of one fleet fabric (extended design).

    ``design_cost`` (DESIGN.md §3.2) prices the reference 32-cluster fabric;
    this scales it to fabric granularity: compute area ~ cluster count,
    bus area ~ the *scaled* banked bus width (``scaled_hw`` — sub-linear,
    so four 8-cluster buses cost more aggregate bandwidth-silicon than one
    32-cluster bus), plus the extended design's multicast port (0.15) and
    credit counter (0.10), the double descriptor buffer (0.05), and the
    per-fabric host/port overhead (:data:`PER_FABRIC_COST`).
    """
    hw = sim.scaled_hw(num_clusters)
    cost = (num_clusters / sim.REFERENCE_CLUSTERS
            * (hw.cores_per_cluster / 8.0))
    cost += hw.bus_bytes_per_cycle / 96.0
    cost += 0.15 + 0.10                      # multicast port + credit unit
    if buffering == "double":
        cost += 0.05
    return cost + PER_FABRIC_COST


def silicon_area(sizes: Sequence[int], *,
                 buffering: str = "double") -> float:
    """Silicon-area proxy of a whole composition (sum over fabrics).

    The static build cost of the composition — what taping it out spends,
    as opposed to the operational watts axis the power-capped sweep
    optimizes (DESIGN.md §11).  Formerly named ``fleet_cost``.
    """
    return sum(fabric_cost(c, buffering=buffering) for c in sizes)


def fleet_cost(sizes: Sequence[int], *, buffering: str = "double") -> float:
    """Deprecated alias of :func:`silicon_area` (the old "cost" name)."""
    warnings.warn("fleet_cost() is deprecated; use silicon_area()",
                  DeprecationWarning, stacklevel=2)
    return silicon_area(sizes, buffering=buffering)


@dataclass(frozen=True)
class FleetDesign:
    """One point on the fleet-composition axis: sizes + routing policy
    + DVFS operating point (DESIGN.md §11)."""

    sizes: tuple[int, ...]
    router: str = "model"
    dvfs: str = "nominal"

    def __post_init__(self):
        if not self.sizes or any(s < 1 for s in self.sizes):
            raise ValueError("compositions need >= 1 cluster per fabric")
        if self.router not in ROUTER_POLICIES:
            raise ValueError(f"router must be one of {ROUTER_POLICIES}")
        if self.dvfs not in sim.DVFS_STATES:
            raise ValueError(f"dvfs must be one of "
                             f"{sorted(sim.DVFS_STATES)}, got {self.dvfs!r}")
        object.__setattr__(self, "sizes", tuple(int(s) for s in self.sizes))

    @property
    def name(self) -> str:
        tag = composition_name(self.sizes)
        if self.router != "model":
            tag = f"{tag} [{self.router}]"
        if self.dvfs != "nominal":
            tag = f"{tag} @{self.dvfs}"
        return tag

    @property
    def clusters(self) -> int:
        return sum(self.sizes)


@dataclass(frozen=True)
class FleetSpace:
    """Declarative fleet-composition axis under a fixed cluster budget."""

    compositions: tuple[tuple[int, ...], ...] = DEFAULT_COMPOSITIONS
    routers: tuple[str, ...] = ("model",)
    budget: int = sim.REFERENCE_CLUSTERS
    #: DVFS operating points swept per composition (DESIGN.md §11).
    dvfs_points: tuple[str, ...] = ("nominal",)

    def __post_init__(self):
        object.__setattr__(
            self, "compositions",
            tuple(tuple(int(s) for s in c) for c in self.compositions))
        over = [c for c in self.compositions if sum(c) > self.budget]
        if over:
            raise ValueError(f"compositions exceed the {self.budget}-cluster "
                             f"budget: {over}")
        bad = set(self.routers) - set(ROUTER_POLICIES)
        if bad:
            raise ValueError(f"invalid router policies {sorted(bad)}")
        bad_dvfs = set(self.dvfs_points) - set(sim.DVFS_STATES)
        if bad_dvfs:
            raise ValueError(f"invalid DVFS points {sorted(bad_dvfs)}")

    @property
    def size(self) -> int:
        return (len(self.compositions) * len(self.routers)
                * len(self.dvfs_points))

    def grid(self) -> Iterator[FleetDesign]:
        for sizes in self.compositions:
            for router in self.routers:
                for dvfs in self.dvfs_points:
                    yield FleetDesign(sizes=sizes, router=router, dvfs=dvfs)


@dataclass(frozen=True)
class FleetResult:
    """One evaluated composition: served trace -> fleet objectives."""

    design: FleetDesign
    throughput_rps: float
    p99_us: float
    cost: float                      # silicon_area (static build proxy)
    imbalance: float
    load_cv: float
    completed: int
    rejected: int
    calib_mape_max_pct: float        # worst per-fabric window MAPE (Eq. 2)
    #: Operational power objectives (DESIGN.md §11): mean draw over the
    #: served span at the design's DVFS point, and the efficiency headline.
    #: Additive defaults keep pre-energy pickles/constructions loadable.
    watts: float = 0.0
    tokens_per_joule: float | None = None
    summary: dict = field(repr=False, default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "design": {"sizes": list(self.design.sizes),
                       "router": self.design.router,
                       "dvfs": self.design.dvfs,
                       "name": self.design.name},
            "throughput_rps": self.throughput_rps,
            "p99_us": self.p99_us,
            "cost": self.cost,
            "imbalance": self.imbalance,
            "load_cv": self.load_cv,
            "completed": self.completed,
            "rejected": self.rejected,
            "calib_mape_max_pct": self.calib_mape_max_pct,
            "watts": self.watts,
            "tokens_per_joule": self.tokens_per_joule,
        }


def evaluate_fleet(design: FleetDesign, spec: WorkloadSpec, *,
                   pipeline: bool = True,
                   jitter_pct: float = 1.0) -> FleetResult:
    """Serve one composition on the trace; extract the fleet objectives."""
    out = serve_fleet(spec, config=FleetConfig(
              fleet=design.sizes, router=design.router, dvfs=design.dvfs,
                            pipeline=pipeline, jitter_pct=jitter_pct))
    s = out["metrics"].summary()
    mapes = [snap.window_mape_pct for snap in out["calibrations"]
             if snap.window_mape_pct is not None]
    # A composition that completes nothing (every request rejected by its
    # lanes' SLO admission) has no latency distribution: score it strictly
    # worst on the latency objective instead of crashing the front.
    p99 = s["latency_us"]["p99"]
    # The summary's watts divide joules by the *cycle-domain* span at the
    # nominal clock (the virtual time axis is DVFS-invariant); true wall
    # time scales inversely with the DVFS frequency, so rescale here.
    energy = s.get("energy", {})
    freq = sim.dvfs_state(design.dvfs).freq_scale
    return FleetResult(
        design=design,
        throughput_rps=s["throughput_rps"],
        p99_us=float(p99) if p99 is not None else float("inf"),
        cost=silicon_area(design.sizes,
                          buffering="double" if pipeline else "single"),
        imbalance=s["imbalance"],
        load_cv=s["load_cv"],
        completed=s["completed"],
        rejected=s["rejected"],
        calib_mape_max_pct=max(mapes) if mapes else -1.0,
        watts=float(energy.get("watts") or 0.0) * freq,
        tokens_per_joule=energy.get("tokens_per_joule"),
        summary=s,
    )


def sweep_fleets(space: FleetSpace | Sequence[FleetDesign],
                 spec: WorkloadSpec, *, pipeline: bool = True,
                 jitter_pct: float = 1.0) -> list[FleetResult]:
    """Evaluate every composition on the same trace (enumeration order)."""
    designs = (list(space.grid()) if isinstance(space, FleetSpace)
               else list(space))
    return [evaluate_fleet(d, spec, pipeline=pipeline,
                           jitter_pct=jitter_pct) for d in designs]


def fleet_objectives(r: FleetResult) -> tuple[float, float, float]:
    """Minimization vector: (-throughput, p99, watts) — DESIGN.md §11."""
    return (-r.throughput_rps, r.p99_us, r.watts)


def fleet_front(results: Sequence[FleetResult], *,
                power_cap_w: float | None = None) -> list[FleetResult]:
    """Pareto front under (max throughput, min p99, min watts).

    ``power_cap_w`` makes the sweep power-capped: any composition whose
    served draw exceeds the cap is excluded *before* the front forms — an
    over-cap design cannot re-enter by dominating on the other axes.
    """
    results = list(results)
    if power_cap_w is not None:
        results = [r for r in results if r.watts <= power_cap_w]
    return pareto_front(results, fleet_objectives)


def summarize_fleets(results: Sequence[FleetResult], *,
                     power_cap_w: float | None = None) -> str:
    """Human-readable composition table with front membership."""
    on_front = {id(r) for r in fleet_front(results,
                                           power_cap_w=power_cap_w)}
    lines = [f"{'fleet':<20} {'thr req/s':>10} {'p99 us':>8} {'watts':>8} "
             f"{'tok/J':>10} {'area':>6} {'imbal':>6} {'MAPE%':>6}  front"]
    for r in sorted(results, key=lambda r: -r.throughput_rps):
        over = (power_cap_w is not None and r.watts > power_cap_w)
        tpj = f"{r.tokens_per_joule:>10.0f}" if r.tokens_per_joule else \
            f"{'-':>10}"
        lines.append(
            f"{r.design.name:<20} {r.throughput_rps:>10.0f} "
            f"{r.p99_us:>8.1f} {r.watts:>8.3f} {tpj} {r.cost:>6.2f} "
            f"{r.imbalance:>6.2f} {r.calib_mape_max_pct:>6.2f}  "
            f"{'x (over cap)' if over else '*' if id(r) in on_front else ''}")
    return "\n".join(lines)
