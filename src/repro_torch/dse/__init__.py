"""Design-space exploration over the offload path (DESIGN.md §3).

The port of ``repro/dse/__init__.py``, copied with its imports renamed: the
same results as the reference's on the same inputs.

The paper publishes two design points — baseline (sequential dispatch +
polling) and extended (multicast + credit counter) — and a 47.9% co-design
speedup between them.  This package generalizes that comparison into a sweep:

    space.DesignSpace    — declarative axes: HWParams fields, dispatch mode,
                           sync mode, kernel (registry in
                           repro_torch.kernels.ops)
    runner.run_sweep     — parallel simulate-every-point runner; each design
                           gets its own Eq.-1 least-squares refit + MAPE
    pareto               — (runtime, cost) Pareto front, ranking, Eq.-3
                           deadline-feasible regions
    fleet.FleetSpace     — the fleet-composition axis (DESIGN.md §8.3): how
                           to partition a fixed cluster budget into fabrics
                           (1x32 | 2x16 | 4x8 | 16+8+8), each composition
                           served end to end and Pareto-scored on
                           (throughput, p99, watts) — optionally power-capped
                           and swept across DVFS points (DESIGN.md §11)

The CLI is ``python -m repro_torch.launch.dse``.  A swept design's
refitted model can be served directly:
``repro_torch.serve.serve_workload(design=point)`` schedules with that
design's coefficients instead of the paper's.
"""

from .fleet import (DEFAULT_COMPOSITIONS, FleetDesign, FleetResult,
                    FleetSpace, composition_name, evaluate_fleet,
                    fabric_cost, fleet_cost, fleet_front, fleet_objectives,
                    silicon_area, summarize_fleets, sweep_fleets)
from .pareto import (deadline_region, design_objectives, dominates,
                     feasible_ms, front, pareto_front, rank, summarize)
from .runner import (DEFAULT_M_GRID, DEFAULT_N_GRID, DesignResult,
                     baseline_grid, design_cost, design_grid, design_speedup,
                     evaluate_design, refit_design, run_sweep)
from .space import PAPER_SPACE, DesignPoint, DesignSpace

__all__ = [
    "DesignPoint", "DesignSpace", "PAPER_SPACE",
    "DesignResult", "run_sweep", "evaluate_design", "refit_design",
    "baseline_grid", "design_cost", "design_grid", "design_speedup",
    "DEFAULT_M_GRID", "DEFAULT_N_GRID",
    "dominates", "pareto_front", "front", "rank", "design_objectives",
    "feasible_ms", "deadline_region", "summarize",
    "DEFAULT_COMPOSITIONS", "FleetDesign", "FleetResult", "FleetSpace",
    "composition_name", "evaluate_fleet", "fabric_cost", "fleet_cost",
    "fleet_front", "fleet_objectives", "silicon_area", "summarize_fleets",
    "sweep_fleets",
]
