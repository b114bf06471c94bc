"""Parallel sweep runner: simulate every design point, refit Eq. 1 per design.

The port of ``repro/dse/runner.py``, copied with its imports renamed: the
same results as the reference's on the same inputs.

For each :class:`~repro_torch.dse.space.DesignPoint` the runner

  1. simulates the full (M, N) measurement grid on the discrete-event model
     (``repro_torch.core.simulator``) configured for that design — for
     double-buffered designs (DESIGN.md §7) the grid is the *steady-state
     back-to-back* per-job runtime from the event engine
     (``repro_torch.core.engine.steady_sweep``), since pipelined throughput is
     what the second descriptor slot buys,
  2. refits the analytical runtime model through the existing least-squares
     path — the 3-coefficient Eq. 1 :class:`OffloadModel` for multicast
     dispatch, the 4-coefficient :class:`LinearDispatchModel` (extra
     ``delta*M`` dispatch term) for sequential unicast — and records the fit's
     MAPE (Eq. 2) against the design's own simulator (for double-buffered
     designs the fitted constant is α_eff, accurate in the fabric-bound
     regime; host-bound cells are piecewise and inflate the reported MAPE —
     DESIGN.md §7),
  3. computes cross-design metrics: the speedup grid against the paper
     baseline (unicast + poll + single buffering on the space's base
     hardware, same kernel), the break-even problem size, and a relative
     silicon-cost proxy (DESIGN.md §3.2).

Designs are independent, so the sweep fans out over a process pool
(``workers > 1``); every input and result is a plain picklable dataclass.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import Iterable, Sequence

from repro_torch.core import decision, runtime_model
from repro_torch.core import engine as engine_mod
from repro_torch.core import simulator as sim
from repro_torch.core.runtime_model import LinearDispatchModel, OffloadModel
from repro_torch.kernels.ops import get_kernel

from .space import DesignPoint, DesignSpace

#: Default measurement grids — the paper's, extended with the Fig.-1-right
#: problem sizes so the 47.9% co-design point is inside every sweep.
DEFAULT_M_GRID = tuple(sim.PAPER_M_GRID)
DEFAULT_N_GRID = tuple(sorted(set(sim.PAPER_N_GRID_MODEL)
                              | set(sim.PAPER_N_GRID_SPEEDUP)))


def design_cost(point: DesignPoint) -> float:
    """Relative silicon-cost proxy of a design (DESIGN.md §3.2).

    Normalized so the paper baseline on default hardware costs 2.0: one unit
    each for the 96 B/cycle operand bus and the 8 worker cores per cluster,
    plus fixed increments for the multicast port (0.15), the credit-counter
    completion unit (0.10), and the second job-descriptor buffer (0.05 —
    a few hundred bytes of SRAM plus the queue logic, DESIGN.md §7).
    """
    hw = point.hw
    cost = hw.bus_bytes_per_cycle / 96.0 + hw.cores_per_cluster / 8.0
    if point.dispatch == "multicast":
        cost += 0.15
    if point.sync == "credit":
        cost += 0.10
    if point.buffering == "double":
        cost += 0.05
    return cost


def design_grid(point: DesignPoint, ms: Sequence[int],
                ns: Sequence[int]) -> dict:
    """Simulate the (M, N) runtime grid a design is scored and refit on.

    Single-buffered designs use the closed-form isolated-job runtime
    (``simulator.sweep``); double-buffered designs use the event engine's
    steady-state back-to-back per-job runtime (``engine.steady_sweep``) —
    the throughput a saturated offload stream sees (DESIGN.md §7).
    """
    kernel = get_kernel(point.kernel_name)
    if point.buffering == "double":
        return engine_mod.steady_sweep(list(ms), list(ns),
                                       dispatch=point.dispatch,
                                       sync=point.sync, hw=point.hw,
                                       kernel=kernel,
                                       buffering=point.buffering)
    return sim.sweep(list(ms), list(ns), dispatch=point.dispatch,
                     sync=point.sync, hw=point.hw, kernel=kernel)


def refit_design(
    point: DesignPoint,
    ms: Sequence[int] = DEFAULT_M_GRID,
    ns: Sequence[int] = DEFAULT_N_GRID,
    *,
    force_eq1: bool = False,
    runtimes: dict | None = None,
) -> tuple[OffloadModel | LinearDispatchModel, float]:
    """Least-squares refit of the analytical model for one design.

    Returns ``(model, mape_pct)`` where the MAPE is evaluated against the
    design's own simulator over the fit grid (paper Eq. 2).  ``force_eq1``
    fits the 3-coefficient Eq. 1 form even for unicast dispatch — used when
    the consumer (scheduler, Eq.-3 closed form) requires (alpha, beta,
    gamma).  ``runtimes`` (an ``{(m, n): cycles}`` grid already simulated for
    this design) skips re-simulation.
    """
    if runtimes is None:
        runtimes = design_grid(point, ms, ns)
    samples = [(m, n, float(t)) for (m, n), t in runtimes.items()]
    if point.dispatch == "multicast" or force_eq1:
        model: OffloadModel | LinearDispatchModel = runtime_model.fit(samples)
    else:
        model = runtime_model.fit_linear_dispatch(samples)
    return model, runtime_model.mape(model, samples)


@dataclass(frozen=True)
class DesignResult:
    """One evaluated design: simulated grid + refitted model + metrics."""

    point: DesignPoint
    model: OffloadModel | LinearDispatchModel
    mape_pct: float
    runtimes: dict            # (m, n) -> simulated cycles
    speedup_vs_baseline: dict  # (m, n) -> t_baseline / t_design
    best_speedup: float
    best_speedup_at: tuple[int, int]
    breakeven_n: int | None
    t_ref: float              # cycles at the reference point (max M, max N)
    cost: float               # relative silicon-cost proxy (design_cost)

    def as_dict(self) -> dict:
        return {
            "design": self.point.as_dict(),
            "model": dataclasses.asdict(self.model),
            "model_family": type(self.model).__name__,
            "mape_pct": self.mape_pct,
            "best_speedup": self.best_speedup,
            "best_speedup_at": list(self.best_speedup_at),
            "breakeven_n": self.breakeven_n,
            "t_ref": self.t_ref,
            "cost": self.cost,
        }


def evaluate_design(
    point: DesignPoint,
    ms: Sequence[int] = DEFAULT_M_GRID,
    ns: Sequence[int] = DEFAULT_N_GRID,
    *,
    baseline_runtimes: dict | None = None,
    base_hw: sim.HWParams | None = None,
) -> DesignResult:
    """Simulate + refit + score one design point."""
    kernel = get_kernel(point.kernel_name)
    runtimes = design_grid(point, ms, ns)
    if baseline_runtimes is None:
        baseline_runtimes = baseline_grid(point.kernel_name, ms, ns,
                                          hw=base_hw or sim.HWParams())
    model, mape_pct = refit_design(point, ms, ns, runtimes=runtimes)

    speedups = {mn: baseline_runtimes[mn] / t for mn, t in runtimes.items()
                if mn in baseline_runtimes}
    best_at = max(speedups, key=speedups.get)
    host = lambda n: sim.host_runtime(n, hw=point.hw, kernel=kernel)  # noqa: E731
    return DesignResult(
        point=point,
        model=model,
        mape_pct=mape_pct,
        runtimes=runtimes,
        speedup_vs_baseline=speedups,
        best_speedup=speedups[best_at],
        best_speedup_at=best_at,
        breakeven_n=decision.breakeven_n(model, host, list(ms)),
        t_ref=float(runtimes[(max(ms), max(ns))]),
        cost=design_cost(point),
    )


def baseline_grid(kernel_name: str, ms: Sequence[int], ns: Sequence[int],
                  *, hw: sim.HWParams = sim.HWParams()) -> dict:
    """Runtimes of the paper-baseline design (unicast+poll) for one kernel."""
    return sim.sweep(list(ms), list(ns), dispatch="unicast", sync="poll",
                     hw=hw, kernel=get_kernel(kernel_name))


def design_speedup(design: DesignPoint, reference: DesignPoint,
                   m_clusters: int, n_elems: int) -> float:
    """Speedup of one swept design over another at (M, N).

    The generalized :func:`repro_torch.core.simulator.speedup` with both operands
    drawn from the design space — e.g. the paper's 47.9% co-design point is
    ``design_speedup(extended, baseline, 32, 1024)`` with the two published
    designs, but any Pareto-front pair can be compared the same way.  Each
    operand is priced in its own serving regime: single-buffered designs at
    the closed-form isolated-job runtime, double-buffered designs at the
    steady-state pipelined per-job runtime (DESIGN.md §7).
    """
    cell = ([m_clusters], [n_elems])
    t_base = design_grid(reference, *cell)[(m_clusters, n_elems)]
    t_design = design_grid(design, *cell)[(m_clusters, n_elems)]
    return t_base / t_design


def run_sweep(
    space: DesignSpace | Iterable[DesignPoint],
    ms: Sequence[int] = DEFAULT_M_GRID,
    ns: Sequence[int] = DEFAULT_N_GRID,
    *,
    workers: int = 1,
    base_hw: sim.HWParams | None = None,
) -> list[DesignResult]:
    """Evaluate every design point; ``workers > 1`` uses a process pool.

    ``base_hw`` is the hardware the paper-baseline speedup reference runs on;
    it defaults to the space's ``base_hw`` (pass it explicitly when sweeping
    a bare point list drawn from a space with non-default base hardware,
    e.g. ``run_sweep(space.sample(8), base_hw=space.base_hw)``).

    Results come back in the space's enumeration order regardless of worker
    scheduling, so sweeps are reproducible byte-for-byte.
    """
    if isinstance(space, DesignSpace):
        points = list(space.grid())
        base_hw = base_hw or space.base_hw
    else:
        points = list(space)
        base_hw = base_hw or sim.HWParams()
    if not points:
        return []

    # One baseline grid per kernel, shared by every worker.
    baselines = {
        k: baseline_grid(k, ms, ns, hw=base_hw)
        for k in {p.kernel_name for p in points}
    }

    def _eval(p: DesignPoint) -> DesignResult:
        return evaluate_design(p, ms, ns,
                               baseline_runtimes=baselines[p.kernel_name])

    if workers > 1:
        try:
            # forkserver: workers fork from a clean single-threaded server
            # process, safe even when the parent already started threads or
            # initialised CUDA; a worker imports torch (through the kernel
            # registry) but runs only numpy and never touches a card.
            # Spawn-only platforms fall through to the default.
            try:
                ctx = multiprocessing.get_context("forkserver")
            except ValueError:
                ctx = multiprocessing.get_context()
            with ProcessPoolExecutor(max_workers=workers,
                                     mp_context=ctx) as pool:
                futures = [
                    pool.submit(evaluate_design, p, ms, ns,
                                baseline_runtimes=baselines[p.kernel_name])
                    for p in points
                ]
                return [f.result() for f in futures]
        except Exception:
            # Restricted / no-fork / unpicklable environments: the sweep is
            # correctness-critical, the parallelism is not — run it serially
            # (a genuine evaluate_design bug still reproduces and raises).
            pass
    return [_eval(p) for p in points]
