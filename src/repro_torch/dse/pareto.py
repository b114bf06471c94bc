"""Pareto front, ranking, and deadline-feasibility over sweep results.

The port of ``repro/dse/pareto.py``, copied with its imports renamed: the
same results as the reference's on the same inputs.

The co-design question the paper motivates — "which dispatch/sync/bus/cluster
combination wins for kernel K under a deadline?" — has no single winner: a
wider bus is faster and costlier, the credit counter is faster and slightly
larger.  So the explorer reports the *front* of mutually non-dominated
designs under (runtime, cost) minimization (DESIGN.md §3.3), plus an Eq.-3
deadline-feasibility map per design via ``repro_torch.core.decision``.
"""

from __future__ import annotations

from typing import Callable, Sequence

from repro_torch.core import decision
from repro_torch.core.runtime_model import OffloadModel

from .runner import DesignResult


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """True iff objective vector ``a`` Pareto-dominates ``b`` (minimize all):
    no worse in every objective and strictly better in at least one."""
    if len(a) != len(b):
        raise ValueError("objective vectors differ in length")
    return all(x <= y for x, y in zip(a, b)) and any(x < y
                                                     for x, y in zip(a, b))


def pareto_front(items: Sequence, key: Callable[[object], Sequence[float]],
                 ) -> list:
    """Items whose ``key(item)`` objective vector no other item dominates.

    Duplicated objective vectors are all kept (none dominates its equal).
    Order of the input is preserved.
    """
    vecs = [tuple(key(it)) for it in items]
    return [
        it for i, it in enumerate(items)
        if not any(dominates(vecs[j], vecs[i])
                   for j in range(len(items)) if j != i)
    ]


def design_objectives(r: DesignResult) -> tuple[float, float]:
    """Default objective vector: (reference runtime, silicon-cost proxy)."""
    return (r.t_ref, r.cost)


def front(results: Sequence[DesignResult]) -> list[DesignResult]:
    """Pareto front of a sweep under (t_ref, cost) minimization.

    Runtimes are only comparable between designs running the *same* kernel,
    so mixed-kernel sweeps get one front per kernel (unioned, input order
    preserved).
    """
    kernels = {r.point.kernel_name for r in results}
    if len(kernels) <= 1:
        return pareto_front(results, design_objectives)
    keep: set[int] = set()
    for k in kernels:
        sub = [r for r in results if r.point.kernel_name == k]
        keep |= {id(r) for r in pareto_front(sub, design_objectives)}
    return [r for r in results if id(r) in keep]


def rank(results: Sequence[DesignResult], *,
         by: str = "t_ref") -> list[DesignResult]:
    """Sweep results sorted best-first; ``by`` is 't_ref', 'best_speedup',
    'cost', or 'mape_pct'."""
    reverse = by == "best_speedup"     # larger is better only for speedup
    return sorted(results, key=lambda r: getattr(r, by), reverse=reverse)


def feasible_ms(model, n: int, t_max: float,
                available: Sequence[int]) -> list[int]:
    """Configured cluster counts meeting the deadline under ``model``.

    Uses the Eq.-3 closed form for the 3-coefficient model; for richer model
    families (e.g. LinearDispatchModel, where more clusters can *hurt*) it
    falls back to evaluating every configured extent.
    """
    if isinstance(model, OffloadModel):
        m_min = decision.m_min_for_deadline(model, n, t_max,
                                            m_max=max(available))
        return [] if m_min is None else [m for m in available if m >= m_min]
    return [m for m in available
            if float(model.predict(m, n)) <= t_max]


def deadline_region(result: DesignResult, ns: Sequence[int], t_max: float,
                    available: Sequence[int]) -> dict[int, int | None]:
    """Per problem size, the smallest feasible extent (None = infeasible) —
    the design's deadline-feasible region for a runtime budget ``t_max``.

    Only for Eq.-1 models does feasibility extend to every larger extent;
    under a LinearDispatchModel the dispatch term can push large M back over
    the deadline — use :func:`feasible_ms` for the full set.
    """
    region: dict[int, int | None] = {}
    for n in ns:
        ok = feasible_ms(result.model, n, t_max, available)
        region[n] = min(ok) if ok else None
    return region


def summarize(results: Sequence[DesignResult], *,
              top: int = 8) -> str:
    """Human-readable sweep summary: ranked table with front membership."""
    on_front = {id(r) for r in front(results)}
    lines = [f"{'design':<44} {'t_ref':>7} {'best-spdup':>10} "
             f"{'breakeven':>9} {'MAPE%':>6} {'cost':>5}  front"]
    for r in rank(results)[:top]:
        b = "-" if r.breakeven_n is None else str(r.breakeven_n)
        lines.append(
            f"{r.point.name:<44} {r.t_ref:>7.0f} "
            f"{r.best_speedup:>9.3f}x {b:>9} {r.mape_pct:>6.2f} "
            f"{r.cost:>5.2f}  {'*' if id(r) in on_front else ''}")
    return "\n".join(lines)
