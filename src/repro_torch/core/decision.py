"""Offload decision problem (paper §III, Eq. 3).

A copy of ``repro/core/decision.py``; results are bit-identical to the
reference's.

Given the runtime model t̂(M, N) = alpha + beta*N + gamma*N/M, answer:

  * ``m_min_for_deadline``: the minimum number of clusters such that the
    offload meets a runtime constraint t̂(M) <= t_max (paper Eq. 3):

        M_min = ceil( gamma*N / (t_max - alpha - beta*N) )

  * ``best_m``: the M (from the available configurations) minimizing t̂,
  * ``should_offload``: offload vs. run-on-host decision for fine-grained jobs,
  * ``breakeven_n``: smallest problem size for which offloading wins.

These are exactly the decisions the paper motivates ("making a correct offload
decision is non-intuitive").
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Sequence

from .runtime_model import OffloadModel


@dataclass(frozen=True)
class OffloadDecision:
    offload: bool
    m: int | None
    t_offload: float | None
    t_host: float
    reason: str


def m_min_for_deadline(
    model: OffloadModel,
    n: int,
    t_max: float,
    *,
    m_max: int | None = None,
) -> int | None:
    """Paper Eq. 3. Returns None when the deadline is infeasible.

    Infeasible when the serial part alone exceeds the deadline
    (t_max <= alpha + beta*N), or when the required M exceeds the fabric.
    """
    slack = t_max - model.alpha - model.beta * n
    if slack <= 0:
        return None
    m_min = math.ceil(model.gamma * n / slack)
    m_min = max(m_min, 1)
    if m_max is not None and m_min > m_max:
        return None
    return m_min


def next_available_m(m_min: int, available: Sequence[int]) -> int | None:
    """Smallest configured cluster count >= m_min (hardware allocates in
    fixed quanta, e.g. powers of two)."""
    feasible = [m for m in available if m >= m_min]
    return min(feasible) if feasible else None


def best_m(model: OffloadModel, n: int, available: Sequence[int]) -> int:
    """argmin over the available cluster counts of the predicted runtime.

    For the multicast model t̂ is monotonically decreasing in M, so this is
    max(available); kept general so it also works for fitted baseline-style
    models passed through the same interface.
    """
    if not available:
        raise ValueError("no cluster configurations available")
    return min(available, key=lambda m: (float(model.predict(m, n)), m))


def should_offload(
    model: OffloadModel,
    host_model: Callable[[int], float],
    n: int,
    available: Sequence[int],
) -> OffloadDecision:
    """Offload iff the best offloaded runtime beats host execution."""
    t_host = float(host_model(n))
    m = best_m(model, n, available)
    t_off = float(model.predict(m, n))
    if t_off < t_host:
        return OffloadDecision(True, m, t_off, t_host,
                               f"offload to {m} clusters: "
                               f"{t_off:.0f} < host {t_host:.0f} cycles")
    return OffloadDecision(False, None, t_off, t_host,
                           f"run on host: {t_host:.0f} <= offload best "
                           f"{t_off:.0f} cycles")


def breakeven_n(
    model: OffloadModel,
    host_model: Callable[[int], float],
    available: Sequence[int],
    *,
    n_max: int = 1 << 20,
) -> int | None:
    """Smallest N (binary search) where offloading becomes profitable.

    Assumes t_host - t_off is monotonically increasing in N (true whenever the
    host's per-element cost exceeds the offload's serial per-element cost).
    """
    def wins(n: int) -> bool:
        return should_offload(model, host_model, n, available).offload

    if not wins(n_max):
        return None
    lo, hi = 1, n_max
    while lo < hi:
        mid = (lo + hi) // 2
        if wins(mid):
            hi = mid
        else:
            lo = mid + 1
    return lo


def deadline_report(
    model: OffloadModel,
    n: int,
    t_max: float,
    available: Sequence[int],
) -> dict:
    """Full Eq.-3 style report used by examples/offload_decision.py."""
    m_min = m_min_for_deadline(model, n, t_max, m_max=max(available))
    m_sel = next_available_m(m_min, available) if m_min is not None else None
    return {
        "n": n,
        "t_max": t_max,
        "m_min_raw": m_min,
        "m_selected": m_sel,
        "t_predicted": float(model.predict(m_sel, n)) if m_sel else None,
        "feasible": m_sel is not None,
    }
