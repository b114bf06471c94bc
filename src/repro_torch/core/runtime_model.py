"""Analytical offload-runtime model (paper Eq. 1) and its validation (Eq. 2).

A copy of ``repro/core/runtime_model.py``; results are bit-identical to the
reference's.

    t̂_off(M, N) = alpha + beta * N + gamma * N / M

alpha  : constant offload overhead (dispatch + wakeup + sync + host return),
beta   : serial per-element term (shared operand-bus bandwidth),
gamma  : parallel per-element term (per-cluster compute), divided by M.

The paper instantiates (alpha, beta, gamma) = (367, 1/4, 2.6/8) for the DAXPY
kernel on the extended (multicast + credit-counter) design and validates <1%
MAPE.  Here the coefficients can also be *fitted* from (M, N, t) samples —
simulated or measured — by linear least squares, since the model is linear in
its coefficients with features (1, N, N/M).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np


@dataclass(frozen=True)
class OffloadModel:
    """t̂(M, N) = alpha + beta*N + gamma*N/M  [cycles]."""

    alpha: float
    beta: float
    gamma: float

    def predict(self, m: int | np.ndarray, n: int | np.ndarray) -> np.ndarray:
        m = np.asarray(m, dtype=np.float64)
        n = np.asarray(n, dtype=np.float64)
        return self.alpha + self.beta * n + self.gamma * n / m

    def serial_fraction(self, m: int, n: int) -> float:
        """Amdahl serial fraction: overhead + serial term vs total at M=m."""
        t = float(self.predict(m, n))
        return (self.alpha + self.beta * n) / t

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return (f"t̂(M,N) = {self.alpha:.1f} + {self.beta:.4f}*N"
                f" + {self.gamma:.4f}*N/M")


#: The paper's published model for the extended design (Eq. 1).
PAPER_MODEL = OffloadModel(alpha=367.0, beta=0.25, gamma=2.6 / 8.0)


def fit(samples: Iterable[tuple[int, int, float]]) -> OffloadModel:
    """Least-squares fit of (alpha, beta, gamma) from (M, N, t) samples.

    The model is linear in the coefficients: t = [1, N, N/M] @ [a, b, g].
    """
    samples = list(samples)
    if len(samples) < 3:
        raise ValueError("need >= 3 samples to fit 3 coefficients")
    a = np.array([[1.0, n, n / m] for m, n, _ in samples], dtype=np.float64)
    y = np.array([t for _, _, t in samples], dtype=np.float64)
    coef, *_ = np.linalg.lstsq(a, y, rcond=None)
    return OffloadModel(alpha=float(coef[0]), beta=float(coef[1]),
                        gamma=float(coef[2]))


def fit_pinned(samples: Iterable[tuple[int, int, float]],
               prior: OffloadModel) -> OffloadModel:
    """Single-extent refit: pin what the window identifies, keep the rest.

    A window whose samples all share one extent M0 makes the (1, N, N/M)
    design rank-deficient — the window identifies only the *level* (alpha)
    and the *at-M0 slope* (beta + gamma/M0), never how runtime trades off
    against M.  Fit those two identifiable components by least squares and
    inherit the unidentifiable cross-extent curvature (gamma) from the
    prior: predictions at M0 match the window exactly (which is all the
    window can speak for), while extent planning keeps the prior's
    M-structure instead of a min-norm artifact.
    """
    samples = list(samples)
    ms = {m for m, _, _ in samples}
    if len(ms) != 1:
        raise ValueError("fit_pinned requires a single-extent window")
    ns = {n for _, n, _ in samples}
    if len(ns) < 2:
        raise ValueError("need >= 2 distinct N to fit level + slope")
    (m0,) = ms
    a = np.array([[1.0, n] for _, n, _ in samples], dtype=np.float64)
    y = np.array([t - prior.gamma * n / m0 for _, n, t in samples],
                 dtype=np.float64)
    coef, *_ = np.linalg.lstsq(a, y, rcond=None)
    return OffloadModel(alpha=float(coef[0]), beta=float(coef[1]),
                        gamma=prior.gamma)


def mape(model: OffloadModel, samples: Iterable[tuple[int, int, float]]) -> float:
    """Mean absolute percentage error over (M, N, t) samples (paper Eq. 2).

    Samples with ``t <= 0`` are skipped: a non-positive measured runtime is
    a clock glitch, and the percentage error against it is undefined (the
    unguarded division used to raise ZeroDivisionError even though upstream
    filters — e.g. ``OnlineCalibrator.observe`` — normally drop them).
    """
    samples = [s for s in samples if s[2] > 0]
    if not samples:
        raise ValueError("no positive-runtime samples")
    errs = [
        abs(t - float(model.predict(m, n))) / t for m, n, t in samples
    ]
    return 100.0 * sum(errs) / len(errs)


def mape_by_n(
    model: OffloadModel,
    samples: Iterable[tuple[int, int, float]],
) -> dict[int, float]:
    """Paper Eq. 2: MAPE over all M configurations, reported per problem size."""
    by_n: dict[int, list[tuple[int, int, float]]] = {}
    for m, n, t in samples:
        by_n.setdefault(n, []).append((m, n, t))
    return {n: mape(model, group) for n, group in sorted(by_n.items())}


@dataclass(frozen=True)
class EnergyModel:
    """Closed-form energy twin of Eq. 1 (DESIGN.md §11) [joules].

        ê(M, N) = alpha_j + delta_j*M + beta_j*N + eta_j*M*N + gamma_j*N/M

    The basis follows from pricing the Eq.-1 phases: dispatch contributes a
    constant (+M for unicast), exec dynamic energy is M clusters times the
    exec cycles (wakeup*M + bus*N*M + compute*N terms), and leakage over the
    exec cycles re-introduces the N and N/M runtime terms.  Linear in its
    coefficients with features (1, M, N, M*N, N/M), so it fits by least
    squares and validates with the same ``mape`` as the runtime model.
    """

    alpha_j: float
    delta_j: float
    beta_j: float
    eta_j: float
    gamma_j: float

    def predict(self, m: int | np.ndarray, n: int | np.ndarray) -> np.ndarray:
        m = np.asarray(m, dtype=np.float64)
        n = np.asarray(n, dtype=np.float64)
        return (self.alpha_j + self.delta_j * m + self.beta_j * n
                + self.eta_j * m * n + self.gamma_j * n / m)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return (f"ê(M,N) = {self.alpha_j:.3g} + {self.delta_j:.3g}*M"
                f" + {self.beta_j:.3g}*N + {self.eta_j:.3g}*M*N"
                f" + {self.gamma_j:.3g}*N/M")


def fit_energy(samples: Iterable[tuple[int, int, float]]) -> EnergyModel:
    """Least-squares fit of the 5-coefficient energy twin from (M, N, joules).

    Linear in the coefficients: e = [1, M, N, M*N, N/M] @ coeffs.
    """
    samples = list(samples)
    if len(samples) < 5:
        raise ValueError("need >= 5 samples to fit 5 coefficients")
    a = np.array([[1.0, m, n, m * n, n / m] for m, n, _ in samples],
                 dtype=np.float64)
    y = np.array([e for _, _, e in samples], dtype=np.float64)
    coef, *_ = np.linalg.lstsq(a, y, rcond=None)
    return EnergyModel(alpha_j=float(coef[0]), delta_j=float(coef[1]),
                       beta_j=float(coef[2]), eta_j=float(coef[3]),
                       gamma_j=float(coef[4]))


def fit_energy_from_simulator(
    ms: Sequence[int] | None = None,
    ns: Sequence[int] | None = None,
    *,
    dispatch: str = "multicast",
    sync: str = "credit",
    hw=None,
    kernel=None,
    dvfs=None,
) -> tuple[EnergyModel, float]:
    """Fit the energy twin against the simulator's closed-form joules.

    Returns ``(model, mape_pct)`` with the MAPE evaluated on the fit grid —
    the energy analogue of ``fit_from_simulator``, used for per-lane energy
    priors and validated the same way (Eq. 2 on joules).
    """
    from . import simulator as sim

    hw = hw if hw is not None else sim.HWParams()
    kernel = kernel if kernel is not None else sim.DAXPY
    dvfs = dvfs if dvfs is not None else sim.DVFS_NOMINAL
    ms = list(ms if ms is not None else sim.PAPER_M_GRID)
    ns = list(ns if ns is not None else sim.PAPER_N_GRID_MODEL)
    samples = [
        (m, n, sim.offload_energy(m, n, dispatch=dispatch, sync=sync,
                                  hw=hw, kernel=kernel, dvfs=dvfs))
        for m in ms
        for n in ns
    ]
    model = fit_energy(samples)
    return model, mape(model, samples)


@dataclass(frozen=True)
class LinearDispatchModel:
    """Baseline-design model: the dispatch overhead grows linearly with M.

        t̂_base(M, N) = alpha + delta*M + beta*N + gamma*N/M
    """

    alpha: float
    delta: float
    beta: float
    gamma: float

    def predict(self, m, n) -> np.ndarray:
        m = np.asarray(m, dtype=np.float64)
        n = np.asarray(n, dtype=np.float64)
        return self.alpha + self.delta * m + self.beta * n + self.gamma * n / m

    def optimal_m(self, n: int) -> float:
        """Continuous minimizer: d t/dM = delta - gamma*N/M^2 = 0."""
        return math.sqrt(self.gamma * n / self.delta)


def fit_linear_dispatch(
    samples: Iterable[tuple[int, int, float]],
) -> LinearDispatchModel:
    """Fit the 4-coefficient baseline model (features 1, M, N, N/M)."""
    samples = list(samples)
    if len(samples) < 4:
        raise ValueError("need >= 4 samples to fit 4 coefficients")
    a = np.array([[1.0, m, n, n / m] for m, n, _ in samples], dtype=np.float64)
    y = np.array([t for _, _, t in samples], dtype=np.float64)
    coef, *_ = np.linalg.lstsq(a, y, rcond=None)
    return LinearDispatchModel(alpha=float(coef[0]), delta=float(coef[1]),
                               beta=float(coef[2]), gamma=float(coef[3]))


def fit_pipelined_from_engine(
    ms: Sequence[int] | None = None,
    ns: Sequence[int] | None = None,
    *,
    dispatch: str = "multicast",
    sync: str = "credit",
    buffering: str = "double",
    hw=None,
    kernel=None,
) -> tuple[OffloadModel, float]:
    """Overlap-aware effective-α fit from the discrete-event engine.

    Fits Eq. 1 to *steady-state* back-to-back per-job periods
    (``engine.steady_sweep``) instead of isolated-job totals: the constant
    that comes out is α_eff — the per-job overhead that survives pipelining.
    In the fabric-bound regime (execution at least as long as the host's
    per-job dispatch + signal + return) α_eff collapses to the cluster
    wakeup (40 vs the closed form's 367 on default hardware); toward the
    host-bound margin the descriptor depth of two re-serializes part of the
    host work and α_eff rises (DESIGN.md §7).  Returns ``(model,
    mape_pct)`` with the MAPE evaluated against the same steady grid
    (Eq. 2), so callers — the DSE refit of double-buffered designs, the
    serve calibrator's pipelined prior — can judge the fit like any other.
    """
    from . import engine as eng
    from . import simulator as sim

    ms = list(ms if ms is not None else sim.PAPER_M_GRID)
    ns = list(ns if ns is not None else sim.PIPELINE_N_GRID)
    grid = eng.steady_sweep(ms, ns, dispatch=dispatch, sync=sync,
                            hw=hw or sim.HWParams(),
                            kernel=kernel or sim.DAXPY, buffering=buffering)
    samples = [(m, n, float(t)) for (m, n), t in grid.items()]
    model = fit(samples)
    return model, mape(model, samples)


def fit_from_simulator(
    ms: Sequence[int] | None = None,
    ns: Sequence[int] | None = None,
    *,
    multicast: bool = True,
    hw=None,
    kernel=None,
) -> OffloadModel | LinearDispatchModel:
    """Convenience: fit the appropriate model from the Manticore simulator.

    ``hw``/``kernel`` configure the simulated hardware (default: the paper's
    reference parameters and DAXPY).  A fleet lane fits its fabric's own
    coefficients this way — ``hw=scaled_hw(C)`` over ``ms=extent_grid(C)``
    gives the per-fabric Eq.-1 prior the router scores with (DESIGN.md §8).
    """
    from . import simulator as sim

    hw = hw if hw is not None else sim.HWParams()
    kernel = kernel if kernel is not None else sim.DAXPY
    ms = list(ms if ms is not None else sim.PAPER_M_GRID)
    ns = list(ns if ns is not None else sim.PAPER_N_GRID_MODEL)
    samples = [
        (m, n, float(sim.offload_runtime(m, n, multicast=multicast, hw=hw,
                                         kernel=kernel)))
        for m in ms
        for n in ns
    ]
    return fit(samples) if multicast else fit_linear_dispatch(samples)
