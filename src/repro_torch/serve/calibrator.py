"""Online runtime-model calibration from completed-step timings.

A copy of ``repro/serve/calibrator.py``; its results are bit-identical to
the reference's on the same inputs.  The port also counts the refits it
enters (``refit_checks``) and exposes the window's size (``n_samples``),
which the batcher's host-clock ``calibrator`` spans carry.

The paper fits (alpha, beta, gamma) of t̂(M, N) = alpha + beta*N + gamma*N/M
offline, from a measurement grid.  A serving system cannot assume the
coefficients stay valid — clock scaling, contention, or a different kernel
mix all shift them — so the scheduler's model is refit *online*: every
completed offload contributes one (M, N, t) sample (from
``DispatchStats``/``CreditCounterSync.timed_wait`` timings or the simulated
fabric), kept in a sliding window, and the model is re-estimated by the same
linear least squares as the offline path (``runtime_model.fit`` — the model
is linear in its coefficients with features (1, N, N/M)).

Guard rails:

  * before ``min_samples`` observations — or while the window lacks N
    diversity — the calibrator serves its prior,
  * a single-M window makes the (1, N, N/M) design rank-deficient (the N
    and N/M columns are collinear), so the full fit is never attempted.
    While the served model stays inside the Eq.-2 bar the prior keeps
    serving; once it drifts past ``PIN_TRIGGER_MAPE_PCT`` the calibrator
    falls back to a *pinned* fit (``runtime_model.fit_pinned``): the
    window-identifiable level and at-M slope are refit, the cross-extent
    gamma is inherited from the prior.  This rescues kernels whose
    grid-fit prior mispredicts the serving regime (e.g. the fused decode
    step's small-N jobs, DESIGN.md §12) when the planner pins one extent,
  * refits are batched (every ``refit_interval`` observations) so the
    scheduler's hot path stays O(1),
  * a fit whose window MAPE (Eq. 2) is worse than the prior's is discarded
    (the prior keeps serving until the window supports a better model).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from repro_torch.core import runtime_model
from repro_torch.core.runtime_model import EnergyModel, OffloadModel, PAPER_MODEL


@dataclass(frozen=True)
class CalibrationSnapshot:
    """What the scheduler is currently planning with, and why."""

    alpha: float
    beta: float
    gamma: float
    source: str            # "prior" | "fitted" | "pinned"
    n_samples: int
    n_observed: int        # total observations ever (window may have evicted)
    window_mape_pct: float | None
    #: Energy-twin calibration (DESIGN.md §11): present once the energy
    #: window supports a fit, else None (additive — cycle-only consumers
    #: are unaffected).
    energy_mape_pct: float | None = None
    energy_n_samples: int = 0

    def as_dict(self) -> dict:
        return {"alpha": self.alpha, "beta": self.beta, "gamma": self.gamma,
                "source": self.source, "n_samples": self.n_samples,
                "n_observed": self.n_observed,
                "window_mape_pct": self.window_mape_pct,
                "energy_mape_pct": self.energy_mape_pct,
                "energy_n_samples": self.energy_n_samples}


#: Eq.-2 bar past which a single-M window's prior is considered drifted and
#: the pinned fallback fit engages (see module docstring).
PIN_TRIGGER_MAPE_PCT = 2.0


class OnlineCalibrator:
    """Sliding-window least-squares refit of the offload-runtime model."""

    def __init__(self, *, prior: OffloadModel = PAPER_MODEL,
                 window: int = 512, min_samples: int = 12,
                 refit_interval: int = 8, tracer=None,
                 proc: str = "fabric"):
        if window < min_samples:
            raise ValueError("window smaller than min_samples")
        self.prior = prior
        self.min_samples = min_samples
        self.refit_interval = max(1, refit_interval)
        self._samples: deque[tuple[int, int, float]] = deque(maxlen=window)
        # Energy-twin window (DESIGN.md §11): (m, n, joules) observations,
        # refit lazily — energy never gates the cycle-domain hot path.
        self._energy_samples: deque[tuple[int, int, float]] = \
            deque(maxlen=window)
        self._energy_model: EnergyModel | None = None
        self._model: OffloadModel = prior
        self._source = "prior"
        self._since_refit = 0
        self.n_observed = 0
        self.n_refits = 0
        self.refit_checks = 0      # entries into _refit, accepted or not
        self.n_quarantines = 0
        # Optional span tracer (repro_torch.obs): refit instants with the
        # before/after coefficients, on this lane's "calibrator" track.
        self.tracer = tracer
        self.proc = proc

    # ------------------------------------------------------------------ #
    def observe(self, m: int, n: int, t_cycles: float, *,
                now: float = 0.0) -> None:
        """One completed offload: parallel extent m, job size n, measured t.

        ``now`` is the virtual-clock time of the observation — it only
        timestamps trace events, never enters the fit.
        """
        if t_cycles <= 0:
            return  # clock glitch; a non-positive runtime can't be real
        self._samples.append((int(m), int(n), float(t_cycles)))
        self.n_observed += 1
        self._since_refit += 1
        if self._since_refit >= self.refit_interval:
            self._refit(now)

    def observe_energy(self, m: int, n: int, e_joules: float) -> None:
        """One completed offload's attributed joules (DESIGN.md §11).

        Samples window like the runtime observations; the energy twin is
        refit lazily at :meth:`energy_mape`/:meth:`snapshot` time, so the
        per-job observation cost stays O(1).
        """
        if e_joules <= 0:
            return
        self._energy_samples.append((int(m), int(n), float(e_joules)))
        self._energy_model = None   # stale; refit on demand

    def _diverse(self) -> bool:
        ms = {m for m, _, _ in self._samples}
        ns = {n for _, n, _ in self._samples}
        return len(ms) >= 2 and len(ns) >= 2

    def _refit(self, now: float = 0.0) -> None:
        self._since_refit = 0
        self.refit_checks += 1
        if len(self._samples) < self.min_samples:
            return
        if self._diverse():
            fitted = runtime_model.fit(self._samples)
            source = "fitted"
        else:
            ns = {n for _, n, _ in self._samples}
            ms = {m for m, _, _ in self._samples}
            if len(ms) != 1 or len(ns) < 2:
                return
            # Single-M window: the full fit is rank-deficient.  Keep the
            # prior while it stays inside the Eq.-2 bar; past that the
            # pinned fallback refits the identifiable components (level +
            # at-M slope) and inherits gamma from the prior.
            served = runtime_model.mape(self._model, self._samples)
            if served <= PIN_TRIGGER_MAPE_PCT:
                return
            fitted = runtime_model.fit_pinned(self._samples, self.prior)
            source = "pinned"
        before = self._model
        # Accept only a model that explains the window at least as well as
        # whatever is currently being served (prior included).
        fitted_mape = runtime_model.mape(fitted, self._samples)
        served_mape = runtime_model.mape(before, self._samples)
        accepted = fitted_mape <= served_mape
        if accepted:
            self._model = fitted
            self._source = source
            self.n_refits += 1
        if self.tracer is not None:
            self.tracer.instant(
                self.proc, "calibrator", "refit", now,
                args={"accepted": accepted,
                      "before": {"alpha": before.alpha, "beta": before.beta,
                                 "gamma": before.gamma},
                      "after": {"alpha": fitted.alpha, "beta": fitted.beta,
                                "gamma": fitted.gamma},
                      "window_mape_pct": fitted_mape if accepted
                      else served_mape,
                      "n_samples": len(self._samples)})

    def quarantine(self, *, now: float = 0.0) -> None:
        """Poisoned-window reset (DESIGN.md §10): drop every sample and
        revert to the prior.

        The fleet calls this when drift telemetry (obs/residual.py) shows
        this lane's predictions diverging — e.g. a latency-skew fault fed
        the window fabricated timings.  A poisoned window cannot be
        salvaged sample-by-sample (the calibrator cannot tell which
        observations lied), so the whole window is discarded; the prior
        serves until *fresh* observations rebuild a trustworthy fit, and
        the router readmits the lane once the refit MAPE recovers
        (``FabricFleet.refresh_quarantine``)."""
        self._samples.clear()
        self._energy_samples.clear()
        self._energy_model = None
        self._model = self.prior
        self._source = "prior"
        self._since_refit = 0
        self.n_quarantines += 1
        if self.tracer is not None:
            self.tracer.instant(self.proc, "calibrator", "quarantine", now,
                                args={"n_quarantines": self.n_quarantines})

    # ------------------------------------------------------------------ #
    @property
    def model(self) -> OffloadModel:
        return self._model

    @property
    def n_samples(self) -> int:
        """The window's size."""
        return len(self._samples)

    def window_mape(self) -> float | None:
        """Eq.-2 MAPE of the served model over the current window."""
        if not self._samples:
            return None
        return runtime_model.mape(self._model, self._samples)

    @property
    def energy_model(self) -> EnergyModel | None:
        """The refit energy twin, or None while the window is too thin.

        Lazy: fits on first access after new observations.  Unlike the
        runtime fit, only N diversity is required: a single-extent window
        (a no-deadline trace always plans the full fabric) collapses the
        five-term basis to (1, N), and the least-squares solver's
        minimum-norm solution absorbs the collinear M columns — the fit
        stays exact at the observed extent, which is all the window can
        speak for anyway.
        """
        if (self._energy_model is None
                and len(self._energy_samples) >= max(5, self.min_samples)):
            ns = {n for _, n, _ in self._energy_samples}
            if len(ns) >= 2:
                self._energy_model = runtime_model.fit_energy(
                    self._energy_samples)
        return self._energy_model

    def energy_mape(self) -> float | None:
        """Eq.-2 MAPE of the refit energy twin over its window (joules)."""
        model = self.energy_model
        if model is None or not self._energy_samples:
            return None
        return runtime_model.mape(model, self._energy_samples)

    def snapshot(self) -> CalibrationSnapshot:
        return CalibrationSnapshot(
            alpha=self._model.alpha, beta=self._model.beta,
            gamma=self._model.gamma, source=self._source,
            n_samples=len(self._samples), n_observed=self.n_observed,
            window_mape_pct=self.window_mape(),
            energy_mape_pct=self.energy_mape(),
            energy_n_samples=len(self._energy_samples))
