"""Predicted-vs-actual drift telemetry: the residual of every decision.

A copy of ``repro/obs/residual.py``; its results are bit-identical to the
reference's on the same inputs.

Three layers of this repo act on Eq.-1 predictions — the Eq.-3 scheduler
(per-job extent + t_pred), the fleet router (per-lane predicted completion
scores), and the calibrator (whose accepted fits the first two read).  The
paper's ≤1% MAPE claim is an *offline* property; what invalidates offload
decisions in a live system is estimator **drift** — the Zynq coarse-grain
estimator line of work (PAPERS.md) shows the estimate silently rots while
the system keeps planning with it.

:class:`ResidualTracker` pairs every prediction with its observed outcome
and maintains, per ``(lane, kind)`` stream, a sliding window of absolute
percentage errors plus the **windowed MAPE series** — the drift signal
ROADMAP item 5's controller will consume (a refit trigger is "windowed MAPE
regressed past the bar", not "a single bad sample").

Kinds in use:

  * ``"prefill"`` / ``"decode"`` — scheduler ``BatchPlan.t_pred`` vs the
    measured job time the calibrator also ingests (same samples, so the
    per-lane residual MAPE must agree with the calibrator's window MAPE —
    asserted in ``tests/test_obs.py``);
  * ``"route"`` — router predicted completion time vs the request's actual
    ``t_done`` (a looser bound: decode batching makes the router's decode
    share a deliberate lower bound, DESIGN.md §8.2).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass


@dataclass(frozen=True)
class Residual:
    """One prediction paired with its observed outcome."""

    lane: str
    kind: str
    t: float            # observation time (fabric cycles)
    predicted: float
    actual: float

    @property
    def ape_pct(self) -> float:
        """Absolute percentage error, Eq.-2 convention (% of actual)."""
        return abs(self.predicted - self.actual) / abs(self.actual) * 100.0


class ResidualTracker:
    """Windowed per-(lane, kind) MAPE over prediction/outcome pairs."""

    def __init__(self, *, window: int = 512):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = window
        self._apes: dict[tuple[str, str], deque[float]] = {}
        #: Per-stream drift signal: (t, windowed MAPE) after each sample.
        self._series: dict[tuple[str, str], list[tuple[float, float]]] = {}
        self._count: dict[tuple[str, str], int] = {}
        self.observations: list[Residual] = []

    def __len__(self) -> int:
        return len(self.observations)

    # ------------------------------------------------------------------ #
    def observe(self, lane: str, kind: str, predicted: float, actual: float,
                *, t: float = 0.0) -> Residual | None:
        """Pair one prediction with its outcome; returns the residual.

        Non-positive outcomes are dropped (a percentage error against a
        zero or negative runtime is meaningless — same guard as
        ``runtime_model.mape``).
        """
        if actual <= 0:
            return None
        r = Residual(lane=lane, kind=kind, t=float(t),
                     predicted=float(predicted), actual=float(actual))
        self.observations.append(r)
        key = (lane, kind)
        win = self._apes.setdefault(key, deque(maxlen=self.window))
        win.append(r.ape_pct)
        self._count[key] = self._count.get(key, 0) + 1
        self._series.setdefault(key, []).append(
            (r.t, sum(win) / len(win)))
        return r

    # ------------------------------------------------------------------ #
    def lanes(self) -> list[str]:
        seen: dict[str, None] = {}
        for lane, _ in self._apes:
            seen.setdefault(lane)
        return list(seen)

    def reset_lane(self, lane: str) -> None:
        """Drop one lane's APE windows (``mape`` returns None until new
        samples arrive).  The historical drift ``series`` and the raw
        observations are kept — this clears the *current* signal, not the
        record.  Used when a quarantined lane is released: its window is
        full of the poisoned-era errors, which must not re-trigger
        quarantine on the first post-release check (DESIGN.md §10.4)."""
        for key in [k for k in self._apes if k[0] == lane]:
            self._apes[key].clear()

    def mape(self, lane: str, kind: str | None = None) -> float | None:
        """Windowed MAPE (%) of one lane, over one kind or all combined.

        ``kind=None`` combines every *scheduler* stream (prefill + decode)
        — the exact sample population the lane's online calibrator fits —
        and excludes ``"route"``, whose deliberate decode lower bound would
        pollute the model-quality signal.
        """
        if kind is not None:
            win = self._apes.get((lane, kind))
            return sum(win) / len(win) if win else None
        apes = [a for (ln, kd), win in self._apes.items()
                for a in win if ln == lane and kd != "route"]
        return sum(apes) / len(apes) if apes else None

    def series(self, lane: str, kind: str) -> list[tuple[float, float]]:
        """The drift signal: (t, windowed MAPE) after every observation."""
        return list(self._series.get((lane, kind), []))

    def summary(self) -> dict:
        """Per-lane, per-kind windowed MAPE + counts (machine-readable)."""
        out: dict = {}
        for (lane, kind), win in self._apes.items():
            entry = out.setdefault(lane, {})
            entry[kind] = {
                "count": self._count[(lane, kind)],
                "window": len(win),
                "mape_pct": sum(win) / len(win),
                "max_ape_pct": max(win),
            }
        for lane, entry in out.items():
            combined = self.mape(lane)
            if combined is not None:
                entry["combined_mape_pct"] = combined
        return out

    def format_summary(self) -> str:
        lines = ["residuals (windowed MAPE, % of actual):"]
        for lane, entry in sorted(self.summary().items()):
            kinds = ", ".join(
                f"{kind} {v['mape_pct']:.2f}% (n={v['count']})"
                for kind, v in sorted(entry.items())
                if isinstance(v, dict))
            comb = entry.get("combined_mape_pct")
            tail = (f"; scheduler combined {comb:.2f}%"
                    if comb is not None else "")
            lines.append(f"  [{lane}] {kinds}{tail}")
        if len(lines) == 1:
            lines.append("  (no observations)")
        return "\n".join(lines)
