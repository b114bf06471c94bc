"""Offload-aware batch scheduler: Eq.-3 admission control + extent selection.

A copy of ``repro/serve/scheduler.py``; its results are bit-identical to the
reference's on the same inputs.

Per batch the scheduler answers the paper's offload-decision problem with
the *calibrated* runtime model (repro_torch.serve.calibrator):

  * with a deadline (tightest SLO among the batch members): M_min from
    Eq. 3 via ``decision.m_min_for_deadline``, rounded up to the next
    configured cluster count (hardware allocates in fixed quanta);
  * without one: ``decision.should_offload`` — tiny jobs run on the host
    (below the break-even size the offload constant dominates), large ones
    get the runtime-minimizing extent.

Admission control runs the same Eq.-3 inversion per request *before* it may
queue: a deadline below the serial floor (slack = t_max - alpha - beta*N
<= 0), or needing more clusters than the fabric has, is infeasible for every
batch the request could ever join — reject it immediately instead of letting
it occupy a slot and miss.

Pipelined serving (DESIGN.md §7) changes what the calibrator's samples
*mean*, not the scheduler's math: the batcher feeds completion-to-completion
effective times, so on a saturated double-buffered fabric the fitted
constant converges to α_eff (the wakeup latency) instead of the closed-form
α — Eq.-3 extents and admission then price the steady-state service a job
actually receives in the pipeline.  A pipelined prior can be seeded with
``runtime_model.fit_pipelined_from_engine``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

from repro_torch.core import decision, simulator
from repro_torch.core.runtime_model import LinearDispatchModel, OffloadModel

from .calibrator import OnlineCalibrator
from .queue import Request


@dataclass(frozen=True)
class AdmissionDecision:
    rid: int
    admitted: bool
    m_min: int | None
    reason: str


#: Job kinds the scheduler prices.  "restore" is a crash-recovery prefill
#: that additionally re-materializes checkpointed KV state (DESIGN.md §10):
#: its N counts the restored tokens on top of the prompt, and the job is
#: priced by the SAME Eq.-1 closed form — recovery is just another offload
#: (dispatch + copy + sync), which is the whole point of the pricing model.
JOB_KINDS = ("prefill", "decode", "restore")


@dataclass(frozen=True)
class BatchPlan:
    """One scheduled job: the batch the engine will run as a unit."""

    kind: str                  # one of JOB_KINDS
    n_elems: int               # job size N (tokens in this job)
    offload: bool
    m: int | None              # chosen parallel extent (None => host)
    m_min: int | None          # Eq.-3 minimum for the deadline, if any
    deadline: float | None     # tightest member SLO, cycles
    t_pred: float              # model-predicted runtime, cycles
    slo_at_risk: bool          # deadline present but infeasible for batch N
    reason: str


class OffloadAwareScheduler:
    """Per-batch extent selection + per-request admission, model-calibrated."""

    def __init__(self, calibrator: OnlineCalibrator | OffloadModel, *,
                 available_m: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 host_model: Callable[[int], float] | None = None,
                 tracer=None, proc: str = "fabric",
                 shed_depth: dict[int, int] | None = None):
        if not available_m:
            raise ValueError("no cluster configurations available")
        if isinstance(calibrator, LinearDispatchModel):
            raise TypeError(
                "the scheduler's Eq.-3 closed form needs the 3-coefficient "
                "Eq.-1 model; refit unicast designs with "
                "refit_design(point, force_eq1=True)")
        if isinstance(calibrator, OffloadModel):
            # A fixed model — e.g. a swept design's refit (repro.dse) —
            # becomes the prior of a fresh calibrator, so scheduling starts
            # from that design's coefficients and still tracks measurements.
            calibrator = OnlineCalibrator(prior=calibrator)
        self.calibrator = calibrator
        self.available_m = sorted(available_m)
        self.host_model = host_model or simulator.host_runtime
        self.admissions: list[AdmissionDecision] = []
        self.plans: list[BatchPlan] = []
        # Priority overload shedding (DESIGN.md §13): per tenant-class
        # priority, the max queue backlog at which the class is still
        # admitted.  None (default) disables shedding entirely.
        self.shed_depth = shed_depth
        # Optional span tracer (repro_torch.obs): plan/admission instants carrying
        # the prediction and the Eq.-3 verdict, on this lane's tracks.
        self.tracer = tracer
        self.proc = proc

    @property
    def m_max(self) -> int:
        return self.available_m[-1]

    # ------------------------------------------------------------------ #
    def admit(self, req: Request, *, now: float | None = None,
              backlog: int = 0) -> AdmissionDecision:
        """Eq.-3 feasibility of the request's own prefill deadline.

        ``now`` is the virtual-clock time of the decision — trace-event
        timestamp only, never an input to the verdict.  ``backlog`` is the
        arrived-waiting depth at decision time: with ``shed_depth``
        configured, a tenant class whose backlog cap is exceeded is shed
        (rejected) before its Eq.-3 math is even consulted — under overload
        the queue's capacity is spent on the classes that pay for it
        (DESIGN.md §13).
        """
        model = self.calibrator.model
        shed_cap = (self.shed_depth.get(req.priority)
                    if self.shed_depth is not None else None)
        if shed_cap is not None and backlog > shed_cap:
            d = AdmissionDecision(
                req.rid, False, None,
                f"overload shed: class priority {req.priority} backlog "
                f"{backlog} > {shed_cap}")
        elif req.slo_cycles is None:
            d = AdmissionDecision(req.rid, True, None, "no SLO")
        else:
            # A resolved warm prefix hit (batcher, DESIGN.md §13) shrinks
            # the N the deadline is checked against — affinity can make an
            # otherwise-infeasible turn admissible.  prefix_hit is 0 unless
            # a PrefixStore is attached.
            n = req.n_prompt_elems - req.prefix_hit
            m_min = decision.m_min_for_deadline(model, n, req.slo_cycles,
                                                m_max=self.m_max)
            if m_min is None:
                slack = req.slo_cycles - model.alpha - model.beta * n
                why = ("serial floor exceeds deadline "
                       f"(slack {slack:.0f} <= 0)" if slack <= 0 else
                       f"needs more than {self.m_max} clusters")
                d = AdmissionDecision(req.rid, False, None,
                                      f"infeasible SLO for N={n}: {why}")
            else:
                d = AdmissionDecision(
                    req.rid, True, m_min,
                    f"feasible with M >= {m_min} for N={n}")
        self.admissions.append(d)
        if self.tracer is not None:
            self.tracer.instant(
                self.proc, "scheduler", "admit" if d.admitted else "reject",
                req.arrival if now is None else now,
                args={"rid": d.rid, "m_min": d.m_min, "reason": d.reason})
        return d

    def fits_deadline(self, n_elems: int, deadline: float | None) -> bool:
        """Can *some* configured extent run an n_elems job within deadline?

        The batcher uses this while growing a wave: batching adds the
        candidate's tokens to the job size N, so a batch can become
        infeasible even though every member passed per-request admission.
        """
        if deadline is None:
            return True
        # m_min_for_deadline already caps at m_max == max(available_m), so a
        # non-None result is always coverable by some configured extent.
        return decision.m_min_for_deadline(self.calibrator.model, n_elems,
                                           deadline,
                                           m_max=self.m_max) is not None

    def preview(self, n_elems: int, *,
                deadline: float | None = None) -> float:
        """Predicted cycles for an ``n_elems`` job — no plan is recorded.

        The fleet router (DESIGN.md §8) scores a candidate request on every
        fabric with this: the same calibrated model and extent selection
        :meth:`plan` would use, but side-effect free (no ``plans`` entry, no
        admission bookkeeping), since only ONE fabric will actually run the
        job.  Infeasible deadlines price at the best-effort full fabric,
        matching :meth:`plan`'s fallback.
        """
        model = self.calibrator.model
        if deadline is not None:
            m_min = decision.m_min_for_deadline(model, n_elems, deadline,
                                                m_max=self.m_max)
            m = (decision.next_available_m(m_min, self.available_m)
                 if m_min is not None else None)
            return float(model.predict(m if m is not None else self.m_max,
                                       n_elems))
        d = decision.should_offload(model, self.host_model, n_elems,
                                    self.available_m)
        return float(d.t_offload if d.offload else d.t_host)

    # ------------------------------------------------------------------ #
    def plan(self, n_elems: int, *, deadline: float | None = None,
             kind: str = "prefill", now: float | None = None) -> BatchPlan:
        """Choose the parallel extent for one batch-job of ``n_elems``.

        ``now`` timestamps the trace event only (the choice is time-free).
        """
        if kind not in JOB_KINDS:
            raise ValueError(f"unknown job kind {kind!r} "
                             f"(expected one of {JOB_KINDS})")
        model = self.calibrator.model
        if deadline is not None:
            m_min = decision.m_min_for_deadline(model, n_elems, deadline,
                                                m_max=self.m_max)
            m = (decision.next_available_m(m_min, self.available_m)
                 if m_min is not None else None)
            if m is not None:
                plan = BatchPlan(
                    kind=kind, n_elems=n_elems, offload=True, m=m,
                    m_min=m_min, deadline=deadline,
                    t_pred=float(model.predict(m, n_elems)),
                    slo_at_risk=False,
                    reason=f"Eq.3: M_min={m_min} -> M={m}")
            else:
                # The *batch* deadline is infeasible (batching raised N past
                # what admission checked per request).  Best effort: run at
                # the full fabric and flag the SLO as at risk.
                m = self.m_max
                plan = BatchPlan(
                    kind=kind, n_elems=n_elems, offload=True, m=m,
                    m_min=None, deadline=deadline,
                    t_pred=float(model.predict(m, n_elems)),
                    slo_at_risk=True,
                    reason=f"batch deadline infeasible; best effort M={m}")
        else:
            d = decision.should_offload(model, self.host_model, n_elems,
                                        self.available_m)
            plan = BatchPlan(
                kind=kind, n_elems=n_elems, offload=d.offload, m=d.m,
                m_min=None, deadline=None,
                t_pred=(d.t_offload if d.offload else d.t_host),
                slo_at_risk=False, reason=d.reason)
        self.plans.append(plan)
        if self.tracer is not None:
            self.tracer.instant(
                self.proc, "scheduler", f"plan:{kind}",
                0.0 if now is None else now,
                args={"n": plan.n_elems, "offload": plan.offload,
                      "m": plan.m, "m_min": plan.m_min,
                      "t_pred": plan.t_pred,
                      "slo_at_risk": plan.slo_at_risk,
                      "reason": plan.reason})
        return plan
