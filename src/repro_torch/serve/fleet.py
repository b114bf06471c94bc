"""Fleet-scale serving: model-driven routing across heterogeneous fabrics.

Everything below ``repro_torch.serve.fleet`` makes the paper's offload decision for
ONE accelerator fabric.  This module lifts the same co-design idea one level
up (DESIGN.md §8): a :class:`FabricFleet` owns N independent fabrics — each
its own :class:`~repro_torch.serve.fabric.SimulatedFabric` with its own scaled
``HWParams`` (``simulator.scaled_hw``; e.g. one 32-cluster "big" fabric and
two 8-cluster "little" fabrics), its own :class:`OnlineCalibrator` seeded
with that fabric's *own* Eq.-1 fit, and its own
:class:`OffloadAwareScheduler` planning over that fabric's extent grid — and
a :class:`Router` dispatches each request to a fabric at arrival time.

Routing policies (the A/B of ``benchmarks/fleet_router.py``):

  * ``"model"`` — score each request's predicted completion on every fabric:
    the fabric's current backlog (the router's bookkeeping of outstanding
    predicted work, i.e. the engine-timeline view available at decision
    time) plus the per-fabric Eq.-1 prediction of the request's prefill
    (``scheduler.preview`` — same model and extent selection the lane's
    planner will use; at routing time this is the fabric's own prior fit,
    see :class:`Router`) and decode work; dispatch to the argmin.
  * ``"rr"`` — round-robin, fabric-blind (the classic fleet baseline).
  * ``"lql"`` — least-queued-lane: fewest outstanding requests, speed-blind
    (knows *how much* is queued, not how fast each fabric drains).

``model`` and ``lql`` are **work-conserving**: while any fabric is predicted
idle, new requests go to an idle fabric — the router never queues a job
behind a busy fabric while another sits empty (property-tested on seeded
traces in ``tests/test_fleet.py``).  ``rr`` is deliberately not (that is the
pathology the A/B quantifies).

Execution composes the existing single-fabric machinery unchanged: after
routing, each fabric lane drains its requests through its own
:class:`~repro_torch.serve.batcher.ContinuousBatcher` on the shared virtual-time
axis (arrival timestamps are global, so per-lane clocks line up and the
fleet span is the max over lanes).  A fleet of ONE reference fabric is
therefore *bit-identical* to the single-fabric ``serve_workload`` path —
tokens and metrics — which is the regression anchor for everything here.

The port of ``repro/serve/fleet.py``.  Routing, serving loops, recovery and
quarantine are numpy copied from the reference, so on the same trace the
port's routes, summaries and calibrations equal the reference's.  With
``execute=True`` each lane's batcher drives one of the port's
``ServingEngine``s (on the card unless ``FleetConfig.device`` says
``"cpu"``); the "restore" recovery snapshots decode state through the
port's own ``CheckpointManager``.
"""

from __future__ import annotations

import dataclasses
import tempfile
from dataclasses import dataclass

import numpy as np

from repro_torch.core import runtime_model, simulator as sim
from repro_torch.core.runtime_model import PAPER_MODEL, OffloadModel
from repro_torch.kernels.ops import get_kernel

from .batcher import ContinuousBatcher
from .calibrator import OnlineCalibrator
from .fabric import SimulatedFabric
from .metrics import FleetMetrics, ServeMetrics
from .prefix import DEFAULT_CAPACITY_TOKENS, PrefixStore
from .queue import Request, RequestState
from .scheduler import OffloadAwareScheduler
from .workload import WorkloadSpec, derive_seed

#: Router policies (DESIGN.md §8.2).
ROUTER_POLICIES = ("model", "rr", "lql")

#: What the ``model`` policy's argmin minimizes (DESIGN.md §11):
#:   * "latency" — predicted completion time (the classic score; default);
#:   * "energy"  — predicted joules on each lane's closed-form energy
#:                 model, predicted completion breaking ties;
#:   * "edp"     — energy-delay product: predicted joules x predicted
#:                 sojourn (queueing included), the classic efficiency
#:                 compromise.
#: ``rr`` and ``lql`` are deliberately objective-blind baselines; with the
#: default objective the scoring path is bit-identical to the historical
#: latency-only router.
ROUTER_OBJECTIVES = ("latency", "energy", "edp")

#: What the fleet does with a dead lane's orphans (DESIGN.md §10):
#:   * "restore"   — re-route and resume from the lane's last decode
#:                   checkpoint (the restore job re-materializes KV and is
#:                   priced by the same Eq.-1 closed form as any offload);
#:   * "reprefill" — re-route and recompute from the request record (no
#:                   checkpoint; the new lane re-runs the full prefill);
#:   * "drop"      — fail the orphans outright (the naive baseline the
#:                   kill-a-fabric A/B measures recovery against).
RECOVERY_MODES = ("restore", "reprefill", "drop")


def fabric_prior(num_clusters: int, *,
                 kernel: sim.KernelSpec = sim.DAXPY) -> OffloadModel:
    """The per-fabric Eq.-1 prior a fleet lane's calibrator starts from.

    At the paper's reference size the published coefficients ARE the fit
    (``PAPER_MODEL`` — this is also what keeps a 1x32 fleet bit-identical to
    the single-fabric path, whose calibrator starts from the same prior).
    Any other size gets its own least-squares fit over its scaled hardware
    (``scaled_hw``) and its own extent grid — an 8-cluster fabric has a
    narrower banked bus (larger beta) and at most 8-way parallelism, and the
    router must score with *that* model, not the reference one
    (DESIGN.md §8.1).
    """
    if num_clusters == sim.REFERENCE_CLUSTERS and kernel is sim.DAXPY:
        return PAPER_MODEL
    model = runtime_model.fit_from_simulator(
        ms=list(sim.extent_grid(num_clusters)),
        ns=sim.PAPER_N_GRID_MODEL,
        hw=sim.scaled_hw(num_clusters), kernel=kernel)
    assert isinstance(model, OffloadModel)
    return model


@dataclass
class FleetLane:
    """One fabric of the fleet plus its private serving machinery."""

    index: int
    num_clusters: int
    fabric: SimulatedFabric
    calibrator: OnlineCalibrator
    scheduler: OffloadAwareScheduler
    engine: object | None = None     # optional per-lane ServingEngine

    @property
    def name(self) -> str:
        return f"f{self.index}:{self.num_clusters}c"

    def preview(self, req: Request, *, skip: int = 0) -> float:
        """Predicted service cycles for ``req`` on this fabric.

        Prefill via the lane scheduler's side-effect-free preview (same
        calibrated model + extent selection its planner uses), plus one
        single-token decode step per generated token — a lower bound on the
        decode share (decode jobs batch across slots), but the same bound on
        every fabric, so the *comparison* the router makes is fair.
        ``skip`` is a warm prefix hit: those prompt tokens are resident in
        the lane's KV store and skip prefill (DESIGN.md §13).
        """
        t = self.scheduler.preview(req.n_prompt_elems - skip,
                                   deadline=req.slo_cycles)
        if req.gen_len > 1:
            t += (req.gen_len - 1) * self.scheduler.preview(1)
        return t

    def handoff_cycles(self, n_copy: int) -> float:
        """Closed-form memcpy pull of ``n_copy`` KV tokens (DESIGN.md §13).

        The same pure-streaming Eq.-1 shape the batcher prices an actual
        handoff with — dispatch + copy + sync at the full fabric, compute
        term nearly gone — so the router's hit-vs-miss delta and the served
        cost agree.
        """
        return float(sim.offload_runtime(
            self.scheduler.m_max, n_copy, dispatch=self.fabric.dispatch,
            sync=self.fabric.sync, kernel=get_kernel("memcpy"),
            hw=self.fabric.hw))

    def preview_energy(self, req: Request) -> float:
        """Predicted joules for ``req`` on this fabric (DESIGN.md §11).

        The fabric's RNG-free closed-form energy at the full-fabric extent
        (prefill plus one single-token decode step per remaining token) —
        a lower bound like :meth:`preview`'s decode share, but the same
        bound on every lane, so an energy/edp router compares fairly.
        Side-effect free: no calibrator, no jitter draw.
        """
        m = max(self.scheduler.available_m)
        e = self.fabric.offload_energy(m, req.n_prompt_elems)
        if req.gen_len > 1:
            e += (req.gen_len - 1) * self.fabric.offload_energy(m, 1)
        return e


@dataclass(frozen=True)
class RouteDecision:
    """One routing decision, with the evidence it was made on."""

    rid: int
    lane: int
    policy: str
    scores: tuple[float, ...]        # predicted completion time per lane
    pending: tuple[int, ...]         # outstanding requests per lane (before)
    feasible: tuple[bool, ...]       # Eq.-3 SLO feasibility per lane
    guarded: bool                    # work-conserving guard redirected it
    requeued: bool = False           # crash-recovery re-route (second pass)
    objective: str = "latency"       # what the model policy minimized
    energy: tuple[float, ...] | None = None  # predicted joules per lane
    prefix_hit: int = 0              # warm-hit tokens on the chosen lane
    prefix_handoff: bool = False     # hit staged via a cross-lane KV pull


class Router:
    """Dispatches requests to fleet lanes at arrival time (DESIGN.md §8.2).

    The router's backlog state is *predicted*, not measured: per lane it
    tracks ``t_free`` (when the fabric is expected to drain everything
    routed so far) and the predicted completion time of each outstanding
    request.  Eq. 1 exists so the decision can be made without running the
    job.  Note the model the router reads per lane is that fabric's own
    Eq.-1 *prior* fit (:func:`fabric_prior`): in this open-loop replay the
    whole trace is routed before the lanes serve it, so online refits
    arrive after every routing decision — they sharpen each lane's
    in-serving scheduling (``plan``/admission read the live calibrator) and
    validate the per-fabric fits (window MAPE ≤ the Eq.-2 bar), but cannot
    influence routing.
    """

    def __init__(self, lanes: list[FleetLane], policy: str = "model", *,
                 objective: str = "latency", tracer=None,
                 tie_seed: int | None = None,
                 prefix_stores: list[PrefixStore] | None = None):
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"router policy must be one of "
                             f"{ROUTER_POLICIES}, got {policy!r}")
        if objective not in ROUTER_OBJECTIVES:
            raise ValueError(f"router objective must be one of "
                             f"{ROUTER_OBJECTIVES}, got {objective!r}")
        if not lanes:
            raise ValueError("a fleet needs at least one fabric")
        self.lanes = lanes
        self.policy = policy
        self.objective = objective
        self._t_free = [0.0] * len(lanes)
        self._inflight: list[list[float]] = [[] for _ in lanes]
        self._rr_next = 0
        self.decisions: list[RouteDecision] = []
        # Fault state (DESIGN.md §10): a lane marked dead at time t is
        # excluded from every decision whose request arrives at/after t —
        # decisions *before* t stay bit-identical to the fault-free run
        # (failure detection takes DETECTION_CYCLES; the router cannot act
        # on a crash it has not observed).  Quarantine is score-less
        # exclusion while a lane's calibrator is distrusted.
        self._dead: dict[int, float] = {}
        self._quarantined: dict[int, float] = {}
        # Tie-break stream (seeded via workload.derive_seed): with no seed,
        # exact score ties resolve to the lowest lane index — bit-identical
        # to the historical min() behavior.
        self._tie_rng = (None if tie_seed is None
                         else np.random.default_rng(tie_seed))
        # Session affinity (DESIGN.md §13): one predictive PrefixStore per
        # lane.  The router walks the trace in arrival order — virtual-time
        # order — so residency evolves exactly as the shared clock would
        # have it, and the resolution it binds onto each request
        # (prefix_hit / prefix_handoff) is authoritative for the lane's
        # batcher.  None (default) keeps routing bit-identical to PR 9.
        self._prefix_stores = prefix_stores
        if prefix_stores is not None and len(prefix_stores) != len(lanes):
            raise ValueError("prefix_stores must match the lane count")
        # Optional span tracer (repro_torch.obs): each decision becomes an instant
        # on the "router" process carrying its evidence, plus a flow arrow
        # the chosen lane's batcher closes at the serving prefill.
        self.tracer = tracer

    # ------------------------------------------------------------------ #
    # Fault state
    # ------------------------------------------------------------------ #
    def mark_dead(self, lane: int, t_detect: float) -> None:
        """Lane ``lane`` is known dead from ``t_detect`` on (crash time +
        the detection delay).  From then on its score is effectively
        zeroed — it is no longer a candidate for any request arriving
        at/after ``t_detect``.  Nothing else is touched: decisions *before*
        the detect time must stay bit-identical to the fault-free run (the
        router cannot act on a crash it has not observed yet)."""
        self._dead[lane] = min(t_detect, self._dead.get(lane, t_detect))

    def quarantine(self, lane: int, now: float = 0.0) -> None:
        """Exclude a lane whose calibrator is distrusted (poisoned window)
        until :meth:`release` — used by FabricFleet when drift telemetry
        crosses the quarantine bar."""
        self._quarantined.setdefault(lane, now)

    def release(self, lane: int) -> None:
        self._quarantined.pop(lane, None)

    @property
    def dead_lanes(self) -> tuple[int, ...]:
        return tuple(sorted(self._dead))

    @property
    def quarantined_lanes(self) -> tuple[int, ...]:
        return tuple(sorted(self._quarantined))

    def _excluded(self, i: int, now: float) -> bool:
        t = self._dead.get(i)
        if t is not None and now >= t:
            return True
        return i in self._quarantined

    def _argmin(self, cand: list[int], key) -> int:
        """Lowest-key candidate; exact ties go through the tie-break RNG
        when one is seeded (lowest index otherwise — the historical
        behavior, preserved bit-for-bit)."""
        best = min(key(i) for i in cand)
        ties = [i for i in cand if key(i) == best]
        if len(ties) > 1 and self._tie_rng is not None:
            return int(ties[int(self._tie_rng.integers(len(ties)))])
        return ties[0]

    def _drain(self, now: float) -> None:
        for fl in self._inflight:
            fl[:] = [t for t in fl if t > now]

    # ------------------------------------------------------------------ #
    # Session affinity (DESIGN.md §13)
    # ------------------------------------------------------------------ #
    def _affinity_service(self, req: Request):
        """Per-lane predicted service with the hit-vs-miss Eq.-1 delta.

        A lane holding the session's prefix skips those prompt tokens; a
        cold lane may instead *pull* the best peer copy as a memcpy handoff
        when that beats re-prefilling the context — the router compares
        both, so affinity never makes a placement strictly worse than the
        affinity-blind score.
        """
        stores = self._prefix_stores
        resident = [min(s.resident(req.prefix_id), req.prefix_len)
                    for s in stores]
        best = max(resident)
        service, hits, handoffs = [], [], []
        for i, lane in enumerate(self.lanes):
            h, ho = resident[i], False
            t = lane.preview(req, skip=h)
            if h == 0 and best > 0:
                t_pull = lane.handoff_cycles(best) + lane.preview(req,
                                                                  skip=best)
                if t_pull < t:
                    t, h, ho = t_pull, best, True
            service.append(t)
            hits.append(h)
            handoffs.append(ho)
        return service, hits, handoffs

    def _commit_affinity(self, req: Request, choice: int,
                         hits: list[int], handoffs: list[bool]) -> None:
        """Bind the chosen lane's hit/handoff onto the request and evolve
        that lane's residency: a handoff stages the pulled copy, and after
        serving the lane holds this turn's full context (which is exactly
        the next turn's ``prefix_len``).  The resolution is authoritative —
        the lane's batcher prices it as bound here."""
        req.prefix_hit = hits[choice]
        req.prefix_handoff = handoffs[choice]
        req.prefix_resolved = True
        store = self._prefix_stores[choice]
        if hits[choice] > 0:
            if handoffs[choice]:
                store.insert(req.prefix_id, hits[choice])
            store.hit(req.prefix_id, req.prefix_len)
        elif req.prefix_len > 0:
            store.hit(req.prefix_id, req.prefix_len)   # counts the miss
        store.insert(req.prefix_id, req.prompt_len + req.gen_len)

    def route(self, req: Request, *, requeued: bool = False) -> int:
        """Pick the lane for one request; returns its index.

        Raises ``RuntimeError`` when every lane is dead or quarantined —
        the fleet turns that into a dropped request rather than a crash.
        """
        now = req.effective_arrival
        self._drain(now)
        alive = [i for i in range(len(self.lanes))
                 if not self._excluded(i, now)]
        if not alive:
            raise RuntimeError(f"no live lane for rid={req.rid} at "
                               f"t={now:.0f} (dead={self.dead_lanes}, "
                               f"quarantined={self.quarantined_lanes})")
        pending = tuple(len(fl) for fl in self._inflight)
        hits = handoffs = None
        if self._prefix_stores is not None and req.prefix_id is not None:
            service, hits, handoffs = self._affinity_service(req)
        else:
            service = [lane.preview(req) for lane in self.lanes]
        scores = tuple(max(self._t_free[i], now) + service[i]
                       for i in range(len(self.lanes)))
        # Per-lane Eq.-3 feasibility of the request's SLO: a little fabric
        # (smaller extent grid, narrower banked bus) may be unable to meet a
        # deadline the big fabric can — its admission control would reject
        # the request on arrival, so the model/lql policies never send one
        # there while a feasible lane exists (rr does, and pays in goodput).
        feasible = tuple(
            lane.scheduler.fits_deadline(req.n_prompt_elems, req.slo_cycles)
            for lane in self.lanes)
        cand = [i for i in alive if feasible[i]] or alive

        # Objective key for the model policy (DESIGN.md §11).  Energy is
        # priced only when asked for — the default "latency" objective runs
        # the historical scoring path bit-for-bit (no energy closed forms
        # evaluated, no new work on the hot path).
        energy: tuple[float, ...] | None = None
        if self.policy == "model" and self.objective != "latency":
            energy = tuple(lane.preview_energy(req) for lane in self.lanes)
            if self.objective == "energy":
                def objkey(i, e=energy):
                    return (e[i], scores[i])
            else:  # edp: joules x predicted sojourn (queueing included)
                def objkey(i, e=energy):
                    return (e[i] * (scores[i] - now), scores[i])
        else:
            def objkey(i):
                return scores[i]

        if self.policy == "rr":
            # Round-robin over the *live* lanes: advance the pointer until
            # it lands on one (identical sequence while nothing is dead).
            choice = alive[0]
            for _ in range(len(self.lanes)):
                c = self._rr_next
                self._rr_next = (self._rr_next + 1) % len(self.lanes)
                if c in alive:
                    choice = c
                    break
        elif self.policy == "lql":
            choice = self._argmin(cand, lambda i: (pending[i], scores[i]))
        else:  # model
            choice = self._argmin(cand, objkey)

        # Work-conserving guard (model/lql): while some fabric *that could
        # serve this request* is predicted idle, never queue behind a busy
        # one — no feasible fabric may sit empty while another accumulates
        # >1 outstanding jobs.  rr stays blind; its queueing pathology is
        # the baseline the A/B measures.
        guarded = False
        if self.policy != "rr" and pending[choice] > 0:
            idle = [i for i in cand if pending[i] == 0]
            if idle:
                # The guard redirects by the same objective the policy
                # scored with: an energy router still never queues a job
                # behind a busy lane while a feasible one sits idle.
                choice = self._argmin(idle, objkey)
                guarded = True

        # A request infeasible on EVERY lane (cand fell back to all lanes)
        # is rejected instantly by the chosen lane's admission control — it
        # runs no work, so charging its predicted service to the lane's
        # backlog would make an idle lane look busy for a phantom duration.
        if feasible[choice]:
            done = max(self._t_free[choice], now) + service[choice]
            self._t_free[choice] = done
            self._inflight[choice].append(done)
        if hits is not None:
            self._commit_affinity(req, choice, hits, handoffs)
        self.decisions.append(RouteDecision(
            rid=req.rid, lane=choice, policy=self.policy, scores=scores,
            pending=pending, feasible=feasible, guarded=guarded,
            requeued=requeued, objective=self.objective, energy=energy,
            prefix_hit=req.prefix_hit,
            prefix_handoff=req.prefix_handoff))
        if self.tracer is not None:
            args = {"rid": req.rid, "lane": self.lanes[choice].name,
                    "scores": [s if np.isfinite(s) else None
                               for s in scores],
                    "pending": list(pending),
                    "feasible": list(feasible), "guarded": guarded,
                    "requeued": requeued}
            if energy is not None:
                args["objective"] = self.objective
                args["energy_j"] = list(energy)
            self.tracer.instant(
                "router", "routes", f"route:{self.policy}", now, args=args)
            self.tracer.flow_start("router", "routes", "route", now,
                                   flow=req.rid)
        return choice


class FabricFleet:
    """N independent fabrics + a router, serving one shared request trace.

    ``sizes`` gives the cluster count of each fabric; every fabric gets its
    own scaled hardware (``simulator.scaled_hw``), its own jitter stream
    (seed offset by the lane index, so lane 0 of a one-fabric fleet matches
    the single-fabric path sample for sample), its own calibrator with its
    own Eq.-1 prior (:func:`fabric_prior`), and its own scheduler over its
    own extent grid.  ``engines`` optionally attaches one real
    ``ServingEngine`` per lane (fleet execution holds one engine, with its
    decode caches, per fabric; the routing benchmarks run
    ``execute=False``).
    """

    def __init__(self, sizes, *, router: str = "model",
                 objective: str = "latency",
                 jitter_pct: float = 1.0, seed: int = 0,
                 max_batch: int = 4, wave_boundary: bool = False,
                 pipeline: bool = False, buffering: str | None = None,
                 dvfs=None,
                 engines: list | None = None, tracer=None, residuals=None,
                 faults=None, recovery: str = "restore",
                 ckpt_every: int = 4, quarantine_mape_pct: float = 10.0,
                 release_mape_pct: float = 2.0,
                 tie_seed: int | None = None,
                 affinity: bool = False,
                 prefix_capacity: int = DEFAULT_CAPACITY_TOKENS,
                 priority: bool = False, preempt: bool = False,
                 shed_depth: dict[int, int] | None = None):
        sizes = tuple(int(s) for s in sizes)
        if not sizes:
            raise ValueError("a fleet needs at least one fabric")
        if engines is not None and len(engines) != len(sizes):
            raise ValueError("engines must match the fleet size")
        if recovery not in RECOVERY_MODES:
            raise ValueError(f"recovery must be one of {RECOVERY_MODES}, "
                             f"got {recovery!r}")
        buffering = buffering or ("double" if pipeline else "single")
        self.sizes = sizes
        self.max_batch = max_batch
        self.wave_boundary = wave_boundary
        self.pipeline = pipeline
        # Fault tolerance (DESIGN.md §10): ``faults`` is a
        # runtime.fault.FaultInjector shared by every lane (each batcher
        # polls its own lane index).  Skew quarantine needs drift telemetry,
        # so a fleet under fault injection always carries a ResidualTracker.
        self.faults = faults
        self.recovery = recovery
        self.ckpt_every = ckpt_every
        self.quarantine_mape_pct = quarantine_mape_pct
        self.release_mape_pct = release_mape_pct
        if faults is not None and residuals is None:
            from repro_torch.obs.residual import ResidualTracker
            residuals = ResidualTracker()
        # Observability (repro_torch.obs): one trace process per lane (named
        # ``f{i}:{clusters}c``) plus a "router" process; the shared residual
        # tracker keys drift series by the same lane names.
        self.tracer = tracer
        self.residuals = residuals
        # Session affinity + tenant classes (DESIGN.md §13) — default-off:
        # no stores, no priority ordering, no shedding, bit-identical to
        # the PR 9 fleet.
        self.affinity = affinity
        self.priority = priority
        self.preempt = preempt
        self.prefix_stores = ([PrefixStore(prefix_capacity)
                               for _ in sizes] if affinity else None)
        self.lanes: list[FleetLane] = []
        for i, clusters in enumerate(sizes):
            proc = f"f{i}:{clusters}c"
            calibrator = OnlineCalibrator(prior=fabric_prior(clusters),
                                          tracer=tracer, proc=proc)
            scheduler = OffloadAwareScheduler(
                calibrator, available_m=sim.extent_grid(clusters),
                tracer=tracer, proc=proc, shed_depth=shed_depth)
            fabric = SimulatedFabric(jitter_pct=jitter_pct, seed=seed + i,
                                     num_clusters=clusters,
                                     buffering=buffering, dvfs=dvfs,
                                     tracer=tracer, proc=proc)
            self.lanes.append(FleetLane(
                index=i, num_clusters=clusters, fabric=fabric,
                calibrator=calibrator, scheduler=scheduler,
                engine=None if engines is None else engines[i]))
        self.router = Router(self.lanes, router, objective=objective,
                             tracer=tracer, tie_seed=tie_seed,
                             prefix_stores=self.prefix_stores)
        # Per-lane checkpoint managers, only where they can matter: a lane
        # with a scheduled crash snapshots its decode state so "restore"
        # recovery can resume orphans elsewhere.  The backing directory
        # lives for the fleet object's lifetime.
        self._ckpt_tmp = None
        self._ckpts: dict[int, object] = {}
        if (faults is not None and recovery == "restore"
                and faults.crashed_lanes()):
            from repro_torch.ckpt import CheckpointManager
            self._ckpt_tmp = tempfile.TemporaryDirectory(
                prefix="repro-torch-fleet-ckpt-")
            for i in faults.crashed_lanes():
                if 0 <= i < len(self.lanes):
                    self._ckpts[i] = CheckpointManager(
                        f"{self._ckpt_tmp.name}/lane{i}", keep=2)

    # ------------------------------------------------------------------ #
    def run(self, requests: list[Request]) -> dict:
        """Route then serve the whole trace; returns the merged results.

        Routing happens strictly in arrival order (what an online router
        sees); each lane then drains its routed requests through its own
        :class:`ContinuousBatcher`.  Lanes share the virtual-time axis —
        arrival timestamps are global — so per-lane spans line up and the
        fleet metrics aggregate them directly.

        Under fault injection (DESIGN.md §10) serving is two-phase:

          1. dead lanes are pre-registered with the router at their
             *detect* time (crash + detection lag) — every decision before
             that stays bit-identical to the fault-free run — and each lane
             drains with its own fault view; a crashed lane halts and
             reports its orphans;
          2. orphans are requeued at the detect time, re-routed (dead lane
             excluded, quarantined calibrators excluded) and re-served on
             the surviving lanes' batchers with their clocks resumed —
             restored from the dead lane's last decode checkpoint when
             ``recovery="restore"`` and one exists, re-prefilled from the
             request record otherwise.  ``recovery="drop"`` fails them
             outright (the naive A/B baseline).
        """
        self.refresh_quarantine()
        if self.faults is not None:
            for i in self.faults.crashed_lanes():
                if 0 <= i < len(self.lanes):
                    self.router.mark_dead(i, self.faults.detect_time(i))

        routed: list[list[Request]] = [[] for _ in self.lanes]
        for req in sorted(requests,
                          key=lambda r: (r.effective_arrival, r.rid)):
            routed[self.router.route(req)].append(req)

        lane_outs = []
        batchers: list[ContinuousBatcher] = []
        for lane, reqs in zip(self.lanes, routed):
            batcher = ContinuousBatcher(
                lane.scheduler, lane.calibrator, fabric=lane.fabric,
                engine=lane.engine,
                max_batch=None if lane.engine is not None else self.max_batch,
                wave_boundary=self.wave_boundary, pipeline=self.pipeline,
                tracer=self.tracer, residuals=self.residuals,
                proc=lane.name, flow=True,
                faults=self.faults, fault_lane=lane.index,
                ckpt=self._ckpts.get(lane.index),
                ckpt_every=self.ckpt_every,
                priority=self.priority, preempt=self.preempt)
            batchers.append(batcher)
            out = batcher.run(reqs)
            # An unused lane still reports an honest (empty) summary.
            if not reqs:
                out["metrics"] = ServeMetrics()
            lane_outs.append(out)

        dropped = self._recover(batchers, lane_outs)

        merged = sorted(
            [r for out in lane_outs for r in out["requests"]] + dropped,
            key=lambda r: r.rid)
        if self.residuals is not None:
            # Routing drift, post hoc: the predicted-completion score the
            # router chose on vs the request's actual completion time.
            # Looser than the per-job residuals by construction (the score's
            # decode share is a lower bound), but trended per lane it shows
            # where the routing model drifts.
            done = {r.rid: r.t_done for r in merged if r.t_done is not None}
            last = {d.rid: k for k, d in enumerate(self.router.decisions)}
            for k, d in enumerate(self.router.decisions):
                # Only a request's LAST routing decision pairs with its
                # completion — a recovered request's first decision sent it
                # to a lane that died under it.
                if last[d.rid] != k:
                    continue
                actual = done.get(d.rid)
                if actual is not None:
                    self.residuals.observe(self.lanes[d.lane].name, "route",
                                           d.scores[d.lane], actual,
                                           t=actual)
        if self.faults is not None:
            # Skew-only schedules never enter the crash-recovery path, so
            # run the drift check here too (quarantine fires for the next
            # trace this fleet serves).
            t_last = max((out["metrics"].t_end for out in lane_outs),
                         default=0.0)
            self._quarantine_check(t_last)
        return {
            "requests": merged,
            "metrics": FleetMetrics([(lane.name, out["metrics"])
                                     for lane, out in zip(self.lanes,
                                                          lane_outs)]),
            "lanes": lane_outs,
            "routes": self.router.decisions,
            "router": self.router.policy,
            "sizes": self.sizes,
            "calibrations": [out["calibration"] for out in lane_outs],
            "recovery": self.recovery if self.faults is not None else None,
            "dropped": sorted(r.rid for r in dropped),
            "dead_lanes": list(self.router.dead_lanes),
            "quarantined_lanes": list(self.router.quarantined_lanes),
            # The live fleet object: callers drive post-run probation
            # (refresh_quarantine) or serve another trace on it.
            "fleet": self,
        }

    # ------------------------------------------------------------------ #
    # Crash recovery + calibrator quarantine (DESIGN.md §10)
    # ------------------------------------------------------------------ #
    def _restore_map(self, lane_idx: int) -> dict[int, tuple[int, list[int]]]:
        """rid -> (tokens_emitted, generated-token row) from the dead lane's
        last decode checkpoint (empty when none was ever written)."""
        mgr = self._ckpts.get(lane_idx)
        if mgr is None:
            return {}
        try:
            mgr.wait()
            # Shapeless placeholder leaves: the saved shapes depend on the
            # dead lane's batch geometry, which the fleet does not know.
            data, _, _ = mgr.restore_latest(
                {"rids": 0, "emitted": 0, "lens": 0, "gen": 0})
        except FileNotFoundError:
            return {}
        out: dict[int, tuple[int, list[int]]] = {}
        for i, rid in enumerate(np.asarray(data["rids"]).tolist()):
            if rid < 0:
                continue
            em = int(np.asarray(data["emitted"])[i])
            row = [int(t) for t in np.asarray(data["gen"])[i] if t >= 0]
            out[int(rid)] = (em, row)
        return out

    def _drop(self, orphans: list[tuple[int, Request]],
              lane_outs: list[dict], now: float) -> list[Request]:
        """Fail orphans outright, attributed to their origin lane."""
        dropped = []
        for origin, r in orphans:
            r.state = RequestState.FAILED
            lane_outs[origin]["metrics"].dropped += 1
            dropped.append(r)
            if self.tracer is not None:
                self.tracer.instant(
                    "router", "faults", "dropped", max(now, r.arrival),
                    args={"rid": r.rid, "origin": self.lanes[origin].name})
        return dropped

    def _recover(self, batchers: list[ContinuousBatcher],
                 lane_outs: list[dict]) -> list[Request]:
        """Phase 2: requeue + re-route + re-serve every crash orphan.

        Returns the requests that could not be recovered (recovery="drop",
        no live lane, or a second crash under the recovery pass) — already
        marked FAILED and counted as ``dropped`` on their origin lane.
        """
        orphans: list[tuple[int, Request]] = [
            (i, r) for i, out in enumerate(lane_outs)
            for r in out.get("orphans", ())]
        if not orphans:
            return []
        t_now = max(out["metrics"].t_end for out in lane_outs)
        if self.recovery == "drop":
            return self._drop(orphans, lane_outs, t_now)

        # A poisoned calibrator must not attract the re-routed orphans:
        # check drift telemetry BEFORE choosing recovery lanes.
        self._quarantine_check(t_now)

        restore_maps = {i: self._restore_map(i)
                        for i in {i for i, _ in orphans}}
        for origin, r in orphans:
            t_detect = max(self.faults.detect_time(origin) or 0.0,
                           lane_outs[origin]["metrics"].t_end)
            r.t_enqueued = max(t_detect, r.arrival)
            r.requeues += 1
            r.state = RequestState.QUEUED
            em, row = restore_maps[origin].get(r.rid, (0, []))
            # Resume at most gen_len - 1 tokens in: a checkpoint at the
            # final token would mean the request had already completed.
            r.restore_len = min(em, r.gen_len - 1)
            r.restored_tokens = (np.asarray(row[:r.restore_len], np.int32)
                                 if r.restore_len > 0 and row else None)
            if self.tracer is not None:
                self.tracer.instant(
                    "router", "faults", "requeue", r.t_enqueued,
                    args={"rid": r.rid, "origin": self.lanes[origin].name,
                          "restore_len": r.restore_len})

        # Re-route in requeue order; a request no live lane can take is
        # dropped, not raised (the client sees a failure, not a crash).
        requeued: list[list[Request]] = [[] for _ in self.lanes]
        undeliverable: list[tuple[int, Request]] = []
        for origin, r in sorted(orphans,
                                key=lambda p: (p[1].effective_arrival,
                                               p[1].rid)):
            try:
                j = self.router.route(r, requeued=True)
            except RuntimeError:
                undeliverable.append((origin, r))
                continue
            requeued[j].append(r)

        dropped = self._drop(undeliverable, lane_outs, t_now)
        for j, reqs2 in enumerate(requeued):
            if not reqs2:
                continue
            b = batchers[j]
            out2 = b.run(reqs2, requeued=True,
                         start_clock=lane_outs[j]["metrics"].t_end)
            lane_outs[j]["requests"] = sorted(
                lane_outs[j]["requests"] + out2["requests"],
                key=lambda r: r.rid)
            # The batcher accumulates into the same ServeMetrics object —
            # re-point the lane output at it in case phase 1 replaced it
            # (empty lane) and refresh the derived fields.
            lane_outs[j]["metrics"] = b.metrics
            lane_outs[j]["calibration"] = out2["calibration"]
            # One recovery round: orphans of a second crash (a lane whose
            # own scheduled crash fell after its phase-1 drain) fail.
            second = [(j, r) for r in out2.get("orphans", ())]
            dropped += self._drop(second, lane_outs, b.metrics.t_end)
        return dropped

    def _quarantine_check(self, now: float = 0.0) -> None:
        """Quarantine any live lane whose drift telemetry (windowed
        residual MAPE over the calibrator's own sample population) has
        blown past the quarantine bar — the calibrator-poisoning signature
        (a skew fault feeds it fabricated timings)."""
        if self.residuals is None:
            return
        crashed = (set(self.faults.crashed_lanes())
                   if self.faults is not None else set())
        for lane in self.lanes:
            i = lane.index
            if i in crashed or i in self.router.quarantined_lanes:
                continue
            mape = self.residuals.mape(lane.name)
            if mape is not None and mape > self.quarantine_mape_pct:
                self.router.quarantine(i, now)
                lane.calibrator.quarantine(now=now)
                if self.tracer is not None:
                    self.tracer.instant(
                        "router", "faults", "quarantine", now,
                        args={"lane": lane.name, "mape_pct": mape,
                              "bar_pct": self.quarantine_mape_pct})

    def refresh_quarantine(self, now: float = 0.0, *,
                           probe_ns: tuple[int, ...] = (256, 1024, 4096)
                           ) -> list[int]:
        """Probation check for quarantined lanes; returns the released ones.

        A quarantined lane serves no traffic, so it re-earns trust through
        a *probe sweep*: a small (M, N) measurement grid run on its own
        fabric, fed through the same (possibly still-skewed) measurement
        channel.  The probes are judged against the lane's *prior* — the
        offline Eq.-1 fit, the only ground-truth anchor a lying measurement
        channel cannot absorb (a constant skew rescales a least-squares
        refit perfectly, so a refit-vs-its-own-window check would release a
        still-poisoned lane).  Probe MAPE back under the release bar — the
        Eq.-2 quality the paper demands of a trustworthy fit — readmits
        the lane and resets its drift windows; while the skew window is
        still active the probes lie too and the lane stays out.
        """
        released: list[int] = []
        for i in list(self.router.quarantined_lanes):
            lane = self.lanes[i]
            cal = lane.calibrator
            skew = (self.faults.skew_factor(i, now)
                    if self.faults is not None else 1.0)
            samples = []
            for n in probe_ns:
                for m in lane.scheduler.available_m:
                    t = lane.fabric.offload(m, n) * skew
                    samples.append((m, n, t))
                    cal.observe(m, n, t, now=now)
            probe_mape = runtime_model.mape(cal.prior, samples)
            ok = probe_mape <= self.release_mape_pct
            if ok:
                self.router.release(i)
                released.append(i)
                if self.residuals is not None:
                    # Fresh telemetry: the stale poisoned window must not
                    # re-trigger quarantine the moment the lane serves.
                    self.residuals.reset_lane(lane.name)
            if self.tracer is not None:
                self.tracer.instant(
                    "router", "faults",
                    "release" if ok else "probation", now,
                    args={"lane": lane.name, "probe_mape_pct": probe_mape,
                          "bar_pct": self.release_mape_pct})
        return released


def serve_fleet(
    spec: WorkloadSpec | None = None,
    *,
    config=None,
    **kwargs,
) -> dict:
    """Run the fleet serving stack on a trace-driven open-loop workload.

    The fleet analogue of :func:`repro_torch.serve.serve_workload` — same
    workload generator, same per-lane machinery, with routing in front
    (DESIGN.md §8).  All options ride in ``config``
    (:class:`repro_torch.serve.FleetConfig`); legacy keyword arguments still work
    via a ``DeprecationWarning`` shim with byte-identical results.
    ``fleet`` is the cluster count per fabric (``(32,)`` is the
    single-fabric reference; ``(16, 8, 8)`` a big+2xlittle fleet).  Fleet
    timing is always the simulated cycle domain: routing is a cycle-model
    decision, and a wall-clock fabric has no per-fabric model to score
    with.  ``execute=True`` builds one ``ServingEngine`` per fabric, each
    with its own decode caches, on ``device``; ``params`` is one weight
    tree that every lane's engine reads (the reference draws the same
    seed-0 weights for every lane, so sharing them computes the same
    function), and ``params=None`` lets each lane draw its own.  The
    engines decode unfused, as the reference's do.  ``affinity=True``
    gives every fabric a :class:`PrefixStore` and turns on the router's
    session-affinity term (DESIGN.md §13).
    """
    # Late import: repro_torch.serve.__init__ imports this module, so the config
    # machinery it defines is only reachable at call time.
    from repro_torch.serve import FleetConfig, _config_from_kwargs
    cfg = _config_from_kwargs(config, FleetConfig, kwargs, "serve_fleet")
    spec = spec or WorkloadSpec()
    if cfg.execute:
        from .batcher import model_config
        mcfg = model_config(cfg.arch, reduced=cfg.reduced)
        spec = dataclasses.replace(spec, vocab_size=mcfg.vocab_size)

    requests = spec.build(with_tokens=cfg.execute)

    engines = None
    if cfg.execute:
        from .batcher import ServingEngine
        # Size decode caches from the generated trace — multi-turn sessions
        # carry cumulative context past max(prompt_lens) (DESIGN.md §13.1).
        max_len = max((r.prompt_len + r.gen_len for r in requests),
                      default=max(spec.prompt_lens) + max(spec.gen_lens))
        engines = [ServingEngine(cfg.arch, reduced=cfg.reduced,
                                 max_batch=cfg.max_batch, max_len=max_len,
                                 mesh_shape=cfg.mesh_shape,
                                 params=cfg.params, device=cfg.device)
                   for _ in cfg.fleet]
    faults = cfg.faults
    if isinstance(faults, str):
        from repro_torch.runtime.fault import FaultInjector
        horizon = max((r.arrival for r in requests), default=0.0)
        faults = FaultInjector.parse(
            faults, horizon=horizon, num_lanes=len(cfg.fleet),
            seed=(derive_seed(spec.seed, "faults")
                  if cfg.fault_seed is None else cfg.fault_seed))
    fleet_obj = FabricFleet(cfg.fleet, router=cfg.router,
                            objective=cfg.objective,
                            jitter_pct=cfg.jitter_pct,
                            seed=spec.seed, max_batch=cfg.max_batch,
                            wave_boundary=cfg.wave_boundary,
                            pipeline=cfg.pipeline,
                            buffering=cfg.buffering, dvfs=cfg.dvfs,
                            engines=engines,
                            tracer=cfg.tracer, residuals=cfg.residuals,
                            faults=faults, recovery=cfg.recovery,
                            ckpt_every=cfg.ckpt_every, tie_seed=cfg.tie_seed,
                            affinity=cfg.affinity,
                            prefix_capacity=cfg.prefix_capacity,
                            priority=cfg.priority, preempt=cfg.preempt,
                            shed_depth=cfg.shed_depth)
    out = fleet_obj.run(requests)
    out["arch"] = cfg.arch
    out["spec"] = spec
    out["faults"] = faults
    out["config"] = cfg
    return out
