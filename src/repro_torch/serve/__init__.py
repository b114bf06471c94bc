"""Offload-aware serving: the paper's offload decision made online.

The port of ``repro/serve/__init__.py``.  It serves a *stream* of
generation requests:

    workload.WorkloadSpec.build  -> trace-driven request stream (Poisson /
                                    Gamma / MMPP arrivals, heavy-tail
                                    lengths, multi-turn sessions, tenant
                                    SLO classes — DESIGN.md §13)
    queue.RequestQueue           -> arrival-ordered admission bookkeeping
    scheduler.OffloadAwareScheduler
                                 -> Eq.-3 admission control + per-batch
                                    parallel extent M from the fitted model
    calibrator.OnlineCalibrator  -> sliding-window least-squares refit of
                                    (alpha, beta, gamma) from measured step
                                    timings
    batcher.ContinuousBatcher    -> slot-managed continuous batching with
                                    per-slot cache lengths and mid-wave
                                    admission (DESIGN.md §6); pipeline=True
                                    drives the async fabric protocol
                                    (DESIGN.md §7)
    batcher.ServingEngine        -> the prefill/decode steps on the card
    prefix.PrefixStore           -> per-fabric prefix-KV residency with LRU
                                    capacity
    metrics.ServeMetrics         -> throughput / p99 latency / SLO
                                    attainment / queue delay / occupancy /
                                    goodput / prefix hit accounting
    fleet.FabricFleet            -> N independent fabrics (each with its own
                                    scaled HWParams, calibrator, scheduler)
                                    behind a model-driven Router
                                    (model|rr|lql) with an optional session
                                    affinity term (DESIGN.md §8)

Everything but the engine is numpy copied from the reference, so with the
same spec and config the port's admissions, plans, traces and
``metrics.summary()`` equal the reference's.  ``serve_workload`` wires the
single-fabric stack together; ``serve_fleet`` is its fleet counterpart.
Each takes its knobs as one frozen config object —
``serve_workload(spec, config=ServeConfig(...))`` /
``serve_fleet(spec, config=FleetConfig(...))``.
"""

from __future__ import annotations

import dataclasses
import warnings

from repro_torch.runtime.fault import FaultEvent, FaultInjector

from .batcher import (ContinuousBatcher, PendingStep, ServingEngine,
                      model_config)
from .fleet import (RECOVERY_MODES, ROUTER_OBJECTIVES, ROUTER_POLICIES,
                    FabricFleet, FleetLane, RouteDecision, Router,
                    fabric_prior, serve_fleet)
from .calibrator import CalibrationSnapshot, OnlineCalibrator
from .fabric import CompletedJob, SimulatedFabric, WallClockFabric
from .metrics import FleetMetrics, ServeMetrics
from .prefix import DEFAULT_CAPACITY_TOKENS, PrefixStore
from .queue import Request, RequestQueue, RequestState
from .scheduler import AdmissionDecision, BatchPlan, OffloadAwareScheduler
from .workload import (ARRIVALS, CYCLES_PER_SECOND, LENGTH_DISTS,
                       TENANT_CLASSES, TenantClass, Workload, WORKLOADS,
                       WorkloadSpec, derive_seed, synthetic_workload,
                       workload_for)

__all__ = [
    "AdmissionDecision", "ARRIVALS", "BatchPlan", "CalibrationSnapshot",
    "CompletedJob", "ContinuousBatcher", "CYCLES_PER_SECOND",
    "DEFAULT_CAPACITY_TOKENS", "FabricFleet", "FaultEvent",
    "FaultInjector", "FleetConfig", "FleetLane", "FleetMetrics",
    "LENGTH_DISTS", "OffloadAwareScheduler",
    "OnlineCalibrator", "PendingStep", "PrefixStore", "RECOVERY_MODES",
    "Request", "RequestQueue", "RequestState", "ROUTER_OBJECTIVES",
    "ROUTER_POLICIES", "RouteDecision", "Router", "ServeConfig",
    "ServeMetrics", "ServingEngine", "SimulatedFabric", "TenantClass",
    "TENANT_CLASSES", "WallClockFabric", "Workload", "WORKLOADS",
    "WorkloadSpec", "derive_seed", "fabric_prior",
    "serve_fleet", "serve_workload", "synthetic_workload", "workload_for",
]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Every knob of the single-fabric serving stack, as one frozen value.

    The reference's fields, names and defaults, and three of the port's
    own: ``device`` (``"cuda"``, the default, or ``"cpu"``) is where the
    engine runs, resolved only when ``execute=True``; ``params`` is a port
    parameter tree for the engine (e.g. the reference's, carried across by
    ``models.convert``) in place of the seeded random weights; ``mesh`` is
    a ``DeviceMesh`` the caller built, of shape ``mesh_shape``, to serve
    on.  ``arch`` may also be a ``ModelConfig`` (e.g. one with its depth
    cut).  ``mesh_shape`` goes to the engine: other than ``(1, 1)`` it
    serves on a (data, model) ``DeviceMesh`` of that shape over the
    caller's ``torch.distributed`` process group (``ServingEngine``).
    """

    arch: str = "chatglm3-6b"
    reduced: bool = True
    execute: bool = True
    max_batch: int = 4
    mesh_shape: tuple = (1, 1)
    jitter_pct: float = 1.0
    fabric: str = "simulated"
    calibrator: OnlineCalibrator | None = None
    available_m: tuple = (1, 2, 4, 8, 16, 32)
    design: object | None = None
    wave_boundary: bool = False
    pipeline: bool = False
    buffering: str | None = None
    dvfs: object = None
    tracer: object = None
    residuals: object = None
    faults: object = None
    fault_seed: int | None = None
    fused_decode: bool = False
    # --- session affinity + tenant classes (DESIGN.md §13) ---
    affinity: bool = False                      # warm-hit prefill skipping
    prefix_capacity: int = DEFAULT_CAPACITY_TOKENS
    priority: bool = False                      # tenant-class queue ordering
    preempt: bool = False                       # evict for higher classes
    shed_depth: dict | None = None              # priority -> backlog cap
    # --- the port's own ---
    device: str = "cuda"
    params: object = None
    mesh: object = None


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Every knob of the fleet serving stack (:func:`serve_fleet`).

    The reference's fields, names and defaults, and the same two of the
    port's own as :class:`ServeConfig`: ``device`` (``"cuda"``, the
    default, or ``"cpu"``, resolved only when ``execute=True``) is where
    every lane's engine runs, and ``params`` is one port parameter tree
    that every lane's engine reads (``None``: each lane draws its own
    seeded weights, as in the reference).  ``mesh_shape`` goes to every
    lane's engine, as in the reference.
    """

    fleet: tuple = (32,)                        # cluster count per fabric
    router: str = "model"
    objective: str = "latency"
    arch: str = "chatglm3-6b"
    reduced: bool = True
    execute: bool = False
    max_batch: int = 4
    mesh_shape: tuple = (1, 1)
    jitter_pct: float = 1.0
    wave_boundary: bool = False
    pipeline: bool = False
    buffering: str | None = None
    dvfs: object = None
    tracer: object = None
    residuals: object = None
    faults: object = None
    fault_seed: int | None = None
    recovery: str = "restore"
    ckpt_every: int = 4
    tie_seed: int | None = None
    # --- session affinity + tenant classes (DESIGN.md §13) ---
    affinity: bool = False                      # router affinity term + hits
    prefix_capacity: int = DEFAULT_CAPACITY_TOKENS
    priority: bool = False
    preempt: bool = False
    shed_depth: dict | None = None
    # --- the port's own ---
    device: str = "cuda"
    params: object = None


def _config_from_kwargs(config, cls, kwargs: dict, fn_name: str):
    """The deprecation shim behind both serving entry points.

    Legacy keyword call sites keep working — each kwarg overrides the
    matching config field via ``dataclasses.replace``, so the result is
    identical to passing the equivalent config — but they warn: the config
    object is the API (unknown names raise ``TypeError``).
    """
    if kwargs:
        warnings.warn(
            f"passing {fn_name}() options as keyword arguments is "
            f"deprecated; pass config={cls.__name__}(...) instead",
            DeprecationWarning, stacklevel=3)
        return dataclasses.replace(config or cls(), **kwargs)
    return config or cls()


def serve_workload(
    spec: WorkloadSpec | None = None,
    *,
    config: ServeConfig | None = None,
    **kwargs,
) -> dict:
    """Run the full serving stack on a trace-driven open-loop workload.

    All options ride in ``config`` (:class:`ServeConfig`); keyword
    arguments still work through a ``DeprecationWarning`` shim with
    identical results.  Field semantics are the reference's:

    ``fused_decode=True`` runs every decode step's attention through the
    fused CUDA decode-attention kernel (one call per layer, the same
    tokens).  Only meaningful with ``execute=True``.

    ``faults`` attaches a :class:`repro_torch.runtime.fault.FaultInjector`
    (or a ``--faults`` spec string) against lane 0; with no fleet behind
    this path a crash's orphans are FAILED and reported as ``dropped``.

    ``execute=False`` runs no engine (no tokens generated, nothing on any
    device) and exercises only the queue/scheduler/calibrator/clock
    machinery.

    ``wave_boundary=True`` disables mid-wave admission (requests join only
    at wave boundaries); ``pipeline=True`` drives the asynchronous fabric
    protocol (refill prefills submitted under in-flight decode work on a
    double-buffered fabric).  ``buffering`` overrides the fabric's
    descriptor depth.

    ``fabric`` picks the timing source: ``"simulated"`` (Manticore cycle
    model) or ``"wallclock"`` (the engine's measured step times — needs
    ``execute=True``; the calibrator then tracks the live host and card).

    ``design`` serves a swept co-design point
    (``repro_torch.dse.DesignPoint``) instead of the paper's extended
    design: the simulated fabric runs that design's hardware, dispatch,
    sync and kernel, and — unless an explicit ``calibrator`` is passed —
    the scheduler's prior becomes the design's own Eq.-1 refit rather than
    ``PAPER_MODEL`` (DESIGN.md §3.4).  The engine, if any, is the same.

    ``tracer`` (a :class:`repro_torch.obs.Tracer`) records the run as
    structured spans and ``residuals`` (a
    :class:`repro_torch.obs.ResidualTracker`) pairs every prediction with
    its measured outcome.  ``affinity``, ``priority``, ``preempt`` and
    ``shed_depth`` are the session-affinity/tenant layer, default-off.
    """
    cfg = _config_from_kwargs(config, ServeConfig, kwargs, "serve_workload")
    spec = spec or WorkloadSpec()
    calibrator = cfg.calibrator
    buffering = cfg.buffering
    if cfg.design is not None and cfg.fabric != "simulated":
        raise ValueError("design= requires the simulated fabric")
    if buffering is None:
        buffering = (getattr(cfg.design, "buffering", None)
                     or ("double" if cfg.pipeline else "single"))
    if calibrator is None:
        if cfg.design is not None:
            from repro_torch.dse.runner import refit_design
            prior, _ = refit_design(cfg.design, force_eq1=True)
            calibrator = OnlineCalibrator(prior=prior)
        else:
            calibrator = OnlineCalibrator()
    if cfg.fabric == "simulated":
        if cfg.design is not None:
            fabric_src = SimulatedFabric.for_design(cfg.design,
                                                    jitter_pct=cfg.jitter_pct,
                                                    seed=spec.seed)
            if buffering != fabric_src.buffering or cfg.dvfs is not None:
                fabric_src = SimulatedFabric(
                    hw=fabric_src.hw, kernel=fabric_src.kernel,
                    dispatch=fabric_src.dispatch, sync=fabric_src.sync,
                    jitter_pct=cfg.jitter_pct, seed=spec.seed,
                    buffering=buffering, dvfs=cfg.dvfs)
            # Plan host fallbacks against the design's own hardware/kernel.
            from repro_torch.core import simulator as _sim
            host_model = lambda n: float(_sim.host_runtime(  # noqa: E731
                n, hw=fabric_src.hw, kernel=fabric_src.kernel))
        else:
            # The fabric is sized to the configured extent grid:
            # interconnect parameters scale with the cluster count
            # (simulator.scaled_hw; identity at the paper's 32-cluster
            # reference).
            fabric_src = SimulatedFabric(jitter_pct=cfg.jitter_pct,
                                         seed=spec.seed,
                                         num_clusters=max(cfg.available_m),
                                         buffering=buffering, dvfs=cfg.dvfs)
            host_model = None  # Manticore host fallback (same cycle domain)
    elif cfg.fabric == "wallclock":
        if not cfg.execute:
            raise ValueError("fabric='wallclock' needs execute=True: the "
                             "engine's measurements are the job runtimes")
        fabric_src = WallClockFabric()
        # The engine executes every job — there is no host fallback whose
        # runtime lives in the wall-cycle domain, so never "keep on host".
        host_model = lambda n: float("inf")  # noqa: E731
    else:
        raise ValueError(f"unknown fabric {cfg.fabric!r}")
    proc = f"f0:{max(cfg.available_m)}c"
    if cfg.tracer is not None:
        calibrator.tracer = cfg.tracer
        calibrator.proc = proc
        if isinstance(fabric_src, SimulatedFabric):
            fabric_src.proc = proc
            fabric_src.engine.tracer = cfg.tracer
            fabric_src.engine.proc = proc
    scheduler = OffloadAwareScheduler(calibrator,
                                      available_m=cfg.available_m,
                                      host_model=host_model,
                                      tracer=cfg.tracer, proc=proc,
                                      shed_depth=cfg.shed_depth)

    if cfg.execute:
        mcfg = model_config(cfg.arch, reduced=cfg.reduced)
        spec = dataclasses.replace(spec, vocab_size=mcfg.vocab_size)

    requests = spec.build(with_tokens=cfg.execute)

    engine = None
    if cfg.execute:
        # Size the decode cache from the *generated* trace: multi-turn
        # sessions carry cumulative context, so a later turn's prompt can
        # exceed max(prompt_lens) by the whole conversation so far.
        max_len = max((r.prompt_len + r.gen_len for r in requests),
                      default=max(spec.prompt_lens) + max(spec.gen_lens))
        engine = ServingEngine(cfg.arch, reduced=cfg.reduced,
                               max_batch=cfg.max_batch, max_len=max_len,
                               mesh_shape=cfg.mesh_shape,
                               fused_decode=cfg.fused_decode,
                               params=cfg.params, device=cfg.device,
                               mesh=cfg.mesh)
        if cfg.fabric == "wallclock":
            # First-call costs must not enter the measured step times the
            # calibrator fits (see ServingEngine.warmup).
            engine.warmup(sorted({r.prompt_len for r in requests}),
                          slots=not cfg.wave_boundary)
    faults = cfg.faults
    if isinstance(faults, str):
        horizon = max((r.arrival for r in requests), default=0.0)
        faults = FaultInjector.parse(
            faults, horizon=horizon, num_lanes=1,
            seed=(derive_seed(spec.seed, "faults")
                  if cfg.fault_seed is None else cfg.fault_seed))
    prefix_store = PrefixStore(cfg.prefix_capacity) if cfg.affinity else None
    batcher = ContinuousBatcher(scheduler, calibrator, fabric=fabric_src,
                                engine=engine, max_batch=cfg.max_batch,
                                wave_boundary=cfg.wave_boundary,
                                pipeline=cfg.pipeline, tracer=cfg.tracer,
                                residuals=cfg.residuals, proc=proc,
                                faults=faults, fault_lane=0,
                                prefix_store=prefix_store,
                                priority=cfg.priority, preempt=cfg.preempt)
    out = batcher.run(requests)
    if out["orphans"]:
        # No fleet behind this path: a crash's orphans have nowhere to go.
        for r in out["orphans"]:
            r.state = RequestState.FAILED
            batcher.metrics.dropped += 1
        out["requests"] = sorted(out["requests"] + out["orphans"],
                                 key=lambda r: r.rid)
    out["arch"] = cfg.arch
    out["spec"] = spec
    out["faults"] = faults
    out["config"] = cfg
    return out
