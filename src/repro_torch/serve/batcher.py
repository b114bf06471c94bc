"""Continuous batcher and serving engine: the request stream as offload jobs.

The port of ``repro/serve/batcher.py``.  ``ContinuousBatcher`` owns the
serving loop: decode state is held in ``max_batch`` request slots with
per-slot cache lengths, every decode job steps all occupied slots at once,
and a freed slot is refilled mid-wave through a prefill-into-slot job
(DESIGN.md §6).  Every job goes through the offload-aware scheduler, its
measured runtime comes from the fabric timing source, advances the
open-loop virtual clock and feeds the online calibrator.  The loop logic
(continuous, ``wave_boundary``, pipelined, preemption, the fault hooks and
``_maybe_checkpoint``) is numpy and is copied from the reference, so the
port's schedules, plans and metrics are bit-identical to the reference's.

``ServingEngine`` runs the steps.  Each job is the paper's offload round
trip on the card: operands placed by the multicast dispatcher
(``DispatchStats`` seconds), the step launched, and completion learned from
the credit counter (``CreditCounterSync``).  It has the reference's
methods, arguments and return values, with these differences:
  * ``params=`` takes a port parameter tree (e.g. the reference's own,
    carried across by ``models.convert``); without it the parameters are
    drawn from a ``torch.Generator`` seeded with ``param_seed``;
  * ``device=`` selects the card (default ``"cuda"``) or the CPU;
  * ``arch`` may be a ``ModelConfig`` instead of an arch id;
  * the engine owns its caches: they are allocated once, ``init_caches``
    zeroes them and returns them, every step updates them in place and
    returns them, and a step handed other caches raises.  They are the
    compiled steps' donated buffers, so they never move;
  * ``mesh_shape`` (the reference's) other than ``(1, 1)`` builds a
    ``DeviceMesh`` over the caller's ``torch.distributed`` process group,
    and ``mesh=`` takes one the caller built (a 1x1 mesh, say): params and
    caches are then DTensors placed by ``param_specs`` and ``cache_specs``,
    each step runs on the mesh, and the credit threshold is the mesh's
    device count.  The mesh's device type must be ``device``'s.  Otherwise
    the engine is the plain one-device path, whatever process group is
    initialised, and runs no DTensor op.

The steps are compiled as the reference's are (``launch.compile``): one
``CompiledStep`` for the decode step and one per prompt length for each
prefill (the reference's ``_dec_jit``, ``_prefill_jit`` and
``_slot_prefill_jit``), with the parameters and the engine's caches as
static arguments.  On the card the first call of each captures a CUDA
graph and every later call copies its inputs in and replays it;
``warmup`` makes those first calls.  On the CPU the same steps run
eagerly on their static buffers.

Every step of one engine is queued on one CUDA stream, so the pipelined
loop's refill prefill, queued behind the decode it overlaps, runs after
that decode on the card.  Right after a step is queued, its credits and
next tokens are copied into the step's own pinned host buffers
(``non_blocking``) and its ``done`` event is recorded behind those copies;
the host's wait is on that event, so it waits for its own step alone, as
the reference's reads of its own buffers do, and not for a prefill queued
after it.  The loop's tokens are those of the sequential loops all the
same.  Queueing a step never syncs the host:
every input crosses in one pinned ``non_blocking`` copy on the
dispatcher's copy stream, the prompt tokens' timed placement waits for
that copy alone, the copy into a graph's input buffers is queued on the
compute stream behind it, and the slot merge picks rows on the card.

With a tracer (``ServingEngine.trace_to``, which a ``ContinuousBatcher``
given a tracer and an engine calls), the engine records each call as a
span on the host clock of ``repro_torch.obs`` (the ``engine`` track of the
lane's ``wall:`` process): ``decode`` or ``prefill``, with the call's
sequence number, its compiled step's name and key, the rows it computes
and keeps and ``state_bytes``, the cache bytes its step reads and writes
(``models.cache_bytes`` over the call's lengths: every row's cache below
its length read and the new positions written; a slot prefill's merge
into the live caches is not counted), holding in order ``dispatch`` (operand placement), ``copy_in``,
``replay`` (or ``capture`` at a key's first call), ``copy_out`` (the
compiled step's phases), ``readback`` (the pinned copies and the event)
and ``wait`` (the event and the credit read).  A step launched while
another is in flight (the pipelined loop's refill) goes on the
``engine:overlap`` track.  The batcher adds ``admit``, ``plan``,
``calibrator`` and ``place`` spans on the ``batcher`` track.  Without a
tracer each site costs one ``is not None`` check and reads no clock.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.dispatch import MulticastDispatcher
from repro_torch.core.sync import CreditCounterSync, FaultDetected
from repro_torch.launch.compile import CompiledStep
from repro_torch.launch.device import resolve_device
from repro_torch.launch.mesh import host_mesh
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_slot_prefill_step, zero_caches)
from repro_torch.core import simulator as sim
from repro_torch.kernels.ops import get_kernel
from repro_torch.models import (ModelConfig, cache_bytes, init_cache,
                                init_params, scaled_down)
from repro_torch.runtime.sharding import cache_specs, param_specs, to_shardings

from .calibrator import OnlineCalibrator
from .fabric import SimulatedFabric, WallClockFabric
from .metrics import ServeMetrics
from .prefix import PrefixStore
from .queue import Request, RequestQueue, RequestState
from .scheduler import BatchPlan, OffloadAwareScheduler


def model_config(arch: str | ModelConfig, *, reduced: bool) -> ModelConfig:
    """An arch id's config, or a ``ModelConfig`` as given (e.g. one with
    its depth cut); ``reduced`` applies ``scaled_down`` to either."""
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    return scaled_down(cfg) if reduced else cfg


@dataclasses.dataclass
class PendingStep:
    """A launched-but-not-awaited engine step.

    PyTorch queues the step's kernels on the card's stream and returns;
    ``out`` holds its output tensors (including the credit scalar) and
    ``done`` an event recorded after its last kernel.  Blocking happens in
    ``ServingEngine.wait_step``.

    ``launch_s`` is the host time spent queueing the step's kernels: a
    graph's input copies, its replay and its output copies, or, for a
    step's first call and under ``disable_compile()``, every op queued
    from Python, which takes as long as or longer than the card's work.
    The credit wait alone would miss that part of the step.

    ``host`` holds, on the card, the step's own pinned host copies of its
    credits and next tokens, which ``done`` follows on the stream.
    """

    out: dict
    dispatch_s: float = 0.0        # measured operand-placement seconds
    launch_s: float = 0.0          # measured kernel-queueing seconds
    done: torch.cuda.Event | None = None
    host: dict | None = None
    trace: "_CallTrace | None" = None   # with a tracer: the call so far


class ServingEngine:
    """Compiled prefill/decode steps over ``max_batch`` request slots on one
    device, or on a ``DeviceMesh`` (``mesh_shape``)."""

    def __init__(self, arch: str | ModelConfig, *, reduced: bool = True,
                 max_batch: int = 4, max_len: int = 64, mesh_shape=(1, 1),
                 param_seed: int = 0, fused_decode: bool = False,
                 params=None, device: str | torch.device = "cuda",
                 mesh=None):
        cfg = model_config(arch, reduced=reduced)
        if cfg.frontend == "vision_patches":
            cfg = dataclasses.replace(cfg, frontend="")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = host_mesh(mesh_shape, self.device, mesh=mesh)
        self.max_batch = max_batch
        self.max_len = max_len
        # Fused decode step: one kernel launch per attention layer instead
        # of separate rope/scatter/attend ops, the same tokens.
        self.fused_decode = fused_decode
        self.dispatcher = MulticastDispatcher()
        self.sync = CreditCounterSync(self.mesh)
        # Host-clock tracing (``trace_to``): off by default.
        self.tracer = None
        self.trace_proc = "fabric"
        self._marks: list = []         # the compiled steps' phases
        self._calls = 0                # traced calls so far
        self._in_flight = 0            # traced steps launched, not waited
        #: Credits read by the most recent completed step.
        self.last_credits: int | None = None
        self.params = (params if params is not None else
                       init_params(cfg, seed=param_seed, device=self.device))
        if self.mesh is not None:
            self.params = to_shardings(
                self.params, param_specs(self.params, cfg, self.mesh),
                self.mesh)
        # The live caches: the compiled steps' donated buffers, allocated
        # once, before and outside any capture.
        self._caches = init_cache(cfg, max_batch, max_len=max_len,
                                  device=self.device)
        if self.mesh is not None:
            self._caches = to_shardings(
                self._caches, cache_specs(self._caches, cfg, self.mesh),
                self.mesh)
        #: One memory pool for all of this engine's graphs.
        self.pool = (torch.cuda.graph_pool_handle()
                     if self.device.type == "cuda" else None)
        kw = {"max_len": max_len, "device": self.device, "mesh": self.mesh}
        self._prefill_fn = make_prefill_step(cfg, max_batch, **kw)
        self._slot_prefill_fn = make_slot_prefill_step(cfg, max_batch, **kw)
        self._prefill_jit: dict[int, CompiledStep] = {}   # prompt_len -> step
        self._slot_prefill_jit: dict[int, CompiledStep] = {}
        self._dec_jit = self._compiled(
            make_decode_step(cfg, fused=fused_decode, mesh=self.mesh),
            "decode")

    def _compiled(self, fn, name: str) -> CompiledStep:
        """``fn(params, x, caches, ...)`` compiled with the parameters and
        the caches static."""
        step = CompiledStep(fn, device=self.device, static_argnums=(0, 2),
                            pool=self.pool, name=name)
        if self.tracer is not None:
            step.marks = self._marks
        return step

    def trace_to(self, tracer, proc: str = "fabric") -> None:
        """Record every later call as host-clock spans on ``tracer``
        (a ``repro_torch.obs.Tracer``) under ``proc``; None stops it."""
        self.tracer = tracer or None
        self.trace_proc = proc
        self._in_flight = 0
        self._marks.clear()
        for step in self.compiled_steps():
            step.marks = self._marks if self.tracer is not None else None

    def _get_prefill(self, prompt_len: int) -> CompiledStep:
        if prompt_len not in self._prefill_jit:
            self._prefill_jit[prompt_len] = self._compiled(
                self._prefill_fn, f"prefill[{prompt_len}]")
        return self._prefill_jit[prompt_len]

    def _get_slot_prefill(self, prompt_len: int) -> CompiledStep:
        if prompt_len not in self._slot_prefill_jit:
            self._slot_prefill_jit[prompt_len] = self._compiled(
                self._slot_prefill_fn, f"slot_prefill[{prompt_len}]")
        return self._slot_prefill_jit[prompt_len]

    def compiled_steps(self) -> list[CompiledStep]:
        """Every compiled step of this engine: decode, then the prefills."""
        return [self._dec_jit, *self._prefill_jit.values(),
                *self._slot_prefill_jit.values()]

    def _own(self, caches):
        if caches is not self._caches:
            raise ValueError("a step runs on this engine's caches only: "
                             "pass those init_caches() or the previous "
                             "step returned")
        return caches

    def _launch(self, step, *args, dispatch_s: float = 0.0,
                kind: str = "decode", t_put: float = 0.0,
                rows_kept: int | None = None,
                state: tuple = ((), 0)) -> PendingStep:
        """Queue ``step(*args)`` and time the queueing.  With a tracer,
        ``t_put`` is the ``perf_counter`` reading at the start of the
        call's operand placement, which ends where the queueing starts,
        and ``state`` the (per-row lengths, new positions) whose cache
        bytes the call's span records."""
        t0 = time.perf_counter()
        out = step(*args)
        out["caches"] = self._caches      # the engine's own, as passed
        done = host = None
        tr = self.tracer
        if tr is not None:
            t_step = time.perf_counter()
        if self.device.type == "cuda":
            host = {name: _pinned_copy(t) for name, t in (
                ("credits", out["credits"]),
                ("next_token", self._whole(out["next_token"])))}
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        t1 = time.perf_counter()
        pending = PendingStep(out=out, dispatch_s=dispatch_s,
                              launch_s=t1 - t0, done=done, host=host)
        if tr is not None:
            pending.trace = self._open_call(tr, step, kind, rows_kept, [
                ("dispatch", t_put, t0, None), *self._marks,
                ("readback", t_step, t1, None)], state)
            self._marks.clear()
        return pending

    def _open_call(self, tr, step, kind: str, rows_kept: int | None,
                   phases: list, state: tuple = ((), 0)) -> "_CallTrace":
        """A traced call's record at its launch."""
        self._calls += 1
        args = {"seq": self._calls, "step": step.name,
                "key": next((a["key"] for _, _, _, a in phases
                             if a and "key" in a), None),
                "rows_computed": self.max_batch,
                "state_bytes": cache_bytes(self.cfg, *state)}
        if rows_kept is not None:
            args["rows_kept"] = rows_kept
        track = "engine:overlap" if self._in_flight else "engine"
        self._in_flight += 1
        return _CallTrace(tr, kind, track, args, phases)

    def _whole(self, t: torch.Tensor) -> torch.Tensor:
        return t.full_tensor() if self.mesh is not None else t

    def _fresh_state(self, length: int) -> tuple:
        """A prefill's (lengths, new positions): every row it computes,
        from nothing."""
        return (0,) * self.max_batch, length

    def init_caches(self):
        """The engine's decode caches, zeroed, for the slot-managed loop."""
        return zero_caches(self._caches)

    def prefill(self, tokens: np.ndarray, metrics=None):
        """tokens (max_batch, L) int32 -> (next_token (B,), caches, wall_s).

        The prefill fills the engine's caches afresh.  ``wall_s`` is the
        measured offload time of the step: the multicast placement
        seconds, the kernel-queueing seconds and the credit-counter
        blocking wait.
        """
        tokens = np.asarray(tokens, np.int32)
        step = self._get_prefill(tokens.shape[1])
        placed, dstats = self.dispatcher.timed_put(tokens, self.device)
        if metrics is not None:
            metrics.record_dispatch(dstats)
        return self.wait_step(self._launch(
            step, self.params, {"tokens": placed}, self._caches,
            dispatch_s=dstats.seconds, kind="prefill", t_put=dstats.t0,
            state=self._fresh_state(tokens.shape[1])))

    def prefill_into_slots_async(self, tokens: np.ndarray, caches,
                                 slot_mask: np.ndarray,
                                 metrics=None) -> PendingStep:
        """Launch a prefill-into-slots step without blocking on it."""
        tokens = np.asarray(tokens, np.int32)
        slot_mask = np.asarray(slot_mask, bool)
        step = self._get_slot_prefill(tokens.shape[1])
        placed, dstats = self.dispatcher.timed_put(tokens, self.device)
        if metrics is not None:
            metrics.record_dispatch(dstats)
        mask = self.dispatcher.put(slot_mask, self.device)
        return self._launch(step, self.params, {"tokens": placed},
                            self._own(caches), mask,
                            dispatch_s=dstats.seconds, kind="prefill",
                            t_put=dstats.t0,
                            rows_kept=(int(np.count_nonzero(slot_mask))
                                       if self.tracer is not None else None),
                            state=self._fresh_state(tokens.shape[1]))

    def prefill_into_slots(self, tokens: np.ndarray, caches,
                           slot_mask: np.ndarray, metrics=None):
        """Prefill the ``slot_mask`` rows of ``tokens`` into live ``caches``;
        returns (next_token (B,), caches, wall_s) like :meth:`prefill`."""
        return self.wait_step(
            self.prefill_into_slots_async(tokens, caches, slot_mask, metrics))

    def warmup(self, prompt_lens, *, slots: bool = False) -> None:
        """Run every prompt-length bucket (and the decode step) once.

        The first call of each compiled step runs it eagerly and captures
        its graph; on the card it also pays the kernel build, cuBLAS
        handles and heuristics.  A wall-clock calibration should see none
        of that.  The longest prompt goes first, so the shorter prefills'
        captures reuse its transients in the engine's graph pool.
        Decoding zero tokens may give non-finite logits, so a fault here is
        ignored.
        """
        for length in sorted(set(prompt_lens), reverse=True):
            tokens = np.zeros((self.max_batch, length), np.int32)
            if slots:
                caches = self.init_caches()
                mask = np.zeros(self.max_batch, bool)
                mask[0] = True
                _, caches, _ = self.prefill_into_slots(tokens, caches, mask)
            else:
                _, caches, _ = self.prefill(tokens)
            tok = np.zeros((self.max_batch, 1), np.int32)
            try:
                self.decode(tok, caches, length)
            except FaultDetected:  # pragma: no cover - warmup is best-effort
                pass

    def decode_async(self, tok: np.ndarray, caches, lens) -> PendingStep:
        """Launch one decode step without blocking on its completion."""
        t_put = time.perf_counter() if self.tracer is not None else 0.0
        lens = np.asarray(lens, np.int32)
        if lens.ndim == 0:
            lens = np.full((self.max_batch,), int(lens), np.int32)
        tok_t, lens_t = self.dispatcher.put((np.asarray(tok, np.int32), lens),
                                            self.device)
        return self._launch(self._dec_jit, self.params, tok_t,
                            self._own(caches), lens_t, t_put=t_put,
                            state=(lens, 1))

    def decode(self, tok: np.ndarray, caches, lens):
        """tok (max_batch, 1) int32 -> (next_token (B,), caches, wall_s).

        ``lens`` is the per-slot cache length — an int or a (max_batch,)
        vector.  ``wall_s`` is the kernel-queueing seconds plus the
        credit-counter blocking wait.
        """
        return self.wait_step(self.decode_async(tok, caches, lens))

    def step_ready(self, pending: PendingStep) -> bool:
        """Non-blocking completion probe of a launched step."""
        if pending.done is None:
            return True   # CPU ops run to completion before they return
        return pending.done.query()

    def wait_step(self, pending: PendingStep):
        """Block on a launched step; returns (next_token, caches, wall_s).

        ``wall_s`` is the dispatch seconds (when the step placed operands),
        the kernel-queueing seconds and the residual blocking wait on the
        credit scalar.  On the card that wait is on the step's own event,
        behind its host copies; on the CPU the outputs are read as they are.
        """
        call = pending.trace
        if call is not None:
            t_wait = time.perf_counter()
        if pending.host is None:
            got, wait_s = self.sync.timed_wait(pending.out["credits"])
            next_token = self._whole(pending.out["next_token"]).cpu()
        else:
            got, wait_s = self.sync.timed_wait(pending.host["credits"],
                                               ready=pending.done)
            next_token = pending.host["next_token"]
        self.last_credits = got
        wall_s = pending.dispatch_s + pending.launch_s + wait_s
        if call is not None:
            self._in_flight -= 1
            call.close(self.trace_proc, t_wait, time.perf_counter(), {
                "dispatch_s": pending.dispatch_s,
                "launch_s": pending.launch_s, "wait_s": wait_s,
                "wall_s": wall_s})
        return next_token.numpy(), pending.out["caches"], wall_s


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a new pinned host tensor, queued on the current
    stream without a host sync."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=True)


@dataclasses.dataclass
class _CallTrace:
    """One traced engine call between its launch and its wait: its phases
    as ``(name, start, end, args)`` with ``perf_counter`` readings."""

    tracer: object
    kind: str                      # "decode" | "prefill"
    track: str
    args: dict
    phases: list

    def close(self, proc: str, t_wait: float, t_waited: float,
              times: dict) -> None:
        """Record the call span, then its phases, ``wait`` last.  The call
        span ends after this recording, which it holds outside any phase,
        so the call's host time is all inside it."""
        tr = self.tracer
        self.phases.append(("wait", t_wait, t_waited, None))
        t0 = self.phases[0][1]
        tr.span(proc, self.track, self.kind, tr.at(t0), 0.0,
                domain="wall_s", args={**self.args, **times})
        call = tr.events[-1]
        for name, a, b, args in self.phases:
            tr.span(proc, self.track, name, tr.at(a), b - a,
                    domain="wall_s", args=args)
        call.dur = time.perf_counter() - t0


@dataclasses.dataclass
class _InflightPrefill:
    """A submitted-but-not-retired refill prefill (pipelined loop)."""

    handle: object                 # async-fabric job handle
    plan: BatchPlan
    batch: list                    # the admitted requests
    take: list                     # their target slots
    prompt_len: int
    tokens: np.ndarray | None = None   # real-engine inputs (deferred dispatch)
    mask: np.ndarray | None = None
    pending: PendingStep | None = None
    overlapped: int = 0            # decode steps run under this prefill


class ContinuousBatcher:
    """The serving loop: queue -> slots -> scheduled jobs -> results."""

    def __init__(self, scheduler: OffloadAwareScheduler,
                 calibrator: OnlineCalibrator, *,
                 fabric: SimulatedFabric | WallClockFabric | None = None,
                 engine: ServingEngine | None = None,
                 max_batch: int | None = None,
                 metrics: ServeMetrics | None = None,
                 wave_boundary: bool = False,
                 pipeline: bool = False,
                 tracer=None, residuals=None,
                 proc: str = "fabric", flow: bool = False,
                 faults=None, fault_lane: int = 0,
                 ckpt=None, ckpt_every: int = 4,
                 prefix_store: PrefixStore | None = None,
                 priority: bool = False, preempt: bool = False):
        self.scheduler = scheduler
        self.calibrator = calibrator
        self.fabric = fabric or SimulatedFabric(
            buffering="double" if pipeline else "single",
            tracer=tracer, proc=proc)
        self.engine = engine
        self.max_batch = (engine.max_batch if engine is not None
                          else (max_batch or 4))
        if engine is not None and max_batch not in (None, engine.max_batch):
            raise ValueError("max_batch conflicts with engine.max_batch")
        self.metrics = metrics or ServeMetrics()
        if pipeline and wave_boundary:
            raise ValueError("pipeline and wave_boundary are exclusive")
        if pipeline and not hasattr(self.fabric, "submit"):
            raise ValueError("pipeline=True needs a fabric speaking the "
                             "async protocol (submit/ready/complete)")
        self.wave_boundary = wave_boundary
        self.pipeline = pipeline
        # Observability (repro.obs) — all optional, zero-cost when unset:
        #   tracer    span/instant/counter sink (request lifecycle on the
        #             "requests" track, scheduled jobs on "jobs", slot
        #             occupancy on "slots", drift instants on "residuals");
        #   residuals ResidualTracker pairing every plan's t_pred with the
        #             measured job time (the calibrator's sample stream);
        #   proc      trace process name (the lane name under a fleet);
        #   flow      close router->execution flow arrows (fleet only, so
        #             single-fabric traces stay event-identical to a 1-lane
        #             fleet modulo routing).
        self.tracer = tracer
        self.residuals = residuals
        self.proc = proc
        self.flow = flow
        # With an engine attached, the tracer also gets host-clock spans:
        # the engine's calls (it is handed the tracer here) and the
        # batcher's admit/plan/calibrator/place phases.
        self._host = tracer if tracer and engine is not None else None
        if engine is not None and hasattr(engine, "trace_to"):
            engine.trace_to(self._host, proc)
        # Fault injection (DESIGN.md §10) — all optional, zero-cost when
        # unset.  ``faults`` is a runtime.fault.FaultInjector; ``fault_lane``
        # selects which of its lanes this batcher is.  The injector is
        # polled at job/loop boundaries only — faults take effect at the
        # next engine-timeline point, never mid-span.  ``ckpt`` is a
        # ckpt.CheckpointManager snapshotting decode state every
        # ``ckpt_every`` decode steps, so a crashed lane's requests can be
        # restored instead of re-prefilled from scratch.
        self.faults = faults
        self.fault_lane = fault_lane
        self.ckpt = ckpt
        self.ckpt_every = max(1, ckpt_every)
        # Session affinity + tenant classes (DESIGN.md §13) — all optional,
        # default-off, zero-cost when unset (the PR 1–9 bit-identity).
        #   prefix_store  this lane's KV residency map; when set, admission
        #                 resolves each request's warm-hit length and prefill
        #                 jobs skip the resident tokens;
        #   priority      order the arrived backlog by tenant class;
        #   preempt       evict a running lower-priority request when a
        #                 higher class arrives and no slot is free
        #                 (continuous loop only; resumes via a restore job).
        self.prefix_store = prefix_store
        self.priority = priority
        self.preempt = preempt
        self.orphans: list[Request] = []
        self._decode_count = 0
        self._ckpt_max_gen = 1
        self._energy_ts = 0.0  # monotonic clamp for the energy counter track
        # With a real engine attached, at most one decode may overlap an
        # in-flight prefill: the prefill is chained on that decode's caches
        # (updated in place, the caches are one linear chain of steps), so a
        # second decode would consume the merged caches before its slots
        # are placed.  The pure-virtual loop has no such chain
        # and keeps decoding until the prefill's completion time.
        self._max_overlap_steps = float("inf") if engine is None else 1

    # ------------------------------------------------------------------ #
    def _form_wave(self, queue: RequestQueue, clock: float,
                   limit: int | None = None) -> list[Request]:
        """Admit newly-arrived requests; take a same-prompt-length batch.

        ``limit`` caps the batch (the number of free slots in continuous
        mode; the full slot count at a wave boundary).  Growth is
        deadline-aware: admission guarantees each request is feasible
        *alone*, but batching sums the job size N, so a candidate is only
        added while the combined job still fits the tightest member SLO at
        some configured extent (Eq. 3 on the batch).
        """
        t_host = self._host.now() if self._host is not None else 0.0
        limit = self.max_batch if limit is None else limit
        wave: list[Request] = []
        wave_n = 0
        wave_deadline: float | None = None
        arrived = queue.arrived(clock)
        for req in list(arrived):
            if req.t_admitted is None:  # admission control runs once
                self._resolve_prefix(req)
                verdict = self.scheduler.admit(req, now=clock,
                                               backlog=len(arrived))
                if not verdict.admitted:
                    queue.reject(req, verdict.reason)
                    self.metrics.rejected += 1
                    if self.tracer is not None and self.flow:
                        # Terminate the router's flow arrow here: the
                        # request's journey ends at this lane's admission.
                        self.tracer.flow_end(self.proc, "requests", "route",
                                             clock, flow=req.rid)
                    continue
                req.t_admitted = clock
                self.metrics.admitted += 1
            # Same-prompt-length bucketing: one compiled prefill shape per
            # job.  Admitted requests of another length (or beyond the free
            # slots, or breaking the batch deadline) stay queued for a later
            # job.  Prefix hits bucket too: a wave's members must share the
            # skipped-token count so the job keeps one uniform shape.
            if wave and (req.prompt_len != wave[0].prompt_len
                         or req.restore_len != wave[0].restore_len
                         or req.prefix_hit != wave[0].prefix_hit
                         or req.prefix_handoff != wave[0].prefix_handoff
                         or len(wave) >= limit):
                continue
            cand_n = wave_n + req.n_prompt_elems - req.prefix_hit
            cand_deadline = wave_deadline
            if req.slo_cycles is not None:
                cand_deadline = (req.slo_cycles if cand_deadline is None
                                 else min(cand_deadline, req.slo_cycles))
            if wave and not self.scheduler.fits_deadline(cand_n,
                                                         cand_deadline):
                continue
            wave.append(req)
            wave_n, wave_deadline = cand_n, cand_deadline
            queue.pop(req)
            req.state = RequestState.RUNNING
        if self._host is not None:
            self._host_span("admit", t_host, {"admitted": len(wave)})
        return wave

    def _host_span(self, name: str, t0: float, args: dict | None = None
                   ) -> None:
        """A batcher phase from ``t0`` to now on the host clock."""
        host = self._host
        host.span(self.proc, "batcher", name, t0, host.now() - t0,
                  domain="wall_s", args=args)

    def _plan(self, n: int, deadline, kind: str, now: float) -> BatchPlan:
        """``scheduler.plan``, a ``plan`` span on the host clock."""
        t_host = self._host.now() if self._host is not None else 0.0
        plan = self.scheduler.plan(n, deadline=deadline, kind=kind, now=now)
        if self._host is not None:
            self._host_span("plan", t_host, {"kind": kind})
        return plan

    def _resolve_prefix(self, req: Request) -> None:
        """Bind the request's warm-hit length at admission (DESIGN.md §13).

        ``prefix_hit`` is the portion of the prompt resident in this lane's
        KV store — those tokens are skipped by the prefill job (the Eq.-1
        saving of a cache hit).  The resolution happens once, *before* the
        Eq.-3 admission verdict, so a warm hit shrinks the N the deadline is
        checked against.  A router that already staged a cross-lane handoff
        marked ``prefix_handoff``; the hit then additionally prices a memcpy
        pull (:meth:`_serve_handoff`).  No store attached => no-op.
        """
        if req.prefix_id is None:
            return
        if self.prefix_store is not None and not req.prefix_resolved:
            hit = self.prefix_store.hit(req.prefix_id, req.prefix_len)
            req.prefix_hit = hit
            if hit == 0:
                req.prefix_handoff = False
            req.prefix_resolved = True
        if not req.prefix_resolved:
            return                     # affinity off: fields stay inert
        m = self.metrics
        if req.prefix_hit > 0:
            m.prefix_hits += 1
            m.prefix_hit_tokens += req.prefix_hit
            if req.prefix_handoff:
                m.prefix_handoffs += 1
        elif req.prefix_len > 0:       # turn 0 has nothing to hit
            m.prefix_misses += 1

    def _serve_handoff(self, batch: list[Request], clock: float) -> float:
        """Price a handoff wave's cross-lane KV pull (DESIGN.md §13).

        The hit portion of a handed-off prefix is copied from the peer lane
        as a pure-streaming ``memcpy`` offload at the full fabric — the same
        Eq.-1 closed form that prices crash restores (DESIGN.md §10), with
        the compute term nearly gone.  The copy is its own restore-kind job:
        it never feeds the calibrator (different kernel than the serve jobs)
        and draws no jitter, so affinity-off streams — which have no
        handoffs — stay bit-identical trivially.
        """
        n_copy = sum(r.prefix_hit for r in batch if r.prefix_handoff)
        if n_copy == 0:
            return clock
        m = self.scheduler.m_max
        hw = getattr(self.fabric, "hw", None)
        t_copy = float(sim.offload_runtime(
            m, n_copy,
            dispatch=getattr(self.fabric, "dispatch", "multicast"),
            sync=getattr(self.fabric, "sync", "credit"),
            kernel=get_kernel("memcpy"),
            **({"hw": hw} if hw is not None else {})))
        plan = BatchPlan(kind="restore", n_elems=n_copy, offload=True, m=m,
                         m_min=None, deadline=None, t_pred=t_copy,
                         slo_at_risk=False,
                         reason=f"prefix handoff: memcpy {n_copy} KV tokens")
        self.metrics.restore_jobs += 1
        self.metrics.job_cycles.add(t_copy)
        self._trace_job(plan, clock, t_copy)
        return clock + t_copy

    # ------------------------------------------------------------------ #
    # Priority preemption (DESIGN.md §13) — continuous loop only, gated
    # behind ``preempt=True``; the default path never reaches these.
    # ------------------------------------------------------------------ #
    def _preempt_victim(self, slots, emitted, queue: RequestQueue,
                        clock: float) -> int | None:
        """Pick the slot to evict for a strictly higher-priority arrival.

        Deterministic: the victim is the occupied slot with the largest
        (priority number, remaining tokens, slot index) — the least
        important request that has the most work left.  ``None`` when no
        arrived request outranks every running one.
        """
        arr = queue.arrived(clock)
        if not arr:
            return None
        best = min(r.priority for r in arr)
        occ = [i for i, s in enumerate(slots) if s is not None]
        if not occ:
            return None
        victim = max(occ, key=lambda i: (slots[i].priority,
                                         slots[i].gen_len - emitted[i], i))
        return victim if slots[victim].priority > best else None

    def _preempt_slot(self, i: int, slots, emitted, gen_buf,
                      queue: RequestQueue, clock: float) -> None:
        """Evict a running request back to the queue, progress intact.

        The slot's decode position rides out through the PR 7 restore
        fields (``restored_tokens`` / ``restore_len``): when re-admitted the
        request resumes as a restore-kind prefill instead of regenerating
        from scratch — preemption costs one restore job, not lost work.
        (Its resume therefore also counts in the ``recovered`` /
        ``recovery_delay`` metrics, same as a crash-orphan requeue.)
        """
        r = slots[i]
        r.restored_tokens = np.asarray(gen_buf[i], np.int64)
        r.restore_len = emitted[i]
        r.t_enqueued = clock
        r.requeues += 1
        r.preemptions += 1
        r.state = RequestState.QUEUED
        queue.push(r)
        slots[i] = None
        self.metrics.preempted += 1
        if self.tracer is not None:
            self.tracer.instant(self.proc, "requests", "preempted", clock,
                                args={"rid": r.rid,
                                      "restore_len": r.restore_len,
                                      "priority": r.priority})

    def _job_runtime(self, plan: BatchPlan, wall_s: float | None) -> float:
        """Measured runtime (cycles) of one job from the timing source.

        With a WallClockFabric the measurement is the real engine step's
        host-side duration (DispatchStats + CreditCounterSync.timed_wait),
        so the calibrator refits from the live system; the simulated fabric
        stands in for the Manticore RTL measurements otherwise.
        """
        if isinstance(self.fabric, WallClockFabric):
            if wall_s is None:
                raise RuntimeError("WallClockFabric needs an attached engine "
                                   "(its measurements ARE the job runtimes)")
            return self.fabric.record(wall_s)
        if plan.offload:
            return self.fabric.offload(plan.m, plan.n_elems)
        return self.fabric.host(plan.n_elems)

    def _executed_n(self, plan: BatchPlan, prompt_len: int | None) -> int:
        """The job size the engine actually executed (padded batch rows).

        Under a WallClockFabric the measured step time covers the full
        ``max_batch`` rows regardless of how many slots are occupied, so
        calibration samples must carry the executed N — otherwise the
        least-squares window ingests mismatched (N, t) pairs and the fit
        drifts (the decode-accounting bug this method fixes).
        """
        if not isinstance(self.fabric, WallClockFabric):
            return plan.n_elems        # the fabric simulated exactly plan.n
        if plan.kind == "prefill":
            return self.max_batch * int(prompt_len or 1)
        return self.max_batch

    def _complete_request(self, r: Request, queue: RequestQueue, now: float,
                          gen_buf: list[int] | None = None) -> None:
        """Per-request completion accounting, shared by both serving paths."""
        if self.engine is not None and gen_buf is not None:
            r.generated = np.asarray(gen_buf, np.int32)
        queue.finish(r, now)
        if self.prefix_store is not None and r.prefix_id is not None:
            # The finished turn's full context (prompt + generated) is what
            # the session's next turn can reuse — the workload generator
            # sets the next turn's prefix_len to exactly this (§13).
            self.prefix_store.insert(r.prefix_id, r.prompt_len + r.gen_len)
        m = self.metrics
        m.completed += 1
        m.latency_cycles.add(r.latency())
        if r.slo_met is not False:
            m.goodput_completed += 1
        if self.tracer is not None:
            self.tracer.instant(self.proc, "requests", "done", now,
                                args={"rid": r.rid, "latency": r.latency(),
                                      "slo_met": r.slo_met})

    def _record_prefill_member(self, r: Request, t_job: float,
                               clock: float) -> None:
        """Per-request prefill accounting (TTFT/SLO/first token), shared by
        both serving paths."""
        if r.t_first_token is not None:
            # Recovered request: its first token, TTFT sample and SLO
            # verdict were produced on the lane that later died — re-serving
            # must not double-count them (the verdict stands: the client
            # already received that token before the crash).
            return
        r.t_first_token = clock
        m = self.metrics
        m.ttft_cycles.add(r.ttft())
        m.tokens_generated += 1
        if r.slo_cycles is not None:
            r.slo_met = t_job <= r.slo_cycles
            if r.slo_met:
                m.slo_met += 1
            else:
                m.slo_missed += 1

    def _account_job(self, plan: BatchPlan, t_cycles: float,
                     n_exec: int | None = None, now: float = 0.0) -> None:
        """Feed counters and — for offloaded jobs — the online calibrator.

        ``now`` is the job's virtual completion time: it timestamps refit
        trace events and the residual series, never the fit itself.
        """
        if plan.offload:
            # A latency-skew fault poisons the MEASUREMENT channel only:
            # the timer the calibrator reads lies by ``factor``, while the
            # job's true time still drives the virtual clock.  Feeding the
            # skewed value to both the calibrator window and the residual
            # series is what lets drift telemetry *catch* the poisoning
            # (DESIGN.md §10): predictions diverge from reports, the
            # residual MAPE blows past the quarantine bar, and the fleet
            # resets this lane's window.
            t_report = t_cycles
            if self.faults is not None:
                f = self.faults.skew_factor(self.fault_lane, now)
                if f != 1.0:
                    t_report = t_cycles * f
                    self.metrics.skewed_jobs += 1
                    if self.tracer is not None:
                        self.tracer.instant(
                            self.proc, "faults", "fault:skew", now,
                            args={"factor": f, "t_true": t_cycles,
                                  "t_report": t_report})
            host = self._host
            if host is not None:
                t_host = host.now()
                checks = self.calibrator.refit_checks
            self.calibrator.observe(plan.m,
                                    plan.n_elems if n_exec is None
                                    else n_exec, t_report, now=now)
            if host is not None:
                self._host_span("calibrator", t_host, {
                    "refit": self.calibrator.refit_checks != checks,
                    "samples": self.calibrator.n_samples})
            if plan.kind == "prefill":
                self.metrics.prefill_jobs += 1
            elif plan.kind == "restore":
                self.metrics.restore_jobs += 1
            else:
                self.metrics.decode_jobs += 1
            if self.residuals is not None:
                # Drift telemetry: the scheduler's prediction for this job
                # vs the measured time the calibrator just windowed — same
                # sample population, so the windowed residual MAPE tracks
                # the calibrator's window MAPE (tested to <= 1pp).
                res = self.residuals.observe(self.proc, plan.kind,
                                             plan.t_pred, t_report, t=now)
                if res is not None and self.tracer is not None:
                    self.tracer.instant(
                        self.proc, "residuals", f"residual:{plan.kind}", now,
                        args={"predicted": res.predicted,
                              "actual": res.actual,
                              "ape_pct": res.ape_pct,
                              "window_mape_pct": self.residuals.mape(
                                  self.proc, plan.kind)})
        else:
            self.metrics.host_jobs += 1
        self.metrics.job_cycles.add(t_cycles)
        self._account_energy(plan, now)

    def _account_energy(self, plan: BatchPlan, now: float) -> None:
        """Joules for one completed job (DESIGN.md §11), every serving path.

        Pricing is the fabric's *deterministic* closed form — RNG-free, so
        the jitter stream and every cycle-domain timeline are untouched
        (the cycles-only bit-identity invariant).  A WallClockFabric has no
        cycle model and therefore no energy model; accounting is skipped.
        """
        price = getattr(self.fabric,
                        "offload_energy" if plan.offload else "host_energy",
                        None)
        if price is None:
            return
        e_j = (price(plan.m, plan.n_elems) if plan.offload
               else price(plan.n_elems))
        self.metrics.energy_j += e_j
        if plan.offload:
            observe = getattr(self.calibrator, "observe_energy", None)
            if observe is not None:
                observe(plan.m, plan.n_elems, e_j)
        if self.tracer is not None:
            # Cumulative joules as one counter series per lane; completion
            # times of interleaved prefill/decode jobs may locally reorder,
            # so clamp to keep the series monotonically timestamped (the
            # tools/check_trace.py counter rule).
            self._energy_ts = max(self._energy_ts, now)
            self.tracer.counter(self.proc, "energy", "energy_j",
                                self._energy_ts, self.metrics.energy_j)

    def _trace_job(self, plan: BatchPlan, t0: float, dur: float) -> None:
        """One scheduled job as a span on this lane's "jobs" track."""
        if self.tracer is not None:
            self.tracer.span(self.proc, "jobs", f"job:{plan.kind}", t0, dur,
                             args={"n": plan.n_elems, "m": plan.m,
                                   "offload": plan.offload,
                                   "t_pred": plan.t_pred})

    def _trace_occupancy(self, ts: float, occupied: int) -> None:
        if self.tracer is not None:
            self.tracer.counter(self.proc, "slots", "slots_occupied", ts,
                                occupied)

    def _record_wall(self, wall_s: float) -> None:
        """One measured real-engine step.  Its span on the host clock is
        the engine's own (``ServingEngine.trace_to``)."""
        self.metrics.step_wall_s.add(wall_s)

    # ------------------------------------------------------------------ #
    # Fault injection (DESIGN.md §10).  All hooks early-return when no
    # injector is attached, keeping the fault-free paths bit-identical.
    # ------------------------------------------------------------------ #
    def _crash_t(self) -> float | None:
        if self.faults is None:
            return None
        return self.faults.crash_time(self.fault_lane)

    def _crashed(self, clock: float) -> bool:
        t = self._crash_t()
        return t is not None and clock >= t

    def _apply_stall(self, clock: float) -> float:
        """Absorb any stall window covering ``clock``: the lane freezes
        until the window ends (chained windows are absorbed one poll at a
        time — the loop re-enters this before dispatching anything)."""
        if self.faults is None:
            return clock
        end = self.faults.stall_end(self.fault_lane, clock)
        if end is None or end <= clock:
            return clock
        m = self.metrics
        m.stalls += 1
        m.stall_cycles += end - clock
        if self.tracer is not None:
            self.tracer.span(self.proc, "faults", "fault:stall", clock,
                             end - clock, args={"lane": self.fault_lane})
        return end

    def _cap_idle_jump(self, clock: float) -> float:
        """An idle lane still dies at its scheduled crash time: cap the
        idle-advance at the crash so the abort is stamped honestly instead
        of at some far-future arrival."""
        crash_t = self._crash_t()
        if crash_t is not None and clock > crash_t:
            return crash_t
        return clock

    def _abort_crash(self, queue: RequestQueue, running: list[Request],
                     clock: float) -> float:
        """The fabric crashed: halt the engine timeline at ``clock`` (the
        first job boundary at/after the scheduled crash) and orphan every
        request on board — in slots, in flight, and still queued (open-loop
        routing already bound future arrivals to this lane).  Recovery is
        the fleet's job (serve/fleet.py); the dead lane only reports."""
        m = self.metrics
        m.faults_crash += 1
        drained = queue.drain()
        orphans = list(running) + drained
        for r in orphans:
            r.state = RequestState.ORPHANED
        m.orphaned += len(orphans)
        eng = getattr(self.fabric, "engine", None)
        if eng is not None and getattr(eng, "halted_at", 0.0) is None:
            eng.halt(clock)
        if self.tracer is not None:
            self.tracer.instant(self.proc, "faults", "fault:crash", clock,
                                args={"lane": self.fault_lane,
                                      "orphaned": len(orphans)})
            for r in orphans:
                self.tracer.instant(self.proc, "requests", "orphaned", clock,
                                    args={"rid": r.rid})
            if self.flow:
                # Only queued orphans still hold an open router flow arrow;
                # running ones closed theirs at their (now lost) prefill.
                for r in drained:
                    self.tracer.flow_end(self.proc, "requests", "route",
                                         clock, flow=r.rid)
        self.orphans.extend(orphans)
        return clock

    def _maybe_checkpoint(self, slots, emitted, lens, gen_buf,
                          clock: float) -> None:
        """Snapshot decode state every ``ckpt_every`` decode steps.

        The checkpoint is the per-slot resume record: request ids, tokens
        emitted, cache lengths, and the generated-token rows — enough for
        ``restore_checkpoint`` to rebuild a crashed slot's decode position
        on another lane (the restore is then priced as an Eq.-1 offload,
        serve/fleet.py)."""
        if self.ckpt is None:
            return
        self._decode_count += 1
        if self._decode_count % self.ckpt_every:
            return
        nb = self.max_batch
        rids = np.full(nb, -1, np.int64)
        em = np.zeros(nb, np.int64)
        ln = np.zeros(nb, np.int64)
        gen = np.full((nb, self._ckpt_max_gen), -1, np.int64)
        for i, r in enumerate(slots):
            if r is None:
                continue
            rids[i] = r.rid
            em[i] = emitted[i]
            ln[i] = int(lens[i])
            row = gen_buf[i][:self._ckpt_max_gen]
            if row:
                gen[i, :len(row)] = row
        self.ckpt.save(self._decode_count,
                       {"rids": rids, "emitted": em, "lens": ln, "gen": gen},
                       {"clock": clock})
        if self.tracer is not None:
            self.tracer.instant(self.proc, "faults", "checkpoint", clock,
                                args={"step": self._decode_count,
                                      "occupied": int((rids >= 0).sum())})

    # ------------------------------------------------------------------ #
    def run(self, requests: list[Request], *, start_clock: float | None = None,
            requeued: bool = False) -> dict:
        """Serve the whole trace; returns requests + metrics + logs.

        ``requeued=True`` is the fleet's recovery pass: the same batcher
        re-serves requests orphaned by another lane's crash — they count as
        ``requeued`` (not ``submitted``; the client submitted them once) and
        the clock resumes from ``start_clock`` (this lane's previous
        ``t_end``), never from zero.
        """
        queue = RequestQueue(requests, priority=self.priority)
        m = self.metrics
        if requeued:
            m.requeued += len(requests)
        else:
            m.submitted += len(requests)
        if requests and self.ckpt is not None:
            self._ckpt_max_gen = max(self._ckpt_max_gen,
                                     max(r.gen_len for r in requests))
        self.orphans = []
        clock = queue.next_arrival() or 0.0
        if start_clock is not None:
            clock = max(clock, start_clock)
        if not requeued:
            m.t_start = clock

        if self.wave_boundary:
            while not queue.empty:
                clock = self._apply_stall(clock)
                if self._crashed(clock):
                    clock = self._abort_crash(queue, [], clock)
                    break
                if not queue.arrived(clock):
                    clock = self._cap_idle_jump(queue.next_arrival())
                    continue
                wave = self._form_wave(queue, clock)
                if not wave:
                    continue  # everything that had arrived was rejected
                m.waves += 1
                clock = self._serve_wave(wave, queue, clock)
        elif self.pipeline:
            clock = self._run_pipelined(queue, clock)
        else:
            clock = self._run_continuous(queue, clock)

        m.t_end = clock
        return {
            "requests": sorted(queue.finished + queue.rejected,
                               key=lambda r: r.rid),
            "orphans": list(self.orphans),
            "metrics": m,
            "plans": self.scheduler.plans,
            "admissions": self.scheduler.admissions,
            "calibration": self.calibrator.snapshot(),
        }

    # ------------------------------------------------------------------ #
    # Continuous (slot-managed) serving loop — DESIGN.md §6
    # ------------------------------------------------------------------ #
    def _run_continuous(self, queue: RequestQueue, clock: float) -> float:
        m = self.metrics
        nb = self.max_batch
        slots: list[Request | None] = [None] * nb
        emitted = [0] * nb                     # tokens produced per slot
        gen_buf: list[list[int]] = [[] for _ in range(nb)]
        lens = np.zeros(nb, np.int32)          # per-slot cache lengths
        tok = np.zeros((nb, 1), np.int32)      # per-slot last token
        caches = self.engine.init_caches() if self.engine is not None else None

        def occupied() -> list[int]:
            return [i for i in range(nb) if slots[i] is not None]

        def finish(i: int, now: float) -> None:
            self._complete_request(slots[i], queue, now, gen_buf[i])
            slots[i] = None

        while True:
            clock = self._apply_stall(clock)
            if self._crashed(clock):
                return self._abort_crash(
                    queue, [slots[i] for i in occupied()], clock)
            free = [i for i in range(nb) if slots[i] is None]
            if self.preempt and not free:
                i = self._preempt_victim(slots, emitted, queue, clock)
                if i is not None:
                    self._preempt_slot(i, slots, emitted, gen_buf, queue,
                                       clock)
                    free = [i]
            occ_before = len(occupied())
            if free and queue.arrived(clock):
                batch = self._form_wave(queue, clock, limit=len(free))
                if batch:
                    m.waves += 1
                    if occ_before:
                        m.mid_wave_admissions += len(batch)
                    clock, caches = self._prefill_slots(
                        batch, free[:len(batch)], slots, emitted, gen_buf,
                        lens, tok, clock, caches, finish)
                    continue   # re-check arrivals before the next decode
            occ = occupied()
            if not occ:
                if queue.empty:
                    return clock
                nxt = queue.next_arrival()
                if nxt is None:  # pragma: no cover - defensive
                    return clock
                clock = self._cap_idle_jump(max(clock, nxt))
                continue

            # One decode step over every occupied slot (per-slot lengths).
            plan = self._plan(len(occ), None, "decode", clock)
            wall = next_tok = None
            if self.engine is not None:
                next_tok, caches, wall = self.engine.decode(tok, caches, lens)
                self._record_wall(wall)
            t_dec = self._job_runtime(plan, wall)
            self._account_job(plan, t_dec, self._executed_n(plan, None),
                              now=clock + t_dec)
            m.slot_occupancy.add(len(occ) / nb)
            self._trace_job(plan, clock, t_dec)
            self._trace_occupancy(clock, len(occ))
            clock += t_dec
            self._place_decoded(occ, slots, emitted, gen_buf, lens, tok,
                                next_tok, clock, finish)
            self._maybe_checkpoint(slots, emitted, lens, gen_buf, clock)

    def _place_decoded(self, occ: list[int], slots, emitted, gen_buf, lens,
                       tok, next_tok, clock: float, finish) -> None:
        """One decode step's tokens into its occupied slots, finishing the
        requests it completes (the continuous and pipelined loops)."""
        t_host = self._host.now() if self._host is not None else 0.0
        m = self.metrics
        for i in occ:
            lens[i] += 1
            emitted[i] += 1
            m.tokens_generated += 1
            if self.engine is not None:
                tok[i, 0] = next_tok[i]
                gen_buf[i].append(int(next_tok[i]))
            if emitted[i] >= slots[i].gen_len:
                finish(i, clock)
        if self._host is not None:
            self._host_span("place", t_host, {"kind": "decode",
                                              "rows": len(occ)})

    def _plan_prefill(self, batch: list[Request],
                      clock: float) -> tuple[BatchPlan, int]:
        """Queue-delay accounting + Eq.-3 plan for one admission batch,
        shared by the sequential and pipelined prefill paths.

        A batch of recovered requests carrying checkpointed decode state
        (``restore_len > 0``, uniform across the batch by ``_form_wave``'s
        bucketing) becomes a ``"restore"`` job: its N additionally counts
        the KV tokens being re-materialized, and the SAME Eq.-1 closed form
        prices it — recovery is dispatch + copy + sync like any other
        offload (DESIGN.md §10).  Restore jobs carry no deadline: the SLO
        verdict fell at the original prefill, on the lane that died.
        """
        prompt_len = batch[0].prompt_len
        restore = batch[0].restore_len > 0
        # A warm prefix hit skips its resident tokens (DESIGN.md §13);
        # prefix_hit is 0 unless a PrefixStore is attached, so the default
        # job size is byte-identical to the PR 1–9 accounting.
        n_job = sum(r.n_prompt_elems - r.prefix_hit + r.restore_len
                    for r in batch)
        slos = ([] if restore else
                [r.slo_cycles for r in batch if r.slo_cycles is not None])
        deadline = min(slos) if slos else None
        for r in batch:
            delay = clock - r.effective_arrival
            self.metrics.queue_delay_cycles.add(delay)
            if r.t_enqueued is not None:
                self.metrics.recovered += 1
                self.metrics.recovery_delay_cycles.add(delay)
            if self.tracer is not None:
                # Queue-delay span: arrival -> the prefill that serves it
                # (requeue instant -> re-prefill for recovered requests).
                self.tracer.span(self.proc, "requests", "queued",
                                 r.effective_arrival, delay,
                                 args={"rid": r.rid})
                if r.t_enqueued is not None:
                    self.tracer.instant(
                        self.proc, "requests", "recovered", clock,
                        args={"rid": r.rid, "restore_len": r.restore_len,
                              "requeues": r.requeues})
                if self.flow:
                    # Close the router's flow arrow at the executing lane.
                    self.tracer.flow_end(self.proc, "requests", "route",
                                         clock, flow=r.rid)
        plan = self._plan(n_job, deadline,
                          "restore" if restore else "prefill", clock)
        return plan, prompt_len

    def _stage_prefill_inputs(self, batch: list[Request], take: list[int],
                              prompt_len: int):
        """Padded token batch + slot mask for a prefill-into-slots step."""
        tokens = np.zeros((self.max_batch, prompt_len), np.int32)
        mask = np.zeros(self.max_batch, bool)
        for slot, r in zip(take, batch):
            tokens[slot] = r.tokens
            mask[slot] = True
        return tokens, mask

    def _place_prefilled(self, batch: list[Request], take: list[int],
                         slots, emitted, gen_buf, lens, tok,
                         t_job: float, clock: float, next_tok,
                         finish) -> None:
        """Install a completed prefill's requests into their slots, with
        per-request TTFT/SLO/first-token accounting, and finish those it
        completes."""
        t_host = self._host.now() if self._host is not None else 0.0
        for slot, r in zip(take, batch):
            slots[slot] = r
            if r.restore_len > 0:
                # KV restore: the slot resumes where the checkpoint left it
                # — restore_len tokens already emitted, cache primed past
                # them.  No new token is produced by the restore job itself.
                emitted[slot] = r.restore_len
                gen_buf[slot] = ([int(t) for t in r.restored_tokens]
                                 if r.restored_tokens is not None else [])
                lens[slot] = r.prompt_len + r.restore_len
                if gen_buf[slot]:
                    tok[slot, 0] = gen_buf[slot][-1]
                self._record_prefill_member(r, t_job, clock)
                continue
            emitted[slot] = 1          # the prefill emits the first token
            gen_buf[slot] = []
            lens[slot] = r.prompt_len
            self._record_prefill_member(r, t_job, clock)
            if next_tok is not None:
                tok[slot, 0] = next_tok[slot]
                gen_buf[slot].append(int(next_tok[slot]))
        for slot, r in zip(take, batch):
            if slots[slot] is r and emitted[slot] >= r.gen_len:
                finish(slot, clock)
        if self._host is not None:
            self._host_span("place", t_host, {"kind": "prefill",
                                              "rows": len(batch)})

    def _prefill_slots(self, batch: list[Request], take: list[int],
                       slots, emitted, gen_buf, lens, tok,
                       clock: float, caches, finish):
        """One prefill job placing ``batch`` into the free ``take`` slots.

        Returns ``(clock, caches)`` — the advanced virtual clock and the
        (merged) live caches.
        """
        clock = self._serve_handoff(batch, clock)
        plan, prompt_len = self._plan_prefill(batch, clock)
        wall = None
        next_tok = None
        if self.engine is not None:
            tokens, mask = self._stage_prefill_inputs(batch, take, prompt_len)
            next_tok, caches, wall = self.engine.prefill_into_slots(
                tokens, caches, mask, self.metrics)
            self._record_wall(wall)
        t_job = self._job_runtime(plan, wall)
        self._account_job(plan, t_job, self._executed_n(plan, prompt_len),
                          now=clock + t_job)
        self._trace_job(plan, clock, t_job)
        clock += t_job
        self._place_prefilled(batch, take, slots, emitted, gen_buf, lens,
                              tok, t_job, clock, next_tok, finish)
        return clock, caches

    # ------------------------------------------------------------------ #
    # Pipelined serving loop (async fabric protocol) — DESIGN.md §7
    # ------------------------------------------------------------------ #
    def _complete(self, handle, wall_s: float | None = None):
        """Retire one async-fabric job; returns its CompletedJob."""
        if isinstance(self.fabric, WallClockFabric):
            return self.fabric.complete(handle, wall_s)
        return self.fabric.complete(handle)

    def _run_pipelined(self, queue: RequestQueue, clock: float) -> float:
        """Slot-managed serving with refill prefills overlapped under the
        in-flight decode work (and vice versa).

        Per iteration: an admission batch's prefill is *submitted* (its
        descriptor dispatch occupies the host, its execution the fabric)
        and decode steps of the already-occupied slots keep running — on
        the engine timeline the host decode jobs slot into the idle window
        while the prefill executes, which is exactly the overhead the
        sequential loop serializes.  The prefill is retired once its
        completion time has passed (pure-virtual mode) or after the one
        decode its cache chain allows (real engine); its slots join the
        next decode, same as the sequential loop.
        """
        m = self.metrics
        nb = self.max_batch
        slots: list[Request | None] = [None] * nb
        emitted = [0] * nb
        gen_buf: list[list[int]] = [[] for _ in range(nb)]
        lens = np.zeros(nb, np.int32)
        tok = np.zeros((nb, 1), np.int32)
        caches = self.engine.init_caches() if self.engine is not None else None
        inflight: _InflightPrefill | None = None

        def occupied() -> list[int]:
            return [i for i in range(nb) if slots[i] is not None]

        def finish(i: int, now: float) -> None:
            self._complete_request(slots[i], queue, now, gen_buf[i])
            slots[i] = None

        while True:
            clock = self._apply_stall(clock)
            if self._crashed(clock):
                running = [s for s in slots if s is not None]
                if inflight is not None:
                    # The in-flight prefill dies with the fabric: its batch
                    # never reached a slot, so its requests are orphans too.
                    running += list(inflight.batch)
                return self._abort_crash(queue, running, clock)
            if inflight is None:
                free = [i for i in range(nb) if slots[i] is None]
                if free and queue.arrived(clock):
                    batch = self._form_wave(queue, clock, limit=len(free))
                    if batch:
                        clock = self._serve_handoff(batch, clock)
                        inflight = self._submit_prefill(
                            batch, free[:len(batch)], clock,
                            bool(occupied()))

            occ = occupied()
            if not occ:
                if inflight is not None:
                    clock, caches = self._retire_prefill(
                        inflight, queue, slots, emitted, gen_buf, lens, tok,
                        clock, caches, finish)
                    inflight = None
                    continue
                if queue.empty:
                    return clock
                nxt = queue.next_arrival()
                if nxt is None:  # pragma: no cover - defensive
                    return clock
                clock = self._cap_idle_jump(max(clock, nxt))
                continue

            # One decode step over the occupied slots, overlapped under the
            # in-flight prefill when there is one.
            plan = self._plan(len(occ), None, "decode", clock)
            pending_d = None
            wall = next_tok = None
            if self.engine is not None:
                pending_d = self.engine.decode_async(tok, caches, lens)
                if inflight is not None and inflight.pending is None:
                    # Chain the refill prefill on the decode's cache future:
                    # the merge overwrites the refilled rows after the
                    # decode's scatter, so running rows stay bit-identical.
                    inflight.pending = self.engine.prefill_into_slots_async(
                        inflight.tokens, pending_d.out["caches"],
                        inflight.mask, m)
                    if hasattr(inflight.handle, "probe"):
                        # Wallclock handles learn readiness from the real
                        # in-flight step (a query of its CUDA event).
                        pending_p = inflight.pending
                        inflight.handle.probe = (
                            lambda: self.engine.step_ready(pending_p))
            handle_d = self.fabric.submit(
                plan.m if plan.offload else None, plan.n_elems,
                t_submit=clock, offload=plan.offload)
            if self.engine is not None:
                next_tok, caches_d, wall = self.engine.wait_step(pending_d)
                self._record_wall(wall)
                if inflight is None or inflight.pending is None:
                    caches = caches_d
                # else: the in-flight prefill merges into the decode's
                # caches; the merged tree arrives when it retires.
            job = self._complete(handle_d, wall)
            self._account_job(plan, job.effective,
                              self._executed_n(plan, None), now=job.t_done)
            m.record_job_pipeline(job)
            m.slot_occupancy.add(len(occ) / nb)
            self._trace_job(plan, job.t_done - job.total, job.total)
            self._trace_occupancy(clock, len(occ))
            clock = max(clock, job.t_done)
            self._place_decoded(occ, slots, emitted, gen_buf, lens, tok,
                                next_tok, clock, finish)
            self._maybe_checkpoint(slots, emitted, lens, gen_buf, clock)

            if inflight is not None:
                inflight.overlapped += 1
                if (self.fabric.ready(inflight.handle, clock)
                        or inflight.overlapped >= self._max_overlap_steps
                        or not occupied()):
                    clock, caches = self._retire_prefill(
                        inflight, queue, slots, emitted, gen_buf, lens, tok,
                        clock, caches, finish)
                    inflight = None

    def _submit_prefill(self, batch: list[Request], take: list[int],
                        clock: float, mid_wave: bool) -> "_InflightPrefill":
        """Plan + submit one refill prefill on the async fabric.

        The real-engine dispatch is deferred (``pending=None``) so it can be
        chained behind the decode it overlaps; the virtual handle is
        scheduled immediately — on the engine timeline the host dispatches
        the descriptor first, then runs decode work in its idle window.
        """
        m = self.metrics
        m.waves += 1
        if mid_wave:
            m.mid_wave_admissions += len(batch)
        plan, prompt_len = self._plan_prefill(batch, clock)
        handle = self.fabric.submit(
            plan.m if plan.offload else None, plan.n_elems,
            t_submit=clock, offload=plan.offload)
        tokens = mask = None
        if self.engine is not None:
            tokens, mask = self._stage_prefill_inputs(batch, take, prompt_len)
        return _InflightPrefill(handle=handle, plan=plan, batch=batch,
                                take=take, prompt_len=prompt_len,
                                tokens=tokens, mask=mask)

    def _retire_prefill(self, inflight: "_InflightPrefill",
                        queue: RequestQueue, slots, emitted, gen_buf, lens,
                        tok, clock: float, caches, finish):
        """Complete an in-flight prefill and place its requests into slots."""
        m = self.metrics
        wall = None
        next_tok = None
        if self.engine is not None:
            if inflight.pending is None:
                # Nothing overlapped it (idle fabric): dispatch now.
                inflight.pending = self.engine.prefill_into_slots_async(
                    inflight.tokens, caches, inflight.mask, m)
            next_tok, caches, wall = self.engine.wait_step(inflight.pending)
            self._record_wall(wall)
        job = self._complete(inflight.handle, wall)
        plan = inflight.plan
        self._account_job(plan, job.effective,
                          self._executed_n(plan, inflight.prompt_len),
                          now=job.t_done)
        self._trace_job(plan, job.t_done - job.total, job.total)
        m.record_job_pipeline(job)
        if job.overlap > 0 or inflight.overlapped > 0:
            m.pipelined_prefills += 1
        clock = max(clock, job.t_done)

        self._place_prefilled(inflight.batch, inflight.take, slots, emitted,
                              gen_buf, lens, tok, job.total, clock, next_tok,
                              finish)
        return clock, caches

    # ------------------------------------------------------------------ #
    # Legacy wave-boundary path (A/B baseline; --wave-boundary)
    # ------------------------------------------------------------------ #
    def _serve_wave(self, wave: list[Request], queue: RequestQueue,
                    clock: float) -> float:
        m = self.metrics

        # --- prefill: one offload job for the whole wave ----------------
        clock = self._serve_handoff(wave, clock)
        plan, prompt_len = self._plan_prefill(wave, clock)
        caches = None
        next_tok = None
        wall = None
        if self.engine is not None:
            tokens = np.zeros((self.max_batch, prompt_len), np.int32)
            for slot, r in enumerate(wave):
                tokens[slot] = r.tokens
            next_tok, caches, wall = self.engine.prefill(tokens, self.metrics)
            self._record_wall(wall)
        t_job = self._job_runtime(plan, wall)
        self._account_job(plan, t_job, self._executed_n(plan, prompt_len),
                          now=clock + t_job)
        self._trace_job(plan, clock, t_job)
        clock += t_job

        t_host = self._host.now() if self._host is not None else 0.0
        gen_buf: list[list[int]] = [[] for _ in wave]
        for slot, r in enumerate(wave):
            self._record_prefill_member(r, t_job, clock)
            if next_tok is not None:
                gen_buf[slot].append(int(next_tok[slot]))
        if self._host is not None:
            self._host_span("place", t_host, {"kind": "prefill",
                                              "rows": len(wave)})

        # --- decode: one job per token step over the active members -----
        max_gen = max(r.gen_len for r in wave)
        done_at = {r.rid: clock for r in wave if r.gen_len <= 1}
        tok = (next_tok[:, None].astype(np.int32)
               if next_tok is not None else None)
        for step in range(max_gen - 1):
            active = [r for r in wave if r.gen_len > step + 1]
            if not active:
                break
            plan_d = self._plan(len(active), None, "decode", clock)
            wall = None
            if self.engine is not None:
                next_tok, caches, wall = self.engine.decode(
                    tok, caches, prompt_len + step)
                self._record_wall(wall)
                tok = next_tok[:, None].astype(np.int32)
            t_dec = self._job_runtime(plan_d, wall)
            self._account_job(plan_d, t_dec, self._executed_n(plan_d, None),
                              now=clock + t_dec)
            m.slot_occupancy.add(len(active) / self.max_batch)
            self._trace_job(plan_d, clock, t_dec)
            self._trace_occupancy(clock, len(active))
            clock += t_dec
            t_host = self._host.now() if self._host is not None else 0.0
            for slot, r in enumerate(wave):
                if r.gen_len > step + 1:
                    m.tokens_generated += 1
                    if self.engine is not None:
                        gen_buf[slot].append(int(next_tok[slot]))
                    if r.gen_len == step + 2:
                        done_at[r.rid] = clock
            if self._host is not None:
                self._host_span("place", t_host, {"kind": "decode",
                                                  "rows": len(active)})

        for slot, r in enumerate(wave):
            self._complete_request(r, queue, done_at[r.rid], gen_buf[slot])
        return clock
