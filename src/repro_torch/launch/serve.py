"""Serving driver: thin CLI over the ``repro_torch.serve`` subsystem.

The port of ``repro/launch/serve.py``.  The default mode drives the
offload-aware scheduler end to end on a synthetic open-loop workload
(Poisson arrivals, mixed prompt/gen lengths, per-request Eq.-3 SLOs):
per-batch parallel extent M chosen from the *online-calibrated* runtime
model, infeasible deadlines rejected at admission, and the calibrated
(alpha, beta, gamma) reported with their window MAPE against the measured
step times of the same run.  Its output is line for line the reference's.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \
      --device cpu --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --no-execute --requests 512
  PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \
      --no-reduced --fused-decode --fabric wallclock    # on the card

``--fleet`` serves the trace on a multi-fabric fleet behind the
model-driven router (DESIGN.md §8): one cluster count per fabric, each
fabric with its own scaled hardware, Eq.-1 prior and online calibrator,
timed on the simulated cycle domain; ``--faults`` crashes a lane mid-serve
and the fleet requeues, restores and re-routes its orphans (DESIGN.md §10):

  PYTHONPATH=src python -m repro_torch.launch.serve --no-execute \
      --fleet 32,8,8
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet 32,8 \
      --device cpu --requests 8          # one engine per lane
  PYTHONPATH=src python -m repro_torch.launch.serve --no-execute --pipeline \
      --fleet 32,8,8 --faults crash@1:0.45 --recovery restore

``--one-shot`` keeps the single-batch driver (one offline offload decision
per run):

  PYTHONPATH=src python -m repro_torch.launch.serve --one-shot \
      --arch chatglm3-6b --no-reduced --fused-decode

The port's own flags: ``--no-reduced`` serves the full-width, full-depth
config, ``--device`` picks the card (default ``cuda``) or ``cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import decision, runtime_model


def serve(arch: str, *, reduced: bool = True, prompts: int = 4,
          prompt_len: int = 32, gen: int = 16, mesh_shape=(1, 1),
          slo_us: float | None = None, fused_decode: bool = False,
          device: str | torch.device = "cuda", params=None,
          prompt_tokens: np.ndarray | None = None, mesh=None) -> dict:
    """One-shot serving: a single batch through the serving engine, with one
    offline offload decision for the whole job.

    ``prompt_tokens`` (prompts, prompt_len) int32 replaces the default
    prompt batch, drawn with ``np.random.default_rng(1)``; ``params`` a
    port parameter tree replaces the seeded random weights.
    ``mesh_shape`` and ``mesh`` go to the ``ServingEngine``: a
    ``DeviceMesh`` over the caller's process group, or the plain
    one-device path for ``(1, 1)`` without ``mesh``.
    """
    from repro_torch.serve.batcher import ServingEngine

    engine = ServingEngine(arch, reduced=reduced, max_batch=prompts,
                           max_len=prompt_len + gen, mesh_shape=mesh_shape,
                           fused_decode=fused_decode, params=params,
                           device=device, mesh=mesh)
    cfg = engine.cfg
    if prompt_tokens is None:
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (prompts, prompt_len), dtype=np.int32)
    else:
        tokens = np.asarray(prompt_tokens, np.int32)
        if tokens.shape != (prompts, prompt_len):
            raise ValueError(f"prompt_tokens must be {(prompts, prompt_len)}, "
                             f"got {tokens.shape}")

    next_tok, caches, t_prefill = engine.prefill(tokens)
    credits = [engine.last_credits]
    tok = next_tok[:, None].astype(np.int32)
    generated = [tok]
    t_decode = 0.0
    for i in range(gen - 1):
        next_tok, caches, dt = engine.decode(tok, caches, prompt_len + i)
        credits.append(engine.last_credits)
        t_decode += dt
        tok = next_tok[:, None].astype(np.int32)
        generated.append(tok)

    # Offload-decision report for this serving job (paper Eq. 1/3): fit the
    # runtime model on the Manticore simulator's scale-free form and answer
    # "how many workers does a job of this size need".
    model = runtime_model.fit_from_simulator()
    n_job = prompts * prompt_len
    rep = decision.deadline_report(model, min(n_job, 8192),
                                   t_max=(slo_us or 700.0),
                                   available=[1, 2, 4, 8, 16, 32])
    return {
        "arch": cfg.name,
        "device": str(engine.device),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_s": prompts * (gen - 1) / max(t_decode, 1e-9),
        "generated": np.concatenate(generated, axis=1),
        "credits": credits,
        "credit_threshold": engine.sync.threshold,
        "offload_decision": rep,
    }


def _make_obs(args):
    """Tracer + residual tracker when a tracing flag is set (else no-ops).

    Tracing is strictly opt-in: without ``--trace``/``--trace-jsonl`` the
    serving stack runs with ``tracer=None`` and pays nothing (DESIGN.md §9).
    """
    if not (args.trace or args.trace_jsonl):
        return None, None
    from repro_torch.obs import ResidualTracker, Tracer
    return Tracer(), ResidualTracker()


def _finish_obs(args, out, tracer, residuals) -> None:
    """Write the requested trace/metrics artifacts and the drift summary."""
    import json

    if residuals is not None and residuals.lanes():
        print(residuals.format_summary())
    if tracer is not None and args.trace:
        from repro_torch.obs import write_chrome_trace
        write_chrome_trace(tracer, args.trace)
        print(f"trace: {len(tracer.events)} events -> {args.trace} "
              f"(load in Perfetto or chrome://tracing)")
    if tracer is not None and args.trace_jsonl:
        from repro_torch.obs import write_jsonl
        write_jsonl(tracer, args.trace_jsonl)
        print(f"trace event log -> {args.trace_jsonl}")
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(out["metrics"].summary(), f, indent=2, sort_keys=True)
        print(f"metrics summary -> {args.metrics_json}")


def _fault_report(out) -> None:
    """Print the injected fault schedule and the recovery outcome."""
    inj = out.get("faults")
    if inj is None:
        return
    print(f"fault schedule ({len(inj)} event(s), boundary-injected):")
    for ev in inj.events:
        extra = ""
        if ev.duration:
            extra += f" +{ev.duration:.0f}cy"
        if ev.factor != 1.0:
            extra += f" x{ev.factor:g}"
        print(f"  {ev.kind}@lane{ev.lane} t={ev.t:.0f}{extra}")
    if "recovery" in out:
        print(f"recovery [{out['recovery']}]: dead lanes "
              f"{list(out.get('dead_lanes', []))}, quarantined "
              f"{list(out.get('quarantined_lanes', []))}, "
              f"{len(out.get('dropped', []))} undeliverable dropped")


def _parse_shed(spec: str | None) -> dict | None:
    """``'1:8,2:2'`` -> ``{1: 8, 2: 2}`` (tenant-class priority -> backlog
    cap at which the class is shed under overload, DESIGN.md §13)."""
    if not spec:
        return None
    out = {}
    for kv in spec.split(","):
        k, _, v = kv.partition(":")
        out[int(k)] = int(v)
    return out


def build_spec(args):
    """The ONE place argv becomes a ``WorkloadSpec`` (trace shape only —
    serving knobs go through :func:`build_serve_config` /
    :func:`build_fleet_config`)."""
    from repro_torch.serve import WorkloadSpec
    return WorkloadSpec(
        num_requests=args.requests,
        rate_rps=args.rate,
        slo_fraction=args.slo_fraction,
        seed=args.seed,
        arrival=args.workload,
        cv=args.cv,
        length_dist=args.length_dist,
        turns=args.sessions,
        think_time_s=tuple(args.think_time),
        tenants=args.tenants,
        tenant_classes=tuple(
            s for s in args.tenant_classes.split(",") if s),
    )


def build_serve_config(args, tracer=None, residuals=None):
    """The ONE place argv becomes a ``ServeConfig`` (single-fabric mode)."""
    from repro_torch.serve import ServeConfig
    return ServeConfig(
        arch=args.arch, reduced=args.reduced,
        execute=not args.no_execute, max_batch=args.max_batch,
        fabric=args.fabric, wave_boundary=args.wave_boundary,
        pipeline=args.pipeline, buffering=args.buffering, dvfs=args.dvfs,
        tracer=tracer, residuals=residuals,
        faults=args.faults, fault_seed=args.fault_seed,
        fused_decode=args.fused_decode,
        affinity=args.affinity, prefix_capacity=args.prefix_capacity,
        priority=args.priority, preempt=args.preempt,
        shed_depth=_parse_shed(args.shed), device=args.device)


def build_fleet_config(args, tracer=None, residuals=None):
    """The ONE place argv becomes a ``FleetConfig`` (``--fleet`` mode)."""
    from repro_torch.serve import FleetConfig
    return FleetConfig(
        fleet=tuple(int(s) for s in args.fleet.split(",") if s),
        router=args.router, objective=args.router_objective,
        arch=args.arch, reduced=args.reduced,
        execute=not args.no_execute, max_batch=args.max_batch,
        wave_boundary=args.wave_boundary, pipeline=args.pipeline,
        buffering=args.buffering, dvfs=args.dvfs,
        tracer=tracer, residuals=residuals,
        faults=args.faults, fault_seed=args.fault_seed,
        recovery=args.recovery, tie_seed=args.tie_seed,
        affinity=args.affinity, prefix_capacity=args.prefix_capacity,
        priority=args.priority, preempt=args.preempt,
        shed_depth=_parse_shed(args.shed), device=args.device)


def serve_fleet_stream(args) -> dict:
    """Drive the multi-fabric fleet (DESIGN.md §8) on the open-loop trace."""
    from repro_torch.serve import serve_fleet

    if args.fabric != "simulated":
        raise SystemExit(
            "--fleet serves on the simulated cycle domain only: routing "
            "scores per-fabric cycle models, which a wallclock fabric does "
            "not have (drop --fabric wallclock or --fleet)")
    spec = build_spec(args)
    tracer, residuals = _make_obs(args)
    cfg = build_fleet_config(args, tracer, residuals)
    sizes = cfg.fleet
    out = serve_fleet(spec, config=cfg)
    _fault_report(out)

    lane_hist: dict[int, int] = {}
    guarded = 0
    for d in out["routes"]:
        lane_hist[d.lane] = lane_hist.get(d.lane, 0) + 1
        guarded += d.guarded
        if args.verbose:
            scores = ", ".join(f"{s:.0f}" for s in d.scores)
            print(f"[route] request {d.rid} -> lane {d.lane} "
                  f"(scores [{scores}], pending {list(d.pending)}"
                  f"{', guarded' if d.guarded else ''})")
    print(f"router [{out['router']}] over fleet "
          f"{'+'.join(map(str, sizes))}: lane histogram "
          f"{dict(sorted(lane_hist.items()))}, "
          f"{guarded} work-conserving redirects")
    print(out["metrics"].format_summary())
    for snap, size in zip(out["calibrations"], sizes):
        mape = ("n/a" if snap.window_mape_pct is None
                else f"{snap.window_mape_pct:.2f}%")
        e_mape = ("" if snap.energy_mape_pct is None
                  else f", energy MAPE {snap.energy_mape_pct:.2f}%")
        print(f"  [{size}c] calibrated: a={snap.alpha:.1f} "
              f"b={snap.beta:.4f} g={snap.gamma:.4f} "
              f"({snap.source}, {snap.n_samples} samples, MAPE {mape}"
              f"{e_mape})")
    _finish_obs(args, out, tracer, residuals)
    return out


def serve_stream(args) -> dict:
    """Drive repro_torch.serve on the trace-driven open-loop workload (default)."""
    from repro_torch.serve import serve_workload

    spec = build_spec(args)
    tracer, residuals = _make_obs(args)
    out = serve_workload(spec, config=build_serve_config(args, tracer,
                                                         residuals))
    _fault_report(out)

    if args.verbose:
        for adm in out["admissions"]:
            if not adm.admitted:
                print(f"[admission] request {adm.rid} REJECTED: {adm.reason}")
        for i, p in enumerate(out["plans"]):
            if p.kind == "prefill":
                dl = f", deadline {p.deadline:.0f}" if p.deadline else ""
                print(f"[plan {i}] prefill N={p.n_elems}{dl}: {p.reason} "
                      f"(t_pred {p.t_pred:.0f} cy)")
    else:
        rej = [a for a in out["admissions"] if not a.admitted]
        print(f"admission control: {len(rej)} rejected "
              f"({', '.join(str(a.rid) for a in rej[:8])}"
              f"{'...' if len(rej) > 8 else ''})")
        for a in rej[:3]:
            print(f"  e.g. request {a.rid}: {a.reason}")

    m_hist: dict = {}
    for p in out["plans"]:
        if p.kind == "prefill" and p.offload:
            m_hist[p.m] = m_hist.get(p.m, 0) + 1
    print("prefill extent histogram (M -> jobs):",
          dict(sorted(m_hist.items())))
    print(out["metrics"].format_summary())

    snap = out["calibration"]
    print(f"calibrated model [{snap.source}, {snap.n_samples} samples in "
          f"window, {snap.n_observed} observed]: "
          f"t̂(M,N) = {snap.alpha:.1f} + {snap.beta:.4f}*N "
          f"+ {snap.gamma:.4f}*N/M")
    if snap.window_mape_pct is not None:
        print(f"calibration MAPE vs measured step times: "
              f"{snap.window_mape_pct:.2f}%")
    _finish_obs(args, out, tracer, residuals)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="serve the scaled_down config (the default)")
    ap.add_argument("--no-reduced", dest="reduced", action="store_false",
                    help="serve the full-width, full-depth config")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'; the engine runs there "
                         "(unused with --no-execute)")
    # One-shot (legacy) driver.
    ap.add_argument("--one-shot", action="store_true",
                    help="original single-batch driver with one offline "
                         "offload decision")
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    # Streaming-scheduler driver (default).
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--rate", type=float, default=2e6,
                    help="open-loop arrival rate, requests/s of fabric time")
    ap.add_argument("--slo-fraction", type=float, default=0.7)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    # Trace-driven workload family + tenancy (DESIGN.md §13).
    ap.add_argument("--workload", choices=("poisson", "gamma", "mmpp"),
                    default="poisson",
                    help="arrival process: memoryless Poisson (default), "
                         "burstier Gamma renewals (--cv), or a two-state "
                         "MMPP whose ON state fires bursts")
    ap.add_argument("--cv", type=float, default=3.0,
                    help="inter-arrival coefficient of variation for "
                         "--workload gamma (1.0 degenerates to Poisson)")
    ap.add_argument("--length-dist", choices=("choice", "lognormal", "zipf"),
                    default="choice",
                    help="prompt/gen length law: the legacy discrete grid "
                         "(default) or heavy-tailed lognormal/Zipf")
    ap.add_argument("--sessions", type=int, default=1, metavar="TURNS",
                    help="multi-turn sessions: each arrival opens a session "
                         "of TURNS requests whose later prompts re-send the "
                         "conversation context (enables prefix-KV reuse; "
                         "default 1 = the historical single-turn trace)")
    ap.add_argument("--think-time", type=float, nargs=2, default=(0.0, 0.0),
                    metavar=("LO", "HI"),
                    help="uniform think-time range in seconds between a "
                         "session's turns")
    ap.add_argument("--tenants", type=int, default=1,
                    help="tenants sharing the trace; each maps onto a "
                         "--tenant-classes SLO class round-robin")
    ap.add_argument("--tenant-classes", default="standard",
                    metavar="C1[,C2,...]",
                    help="SLO classes tenants cycle through: "
                         "premium/standard/batch (priority 0/1/2)")
    ap.add_argument("--affinity", action="store_true",
                    help="session-affine serving: per-fabric prefix-KV "
                         "stores; warm hits skip prefill, the fleet router "
                         "prices hit-vs-miss-vs-handoff (DESIGN.md §13)")
    ap.add_argument("--prefix-capacity", type=int, default=65536,
                    help="per-fabric prefix-KV store capacity in tokens "
                         "(LRU eviction)")
    ap.add_argument("--priority", action="store_true",
                    help="drain the arrived backlog premium-first under "
                         "overload (tenant-class queue ordering)")
    ap.add_argument("--preempt", action="store_true",
                    help="evict a running lower-class request when a "
                         "premium request finds every slot busy")
    ap.add_argument("--shed", default=None, metavar="P:CAP[,P:CAP...]",
                    help="overload shedding: per class priority, the max "
                         "backlog at which it is still admitted, e.g. "
                         "'2:4,1:16' sheds batch beyond 4 waiting and "
                         "standard beyond 16")
    ap.add_argument("--wave-boundary", action="store_true",
                    help="disable mid-wave admission (legacy iteration-level "
                         "batching; the A/B baseline for the slot-managed "
                         "continuous loop)")
    ap.add_argument("--pipeline", action="store_true",
                    help="async fabric protocol: refill prefills dispatched "
                         "under in-flight decode work on a double-buffered "
                         "fabric (DESIGN.md §7)")
    ap.add_argument("--buffering", choices=("single", "double"), default=None,
                    help="fabric job-descriptor depth (default: double when "
                         "--pipeline, else single)")
    ap.add_argument("--fleet", default=None, metavar="C1[,C2,...]",
                    help="serve on a multi-fabric fleet: one cluster count "
                         "per fabric (e.g. 32 / 16,16 / 32,8,8), each with "
                         "its own scaled hardware + calibrated model "
                         "(DESIGN.md §8); with --no-execute off, builds "
                         "one engine per fabric")
    ap.add_argument("--router", choices=("model", "rr", "lql"),
                    default="model",
                    help="fleet routing policy: model-driven predicted "
                         "completion (default), round-robin, or "
                         "least-queued-lane")
    ap.add_argument("--router-objective",
                    choices=("latency", "energy", "edp"), default="latency",
                    help="what the model router's argmin minimizes "
                         "(DESIGN.md §11): predicted completion (default), "
                         "predicted joules, or the energy-delay product")
    ap.add_argument("--dvfs", choices=("eco", "nominal", "turbo"),
                    default=None,
                    help="DVFS operating point of the simulated fabric(s): "
                         "prices joules only — cycle timelines and every "
                         "scheduling decision are DVFS-invariant "
                         "(DESIGN.md §11)")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="deterministic fault schedule (DESIGN.md §10): "
                         "comma-separated KIND@LANE:T[+DUR][xFACTOR] with "
                         "KIND in crash/stall/skew and T/DUR as cycles or "
                         "horizon fractions (<=1.0), e.g. 'crash@1:0.45' or "
                         "'stall@0:0.3+0.1,skew@2:0.5+0.2x1.5'; or "
                         "'random:N' for N seeded random events")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="seed for 'random:N' fault schedules (default: "
                         "derive_seed(--seed, 'faults') — one workload seed "
                         "reproduces the whole chaos run)")
    ap.add_argument("--recovery", choices=("restore", "reprefill", "drop"),
                    default="restore",
                    help="fleet crash recovery mode: requeue orphans with "
                         "KV restore priced as an Eq.-1 offload (default), "
                         "requeue with full re-prefill, or drop them (the "
                         "naive baseline the A/B benchmark measures against)")
    ap.add_argument("--tie-seed", type=int, default=None,
                    help="seed the router's tie-break RNG (default: "
                         "deterministic first-lane ties)")
    ap.add_argument("--no-execute", action="store_true",
                    help="skip the real engine (scheduler machinery only)")
    ap.add_argument("--fused-decode", action="store_true",
                    help="run every decode step's attention through the "
                         "fused CUDA decode-attention kernel (one call per "
                         "layer, the same tokens; DESIGN.md §12). Pairs "
                         "with --fabric wallclock for the measured speedup")
    ap.add_argument("--fabric", choices=("simulated", "wallclock"),
                    default="simulated",
                    help="job timing source: Manticore cycle model, or the "
                         "engine's measured DispatchStats/credit-counter "
                         "step times (calibrator then tracks the live host; "
                         "SLO deadlines are still in fabric cycles, so "
                         "expect the model to learn they are infeasible)")
    ap.add_argument("--verbose", action="store_true",
                    help="log every admission decision and prefill plan")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record the run as a Chrome/Perfetto trace "
                         "(docs/observability.md); tracing is off — and "
                         "costs nothing — without this flag")
    ap.add_argument("--trace-jsonl", default=None, metavar="PATH",
                    help="also write the raw trace events as JSON lines "
                         "(one event per line, for ad-hoc analysis)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="dump the machine-readable metrics summary() dict "
                         "as JSON (single-fabric and fleet)")
    args = ap.parse_args(argv)

    if args.one_shot:
        out = serve(args.arch, reduced=args.reduced, prompts=args.prompts,
                    prompt_len=args.prompt_len, gen=args.gen,
                    fused_decode=args.fused_decode, device=args.device)
        print(f"{out['arch']} on {out['device']}: prefill "
              f"{out['prefill_s'] * 1e3:.1f} ms, decode "
              f"{out['decode_tok_s']:.1f} tok/s")
        print("offload decision (Eq.3):", out["offload_decision"])
        return out
    if args.fleet:
        return serve_fleet_stream(args)
    return serve_stream(args)


if __name__ == "__main__":
    main()
