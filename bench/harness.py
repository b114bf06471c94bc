"""One run of one cell: set-up, the window, the check, the metrics.

Everything that belongs to one configuration, traffic mix or metric is
found by name: ``BENCHMARK.json``'s configuration ``file``,
``bench/traffic/<mix>.json``, ``bench/metrics/<metric>.py``,
``bench/layouts/<family>.py``, ``bench/reference/<family>.py``,
``bench/counts/<family>.py`` and ``bench/limits/<cell>.json``, all under
``root`` (the checkout).

Set-up (``setup_s``, from the process's start): the kernels built, the
weights drawn on the device from the seed, one ``ServingEngine`` with the
fused decode built at the mix's slots and longest request, its warm-up
over the mix's prompt lengths, one ``OnlineCalibrator`` and one
``OffloadAwareScheduler`` for the run, and the backlog of requests.  The
window drives ``ContinuousBatcher.run`` on a ``WallClockFabric`` through
``window.TimedEngine`` until the first engine call after ``seconds``.
Then the peak memory is read, the program's engine is freed, and the
reference judges a sample of the served tokens.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from bench import check, peaks as peak_table, trace as tracing, traffic
from bench.window import TimedEngine, WindowClosed, replay

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
AVAILABLE_M = (1, 2, 4, 8, 16, 32)
TRACE_START = 0.3          # share of the window before the traced part
TRACE_SECONDS = 3.0        # length of the traced part (at most)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the
    JAX package's, compared whole."""
    tops = {n.split(".")[0] for n in (list(sys.modules) if names is None
                                      else names)}
    return sorted(tops & set(FORBIDDEN))


@dataclass
class Cell:
    root: Path
    spec: dict
    workload: dict
    config: dict

    @classmethod
    def load(cls, root: Path, name: str) -> "Cell":
        spec = json.loads((root / "BENCHMARK.json").read_text())
        wl = next((w for w in spec["workloads"] if w["name"] == name), None)
        if wl is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        entry = next(c for c in spec["configs"] if c["name"] == wl["config"])
        config = json.loads((root / entry["file"]).read_text())
        return cls(root, spec, wl, config)

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def mix(self) -> dict:
        return traffic.load(self.workload["traffic"], self.root)

    def family(self, kind: str):
        fam = self.model["family"]
        path = self.root / "bench" / kind / f"{fam}.py"
        if not path.is_file():
            raise FileNotFoundError(f"family {fam!r} has no {kind} file: "
                                    f"bench/{kind}/{fam}.py")
        return load_module(path, f"bench_{kind}_{fam}")

    def lists(self, metric: dict) -> bool:
        return self.workload["name"] in metric.get("workloads", ())

    def metrics(self, trace: bool) -> list[dict]:
        """This cell's end-to-end metrics, or with ``trace`` its per-layer
        ones.  A metric with a ``workloads`` list is the listed cells'; an
        end-to-end metric without one is every cell's, and a per-layer
        metric without one is every cell's that reports what it moves."""
        e2e = [m for m in self.spec["end_to_end"]
               if "workloads" not in m or self.lists(m)]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (self.lists(m) if "workloads" in m
                    else m["moves"] in moved)]

    def reader(self, metric: str):
        return load_module(self.root / "bench" / "metrics" / f"{metric}.py",
                           f"bench_metric_{metric.replace('.', '_')}")


@dataclass
class RunData:
    """What the metric readers read."""
    model: dict
    mix: dict
    counts: object
    peaks: dict | None
    setup_s: float
    t_start: float
    window_s: float
    calls: list
    metrics: object
    trace: object = None
    experts: dict = field(default_factory=dict)   # call index -> per layer

    @property
    def max_len(self) -> int:
        return traffic.max_len(self.mix)

    def traced_calls(self) -> list[tuple[int, int, object]]:
        """(trace index, call index, call) of each traced engine call."""
        idx = [i for i, c in enumerate(self.calls) if c.traced]
        if self.trace is None:
            return []
        return [(t, i, self.calls[i]) for t, i in enumerate(idx)]

    def clean(self) -> tuple[list, list, float]:
        """The untraced part of the window: its calls, the host gaps
        between them (the first from the window's start), and its seconds.
        The traced part, with the profiler's start and stop, is cut out."""
        traced = [i for i, c in enumerate(self.calls) if c.traced]
        cut = (None, None)
        if traced:
            i, j = traced[0], traced[-1]
            a = self.calls[i - 1].t1 if i > 0 else self.t_start
            b = self.calls[j + 1].t0 if j + 1 < len(self.calls) else \
                self.calls[j].t1
            cut = (a, b)
        calls, gaps, prev = [], [], self.t_start
        for c in self.calls:
            if cut[0] is not None and c.t1 > cut[0] and c.t0 < cut[1]:
                prev = None
                continue
            if prev is not None:
                gaps.append(c.t0 - prev)
            calls.append(c)
            prev = c.t1
        seconds = self.window_s - ((cut[1] - cut[0]) if traced else 0.0)
        return calls, gaps, seconds


def model_config(m: dict):
    """The program's ``ModelConfig`` of a configuration file's model."""
    from repro_torch.models.config import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in m.items() if k in names})


def build_engine(cell: Cell, weights, dev):
    from repro_torch.serve.batcher import ServingEngine
    mix = cell.mix
    engine = ServingEngine(model_config(cell.model), reduced=False,
                           max_batch=mix["slots"],
                           max_len=traffic.max_len(mix), fused_decode=True,
                           params=weights, device=dev)
    engine.warmup(sorted(set(mix["prompt_lens"])), slots=True)
    return engine


def requests_for(mix: dict, seed: int, vocab: int):
    from repro_torch.serve.queue import Request
    return [Request(rid=i, arrival=0.0, prompt_len=p, gen_len=g, tokens=t)
            for i, (p, g, t) in enumerate(traffic.draw(mix, seed, vocab))]


def serve_window(engine, requests, seconds: float, tracer=None):
    """Drive ``ContinuousBatcher.run`` over ``requests`` for ``seconds``.
    Returns (timed engine, batcher, whether the backlog ran dry)."""
    from repro_torch.serve.batcher import ContinuousBatcher
    from repro_torch.serve.calibrator import OnlineCalibrator
    from repro_torch.serve.fabric import WallClockFabric
    from repro_torch.serve.scheduler import OffloadAwareScheduler
    calibrator = OnlineCalibrator()
    proc = f"f0:{max(AVAILABLE_M)}c"
    scheduler = OffloadAwareScheduler(calibrator, available_m=AVAILABLE_M,
                                      host_model=lambda n: float("inf"),
                                      proc=proc)
    timed = TimedEngine(engine, seconds, tracer)
    batcher = ContinuousBatcher(scheduler, calibrator,
                                fabric=WallClockFabric(), engine=timed,
                                proc=proc)
    _sync(engine.device)
    timed.start()
    drained = True
    try:
        batcher.run(requests)
    except WindowClosed:
        drained = False
    finally:
        if tracer is not None:
            tracer.stop()
    return timed, batcher, drained


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_kernels(dev) -> None:
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all(("decode_attention",))


def audit(calls, requests, slots, metrics):
    """The harness's count of the served tokens against the program's."""
    from repro_torch.serve.queue import RequestState
    served, prefill_of, problems = replay(calls, requests, slots)
    n = sum(len(v) for v in served.values())
    if n != metrics.tokens_generated:
        problems.append(f"{n} tokens in the calls, the program counted "
                        f"{metrics.tokens_generated}")
    finished = [r.rid for r in requests if r.state == RequestState.DONE]
    for r in requests:
        if r.state == RequestState.DONE and (
                r.generated is None
                or r.generated.tolist() != served.get(r.rid)):
            problems.append(f"request {r.rid}: its output is not the "
                            "tokens its calls returned")
    return served, prefill_of, finished, problems


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        dev, t_process: float, *, fault=None) -> tuple[dict, list[str]]:
    """One run; returns (the result line's object, the check lines).
    ``fault`` wraps the engine before the window (tests break the timed
    path with it)."""
    import torch
    from bench.weights import draw

    cell = Cell.load(root, workload)
    m, mix = cell.model, cell.mix
    layout = cell.family("layouts")
    build_kernels(dev)
    weights = draw(m, seed, dev, layout)
    engine = build_engine(cell, weights, dev)
    requests = requests_for(mix, seed, m["vocab_size"])
    if fault is not None:
        engine = fault(engine)
    tracer = None
    if trace:
        tracer = tracing.Tracer(TRACE_START * seconds,
                                min(TRACE_SECONDS, 0.5 * seconds))
        tracer.warm()
    setup_start = t_process
    timed, batcher, drained = serve_window(engine, requests, seconds, tracer)
    if drained:
        raise RuntimeError("the backlog ran dry before the window closed: "
                           "the mix needs more requests")
    t_window = timed.t_start
    setup_s = t_window - setup_start
    window_s = timed.t_end - t_window
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    calls, metrics = timed.calls, batcher.metrics
    served, prefill_of, finished, problems = audit(
        calls, requests, mix["slots"], metrics)
    prof = tracer.prof if tracer is not None and tracer.done else None
    del timed, batcher, engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = cell.family("reference")
    rids = check.sample(served, finished, seed, mix["slots"])
    ref_rids = list(rids)
    traced_rows = {r.rid for c in calls if c.traced and c.kind == "decode"
                   for _, r, _ in c.rows}
    want_routes = trace and m.get("num_experts", 0) > 0
    if want_routes:
        ref_rids += sorted(traced_rows - set(rids))
    jobs = check.jobs(ref_rids, served, prefill_of, calls, ref.COUPLED_ROWS)
    if getattr(ref, "decode_drops_nothing", None) and \
            not ref.decode_drops_nothing(m, mix["slots"]):
        raise RuntimeError("a decode call could drop tokens: the reference "
                           "would have to replay every decode call")
    t_ref = time.perf_counter()
    logits = ref.logits(weights, m, jobs, routes=want_routes) if jobs else []
    n = len(rids)
    read = check.numbers(logits[:n], [served[r] for r in rids])
    ref_s = time.perf_counter() - t_ref
    limits = check.limits(root, workload)
    compared = sum(len(served[r]) for r in rids)
    experts = {}
    if want_routes:
        experts = traced_experts(calls, dict(zip(ref_rids, jobs)))
    del logits, jobs

    data = RunData(m, mix, cell.family("counts"),
                   peak_table.peaks(device_name(dev)), setup_s,
                   t_window, window_s, calls, metrics, None, experts)
    if prof is not None:
        data.trace = tracing.read(prof, [(c.kind, *c.span) for c in calls
                                         if c.traced])
    values = {}
    for spec in cell.metrics(trace):
        v = cell.reader(spec["name"]).read(data)
        if v is not None:
            values[spec["name"]] = {"value": v, "unit": spec["unit"]}
    checks = {k: {"value": read[k], "limit": limits[k]["limit"]}
              for k in read if k in limits}
    checks["tokens_compared"] = {"value": compared, "limit": 1}
    checks["audit_problems"] = {"value": len(problems), "limit": 0}
    correct = (any(k in limits for k in read) and compared >= 1
               and not problems
               and all(read[k] <= limits[k]["limit"]
                       for k in read if k in limits))
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": device_name(dev),
              "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct,
              "attempted": len(prefill_of) + metrics.rejected,
              "failed": metrics.rejected + metrics.dropped,
              "metrics": values, "device": device}
    if trace and data.trace is not None:
        device["busy_s"] = data.trace.busy_s()
        device["window_s"] = data.trace.window_s
        result["breakdown"] = tracing.breakdown(data.trace)
    result["checks"] = checks
    lines = [f"timing: set-up {setup_s:.3f} s, window {window_s:.3f} s, "
             f"{len(calls)} engine calls, reference "
             f"{ref_s:.3f} s over {len(ref_rids)} requests"]
    if data.trace is not None:
        lines.append(f"trace: {len(data.trace.calls)} calls over "
                     f"{data.trace.window_s:.3f} s; share of device time "
                     f"inside them {tracing.inside_calls(data.trace):.6f}")
    lines += [f"audit: {p}" for p in problems[:20]]
    lines += [f"not compared: {k} {v}" for k, v in read.items()
              if k not in limits]
    lines += [f"check {k}: {v['value']} (limit {v['limit']}, at most)"
              if k != "tokens_compared" else
              f"check {k}: {v['value']} (limit {v['limit']}, at least)"
              for k, v in checks.items()]
    return result, lines


def device_name(dev) -> str:
    import torch
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def traced_experts(calls, job_of: dict) -> dict:
    """Per traced decode call, the distinct experts its occupied rows'
    tokens picked in each layer, by the reference's router."""
    out = {}
    for ci, c in enumerate(calls):
        if not (c.traced and c.kind == "decode") or not c.rows:
            continue
        per_layer = None
        for _, r, pos in c.rows:
            job = job_of.get(r.rid)
            e = pos - r.prompt_len
            if job is None or not job.routes or e >= len(job.extend):
                per_layer = None
                break
            ids = [set(layer[e].tolist()) for layer in job.routes]
            per_layer = ids if per_layer is None else \
                [a | b for a, b in zip(per_layer, ids)]
        if per_layer is not None:
            out[ci] = [len(s) for s in per_layer]
    return out


def p95(values) -> float:
    return statistics.quantiles(values, n=20, method="inclusive")[18]
