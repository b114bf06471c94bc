#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases; each raises on failure, and the script then exits non-zero without
printing a result:

  1. card: name and power limit (nvidia-smi), torch version; TF32 off;
  2. build: every CUDA kernel of the port, with nvcc, from the sources here;
  3. check: the decode-attention kernel against its plain PyTorch version
     on the card — caches bit-exact, attention out within tolerance;
  4. time: kernel and plain version at the chatglm3-6b decode shape (CUDA
     events, median, L2 flushed before each launch), beside the least time
     the card could take (bytes over HBM rate or ops over peak rate);
  5. serve: full-width chatglm3-6b (28 layers, d_model 4096, bf16, random
     seeded weights) through ``repro_torch.launch.serve.serve`` with the
     fused decode step; the kernel must launch 28 * (gen - 1) times and
     every step's credit counter must read its threshold; then a profile
     of a few warm decode steps: host wall per step vs device time by kind;
  6. fused vs unfused, teacher-forced, at full width in f32 with the depth
     cut to 4 layers: logits within 1e-3 and greedy tokens equal wherever
     the unfused top-2 gap exceeds 1e-3;
  7. a ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

It needs one card.  Without one (``torch.cuda.is_available()`` false), or
without the ``src/repro_torch`` package beside it, it exits non-zero at
once.  Full results also go to ``results/chip_smoke.json``.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:195"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}   # dense bf16 / f32 non-tensor
ARCH = "chatglm3-6b"

# (name, arch for the rope variant, B, S, H, K, D, dtype, lens, quant,
#  is_ring, window): the six small variants the reference kernel's tests
# check, one int8 cache with bf16 activations, and the chatglm3-6b decode
# shape that serving gives the kernel.
CASES = [
    ("plain-half-rope", "chatglm3-6b", 3, 64, 8, 2, 16, "f32",
     [5, 0, 63], False, False, 0),
    ("plain-std-rope-bf16", "granite-3-8b", 2, 32, 4, 4, 8, "bf16",
     [7, 31], False, False, 0),
    ("quant", "chatglm3-6b", 3, 64, 8, 2, 16, "f32",
     [5, 0, 63], True, False, 0),
    ("ring", "chatglm3-6b", 3, 32, 8, 2, 16, "f32",
     [100, 3, 32], False, True, 32),
    ("window-nonring", "granite-3-8b", 2, 64, 4, 4, 8, "f32",
     [40, 10], False, False, 16),
    ("quant-ring", "chatglm3-6b", 2, 32, 4, 2, 16, "f32",
     [70, 1], True, True, 32),
    ("quant-bf16", "chatglm3-6b", 2, 64, 8, 2, 16, "bf16",
     [5, 40], True, False, 0),
]
FULL_CASE = ("chatglm3-6b-decode", "chatglm3-6b", 4, 160, 32, 2, 128, "bf16",
             None, False, False, 0)   # lens drawn in [128, 160)
# Attention-out tolerance, kernel vs plain version on the card (PERF.md):
# f32 atol scales with max|V| (see check_case); bf16 rtol is two bf16 ULPs
# (one rounding flip after f32 sums taken in another order).
TOL = {"f32": dict(rtol=1e-5, atol=1e-6), "bf16": dict(rtol=1.6e-2, atol=1e-4)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# Kernel checks and timing
# --------------------------------------------------------------------------- #
def make_inputs(case, seed, dev):
    """The kernel's arguments for a case, drawn from a seeded CPU generator."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.layers import rope_cos_sin

    _, arch, b, s, h, kh, d, dt, lens, quant, _, _ = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dtype).to(dev)

    if lens is None:
        lens = torch.randint(128, s, (b,), generator=g).tolist()
    x = {"q": randn(b, 1, h, d), "k": randn(b, 1, kh, d), "v": randn(b, 1, kh, d)}
    if quant:
        for nm in ("kc", "vc"):
            x[nm] = torch.randint(-127, 128, (b, s, kh, d), generator=g,
                                  dtype=torch.int8).to(dev)
        for nm in ("ks", "vs"):
            x[nm] = (torch.rand((b, s, kh, 1), generator=g) * 0.099
                     + 0.001).to(dev)
    else:
        x["kc"], x["vc"] = randn(b, s, kh, d), randn(b, s, kh, d)
        x["ks"] = x["vs"] = None
    x["idx"] = torch.tensor(lens, dtype=torch.int32, device=dev)
    x["cos"], x["sin"] = rope_cos_sin(x["idx"][:, None], d, get_config(arch))
    return [x[n] for n in ("q", "k", "v", "kc", "vc", "idx", "cos", "sin",
                           "ks", "vs")], lens


def clone(args):
    return [a.clone() if a is not None else None for a in args]


def check_case(case, seed, dev) -> dict:
    """Kernel vs plain version on one case; caches must be bit-exact."""
    import torch
    from repro_torch.kernels import decode_attention as DA

    name, *_, dt, _, quant, is_ring, window = case
    args, lens = make_inputs(case, seed, dev)
    kw = dict(window=0 if is_ring else window, is_ring=is_ring)
    got = DA.fused_decode_attention(*clone(args), **kw)
    want = DA.decode_attention_plain(*clone(args), **kw)
    torch.cuda.synchronize()
    names = ("k_cache", "v_cache", "k_scale", "v_scale")
    for nm, g, w in zip(names, got[1:], want[1:]):
        if not torch.equal(g, w):
            bad = int((g != w).sum())
            raise AssertionError(f"{name}: {nm} differs from the plain "
                                 f"version in {bad} elements")
    diff = (got[0].float() - want[0].float()).abs()
    rel = float((diff / want[0].float().abs().clamp_min(1e-30)).max())
    tol = dict(TOL[dt])
    if dt == "f32":
        # The kernel and cuBLAS sum p@V in different orders: the absolute
        # slack scales with the largest value summed (dequantised int8
        # values reach +-12.7, random f32 ones ~4).
        v = args[4].float() * args[9] if quant else args[4].float()
        tol["atol"] *= max(1.0, float(v.abs().max()))
    torch.testing.assert_close(got[0], want[0], **tol,
                               msg=lambda m: f"{name}: out: {m}")
    res = {"case": name, "dtype": dt, "quant": quant, "lens": lens,
           "max_abs_err": float(diff.max()), "max_rel_err": rel,
           "tolerance": tol}
    log(f"[check] {name}: caches bit-exact, out max|err| "
        f"{res['max_abs_err']:.3e} (max rel {rel:.3e}; rtol "
        f"{tol['rtol']}, atol {tol['atol']:.3g})")
    return res


def time_ms(fn, dev, reps=200, warmup=20) -> float:
    """Median ms of one call, CUDA events around each; L2 flushed first."""
    import torch
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=dev)
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        # 1 GiB > the 50 MB L2, so the launch starts cold; zeroing it also
        # keeps the card busy while the host queues the timed call.
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def bound(case, args) -> tuple[float, str, float, float]:
    """Least time for the work: max(bytes / HBM rate, ops / peak rate)."""
    _, _, b, s, h, kh, d, dt, _, quant, _, _ = case
    q, k_cache = args[0], args[3]
    lens = args[5].tolist()
    act, elem = q.element_size(), k_cache.element_size()
    w = args[6].shape[-1]
    live = sum(min(n + 1, s) for n in lens)
    scales = 2 * 4 if quant else 0               # k and v scale per vector
    nbytes = (live * kh * (2 * d * elem + scales)      # live K/V read
              + b * kh * (2 * d * elem + scales)       # new token written
              + b * h * d * act * 2                    # q read, out written
              + b * kh * d * act * 2                   # k_new, v_new read
              + b * (2 * w * 4 + 4))                   # cos, sin, lens
    ops = sum(4 * h * d * min(n + 1, s) for n in lens)  # q.k and p@v MACs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dt]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, nbytes, ops


# --------------------------------------------------------------------------- #
# Phases
# --------------------------------------------------------------------------- #
def phase_serve(dev) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.launch.serve import serve

    prompts, prompt_len, gen = 4, 128, 32
    cfg = get_config(ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    DA.LAUNCHES = 0
    t0 = time.perf_counter()
    out = serve(ARCH, reduced=False, prompts=prompts, prompt_len=prompt_len,
                gen=gen, fused_decode=True, device=dev)
    wall = time.perf_counter() - t0
    launches = DA.LAUNCHES
    expect = cfg.num_layers * (gen - 1)
    if launches != expect:
        raise AssertionError(f"kernel launched {launches} times while "
                             f"serving, expected {expect}")
    if out["credits"] != [out["credit_threshold"]] * gen:
        raise AssertionError(f"credit reads {out['credits']}")
    toks = out["generated"]
    if toks.shape != (prompts, gen) or toks.min() < 0 or \
            toks.max() >= cfg.vocab_size:
        raise AssertionError(f"generated tokens out of range: {toks}")
    res = {"arch": ARCH, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "prompts": prompts, "prompt_len": prompt_len,
           "gen": gen, "launches": launches,
           "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
           "decode_tok_s": out["decode_tok_s"], "serve_wall_s": wall,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "offload_decision": out["offload_decision"],
           "first_tokens": toks[:, :8].tolist()}
    log(f"[serve] {ARCH} full width ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.dtype}): kernel launches {launches} == "
        f"{cfg.num_layers} x {gen - 1}; credits {gen}/{gen} at threshold")
    log(f"[serve] prefill_s {res['prefill_s']:.4f}  decode_s "
        f"{res['decode_s']:.4f}  decode_tok_s {res['decode_tok_s']:.1f}  "
        f"max_memory_allocated {res['max_memory_allocated'] / 2**30:.2f} GiB"
        f"  wall {wall:.1f} s (weights drawn on the card included)")
    log(f"[serve] offload decision (Eq.3): {res['offload_decision']}")
    return res


def _kind(name: str) -> str:
    if "decode_attention" in name:
        return "decode_attention"
    if any(k in name.lower() for k in ("gemm", "gemv", "splitk", "cutlass",
                                       "nvjet", "xmma")):
        return "matmul"
    return "other"


def phase_profile(dev, warm=8, steps=4) -> dict:
    """Where a full-width decode step's time goes: host wall per step vs
    device time by kernel kind (torch.profiler over a few warm steps)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.batcher import ServingEngine

    eng = ServingEngine(ARCH, reduced=False, max_batch=4, max_len=160,
                        fused_decode=True, device=dev)
    prompt = np.random.default_rng(1).integers(
        0, eng.cfg.vocab_size, (4, 128), dtype=np.int32)
    tok, caches, _ = eng.prefill(prompt)
    pos, walls = 128, []
    for _ in range(warm):
        tok, caches, w = eng.decode(tok[:, None], caches, pos)
        walls.append(w)
        pos += 1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(steps):
            tok, caches, _ = eng.decode(tok[:, None], caches, pos)
            pos += 1
    by_kind = {"decode_attention": 0.0, "matmul": 0.0, "other": 0.0}
    n_attn, top = 0, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue   # host ops also carry their kernels' device time
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            by_kind[_kind(e.key)] += us / 1e3 / steps
            top.append((us / 1e3 / steps, e.count // steps, e.key[:90]))
            if _kind(e.key) == "decode_attention":
                n_attn += e.count
    top.sort(reverse=True)
    wall_ms = statistics.median(walls) * 1e3
    busy_ms = sum(by_kind.values())
    res = {"shape": "B=4, S=160 slots, lens 136..139, fused decode",
           "warm_steps": warm, "profiled_steps": steps,
           "step_wall_ms_median": wall_ms, "device_ms_per_step": by_kind,
           "device_busy_ms_per_step": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
           "attention_kernels_per_step": n_attn / steps,
           "top_kernels_ms_calls_name": top[:10]}
    if busy_ms == 0:
        log("[profile] torch.profiler saw no device time")
    log(f"[profile] decode step: host-measured {wall_ms:.3f} ms (median of "
        f"{warm}, unprofiled); device busy {busy_ms:.3f} ms = attention "
        f"kernel {by_kind['decode_attention']:.3f} + matmul "
        f"{by_kind['matmul']:.3f} + other {by_kind['other']:.3f} ms "
        f"({n_attn / steps:.0f} attention launches per step); idle share "
        f"{res['idle_share']}")
    for ms, calls, name in top[:10]:
        log(f"[profile]   {ms:8.3f} ms/step  {calls:4d} calls  {name}")
    return res


def phase_teacher_forced(dev) -> dict:
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill)

    layers, b, prompt_len, steps = 4, 4, 128, 16
    cfg = replace(get_config(ARCH), num_layers=layers, dtype="float32")
    params = init_params(cfg, seed=0, device=dev)
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (b, prompt_len), generator=g,
                           dtype=torch.int32).to(dev)
    caches = init_cache(cfg, b, prompt_len + steps, device=dev)
    logits, caches = prefill(params, cfg, caches=caches, tokens=prompt)
    caches_u = pytree.tree_map(lambda t: t.clone(), caches)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    feed, fused = [], []
    for i in range(steps):
        feed.append(tok)
        lg, caches = decode_step(params, cfg, tok[:, None], caches,
                                 prompt_len + i, fused=True)
        fused.append(lg[:, 0])
        tok = lg[:, 0].argmax(-1).to(torch.int32)
    worst, checked, near_ties = 0.0, 0, 0
    for i in range(steps):
        lg, caches_u = decode_step(params, cfg, feed[i][:, None], caches_u,
                                   prompt_len + i, fused=False)
        ref = lg[:, 0]
        diff = float((fused[i] - ref).abs().max())
        worst = max(worst, diff)
        if diff > 1e-3:
            raise AssertionError(f"step {i}: fused vs unfused logits differ "
                                 f"by {diff:.3e} > 1e-3")
        top2 = ref.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-3
        same = fused[i].argmax(-1) == ref.argmax(-1)
        if not bool(same[clear].all()):
            raise AssertionError(f"step {i}: greedy tokens differ")
        checked += int(clear.sum())
        near_ties += int((~clear).sum())
    torch.cuda.synchronize()
    res = {"layers": layers, "d_model": cfg.d_model, "dtype": cfg.dtype,
           "prompts": b, "prompt_len": prompt_len, "steps": steps,
           "max_abs_logit_diff": worst, "tokens_checked": checked,
           "near_ties_skipped": near_ties}
    log(f"[teacher-forced] f32, full width, depth cut to {layers} layers, "
        f"{b} prompts x {steps} steps: max|logit diff| {worst:.3e} <= 1e-3; "
        f"argmax equal on {checked} tokens ({near_ties} near-ties skipped)")
    return res


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: no src/repro_torch beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "script needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as DA

    # 1. Card.
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
        f"device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    results = {"card": card, "torch": torch.__version__,
               "cuda": torch.version.cuda}

    # 2. Build.
    t0 = time.perf_counter()
    _build.build_all()
    results["build_s"] = time.perf_counter() - t0
    log(f"[build] {len(_build.SOURCES)} kernel source(s) in "
        f"{results['build_s']:.1f} s")
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {name}: {line.strip()}")

    # 3. Kernel vs plain version.
    results["checks"] = [check_case(c, 0, dev) for c in CASES]
    results["checks"] += [check_case(FULL_CASE, s, dev) for s in range(3)]
    full_err = max(c["max_abs_err"] for c in results["checks"]
                   if c["case"] == FULL_CASE[0])

    # 4. Timing at the full decode shape.
    args, lens = make_inputs(FULL_CASE, 0, dev)
    a_kernel, a_plain = clone(args), clone(args)
    kernel_ms = time_ms(lambda: DA.fused_decode_attention(*a_kernel), dev)
    plain_ms = time_ms(lambda: DA.decode_attention_plain(*a_plain), dev)
    bound_ms, bound_by, nbytes, ops = bound(FULL_CASE, args)
    results["timing"] = {"shape": "B=4 S=160 H=32 K=2 D=128 W=32 bf16",
                         "lens": lens, "kernel_ms": kernel_ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "bytes": nbytes, "ops": ops,
                         "l2": "flushed before each launch"}
    log(f"[time] fused_decode_attention at {results['timing']['shape']}, "
        f"lens {lens}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B / 3.35 TB/s, "
        f"{ops} ops)")

    # 5. Full-width serving: the main path, launches counted from 0.
    results["serve"] = phase_serve(dev)
    gc.collect()
    torch.cuda.empty_cache()
    results["profile"] = phase_profile(dev)
    gc.collect()
    torch.cuda.empty_cache()

    # 6. Fused vs unfused, teacher-forced.
    results["teacher_forced"] = phase_teacher_forced(dev)
    results["total_s"] = time.perf_counter() - t_start

    kernels = {"kernels": [{
        "name": "fused_decode_attention", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": results["serve"]["launches"], "max_abs_err": full_err,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}]}
    results.update(kernels)
    out_dir = REPO / "results"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    log(f"[done] {results['total_s']:.1f} s")
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
