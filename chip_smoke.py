#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases; each raises on failure, and the script then exits non-zero without
printing a result:

  1. card: name and power limit (nvidia-smi), torch version; TF32 off;
  2. build: every CUDA kernel of the port (decode_attention, daxpy,
     fused_adamw), one nvcc each, all started together, from the sources
     here;
  3. check: the decode-attention kernels against their plain PyTorch
     version on the card (the reference's cases, the serving shape, and the
     serving shape with the new token on a chunk edge of the split) —
     caches bit-exact, attention out within tolerance;
  4. time: kernels and plain version at the chatglm3-6b decode shape (CUDA
     events, median, L2 flushed before each launch), beside the least time
     the card could take (bytes over HBM rate or ops over peak rate); the
     split's NSPLIT and each of its two kernels' device time
     (torch.profiler);
  5. daxpy: the kernel against ``daxpy_plain``, bit-exact, on the shapes and
     dtypes of tests/test_kernels.py and every length 1..5000; the kernel
     ops' main path (``kernels.ops.daxpy``, one offloaded job per size) with
     its launches counted from 0; times at n = 2^10 .. 2^27 f32 beside the
     bound, the plain version and ``torch.add(y, x, alpha=a)``, the kernel
     and ``torch.add`` timed in turns (kernel, add, add, kernel);
  6. adamw: the kernel against ``adamw_plain`` on the cases of
     tests/test_kernels.py and on the training shape's largest leaf (m, v
     bit-exact, p within 1 ULP); one whole-tree update of the training
     shape timed beside its bound, the plain version and
     ``torch._fused_adamw_`` (timed only);
  7. serve: full-width chatglm3-6b (28 layers, d_model 4096, bf16, random
     seeded weights) through ``repro_torch.launch.serve.serve`` with the
     fused decode step; the kernel must launch 28 * (gen - 1) times and
     every step's credit counter must read its threshold; then a profile
     of a few warm decode steps: host wall per step vs device time by kind;
  8. train: chatglm3-6b at full width, depth cut to 8 layers, through
     ``repro_torch.launch.train.run`` with the fused AdamW kernel under the
     step supervisor: 8 steps of 4 x 512 tokens; the kernel must launch
     12 * 8 times, no credit may fall short, every loss must be finite;
     then a profile of one warm step by kernel kind;
  9. fused vs unfused decoding, teacher-forced, at full width in f32 with
     the depth cut to 4 layers: logits within 1e-3 and greedy tokens equal
     wherever the unfused top-2 gap exceeds 1e-3;
 10. kernel vs plain optimizer: 3 training steps at full width in f32, depth
     cut to 2 layers, from the same weights and batches: losses within 1e-5
     relative, parameters within the tolerance stated at OPT_PARAM_TOL;
 11. a ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

It needs one card.  Without one (``torch.cuda.is_available()`` false), or
without the ``src/repro_torch`` package beside it, it exits non-zero at
once.  Full results also go to ``results/chip_smoke.json``.
"""

from __future__ import annotations

import gc
import json
import shutil
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
DAXPY_SOURCE = "src/repro_torch/kernels/csrc/daxpy.cu"
DAXPY_REPLACES = "src/repro/kernels/daxpy.py:35"
ADAMW_SOURCE = "src/repro_torch/kernels/csrc/fused_adamw.cu"
ADAMW_REPLACES = "src/repro/kernels/fused_adamw.py:52"
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
# The serving shape with the new token on the first or last slot of a chunk
# of the scores kernel's split (16 chunks of 10 slots at B=4, K=2, S=160),
# in each cache dtype.
EDGE_CASES = [
    ("decode-chunk-edges", "chatglm3-6b", 4, 160, 32, 2, 128, "bf16",
     [130, 139, 0, 159], False, False, 0),
    ("decode-chunk-edges-2", "chatglm3-6b", 4, 160, 32, 2, 128, "bf16",
     [9, 10, 149, 150], False, False, 0),
    ("decode-chunk-edges-q8", "chatglm3-6b", 4, 160, 32, 2, 128, "bf16",
     [19, 20, 79, 80], True, False, 0),
    ("decode-chunk-edges-f32", "chatglm3-6b", 4, 160, 32, 2, 128, "f32",
     [10, 99, 100, 155], False, False, 0),
]
# (case, offset): cases that take the kernels' scalar-load build, where a
# cache row of D * sizeof(cache) bytes is no multiple of 16 (int8 with D=8,
# bf16 with D=12) or the caches start `offset` elements past a 16-byte
# boundary (the serving shape in bf16 and int8).
SCALAR_LOAD_CASES = [
    (("narrow-head-q8", "granite-3-8b", 2, 32, 4, 4, 8, "bf16",
      [7, 31], True, False, 0), 0),
    (("narrow-head-bf16", "granite-3-8b", 2, 32, 4, 2, 12, "bf16",
      [5, 30], False, False, 0), 0),
    (("decode-unaligned-caches", "chatglm3-6b", 4, 160, 32, 2, 128, "bf16",
      [9, 10, 149, 150], False, False, 0), 1),
    (("decode-unaligned-caches-q8", "chatglm3-6b", 4, 160, 32, 2, 128,
      "bf16", [19, 20, 79, 80], True, False, 0), 3),
]
# daxpy: the shapes and dtypes of tests/test_kernels.py, and the sizes the
# offload sweep times (f32).
DAXPY_SHAPES = [(5,), (128,), (1000,), (8, 128), (3, 7, 11), (256, 256),
                (1, 1)]
DAXPY_SIZES = [2 ** 10, 2 ** 16, 2 ** 20, 2 ** 24, 2 ** 27]
# adamw: the cases of tests/test_kernels.py (shape, p dtype, step).
ADAMW_CASES = [(shape, dt, step)
               for shape in [(130,), (4, 128), (1000,), (16, 16, 16)]
               for dt in ("f32", "bf16") for step in (1, 100)]
ADAMW_HPS = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
# Training: chatglm3-6b at full width, depth cut to 8 of 28 layers (6.24 G
# params x 12 B of bf16 p/g and f32 m/v would not fit in 80 GB with
# activations; 8 layers hold 2.16 G params, ~26 GB of optimizer state).
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 4, 512, 8
# Kernel vs plain optimizer over 3 steps (f32, 2 layers): a parameter may
# differ by at most OPT_PARAM_TOL["abs"] in all but a fraction
# OPT_PARAM_TOL["frac"] of elements, and by at most 2 * sum(lr) anywhere —
# the two update paths round 1 - b1 differently (~3e-8 in m), and Adam's
# m/sqrt(v) can amplify a difference where the gradient is near 0, up to a
# full sign flip of one step (2 * lr).
OPT_PARAM_TOL = {"abs": 1e-6, "frac": 1e-5}
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


def offset_copy(t, offset: int):
    """A contiguous copy of ``t`` that starts ``offset`` elements into its
    allocation, so off a 16-byte boundary unless offset * itemsize is a
    multiple of 16."""
    import torch
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape).copy_(t)
    assert out.data_ptr() % 16 == (offset * t.element_size()) % 16
    return out


def check_case(case, seed, dev, offset=0) -> dict:
    """Kernel vs plain version on one case; caches must be bit-exact."""
    import torch
    from repro_torch.kernels import decode_attention as DA

    name, *_, dt, _, quant, is_ring, window = case
    args, lens = make_inputs(case, seed, dev)
    kw = dict(window=0 if is_ring else window, is_ring=is_ring)
    kargs = clone(args)
    if offset:   # the kernel's caches off a 16-byte boundary
        kargs[3], kargs[4] = (offset_copy(t, offset) for t in kargs[3:5])
    got = DA.fused_decode_attention(*kargs, **kw)
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


def _device_us(event) -> float:
    """A profiler event's own device time in µs, under either of the names
    torch versions give it."""
    us = getattr(event, "self_device_time_total", None)
    return getattr(event, "self_cuda_time_total", 0.0) if us is None else us


def time_split(fn, dev, calls=100) -> dict:
    """Device ms per call of each of the decode step's two kernels (mean of
    ``calls`` profiled calls, L2 flushed before each), by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=dev)
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = {"scores": 0.0, "pv": 0.0}
    counts = {"scores": 0, "pv": 0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = _device_us(e)
        for part in us:
            if f"decode_attention_{part}" in e.key:
                us[part] += t
                counts[part] += e.count
    res = {"calls": calls}
    for part in us:
        # None where the profiler saw no launch of that kernel.
        res[f"{part}_ms"] = us[part] / 1e3 / calls if counts[part] else None
        res[f"{part}_launches_profiled"] = counts[part]
    return res


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
    prof_walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(steps):
            tok, caches, w = eng.decode(tok[:, None], caches, pos)
            prof_walls.append(w)
            pos += 1
    by_kind = {"decode_attention": 0.0, "matmul": 0.0, "other": 0.0}
    n_attn, top = 0, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue   # host ops also carry their kernels' device time
        us = _device_us(e)
        if us > 0:
            by_kind[_kind(e.key)] += us / 1e3 / steps
            top.append((us / 1e3 / steps, e.count // steps, e.key[:90]))
            if _kind(e.key) == "decode_attention":
                n_attn += e.count
    top.sort(reverse=True)
    wall_ms = statistics.median(walls) * 1e3
    # Busy and wall time both of the profiled steps.
    prof_wall_ms = sum(prof_walls) / steps * 1e3
    busy_ms = sum(by_kind.values())
    res = {"shape": "B=4, S=160 slots, lens 136..139, fused decode",
           "warm_steps": warm, "profiled_steps": steps,
           "step_wall_ms_median": wall_ms,
           "profiled_step_wall_ms": prof_wall_ms,
           "device_ms_per_step": by_kind,
           "device_busy_ms_per_step": busy_ms,
           "idle_share": 1.0 - busy_ms / prof_wall_ms if busy_ms else None,
           "attention_kernels_per_step": n_attn / steps,
           "top_kernels_ms_calls_name": top[:10]}
    if busy_ms == 0:
        log("[profile] torch.profiler saw no device time")
    log(f"[profile] decode step: host-measured {wall_ms:.3f} ms (median of "
        f"{warm}, unprofiled), {prof_wall_ms:.3f} ms (mean of the {steps} "
        f"profiled); device busy {busy_ms:.3f} ms = attention "
        f"kernel {by_kind['decode_attention']:.3f} + matmul "
        f"{by_kind['matmul']:.3f} + other {by_kind['other']:.3f} ms "
        f"({n_attn / steps:.0f} attention kernel launches per step, two "
        f"per call); idle share "
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

# --------------------------------------------------------------------------- #
# daxpy and fused AdamW
# --------------------------------------------------------------------------- #
def _dtype(name: str):
    import torch
    return {"f32": torch.float32, "bf16": torch.bfloat16}[name]


def check_daxpy(dev) -> dict:
    """Kernel vs ``daxpy_plain``, bit-exact: test_kernels.py's shapes and
    dtypes, every length 1..5000 (f32), and unaligned views (scalar path)."""
    import torch
    from repro_torch.kernels import daxpy as DX

    g = torch.Generator().manual_seed(0)
    cases = [(shape, dt, 2.5) for shape in DAXPY_SHAPES
             for dt in ("f32", "bf16")]
    a_vals = (torch.rand(5000, generator=g) * 20 - 10).tolist()
    cases += [((n,), "f32", a_vals[n - 1]) for n in range(1, 5001)]
    bad, worst = [], 0.0
    for shape, dt, a in cases:
        x = torch.randn(shape, generator=g).to(_dtype(dt)).to(dev)
        y = torch.randn(shape, generator=g).to(_dtype(dt)).to(dev)
        got, want = DX.daxpy(a, x, y), DX.daxpy_plain(a, x, y)
        if not torch.equal(got, want):
            bad.append((shape, dt))
            worst = max(worst, float((got.float() - want.float()).abs().max()))
    for dt in ("f32", "bf16"):       # views 1 element off 16-byte alignment
        for n in (1, 7, 8, 9, 1023, 4097):
            buf = torch.randn(2, n + 1, generator=g).to(_dtype(dt)).to(dev)
            x, y = buf[0, 1:], buf[1, 1:]
            if not torch.equal(DX.daxpy(-1.5, x, y),
                               DX.daxpy_plain(-1.5, x, y)):
                bad.append(((n,), dt + " unaligned"))
    torch.cuda.synchronize()
    if bad:
        raise AssertionError(f"daxpy differs from its plain version on "
                             f"{len(bad)} cases, e.g. {bad[:5]} (max|err| "
                             f"{worst:.3e})")
    n_cases = len(cases) + 12
    log(f"[daxpy] kernel bit-exact against daxpy_plain on {n_cases} cases "
        f"(14 test_kernels shapes x dtypes, lengths 1..5000, 12 unaligned)")
    return {"cases": n_cases, "max_abs_err": 0.0}


def _daxpy_inputs(n: int, dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(n)
    return (torch.randn(n, generator=g, device=dev),
            torch.randn(n, generator=g, device=dev))


def phase_daxpy_offload(dev) -> dict:
    """The kernel ops' main path: one ``kernels.ops.daxpy`` job per size,
    launches counted from 0, each result held against the plain version."""
    import torch
    from repro_torch.kernels import daxpy as DX
    from repro_torch.kernels import ops

    inputs = {n: _daxpy_inputs(n, dev) for n in DAXPY_SIZES}
    DX.LAUNCHES = 0
    outs = {n: ops.daxpy(2.5, x, y) for n, (x, y) in inputs.items()}
    torch.cuda.synchronize()
    launches = DX.LAUNCHES
    if launches != len(DAXPY_SIZES):
        raise AssertionError(f"daxpy launched {launches} times, expected "
                             f"{len(DAXPY_SIZES)}")
    for n, (x, y) in inputs.items():
        if not torch.equal(outs[n], DX.daxpy_plain(2.5, x, y)):
            raise AssertionError(f"ops.daxpy at n={n} differs from the plain "
                                 "version")
    log(f"[daxpy] ops.daxpy at n = {DAXPY_SIZES}: {launches} launches, "
        "every result bit-exact")
    return {"sizes": DAXPY_SIZES, "launches": launches}


def time_daxpy(dev) -> list[dict]:
    import torch
    from repro_torch.kernels import daxpy as DX

    rows = []
    for n in DAXPY_SIZES:
        x, y = _daxpy_inputs(n, dev)

        def kernel():
            DX.daxpy(2.5, x, y)

        def add():
            torch.add(y, x, alpha=2.5)

        # In turns: kernel, add, add, kernel; each entry a median.
        turns = [time_ms(f, dev) for f in (kernel, add, add, kernel)]
        kernel_ms = (turns[0] + turns[3]) / 2
        library_ms = (turns[1] + turns[2]) / 2
        plain_ms = time_ms(lambda: DX.daxpy_plain(2.5, x, y), dev)
        nbytes = 12 * n                   # read x, y; write o (f32)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * n / PEAK_OPS_PER_S["f32"]
        row = {"n": n, "dtype": "f32", "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "turns_kernel_add_add_kernel_ms": turns,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "kernel_gb_s": nbytes / kernel_ms / 1e6}
        rows.append(row)
        log(f"[daxpy] n=2^{n.bit_length() - 1} f32: kernel {turns[0]:.4f} / "
            f"{turns[3]:.4f} ms (first / last turn; {row['kernel_gb_s']:.0f} "
            f"GB/s at their mean), torch.add {turns[1]:.4f} / {turns[2]:.4f} "
            f"ms (second / third turn), plain {plain_ms:.4f} ms, bound "
            f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
        del x, y
    return rows


def _ulps(got, want) -> int:
    """Largest distance in units in the last place (same-sign values)."""
    import torch
    ity = torch.int32 if got.dtype == torch.float32 else torch.int16
    return int((got.view(ity).int() - want.view(ity).int()).abs().max())


def check_adamw_tensors(name, p, g, m, v, hp) -> dict:
    """Kernel vs ``adamw_plain`` on clones: m, v bit-exact, p <= 1 ULP."""
    import torch
    from repro_torch.kernels import fused_adamw as FA

    pk, mk, vk = p.clone(), m.clone(), v.clone()
    FA.fused_adamw(pk, g, mk, vk, hp)
    pw, mw, vw = FA.adamw_plain(p, g, m, v, hp)
    torch.cuda.synchronize()
    for nm, a, b in (("m", mk, mw), ("v", vk, vw)):
        if not torch.equal(a, b):
            raise AssertionError(f"adamw {name}: {nm} differs from the plain "
                                 f"version in {int((a != b).sum())} elements")
    ulps = _ulps(pk, pw)
    err = float((pk.float() - pw.float()).abs().max())
    if ulps > 1:
        raise AssertionError(f"adamw {name}: p differs by {ulps} ULP")
    return {"case": name, "p_max_ulps": ulps, "p_max_abs_err": err}


def check_adamw(dev, train_cfg) -> list[dict]:
    import torch
    from repro_torch.kernels.fused_adamw import pack_hparams

    g = torch.Generator().manual_seed(1)
    res = []
    for shape, dt, step in ADAMW_CASES:
        p = torch.randn(shape, generator=g).to(_dtype(dt)).to(dev)
        gr = (torch.randn(shape, generator=g) * 0.1).to(_dtype(dt)).to(dev)
        m = (torch.randn(shape, generator=g) * 0.01).to(dev)
        v = (torch.randn(shape, generator=g).abs() * 0.001).to(dev)
        hp = pack_hparams(**ADAMW_HPS, step=step, device=dev)
        res.append(check_adamw_tensors(f"{shape} {dt} step {step}", p, gr, m,
                                       v, hp))
    # The largest leaf of the training shape: w_in (8, 4096, 13696) bf16.
    shape = (TRAIN_LAYERS, train_cfg.d_model, train_cfg.d_ff)
    gd = torch.Generator(device=dev).manual_seed(2)
    p = (torch.randn(shape, generator=gd, device=dev) * 0.02).bfloat16()
    gr = (torch.randn(shape, generator=gd, device=dev) * 1e-3).bfloat16()
    m = torch.randn(shape, generator=gd, device=dev) * 1e-4
    v = torch.randn(shape, generator=gd, device=dev).square_() * 1e-6
    hp = pack_hparams(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, step=3,
                      device=dev)
    res.append(check_adamw_tensors(f"w_in {shape} bf16 step 3", p, gr, m, v,
                                   hp))
    worst = max(r["p_max_ulps"] for r in res)
    log(f"[adamw] kernel against adamw_plain on {len(res)} cases (w_in "
        f"{shape} bf16 among them): m, v bit-exact; p max {worst} ULP, max "
        f"|err| {max(r['p_max_abs_err'] for r in res):.3e}")
    return res


def _train_tree(cfg, dev):
    """Params, bf16/f32 grads and f32 moments shaped like the train step's."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.models import init_params
    from repro_torch.optim import init_opt_state

    params = init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)

    def grad(p):
        return (torch.randn(p.shape, generator=gen, device=dev) * 1e-3
                ).to(p.dtype)

    leaves = pytree.tree_leaves(params)
    grads = [grad(p) for p in leaves]
    st = init_opt_state(params)
    return leaves, grads, pytree.tree_leaves(st["m"]), \
        pytree.tree_leaves(st["v"])


def time_adamw(dev, train_cfg) -> dict:
    """One whole-tree update of the training shape: kernel, plain, bound,
    and torch._fused_adamw_ (what torch.optim.AdamW(fused=True) calls)."""
    import torch
    from repro_torch.kernels import fused_adamw as FA
    from repro_torch.kernels.fused_adamw import pack_hparams

    ps, gs, ms, vs = _train_tree(train_cfg, dev)
    hp = pack_hparams(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, step=1,
                      device=dev)

    def kernel():
        for p, g, m, v in zip(ps, gs, ms, vs):
            FA.fused_adamw(p, g, m, v, hp)

    def plain():
        for p, g, m, v in zip(ps, gs, ms, vs):
            FA.adamw_plain(p, g, m, v, hp)

    kernel_ms = time_ms(kernel, dev, reps=10, warmup=2)
    plain_ms = time_ms(plain, dev, reps=5, warmup=1)
    n_elems = sum(p.numel() for p in ps)
    nbytes = sum(p.numel() * (2 * p.element_size() + g.element_size() + 16)
                 for p, g in zip(ps, gs))
    ops = 15 * n_elems
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["f32"]
    # torch._fused_adamw_ takes one dtype for p, g, m and v; where it refuses
    # bf16 p with f32 moments it is timed with bf16 moments for the bf16
    # leaves, as torch.optim.AdamW(fused=True) keeps them for bf16 params.
    steps = [torch.ones((), device=dev) for _ in ps]
    kw = dict(lr=3e-4, beta1=0.9, beta2=0.95, weight_decay=0.1, eps=1e-8,
              amsgrad=False, maximize=False)
    lib_ms, variant = None, "p, g, m, v as the kernel takes them"
    try:
        torch._fused_adamw_([ps[0][:1].clone()], [gs[0][:1].clone()],
                            [ms[0][:1].clone()], [vs[0][:1].clone()], [],
                            [steps[0].clone()], **kw)
        lm, lv = ms, vs
    except RuntimeError:
        variant = "bf16 moments for the bf16 leaves (mixed dtypes refused)"
        lm = [m.to(p.dtype) for p, m in zip(ps, ms)]
        lv = [v.to(p.dtype) for p, v in zip(ps, vs)]
    groups: dict = {}
    for p, g, m, v, s in zip(ps, gs, lm, lv, steps):
        groups.setdefault(p.dtype, []).append((p, g, m, v, s))

    def library():
        for items in groups.values():
            cols = [list(c) for c in zip(*items)]
            torch._fused_adamw_(cols[0], cols[1], cols[2], cols[3], [],
                                cols[4], **kw)

    lib_ms = time_ms(library, dev, reps=10, warmup=2)
    res = {"leaves": len(ps), "elements": n_elems, "bytes": nbytes,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "library_variant": variant,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "kernel_gb_s": nbytes / kernel_ms / 1e6}
    log(f"[adamw] whole-tree update, {len(ps)} leaves, {n_elems} elements "
        f"({nbytes / 1e9:.2f} GB): kernel {kernel_ms:.3f} ms "
        f"({res['kernel_gb_s']:.0f} GB/s), plain {plain_ms:.3f} ms, "
        f"torch._fused_adamw_ {lib_ms:.3f} ms ({variant}), bound "
        f"{res['bound_ms']:.3f} ms ({res['bound_by']})")
    return res


# --------------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------------- #
def train_cfg(layers: int, dtype: str | None = None):
    from repro_torch.configs import get_config
    cfg = replace(get_config(ARCH), num_layers=layers)
    return replace(cfg, dtype=dtype) if dtype else cfg


def train_opt(steps: int):
    from repro_torch.optim import AdamWConfig
    return AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=steps)


def _train_kind(name: str) -> str:
    if "adamw_kernel" in name:
        return "fused_adamw"
    return _kind(name)


def phase_train(dev) -> dict:
    """The training path at full width: 8 supervised steps, fused AdamW."""
    import math

    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.kernels import fused_adamw as FA
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step

    cfg = train_cfg(TRAIN_LAYERS)
    step = make_train_step(cfg, opt_cfg=train_opt(TRAIN_STEPS), remat=False,
                           fused_adamw=True)
    ckpt_dir = REPO / "results" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats(dev)
    FA.LAUNCHES = 0
    t0 = time.perf_counter()
    out = train.run(cfg, step, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                    seq=TRAIN_SEQ, ckpt_dir=ckpt_dir,
                    ckpt_every=TRAIN_STEPS + 1, log_every=1, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = FA.LAUNCHES
    ckpt_bytes = sum(f.stat().st_size for f in ckpt_dir.rglob("*.npy"))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    leaves = pytree.tree_leaves(out["params"])
    n_leaves = sum(p.ndim >= 1 and p.numel() >= 128 for p in leaves)
    expect = n_leaves * TRAIN_STEPS
    if launches != expect:
        raise AssertionError(f"fused AdamW launched {launches} times while "
                             f"training, expected {expect}")
    if out["steps"] != TRAIN_STEPS or out["faults"] or out["restarts"]:
        raise AssertionError(f"supervisor: {out['steps']} steps, faults "
                             f"{out['faults']}, restarts {out['restarts']}")
    losses = out["losses"]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"losses {losses}")
    secs = out["step_seconds"]
    warm = statistics.median(secs[1:])
    # The rate over every warm step, stalls included; the median beside it.
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ * len(secs[1:]) / sum(secs[1:])
    n_params = sum(p.numel() for p in leaves)
    # The optimizer's least time per step: read p, g, m, v; write p, m, v.
    opt_bytes = sum(p.numel() * (3 * p.element_size() + 16) for p in leaves)
    res = {"arch": ARCH, "layers": TRAIN_LAYERS, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "params": n_params, "leaves": n_leaves,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "launches": launches, "losses": losses, "step_seconds": secs,
           "step_s_median_warm": warm, "tokens_per_s": tokens_per_s,
           "tokens_per_s_at_median": TRAIN_BATCH * TRAIN_SEQ / warm,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "optimizer_bound_ms": opt_bytes / HBM_BYTES_PER_S * 1e3,
           "rollback_checkpoint_bytes": ckpt_bytes, "wall_s": wall}
    log(f"[train] {ARCH} full width, depth cut to {TRAIN_LAYERS} layers "
        f"({n_params} params, {cfg.dtype}), {TRAIN_STEPS} supervised steps "
        f"of {TRAIN_BATCH} x {TRAIN_SEQ}: fused AdamW launches {launches} == "
        f"{n_leaves} x {TRAIN_STEPS}; no credit short, no restart")
    log(f"[train] losses {[round(x, 4) for x in losses]}")
    log(f"[train] step seconds {[round(x, 4) for x in secs]} (host queueing "
        f"+ credit wait); steps 2-{TRAIN_STEPS}: {tokens_per_s:.0f} tokens/s "
        f"(all their tokens over all their seconds), median step "
        f"{warm:.4f} s; max_memory_allocated "
        f"{res['max_memory_allocated'] / 2**30:.2f} GiB; wall {wall:.1f} s "
        f"(weights drawn on the card and the {ckpt_bytes / 1e9:.2f} GB "
        f"rollback checkpoint at step 0 included)")
    res["profile"] = profile_train_step(dev, cfg, step, out)
    prof = res["profile"]
    log(f"[train] optimizer device time per step "
        f"{prof['device_ms']['fused_adamw']:.3f} ms ({prof['adamw_launches']} "
        f"fused AdamW launches) beside its bound "
        f"{res['optimizer_bound_ms']:.3f} ms ({opt_bytes} B / 3.35 TB/s)")
    return res


def profile_train_step(dev, cfg, step, out) -> dict:
    """Device time of one warm train step by kernel kind (torch.profiler)."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import DataConfig, packed_batches

    params, opt_state = out["params"], out["opt_state"]
    tokens = torch.from_numpy(next(packed_batches(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=5)))).to(dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        # Busy and wall time both of this one step.
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state,
                                          {"tokens": tokens})
        int(metrics["credits"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind = {"fused_adamw": 0.0, "matmul": 0.0, "other": 0.0}
    n_adamw, top = 0, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = _device_us(e)
        if us > 0:
            kind = _train_kind(e.key)
            by_kind[kind if kind in by_kind else "other"] += us / 1e3
            top.append((us / 1e3, e.count, e.key[:90]))
            if kind == "fused_adamw":
                n_adamw += e.count
    top.sort(reverse=True)
    busy = sum(by_kind.values())
    res = {"step_wall_ms": wall_ms, "device_ms": by_kind,
           "device_busy_ms": busy,
           "idle_share": 1.0 - busy / wall_ms if busy else None,
           "adamw_launches": n_adamw, "top_kernels_ms_calls_name": top[:10],
           "finite": math.isfinite(float(metrics["loss"]))}
    if busy == 0:
        log("[train-profile] torch.profiler saw no device time")
    log(f"[train-profile] warm step: host-measured {wall_ms:.1f} ms "
        f"(profiled); device busy {busy:.1f} ms = fused AdamW "
        f"{by_kind['fused_adamw']:.3f} ({n_adamw} launches) + matmul "
        f"{by_kind['matmul']:.1f} + other {by_kind['other']:.1f} ms; idle "
        f"share {res['idle_share']}")
    for ms, calls, name in top[:10]:
        log(f"[train-profile]   {ms:8.3f} ms  {calls:4d} calls  {name}")
    return res


def phase_optimizer_paths(dev) -> dict:
    """Kernel vs plain optimizer: 3 steps from the same weights and batches
    (f32, full width, 2 layers)."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step

    steps = 3
    cfg = train_cfg(2, "float32")
    opt = train_opt(TRAIN_STEPS)
    runs = {}
    for fused in (True, False):
        step = make_train_step(cfg, opt_cfg=opt, remat=False,
                               fused_adamw=fused)
        ckpt_dir = REPO / "results" / f"opt_ckpt_{int(fused)}"
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        out = train.run(cfg, step, steps=steps, batch=TRAIN_BATCH,
                        seq=TRAIN_SEQ, ckpt_dir=ckpt_dir,
                        ckpt_every=steps + 1, log_every=1, device=dev)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        runs[fused] = (out["losses"], pytree.tree_leaves(out["params"]))
        del out
    (lk, pk), (lp, pp) = runs[True], runs[False]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    if rel > 1e-5:
        raise AssertionError(f"losses kernel {lk} vs plain {lp}: rel {rel}")
    lr_sum = sum(opt.lr * min(t / opt.warmup_steps, 1.0)
                 for t in range(1, steps + 1))
    worst, n_over, n_all = 0.0, 0, 0
    for a, b in zip(pk, pp):
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        n_over += int((d > OPT_PARAM_TOL["abs"]).sum())
        n_all += d.numel()
    frac = n_over / n_all
    if worst > 2 * lr_sum or frac > OPT_PARAM_TOL["frac"]:
        raise AssertionError(f"params: max|diff| {worst:.3e} (limit "
                             f"{2 * lr_sum:.3e}), {n_over} of {n_all} beyond "
                             f"{OPT_PARAM_TOL['abs']}")
    res = {"layers": 2, "dtype": "float32", "steps": steps,
           "losses_kernel": lk, "losses_plain": lp, "loss_max_rel": rel,
           "param_max_abs_diff": worst, "param_beyond_abs_tol": n_over,
           "param_elements": n_all, "param_limit_2_sum_lr": 2 * lr_sum}
    log(f"[optimizer] kernel vs plain, f32, 2 layers, {steps} steps: losses "
        f"max rel diff {rel:.3e} <= 1e-5; params max|diff| {worst:.3e} "
        f"(<= 2 sum(lr) = {2 * lr_sum:.3e}); {n_over} of {n_all} beyond "
        f"{OPT_PARAM_TOL['abs']}")
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

    def free():
        gc.collect()
        torch.cuda.empty_cache()

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

    # 3. Decode-attention kernel vs plain version.
    results["checks"] = [check_case(c, 0, dev) for c in CASES + EDGE_CASES]
    results["checks"] += [check_case(c, 0, dev, off)
                          for c, off in SCALAR_LOAD_CASES]
    results["checks"] += [check_case(FULL_CASE, s, dev) for s in range(3)]
    full_err = max(c["max_abs_err"] for c in results["checks"]
                   if c["case"] == FULL_CASE[0])

    # 4. Timing at the full decode shape.
    args, lens = make_inputs(FULL_CASE, 0, dev)
    a_kernel, a_plain = clone(args), clone(args)
    kernel_ms = time_ms(lambda: DA.fused_decode_attention(*a_kernel), dev)
    plain_ms = time_ms(lambda: DA.decode_attention_plain(*a_plain), dev)
    split = time_split(lambda: DA.fused_decode_attention(*a_kernel), dev)
    bound_ms, bound_by, nbytes, ops = bound(FULL_CASE, args)
    nsplit, chunk = DA.split_plan(
        FULL_CASE[2], FULL_CASE[5], FULL_CASE[3],
        torch.cuda.get_device_properties(dev).multi_processor_count)
    results["timing"] = {"shape": "B=4 S=160 H=32 K=2 D=128 W=32 bf16",
                         "lens": lens, "kernel_ms": kernel_ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "bytes": nbytes, "ops": ops,
                         "nsplit": nsplit, "chunk": chunk, **split,
                         "l2": "flushed before each launch"}
    log(f"[time] fused_decode_attention at {results['timing']['shape']}, "
        f"lens {lens}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B / 3.35 TB/s, "
        f"{ops} ops)")
    log(f"[time] NSPLIT {nsplit} (chunks of {chunk} slots): scores kernel "
        f"{split['scores_ms']} ms + p@V kernel {split['pv_ms']} ms of device "
        f"time per call (torch.profiler, mean of {split['calls']} calls), "
        f"whole call {kernel_ms:.4f} ms (CUDA events)")
    del args, a_kernel, a_plain

    # 5. daxpy: check, the kernel ops' main path, timing.
    results["daxpy_check"] = check_daxpy(dev)
    results["daxpy_offload"] = phase_daxpy_offload(dev)
    free()
    results["daxpy_timing"] = time_daxpy(dev)
    free()

    # 6. Fused AdamW: check, whole-tree timing at the training shape.
    tcfg = train_cfg(TRAIN_LAYERS)
    results["adamw_checks"] = check_adamw(dev, tcfg)
    free()
    results["adamw_timing"] = time_adamw(dev, tcfg)
    free()

    # 7. Full-width serving: its main path, launches counted from 0.
    results["serve"] = phase_serve(dev)
    free()
    results["profile"] = phase_profile(dev)
    free()

    # 8. Training at full width, depth cut: its main path, launches from 0.
    results["train"] = phase_train(dev)
    free()

    # 9. Fused vs unfused decoding, teacher-forced.
    results["teacher_forced"] = phase_teacher_forced(dev)
    free()

    # 10. Kernel vs plain optimizer.
    results["optimizer_paths"] = phase_optimizer_paths(dev)
    results["total_s"] = time.perf_counter() - t_start

    dx = results["daxpy_timing"][-1]            # n = 2^27, f32
    aw = results["adamw_timing"]
    kernels = {"kernels": [
        {"name": "fused_decode_attention", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": REPLACES,
         "launches": results["serve"]["launches"], "max_abs_err": full_err,
         "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
         "scores_ms": split["scores_ms"], "pv_ms": split["pv_ms"],
         "nsplit": nsplit, "bound_ms": bound_ms, "bound_by": bound_by,
         "library_ms": None},
        {"name": "daxpy", "route": "cuda", "source": DAXPY_SOURCE,
         "replaces": DAXPY_REPLACES,
         "launches": results["daxpy_offload"]["launches"],
         "max_abs_err": results["daxpy_check"]["max_abs_err"],
         "ms": dx["kernel_ms"], "plain_ms": dx["plain_ms"],
         "bound_ms": dx["bound_ms"], "bound_by": dx["bound_by"],
         "library_ms": dx["library_ms"]},
        {"name": "fused_adamw", "route": "cuda", "source": ADAMW_SOURCE,
         "replaces": ADAMW_REPLACES,
         "launches": results["train"]["launches"],
         "max_abs_err": max(c["p_max_abs_err"]
                            for c in results["adamw_checks"]),
         "ms": aw["kernel_ms"], "plain_ms": aw["plain_ms"],
         "bound_ms": aw["bound_ms"], "bound_by": aw["bound_by"],
         "library_ms": aw["library_ms"]}]}
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
