#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases; each raises on failure, and the script then exits non-zero without
printing a result:

  1. card: name and power limit (nvidia-smi), torch version; TF32 off;
  2. build: every CUDA kernel of the port (decode_attention,
     prefill_attention, moe_route, moe_experts, daxpy, fused_adamw), one
     nvcc each, all started together, from the sources
     here; each decode-attention kernel's SASS counted (``cuobjdump``:
     instructions, tensor-core HMMA, cp.async LDGSTS), the tensor-core
     build required to hold HMMA;
  3. check: the decode-attention kernels against their plain PyTorch
     version on the card (the reference's cases, the serving shape, the
     serving shape with the new token on a chunk edge of the split, and the
     streaming shapes of chatglm3-6b, qwen3-moe-30b-a3b and zamba2-1.2b's
     shared attention: S = the streaming trace's max_len, lens 0, S - 1
     and chunk edges, bf16 and int8 caches) — caches bit-exact, attention
     out within tolerance; the streaming shapes and the G = 64 shape again
     on the kernels' CUDA-core build (``cuda_core_build()``), beside the
     tensor-core build bf16 calls take by default; the kernels' slot-shard
     form (a mesh's
     flash-decoding) over P = 1, 2, 4 and 16 blocks of one cache, reduced
     on the card (SHARD_CASES: the streaming shape with the new token on
     a block's first and last slot, bf16, int8 and a ring, and
     decode_32k's per-device shape, 8 x 32768 slots) — caches bit-exact
     against the plain version, out within tolerance, one block bit-equal
     to the whole-cache call; then the serving engine, its steps' graphs
     captured by a warm call, replays a prefill-into-slots step and two
     decode steps under ``torch.cuda.set_sync_debug_mode("error")``
     (reduced chatglm3-6b, qwen3-moe-30b-a3b and zamba2-1.2b) without
     raising, the decode kernel counted once per attention layer per
     replay; and the kernel captured and replayed in a graph at a shape
     whose launch sets its shared-memory attribute (G = 64); then the
     prefill-attention kernel against its plain version at the benchmark
     cells' prefill shapes, at kanana-2-30b-a3b's refills (multi-head
     latent attention's q and k 192 wide, v 128, 32 heads each with its own
     key and value: PREFILL_MLA_SHAPES) and at ragged, windowed, D = 64 and
     D = 256 shapes (within ``prefill_tolerance``), and timed at the cells'
     shapes
     (CUDA events, median, L2 flushed first) beside its bound, its plain
     version and an attend-only yardstick,
     ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``
     (timed only; the port never calls it); then the MoE router's
     expert-slot kernel against its plain version, bit-equal, at
     MOE_ROUTE_CASES (granite-4.0-h-small's 4096 refill and decode call,
     qwen3-moe-30b-a3b's 8 x 512 refill and decode call, capacity factor
     0.25, two routing groups, the tile's edges and a ragged last tile,
     kanana-2-30b-a3b's 4 x 8192 refill and decode call),
     captured in a graph and replayed twice, bit-equal, one launch counted
     per replay, and timed (CUDA events, median, L2 flushed first; and its
     graph's replay) beside its bound and its plain version; the serving
     engine's check above also counts it once per MoE layer per replay;
     then the MoE's expert-FFN kernel against ``expert_ffn_plain`` (the
     dense einsums) at MOE_EXPERTS_SHAPES (qwen3-moe-30b-a3b's,
     granite-4.0-h-small's and kanana-2-30b-a3b's decode calls, the last at
     C = 6) under MOE_EXPERTS_ROUTINGS (the
     cell's, one kept copy, every expert full, one expert holding C copies,
     two groups), within ``experts_tolerance`` with dead experts' rows
     exactly 0; captured, replayed twice bit-equal, then replayed under
     other routings, bit-equal to the eager call under each; and timed
     (CUDA events, median, L2 flushed first) beside its live-bytes bound,
     its plain version and the dense einsums alone; the streaming phases
     count it once per MoE layer per decode replay and never per prefill;
     then kanana-2-30b-a3b at full width and depth through the engine's
     compiled steps (``phase_kanana_launches``: a 4-slot refill of
     KANANA_PROMPT tokens and decode steps), its launches per replay
     counted: ``prefill_attention`` once per layer per refill (48),
     ``decode_attention_latent`` once per layer per decode step (48),
     ``moe_route`` once per MoE layer per call (47) and ``moe_experts``
     47 per decode step and none per refill;
  4. time: kernels and plain version at the chatglm3-6b decode shape and
     at the three streaming shapes (CUDA events, median, L2 flushed before
     each launch), beside the least time the card could take (bytes over
     HBM rate or ops over peak rate); the split's NSPLIT and each of its
     three kernels' device time (torch.profiler); the launch floor (an
     empty kernel on the same grids, as many launches); an attend-only
     yardstick, ``scaled_dot_product_attention(..., enable_gqa=True)``
     over the written cache with the live mask (another function: no rope,
     no write; the port never calls it) at S = 160, 1040 and decode_32k's
     shape; the CUDA-core build at the streaming shape; the slot-shard
     form's passes (scores, stats, p@V) at each P beside the whole-cache
     kernels, and its one-block call and plain version, at the streaming
     shape and at decode_32k's;
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
  7. serve (every engine's steps compiled: a CUDA graph per step and
     shape, captured at its first call, replayed at every later one):
     full-width chatglm3-6b (28 layers, d_model 4096, bf16, random
     seeded weights) through ``repro_torch.launch.serve.serve`` with the
     fused decode step; the kernel must launch 28 * (gen - 1) times and
     every step's credit counter must read its threshold; then a profile
     of a few warm decode steps: host wall per step vs device time by
     kind, the host events and graph launches per step, back-to-back
     replays' device time, capture seconds, the pool and peak memory
     allocated and reserved with the graphs held;
     then the streaming path, ``serve_workload`` -> ``ContinuousBatcher``
     with the CLI's defaults (48 requests at 2e6 req/s, seed 0) on the
     wall-clock fabric with the fused decode step: the kernel must launch
     28 x (decode jobs + one warm-up decode per distinct prompt length),
     the prefill-attention kernel a multiple of 28 times (once per layer
     and prefill; never on a mesh or where the route keeps the plain
     version),
     every credit read must be at its threshold, every admitted request
     completed with in-range tokens; the same with the pipelined loop,
     its replayed decode steps queued and awaited under
     ``set_sync_debug_mode("error")``, its decode wall per step printed
     beside the continuous loop's; a
     profile of warm decode steps at the streaming shape (S = 1040, four
     slot lengths); then the same trace at 4 layers in f32 on the
     simulated fabric, fused, unfused and fused-pipelined under
     ``disable_compile()``, then fused and unfused compiled: equal token
     streams and launches, every graph captured once and every step after
     its first a replay; then the MoE, SSM and hybrid families at full width through
     the same ``serve_workload`` call (qwen3-moe-30b-a3b on the 48
     requests, mamba2-370m and zamba2-1.2b on the first 16; every earlier
     phase's weights freed first, memory printed before and after): every
     request admitted or rejected, every admitted one completed, the
     kernel launched once per attention layer per decode (none for
     mamba2); a profile of one qwen3-moe decode step at S = 1040 beside
     the bound of the weights it reads; fused against unfused, and
     compiled against ``disable_compile()``, on the trace in f32 at full
     width, qwen3-moe at 2 layers, mamba2 at 4 and zamba2's first group
     (6 layers): equal token streams (the pipelined loop's, on the MoE,
     counted where they differ: ROADMAP C12);
  8. train: chatglm3-6b at full width, depth cut to 8 layers, through
     ``repro_torch.launch.train.build``'s compiled step (one CUDA graph
     holding the forward, autograd's backward, the clipping, the fused
     AdamW kernel and the credit counter) and ``train.run`` under the step
     supervisor: 8 steps of 4 x 512 tokens; one graph captured, step 0
     eager and every later step a replay; the kernel must launch 12 * 8
     times, no credit may fall short, every loss must be finite; warm
     replays queued under ``set_sync_debug_mode("error")``, then timed
     unprofiled (host wall, queueing a replay) and the same steps under
     ``disable_compile()`` beside them; one replay profiled by
     kernel kind (device busy, idle share); capture seconds, the pool, peak
     allocated and reserved; the graph dropped, memory printed before and
     after; then at full width in f32, depth cut, compiled against
     ``disable_compile()`` from the same weights and batches, 4 steps:
     chatglm3-6b (2 layers) and mamba2-370m (4) bit-equal in losses, grad
     norms and final params, qwen3-moe-30b-a3b (2) within
     MOE_SPREAD_FACTOR times the spread of two eager runs, printed beside
     it; a supervised 2-layer chatglm3-6b run with a NaN ``embeds`` batch
     at step 2: rolled back into the held leaves, the ``embeds`` key
     captured once, the final params those of the same run under
     ``disable_compile()``; mamba2-370m (the train CLI's default arch) at
     its full published size, 4 steps, compiled;
  9. fused vs unfused decoding, teacher-forced, at full width in f32 with
     the depth cut to 4 layers: logits within 1e-3 and greedy tokens equal
     wherever the unfused top-2 gap exceeds 1e-3;
 10. kernel vs plain optimizer: 3 training steps at full width in f32, depth
     cut to 2 layers, from the same weights and batches, both sides through
     ``train.build``'s compiled step: losses within 1e-5 relative,
     parameters within the tolerance stated at OPT_PARAM_TOL;
 11. the co-design explorer and the fleet (every earlier phase's weights
     freed first, memory printed before and after): ``run_sweep`` over the
     paper's space, serially and on EXPLORER_WORKERS worker processes,
     equal, its front holding the co-design point (multicast dispatch,
     credit sync) with the paper's +47.9 % at (M=32, N=1024); that point
     served by ``serve_workload(design=...)`` on the stream trace,
     chatglm3-6b at full width, fused decode: every request admitted or
     rejected, every admitted one completed with in-range tokens, every
     credit read at its threshold, the kernel launched 28 x the decode
     steps; the same trace at 4 layers in f32, fused and unfused, equal
     token streams; then ``serve_fleet`` on a 32+8+8 fleet at full width,
     one bf16 weight tree shared by the three lanes' engines (unfused, as
     the reference's fleet decodes): the stream trace, the CI chaos step's
     traffic with lane 1 crashed, and its 96 requests with a crash that
     finds a request mid-decode (restored from lane 1's checkpoint) — the
     routes, per-lane counts and fleet summary equal those of the same
     call with a narrow model of the same vocabulary, every request not
     dropped completed, no decode-kernel launch; at 4 layers in f32, how
     many of the chaos runs' token streams equal the fault-free run's (a
     finding, not a gate);
 12. the multi-device and analysis layers: the planner's host overheads
     (an empty step's queue-plus-credit time, a sequential put's extra
     leaf) and one 4 x 1024 prefill job timed; then an NCCL process group
     of one rank, and chatglm3-6b at full width served through a 1x1
     ``DeviceMesh`` (``serve_workload`` given ``make_host_mesh(1, 1)``, on
     the stream trace's first 16 requests: DTensor params and caches, the
     decode kernels' slot-shard form on each device's block of the cache):
     counts, slot-shard launches (28 per decode step), credits, its decode
     step profiled beside phase 7's;
     the trace at 4 layers f32 through the mesh, compiled and under
     ``disable_compile()``, token for token the plain path's; chatglm3-6b's
     train step (2 layers, f32) through the mesh, compiled and under
     ``disable_compile()``, bit-equal, its losses those of phase 8's plain
     compiled run; ``H100_SXM``'s predicted decode and prefill times beside the
     measured ones; and the dry runs, started as CPU processes after the build
     (chatglm3-6b and qwen3-moe-235b-a22b x decode_32k on 16x16,
     qwen3-moe-235b-a22b x train_4k on 2x16x16, and phase 7's streaming
     decode step on a 1x1 mesh, held against the mesh serve's measured
     peak memory): per-device peak against 80 GiB, FLOPs against
     ``cell_cost``, the collective census; chatglm3-6b x decode_32k
     gathers no cache (no all-gather as large as one layer's local k
     cache) and its FLOPs are ``cell_cost``'s within 20 %;
 13. a ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

It needs one card.  Without one (``torch.cuda.is_available()`` false), or
without the ``src/repro_torch`` package beside it, it exits non-zero at
once.  Full results also go to ``results/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
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
PREFILL_SOURCE = "src/repro_torch/kernels/csrc/prefill_attention.cu"
MOE_ROUTE_SOURCE = "src/repro_torch/kernels/csrc/moe_route.cu"
MOE_EXPERTS_SOURCE = "src/repro_torch/kernels/csrc/moe_experts.cu"
MOE_EXPERTS_REPLACES = ("none: the reference's expert FFN is plain jnp "
                        "(src/repro/models/layers.py:496-497, moe_block's "
                        "jnp.einsums)")
MOE_ROUTE_REPLACES = ("none: the reference ranks the copies with plain jnp "
                      "(src/repro/models/layers.py, route_group's "
                      "jnp.cumsum)")
PREFILL_REPLACES = ("none: the reference's prefill attention is plain jnp "
                    "(src/repro/models/layers.py, chunked_attention)")
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
# of the kernels' split (3 chunks of 64 slots at B=4, K=2, S=160; the
# first four cases put it at the 10-slot chunks of an earlier split), in
# each cache dtype.
EDGE_CASES = [
    ("decode-chunk-edges", "chatglm3-6b", 4, 160, 32, 2, 128, "bf16",
     [130, 139, 0, 159], False, False, 0),
    ("decode-chunk-edges-2", "chatglm3-6b", 4, 160, 32, 2, 128, "bf16",
     [9, 10, 149, 150], False, False, 0),
    ("decode-chunk-edges-q8", "chatglm3-6b", 4, 160, 32, 2, 128, "bf16",
     [19, 20, 79, 80], True, False, 0),
    ("decode-chunk-edges-f32", "chatglm3-6b", 4, 160, 32, 2, 128, "f32",
     [10, 99, 100, 155], False, False, 0),
    ("decode-tile-edges", "chatglm3-6b", 4, 160, 32, 2, 128, "bf16",
     [63, 64, 127, 128], False, False, 0),
    ("decode-tile-edges-q8", "chatglm3-6b", 4, 160, 32, 2, 128, "bf16",
     [0, 63, 64, 159], True, False, 0),
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
# A decode shape whose kernels need more than 48 KiB of shared memory (at
# G = 64, D = 128, bf16: ``DA.smem_bytes``), so their launches call
# cudaFuncSetAttribute: held under graph capture.
BIG_SMEM_CASE = ("decode-g64-captured", "chatglm3-6b", 2, 160, 64, 1, 128,
                 "bf16", [5, 150], False, False, 0)
# The decode kernels' slot-shard form (a mesh's flash-decoding: a device
# holds a block of the slots; the softmax's max and sum and the partial
# p@V are all-reduced over the model axis) at full width, over each P of
# SHARD_COUNTS blocks of one card's cache, reduced on the card: chatglm3-
# 6b's streaming shape (S = 1040: blocks of 65 slots at P = 16, the new
# token on a block's first and last slot) in bf16 and int8 and as a ring,
# and decode_32k's per-device shape on the 16x16 mesh (8 rows of 32768
# slots, 2048 a block at P = 16: 268 MB of bf16 cache).
SHARD_COUNTS = (1, 2, 4, 16)
SHARD_CASES = [
    ("shard-stream", "chatglm3-6b", 4, 1040, 32, 2, 128, "bf16",
     [65, 129, 520, 1039], False, False, 0),
    ("shard-stream-q8", "chatglm3-6b", 4, 1040, 32, 2, 128, "bf16",
     [64, 259, 780, 0], True, False, 0),
    ("shard-stream-ring", "chatglm3-6b", 4, 1040, 32, 2, 128, "bf16",
     [1104, 2079, 3120, 5], False, True, 1040),
    ("shard-decode-32k", "chatglm3-6b", 8, 32768, 32, 2, 128, "bf16",
     [2047, 2048, 32767, 20000, 4095, 4096, 16384, 100], False, False, 0),
]
# The streaming path: the CLI's default trace (``python -m
# repro_torch.launch.serve``), and the depth of its fused-vs-unfused check.
STREAM_REQUESTS, STREAM_RATE, STREAM_SEED = 48, 2e6, 0
STREAM_CHECK_LAYERS = 4
# The MoE, SSM and hybrid families at full width on the streaming path:
# qwen3-moe-30b-a3b on the CLI's trace, mamba2-370m and zamba2-1.2b on its
# first FAMILY_REQUESTS requests; their fused-vs-unfused checks in f32 at
# the depths below (qwen3-moe: 2 layers; zamba2: its first group).
MOE_ARCH, SSM_ARCH, HYBRID_ARCH = ("qwen3-moe-30b-a3b", "mamba2-370m",
                                   "zamba2-1.2b")
FAMILY_REQUESTS = 16
FAMILY_CHECK_LAYERS = {MOE_ARCH: 2, SSM_ARCH: 4, HYBRID_ARCH: 6}
# The fleet and the co-design explorer: the explorer's paper space swept
# serially and over EXPLORER_WORKERS processes; the co-design point's
# headline gain at (M=32, N=1024) over the paper baseline (Fig. 1 right,
# as tests/test_dse.py asserts it); a big + two little fabrics; the CI
# chaos-smoke step's traffic (.github/workflows/ci.yml) with its crash on
# the stream trace's request count, and on the step's own 96 requests with
# a crash that finds a request mid-decode at lane 1's last checkpoint (at
# 0.45 none is, so nothing is restored there); FLEET_CHECK_LAYERS is the
# depth of the token-stream checks in f32.
EXPLORER_WORKERS = 4
CODESIGN_GAIN, CODESIGN_CELL, CODESIGN_TOL = 1.479, (32, 1024), 5e-3
FLEET_SIZES = (32, 8, 8)
CHAOS_TRAFFIC = dict(rate_rps=1.5e6, slo_fraction=0.5, seed=11)
CHAOS_FAULTS = "crash@1:0.45"
RESTORE_REQUESTS, RESTORE_FAULTS = 96, "crash@1:0.6"
FLEET_CHECK_LAYERS = 4
# The multi-device and analysis layers (phase 12): the stream trace's first
# MESH_REQUESTS requests served through a 1x1 DeviceMesh; the empty step
# timed LAUNCH_REPS times for the planner's host overheads; the dry-run
# cells (arch, shape, multi-pod), each a CPU process started after the
# build and waited for at most DRYRUN_TIMEOUT_S in phase 12.
MESH_REQUESTS = 16
LAUNCH_REPS = 200
DRYRUN_CELLS = [("chatglm3-6b", "decode_32k", False),
                ("qwen3-moe-235b-a22b", "decode_32k", False),
                ("qwen3-moe-235b-a22b", "train_4k", True)]
DRYRUN_TIMEOUT_S = 600
# The archs whose engine steps are queued under the sync debug mode.
NO_SYNC_ARCHS = (ARCH, MOE_ARCH, HYBRID_ARCH)
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
# The compiled train step (phase 8): warm replays queued under the sync
# debug mode, then timed unprofiled; its runs in f32 at cut depth against
# disable_compile() (layers per arch), TRAIN_CHECK_STEPS steps each from
# the same weights and batches; the MoE's differences may reach
# MOE_SPREAD_FACTOR times those between two eager runs (its sums may meet
# in another order on the card: the spread is measured in the same call);
# a supervised run with a NaN embeds batch at ROLLBACK_NAN_AT; mamba2-370m
# (the train CLI's default arch) at its full published size.
TRAIN_SYNC_STEPS, TRAIN_TIMED_STEPS = 2, 4
TRAIN_CHECKS = {ARCH: 2, SSM_ARCH: 4, MOE_ARCH: 2}
TRAIN_CHECK_STEPS = 4
MOE_SPREAD_FACTOR = 4.0
ROLLBACK_NAN_AT = 2
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
# The benchmark cells' prefill shapes, (cell, B, L, H, K, D), bf16: each
# cell's slot prefill computes every slot's row at the prompt's length.
PREFILL_SHAPES = (
    [("glm3-6b.prefill-heavy", 4, n, 32, 2, 128) for n in (512, 1024, 1536,
                                                           2048)]
    + [("qwen3-moe-30b.decode-heavy", 8, n, 32, 4, 128) for n in (128, 256,
                                                                  512)]
    + [("glm3-6b.decode-heavy", 8, n, 32, 2, 128) for n in (64, 128, 192,
                                                            256)])
# kanana-2-30b-a3b's refills, (cell, B, L, H, K, D, Dv): multi-head latent
# attention decompressed, q and k 128 + 64 wide, v 128, every head its own
# key and value.
PREFILL_MLA_SHAPES = [("kanana-2-30b.long-docs", 4, n, 32, 32, 192, 128)
                      for n in (2048, 4096, 6144, 8192)]
# Shapes the kernel is held against the plain version at, beyond those:
# short and ragged prompts, a sliding window, head dims 64 and 256.
PREFILL_EDGE_SHAPES = [("ragged", 4, 17, 32, 2, 128, 0),
                       ("ragged", 4, 100, 32, 4, 128, 0),
                       ("window", 4, 2048, 32, 4, 128, 1024),
                       ("window", 2, 700, 16, 2, 128, 100),
                       ("d64", 3, 333, 8, 1, 64, 0),
                       ("d256-window", 1, 200, 8, 2, 256, 50)]
# The MoE router's expert slots: (tag, groups, tokens per group, experts per
# token, experts, capacity factor); cap = max(ceil(tokens * k / E * cf), k)
# (``models.layers.moe_capacity``).  The cells' refills and decode calls
# (granite: 4 slots x 4096, qwen3-moe: 8 x 512), drops, two routing groups,
# and the kernel's tiles of 2048 copies: one less, one, one more, ragged.
MOE_ROUTE_CASES = [
    ("granite-refill-4096", 1, 4 * 4096, 10, 72, 1.25),
    ("qwen3-moe-refill-8x512", 1, 8 * 512, 8, 128, 1.25),
    ("granite-decode", 1, 4, 10, 72, 1.25),
    ("qwen3-moe-decode", 1, 8, 8, 128, 1.25),
    ("overflow-cf0.25", 1, 8 * 512, 8, 128, 0.25),
    ("two-groups", 2, 4 * 512, 8, 128, 1.25),
    ("tile-less-one", 1, 2047, 1, 72, 1.25),
    ("one-tile", 1, 2048, 1, 72, 1.25),
    ("tile-plus-one", 1, 2049, 1, 72, 1.25),
    ("ragged-last-tile", 1, 1000, 8, 128, 1.25),
    ("kanana-refill-4x8192", 1, 4 * 8192, 6, 128, 1.25),
    ("kanana-decode", 1, 4, 6, 128, 1.25),
]
MOE_ROUTE_TIMED = MOE_ROUTE_CASES[:4]
# The MoE's expert FFN at the cells' decode calls: (G, E, C, D, F, tokens,
# experts per token).  qwen3-moe-30b-a3b: 8 slots x top-8 of 128 experts,
# C = max(ceil(8 * 8 / 128 * 1.25), 8) = 8; granite-4.0-h-small: 4 slots x
# top-10 of 72, C = 10.  Routings: the cell's (the router's slots of
# random logits), one kept copy, every expert full, one expert holding C
# copies with more dropped, and two routing groups of the cell's.
# kanana-2-30b-a3b: 4 slots x top-6 of 128, C = max(ceil(4 * 6 / 128 *
# 1.25), 6) = 6.
MOE_EXPERTS_SHAPES = {"qwen3-moe-decode": (1, 128, 8, 2048, 768, 8, 8),
                      "granite-decode": (1, 72, 10, 4096, 768, 4, 10),
                      "kanana-decode": (1, 128, 6, 2048, 768, 4, 6)}
# The full-width kanana-2-30b-a3b engine's refill length (4 slots).
KANANA_ARCH = "kanana-2-30b-a3b"
KANANA_PROMPT = 1024
MOE_EXPERTS_ROUTINGS = ("cell", "one-copy", "all-live", "one-full",
                        "two-groups")


def log(msg: str) -> None:
    print(msg, flush=True)


def sass_report(name: str = "decode_attention") -> dict:
    """Each kernel of a built library by ``cuobjdump -sass``: its SASS
    instructions, tensor-core instructions (HMMA) and asynchronous copies
    (LDGSTS), under a short name (pass<activation,cache,tensor
    cores,16-byte loads[,shard]>)."""
    import re

    from repro_torch.kernels import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    words = {"13__nv_bfloat16": "bf16", "f": "f32", "a": "int8",
             "Lb1E": "1", "Lb0E": "0"}
    res, key = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : \S*?\d(decode_attention_(?:scores|pv|stats|"
                      r"empty))(I(\S+?)EEv)?", line)
        if m:
            args = re.findall(r"13__nv_bfloat16|S1_|Lb[01]E|[fa](?=[aLfS]|$)",
                              m.group(3) or "")
            args = [words.get(a, args[0] if a == "S1_" else a) for a in args]
            args = ["bf16" if a == "13__nv_bfloat16" else a for a in args]
            key = m.group(1) + (f"<{','.join(args)}>" if args else "")
            res[key] = {"instructions": 0, "hmma": 0, "ldgsts": 0}
        elif key and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            res[key]["instructions"] += 1
            res[key]["hmma"] += "HMMA" in line
            res[key]["ldgsts"] += "LDGSTS" in line
    return res


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
    # f32: the kernel and cuBLAS sum p@V in different orders, so the
    # absolute slack scales with the largest value summed (dequantised int8
    # values reach +-12.7, random f32 ones ~4).
    tol = _out_tolerance(dt, args, quant)
    torch.testing.assert_close(got[0], want[0], **tol,
                               msg=lambda m: f"{name}: out: {m}")
    res = {"case": name, "dtype": dt, "quant": quant, "lens": lens,
           "max_abs_err": float(diff.max()), "max_rel_err": rel,
           "tolerance": tol}
    log(f"[check] {name}: caches bit-exact, out max|err| "
        f"{res['max_abs_err']:.3e} (max rel {rel:.3e}; rtol "
        f"{tol['rtol']}, atol {tol['atol']:.3g})")
    return res


def _out_tolerance(dt, args, quant) -> dict:
    tol = dict(TOL[dt])
    if dt == "f32":
        v = args[4].float() * args[9] if quant else args[4].float()
        tol["atol"] *= max(1.0, float(v.abs().max()))
    return tol


def check_shard_case(case, shards, dev) -> dict:
    """The slot-shard form over ``shards`` blocks of one cache (views of
    it, reduced on the card), kernels against the plain version: caches
    bit-exact, out within TOL; one block is the whole-cache kernel call,
    out and caches bit for bit."""
    import torch
    from repro_torch.kernels import decode_attention as DA

    name, *_, dt, _, quant, is_ring, window = case
    args, lens = make_inputs(case, 0, dev)
    kw = dict(window=0 if is_ring else window, is_ring=is_ring)
    got = DA.decode_attention_over_shards(*clone(args), shards=shards, **kw)
    want = DA.decode_attention_over_shards(*clone(args), shards=shards,
                                           plain=True, **kw)
    whole = (DA.fused_decode_attention(*clone(args), **kw) if shards == 1
             else None)
    torch.cuda.synchronize()
    names = ("k_cache", "v_cache", "k_scale", "v_scale")
    for nm, g, w in zip(names, got[1:], want[1:]):
        if not torch.equal(g, w):
            raise AssertionError(f"{name} P={shards}: {nm} differs from the "
                                 f"plain version in {int((g != w).sum())} "
                                 "elements")
    tol = _out_tolerance(dt, args, quant)
    torch.testing.assert_close(got[0], want[0], **tol, msg=lambda m: (
        f"{name} P={shards}: out: {m}"))
    if whole is not None and not all(
            torch.equal(g, w) for g, w in zip(got, whole)):
        raise AssertionError(f"{name}: one block is not the whole-cache "
                             "call bit for bit")
    err = float((got[0].float() - want[0].float()).abs().max())
    log(f"[shard] {name} P={shards} (blocks of {-(-case[3] // shards)} "
        f"slots): caches bit-exact, out max|err| {err:.3e} against the "
        f"plain version" + ("; bit-equal to the whole-cache kernel"
                            if whole is not None else ""))
    return {"case": name, "shards": shards, "lens": lens,
            "max_abs_err": err, "whole_bit_equal": whole is not None}


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


def time_split(fn, dev, calls=100, parts=("scores", "stats", "pv")) -> dict:
    """Device ms per call of each of the decode step's kernels
    (``decode_attention_<part>``; mean of ``calls`` profiled calls, L2
    flushed before each), by kernel name."""
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
    us = {part: 0.0 for part in parts}
    counts = {part: 0 for part in parts}
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


def time_floor(case, dev, launches: int | None = None) -> float:
    """Median ms of ``launches`` launches of an empty kernel on ``case``'s
    grid (B, K, NSPLIT) of 256 threads (CUDA events, as ``time_ms``): the
    floor under the whole call's launches (by default as many as it makes:
    two where its statistics fold into p@V, else three)."""
    import ctypes

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as DA

    _, _, b, s, h, kh, *_ = case
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nsplit, _ = DA.split_plan(b, kh, s, sms)
    if launches is None:
        launches = 2 if DA.fold_stats(h // kh, s, nsplit) else 3
    argtypes = (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
    return time_ms(lambda: _build.launch(
        "decode_attention", "decode_attention_empty_grid", argtypes, dev, b,
        kh, nsplit, launches, count=None), dev)


def time_attend_only(case, dev) -> float:
    """An attend-only yardstick: one ``scaled_dot_product_attention(...,
    enable_gqa=True)`` call over ``case``'s caches after the kernels wrote
    the new token, with the live mask, timed as the kernels are.  Another
    function (no rope, no quantise, no write; the port never calls it),
    so it is no ``library_ms``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA

    _, _, b, s, *_ = case
    args, _ = make_inputs(case, 0, dev)
    DA.fused_decode_attention(*args)
    q = args[0].transpose(1, 2).contiguous()                  # (B, H, 1, D)
    k, v = (t.transpose(1, 2).contiguous() for t in args[3:5])  # (B, K, S, D)
    mask = DA.live_slots(args[5].long() + 1, s)[:, None, None, :]
    return time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True), dev)


def time_case(case, dev) -> dict:
    """Kernel and plain version at one case's shape (lens as the case
    gives them), beside the bound, and the split the kernel takes."""
    import torch
    from repro_torch.kernels import decode_attention as DA

    _, _, b, s, h, kh, d, dt, *_ = case
    args, lens = make_inputs(case, 0, dev)
    a_kernel, a_plain = clone(args), clone(args)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nsplit, chunk = DA.split_plan(b, kh, s, sms)
    bound_ms, bound_by, nbytes, ops = bound(case, args)
    res = {"case": case[0],
           "shape": f"B={b} S={s} H={h} K={kh} D={d} "
                    f"W={args[6].shape[-1]} {dt}",
           "lens": lens, "nsplit": nsplit, "chunk": chunk,
           "kernel_ms": time_ms(
               lambda: DA.fused_decode_attention(*a_kernel), dev),
           "plain_ms": time_ms(
               lambda: DA.decode_attention_plain(*a_plain), dev),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "ops": ops, **time_split(
               lambda: DA.fused_decode_attention(*a_kernel), dev),
           "floor_ms": time_floor(case, dev),
           "tensor_cores": DA.tensor_cores(args[0].dtype, d)}
    if res["tensor_cores"]:
        with DA.cuda_core_build():
            res["cuda_core_ms"] = time_ms(
                lambda: DA.fused_decode_attention(*a_kernel), dev)
    return res


def time_shards(case, dev) -> dict:
    """The slot-shard form at one case's shape: for each P of SHARD_COUNTS
    blocks, each pass's device ms per call (scores, stats, p@V, summed
    over the blocks; torch.profiler) and the whole call's ms with its
    reductions on the card (CUDA events), beside the whole-cache kernels';
    then the one-block call (the 1x1 mesh's, ``decode_attention_shard``)
    and its plain version, with the bound of the work."""
    import functools
    from repro_torch.kernels import decode_attention as DA

    _, _, b, s, h, kh, d, dt, _, _, is_ring, window = case
    args, lens = make_inputs(case, 0, dev)
    kw = dict(window=0 if is_ring else window, is_ring=is_ring)
    call = functools.partial(DA.fused_decode_attention, *clone(args), **kw)
    whole = time_split(call, dev)
    whole["ms"] = time_ms(call, dev)
    bound_ms, bound_by, nbytes, ops = bound(case, args)
    res = {"case": case[0], "shape": f"B={b} S={s} H={h} K={kh} D={d} {dt}",
           "lens": lens, "whole": whole, "shards": {}, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes, "ops": ops,
           "floor_ms": time_floor(case, dev),
           "one_block_floor_ms": time_floor(case, dev, launches=4),
           "attend_only_sdpa_ms": time_attend_only(case, dev)}
    for shards in SHARD_COUNTS:
        fn = functools.partial(DA.decode_attention_over_shards, *clone(args),
                               shards=shards, **kw)
        passes = time_split(fn, dev, parts=("scores", "stats", "pv"))
        passes["ms"] = time_ms(fn, dev, reps=50)
        res["shards"][shards] = passes
        log(f"[time] {case[0]} ({res['shape']}) over P={shards} blocks: "
            f"scores {passes['scores_ms']} + stats {passes['stats_ms']} + "
            f"p@V {passes['pv_ms']} ms of device time per call (all "
            f"blocks), whole call with its reductions {passes['ms']:.4f} ms;"
            f" the whole-cache kernels: scores {whole['scores_ms']} + stats "
            f"{whole['stats_ms']} + p@V {whole['pv_ms']} ms, call "
            f"{whole['ms']:.4f} ms; bound {bound_ms:.6f} ms ({bound_by})")
    res["one_block_ms"] = time_ms(functools.partial(
        DA.decode_attention_shard, *clone(args), **kw), dev)
    res["one_block_plain_ms"] = time_ms(functools.partial(
        DA.decode_attention_shard_plain, *clone(args), **kw), dev)
    log(f"[time] {case[0]}: one-block call (the 1x1 mesh's) "
        f"{res['one_block_ms']:.4f} ms, its plain version "
        f"{res['one_block_plain_ms']:.4f} ms; launch floor (empty kernel on "
        f"the grid) {res['floor_ms']:.4f} ms for the whole call's launches, "
        f"{res['one_block_floor_ms']:.4f} for 4; attend-only SDPA "
        f"yardstick (another function) {res['attend_only_sdpa_ms']:.4f} ms")
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


def prefill_inputs(b, length, h, kh, d, dev, seed=0, dv=None):
    """bf16 q (B, L, H, D), k (B, L, K, D) and v (B, L, K, Dv) (Dv = D
    where None), drawn on the CPU; q scaled by 2 so the softmax is peaked
    as well as flat."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, length, h, d, generator=gen) * 2.0
    k = torch.randn(b, length, kh, d, generator=gen)
    v = torch.randn(b, length, kh, dv or d, generator=gen)
    return tuple(t.to(torch.bfloat16).to(dev) for t in (q, k, v))


def prefill_tolerance(q, k, v, want, window: int = 0):
    """How far the prefill-attention kernel may lie from its plain version,
    per element.  Both round p to bf16 before p@V, but under running maxima
    of other tile widths (64 keys against 1024), so a p may round to the
    other side: bf16 keeps 8 significant bits, so the two roundings lie
    within 2 * 2^-8 of p, and the outputs within 2^-7 of sum(p |v|) /
    sum(p), which is the plain version over |v|.  Each output then rounds
    once to bf16, 2^-8 of |out| each, 2^-7 apart.  The f32 sums in another
    order add ~1e-6 relative, far below either."""
    from repro_torch.kernels import prefill_attention as PA
    mag = PA.prefill_attention_plain(q, k, v.abs(), window=window).float()
    return 2.0 ** -7 * (mag + want.float().abs()) + 1e-6


def check_prefill(shape, dev, seed=0) -> dict:
    """The prefill-attention kernel against its plain version at ``shape``
    ((tag, B, L, H, K, D[, window[, Dv]])): within ``prefill_tolerance``."""
    import torch
    from repro_torch.kernels import prefill_attention as PA
    tag, b, length, h, kh, d, *rest = shape
    window = rest[0] if rest else 0
    dv = rest[1] if len(rest) > 1 else d
    q, k, v = prefill_inputs(b, length, h, kh, d, dev, seed, dv)
    got = PA.prefill_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    want = PA.prefill_attention_plain(q, k, v, window=window)
    err = (got.float() - want.float()).abs()
    tol = prefill_tolerance(q, k, v, want, window)
    res = {"shape": f"{tag} B={b} L={length} H={h} K={kh} D={d} "
                    + (f"Dv={dv} " if dv != d else "") + f"window={window}",
           "max_abs_err": err.max().item(),
           "share_of_tolerance": (err / tol).max().item()}
    if not bool((err <= tol).all()):
        raise AssertionError(f"prefill_attention off its plain version: {res}")
    return res


def prefill_bound(b, length, h, kh, d, dv=None
                  ) -> tuple[float, str, int, int]:
    """Least time of one prefill attention (one layer): the causal q.K^T
    and p@V, 2*B*H*(D + Dv)*L*(L+1)/2 operations, over the bf16 peak, or
    q, k, v read and the output written once over the HBM rate, whichever
    is longer (the families' ``prefill_attention_bytes_ops``)."""
    dv = dv or d
    ops = 2 * b * h * (d + dv) * length * (length + 1) // 2
    nbytes = b * length * (h * (d + dv) + kh * (d + dv)) * 2
    t_ops, t_bytes = ops / PEAK_OPS_PER_S["bf16"], nbytes / HBM_BYTES_PER_S
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, nbytes, ops


def time_prefill_attention(shape, dev) -> dict:
    """The prefill-attention kernel at ``shape`` ((cell, B, L, H, K, D[,
    Dv])), CUDA events, median, L2 flushed before each launch, beside its
    bound, its plain version and an attend-only yardstick,
    ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``
    (timed only; the port never calls it)."""
    import torch.nn.functional as F
    from repro_torch.kernels import prefill_attention as PA
    cell, b, length, h, kh, d, *rest = shape
    dv = rest[0] if rest else d
    q, k, v = prefill_inputs(b, length, h, kh, d, dev, dv=dv)
    kernel_ms = time_ms(lambda: PA.prefill_attention(q, k, v), dev, reps=50,
                        warmup=5)
    plain_ms = time_ms(lambda: PA.prefill_attention_plain(q, k, v), dev,
                       reps=5, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), dev, reps=50, warmup=5)
    bound_ms, by, nbytes, ops = prefill_bound(b, length, h, kh, d, dv)
    return {"cell": cell,
            "shape": f"B={b} L={length} H={h} K={kh} D={d}"
                     + (f" Dv={dv}" if dv != d else ""),
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "attend_only_sdpa_ms": sdpa_ms, "bound_ms": bound_ms,
            "bound_by": by, "bytes": nbytes, "ops": ops,
            "roofline_pct": 100.0 * bound_ms / kernel_ms,
            "l2": "flushed before each launch"}


def phase_prefill_attention(dev) -> dict:
    """The prefill-attention kernel against its plain version at the cells'
    prefill shapes and the edge shapes, then timed at the cells' shapes."""
    checks = [check_prefill(s, dev) for s in PREFILL_SHAPES
              + PREFILL_EDGE_SHAPES]
    checks += [check_prefill((*s[:6], 0, s[6]), dev)
               for s in PREFILL_MLA_SHAPES]
    for c in checks:
        log(f"[check] prefill_attention {c['shape']}: largest error "
            f"{c['max_abs_err']:.3g}, {c['share_of_tolerance']:.3f} of the "
            "tolerance")
    timing = [time_prefill_attention(s, dev) for s in PREFILL_SHAPES
              + PREFILL_MLA_SHAPES]
    card = card_line()
    for t in timing:
        log(f"[time] {card}: prefill_attention at {t['shape']} "
            f"({t['cell']}): kernel {t['kernel_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}; "
            f"{t['roofline_pct']:.1f} % of it), plain {t['plain_ms']:.3f} ms, "
            f"attend-only SDPA yardstick {t['attend_only_sdpa_ms']:.4f} ms")
    return {"checks": checks, "timing": timing}


def moe_layers(cfg) -> int:
    """MoE FFNs in a stack: the router kernel's calls per step."""
    from repro_torch.models.config import MOE_KINDS
    return (sum(k in MOE_KINDS for k in cfg.pattern) * cfg.full_groups
            + sum(k in MOE_KINDS for k in cfg.tail))


def expert_kernel_runs(cfg, mesh=None) -> bool:
    """Whether ``cfg``'s decode steps run the expert-FFN kernel: an MoE on
    one device, bf16, SiLU, widths of 64 (``moe_experts.takes``; a decode
    step of a few slots has capacity <= 16, a prefill of 256 tokens or more
    has more)."""
    return (mesh is None and moe_layers(cfg) > 0 and cfg.dtype == "bfloat16"
            and cfg.act == "silu" and cfg.d_model % 64 == 0
            and cfg.d_ff % 64 == 0)


def check_expert_launches(report: dict, per_decode: int, tag: str) -> None:
    """A compiled run's expert-FFN launches per replay: ``per_decode`` in
    the decode step's graph, none in any prefill's."""
    off = {step: n.get("moe_experts", 0)
           for step, n in report["launches_per_replay"].items()
           if n.get("moe_experts", 0) != (per_decode if step == "decode"
                                          else 0)}
    if off:
        raise AssertionError(f"{tag}: moe_experts launches per replay {off},"
                             f" expected {per_decode} per decode step and "
                             "none per prefill")


def route_inputs(case, dev, seed=0):
    """The experts ids (G, tokens * k) of ``case`` as the router picks
    them (each token's k largest of E normal logits, each expert's logits
    shifted by a bias of its own so that some are more popular; a
    stable descending sort), drawn on the CPU; E; and the case's cap."""
    import math

    import torch
    _, g, tokens, k, e, cf = case
    gen = torch.Generator().manual_seed(seed)
    logits = (torch.randn(g, tokens, e, generator=gen)
              + 0.3 * torch.randn(e, generator=gen))
    ids = torch.sort(logits, dim=-1, descending=True,
                     stable=True).indices[..., :k]
    cap = max(math.ceil(tokens * k / e * cf), k)
    return ids.reshape(g, tokens * k).to(dev), e, cap


def _slots_equal(tag: str, got, want) -> None:
    import torch
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        bad = (got[0] != want[0]) | (got[1] != want[1])
        raise AssertionError(
            f"moe_route {tag}: {int(bad.sum())} of {bad.numel()} copies "
            f"differ from the plain version, the first at "
            f"{bad.nonzero()[0].tolist()}")


def counted_once(key: str, tag: str, fn):
    """``fn()``, synced; raises unless it counted one launch under
    ``LAUNCHES[key]``."""
    import torch
    from repro_torch.kernels._build import LAUNCHES
    before = LAUNCHES[key]
    out = fn()
    torch.cuda.synchronize()
    if LAUNCHES[key] - before != 1:
        raise AssertionError(f"{tag}: {LAUNCHES[key] - before} {key} "
                             "launches counted for one call")
    return out


def check_moe_route(case, dev) -> dict:
    """The router's expert-slot kernel against its plain version at
    ``case``: dst and keep bit-equal, one launch counted."""
    from repro_torch.kernels import moe_route as MR
    ids, e, cap = route_inputs(case, dev)
    got = counted_once("moe_route", f"moe_route {case[0]}",
                       lambda: MR.expert_slots(ids, e, cap))
    _slots_equal(case[0], got, MR.expert_slots_plain(ids, e, cap))
    return {"case": case[0], "groups": ids.shape[0], "copies": ids.shape[1],
            "experts": e, "cap": cap, "dropped": int((~got[1]).sum())}


def check_captured(dev, name: str, fn, args: tuple, key: str, compare,
                   static_argnums=()) -> tuple[list, dict]:
    """A ``CompiledStep`` of ``fn`` called three times on ``args``: eager
    and captured, then two replays.  Each call must count one launch under
    ``LAUNCHES[key]``, pass ``compare(out)`` (which raises) and give the
    first call's out bit for bit, and the stats must say captured, three
    calls and ``{key: 1}`` per replay.  Returns the outs and the stats."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.launch.compile import CompiledStep
    step = CompiledStep(fn, device=dev, static_argnums=static_argnums,
                        name=name)
    outs = []
    for _ in range(3):
        outs.append(counted_once(key, name, lambda: step(*args)))
        compare(outs[-1])
        if not all(map(torch.equal, pytree.tree_leaves(outs[-1]),
                       pytree.tree_leaves(outs[0]))):
            raise AssertionError(f"{name}: a replay's out differs from the "
                                 "first call's")
    [st] = step.stats()
    if (not st["captured"] or st["calls"] != 3
            or st["launches_per_replay"] != {key: 1}):
        raise AssertionError(f"{name}: {st}")
    return outs, st


def check_moe_route_captured(dev, case) -> dict:
    """The router kernel inside a captured graph (``check_captured``):
    every call's dst and keep bit-equal to the plain version's."""
    from repro_torch.kernels import moe_route as MR
    ids, e, cap = route_inputs(case, dev, seed=1)
    want = MR.expert_slots_plain(ids, e, cap)
    _, st = check_captured(
        dev, f"moe_route-{case[0]}", lambda ids: MR.expert_slots(ids, e, cap),
        (ids,), "moe_route", lambda got: _slots_equal(
            f"{case[0]} (compiled)", got, want))
    log(f"[capture] moe_route {case[0]} ({ids.shape[1]} copies): captured "
        f"in {st['capture_s']:.3f} s and replayed twice, dst and keep "
        "bit-equal to the plain version, one launch per replay")
    return {"case": case[0], "capture_s": st["capture_s"]}


def time_moe_route(case, dev) -> dict:
    """The router kernel at ``case``: one call (CUDA events, median, L2
    flushed first) and one replay of a graph holding the call, beside its
    bound (ids read, dst and keep written once over the HBM rate) and its
    plain version."""
    import torch
    from repro_torch.kernels import moe_route as MR
    ids, e, cap = route_inputs(case, dev)
    kernel_ms = time_ms(lambda: MR.expert_slots(ids, e, cap), dev)
    plain_ms = time_ms(lambda: MR.expert_slots_plain(ids, e, cap), dev,
                       reps=20, warmup=3)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        MR.expert_slots(ids, e, cap)
    graph_ms = time_ms(graph.replay, dev)
    del graph
    g, n = ids.shape
    nbytes = g * n * (8 + 8 + 1)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"case": case[0], "shape": f"G={g} N={n} E={e} cap={cap}",
            "kernel_ms": kernel_ms, "graph_ms": graph_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "bytes": nbytes, "launches": 1 if n <= MR.TILE else 2,
            "l2": "flushed before each launch"}


def phase_moe_route(dev) -> dict:
    """The MoE router's expert-slot kernel against its plain version at
    MOE_ROUTE_CASES, captured and replayed at a refill and a decode shape,
    then timed at MOE_ROUTE_TIMED."""
    checks = [check_moe_route(c, dev) for c in MOE_ROUTE_CASES]
    for c in checks:
        log(f"[check] moe_route {c['case']} (G={c['groups']}, "
            f"{c['copies']} copies, E={c['experts']}, cap {c['cap']}): dst "
            f"and keep bit-equal to the plain version, {c['dropped']} "
            "copies dropped")
    captured = [check_moe_route_captured(dev, c)
                for c in (MOE_ROUTE_CASES[0], MOE_ROUTE_CASES[3])]
    timing = [time_moe_route(c, dev) for c in MOE_ROUTE_TIMED]
    card = card_line()
    for t in timing:
        log(f"[time] {card}: moe_route at {t['shape']} ({t['case']}, "
            f"{t['launches']} launch(es)): kernel {t['kernel_ms']:.4f} ms, "
            f"graph replay {t['graph_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.5f} ms (bytes), plain {t['plain_ms']:.3f} ms")
    return {"checks": checks, "captured": captured, "timing": timing}


def _experts_weights(shape: str, dev, seed=0):
    """w_gate, w_in (E, D, F) and w_out (E, F, D) bf16 at ``shape``, drawn
    on the card at fan-in scale."""
    import torch
    _, e, _, d, f, _, _ = MOE_EXPERTS_SHAPES[shape]
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple((torch.randn(sh, generator=gen, device=dev) / sh[1] ** 0.5
                  ).to(torch.bfloat16)
                 for sh in ((e, d, f), (e, d, f), (e, f, d)))


def experts_inputs(shape: str, routing: str, dev, seed=0):
    """buf (G, E, C, D) bf16 as moe_block's dispatch leaves it (a view of
    its (G, E*C + 1, D) buffer without the overflow row), dst and keep
    (G, N) from the router's plain slots, at ``shape`` under ``routing``
    (MOE_EXPERTS_ROUTINGS), and the live experts per group."""
    import torch
    from repro_torch.kernels import moe_route as MR
    g, e, c, d, _, tokens, k = MOE_EXPERTS_SHAPES[shape]
    gen = torch.Generator().manual_seed(seed)
    if routing in ("cell", "two-groups"):
        g = 2 if routing == "two-groups" else g
        logits = torch.randn(g, tokens, e, generator=gen)
        ids = torch.sort(logits, dim=-1, descending=True,
                         stable=True).indices[..., :k].reshape(g, tokens * k)
    elif routing == "one-copy":            # one kept copy, one live expert
        ids = torch.full((g, 1), e // 2)
    elif routing == "all-live":            # every expert holds C copies
        ids = (torch.arange(e * c) % e).expand(g, e * c)
    elif routing == "one-full":            # the last expert: C kept, 3 dropped
        ids = torch.full((g, c + 3), e - 1)
    else:
        raise ValueError(routing)
    dst, keep = MR.expert_slots_plain(ids.contiguous(), e, c)
    rows = e * c + 1
    x = torch.randn(g, ids.shape[1], d, generator=gen).to(torch.bfloat16)
    full = torch.zeros(g * rows, d, dtype=torch.bfloat16).index_add_(
        0, (dst + torch.arange(g)[:, None] * rows).reshape(-1),
        x.reshape(-1, d))
    buf = full.to(dev).reshape(g, rows, d)[:, :-1].reshape(g, e, c, d)
    live = [sorted({int(i) // c for i, kp in zip(dg, kg) if kp})
            for dg, kg in zip(dst.tolist(), keep.tolist())]
    return buf, dst.to(dev), keep.to(dev), live


def experts_tolerance(buf, w_gate, w_in, w_out):
    """Per element of y_e: 2^-7 of sum_f |h_f| |w_out[f, :]|, with h the
    plain chain's bf16 hidden values.  The kernel sums each product's terms
    in another order than cuBLAS (both in f32), so a bf16 output of either
    GEMM, and so an element of h, may round one step (2^-7 relative) the
    other way; the out GEMM carries such steps by |w_out|, and y_e's own
    rounding adds at most one step of |y_e| <= that sum."""
    import torch
    from repro_torch.kernels import moe_experts as ME
    h = ME.ACTS["silu"](torch.einsum("gecd,edf->gecf", buf, w_gate)) \
        * torch.einsum("gecd,edf->gecf", buf, w_in)
    return torch.einsum("gecf,efd->gecd", h.float().abs(),
                        w_out.float().abs()) * 2.0 ** -7


def _experts_close(tag: str, got, want, tol, dead) -> float:
    """Raise unless got is within tol of want and the dead experts' rows
    are exactly 0; the largest error over its tolerance."""
    import torch
    if got[dead].any() or want[dead].any():
        raise AssertionError(f"moe_experts {tag}: a dead expert's rows are "
                             "not 0")
    err = (got.float() - want.float()).abs()
    if not bool(torch.isfinite(got).all()) or bool((err > tol).any()):
        bad = (err > tol) | ~torch.isfinite(got)
        raise AssertionError(
            f"moe_experts {tag}: {int(bad.sum())} of {bad.numel()} values "
            f"outside the tolerance, the first at {bad.nonzero()[0].tolist()}"
            f" (max error {float(err.max()):.3g})")
    return float((err / tol.clamp_min(1e-30)).max())


def _dead_rows(buf, live):
    import torch
    dead = torch.ones(buf.shape[:2], dtype=torch.bool, device=buf.device)
    for gi, experts in enumerate(live):
        dead[gi, experts] = False
    return dead


def check_moe_experts(shape: str, routing: str, dev, seed=0) -> dict:
    """The expert-FFN kernel against ``expert_ffn_plain`` (cuBLAS's dense
    einsums on the card) at ``shape`` under ``routing``: within
    ``experts_tolerance``, dead experts' rows exactly 0, one launch."""
    from repro_torch.kernels import moe_experts as ME
    ws = _experts_weights(shape, dev)
    buf, dst, keep, live = experts_inputs(shape, routing, dev, seed)
    got = counted_once("moe_experts", f"moe_experts {shape} {routing}",
                       lambda: ME.expert_ffn(buf, *ws, dst, keep, "silu"))
    want = ME.expert_ffn_plain(buf, *ws, "silu")
    ratio = _experts_close(f"{shape} {routing}", got, want,
                           experts_tolerance(buf, *ws), _dead_rows(buf, live))
    return {"shape": shape, "routing": routing, "groups": buf.shape[0],
            "live": [len(x) for x in live],
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "max_err_over_tol": ratio}


def check_moe_experts_captured(dev, shape: str) -> dict:
    """The kernel in a captured graph (``check_captured``: eager and
    captured under the cell's routing, replayed twice, bit-equal, one
    launch per replay); then the graph replayed under other routings (one
    kept copy, every expert full, another seed's) must give the eager
    kernel's result under each, bit for bit: the experts it skips are read
    from dst and keep on the device at every replay.  A graph holds one
    call shape, so the other routings' copies are padded to the cell's
    with dropped ones (keep False), which choose no expert."""
    import torch

    from repro_torch.kernels import moe_experts as ME
    from repro_torch.launch.compile import CompiledStep
    ws = _experts_weights(shape, dev)
    buf, dst, keep, live = experts_inputs(shape, "cell", dev)
    want = ME.expert_ffn_plain(buf, *ws, "silu")
    tol = experts_tolerance(buf, *ws)

    def fn(buf, dst, keep):
        return ME.expert_ffn(buf, *ws, dst, keep, "silu")
    _, st = check_captured(
        dev, f"moe_experts-{shape}", fn, (buf, dst, keep), "moe_experts",
        lambda got: _experts_close(f"{shape} (compiled)", got, want, tol,
                                   _dead_rows(buf, live)))
    step = CompiledStep(fn, device=dev, name=f"moe_experts-{shape}-b")
    step(buf, dst, keep)                   # captured under the cell's routing
    replays = []
    for routing, seed in (("one-copy", 0), ("one-full", 0), ("cell", 7)):
        b2, d2, k2, live2 = experts_inputs(shape, routing, dev, seed)
        pad = dst.shape[1] - d2.shape[1]
        d2 = torch.cat([d2, d2.new_full((1, pad),
                                        buf.shape[1] * buf.shape[2])], 1)
        k2 = torch.cat([k2, k2.new_zeros((1, pad))], 1)
        eager = ME.expert_ffn(b2, *ws, d2, k2, "silu")
        got = step(b2, d2, k2)
        torch.cuda.synchronize()
        if not torch.equal(got, eager):
            raise AssertionError(f"moe_experts {shape}: the graph captured "
                                 f"under the cell's routing, replayed under "
                                 f"{routing}, differs from the eager call")
        _experts_close(f"{shape} replayed under {routing}", got,
                       ME.expert_ffn_plain(b2, *ws, "silu"),
                       experts_tolerance(b2, *ws), _dead_rows(b2, live2))
        replays.append({"routing": routing, "live": len(live2[0])})
    log(f"[capture] moe_experts {shape}: captured in {st['capture_s']:.3f} s "
        f"and replayed twice, bit-equal, one launch per replay; the graph "
        f"replayed under {', '.join(r['routing'] for r in replays)} "
        f"({', '.join(str(r['live']) for r in replays)} live experts) gave "
        "the eager kernel's result bit for bit")
    return {"shape": shape, "capture_s": st["capture_s"],
            "replayed_under": replays}


def time_moe_experts(shape: str, dev) -> dict:
    """The kernel at ``shape`` under the cell's routing (CUDA events,
    median, L2 flushed first) and one replay of a graph holding the call,
    beside its bound (the live experts' weights, buf and y_e once over the
    HBM rate), the plain version (the dense chain over every expert) and
    the dense einsums alone (cuBLAS, the yardstick)."""
    import torch
    from repro_torch.kernels import moe_experts as ME
    ws = _experts_weights(shape, dev)
    buf, dst, keep, live = experts_inputs(shape, "cell", dev)
    kernel_ms = time_ms(lambda: ME.expert_ffn(buf, *ws, dst, keep, "silu"),
                        dev)
    plain_ms = time_ms(lambda: ME.expert_ffn_plain(buf, *ws, "silu"), dev,
                       reps=50, warmup=5)
    h = ME.ACTS["silu"](torch.einsum("gecd,edf->gecf", buf, ws[0])) \
        * torch.einsum("gecd,edf->gecf", buf, ws[1])

    def einsums():
        torch.einsum("gecd,edf->gecf", buf, ws[0])
        torch.einsum("gecd,edf->gecf", buf, ws[1])
        torch.einsum("gecf,efd->gecd", h, ws[2])
    einsum_ms = time_ms(einsums, dev, reps=50, warmup=5)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ME.expert_ffn(buf, *ws, dst, keep, "silu")
    graph_ms = time_ms(graph.replay, dev)
    del graph
    g, e, c, d = buf.shape
    f = ws[0].shape[-1]
    n_live = sum(len(x) for x in live)
    nbytes = n_live * 3 * d * f * 2 + 2 * g * e * c * d * 2
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"shape": shape, "dims": f"G={g} E={e} C={c} D={d} F={f}",
            "live": n_live, "kernel_ms": kernel_ms, "graph_ms": graph_ms,
            "plain_ms": plain_ms, "dense_einsum_ms": einsum_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes,
            "bound_share": bound_ms / kernel_ms,
            "l2": "flushed before each launch"}


def phase_moe_experts(dev) -> dict:
    """The MoE's expert-FFN kernel against its plain version at both cells'
    decode shapes under every MOE_EXPERTS_ROUTINGS, captured and replayed
    (under new routings too), then timed under the cells' routing."""
    checks = [check_moe_experts(sh, r, dev) for sh in MOE_EXPERTS_SHAPES
              for r in MOE_EXPERTS_ROUTINGS]
    for c in checks:
        log(f"[check] moe_experts {c['shape']} {c['routing']} (G="
            f"{c['groups']}, live experts {c['live']}): within the "
            f"tolerance (largest error {c['max_abs_err']:.4g}, "
            f"{c['max_err_over_tol']:.3f} of it), dead experts exactly 0")
    captured = [check_moe_experts_captured(dev, sh)
                for sh in MOE_EXPERTS_SHAPES]
    timing = [time_moe_experts(sh, dev) for sh in MOE_EXPERTS_SHAPES]
    card = card_line()
    for t in timing:
        log(f"[time] {card}: moe_experts at {t['shape']} ({t['dims']}, "
            f"{t['live']} live experts): kernel {t['kernel_ms']:.4f} ms, "
            f"graph replay {t['graph_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms (bytes, {t['bound_share']:.1%} of it), "
            f"plain {t['plain_ms']:.4f} ms, dense einsums "
            f"{t['dense_einsum_ms']:.4f} ms")
    return {"checks": checks, "captured": captured, "timing": timing}


def phase_kanana_launches(dev) -> dict:
    """kanana-2-30b-a3b at full width and depth (random weights, 61.3 GB)
    through the engine's compiled steps: warm-up at KANANA_PROMPT, then a
    refill of all four slots and four decode steps, replayed; each step's
    launches per replay against the model: the prefill kernel once per MLA
    layer of a refill (its (192, 128) instantiation), the latent decode
    kernels once per MLA layer of a decode step, the router kernel once
    per MoE layer of every call, the expert kernel once per MoE layer of a
    decode step and never in a refill."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serve.batcher import ServingEngine
    cfg = get_config(KANANA_ARCH)
    n_moe = moe_layers(cfg)
    eng = ServingEngine(cfg, reduced=False, max_batch=4,
                        max_len=KANANA_PROMPT + 8, fused_decode=True,
                        device=dev)
    eng.warmup([KANANA_PROMPT], slots=True)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (4, KANANA_PROMPT), np.int32)
    caches = eng.init_caches()
    nxt, caches, _ = eng.prefill_into_slots(toks, caches, np.ones(4, bool))
    lens = np.full(4, KANANA_PROMPT, np.int32)
    for _ in range(4):
        nxt, caches, _ = eng.decode(nxt[:, None].astype(np.int32), caches,
                                    lens)
        lens += 1
    torch.cuda.synchronize()
    rep = compile_report([eng], tag="kanana")
    want = {"decode": {"decode_attention_latent": cfg.num_layers,
                       "moe_route": n_moe, "moe_experts": n_moe},
            f"slot_prefill[{KANANA_PROMPT}]": {
                "prefill_attention": cfg.num_layers, "moe_route": n_moe}}
    got = rep["launches_per_replay"]
    if got != want:
        raise AssertionError(f"kanana launches per replay {got}, expected "
                             f"{want}")
    log(f"[kanana] {KANANA_ARCH} full width, 4 slots x {KANANA_PROMPT}: "
        f"launches per replay {got}; peak "
        f"{gib(torch.cuda.max_memory_allocated(dev))}")
    _log_compile("kanana", rep)
    del eng, caches
    return {"launches_per_replay": got, "compiled": rep}


# --------------------------------------------------------------------------- #
# Phases
# --------------------------------------------------------------------------- #
def phase_serve(dev) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.launch.serve import serve

    prompts, prompt_len, gen = 4, 128, 32
    cfg = get_config(ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    LAUNCHES["decode_attention"] = 0
    t0 = time.perf_counter()
    out = serve(ARCH, reduced=False, prompts=prompts, prompt_len=prompt_len,
                gen=gen, fused_decode=True, device=dev)
    wall = time.perf_counter() - t0
    launches = LAUNCHES["decode_attention"]
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


def stream_spec(requests: int = STREAM_REQUESTS):
    from repro_torch.serve import WorkloadSpec
    return WorkloadSpec(num_requests=requests, rate_rps=STREAM_RATE,
                        seed=STREAM_SEED)


def stream_max_len(arch: str = ARCH, requests: int = STREAM_REQUESTS) -> int:
    """The cache length ``serve_workload`` sizes for the streaming trace."""
    from repro_torch.configs import get_config
    spec = replace(stream_spec(requests),
                   vocab_size=get_config(arch).vocab_size)
    return max(r.prompt_len + r.gen_len for r in spec.build())


def attention_layers(cfg) -> int:
    """Attention blocks in a stack: the decode kernel's calls per step."""
    per_group = sum(k != "mamba" for k in cfg.pattern)
    return per_group * cfg.full_groups + sum(k != "mamba" for k in cfg.tail)


def stream_cases(sms: int, arch: str = ARCH) -> list:
    """The decode kernel at ``arch``'s streaming shape: B=4, S = the CLI
    trace's max_len, with the new token at 0, S - 1 and on chunk edges of
    the kernels' split (the middle of the row where the split has one
    chunk), in bf16 and int8 caches; and lens drawn in [128, S)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as DA
    cfg = get_config(arch)
    s = stream_max_len(arch)
    kh = cfg.num_kv_heads
    _, chunk = DA.split_plan(4, kh, s, sms)
    edge = chunk if chunk < s else s // 2
    edge2 = 2 * edge if 2 * edge < s else edge + 1
    shape = (arch, 4, s, cfg.num_heads, kh, cfg.qk_head_dim, "bf16")
    tag = "" if arch == ARCH else f"{arch}-"
    return [(f"{tag}stream-edges", *shape, [0, s - 1, edge - 1, edge],
             False, False, 0),
            (f"{tag}stream-edges-q8", *shape, [edge2 - 1, 0, s - 1, edge2],
             True, False, 0),
            (f"{tag}stream-drawn", *shape, None, False, False, 0)]


def gib(nbytes: float) -> str:
    return f"{nbytes / 2**30:.2f} GiB"


def _decode_steps_sync_checked():
    """Queue and await every replayed decode step of a ``ServingEngine``
    (one whose decode graph is captured) under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
    stream or device sync and any blocking copy.  Returns a one-element
    count of the decode steps so checked and an undo."""
    import torch
    from repro_torch.serve.batcher import ServingEngine

    decode, wait = ServingEngine.decode_async, ServingEngine.wait_step
    checked, count = set(), [0]

    def sync_free(fn, *args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def decode_async(self, tok, caches, lens):
        if not self._dec_jit.graphs():   # the capture itself syncs
            return decode(self, tok, caches, lens)
        pending = sync_free(decode, self, tok, caches, lens)
        checked.add(id(pending))
        return pending

    def wait_step(self, pending):
        if id(pending) not in checked:
            return wait(self, pending)
        checked.discard(id(pending))
        count[0] += 1
        return sync_free(wait, self, pending)

    ServingEngine.decode_async, ServingEngine.wait_step = (decode_async,
                                                           wait_step)

    def undo():
        ServingEngine.decode_async, ServingEngine.wait_step = decode, wait
    return count, undo


def phase_stream(dev, pipeline: bool = False, arch: str = ARCH,
                 requests: int = STREAM_REQUESTS, mesh=None,
                 tag: str = "stream", sync_check: bool = False) -> dict:
    """The streaming path at full width: ``serve_workload`` with the CLI's
    defaults (its first ``requests`` requests) on the wall-clock fabric,
    fused decode on; ``pipeline`` runs the pipelined loop instead of the
    continuous one; ``mesh`` (a ``DeviceMesh``) goes to the engine, whose
    decode then runs the kernels' slot-shard form.  The decode kernel must
    launch once per attention layer for every decode job and warm-up
    decode.  ``sync_check`` queues and awaits every replayed decode step
    under ``set_sync_debug_mode("error")``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.sync import credit_threshold
    from repro_torch.kernels import prefill_attention as PA
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.obs import Tracer
    from repro_torch.serve import RequestState, ServeConfig, serve_workload

    cfg = get_config(arch)
    n_attn = attention_layers(cfg)
    n_moe = moe_layers(cfg)
    tracer = Tracer()     # its wall-domain spans give the decode seconds
    torch.cuda.reset_peak_memory_stats(dev)
    mem_before = torch.cuda.memory_allocated(dev)
    reads, undo = _record_credit_reads()
    engines, undo_rec = _record_engines()
    checked, undo_check = (_decode_steps_sync_checked() if sync_check
                           else ([0], lambda: None))
    windows, undo_window = time_loop_runs()
    try:
        LAUNCHES.clear()
        t0 = time.perf_counter()
        out = serve_workload(stream_spec(requests), config=ServeConfig(
            arch=arch, reduced=False, fused_decode=True, fabric="wallclock",
            pipeline=pipeline, device=dev, tracer=tracer,
            mesh_shape=(1, 1) if mesh is None else tuple(mesh.shape),
            mesh=mesh))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, other = (LAUNCHES[k] for k in (
            ("decode_attention_shard", "decode_attention") if mesh is not None
            else ("decode_attention", "decode_attention_shard")))
        prefill_launches = LAUNCHES["prefill_attention"]
        route_launches = LAUNCHES["moe_route"]
        expert_launches = LAUNCHES["moe_experts"]
    finally:
        undo()
        undo_rec()
        undo_check()
        undo_window()
    compiled = compile_report(engines, tag=tag)
    del engines
    m, reqs = out["metrics"], out["requests"]
    threshold = credit_threshold()
    n_lengths = len({r.prompt_len for r in reqs})   # one warm-up each
    expect = n_attn * (m.decode_jobs + n_lengths)
    if launches != expect or other:
        raise AssertionError(f"kernel launched {launches} times while "
                             f"streaming, expected {n_attn} x "
                             f"({m.decode_jobs} + {n_lengths}); the other "
                             f"form of the decode kernel {other} times")
    # One prefill-attention launch per attention layer and prefill (warm-up
    # and capture included) where the kernel takes the prefill: one device,
    # bf16, a built head dim; none on a mesh.
    takes = (mesh is None and cfg.dtype == "bfloat16"
             and cfg.qk_head_dim in PA.HEAD_DIMS and n_attn > 0)
    if (prefill_launches % max(n_attn, 1)
            or bool(prefill_launches) != takes):
        raise AssertionError(f"prefill_attention launched {prefill_launches} "
                             f"times over {n_attn} attention layers "
                             f"(the route {'takes' if takes else 'skips'} "
                             "the kernel)")
    # The router kernel: once per MoE layer of every step the engine runs.
    if route_launches % max(n_moe, 1) or bool(route_launches) != bool(n_moe):
        raise AssertionError(f"moe_route launched {route_launches} times over "
                             f"{n_moe} MoE layers")
    # The expert-FFN kernel: once per MoE layer of every decode step, warm-up
    # decodes included, and never in a prefill.
    per_decode = n_moe if expert_kernel_runs(cfg, mesh) else 0
    check_expert_launches(compiled, per_decode, f"{arch} {tag}")
    if expert_launches != per_decode * (m.decode_jobs + n_lengths):
        raise AssertionError(f"moe_experts launched {expert_launches} times "
                             f"while streaming, expected {per_decode} x "
                             f"({m.decode_jobs} + {n_lengths})")
    # Every decode but the first warm-up one, which captures the graph.
    if sync_check and checked[0] != m.decode_jobs + n_lengths - 1:
        raise AssertionError(f"{checked[0]} decode steps ran under the sync "
                             f"check, expected {m.decode_jobs} + "
                             f"{n_lengths - 1} warm-up")
    n_reads = m.prefill_jobs + m.decode_jobs + 2 * n_lengths
    if len(reads) != n_reads or any(r != threshold for r in reads):
        raise AssertionError(f"{len(reads)} credit reads (expected "
                             f"{n_reads}), below threshold: "
                             f"{[r for r in reads if r != threshold]}")
    admitted = [r for r in reqs if r.state is not RequestState.REJECTED]
    if (len(admitted) != m.admitted or m.completed != m.admitted
            or m.admitted + m.rejected != requests
            or m.dropped or out["orphans"]
            or any(r.state is not RequestState.DONE for r in admitted)):
        raise AssertionError(f"admitted {m.admitted}, rejected {m.rejected},"
                             f" completed {m.completed}, dropped {m.dropped}")
    for r in admitted:
        toks = r.generated
        if len(toks) != r.gen_len or toks.min() < 0 or \
                toks.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r.rid}: tokens {toks}")
    decode_s = sum(e.dur for e in tracer.events
                   if e.domain == "wall_s" and e.name == "decode")
    prefill_s = sum(e.dur for e in tracer.events
                    if e.domain == "wall_s" and e.name == "prefill")
    decode_tokens = sum(p.n_elems for p in out["plans"] if p.kind == "decode")
    snap = out["calibration"]
    summ = m.summary()
    lat = summ["latency_us"]
    loop = "pipelined" if pipeline else "continuous"
    del out
    torch.cuda.synchronize()
    res = {"arch": arch, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "params": cfg.param_count(), "attention_layers": n_attn,
           "loop": loop, "pipelined_prefills": m.pipelined_prefills,
           "requests": requests, "rate_rps": STREAM_RATE,
           "seed": STREAM_SEED, "max_len": stream_max_len(arch, requests),
           "prompt_lengths": n_lengths, "admitted": m.admitted,
           "rejected": m.rejected, "completed": m.completed,
           "prefill_jobs": m.prefill_jobs, "decode_jobs": m.decode_jobs,
           "launches": launches, "prefill_launches": prefill_launches,
           "moe_route_launches": route_launches,
           "moe_experts_launches": expert_launches,
           "credit_reads": len(reads), "decode_tokens": decode_tokens, "decode_s": decode_s,
           "prefill_s": prefill_s,
           "decode_tok_s": decode_tokens / decode_s,
           "decode_wall_ms_per_step": decode_s / m.decode_jobs * 1e3,
           "loop_window_s": windows[0],
           "window_decode_tok_s": decode_tokens / windows[0],
           "sync_checked_decodes": checked[0],
           "decode_rows_tok_s": 4 * m.decode_jobs / decode_s,
           "latency_p50_s": lat["p50"] / 1e6, "latency_p99_s": lat["p99"] / 1e6,
           "ttft_p99_s": summ["ttft_us"]["p99"] / 1e6,
           "step_p50_ms": summ["wall"]["step_p50_ms"],
           "slot_occupancy_mean": summ["slot_occupancy"]["mean"],
           "mid_wave_admissions": m.mid_wave_admissions,
           "calibration": snap.as_dict(),
           "memory_allocated_before": mem_before,
           "memory_allocated_after": torch.cuda.memory_allocated(dev),
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "max_memory_reserved": torch.cuda.max_memory_reserved(dev),
           "compiled": compiled, "serve_wall_s": wall}
    card = card_line()
    log(f"[{tag}] {card}: {arch} full width ({cfg.num_layers} layers, "
        f"{cfg.param_count()} params, {cfg.dtype}), {requests} requests at "
        f"{STREAM_RATE:g} req/s (seed {STREAM_SEED}), wall-clock fabric, "
        f"{loop} loop, fused decode, max_len {res['max_len']}; "
        f"memory_allocated before {gib(mem_before)}")
    form = "slot-shard form" if mesh is not None else "kernel"
    kernel = (f"{form} launches {launches} == {n_attn} x ({m.decode_jobs} + "
              f"{n_lengths} warm-up)" if n_attn else
              f"no attention layer, so no decode-kernel launch ({launches})")
    log(f"[{tag}] {card}: admitted {m.admitted}, rejected {m.rejected}, "
        f"completed {m.completed}; prefill jobs {m.prefill_jobs}, decode "
        f"jobs {m.decode_jobs}; {kernel}; prefill_attention launches "
        f"{prefill_launches}; moe_route launches {route_launches}; credit reads {len(reads)}/{n_reads} at threshold; "
        f"{m.pipelined_prefills} pipelined prefills"
        + (f"; {checked[0]} replayed decode steps queued and awaited under "
           "set_sync_debug_mode('error')" if sync_check else ""))
    log(f"[{tag}] {card}: decode {decode_tokens} tokens in {decode_s:.4f} "
        f"s of decode-step wall ({res['decode_wall_ms_per_step']:.3f} ms "
        f"per step) = {res['decode_tok_s']:.1f} tok/s "
        f"({res['decode_rows_tok_s']:.1f} counting all 4 rows); over the "
        f"loop's whole window ({windows[0]:.4f} s, prefills included) "
        f"{res['window_decode_tok_s']:.1f} tok/s; prefill "
        f"jobs {prefill_s:.4f} s; step p50 "
        f"{res['step_p50_ms']:.2f} ms; request latency p50 "
        f"{res['latency_p50_s']:.4f} s, p99 {res['latency_p99_s']:.4f} s; "
        f"slot occupancy {res['slot_occupancy_mean']:.3f}")
    mape = snap.window_mape_pct
    log(f"[{tag}] {card}: calibrated [{snap.source}, {snap.n_samples} "
        f"samples]: alpha {snap.alpha:.1f} beta {snap.beta:.4f} gamma "
        f"{snap.gamma:.4f} (cycles = ns), window MAPE "
        f"{'n/a' if mape is None else f'{mape:.2f}%'}; max_memory_allocated "
        f"{gib(res['max_memory_allocated'])}, max_memory_reserved "
        f"{gib(res['max_memory_reserved'])}, memory_allocated after "
        f"{gib(res['memory_allocated_after'])}; wall {wall:.1f} s "
        f"(weights drawn on the card and the warm-up included)")
    _log_compile(tag, compiled)
    return res


def _tap_decodes(route: bool = True):
    """Record, per decode job, each row's next token and, with ``route``,
    the smallest margin between its k-th and (k+1)-th router logit over
    the step's MoE layers (for the report of a token that differs; the
    router runs in Python only in an eager step, so a compiled run taps no
    route).  Returns the record and a function that undoes the wrapping."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.serve.batcher import ServingEngine

    rec = {"steps": [], "margins": []}
    route, decode = L.moe_route, ServingEngine.decode_async

    def tapped_route(xg, w_router, cfg, cap, *bias):
        if xg.shape[1] == 4:            # a decode step's four rows
            top = torch.sort(xg @ w_router.to(xg.dtype), dim=-1,
                             descending=True, stable=True).values
            k = cfg.num_experts_per_tok
            rec["margins"].append((top[..., k - 1] - top[..., k]).amin(0))
        return route(xg, w_router, cfg, cap, *bias)

    def tapped_decode(self, tok, caches, lens):
        first = len(rec["margins"])
        pending = decode(self, tok, caches, lens)
        rec["steps"].append((pending.out["next_token"], first,
                             len(rec["margins"])))
        return pending

    ServingEngine.decode_async = tapped_decode
    if route:
        L.moe_route = tapped_route

    def undo():
        L.moe_route, ServingEngine.decode_async = route, decode
    return rec, undo


def _first_difference(a: dict, b: dict) -> str:
    """The first decode job whose next tokens differ between two tapped
    runs: its step, row and that row's smallest router margin in each."""
    import torch
    for i, ((ta, a0, a1), (tb, b0, b1)) in enumerate(zip(a["steps"],
                                                         b["steps"])):
        rows = (ta != tb).nonzero().flatten().tolist()
        if rows:
            r = rows[0]

            def margin(rec, lo, hi):
                if hi == lo:
                    return "n/a (no MoE layer)"
                return f"{float(torch.stack(rec['margins'][lo:hi])[:, r].min()):.3e}"
            return (f"decode step {i}, row {r}: tokens {int(ta[r])} vs "
                    f"{int(tb[r])}; smallest top-k router margin "
                    f"{margin(a, a0, a1)} vs {margin(b, b0, b1)}")
    return "no decode step differs (the prefill's tokens do)"


def check_no_sync(dev) -> dict:
    """Queueing a step syncs nothing: for each arch of NO_SYNC_ARCHS
    (reduced, f32, fused decode), a warm engine's
    ``prefill_into_slots_async`` and two ``decode_async`` run under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
    stream or device sync and on any blocking copy; then the steps are
    awaited and their credits read.  The warm calls captured the steps'
    graphs, so the queued steps are replays (input copies, one graph
    launch, output copies), and the decode kernel's count must grow by
    its captured launches per replay: one per attention layer."""
    import numpy as np
    import torch
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.serve.batcher import ServingEngine

    # The mode catches a blocking copy (else the check below proves nothing).
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.as_tensor(np.zeros(4, np.int32), device=dev)
        caught = False
    except RuntimeError:
        caught = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not caught:
        raise AssertionError("set_sync_debug_mode('error') let a blocking "
                             "host->device copy through")
    res = {}
    for arch in NO_SYNC_ARCHS:
        eng = ServingEngine(arch, reduced=True, max_batch=4, max_len=48,
                            fused_decode=True, device=dev)
        tokens = np.random.default_rng(0).integers(
            0, eng.cfg.vocab_size, (4, 16), dtype=np.int32)
        mask = np.array([True, False, True, True])
        lens = np.array([16, 3, 16, 16], np.int32)
        tok, caches, _ = eng.prefill_into_slots(tokens, eng.init_caches(),
                                                mask)
        tok, caches, _ = eng.decode(tok[:, None], caches, lens)
        torch.cuda.synchronize()
        LAUNCHES.clear()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pend = [eng.prefill_into_slots_async(tokens, caches, mask)]
            for i in (1, 2):
                pend.append(eng.decode_async(tok[:, None],
                                             pend[-1].out["caches"],
                                             lens + i))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        for p in pend:
            eng.wait_step(p)      # raises if a credit count falls short
        n_attn = attention_layers(eng.cfg)
        per_replay = eng._dec_jit.stats()[0]["launches_per_replay"]
        decode, route = LAUNCHES["decode_attention"], LAUNCHES["moe_route"]
        if decode != 2 * n_attn or \
                per_replay.get("decode_attention", 0) != n_attn:
            raise AssertionError(f"{arch}: {decode} decode-kernel "
                                 f"launches for two replays ({per_replay} "
                                 f"per replay), expected 2 x {n_attn}")
        # The router kernel: once per MoE layer in each of the three replays.
        n_moe = moe_layers(eng.cfg)
        if route != 3 * n_moe or per_replay.get("moe_route", 0) != n_moe:
            raise AssertionError(f"{arch}: {route} moe_route launches "
                                 f"for three replays ({per_replay} per "
                                 f"decode replay), expected 3 x {n_moe}")
        # The expert-FFN kernel: once per MoE layer in each decode replay
        # where the config takes it (not in f32), never in the prefill.
        experts = n_moe if expert_kernel_runs(eng.cfg) else 0
        if LAUNCHES["moe_experts"] != 2 * experts or \
                per_replay.get("moe_experts", 0) != experts:
            raise AssertionError(f"{arch}: {LAUNCHES['moe_experts']} "
                                 f"moe_experts launches for two decode "
                                 f"replays, expected 2 x {experts}")
        res[arch] = {"steps_queued": len(pend), "replay_launches": decode,
                     "graphs": len(eng.compiled_steps())}
    log(f"[sync] prefill_into_slots_async and decode_async replayed their "
        f"graphs under set_sync_debug_mode('error') with no sync, the decode "
        f"kernel counted once per attention layer per replay and the router "
        f"kernel once per MoE layer, on reduced "
        f"{', '.join(NO_SYNC_ARCHS)} (the mode raised on a deliberate "
        f"blocking copy first)")
    return res


def check_captured_kernel(dev, case=BIG_SMEM_CASE) -> dict:
    """The decode kernel inside a captured graph (``check_captured``):
    ``fused_decode_attention`` with the caches static, at ``case`` (the
    launches set the kernels' shared-memory attribute and launch on the
    capture stream).  Each call starts from the same caches, and its out
    and caches must equal the plain version's one step from them (out bit
    for bit across the calls: the tickets and chunk sums of a replay start
    as the eager call's did)."""
    import torch
    from repro_torch.kernels import decode_attention as DA

    name, *_, dt, _, _, _, _ = case
    args = make_inputs(case, 0, dev)[0][:8]
    q, k, v, kc, vc, idx, cos, sin = args
    kc0, vc0 = kc.clone(), vc.clone()
    want = DA.decode_attention_plain(q, k, v, kc0.clone(), vc0.clone(), idx,
                                     cos, sin)

    def compare(out):     # then back to the first call's caches
        if not (torch.equal(kc, want[1]) and torch.equal(vc, want[2])):
            raise AssertionError(f"{name}: caches differ from the plain "
                                 "version's")
        torch.testing.assert_close(out, want[0], **TOL[dt],
                                   msg=lambda m: f"{name}: out: {m}")
        kc.copy_(kc0)
        vc.copy_(vc0)

    outs, st = check_captured(
        dev, name, lambda *a: DA.fused_decode_attention(*a)[0], args,
        "decode_attention", compare, static_argnums=(3, 4))
    err = max(float((o.float() - want[0].float()).abs().max()) for o in outs)
    g, d = case[4] // case[5], case[6]
    smem = max(DA.smem_bytes(g, d, q.element_size(), kc.element_size(),
                             tc=DA.tensor_cores(q.dtype, d), pv=pv)
               for pv in (False, True))
    log(f"[capture] {name}: fused_decode_attention (G={g}, {smem} B of "
        f"shared memory per CTA) captured in "
        f"{st['capture_s']:.3f} s and replayed twice: out within {TOL[dt]} "
        f"of the plain version (max abs err {err:.3g}) and bit-equal "
        f"across the calls, caches bit-exact")
    return {"case": name, "capture_s": st["capture_s"], "max_abs_err": err}


def phase_stream_fused_vs_unfused(dev, arch: str = ARCH,
                                  layers: int = STREAM_CHECK_LAYERS,
                                  design=None) -> dict:
    """The streaming trace at full width, depth cut to ``layers``, f32, on
    the simulated fabric (a fixed schedule): fused and unfused decoding,
    and the fused pipelined loop, must give the same token stream for
    every request.  These three run eagerly (``disable_compile()``); the
    fused and unfused runs are then repeated with the engine's compiled
    steps (a CUDA graph per step and shape, captured at its first call and
    replayed at every later one), which must give the eager runs' streams
    and kernel launches.  If a token differs, the report names the decode
    step, the row and the row's smallest top-k router margin.  With
    ``design`` (a swept co-design point) the fabric is that design's, and
    the pipelined loop is left out.

    One exception, for an MoE: the pipelined loop batches other requests
    together, and with one routing group a batch's rows share the
    experts' capacity (ROADMAP C12, as in the reference), so its streams
    may differ from the continuous loop's; they are counted, not held
    equal."""
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.launch.compile import disable_compile
    from repro_torch.models import init_params
    from repro_torch.serve import RequestState, ServeConfig, serve_workload

    cfg = replace(get_config(arch), num_layers=layers, dtype="float32")
    n_attn = attention_layers(cfg)
    params = init_params(cfg, seed=0, device=dev)   # serving leaves it as is
    # name: (fused, pipelined, compiled, the eager run it must equal)
    runs = {"fused": (True, False, False, "fused"),
            "unfused": (False, False, False, "fused")}
    if design is None:
        runs["fused-pipelined"] = (True, True, False, "fused")
    runs["fused-compiled"] = (True, False, True, "fused")
    runs["unfused-compiled"] = (False, False, True, "unfused")
    streams, plans, launches, taps, compiled = {}, {}, {}, {}, {}
    for name, (fused, pipeline, comp, _) in runs.items():
        LAUNCHES["decode_attention"] = 0
        taps[name], undo = _tap_decodes(route=not comp)
        engines, undo_rec = _record_engines()
        try:
            with (contextlib.nullcontext() if comp else disable_compile()):
                out = serve_workload(stream_spec(), config=ServeConfig(
                    arch=cfg, reduced=False, fused_decode=fused,
                    fabric="simulated", pipeline=pipeline, device=dev,
                    params=params, design=design))
        finally:
            undo()
            undo_rec()
        launches[name] = LAUNCHES["decode_attention"]
        streams[name] = {r.rid: r.generated.tolist() for r in out["requests"]
                         if r.state is RequestState.DONE}
        plans[name] = [(p.kind, p.n_elems, p.m) for p in out["plans"]]
        if comp:
            compiled[name] = report = compile_report(engines, out["plans"],
                                                     f"{arch} {name}")
            # The router kernel replays once per MoE layer in every step.
            off = {k: v for k, v in report["launches_per_replay"].items()
                   if v.get("moe_route", 0) != moe_layers(cfg)}
            if off:
                raise AssertionError(f"{arch} {name}: moe_route launches per "
                                     f"replay {off}, expected "
                                     f"{moe_layers(cfg)}")
            check_expert_launches(
                report, moe_layers(cfg) if expert_kernel_runs(cfg) else 0,
                f"{arch} {name}")
        del out, engines
    if plans["fused"] != plans["unfused"] or not streams["fused"]:
        raise AssertionError(f"{arch}: the simulated schedule differs "
                             "between runs")
    coupled = {}      # the pipelined run's differing requests (an MoE)
    for name in [n for n in runs if n != "fused"]:
        base = runs[name][3]
        if plans[name] != plans[base] and runs[name][2]:
            raise AssertionError(f"{arch} {name}: the simulated schedule "
                                 f"differs from the {base} run's")
        if streams[name].keys() != streams[base].keys():
            raise AssertionError(f"{arch} {name}: other requests completed")
        bad = [rid for rid in streams[base]
               if streams[name][rid] != streams[base][rid]]
        if bad and name == "fused-pipelined" and cfg.num_experts:
            coupled = {"requests": bad}
            log(f"[stream-check] {arch}: the pipelined loop's streams differ "
                f"from the continuous loop's for {len(bad)} of "
                f"{len(streams[name])} requests: it batches other rows "
                f"together, and rows share the experts' capacity (ROADMAP "
                f"C12)")
        elif bad:
            raise AssertionError(
                f"{arch}: {base} and {name} token streams differ for "
                f"requests {bad}; "
                f"{_first_difference(taps[base], taps[name])}")
        if runs[name][2] and launches[name] != launches[base]:
            raise AssertionError(f"{arch} {name}: {launches[name]} kernel "
                                 f"launches, the eager run {launches[base]}")
    # Every decode step runs on the engine, offloaded or kept on the host.
    for name in runs:
        steps = sum(p[0] == "decode" for p in plans[name])
        want = n_attn * steps if runs[name][0] else 0
        if launches[name] != want:
            raise AssertionError(f"{arch} {name}: {launches[name]} kernel "
                                 f"launches, expected {want}")
    n_tok = sum(len(v) for v in streams["fused"].values())
    margins = taps["fused"]["margins"]
    smallest = (min(float(m.min()) for m in margins) if margins else None)
    names = [n for n in runs if not (coupled and n == "fused-pipelined")]
    same = ", ".join(names[:-1]) + " and " + names[-1]
    where = ("simulated fabric" if design is None else
             f"the simulated fabric of design [{design.name}]")
    log(f"[stream-check] {arch}, f32, full width, depth cut to {layers} "
        f"layers, {where}: {same} token streams equal for "
        f"{len(streams['fused'])} requests ({n_tok} tokens; kernel launches "
        f"{launches}"
        + ("" if smallest is None else
           f"; smallest decode-row top-k router margin {smallest:.3e}") + ")")
    for name, rep in compiled.items():
        _log_compile(f"stream-check] [{arch} {name}", rep)
    return {"arch": arch, "layers": layers, "dtype": "float32",
            "design": None if design is None else design.name,
            "requests": len(streams["fused"]), "tokens": n_tok,
            "launches": launches, "smallest_router_margin": smallest,
            "pipelined_differs_c12": coupled, "compiled": compiled}


# --------------------------------------------------------------------------- #
# The co-design explorer and the fleet
# --------------------------------------------------------------------------- #
def _record_credit_reads():
    """Wrap ``CreditCounterSync.wait`` to record every credit read (None
    where a fault was detected); returns the record and an undo."""
    from repro_torch.core.sync import CreditCounterSync, FaultDetected

    reads, wait = [], CreditCounterSync.wait

    def recording_wait(self, credits):
        try:
            got = wait(self, credits)
        except FaultDetected:
            reads.append(None)
            raise
        reads.append(got)
        return got

    CreditCounterSync.wait = recording_wait

    def undo():
        CreditCounterSync.wait = wait
    return reads, undo


def _record_engines():
    """Record every ``ServingEngine`` built from here on; returns the list
    and an undo."""
    from repro_torch.serve.batcher import ServingEngine

    engines, init = [], ServingEngine.__init__

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        engines.append(self)

    ServingEngine.__init__ = recording_init

    def undo():
        ServingEngine.__init__ = init
    return engines, undo


def time_loop_runs():
    """Time every ``ContinuousBatcher.run`` from here on on the host clock,
    the serving loop's whole window (the engine's warm-up is before it);
    returns the list of seconds and an undo."""
    import torch
    from repro_torch.serve.batcher import ContinuousBatcher

    windows, run = [], ContinuousBatcher.run

    def timed_run(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(self, *args, **kwargs)
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - t0)
        return out

    ContinuousBatcher.run = timed_run

    def undo():
        ContinuousBatcher.run = run
    return windows, undo


def compile_report(engines, plans=None, tag: str = "") -> dict:
    """What the engines' compiled steps did: one graph per step and key,
    each captured at its first call and replayed at every later one, with
    the capture seconds and the pool's growth.  With ``plans`` (a run on
    the simulated fabric, whose every plan runs on the engine), the decode
    and prefill calls must equal the run's decode and prefill steps."""
    stats = [st for eng in engines for step in eng.compiled_steps()
             for st in step.stats()]
    missed = [st["step"] for eng in engines for step in eng.compiled_steps()
              for st in step.stats()
              if eng.device.type == "cuda" and not st["captured"]]
    if missed:
        raise AssertionError(f"{tag}: compiled steps not captured: {missed}")
    calls = {"decode": 0, "prefill": 0}
    for st in stats:
        calls["decode" if st["step"] == "decode" else "prefill"] += st["calls"]
    if plans is not None:
        want = {k: sum(p.kind == k for p in plans) for k in calls}
        if calls != want:
            raise AssertionError(f"{tag}: compiled steps called {calls}, "
                                 f"the run has {want} steps")
    return {"graphs": len(stats), "calls": calls,
            "replays": sum(st["calls"] - 1 for st in stats),
            "capture_s": {st["step"]: st["capture_s"] for st in stats},
            "capture_s_total": sum(st["capture_s"] for st in stats),
            "pool_bytes": sum(st["pool_bytes"] for st in stats),
            "pool_bytes_by_step": {st["step"]: st["pool_bytes"]
                                   for st in stats},
            "launches_per_replay": {st["step"]: st["launches_per_replay"]
                                    for st in stats}}


def _log_compile(tag: str, rep: dict) -> None:
    log(f"[{tag}] compiled steps: {rep['graphs']} graphs captured in "
        f"{rep['capture_s_total']:.2f} s ("
        + ", ".join(f"{k} {v:.3f} s" for k, v in rep["capture_s"].items())
        + f"), {rep['replays']} replays; calls {rep['calls']}; pool "
        f"{gib(rep['pool_bytes'])} ("
        + ", ".join(f"{k} +{gib(v)}" for k, v in
                    rep["pool_bytes_by_step"].items()) + ")")


def _check_requests(reqs, vocab: int, tag: str) -> None:
    """Every request completed, was rejected at admission, or was dropped
    (FAILED); a completed one has gen_len tokens, each in the vocabulary."""
    from repro_torch.serve import RequestState

    ends = (RequestState.DONE, RequestState.REJECTED, RequestState.FAILED)
    for r in reqs:
        if r.state not in ends:
            raise AssertionError(f"{tag}: request {r.rid} ended {r.state}")
        if r.state is RequestState.DONE:
            toks = r.generated
            if len(toks) != r.gen_len or toks.min() < 0 or \
                    toks.max() >= vocab:
                raise AssertionError(f"{tag}: request {r.rid}: tokens {toks}")


def phase_explorer() -> tuple[dict, object]:
    """The explorer on the paper's space, ``run_sweep`` serially and over
    EXPLORER_WORKERS worker processes: the CPU's work, run from the card's
    process (the workers import torch and touch no card).  Both must give
    the same results, the pool must really have run (the runner falls back
    to a serial sweep when its pool fails), and the front must hold the
    co-design point (multicast dispatch, credit sync) with the paper's
    gain over the baseline.  Returns the record and that point."""
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.dse import PAPER_SPACE, front, run_sweep, runner

    completed = []       # one entry per design a pool worker evaluated

    class CountingPool(ProcessPoolExecutor):
        def submit(self, *args, **kwargs):
            fut = super().submit(*args, **kwargs)
            fut.add_done_callback(
                lambda f: f.exception() is None and completed.append(1))
            return fut

    def plain(r) -> str:
        return json.dumps({**r.as_dict(), "runtimes": sorted(r.runtimes.items()),
                           "speedups": sorted(r.speedup_vs_baseline.items())},
                          sort_keys=True)

    t0 = time.perf_counter()
    serial = run_sweep(PAPER_SPACE, workers=1)
    serial_s = time.perf_counter() - t0
    runner.ProcessPoolExecutor = CountingPool
    try:
        t0 = time.perf_counter()
        parallel = run_sweep(PAPER_SPACE, workers=EXPLORER_WORKERS)
        parallel_s = time.perf_counter() - t0
    finally:
        runner.ProcessPoolExecutor = ProcessPoolExecutor
    if len(completed) != len(serial):
        raise AssertionError(f"the {EXPLORER_WORKERS}-worker pool completed "
                             f"{len(completed)} of {len(serial)} "
                             "designs (the sweep fell back to serial)")
    if [plain(r) for r in parallel] != [plain(r) for r in serial]:
        raise AssertionError("the parallel sweep differs from the serial one")
    fr = front(serial)
    ext = next((r for r in fr if r.point.is_paper_extended), None)
    if ext is None:
        raise AssertionError(f"the front {[r.point.name for r in fr]} lacks "
                             "the co-design point")
    gain = ext.speedup_vs_baseline[CODESIGN_CELL]
    if abs(gain - CODESIGN_GAIN) > CODESIGN_TOL:
        raise AssertionError(f"co-design speedup {gain} at {CODESIGN_CELL}, "
                             f"expected {CODESIGN_GAIN} +- {CODESIGN_TOL}")
    res = {"designs": len(serial), "workers": EXPLORER_WORKERS,
           "serial_s": serial_s, "parallel_s": parallel_s,
           "front": [r.point.name for r in fr], "codesign": ext.point.name,
           "speedup_at": list(CODESIGN_CELL), "speedup": gain,
           "best_speedup": ext.best_speedup, "mape_pct": ext.mape_pct,
           "model": ext.as_dict()["model"], "breakeven_n": ext.breakeven_n}
    log(f"[explorer] run_sweep over the paper space: {len(serial)} designs, "
        f"serial {serial_s:.3f} s and {EXPLORER_WORKERS} worker processes "
        f"{parallel_s:.3f} s (all {len(completed)} designs on the "
        f"pool), identical; front {res['front']}")
    log(f"[explorer] co-design point [{ext.point.name}]: speedup "
        f"{gain:.4f}x over the paper baseline at (M, N) = {CODESIGN_CELL} "
        f"(+{100 * (gain - 1):.1f} %; paper 47.9 %), best {ext.best_speedup:.4f}x; "
        f"Eq.-1 refit alpha {ext.model.alpha:.1f} beta {ext.model.beta:.4f} "
        f"gamma {ext.model.gamma:.4f}, MAPE {ext.mape_pct:.3f} %; "
        f"break-even N {ext.breakeven_n}")
    return res, ext.point


def phase_design_point(dev, point) -> dict:
    """A swept design point served: ``serve_workload`` on the stream trace
    with ``design=point`` (its simulated fabric and its own Eq.-1 prior),
    chatglm3-6b at full width, fused decode.  The kernel must launch once
    per attention layer for every decode step the engine ran (there is no
    warm-up on the simulated fabric), and every credit read must be at its
    threshold."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.sync import credit_threshold
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.serve import ServeConfig, serve_workload

    cfg = get_config(ARCH)
    n_attn = attention_layers(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    mem_before = torch.cuda.memory_allocated(dev)
    reads, undo = _record_credit_reads()
    try:
        LAUNCHES["decode_attention"] = 0
        t0 = time.perf_counter()
        out = serve_workload(stream_spec(), config=ServeConfig(
            arch=ARCH, reduced=False, fused_decode=True, design=point,
            device=dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = LAUNCHES["decode_attention"]
    finally:
        undo()
    m, plans = out["metrics"], out["plans"]
    steps = sum(p.kind == "decode" for p in plans)
    if launches != n_attn * steps:
        raise AssertionError(f"kernel launched {launches} times serving "
                             f"[{point.name}], expected {n_attn} x {steps}")
    threshold = credit_threshold()
    if len(reads) != len(plans) or any(r != threshold for r in reads):
        raise AssertionError(f"{len(reads)} credit reads for {len(plans)} "
                             f"jobs, below threshold: "
                             f"{[r for r in reads if r != threshold]}")
    _check_requests(out["requests"], cfg.vocab_size, "design point")
    if (m.admitted + m.rejected != STREAM_REQUESTS
            or m.completed != m.admitted or m.dropped):
        raise AssertionError(f"admitted {m.admitted}, rejected {m.rejected},"
                             f" completed {m.completed}, dropped {m.dropped}")
    snap = out["calibration"]
    summ = m.summary()
    res = {"design": point.name, "arch": ARCH, "layers": cfg.num_layers,
           "requests": STREAM_REQUESTS, "admitted": m.admitted,
           "rejected": m.rejected, "completed": m.completed,
           "prefill_steps": sum(p.kind == "prefill" for p in plans),
           "decode_steps": steps, "offloaded_decode_jobs": m.decode_jobs,
           "launches": launches, "credit_reads": len(reads),
           "calibration": snap.as_dict(),
           "latency_p50_us": summ["latency_us"]["p50"],
           "latency_p99_us": summ["latency_us"]["p99"],
           "step_p50_ms": summ["wall"]["step_p50_ms"],
           "memory_allocated_before": mem_before,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "serve_wall_s": wall}
    card = card_line()
    log(f"[design] {card}: {ARCH} full width on the simulated fabric of "
        f"[{point.name}], {STREAM_REQUESTS} requests at {STREAM_RATE:g} "
        f"req/s (seed {STREAM_SEED}), fused decode: admitted {m.admitted}, "
        f"rejected {m.rejected}, completed {m.completed}; {res['prefill_steps']}"
        f" prefill and {steps} decode steps ({m.decode_jobs} offloaded); "
        f"kernel launches {launches} == {n_attn} x {steps}; credit reads "
        f"{len(reads)}/{len(plans)} at threshold")
    log(f"[design] {card}: prior = the design's Eq.-1 refit, calibrated "
        f"[{snap.source}, {snap.n_samples} samples] alpha {snap.alpha:.1f} "
        f"beta {snap.beta:.4f} gamma {snap.gamma:.4f} (cycles); latency p50 "
        f"{res['latency_p50_us']:.1f} us, p99 {res['latency_p99_us']:.1f} us "
        f"(virtual); engine step p50 {res['step_p50_ms']:.2f} ms; "
        f"max_memory_allocated {gib(res['max_memory_allocated'])}; wall "
        f"{wall:.1f} s")
    return res


def chaos_spec(requests: int = STREAM_REQUESTS):
    from repro_torch.serve import WorkloadSpec
    return WorkloadSpec(num_requests=requests, **CHAOS_TRAFFIC)


def run_fleet(dev, spec, arch, params, faults: str | None = None,
              tag: str = "fleet", compare: bool = True) -> tuple[dict, dict]:
    """``serve_fleet`` on FLEET_SIZES, pipelined, one engine per lane on the
    card, all lanes reading ``params``; with ``faults``, restore recovery.
    Routing and the schedule are cycle-model decisions, so with
    ``compare`` the routes, each lane's counts and the fleet summary must
    equal those of the same call with a narrow model of the same
    vocabulary (``scaled_down``), hence the same trace.  The same call
    with ``execute=False`` is no such reference: it builds the trace
    without prompt tokens, whose draws interleave with the lengths' and
    deadlines', so it serves another trace; and with no engine the
    pipelined loop lets a prefill overlap any number of decodes, not one.
    Returns the record and the completed requests' token streams."""
    import torch
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.models import scaled_down
    from repro_torch.obs import Tracer
    from repro_torch.serve import FleetConfig, RequestState, serve_fleet
    from repro_torch.serve.batcher import model_config

    kw = dict(fleet=FLEET_SIZES, arch=arch, reduced=False, pipeline=True)
    if faults is not None:
        kw.update(faults=faults, recovery="restore")
    mcfg = model_config(arch, reduced=False)
    torch.cuda.reset_peak_memory_stats(dev)
    mem_before = torch.cuda.memory_allocated(dev)
    tracer = Tracer()     # its wall-domain spans split each lane's seconds
    LAUNCHES["decode_attention"] = 0
    t0 = time.perf_counter()
    out = serve_fleet(spec, config=FleetConfig(
        execute=True, params=params, device=dev, tracer=tracer, **kw))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES["decode_attention"]
    peak = torch.cuda.max_memory_allocated(dev)

    def routes(o):
        return json.dumps([dataclasses.asdict(d) for d in o["routes"]],
                          default=repr)

    def counts(o):
        return [(lm.admitted, lm.rejected, lm.completed, lm.prefill_jobs,
                 lm.decode_jobs, lm.restore_jobs, len(lane["requests"]))
                for lane in o["lanes"] for lm in [lane["metrics"]]]

    def summary(o):
        return json.dumps(o["metrics"].summary(), sort_keys=True, default=repr)

    compare_s = None
    if compare:
        narrow = replace(scaled_down(mcfg), vocab_size=mcfg.vocab_size)
        t0 = time.perf_counter()
        small = serve_fleet(spec, config=FleetConfig(
            execute=True, device=dev, **{**kw, "arch": narrow}))
        compare_s = time.perf_counter() - t0
        for what, fn in (("routes", routes), ("per-lane counts", counts),
                         ("FleetMetrics.summary()", summary)):
            if fn(out) != fn(small):
                raise AssertionError(f"{tag}: the {what} differ from those "
                                     "of the same call with a narrow model")
    if launches:
        raise AssertionError(f"{tag}: the fleet decodes unfused, yet the "
                             f"decode kernel launched {launches} times")
    reqs = out["requests"]
    _check_requests(reqs, mcfg.vocab_size, tag)
    failed = sorted(r.rid for r in reqs if r.state is RequestState.FAILED)
    if failed != out["dropped"]:
        raise AssertionError(f"{tag}: failed {failed}, dropped "
                             f"{out['dropped']}")
    summ = out["metrics"].summary()
    ft = summ["faults"]
    lanes = []
    for lane, o in zip(out["fleet"].lanes, out["lanes"]):
        lm = o["metrics"]
        walls = {k: sum(e.dur for e in tracer.events
                        if e.domain == "wall_s" and e.proc == lane.name
                        and e.name == k) for k in ("prefill", "decode")}
        lanes.append({"lane": lane.name, "admitted": lm.admitted,
                      "rejected": lm.rejected, "completed": lm.completed,
                      "decode_steps": sum(p.kind == "decode"
                                          for p in o["plans"]),
                      "prefill_steps": sum(p.kind in ("prefill", "restore")
                                           for p in o["plans"]),
                      "engine_s": lm.step_wall_s.total(),
                      "prefill_s": walls["prefill"],
                      "decode_s": walls["decode"]})
    requeued = sorted(r.rid for r in reqs if r.requeues)
    restored = {r.rid: r.restore_len for r in reqs if r.restore_len > 0}
    if faults is not None:
        if out["dead_lanes"] != [1] or not ft["orphaned"] or \
                ft["requeued"] != ft["orphaned"] or \
                len(requeued) != ft["orphaned"]:
            raise AssertionError(f"{tag}: dead lanes {out['dead_lanes']}, "
                                 f"faults {ft}")
        if len(restored) != sum(r.rid in restored and r.state is
                                RequestState.DONE for r in reqs):
            raise AssertionError(f"{tag}: a restored request did not "
                                 "complete")
    res = {"sizes": list(FLEET_SIZES), "layers": mcfg.num_layers,
           "dtype": mcfg.dtype, "requests": spec.num_requests,
           "traffic": {"rate_rps": spec.rate_rps,
                       "slo_fraction": spec.slo_fraction, "seed": spec.seed},
           "faults": faults, "admitted": summ["admitted"],
           "rejected": summ["rejected"], "completed": summ["completed"],
           "lanes": lanes, "launches": launches, "fault_counts": ft,
           "dead_lanes": out["dead_lanes"], "dropped": out["dropped"],
           "requeued": requeued, "restored": restored,
           "latency_p99_us": summ["latency_us"]["p99"],
           "imbalance": summ["imbalance"], "compared_narrow": compare,
           "compare_s": compare_s,
           "memory_allocated_before": mem_before,
           "max_memory_allocated": peak, "wall_s": wall}
    streams = {r.rid: r.generated.tolist() for r in reqs
               if r.state is RequestState.DONE}
    return res, streams


def _log_fleet(tag: str, res: dict) -> None:
    card = card_line()
    per_lane = "; ".join(
        f"{ln['lane']} admitted {ln['admitted']} rejected {ln['rejected']} "
        f"completed {ln['completed']}, {ln['prefill_steps']} prefill and "
        f"{ln['decode_steps']} decode steps, engine {ln['engine_s']:.2f} s "
        f"(prefill {ln['prefill_s']:.2f} s, decode {ln['decode_s']:.2f} s)"
        for ln in res["lanes"])
    log(f"[{tag}] {card}: {ARCH} {res['layers']} layers {res['dtype']}, "
        f"fleet {'+'.join(map(str, res['sizes']))} pipelined, "
        f"{res['requests']} requests {res['traffic']}"
        + (f", faults {res['faults']} (restore)" if res["faults"] else "")
        + f": admitted {res['admitted']}, rejected {res['rejected']}, "
        f"completed {res['completed']}; {per_lane}")
    same = ("routes, per-lane counts and FleetMetrics.summary() equal the "
            f"narrow model's run ({res['compare_s']:.1f} s); "
            if res["compared_narrow"] else "")
    log(f"[{tag}] {card}: {same}decode-kernel launches "
        f"{res['launches']} (unfused); wall {res['wall_s']:.1f} s; "
        f"max_memory_allocated {gib(res['max_memory_allocated'])} (before "
        f"{gib(res['memory_allocated_before'])})")
    if res["faults"]:
        log(f"[{tag}] {card}: dead lanes {res['dead_lanes']}; faults "
            f"{res['fault_counts']}; requeued {res['requeued']}; restored "
            f"from lane 1's checkpoints {res['restored'] or 'none'}; dropped "
            f"{res['dropped']}")


def phase_fleet(dev) -> dict:
    """A three-lane fleet at full width, one bf16 weight tree on the card
    read by every lane: the stream trace (c), the CI chaos step's traffic
    with its crash (d), and the step's 96 requests with a crash that
    catches a request mid-decode (its decode state restored)."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    params = init_params(get_config(ARCH), seed=0, device=dev)
    torch.cuda.synchronize()
    res = {"weights_bytes": sum(t.numel() * t.element_size()
                                for t in pytree.tree_leaves(params))}
    for tag, spec, faults in (
            ("fleet", stream_spec(), None),
            ("fleet-chaos", chaos_spec(), CHAOS_FAULTS),
            ("fleet-restore", chaos_spec(RESTORE_REQUESTS), RESTORE_FAULTS)):
        res[tag], _ = run_fleet(dev, spec, ARCH, params, faults, tag)
        _log_fleet(tag, res[tag])
    if not res["fleet-restore"]["restored"]:
        raise AssertionError("fleet-restore: no request resumed from lane "
                             "1's checkpoints")
    return res


def phase_fleet_tokens(dev) -> dict:
    """The chaos runs' token streams against the fault-free run's, at full
    width, depth cut to FLEET_CHECK_LAYERS, f32: a finding, not a gate (a
    requeued request is prefilled again, and a restored one resumes from
    its checkpoint)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = replace(get_config(ARCH), num_layers=FLEET_CHECK_LAYERS,
                  dtype="float32")
    params = init_params(cfg, seed=0, device=dev)
    res = {}
    for tag, spec, faults in (
            ("chaos", chaos_spec(), CHAOS_FAULTS),
            ("restore", chaos_spec(RESTORE_REQUESTS), RESTORE_FAULTS)):
        t0 = time.perf_counter()
        _, clean = run_fleet(dev, spec, cfg, params, None, f"{tag}-clean",
                             compare=False)
        crashed, streams = run_fleet(dev, spec, cfg, params, faults, tag,
                                     compare=False)
        same = sorted(rid for rid in streams if streams[rid] == clean.get(rid))
        requeued = [rid for rid in crashed["requeued"]
                    if rid in streams and rid not in crashed["restored"]]
        res[tag] = {"faults": faults, "completed": len(streams),
                    "equal": len(same), "requeued_completed": len(requeued),
                    "requeued_equal": sum(rid in same for rid in requeued),
                    "restored": crashed["restored"],
                    "restored_equal": sum(int(rid) in same
                                          for rid in crashed["restored"]),
                    "wall_s": time.perf_counter() - t0}
        log(f"[fleet-tokens] {ARCH} {FLEET_CHECK_LAYERS} layers f32, "
            f"{spec.num_requests} requests, {faults}: {len(same)} of "
            f"{len(streams)} completed requests emit the fault-free run's "
            f"token stream; of the {len(requeued)} requeued and prefilled "
            f"again, {res[tag]['requeued_equal']}; restored "
            f"{crashed['restored'] or 'none'}, equal "
            f"{res[tag]['restored_equal']} ({res[tag]['wall_s']:.1f} s for "
            "both runs)")
    return res


def _kind(name: str) -> str:
    if "decode_attention" in name:
        return "decode_attention"
    if any(k in name.lower() for k in ("gemm", "gemv", "splitk", "cutlass",
                                       "nvjet", "xmma")):
        return "matmul"
    return "other"


def weight_bound(params, cfg) -> dict:
    """Bytes of the weights one decode step reads, each once: every leaf
    but the embedding table (of which it gathers B rows; a tied table is
    the LM head and is read whole), over the HBM rate; for an MoE, the
    expert leaves apart (the dense capacity dispatch runs every expert)."""
    from torch.utils import _pytree as pytree
    total = sum(t.numel() * t.element_size()
                for t in pytree.tree_leaves(params))
    if not cfg.tie_embeddings:
        e = params["embed"]
        total -= e.numel() * e.element_size()
    experts = sum(t.numel() * t.element_size()
                  for g in params["groups"] if "moe" in g
                  for name, t in g["moe"].items() if name != "w_router")
    return {"weight_bytes": total,
            "bound_ms": total / HBM_BYTES_PER_S * 1e3,
            "expert_bytes": experts,
            "expert_bound_ms": experts / HBM_BYTES_PER_S * 1e3}


def phase_profile(dev, warm=8, steps=4, max_len=160, prompt_len=128,
                  lens=None, tag="profile", arch=ARCH, mesh=None) -> dict:
    """Where a full-width decode step's time goes: host wall per step vs
    device time by kernel kind (torch.profiler over a few warm steps),
    beside the least time the step's weight reads take.  The engine's
    steps are compiled: the first decode captures its graph, the later
    ones replay it.  The report adds the host ops the profiler saw per
    step and its graph launches, the device time of back-to-back replays
    (CUDA events), each graph's capture seconds, the pool's growth and
    the memory allocated and reserved with the graphs held.

    ``lens`` (one per slot) decodes each slot at its own length, as the
    streaming path does; by default every slot decodes at ``prompt_len``
    onwards."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.batcher import ServingEngine

    torch.cuda.reset_peak_memory_stats(dev)
    eng = ServingEngine(arch, reduced=False, max_batch=4, max_len=max_len,
                        fused_decode=True, device=dev, mesh=mesh,
                        mesh_shape=(1, 1) if mesh is None
                        else tuple(mesh.shape))
    wb = weight_bound(eng.params, eng.cfg)
    prompt = np.random.default_rng(1).integers(
        0, eng.cfg.vocab_size, (4, prompt_len), dtype=np.int32)
    tok, caches, _ = eng.prefill(prompt)
    pos = (np.full(4, prompt_len, np.int32) if lens is None
           else np.asarray(lens, np.int32))
    walls, queue = [], []
    for _ in range(warm):
        t0 = time.perf_counter()
        pend = eng.decode_async(tok[:, None], caches, pos)
        queue.append(time.perf_counter() - t0)
        tok, caches, w = eng.wait_step(pend)
        walls.append(w)
        pos = pos + 1
    prof_walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(steps):
            tok, caches, w = eng.decode(tok[:, None], caches, pos)
            prof_walls.append(w)
            pos = pos + 1
    by_kind = {"decode_attention": 0.0, "matmul": 0.0, "other": 0.0}
    attn_parts = {"scores": 0.0, "stats": 0.0, "pv": 0.0}
    n_attn, top, host_ops, graph_launches, launch_us = 0, [], 0, 0, 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host_ops += e.count
            if "cudaGraphLaunch" in e.key:
                graph_launches += e.count
                launch_us += e.cpu_time_total
            continue   # host ops also carry their kernels' device time
        us = _device_us(e)
        if us > 0:
            by_kind[_kind(e.key)] += us / 1e3 / steps
            top.append((us / 1e3 / steps, e.count // steps, e.key[:90]))
            if _kind(e.key) == "decode_attention":
                n_attn += e.count
                for part in attn_parts:
                    if f"decode_attention_{part}" in e.key:
                        attn_parts[part] += us / 1e3 / steps
    top.sort(reverse=True)
    replay_ms = None
    graphs = eng._dec_jit.graphs()
    if graphs:
        # Back-to-back replays of the decode graph, no host in between.
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        torch.cuda.synchronize()
        start.record()
        for _ in range(steps):
            graphs[0].replay()
        end.record()
        end.synchronize()
        replay_ms = start.elapsed_time(end) / steps
    compiled = compile_report([eng], tag=tag)
    wall_ms = statistics.median(walls) * 1e3
    # Busy and wall time both of the profiled steps.
    prof_wall_ms = sum(prof_walls) / steps * 1e3
    busy_ms = sum(by_kind.values())
    first = pos - warm - steps
    res = {"arch": arch,
           "shape": f"B=4, S={max_len} slots, lens {first.tolist()} + "
                    f"{warm}..{warm + steps - 1}, fused decode",
           "warm_steps": warm, "profiled_steps": steps, **wb,
           "step_wall_ms_median": wall_ms,
           "profiled_step_wall_ms": prof_wall_ms,
           "device_ms_per_step": by_kind,
           "attention_ms_per_step_by_pass": attn_parts,
           "device_busy_ms_per_step": busy_ms,
           "idle_share": 1.0 - busy_ms / prof_wall_ms if busy_ms else None,
           "idle_share_unprofiled":
               1.0 - busy_ms / wall_ms if busy_ms else None,
           "host_queue_ms_median": statistics.median(queue) * 1e3,
           "attention_kernels_per_step": n_attn / steps,
           "host_ops_per_step": host_ops / steps,
           "graph_launches_per_step": graph_launches / steps,
           "graph_launch_host_ms": launch_us / 1e3 / steps,
           "graph_replay_device_ms": replay_ms, "compiled": compiled,
           "memory_allocated": torch.cuda.memory_allocated(dev),
           "memory_reserved": torch.cuda.memory_reserved(dev),
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "max_memory_reserved": torch.cuda.max_memory_reserved(dev),
           "top_kernels_ms_calls_name": top[:10]}
    if busy_ms == 0:
        log(f"[{tag}] torch.profiler saw no device time")
    log(f"[{tag}] {arch}: {res['shape']}")
    log(f"[{tag}] decode step: host-measured {wall_ms:.3f} ms (median of "
        f"{warm}, unprofiled), {prof_wall_ms:.3f} ms (mean of the {steps} "
        f"profiled); device busy {busy_ms:.3f} ms = attention "
        f"kernel {by_kind['decode_attention']:.3f} + matmul "
        f"{by_kind['matmul']:.3f} + other {by_kind['other']:.3f} ms "
        f"({n_attn / steps:.0f} attention kernel launches per step, three "
        f"per call, four on a mesh: scores {attn_parts['scores']:.3f} + stats "
        f"{attn_parts['stats']:.3f} + p@V {attn_parts['pv']:.3f} ms); idle "
        f"share {res['idle_share']}")
    log(f"[{tag}] {card_line()}: queueing a step (placement, input "
        f"copies, replay, output copies) {res['host_queue_ms_median']:.3f} "
        f"ms of host time (median of {warm}); idle share against the "
        f"unprofiled step {res['idle_share_unprofiled']}")
    log(f"[{tag}] {card_line()}: {res['host_ops_per_step']:.0f} host events "
        f"and {res['graph_launches_per_step']:.0f} cudaGraphLaunch "
        f"({res['graph_launch_host_ms']:.3f} ms of host time) per "
        f"profiled step; back-to-back replays of the decode graph "
        f"{replay_ms} ms of device time each (CUDA events); "
        f"max_memory_allocated {gib(res['max_memory_allocated'])}, "
        f"max_memory_reserved {gib(res['max_memory_reserved'])} with the "
        f"graphs held")
    _log_compile(tag, compiled)
    log(f"[{tag}] bound: {wb['weight_bytes']} B of weights read once per "
        f"step / 3.35 TB/s = {wb['bound_ms']:.3f} ms"
        + (f" (the experts' {wb['expert_bytes']} B alone: "
           f"{wb['expert_bound_ms']:.3f} ms)" if wb["expert_bytes"] else ""))
    for ms, calls, name in top[:10]:
        log(f"[{tag}]   {ms:8.3f} ms/step  {calls:4d} calls  {name}")
    del eng, caches
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
    DX = importlib.import_module("repro_torch.kernels.daxpy")

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
    DX = importlib.import_module("repro_torch.kernels.daxpy")
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import LAUNCHES

    inputs = {n: _daxpy_inputs(n, dev) for n in DAXPY_SIZES}
    LAUNCHES["daxpy"] = 0
    outs = {n: ops.daxpy(2.5, x, y) for n, (x, y) in inputs.items()}
    torch.cuda.synchronize()
    launches = LAUNCHES["daxpy"]
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
    DX = importlib.import_module("repro_torch.kernels.daxpy")

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


def _sync_free(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``, which
    raises on any stream or device sync and on any blocking copy."""
    import torch
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def phase_train(dev) -> dict:
    """The training path at full width: ``train.build``'s compiled step
    (one CUDA graph, fused AdamW inside) under the supervisor for 8 steps;
    warm replays queued with no host sync, then timed unprofiled; one
    replay profiled; the graph dropped before the next phase."""
    import math

    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.launch import train
    from repro_torch.launch.compile import disable_compile

    cfg = train_cfg(TRAIN_LAYERS)
    _, _, step = train.build(cfg, reduced=False, opt=train_opt(TRAIN_STEPS),
                             fused_adamw=True, device=dev)
    ckpt_dir = REPO / "results" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats(dev)
    LAUNCHES["fused_adamw"] = 0
    t0 = time.perf_counter()
    out = train.run(cfg, step, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                    seq=TRAIN_SEQ, ckpt_dir=ckpt_dir,
                    ckpt_every=TRAIN_STEPS + 1, log_every=1, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES["fused_adamw"]
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
    stats = step.stats()
    if len(stats) != 1 or not stats[0]["captured"] \
            or stats[0]["calls"] != TRAIN_STEPS \
            or stats[0]["launches_per_replay"] != {"fused_adamw": n_leaves}:
        raise AssertionError(f"compiled train step: {stats}, expected one "
                             f"captured graph called {TRAIN_STEPS} times "
                             f"with {n_leaves} fused AdamW launches")
    [st] = stats
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
           "compile": st, "capture_s": st["capture_s"],
           "pool_bytes": st["pool_bytes"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "max_memory_reserved": torch.cuda.max_memory_reserved(dev),
           "optimizer_bound_ms": opt_bytes / HBM_BYTES_PER_S * 1e3,
           "rollback_checkpoint_bytes": ckpt_bytes, "wall_s": wall}
    log(f"[train] {ARCH} full width, depth cut to {TRAIN_LAYERS} layers "
        f"({n_params} params, {cfg.dtype}), {TRAIN_STEPS} supervised steps "
        f"of {TRAIN_BATCH} x {TRAIN_SEQ} through train.build's compiled "
        f"step: one graph captured in {st['capture_s']:.3f} s, step 0 eager "
        f"and steps 1-{TRAIN_STEPS - 1} replays; fused AdamW launches "
        f"{launches} == {n_leaves} x {TRAIN_STEPS}; no credit short, no "
        f"restart")
    log(f"[train] losses {[round(x, 4) for x in losses]}")
    log(f"[train] step seconds {[round(x, 4) for x in secs]} (host queueing "
        f"+ credit wait); steps 2-{TRAIN_STEPS}: {tokens_per_s:.0f} tokens/s "
        f"(all their tokens over all their seconds), median step "
        f"{warm:.4f} s; wall {wall:.1f} s (weights drawn on the card and the "
        f"{ckpt_bytes / 1e9:.2f} GB rollback checkpoint at step 0 included)")
    log(f"[train] {card_line()}: graph pool {gib(st['pool_bytes'])}; peak "
        f"allocated {gib(res['max_memory_allocated'])}, reserved "
        f"{gib(res['max_memory_reserved'])} with the graph held")

    # Warm replays: queued with no host sync (the pipeline's pinned copy
    # and the step's copy-in, replay and copy-out), then timed unprofiled.
    params, opt_state = out["params"], out["opt_state"]
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                   seed=5), dev)
    try:
        next(data)
        LAUNCHES["fused_adamw"] = 0
        for _ in range(TRAIN_SYNC_STEPS):
            params, opt_state, met = _sync_free(lambda: step(
                params, opt_state, {"tokens": next(data)}))
            if int(met["credits"]) != 1:
                raise AssertionError("a warm replay's credits fell short")
        if LAUNCHES["fused_adamw"] != n_leaves * TRAIN_SYNC_STEPS:
            raise AssertionError(f"{LAUNCHES['fused_adamw']} fused AdamW "
                                 f"launches in {TRAIN_SYNC_STEPS} replays")
        # The same steps timed replayed, then eager (disable_compile()) on
        # the same tensors, in this call.
        for mode in ("replay", "eager"):
            timed = []
            with contextlib.nullcontext() if mode == "replay" \
                    else disable_compile():
                for _ in range(TRAIN_TIMED_STEPS):
                    t0 = time.perf_counter()
                    tokens = next(data)
                    t1 = time.perf_counter()
                    params, opt_state, met = step(params, opt_state,
                                                  {"tokens": tokens})
                    t2 = time.perf_counter()
                    int(met["credits"])
                    timed.append((t1 - t0, t2 - t1,
                                  time.perf_counter() - t0))
            res[mode] = {k: statistics.median(t[i] * 1e3 for t in timed)
                         for i, k in enumerate(("dispatch_ms", "queueing_ms",
                                                "wall_ms"))}
            res[mode]["steps"] = timed
    finally:
        data.close()
    rp, eg = res["replay"], res["eager"]
    log(f"[train] {TRAIN_SYNC_STEPS} warm replays queued under "
        f"set_sync_debug_mode('error') with no sync ({n_leaves} fused AdamW "
        f"launches each); {TRAIN_TIMED_STEPS} unprofiled: median host wall "
        f"{rp['wall_ms']:.3f} ms per step (dispatch {rp['dispatch_ms']:.3f} + "
        f"queueing the replay {rp['queueing_ms']:.3f} + credit wait); the "
        f"same step under disable_compile(): {eg['wall_ms']:.3f} ms (queueing "
        f"{eg['queueing_ms']:.3f})")
    res["profile"] = profile_train_step(dev, cfg, step, out)
    prof = res["profile"]
    res["idle_share"] = 1.0 - prof["device_busy_ms"] / rp["wall_ms"]
    log(f"[train] {card_line()}: replayed step: host wall {rp['wall_ms']:.3f}"
        f" ms (unprofiled median), device busy "
        f"{prof['device_busy_ms']:.3f} ms (profiled), idle share "
        f"{res['idle_share']:.4f}; the eager step's host wall here "
        f"{eg['wall_ms']:.3f} ms")
    log(f"[train] optimizer device time per step "
        f"{prof['device_ms']['fused_adamw']:.3f} ms ({prof['adamw_launches']} "
        f"fused AdamW launches) beside its bound "
        f"{res['optimizer_bound_ms']:.3f} ms ({opt_bytes} B / 3.35 TB/s)")
    mem = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
    del step, out, params, opt_state, met, leaves
    gc.collect()
    torch.cuda.empty_cache()
    res["memory_before_after_drop"] = [*mem, torch.cuda.memory_allocated(dev),
                                       torch.cuda.memory_reserved(dev)]
    log(f"[train] dropping the train step's graph and state: allocated "
        f"{gib(mem[0])} -> {gib(torch.cuda.memory_allocated(dev))}, reserved "
        f"{gib(mem[1])} -> {gib(torch.cuda.memory_reserved(dev))}")
    return res


def _device_batches(cfg, dev, n: int, seed: int = 1) -> list:
    """``n`` token batches of TRAIN_BATCH x TRAIN_SEQ, on the card."""
    import torch
    from repro_torch.data import DataConfig, packed_batches
    it = packed_batches(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH, seed=seed))
    return [torch.from_numpy(next(it)).to(dev) for _ in range(n)]


def train_steps(dev, cfg, steps: int = TRAIN_CHECK_STEPS, *,
                compiled: bool = True, mesh=None) -> dict:
    """``steps`` steps of ``train.build``'s step (fused AdamW) from seed-0
    weights on seed-1 batches, compiled or under ``disable_compile()``;
    every step after the first is queued under the sync debug mode.
    Returns the losses, grad norms and final params (leaves), the fused
    AdamW launches and the compiled step's stats."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.launch import train
    from repro_torch.launch.compile import disable_compile
    from repro_torch.models import init_params
    from repro_torch.optim import init_opt_state

    _, _, step = train.build(cfg, reduced=False, opt=train_opt(TRAIN_STEPS),
                             fused_adamw=True, device=dev, mesh=mesh)
    params = init_params(cfg, seed=0, device=dev)
    if mesh is not None:
        from repro_torch.runtime.sharding import param_specs, to_shardings
        params = to_shardings(params, param_specs(params, cfg, mesh), mesh)
    opt_state = init_opt_state(params)
    batches = _device_batches(cfg, dev, steps)
    metrics = []
    LAUNCHES["fused_adamw"] = 0
    with contextlib.nullcontext() if compiled else disable_compile():
        for i, tokens in enumerate(batches):
            def one():
                return step(params, opt_state, {"tokens": tokens})
            params, opt_state, met = one() if i == 0 else _sync_free(one)
            metrics.append(met)
    torch.cuda.synchronize()

    def scalar(x):
        return float(x.full_tensor() if mesh is not None else x)

    return {"losses": [scalar(m["loss"]) for m in metrics],
            "grad_norms": [scalar(m["grad_norm"]) for m in metrics],
            "params": [p.full_tensor() if mesh is not None else p
                       for p in pytree.tree_leaves(params)],
            "launches": LAUNCHES["fused_adamw"],
            "stats": step.stats() if compiled else [],
            "credits": [int(m["credits"]) for m in metrics]}


def _check_compiled_run(tag: str, stats: list, launches: int, params,
                        steps: int) -> None:
    """One captured graph, called ``steps`` times, with the fused AdamW
    kernel launched once per leaf of 128 elements or more per step."""
    n = sum(p.ndim >= 1 and p.numel() >= 128 for p in params)
    if len(stats) != 1 or not stats[0]["captured"] \
            or stats[0]["calls"] != steps or launches != n * steps:
        raise AssertionError(f"{tag}: stats {stats}, {launches} fused AdamW "
                             f"launches (expected {n} x {steps})")


def _run_diff(a: dict, b: dict) -> dict:
    """Largest differences of two runs: relative in losses and grad norms,
    absolute in the final params."""
    def rel(x, y):
        return max(abs(u - v) / abs(v) for u, v in zip(x, y))
    return {"loss_rel": rel(a["losses"], b["losses"]),
            "grad_norm_rel": rel(a["grad_norms"], b["grad_norms"]),
            "param_abs": max(float((x - y).abs().max())
                             for x, y in zip(a["params"], b["params"]))}


def phase_train_compiled_vs_eager(dev) -> dict:
    """Each arch of TRAIN_CHECKS at full width, depth cut, f32: the compiled
    train step against ``disable_compile()`` from the same weights and
    batches.  Dense and SSM: losses, grad norms and final params bit-equal.
    The MoE: its differences within MOE_SPREAD_FACTOR times those between
    two eager runs."""
    import torch
    from repro_torch.configs import get_config

    res = {}
    for arch, layers in TRAIN_CHECKS.items():
        cfg = replace(get_config(arch), num_layers=layers, dtype="float32")
        comp = train_steps(dev, cfg)
        _check_compiled_run(f"{arch} compiled", comp["stats"],
                            comp["launches"], comp["params"],
                            TRAIN_CHECK_STEPS)
        if set(comp["credits"]) != {1}:
            raise AssertionError(f"{arch}: credits {comp['credits']}")
        gc.collect()
        torch.cuda.empty_cache()
        eager = train_steps(dev, cfg, compiled=False)
        out = {"layers": layers, "losses": comp["losses"],
               "grad_norms": comp["grad_norms"],
               "capture_s": comp["stats"][0]["capture_s"],
               "pool_bytes": comp["stats"][0]["pool_bytes"],
               "launches": comp["launches"], "eager_launches":
               eager["launches"]}
        if arch == MOE_ARCH:
            eager2 = train_steps(dev, cfg, compiled=False)
            spread = _run_diff(eager2, eager)
            del eager2
            diff = _run_diff(comp, eager)
            out.update(spread=spread, diff=diff)
            bad = [k for k in diff if diff[k] > MOE_SPREAD_FACTOR * spread[k]]
            if bad:
                raise AssertionError(f"{arch}: compiled vs eager {diff} "
                                     f"beyond {MOE_SPREAD_FACTOR} x the "
                                     f"eager-vs-eager spread {spread}")
            log(f"[train-check] {arch} {layers} layers f32, "
                f"{TRAIN_CHECK_STEPS} steps: compiled vs eager {diff}; "
                f"eager vs eager {spread} (limit {MOE_SPREAD_FACTOR} x)")
        else:
            equal = comp["losses"] == eager["losses"] and \
                comp["grad_norms"] == eager["grad_norms"] and \
                all(torch.equal(a, b) for a, b in zip(comp["params"],
                                                       eager["params"]))
            if not equal or comp["launches"] != eager["launches"]:
                raise AssertionError(f"{arch}: compiled {comp['losses']} / "
                                     f"{comp['grad_norms']} vs eager "
                                     f"{eager['losses']} / "
                                     f"{eager['grad_norms']}; differences "
                                     f"{_run_diff(comp, eager)}")
            log(f"[train-check] {arch} {layers} layers f32, "
                f"{TRAIN_CHECK_STEPS} steps: compiled and disable_compile() "
                f"losses, grad norms and final params bit-equal; losses "
                f"{[round(x, 5) for x in comp['losses']]}")
        log(f"[train-check] {arch}: capture {out['capture_s']:.3f} s, pool "
            f"{gib(out['pool_bytes'])}, fused AdamW launches "
            f"{comp['launches']} compiled, {eager['launches']} eager")
        res[arch] = out
        del comp, eager
        gc.collect()
        torch.cuda.empty_cache()
    return res


def check_train_rollback(dev) -> dict:
    """A supervised run of ``train.build``'s step (chatglm3-6b at full
    width, 2 layers, f32) with a NaN ``embeds`` batch at ROLLBACK_NAN_AT:
    compiled, the rollback restores into the held leaves, the ``embeds``
    key is captured once and the ``tokens`` graph replays after it; the
    final params equal the same run's under ``disable_compile()``."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.launch.compile import disable_compile
    from repro_torch.models import init_params
    from repro_torch.optim import init_opt_state
    from repro_torch.runtime.fault import StepSupervisor, SupervisorConfig

    cfg = train_cfg(2, "float32")
    steps = TRAIN_CHECK_STEPS
    # Steps before the fault, the NaN batch, then every step again from
    # the rollback point (the checkpoint at step 0).
    toks = _device_batches(cfg, dev, ROLLBACK_NAN_AT + 1 + steps, seed=3)
    runs = {}
    for compiled in (True, False):
        _, _, step = train.build(cfg, reduced=False,
                                 opt=train_opt(TRAIN_STEPS), fused_adamw=True,
                                 device=dev)
        params = init_params(cfg, seed=0, device=dev)
        state = (params, init_opt_state(params))
        drawn = pytree.tree_leaves(state)

        def batches():
            for i, t in enumerate(toks):
                if i == ROLLBACK_NAN_AT:
                    yield {"embeds": torch.full(
                        (TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), float("nan"),
                        device=dev), "labels": t}
                else:
                    yield {"tokens": t}

        def step_fn(state, batch):
            p, o, metrics = step(*state, batch)
            return (p, o), metrics

        ckpt_dir = REPO / "results" / f"rollback_ckpt_{int(compiled)}"
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        sup = StepSupervisor(step_fn, CheckpointManager(ckpt_dir, keep=1),
                             SupervisorConfig(ckpt_every=100),
                             credit_threshold=1)
        with contextlib.nullcontext() if compiled else disable_compile():
            state, rep = sup.run(state, batches(), steps)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        leaves = pytree.tree_leaves(state)
        held = all(a is b for a, b in zip(leaves, drawn))
        mode = "compiled" if compiled else "eager"
        if rep.restarts != 1 or rep.faults[0]["step"] != ROLLBACK_NAN_AT \
                or rep.steps_done != ROLLBACK_NAN_AT + steps or not held:
            raise AssertionError(f"rollback ({mode}): restarts "
                                 f"{rep.restarts}, faults {rep.faults}, "
                                 f"{rep.steps_done} steps, held leaves "
                                 f"kept: {held}")
        stats = step.stats() if compiled else []
        # tokens (one leaf): every good step; embeds + labels: once.
        by_key = sorted((len(st["key"]), st["calls"], st["captured"])
                        for st in stats)
        if compiled and by_key != [(1, ROLLBACK_NAN_AT + steps, True),
                                   (2, 1, True)]:
            raise AssertionError(f"rollback: compiled keys {stats}")
        runs[compiled] = (leaves, rep.steps_done, stats)
        del step, state, params
    (lc, n, stats), (le, _, _) = runs[True], runs[False]
    if not all(torch.equal(a, b) for a, b in zip(lc, le)):
        raise AssertionError("rollback: compiled and disable_compile() final "
                             "params differ")
    res = {"steps_done": n, "nan_at": ROLLBACK_NAN_AT,
           "graphs": [{k: st[k] for k in ("key", "calls", "capture_s")}
                      for st in stats]}
    log(f"[train-rollback] chatglm3-6b 2 layers f32: NaN embeds batch at "
        f"step {ROLLBACK_NAN_AT} caught by the credit counter, rolled back "
        f"into the held leaves; tokens graph {stats[0]['calls']} calls, "
        f"embeds graph captured once; final params equal "
        f"disable_compile()'s")
    return res


def phase_train_ssm(dev) -> dict:
    """mamba2-370m, the train CLI's default arch, at its full published
    size through ``train.build`` and ``train.run``, compiled."""
    import math

    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.launch import train

    steps = TRAIN_CHECK_STEPS
    cfg, _, step = train.build(SSM_ARCH, reduced=False,
                               opt=train_opt(TRAIN_STEPS), fused_adamw=True,
                               device=dev)
    if cfg != get_config(SSM_ARCH):
        raise AssertionError(f"{SSM_ARCH}: build changed the config")
    ckpt_dir = REPO / "results" / "ssm_train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats(dev)
    LAUNCHES["fused_adamw"] = 0
    out = train.run(cfg, step, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    ckpt_dir=ckpt_dir, ckpt_every=steps + 1, log_every=1,
                    device=dev)
    launches = LAUNCHES["fused_adamw"]
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    leaves = pytree.tree_leaves(out["params"])
    stats = step.stats()
    _check_compiled_run(SSM_ARCH, stats, launches, leaves, steps)
    if out["faults"] or not all(map(math.isfinite, out["losses"])):
        raise AssertionError(f"{SSM_ARCH}: faults {out['faults']}, losses "
                             f"{out['losses']}")
    [st] = stats
    res = {"arch": SSM_ARCH, "layers": cfg.num_layers,
           "params": sum(p.numel() for p in leaves), "dtype": cfg.dtype,
           "losses": out["losses"], "step_seconds": out["step_seconds"],
           "launches": launches, "capture_s": st["capture_s"],
           "pool_bytes": st["pool_bytes"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    log(f"[train-ssm] {SSM_ARCH} full size ({cfg.num_layers} layers, "
        f"{res['params']} params, {cfg.dtype}), {steps} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} compiled: losses "
        f"{[round(x, 4) for x in out['losses']]}, step seconds "
        f"{[round(x, 4) for x in out['step_seconds']]}; capture "
        f"{st['capture_s']:.3f} s, pool {gib(st['pool_bytes'])}, fused AdamW "
        f"launches {launches}")
    del step, out, leaves
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
    from torch.utils import _pytree as pytree

    from repro_torch.launch import train

    steps = 3
    cfg = train_cfg(2, "float32")
    opt = train_opt(TRAIN_STEPS)
    runs = {}
    for fused in (True, False):
        _, _, step = train.build(cfg, reduced=False, opt=opt,
                                 fused_adamw=fused, device=dev)
        ckpt_dir = REPO / "results" / f"opt_ckpt_{int(fused)}"
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        out = train.run(cfg, step, steps=steps, batch=TRAIN_BATCH,
                        seq=TRAIN_SEQ, ckpt_dir=ckpt_dir,
                        ckpt_every=steps + 1, log_every=1, device=dev)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        [st] = step.stats()
        if not st["captured"] or st["calls"] != steps:
            raise AssertionError(f"optimizer paths: compiled step {st}")
        runs[fused] = (out["losses"], pytree.tree_leaves(out["params"]))
        del out, step
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
    log(f"[optimizer] kernel vs plain, f32, 2 layers, {steps} steps, both "
        f"through train.build's compiled step (one graph each): losses "
        f"max rel diff {rel:.3e} <= 1e-5; params max|diff| {worst:.3e} "
        f"(<= 2 sum(lr) = {2 * lr_sum:.3e}); {n_over} of {n_all} beyond "
        f"{OPT_PARAM_TOL['abs']}")
    return res


# --------------------------------------------------------------------------- #
# 12. The multi-device and analysis layers
# --------------------------------------------------------------------------- #
def start_dry_runs() -> list:
    """Start the dry runs, one CPU process each (niced, one thread, no
    card), so they run beside the card's phases: the production cells of
    DRYRUN_CELLS through ``python -m repro_torch.launch.dryrun``, and the
    streaming decode step of phase 7 (chatglm3-6b, B=4, S = the trace's
    max_len, fused) on a 1x1 mesh.  Returns [(name, Popen, record path)]."""
    import os
    out = REPO / "results" / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    runs = []

    def start(name, cmd, path):
        if path.exists():
            path.unlink()
        log_file = open(out / f"{name}.log", "w")
        proc = subprocess.Popen(cmd, env=env, stdout=log_file,
                                stderr=subprocess.STDOUT, cwd=REPO,
                                preexec_fn=lambda: os.nice(19))
        runs.append((name, proc, path))

    for arch, shape, multi in DRYRUN_CELLS:
        mesh = "multi" if multi else "single"
        start(f"{arch}__{shape}__{mesh}",
              [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out", str(out)],
              out / f"{arch}__{shape}__{mesh}.json")
    s = stream_max_len()
    path = out / f"{ARCH}__stream_decode__1x1.json"
    code = (
        "import json, sys, torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.launch.dryrun import run_step\n"
        "from repro_torch.models import init_cache\n"
        f"cfg = get_config({ARCH!r})\n"
        "meta = lambda shape: torch.empty(shape, dtype=torch.int32, "
        "device='meta')\n"
        f"specs = {{'tokens': meta((4, 1)), 'caches': init_cache(cfg, 4, "
        f"max_len={s}, device='meta'), 'cache_len': meta((4,))}}\n"
        "rec = run_step(cfg, 'decode_32k', specs, (1, 1), fused=True)\n"
        f"rec.update(arch={ARCH!r}, shape='B=4, S={s}, fused decode', "
        "mesh='1x1', ok=True)\n"
        "open(sys.argv[1], 'w').write(json.dumps(rec, indent=1))\n")
    start(f"{ARCH}__stream_decode__1x1", [sys.executable, "-c", code,
                                           str(path)], path)
    return runs


def finish_dry_runs(runs, mesh_peak: int) -> dict:
    """Wait for the dry runs and report each record: per-device peak
    against the card's 80 GiB, FLOPs against ``cell_cost``, the collective
    census; the 1x1 streaming decode step's peak against the mesh serve's
    measured ``max_memory_allocated``.  A cell that failed fails the
    phase."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import config_for_shape
    from repro_torch.core.planner import H100_SXM
    from repro_torch.runtime.analytics import cell_cost

    recs = {}
    for name, proc, path in runs:
        t0 = time.perf_counter()
        rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
        if rc != 0 or not path.exists():
            raise AssertionError(f"dry run {name}: exit {rc}, see "
                                 f"results/dryrun/{name}.log")
        rec = json.loads(path.read_text())
        if not rec.get("ok"):
            raise AssertionError(f"dry run {name} failed: {rec.get('error')}")
        recs[name] = rec
        mem, cost = rec["memory"], rec["cost_analysis"]
        if name.endswith("__1x1"):
            cfg = get_config(ARCH)
            log(f"[dryrun] {name} ({rec['shape']}, fake 1x1 mesh): "
                f"arguments {gib(mem['argument_bytes'])} + temporaries "
                f"{gib(mem['temp_bytes'])} = peak {gib(mem['peak_bytes'])} "
                f"per device, against the mesh serve's measured "
                f"max_memory_allocated {gib(mesh_peak)} (which holds its "
                f"prefill jobs too); FLOPs {cost['flops']:.4e}")
            rec["measured_max_memory_allocated"] = mesh_peak
            continue
        cfg = config_for_shape(get_config(rec["arch"]), rec["shape"],
                               num_shards=rec["devices"])
        want = cell_cost(cfg, rec["shape"]).flops
        fits = mem["peak_bytes"] <= H100_SXM.hbm_bytes
        if rec["shape"] == "decode_32k":
            # Flash-decoding: chatglm3-6b's step has no all-gather as large
            # as one layer's local k cache (the caches are the step's
            # aliased arguments: k and v of every attention layer; an
            # MoE's expert weights are gathered in larger pieces).
            block = mem["alias_bytes"] // (2 * attention_layers(cfg))
            largest = rec["collectives"]["largest_op_bytes_by_kind"].get(
                "all-gather", 0)
            log(f"[dryrun] {name}: largest all-gather {largest} B, one "
                f"layer's local k cache {block} B")
            if rec["arch"] == ARCH and (largest >= block or abs(
                    cost["flops"] / want - 1) > 0.2):
                raise AssertionError(f"dry run {name}: largest all-gather "
                                     f"{largest} B against a cache block of "
                                     f"{block} B; FLOPs {cost['flops']:.4e} "
                                     f"against cell_cost's {want:.4e}")
        log(f"[dryrun] {name} on {rec['mesh']} ({rec['devices']} fake "
            f"ranks; ran {rec['compile_s']} s, waited "
            f"{time.perf_counter() - t0:.1f} s): per-device peak "
            f"{gib(mem['peak_bytes'])} ({'fits' if fits else 'exceeds'} "
            f"80 GiB; arguments {gib(mem['argument_bytes'])}, temporaries "
            f"{gib(mem['temp_bytes'])}); FLOPs {cost['flops']:.4e} = "
            f"{cost['flops'] / want:.3f} x cell_cost's {want:.4e}; "
            f"collectives per device "
            f"{rec['collectives']['per_device_bytes_total'] / 2**30:.2f} GiB"
            f" in {rec['collectives']['num_ops']} ops")
        for op in rec["collectives"]["ops_summary"]:
            log(f"[dryrun]   {op['kind']:15s} group {op['group_size']:3d}: "
                f"{op['count']:6d} ops, {op['bytes'] / 2**30:.3f} GiB")
        rec["cell_cost_flops"] = want
    return recs


def measure_step_launch(dev) -> dict:
    """The planner's host overheads on this card: the median
    queue-plus-credit time of an empty step (one int32 token placed by
    ``MulticastDispatcher.timed_put``, its credit emitted and read by
    ``CreditCounterSync.timed_wait``), and the median extra time of a
    ``SequentialDispatcher`` put per added leaf (one more host
    transaction)."""
    import numpy as np
    from repro_torch.core.dispatch import (MulticastDispatcher,
                                           SequentialDispatcher)
    from repro_torch.core.sync import CreditCounterSync, emit_credits

    multi, seq, sync = (MulticastDispatcher(), SequentialDispatcher(),
                        CreditCounterSync())
    tok = np.zeros((1, 1), np.int32)
    launch, one, two = [], [], []
    for i in range(LAUNCH_REPS + 20):
        t0 = time.perf_counter()
        placed, _ = multi.timed_put(tok, dev)
        sync.timed_wait(emit_credits({"t": placed.float()}))
        launch.append(time.perf_counter() - t0)
        one.append(seq.timed_put((tok,), dev)[1].seconds)
        two.append(seq.timed_put((tok, tok), dev)[1].seconds)
    step = statistics.median(launch[20:])
    per_dev = statistics.median(b - a for a, b in zip(one[20:], two[20:]))
    return {"step_launch_s": step, "per_device_dispatch_s": per_dev,
            "reps": LAUNCH_REPS}


def time_prefill(dev, reps: int = 3) -> float:
    """Median seconds of one 4 x 1024 prefill job of chatglm3-6b at full
    width on the plain path (placement, queueing, credit wait)."""
    import numpy as np
    from repro_torch.serve.batcher import ServingEngine
    eng = ServingEngine(ARCH, reduced=False, max_batch=4, max_len=1040,
                        fused_decode=True, device=dev)
    prompt = np.random.default_rng(2).integers(
        0, eng.cfg.vocab_size, (4, 1024), dtype=np.int32)
    eng.prefill(prompt)      # warm
    walls = [eng.prefill(prompt)[2] for _ in range(reps)]
    del eng
    return statistics.median(walls)


def planner_vs_card(results, launch: dict, prefill_s: float) -> dict:
    """``H100_SXM``'s step time for the streaming decode step (B=4, S =
    the trace's max_len) and for one 4 x 1024 prefill job, beside the
    measured ones: FLOPs from ``forward_flops``, bytes the weights (all
    but the embedding table, of which a step gathers rows) and the KV
    caches each job reads or writes."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.core.planner import H100_SXM, JobStats, roofline
    from repro_torch.core.planner import step_time
    from repro_torch.runtime.analytics import forward_flops

    cfg = get_config(ARCH)
    weights = 2 * (cfg.param_count() - cfg.vocab_padded * cfg.d_model)

    def kv(s):
        return (cfg.num_layers * 2 * 4 * s * cfg.num_kv_heads
                * cfg.qk_head_dim * 2)

    s = stream_max_len()
    measured = dc.replace(H100_SXM, **{k: launch[k] for k in
                                       ("step_launch_s",
                                        "per_device_dispatch_s")})
    prof = results["stream_profile"]
    mesh_prof = results["mesh"]["profile"]
    jobs = {
        "decode": (JobStats("decode", forward_flops(
            cfg, 4, 1, decode=True, cache_len=s), weights + kv(s)),
            {"plain device busy": prof["device_busy_ms_per_step"] / 1e3,
             "plain host wall": prof["step_wall_ms_median"] / 1e3,
             "mesh device busy":
                 mesh_prof["device_busy_ms_per_step"] / 1e3,
             "mesh host wall": mesh_prof["step_wall_ms_median"] / 1e3}),
        "prefill": (JobStats("prefill", forward_flops(cfg, 4, 1024),
                             weights + kv(1024)),
                    {"plain job wall": prefill_s})}
    out = {}
    for name, (stats, seen) in jobs.items():
        terms = roofline(stats, 1, H100_SXM)
        pred = step_time(stats, 1, H100_SXM)
        pred_m = step_time(stats, 1, measured)
        out[name] = {"flops": stats.flops, "hbm_bytes": stats.hbm_bytes,
                     "t_compute_s": terms.t_compute,
                     "t_memory_s": terms.t_memory,
                     "dominant": terms.dominant, "predicted_s": pred,
                     "predicted_with_measured_launch_s": pred_m,
                     "measured_s": seen}
        log(f"[planner] {card_line()}: {ARCH} {name} job: "
            f"{stats.flops:.4e} FLOPs, {stats.hbm_bytes} B -> compute "
            f"{terms.t_compute * 1e3:.4f} ms, memory "
            f"{terms.t_memory * 1e3:.4f} ms ({terms.dominant}-bound); "
            f"H100_SXM predicts {pred * 1e3:.4f} ms "
            f"({pred_m * 1e3:.4f} with this run's launch); measured "
            + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in seen.items()))
    log(f"[planner] {card_line()}: step_launch_s "
        f"{launch['step_launch_s'] * 1e6:.2f} us, per_device_dispatch_s "
        f"{launch['per_device_dispatch_s'] * 1e6:.2f} us (median of "
        f"{launch['reps']}; the committed H100_SXM holds "
        f"{H100_SXM.step_launch_s * 1e6:.2f} and "
        f"{H100_SXM.per_device_dispatch_s * 1e6:.2f} us)")
    return out


def _token_streams(dev, params, cfg, mesh=None, compiled=True) -> dict:
    """The stream trace's token streams on the simulated fabric, with the
    engine's compiled steps or under ``disable_compile()``."""
    from repro_torch.launch.compile import disable_compile
    from repro_torch.serve import RequestState, ServeConfig, serve_workload
    with contextlib.nullcontext() if compiled else disable_compile():
        out = serve_workload(stream_spec(), config=ServeConfig(
            arch=cfg, reduced=False, fused_decode=True, fabric="simulated",
            device=dev, params=params, mesh=mesh,
            mesh_shape=(1, 1) if mesh is None else tuple(mesh.shape)))
    return {r.rid: r.generated.tolist() for r in out["requests"]
            if r.state is RequestState.DONE}


def check_mesh_train(dev, mesh, train_checks) -> dict:
    """chatglm3-6b's train step at full width, 2 layers, f32, through
    ``mesh`` (DTensor params, moments and batch): compiled and under
    ``disable_compile()``, bit-equal to each other, and losses equal to
    the plain path's compiled run of phase 8."""
    import torch

    cfg = train_cfg(2, "float32")
    comp = train_steps(dev, cfg, mesh=mesh)
    _check_compiled_run("mesh train", comp["stats"], comp["launches"],
                        comp["params"], TRAIN_CHECK_STEPS)
    eager = train_steps(dev, cfg, compiled=False, mesh=mesh)
    plain = train_checks[ARCH]["losses"]
    same = comp["losses"] == eager["losses"] and \
        comp["grad_norms"] == eager["grad_norms"] and \
        all(torch.equal(a, b) for a, b in zip(comp["params"],
                                               eager["params"]))
    if not same or comp["losses"] != plain or set(comp["credits"]) != {1}:
        raise AssertionError(f"mesh train: compiled {comp['losses']}, "
                             f"disable_compile() {eager['losses']}, plain "
                             f"{plain}; credits {comp['credits']}; compiled "
                             f"vs eager {_run_diff(comp, eager)}")
    st = comp["stats"][0]
    log(f"[mesh] {card_line()}: chatglm3-6b train step, 2 layers f32, "
        f"through the 1x1 mesh: compiled (one graph, captured in "
        f"{st['capture_s']:.3f} s, {comp['launches']} fused AdamW launches) "
        f"and disable_compile() bit-equal; losses equal the plain path's "
        f"{[round(x, 5) for x in plain]}")
    return {"losses": comp["losses"], "grad_norms": comp["grad_norms"],
            "capture_s": st["capture_s"], "pool_bytes": st["pool_bytes"],
            "launches": comp["launches"]}


def phase_mesh(dev, results) -> dict:
    """chatglm3-6b served through a ``DeviceMesh``: an NCCL group of one
    rank, ``serve_workload(mesh=make_host_mesh(1, 1))`` on the stream
    trace's first MESH_REQUESTS requests at full width (DTensor params and
    caches, the decode kernels' slot-shard form on each device's block of
    the cache), its decode step profiled beside phase 7's, and the trace
    at 4 layers f32 on the simulated fabric with the mesh, token for token
    the plain path's."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.models import layers

    cfg4 = replace(get_config(ARCH), num_layers=STREAM_CHECK_LAYERS,
                   dtype="float32")
    params4 = init_params(cfg4, seed=0, device=dev)
    plain = _token_streams(dev, params4, cfg4)
    store = REPO / "results" / "nccl_store"
    store.parent.mkdir(exist_ok=True)
    if store.exists():
        store.unlink()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            rank=0, world_size=1,
                            store=dist.FileStore(str(store), 1))
    calls = []
    inner = layers._decode_on_slot_blocks
    layers._decode_on_slot_blocks = lambda *a, **k: (calls.append(1),
                                                     inner(*a, **k))[1]
    try:
        mesh = make_host_mesh(1, 1)
        res = {"backend": dist.get_backend(),
               "serve": phase_stream(dev, requests=MESH_REQUESTS, mesh=mesh,
                                     tag="mesh")}
        if not calls:
            raise AssertionError("the mesh serve never took the mesh's "
                                 "decode path")
        res["mesh_decode_calls"] = len(calls)
        s_len = results["stream"]["max_len"]
        res["profile"] = phase_profile(
            dev, max_len=s_len, prompt_len=256,
            lens=[256, 511, 767, s_len - 17], tag="mesh-profile", mesh=mesh)
        meshed = _token_streams(dev, params4, cfg4, mesh=mesh)
        meshed_eager = _token_streams(dev, params4, cfg4, mesh=mesh,
                                      compiled=False)
        res["train"] = check_mesh_train(dev, mesh, results["train_checks"])
    finally:
        layers._decode_on_slot_blocks = inner
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    for name, streams in (("mesh", meshed), ("mesh eager", meshed_eager)):
        bad = [rid for rid in plain if streams.get(rid) != plain[rid]]
        if bad or streams.keys() != plain.keys() or not plain:
            raise AssertionError(f"{name} and plain token streams differ "
                                 f"for requests {bad}")
    res["tokens_equal"] = {"requests": len(plain),
                           "tokens": sum(map(len, plain.values()))}
    pp, mp = results["stream_profile"], res["profile"]
    log(f"[mesh] {card_line()}: 4 layers f32, simulated fabric: mesh "
        f"(compiled), mesh under disable_compile() and plain (compiled) "
        f"token streams equal for {len(plain)} requests "
        f"({res['tokens_equal']['tokens']} tokens)")
    log(f"[mesh] {card_line()}: decode step at S={results['stream']['max_len']}"
        f": plain host {pp['step_wall_ms_median']:.3f} ms / device busy "
        f"{pp['device_busy_ms_per_step']:.3f} ms (phase 7), mesh host "
        f"{mp['step_wall_ms_median']:.3f} ms / device busy "
        f"{mp['device_busy_ms_per_step']:.3f} ms")
    del params4
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
    # Phase 12's dry runs: CPU processes beside the card's phases.
    dry_runs = start_dry_runs()
    try:
        return run_phases(dev, results, dry_runs, t_start)
    finally:
        for _, proc, _ in dry_runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_phases(dev, results, dry_runs, t_start) -> int:
    """Phases 3 to 13 (see the module docstring)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as DA

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    card = results["card"]
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {name}: {line.strip()}")
    results["sass"] = sass = sass_report()
    for kname, n in sass.items():
        log(f"[build] decode_attention SASS {kname}: {n['instructions']} "
            f"instructions, {n['hmma']} HMMA, {n['ldgsts']} LDGSTS")
    tc = [n for k, n in sass.items() if k.startswith(
        ("decode_attention_scores<bf16,bf16,1", "decode_attention_pv<bf16,bf16,1"))]
    if not tc or not all(n["hmma"] for n in tc):
        raise AssertionError(f"the tensor-core build has no HMMA: {sass}")

    # 3. Decode-attention kernel vs plain version.
    results["checks"] = [check_case(c, 0, dev) for c in CASES + EDGE_CASES]
    results["checks"] += [check_case(c, 0, dev, off)
                          for c, off in SCALAR_LOAD_CASES]
    results["checks"] += [check_case(FULL_CASE, s, dev) for s in range(3)]
    full_err = max(c["max_abs_err"] for c in results["checks"]
                   if c["case"] == FULL_CASE[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    s_cases = stream_cases(sms)
    s_nsplit, s_chunk = DA.split_plan(4, 2, s_cases[0][3], sms)
    log(f"[check] streaming shape S={s_cases[0][3]}: NSPLIT {s_nsplit}, "
        f"chunks of {s_chunk} slots")
    results["checks"] += [check_case(c, 0, dev) for c in s_cases]
    # ... at qwen3-moe's (G=8) and zamba2's shared-attention (G=1, D=64)
    # decode shapes.
    family_cases = {a: stream_cases(sms, a) for a in (MOE_ARCH, HYBRID_ARCH)}
    for cases in family_cases.values():
        results["checks"] += [check_case(c, 0, dev) for c in cases]
    # ... the streaming shapes and the G = 64 shape on the CUDA-core build
    # (bf16 calls take the tensor-core build by default) ...
    with DA.cuda_core_build():
        results["cuda_core_checks"] = [
            check_case(c, 0, dev) for c in
            s_cases + [c for cs in family_cases.values() for c in cs]
            + [BIG_SMEM_CASE]]
    # ... and the slot-shard form over P blocks of one cache.
    results["shard_checks"] = [check_shard_case(c, p, dev)
                               for c in SHARD_CASES for p in SHARD_COUNTS]
    free()

    # The engine queues its steps without a host sync; the kernel under
    # graph capture.
    results["no_sync"] = check_no_sync(dev)
    results["captured_kernel"] = check_captured_kernel(dev)
    free()
    # The prefill-attention kernel: against its plain version, then timed
    # at the benchmark cells' prefill shapes.
    results["prefill_attention"] = pa = phase_prefill_attention(dev)
    free()
    # The MoE router's expert-slot kernel: against its plain version,
    # captured, then timed at the cells' refill and decode shapes.
    results["moe_route"] = mr = phase_moe_route(dev)
    free()
    # The MoE's expert-FFN kernel: against its plain version at the cells'
    # decode shapes, captured and replayed under new routings, then timed.
    results["moe_experts"] = me = phase_moe_experts(dev)
    free()
    # kanana-2-30b-a3b's kernels counted per replay of its compiled steps.
    results["kanana_launches"] = phase_kanana_launches(dev)
    free()

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
    floor_ms = time_floor(FULL_CASE, dev)
    attend_ms = time_attend_only(FULL_CASE, dev)
    results["timing"] = {"shape": "B=4 S=160 H=32 K=2 D=128 W=32 bf16",
                         "lens": lens, "kernel_ms": kernel_ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "bytes": nbytes, "ops": ops,
                         "nsplit": nsplit, "chunk": chunk, **split,
                         "floor_ms": floor_ms,
                         "attend_only_sdpa_ms": attend_ms,
                         "l2": "flushed before each launch"}
    log(f"[time] fused_decode_attention at {results['timing']['shape']}, "
        f"lens {lens}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B / 3.35 TB/s, "
        f"{ops} ops)")
    log(f"[time] NSPLIT {nsplit} (chunks of {chunk} slots): scores "
        f"{split['scores_ms']} + stats {split['stats_ms']} + p@V "
        f"{split['pv_ms']} ms of device time per call (torch.profiler, mean "
        f"of {split['calls']} calls), whole call {kernel_ms:.4f} ms (CUDA "
        f"events); launch floor (as many empty kernels on the grid) "
        f"{floor_ms:.4f} ms; attend-only SDPA yardstick (another function) "
        f"{attend_ms:.4f} ms")
    del args, a_kernel, a_plain
    # ... and at the streaming shapes (lens drawn in [128, S)): chatglm3's,
    # qwen3-moe's and zamba2's shared attention's.
    for key, cases in (("stream_timing", s_cases),
                       *((f"stream_timing_{a}", c)
                         for a, c in family_cases.items())):
        results[key] = st = time_case(cases[-1], dev)
        log(f"[time] fused_decode_attention at {st['shape']} "
            f"({cases[-1][1]}), lens {st['lens']}: kernel "
            f"{st['kernel_ms']:.4f} ms (scores {st['scores_ms']} + stats "
            f"{st['stats_ms']} + p@V {st['pv_ms']} of device time; launch "
            f"floor {st['floor_ms']:.4f}; CUDA-core build "
            f"{st.get('cuda_core_ms')}), plain {st['plain_ms']:.4f} ms, "
            f"bound {st['bound_ms']:.6f} ms ({st['bound_by']}: "
            f"{st['bytes']} B); NSPLIT {st['nsplit']}")
    st = results["stream_timing"]
    # ... and the slot-shard form at chatglm3-6b's streaming shape and at
    # decode_32k's per-device shape, each pass beside the whole-cache
    # kernels.
    results["shard_timing"] = {c[0]: time_shards(c, dev)
                               for c in (SHARD_CASES[0], SHARD_CASES[-1])}
    sh = results["shard_timing"][SHARD_CASES[0][0]]
    free()

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
    # The streaming path: its launches counted from 0; then its trace,
    # depth cut, fused against unfused.
    results["stream"] = phase_stream(dev)
    free()
    results["stream_pipelined"] = sp = phase_stream(dev, pipeline=True,
                                                    sync_check=True)
    free()
    sc = results["stream"]
    log(f"[stream] {card}: decode wall per step, pipelined "
        f"{sp['decode_wall_ms_per_step']:.3f} ms ({sp['decode_tok_s']:.1f} "
        f"tok/s) against continuous {sc['decode_wall_ms_per_step']:.3f} ms "
        f"({sc['decode_tok_s']:.1f} tok/s); decode tokens over the loop's "
        f"window, pipelined {sp['window_decode_tok_s']:.1f} against "
        f"continuous {sc['window_decode_tok_s']:.1f} tok/s (a pipelined "
        "decode's wall leaves out its device time under the queueing of "
        "the refill prefill behind it); pipelined calibration "
        f"{sp['calibration']['source']}, continuous "
        f"{sc['calibration']['source']}")
    s_len = results["stream"]["max_len"]
    results["stream_profile"] = phase_profile(
        dev, max_len=s_len, prompt_len=256,
        lens=[256, 511, 767, s_len - 17], tag="stream-profile")
    free()
    results["stream_check"] = phase_stream_fused_vs_unfused(dev)
    free()

    # 7b. The MoE, SSM and hybrid families at full width on the streaming
    # path, each with its launches counted from 0 (every earlier phase's
    # weights and caches freed first); a profile of one qwen3-moe decode
    # step at the streaming shape; fused against unfused at reduced depth.
    results["moe_stream"] = phase_stream(dev, arch=MOE_ARCH)
    free()
    m_len = results["moe_stream"]["max_len"]
    results["moe_profile"] = phase_profile(
        dev, max_len=m_len, prompt_len=256, lens=[256, 511, 767, m_len - 17],
        tag="moe-profile", arch=MOE_ARCH)
    free()
    results["ssm_stream"] = phase_stream(dev, arch=SSM_ARCH,
                                         requests=FAMILY_REQUESTS)
    free()
    results["hybrid_stream"] = phase_stream(dev, arch=HYBRID_ARCH,
                                            requests=FAMILY_REQUESTS)
    free()
    results["family_checks"] = [
        phase_stream_fused_vs_unfused(dev, arch, layers)
        for arch, layers in FAMILY_CHECK_LAYERS.items()]
    free()

    # 8. Training at full width, depth cut: its main path (compiled),
    # launches from 0; compiled against disable_compile() at cut depth in
    # f32; a rollback into the held leaves; mamba2-370m at full size.
    results["train"] = phase_train(dev)
    free()
    results["train_checks"] = phase_train_compiled_vs_eager(dev)
    free()
    results["train_rollback"] = check_train_rollback(dev)
    free()
    results["train_ssm"] = phase_train_ssm(dev)
    free()

    # 9. Fused vs unfused decoding, teacher-forced.
    results["teacher_forced"] = phase_teacher_forced(dev)
    free()

    # 10. Kernel vs plain optimizer.
    results["optimizer_paths"] = phase_optimizer_paths(dev)
    free()

    # 11. The co-design explorer, a swept design point served (its decode
    # launches counted from 0), and a three-lane fleet with its chaos runs;
    # every earlier phase's weights freed first.
    t0 = time.perf_counter()
    mem = torch.cuda.memory_allocated(dev)
    log(f"[fleet] memory_allocated before the phase {gib(mem)}")
    results["explorer"], codesign = phase_explorer()
    results["design_point"] = phase_design_point(dev, codesign)
    free()
    results["design_point_check"] = phase_stream_fused_vs_unfused(
        dev, design=codesign)
    free()
    results["fleet"] = phase_fleet(dev)
    free()
    results["fleet_tokens"] = phase_fleet_tokens(dev)
    free()
    results["fleet_phase_s"] = time.perf_counter() - t0
    log(f"[fleet] memory_allocated after the phase "
        f"{gib(torch.cuda.memory_allocated(dev))}; phase "
        f"{results['fleet_phase_s']:.1f} s")

    # 12. The multi-device and analysis layers: the planner's host
    # overheads and a prefill job timed, chatglm3-6b through a DeviceMesh
    # (its launches counted from 0), the planner against the card, and the
    # dry runs' records.
    t0 = time.perf_counter()
    launch = measure_step_launch(dev)
    prefill_s = time_prefill(dev)
    free()
    results["mesh"] = phase_mesh(dev, results)
    free()
    results["planner"] = planner_vs_card(results, launch, prefill_s)
    results["planner"]["launch"] = launch
    results["dryrun"] = finish_dry_runs(
        dry_runs, results["mesh"]["serve"]["max_memory_allocated"])
    results["mesh_phase_s"] = time.perf_counter() - t0
    log(f"[mesh] phase {results['mesh_phase_s']:.1f} s")
    results["total_s"] = time.perf_counter() - t_start

    dx = results["daxpy_timing"][-1]            # n = 2^27, f32
    pt = next(t for t in pa["timing"]           # B=4, L=2048, chatglm3-6b
              if t["shape"] == "B=4 L=2048 H=32 K=2 D=128")
    aw = results["adamw_timing"]
    kernels = {"kernels": [
        {"name": "fused_decode_attention", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": REPLACES,
         "launches": results["serve"]["launches"], "max_abs_err": full_err,
         "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
         "scores_ms": split["scores_ms"], "stats_ms": split["stats_ms"],
         "pv_ms": split["pv_ms"], "floor_ms": floor_ms,
         "nsplit": nsplit, "bound_ms": bound_ms, "bound_by": bound_by,
         "library_ms": None,
         "sass_main_path": {k: [n["instructions"], n["hmma"]]
                            for k, n in results["sass"].items()
                            if "<bf16,bf16,1,1" in k},
         "attend_only_sdpa_ms": {
             "S=160": attend_ms, "S=1040": sh["attend_only_sdpa_ms"],
             "decode_32k": results["shard_timing"][SHARD_CASES[-1][0]][
                 "attend_only_sdpa_ms"]},
         "stream_launches": results["stream"]["launches"],
         "design_launches": results["design_point"]["launches"],
         "fleet_launches": sum(results["fleet"][t]["launches"]
                               for t in ("fleet", "fleet-chaos",
                                         "fleet-restore")),
         "stream_shape_ms": st["kernel_ms"],
         "stream_shape_plain_ms": st["plain_ms"],
         "stream_shape_bound_ms": st["bound_ms"],
         **{f"stream_shape_{k}": st[k] for k in (
             "scores_ms", "stats_ms", "pv_ms", "floor_ms", "cuda_core_ms")},
         **{f"{tag}_{key}": val
            for tag, arch in (("moe", MOE_ARCH), ("hybrid", HYBRID_ARCH))
            for key, val in (
                ("stream_launches", results[f"{tag}_stream"]["launches"]),
                ("shape_ms",
                 results[f"stream_timing_{arch}"]["kernel_ms"]),
                ("shape_plain_ms",
                 results[f"stream_timing_{arch}"]["plain_ms"]),
                ("shape_bound_ms",
                 results[f"stream_timing_{arch}"]["bound_ms"]),
                *((f"shape_{k}", results[f"stream_timing_{arch}"].get(k))
                  for k in ("scores_ms", "stats_ms", "pv_ms", "floor_ms",
                            "cuda_core_ms")))}},
        {"name": "fused_decode_attention_shard", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": REPLACES,
         "launches": results["mesh"]["serve"]["launches"],
         "max_abs_err": max(c["max_abs_err"]
                            for c in results["shard_checks"]),
         "ms": sh["one_block_ms"], "plain_ms": sh["one_block_plain_ms"],
         "bound_ms": sh["bound_ms"], "bound_by": sh["bound_by"],
         "library_ms": None,
         "floor_ms": sh["one_block_floor_ms"],
         "attend_only_sdpa_ms": sh["attend_only_sdpa_ms"],
         "decode_32k_one_block_ms": results["shard_timing"][
             SHARD_CASES[-1][0]]["one_block_ms"],
         "passes_ms": {name: {p: {k: t[k] for k in ("scores_ms", "stats_ms",
                                                    "pv_ms", "ms")}
                              for p, t in tm["shards"].items()}
                       for name, tm in results["shard_timing"].items()},
         "whole_ms": {name: tm["whole"]["ms"]
                      for name, tm in results["shard_timing"].items()}},
        {"name": "prefill_attention", "route": "cuda",
         "source": PREFILL_SOURCE, "replaces": PREFILL_REPLACES,
         "launches": results["stream"]["prefill_launches"],
         "max_abs_err": max(c["max_abs_err"] for c in pa["checks"]),
         "ms": pt["kernel_ms"], "plain_ms": pt["plain_ms"],
         "bound_ms": pt["bound_ms"], "bound_by": pt["bound_by"],
         "library_ms": None,
         "attend_only_sdpa_ms": pt["attend_only_sdpa_ms"],
         "shapes": {f"{t['cell']} {t['shape']}": {
             k: t[k] for k in ("kernel_ms", "plain_ms", "bound_ms",
                               "attend_only_sdpa_ms")}
             for t in pa["timing"]}},
        {"name": "moe_route", "route": "cuda", "source": MOE_ROUTE_SOURCE,
         "replaces": MOE_ROUTE_REPLACES,
         "launches": results["moe_stream"]["moe_route_launches"],
         "max_abs_err": 0,
         "ms": mr["timing"][0]["kernel_ms"],
         "plain_ms": mr["timing"][0]["plain_ms"],
         "bound_ms": mr["timing"][0]["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "shapes": {t["case"]: {k: t[k] for k in (
             "shape", "kernel_ms", "graph_ms", "plain_ms", "bound_ms")}
             for t in mr["timing"]}},
        {"name": "moe_experts", "route": "cuda",
         "source": MOE_EXPERTS_SOURCE, "replaces": MOE_EXPERTS_REPLACES,
         "launches": results["moe_stream"]["moe_experts_launches"],
         "max_abs_err": max(c["max_abs_err"] for c in me["checks"]),
         "ms": me["timing"][0]["kernel_ms"],
         "plain_ms": me["timing"][0]["plain_ms"],
         "bound_ms": me["timing"][0]["bound_ms"], "bound_by": "bytes",
         "library_ms": me["timing"][0]["dense_einsum_ms"],
         "shapes": {t["shape"]: {k: t[k] for k in (
             "dims", "live", "kernel_ms", "graph_ms", "plain_ms",
             "dense_einsum_ms", "bound_ms", "bound_share")}
             for t in me["timing"]}},
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
