"""Serve ``chip_smoke.py``'s streaming trace from several checkouts of the
repo in turn, on one card: an A/B of the port's serving loops; or, with
``--kernels``, time each checkout's decode-attention kernels on the same
inputs.

    python3 tools/stream_ab.py DIR [DIR ...] [--kernels] [--out FILE]

Each DIR is a checkout of this repo (its root, or a commit unpacked from
``git archive``).  For each, in the order given, a new process imports that
checkout's ``chip_smoke.py`` and ``repro_torch``, builds its kernels and
serves the streaming trace at full width (chatglm3-6b, 48 requests,
wall-clock fabric, fused decode) through ``phase_stream``: the continuous
loop, then the pipelined one.  This script times each
``ContinuousBatcher.run`` itself, the same way in every checkout: the
loop's whole window on the host clock, after the engine's warm-up, prefills
included.  It prints one JSON line per checkout and loop (and writes them
to FILE); name a checkout twice (A B B A) to see how far the card drifts
within the call.  Needs one CUDA card.

``--kernels``: for each checkout in turn, a new process builds that
checkout's kernels and times its ``fused_decode_attention`` (the whole
call) and ``decode_attention_shard`` (the slot-shard form's one-block
call, the 1x1 mesh's) at KERNEL_CASES, with that checkout's
``chip_smoke.make_inputs`` and ``time_ms`` (inputs from a seeded CPU
generator, CUDA events, median of 200, L2 flushed before each call): one
JSON line per checkout.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

MARK = "stream_ab "
# chip_smoke.py's case tuples (name, arch for the rope variant, B, S, H,
# K, D, dtype, lens (None: drawn in [128, S) from the seed), quant,
# is_ring, window): the one-shot serving shape, the three streaming shapes
# and decode_32k's per-device shape on a 16x16 mesh.
KERNEL_CASES = [
    ("chatglm3-6b-S160", "chatglm3-6b", 4, 160, 32, 2, 128, "bf16", None,
     False, False, 0),
    ("chatglm3-6b-S1040", "chatglm3-6b", 4, 1040, 32, 2, 128, "bf16", None,
     False, False, 0),
    ("qwen3-moe-30b-a3b-S1040", "qwen3-moe-30b-a3b", 4, 1040, 32, 4, 128,
     "bf16", None, False, False, 0),
    ("zamba2-1.2b-S1040", "zamba2-1.2b", 4, 1040, 32, 32, 64, "bf16", None,
     False, False, 0),
    ("decode-32k", "chatglm3-6b", 8, 32768, 32, 2, 128, "bf16",
     [2047, 2048, 32767, 20000, 4095, 4096, 16384, 100], False, False, 0),
]


def time_kernels(root: Path, smoke, dev) -> dict:
    """The checkout's whole call and one-block shard call at KERNEL_CASES."""
    from repro_torch.kernels import decode_attention as DA

    rec = {"tree": str(root), "card": smoke.card_line()}
    for case in KERNEL_CASES:
        args, _ = smoke.make_inputs(case, 0, dev)
        whole, shard = smoke.clone(args), smoke.clone(args)
        rec[case[0]] = {
            "whole_ms": smoke.time_ms(
                lambda: DA.fused_decode_attention(*whole), dev),
            "one_block_ms": smoke.time_ms(
                lambda: DA.decode_attention_shard(*shard), dev)}
        del args, whole, shard
    return rec


def child(root: Path, kernels: bool = False) -> None:
    """Serve both loops from the checkout at ``root``, or time its kernels
    (``kernels``); print a marked JSON line for each."""
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels import _build
    from repro_torch.serve.batcher import ContinuousBatcher

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.ones(1, device=dev)     # the allocator's stats need a context
    if kernels:
        _build.build_all(("decode_attention",))
        print(MARK + json.dumps(time_kernels(root, smoke, dev)), flush=True)
        return
    _build.build_all()
    windows, run = [], ContinuousBatcher.run

    def timed_run(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(self, *args, **kwargs)
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - t0)
        return out

    ContinuousBatcher.run = timed_run
    card = smoke.card_line()
    for pipeline in (False, True):
        res = smoke.phase_stream(dev, pipeline=pipeline)
        window = windows[-1]
        rec = {"tree": str(root), "card": card,
               "loop": "pipelined" if pipeline else "continuous"}
        rec.update({k: res[k] for k in (
            "decode_jobs", "prefill_jobs", "decode_tokens", "decode_s",
            "prefill_s", "decode_tok_s", "step_p50_ms",
            "slot_occupancy_mean", "latency_p50_s", "latency_p99_s")})
        rec.update(decode_wall_ms_per_step=res["decode_s"]
                   / res["decode_jobs"] * 1e3,
                   loop_window_s=window,
                   window_decode_tok_s=res["decode_tokens"] / window,
                   calibration=res["calibration"]["source"])
        print(MARK + json.dumps(rec), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--kernels", action="store_true",
                    help="time the decode-attention kernels instead")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child.resolve(), args.kernels)
        return 0
    if not args.trees:
        ap.error("name at least one checkout")
    recs = []
    for tree in args.trees:
        root = tree.resolve()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child",
             str(root)] + (["--kernels"] if args.kernels else []),
            cwd=root, capture_output=True, text=True)
        marked = [json.loads(line[len(MARK):])
                  for line in proc.stdout.splitlines()
                  if line.startswith(MARK)]
        if proc.returncode != 0 or len(marked) != (1 if args.kernels else 2):
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            print(f"stream_ab: {root} failed (exit {proc.returncode})",
                  file=sys.stderr)
            return 1
        for rec in marked:
            recs.append(rec)
            print(json.dumps(rec), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
