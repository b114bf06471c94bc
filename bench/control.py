"""Readings for a cell's limit: the program's widest logit gap over many
seeds, and the control's, in one process on the card.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --seconds 15
        [--control N] [--witness N]

One set-up serves every seed: the weights are drawn anew from each seed
into the same tensors (``weights.fill``), so the engine's captured steps
stay valid, and a fresh scheduler and calibrator serve a window of the
cell's own traffic at its own load.  For each seed it prints one JSON line:
the program's numbers (``bench/check.py``) over the sample it draws, and,
for the first N seeds, the control's: the same reference in float8
(``reference.common.FP8``), whose first token at each position is read
in the float32 reference's logits.  The benchmark's own runs never run the
control.

``--witness N`` reads, for the first N seeds, what bfloat16 rounding alone
does: ``bf16``, the tokens that the reference with every product's
operands in bfloat16 (``reference.common.BF16``) puts first, read like the
control's; and, for a family with a router, ``router_bf16``, the
program's tokens against the reference whose router logits are a bfloat16
product (the family's ``ROUTER_BF16``).
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(root: Path, workload: str, seeds: list[int], seconds: float,
             dev, control: int = 0, witness: int = 0):
    import torch

    from bench import check, harness
    from bench.reference.common import BF16, FP8
    from bench.weights import draw, fill

    cell = harness.Cell.load(root, workload)
    m, mix = cell.model, cell.mix
    ref, layout = cell.family("reference"), cell.family("layouts")
    harness.build_kernels(dev)
    weights = draw(m, seeds[0], dev, layout)
    engine = harness.build_engine(cell, weights, dev)
    for n, seed in enumerate(seeds):
        t0 = time.perf_counter()
        fill(weights, m, seed, layout)
        requests = harness.requests_for(mix, seed, m["vocab_size"])
        timed, batcher, drained = harness.serve_window(engine, requests,
                                                       seconds)
        calls = timed.calls
        served, prefill_of, finished, problems = harness.audit(
            calls, requests, mix["slots"], batcher.metrics)
        rids = check.sample(served, finished, seed, mix["slots"])
        jobs = check.jobs(rids, served, prefill_of, calls, ref.COUPLED_ROWS)
        toks = [served[r] for r in rids]
        logits = ref.logits(weights, m, jobs)
        rec = {"workload": workload, "seed": seed, "drained": drained,
               "problems": len(problems), "requests": len(rids),
               "tokens": sum(map(len, toks)),
               "program": check.numbers(logits, toks)}
        if n < control:
            ctl = ref.logits(weights, m, jobs, prec=FP8)
            rec["control"] = check.control_numbers(logits, ctl)
            del ctl
        if n < witness:
            wit = ref.logits(weights, m, jobs, prec=BF16)
            rec["bf16"] = check.control_numbers(logits, wit)
            del wit
            router = getattr(ref, "ROUTER_BF16", None)
            if router is not None:
                wit = ref.logits(weights, m, jobs, prec=router)
                rec["router_bf16"] = check.numbers(wit, toks)
                del wit
        rec["seconds"] = time.perf_counter() - t0
        del logits, jobs, timed, batcher
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        yield rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--witness", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",")]
    for rec in readings(ROOT, args.workload, seeds, args.seconds,
                        torch.device("cuda", 0), args.control,
                        args.witness):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
