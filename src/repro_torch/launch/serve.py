"""One-shot serving on the card.

The port of the ``--one-shot`` mode of ``repro/launch/serve.py``: one
batch of prompts through the ``ServingEngine`` — multicast dispatch, the
prefill step, then ``gen - 1`` decode steps, each retired by the credit
counter — followed by the offline Eq.-1 fit and Eq.-3 offload decision.

  PYTHONPATH=src python -m repro_torch.launch.serve --one-shot \\
      --arch chatglm3-6b --no-reduced --fused-decode

The streaming mode (``serve_workload``) is not ported yet (ROADMAP A8).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.core import decision, runtime_model


def serve(arch: str, *, reduced: bool = True, prompts: int = 4,
          prompt_len: int = 32, gen: int = 16, slo_us: float | None = None,
          fused_decode: bool = False, device: str | torch.device = "cuda",
          params=None, prompt_tokens: np.ndarray | None = None) -> dict:
    """One-shot serving: a single batch through the serving engine, with one
    offline offload decision for the whole job.

    ``prompt_tokens`` (prompts, prompt_len) int32 replaces the default
    prompt batch, drawn with ``np.random.default_rng(1)``; ``params`` a
    port parameter tree replaces the seeded random weights.
    """
    from repro_torch.serve.batcher import ServingEngine

    engine = ServingEngine(arch, reduced=reduced, max_batch=prompts,
                           max_len=prompt_len + gen, fused_decode=fused_decode,
                           params=params, device=device)
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--no-reduced", dest="reduced", action="store_false",
                    help="serve the full-width, full-depth config (default: "
                         "its scaled_down version)")
    ap.add_argument("--one-shot", action="store_true",
                    help="serve one batch with one offline offload "
                         "decision (the only mode ported so far)")
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--fused-decode", action="store_true",
                    help="run every decode step's attention through the "
                         "fused CUDA decode-attention kernel")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    if not args.one_shot:
        print("streaming serving is not yet ported (ROADMAP A8); "
              "use --one-shot", file=sys.stderr)
        raise SystemExit(2)
    out = serve(args.arch, reduced=args.reduced, prompts=args.prompts,
                prompt_len=args.prompt_len, gen=args.gen,
                fused_decode=args.fused_decode, device=args.device)
    print(f"{out['arch']} on {out['device']}: prefill "
          f"{out['prefill_s'] * 1e3:.1f} ms, decode "
          f"{out['decode_tok_s']:.1f} tok/s")
    print("offload decision (Eq.3):", out["offload_decision"])
    return out


if __name__ == "__main__":
    main()
