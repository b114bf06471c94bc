"""How ``correct`` is decided: served tokens against the plain reference.

Once the window has closed, a sample of the requests the window finished
is drawn from the seed: the one with the most served tokens, then others in
a seeded order until the sample holds ``TARGET_TOKENS`` served tokens and
as many requests as the engine has slots.  The family's float32 reference
runs each prompt with its served tokens, given the rows of the prefill
call that placed it where the family couples rows (the MoE's capacity).

Three numbers are read over the sampled served tokens, from each token's
gap: how far its reference logit lies below the reference's best logit at
its position (0 where the program served the reference's own greedy
token).  ``logit_gap``, the widest gap; ``mismatch_share``, the share of
tokens with a gap; ``mean_gap``, the mean gap.  The control reads them for
the tokens that the reference in float8 puts first.  A cell's limits
(``bench/limits/<cell>.json``) say which numbers it compares: those that
separate the program's readings from the control's.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from bench.reference.common import Job

TARGET_TOKENS = 512


def sample(served: dict, finished: list[int], seed: int, min_requests: int,
           target: int = TARGET_TOKENS) -> list[int]:
    """rids of the finished requests to compare: the longest first."""
    if not finished:
        return []
    longest = max(finished, key=lambda rid: (len(served[rid]), -rid))
    rest = sorted(set(finished) - {longest})
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC4EC]))
    out, total = [longest], len(served[longest])
    for i in rng.permutation(len(rest)):
        if total >= target and len(out) >= min_requests:
            break
        out.append(rest[i])
        total += len(served[rest[i]])
    return out


def jobs(rids, served, prefill_of, calls, coupled: bool) -> list[Job]:
    """One reference job per request: its prefill call's rows (all of
    them where ``coupled``), its row, its served tokens but the last."""
    out = []
    for rid in rids:
        ci = prefill_of[rid]
        call = calls[ci]
        slot = next(i for i, r, _ in call.rows if r.rid == rid)
        rows = torch.from_numpy(call.tokens.astype(np.int64))
        ext = torch.tensor(served[rid][:-1], dtype=torch.int64)
        if coupled:
            out.append(Job(rows, slot, ext, group=ci))
        else:
            out.append(Job(rows[slot:slot + 1], 0, ext, group=-1 - rid))
    return out


def gaps(ref_logits, tokens) -> torch.Tensor:
    """Per position: reference best logit minus the token's logit."""
    t = torch.as_tensor(tokens, device=ref_logits.device, dtype=torch.long)
    if t.numel() and int(t.max()) >= ref_logits.shape[-1]:
        return torch.full((len(t),), float("inf"))
    best = ref_logits.max(dim=-1).values
    return (best - ref_logits.gather(1, t[:, None])[:, 0]).cpu()


def numbers(ref_logits: list, served_lists: list) -> dict:
    """``logit_gap``, ``mismatch_share`` and ``mean_gap`` of the served
    tokens."""
    g = torch.cat([gaps(lg, toks) for lg, toks in zip(ref_logits,
                                                      served_lists)
                   if len(toks)] or [torch.full((1,), float("inf"))])
    return {"logit_gap": float(g.max()),
            "mismatch_share": float((g > 0).float().mean()),
            "mean_gap": float(g.mean())}


def control_numbers(ref_logits: list, ctl_logits: list) -> dict:
    """The same numbers for the tokens the control puts first."""
    return numbers(ref_logits, [c.argmax(dim=-1) for c in ctl_logits])


def limits(root: Path, workload: str) -> dict:
    path = root / "bench" / "limits" / f"{workload}.json"
    return json.loads(path.read_text()) if path.is_file() else {}
