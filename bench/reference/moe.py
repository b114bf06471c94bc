"""Plain float32 reference of the MoE family (qwen3-moe-30b-a3b).

Each token's router picks its ``num_experts_per_tok`` largest logits
(ties in expert order), weights them by a softmax over those logits, and
adds the chosen experts' gated SiLU FFNs.  Experts have a capacity per
call, as the configuration states: ``max(ceil(T * k / E * cf), k)``
copies for the T tokens of one call, taken in token order, then in each
token's rank order; a copy past its expert's capacity is dropped.  The
prefill's tokens are all rows of the program's call, row by row, so the
reference is handed those rows.  A decode call of B rows drops nothing
when its capacity is at least B (each token sends one copy to an expert),
which ``decode_drops_nothing`` checks; the extension then runs dropless.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.common import F32, Job, run_jobs

COUPLED_ROWS = True       # the prefill rows a job needs: the whole call


def capacity(tokens: int, m: dict) -> int:
    k, e = m["num_experts_per_tok"], m["num_experts"]
    return max(int(math.ceil(tokens * k / e * m["capacity_factor"])), k)


def decode_drops_nothing(m: dict, max_batch: int) -> bool:
    return capacity(max_batch, m) >= max_batch


class ROUTER_BF16(F32):
    """A witness, never the check: float32, but the router's logits are a
    bfloat16 product rounded to bfloat16, as the published model (and the
    program) computes them."""

    @staticmethod
    def router_mm(f, w):
        return (f.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()


def route(f, w_router, m, prec=F32):
    """Top-k experts and their gates of f (T, d): (T, k) ids, (T, k) f32."""
    logits = getattr(prec, "router_mm", prec.mm)(f, w_router)
    top, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = m["num_experts_per_tok"]
    return ids[:, :k], torch.softmax(top[:, :k], dim=-1)


def ffn(f, w, m, prec, coupled, route_out):
    p, mm = w["moe"], prec.mm
    ids, gates = route(f, p["w_router"], m, prec)
    t, k = ids.shape
    flat = ids.reshape(-1)                        # (token, rank) order
    keep = torch.ones_like(flat, dtype=torch.bool)
    if coupled:
        cap = capacity(t, m)
        onehot = F.one_hot(flat, m["num_experts"])
        rank = (torch.cumsum(onehot, 0) - onehot).gather(1, flat[:, None])[:, 0]
        keep = rank < cap
    weight = gates.reshape(-1) * keep
    token = torch.arange(t, device=f.device).repeat_interleave(k)
    out = torch.zeros_like(f)
    for e in torch.unique(flat[keep]).tolist():
        sel = (flat == e) & keep
        x = f[token[sel]]
        y = mm(F.silu(mm(x, p["w_gate"][e])) * mm(x, p["w_in"][e]),
               p["w_out"][e])
        out.index_add_(0, token[sel], y * weight[sel][:, None])
    if route_out is not None:
        route_out.append(ids)
    return out


def logits(weights, m, jobs: list[Job], *, prec=F32, routes=False):
    return run_jobs(weights, m, jobs, ffn, prec=prec, routes=routes)
