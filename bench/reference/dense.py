"""Plain float32 reference of the dense family (chatglm3-6b): a gated SiLU
MLP after each attention block.  Rows never couple, so a job's prefill is
its own row alone."""

from __future__ import annotations

import torch.nn.functional as F

from bench.reference.common import F32, Job, run_jobs

COUPLED_ROWS = False      # the prefill rows a job needs: its own


def ffn(f, w, m, prec, coupled, route):
    p, mm = w["mlp"], prec.mm
    return mm(F.silu(mm(f, p["w_gate"])) * mm(f, p["w_in"]), p["w_out"])


def logits(weights, m, jobs: list[Job], *, prec=F32, routes=False):
    return run_jobs(weights, m, jobs, ffn, prec=prec, routes=routes)
