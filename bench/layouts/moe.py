"""Leaves of the MoE family's block (``attn_moe``): the dense family's
attention, then a float32 router and the experts' gated MLPs stacked along
a leading expert axis."""

from __future__ import annotations

from bench.layouts.dense import attention
from bench.weights import NORM_STD

KINDS = ("attn_moe",)


def block(m: dict, kind: str) -> dict:
    if kind not in KINDS:
        raise ValueError(f"bench/layouts/moe.py has no {kind!r} block")
    d, f, e, dt = m["d_model"], m["d_ff"], m["num_experts"], m["dtype"]
    return {"norm1": ((d,), NORM_STD, "float32"),
            "norm2": ((d,), NORM_STD, "float32"), "attn": attention(m),
            "moe": {"w_router": ((d, e), d ** -0.5, "float32"),
                    "w_gate": ((e, d, f), d ** -0.5, dt),
                    "w_in": ((e, d, f), d ** -0.5, dt),
                    "w_out": ((e, f, d), f ** -0.5, dt)}}
