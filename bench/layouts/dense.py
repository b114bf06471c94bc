"""Leaves of the dense family's blocks: attention and a gated MLP, the
same for global (``attn``) and sliding-window (``local``) attention."""

from __future__ import annotations

from bench.weights import NORM_STD

KINDS = ("attn", "local")


def attention(m: dict) -> dict:
    d, hd, dt = m["d_model"], m["head_dim"], m["dtype"]
    h, kh = m["num_heads"], m["num_kv_heads"]
    return {"wq": ((d, h * hd), d ** -0.5, dt),
            "wk": ((d, kh * hd), d ** -0.5, dt),
            "wv": ((d, kh * hd), d ** -0.5, dt),
            "wo": ((h * hd, d), (h * hd) ** -0.5, dt)}


def block(m: dict, kind: str) -> dict:
    if kind not in KINDS:
        raise ValueError(f"bench/layouts/dense.py has no {kind!r} block")
    d, f, dt = m["d_model"], m["d_ff"], m["dtype"]
    return {"norm1": ((d,), NORM_STD, "float32"),
            "norm2": ((d,), NORM_STD, "float32"), "attn": attention(m),
            "mlp": {"w_in": ((d, f), d ** -0.5, dt),
                    "w_gate": ((d, f), d ** -0.5, dt),
                    "w_out": ((f, d), f ** -0.5, dt)}}
