"""Leaves of the hybrid MoE family's blocks (granite-4.0-h): a Mamba-2
mixer (``mamba_moe``) or GQA attention (``attn_moe``), each followed by the
MoE family's router and experts and a shared gated expert of
``shared_expert_ff``.

The mixer's in-projection is split as the program holds it: z and x
(``d_inner`` each), B and C of one group (``ssm_state`` each, as one
leaf), and dt (one per head); the depthwise conv over x, B and C with its
bias (``conv_bias``); A as ``a_log`` (A = -exp(a_log)), ``dt_bias`` and
the skip ``d_skip`` per head, in float32; the gated norm's scale and the
out-projection.  Every draw has mean 0: ``a_log`` and ``dt_bias`` at the
norm scale put A near -1 and dt near softplus of a unit normal, and the
skip is drawn at unit scale, the size of its published initial value.

Each branch's last projection (the mixer's and the attention's out, the
experts' and the shared expert's down) is drawn at the fan-in scale over
``residual_multiplier``, the scale a trained muP-style model's branches
carry against the multiplier that shrinks them.  At the plain fan-in scale
the 80 branches, each times 0.22, leave the 12-fold embedding a large
enough share of the final hidden state that the tied head's best logit is,
at every position, the input token's own: the model would only copy its
last token, and no check could tell a precision from another."""

from __future__ import annotations

from bench.weights import NORM_STD

KINDS = ("mamba_moe", "attn_moe")


def _out(m: dict, fan_in: int) -> float:
    """The std of a branch's last projection."""
    return fan_in ** -0.5 / m.get("residual_multiplier", 1.0)


def attention(m: dict) -> dict:
    d, hd, dt = m["d_model"], m["head_dim"], m["dtype"]
    h, kh = m["num_heads"], m["num_kv_heads"]
    return {"wq": ((d, h * hd), d ** -0.5, dt),
            "wk": ((d, kh * hd), d ** -0.5, dt),
            "wv": ((d, kh * hd), d ** -0.5, dt),
            "wo": ((h * hd, d), _out(m, h * hd), dt)}


def mamba(m: dict) -> dict:
    d, dt = m["d_model"], m["dtype"]
    di, n = m["ssm_expand"] * d, m["ssm_state"]
    h, w = m["ssm_heads"], m["conv_width"]
    out = {"w_z": ((d, di), d ** -0.5, dt),
           "w_x": ((d, di), d ** -0.5, dt),
           "w_bc": ((d, 2 * n), d ** -0.5, dt),
           "w_dt": ((d, h), d ** -0.5, dt),
           "w_conv": ((w, di + 2 * n), w ** -0.5, dt)}
    if m.get("conv_bias"):
        out["conv_bias"] = ((di + 2 * n,), w ** -0.5, "float32")
    out.update({"a_log": ((h,), NORM_STD, "float32"),
                "dt_bias": ((h,), NORM_STD, "float32"),
                "d_skip": ((h,), 1.0, "float32"),
                "w_norm": ((di,), NORM_STD, "float32"),
                "w_out": ((di, d), _out(m, di), dt)})
    return out


def moe(m: dict) -> dict:
    d, f, e, dt = m["d_model"], m["d_ff"], m["num_experts"], m["dtype"]
    out = {"w_router": ((d, e), d ** -0.5, "float32"),
           "w_gate": ((e, d, f), d ** -0.5, dt),
           "w_in": ((e, d, f), d ** -0.5, dt),
           "w_out": ((e, f, d), _out(m, f), dt)}
    fs = m.get("shared_expert_ff", 0)
    if fs:
        out["shared"] = {"w_gate": ((d, fs), d ** -0.5, dt),
                         "w_in": ((d, fs), d ** -0.5, dt),
                         "w_out": ((fs, d), _out(m, fs), dt)}
    return out


def block(m: dict, kind: str) -> dict:
    if kind not in KINDS:
        raise ValueError(f"bench/layouts/hybrid_moe.py has no {kind!r} block")
    d = m["d_model"]
    if kind == "mamba_moe":
        return {"norm1": ((d,), NORM_STD, "float32"), "mamba": mamba(m),
                "norm2": ((d,), NORM_STD, "float32"), "moe": moe(m)}
    return {"norm1": ((d,), NORM_STD, "float32"),
            "norm2": ((d,), NORM_STD, "float32"), "attn": attention(m),
            "moe": moe(m)}
