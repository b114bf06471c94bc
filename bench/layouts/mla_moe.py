"""Leaves of the MLA MoE family's blocks (kanana-2-30b-a3b, DeepSeek-V3's
layers): multi-head latent attention followed by a dense gated FFN
(``mla``, the leading layer, ``dense_d_ff`` wide) or by the sigmoid-routed
experts and a shared gated expert (``mla_moe``).

The attention's leaves are as the program holds them: ``wq`` (each head's
``qk_nope_head_dim`` + ``qk_rope_head_dim`` dims from the hidden state, no
q-LoRA), ``w_kv_a`` (the ``kv_lora_rank``-wide latent and the shared
rotary key), the latent's norm scale ``kv_norm``, ``w_kv_b`` (each head's
key and value dims from the latent, head-major) and ``wo``.  The router is
float32, as is its score-correction bias, drawn at ``BIAS_STD``: about the
spacing of the 128 sigmoid scores at the top-6 cut, so that it moves some
picks.

The routed experts' down-projection is drawn at the fan-in scale times
``ROUTED_OUT_SCALE``.  DeepSeek-V3's router weighs each of its 6 experts by
about ``routed_scaling_factor`` / 6 = 0.41, at the top-6 cut too, so a copy
that a rounding moves across the cut swaps a whole random expert of that
weight for another: at the plain fan-in scale these swaps, compounded over
47 layers, leave a bfloat16 program's tokens as far from the float32
reference as the float8 control's (mean gap 1.47 against 2.6 at a 4 x 1024
refill and 16 decode steps, two seeds on one H100), and no check could
tell a precision from another.  At a quarter of it the program reads 0.013
and 0.014 and the control 0.26 and 0.22 (an eighth: 0.008, 0.003 against
0.24, 0.13; 1 / 2.448: 0.075, 0.092 against 0.52, 0.38).  Trained experts
differ from each other far less than random ones do."""

from __future__ import annotations

from bench.weights import NORM_STD

KINDS = ("mla", "mla_moe")
BIAS_STD = 0.02
ROUTED_OUT_SCALE = 0.25


def attention(m: dict) -> dict:
    d, h, r, dt = m["d_model"], m["num_heads"], m["kv_lora_rank"], m["dtype"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    return {"wq": ((d, h * (dn + dr)), d ** -0.5, dt),
            "w_kv_a": ((d, r + dr), d ** -0.5, dt),
            "kv_norm": ((r,), NORM_STD, "float32"),
            "w_kv_b": ((r, h * (dn + dv)), r ** -0.5, dt),
            "wo": ((h * dv, d), (h * dv) ** -0.5, dt)}


def mlp(d: int, f: int, dt: str) -> dict:
    return {"w_in": ((d, f), d ** -0.5, dt),
            "w_gate": ((d, f), d ** -0.5, dt),
            "w_out": ((f, d), f ** -0.5, dt)}


def moe(m: dict) -> dict:
    d, f, e, dt = m["d_model"], m["d_ff"], m["num_experts"], m["dtype"]
    out = {"w_router": ((d, e), d ** -0.5, "float32"),
           "router_bias": ((e,), BIAS_STD, "float32"),
           "w_gate": ((e, d, f), d ** -0.5, dt),
           "w_in": ((e, d, f), d ** -0.5, dt),
           "w_out": ((e, f, d), f ** -0.5 * ROUTED_OUT_SCALE, dt)}
    if m.get("shared_expert_ff", 0):
        out["shared"] = mlp(d, m["shared_expert_ff"], dt)
    return out


def block(m: dict, kind: str) -> dict:
    if kind not in KINDS:
        raise ValueError(f"bench/layouts/mla_moe.py has no {kind!r} block")
    d = m["d_model"]
    out = {"norm1": ((d,), NORM_STD, "float32"),
           "norm2": ((d,), NORM_STD, "float32"), "mla": attention(m)}
    if kind == "mla_moe":
        out["moe"] = moe(m)
    else:
        out["mlp"] = mlp(d, m.get("dense_d_ff") or m["d_ff"], m["dtype"])
    return out
