"""Operations and bytes of the MoE family's serving work.

As the dense family (``bench.counts.dense``), with the FFN replaced: a
token needs the router and its ``num_experts_per_tok`` experts, and a
decode step reads the router and the experts that its tokens picked, each
once, per layer (``experts``: the distinct experts per layer, from the
benchmark's own router; without them the step's expert bytes are not
counted and the caller reports nothing)."""

from __future__ import annotations

from bench.counts.dense import (attn_flops, attn_params,  # noqa: F401
                                decode_attention_bytes_ops, elem, head_flops,
                                kv_bytes_per_slot,
                                prefill_attention_bytes_ops)


def ffn_params_per_token(m: dict) -> int:
    d = m["d_model"]
    return d * m["num_experts"] + m["num_experts_per_tok"] * 3 * d * m["d_ff"]


def ffn_weight_bytes(m: dict, experts=None) -> int:
    if experts is None:
        raise ValueError("the MoE's step bytes need the experts it used")
    d = m["d_model"]
    return (m["num_layers"] * d * m["num_experts"] * 4
            + sum(experts) * 3 * d * m["d_ff"] * elem(m))


def decode_step_bytes(m: dict, positions: list[int], experts=None) -> int:
    d, n = m["d_model"], len(positions)
    weights = (m["num_layers"] * (attn_params(m) * elem(m) + 2 * d * 4)
               + ffn_weight_bytes(m, experts)
               + d * m["vocab_size"] * elem(m) + d * 4 + n * d * elem(m))
    return weights + kv_bytes_per_slot(m) * (sum(positions) + n)


def token_flops(m: dict) -> int:
    return 2 * m["num_layers"] * (attn_params(m) + ffn_params_per_token(m))


def decode_flops(m: dict, position: int) -> int:
    return token_flops(m) + attn_flops(m, position + 1) + head_flops(m)


def prefill_flops(m: dict, length: int) -> int:
    return (length * token_flops(m)
            + attn_flops(m, length * (length + 1) // 2) + head_flops(m))
