"""Operations and bytes of the dense family's serving work.

Counted as the inputs need them, each byte read once and written once: a
decode step reads every layer's weights, the embedding rows of its tokens,
the LM head's real vocabulary columns and each occupied row's live cache,
and writes each row's new key and value; a FLOP is one multiply or one add
(a multiply-add is two).  A prefill row needs the LM head at its last
position only, where it yields the first token.  Rows the program computes
and throws away are not counted: callers pass the rows that carry requests.
"""

from __future__ import annotations

ELEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def elem(m: dict) -> int:
    return ELEM[m["dtype"]]


def attn_params(m: dict) -> int:
    d, hd = m["d_model"], m["head_dim"]
    return d * hd * (m["num_heads"] + 2 * m["num_kv_heads"]) \
        + m["num_heads"] * hd * d


def ffn_params_per_token(m: dict) -> int:
    return 3 * m["d_model"] * m["d_ff"]


def ffn_weight_bytes(m: dict, experts=None) -> int:
    """Bytes of every layer's FFN weights (``experts`` is the MoE's)."""
    return m["num_layers"] * 3 * m["d_model"] * m["d_ff"] * elem(m)


def kv_bytes_per_slot(m: dict) -> int:
    """One position's key and value over all layers."""
    return m["num_layers"] * 2 * m["num_kv_heads"] * m["head_dim"] * elem(m)


def decode_step_bytes(m: dict, positions: list[int], experts=None) -> int:
    """One decode step of the rows at ``positions`` (each row's cache
    length before the step)."""
    d, n = m["d_model"], len(positions)
    weights = (m["num_layers"] * (attn_params(m) * elem(m) + 2 * d * 4)
               + ffn_weight_bytes(m, experts)
               + d * m["vocab_size"] * elem(m) + d * 4      # head, norm
               + n * d * elem(m))                            # embed rows
    kv = kv_bytes_per_slot(m) * (sum(positions) + n)
    return weights + kv


def attn_flops(m: dict, keys: int) -> int:
    """q.k and p@v of one query over ``keys`` keys, every layer."""
    return m["num_layers"] * 4 * m["num_heads"] * m["head_dim"] * keys


def token_flops(m: dict) -> int:
    """The weight products of one token through every layer (no head)."""
    return 2 * m["num_layers"] * (attn_params(m) + ffn_params_per_token(m))


def head_flops(m: dict) -> int:
    return 2 * m["d_model"] * m["vocab_size"]


def decode_flops(m: dict, position: int) -> int:
    """One decode token at ``position`` (it attends ``position + 1``)."""
    return token_flops(m) + attn_flops(m, position + 1) + head_flops(m)


def prefill_flops(m: dict, length: int) -> int:
    """One prompt row of ``length`` tokens, causal, head at the last."""
    return (length * token_flops(m)
            + attn_flops(m, length * (length + 1) // 2) + head_flops(m))


def decode_attention_bytes_ops(m: dict, lens, slots: int) -> tuple[int, int]:
    """The fused decode-attention calls of one step, every layer: the
    live keys and values read once, the new ones written, q, k, v read and
    the output written, the rotary angles and lengths read; the operations
    of q.k and p@v over the live slots.  ``lens`` are all rows' lengths as
    the call was given them (the new token goes at ``lens[i]``)."""
    h, kh, hd, e = m["num_heads"], m["num_kv_heads"], m["head_dim"], elem(m)
    w = hd // 4 if m.get("rope_variant") == "half" else hd // 2
    b = len(lens)
    live = sum(min(int(n) + 1, slots) for n in lens)
    nbytes = (live * kh * 2 * hd * e + b * kh * 2 * hd * e
              + b * h * hd * e * 2 + b * kh * hd * e * 2 + b * (2 * w * 4 + 4))
    ops = 4 * h * hd * live
    return m["num_layers"] * nbytes, m["num_layers"] * ops


def prefill_attention_bytes_ops(m: dict, batch: int,
                                length: int) -> tuple[int, int]:
    """The prefill-attention calls of one prefill of ``batch`` rows of
    ``length`` tokens, every layer: q, k and v read and the output written
    once; the operations of q.k and p@v, each position over its whole
    causal prefix, in every row, the rows the program throws away too (the
    kernel computes them)."""
    h, kh, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    nbytes = batch * length * (2 * h + 2 * kh) * hd * elem(m)
    ops = 4 * batch * h * hd * length * (length + 1) // 2
    return m["num_layers"] * nbytes, m["num_layers"] * ops
