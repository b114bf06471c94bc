"""Operations and bytes of the MLA MoE family's serving work
(kanana-2-30b-a3b: multi-head latent attention in every layer, a dense
FFN in the leading layers, sigmoid-routed experts and a shared expert in
the rest).

As the other families count (``bench.counts.dense``, ``bench.counts.moe``):
each byte read once and written once, a FLOP one multiply or one add, a
prefill row's LM head at its last position only, rows the program computes
and throws away not counted.  Attention is counted in the form the program
computes it:

* a prefill decompresses the latent into every head's key and value: each
  query's q.k over ``qk_nope_head_dim + qk_rope_head_dim`` and p@v over
  ``v_head_dim``, 2 H (Dq + Dv) a key;
* a decode step attends over the cached latent: scores over ``kv_lora_rank
  + qk_rope_head_dim`` and the weighted latent over ``kv_lora_rank``, 2 H
  (2 R + Dr) a key.

Either way a token's ``w_kv_b`` product (decompression, or absorption into
the query and the output) is 2 R H (Dn + Dv), counted with the weights.
A decode step reads every layer's attention weights, the dense FFN, the
router and its bias (float32), the experts its tokens picked (``experts``:
the distinct experts per MoE layer, from the benchmark's own router), the
shared experts, the LM head and its tokens' embedding rows; it reads each
occupied row's cached latent and writes the new one.
"""

from __future__ import annotations

from bench.counts.dense import elem, head_flops  # noqa: F401

F32 = 4


def _layers(m: dict, kind: str) -> int:
    pattern = list(m["pattern"])
    groups, rest = divmod(m["num_layers"], len(pattern))
    return groups * pattern.count(kind) + pattern[:rest].count(kind)


def dense_layers(m: dict) -> int:
    return _layers(m, "mla")


def moe_layers(m: dict) -> int:
    return _layers(m, "mla_moe")


def _widths(m: dict) -> tuple[int, int, int, int, int]:
    return (m["num_heads"], m["kv_lora_rank"], m["qk_nope_head_dim"],
            m["qk_rope_head_dim"], m["v_head_dim"])


def attn_params(m: dict) -> int:
    """The weights of one MLA layer's products: q, the latent and shared
    key, the latent's keys and values, the output."""
    d = m["d_model"]
    h, r, dn, dr, dv = _widths(m)
    return (d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv)
            + h * dv * d)


def dense_ffn_params(m: dict) -> int:
    return 3 * m["d_model"] * (m.get("dense_d_ff") or m["d_ff"])


def ffn_params_per_token(m: dict) -> int:
    """One MoE layer's FFN weights a token uses: the router, its experts
    and the shared expert."""
    d = m["d_model"]
    return (d * m["num_experts"] + m["num_experts_per_tok"] * 3 * d * m["d_ff"]
            + 3 * d * m.get("shared_expert_ff", 0))


def kv_bytes_per_slot(m: dict) -> int:
    """One position's cached latent and shared rotary key, every layer."""
    h, r, dn, dr, dv = _widths(m)
    return m["num_layers"] * (r + dr) * elem(m)


def token_flops(m: dict) -> int:
    """One token's weight products through every layer (no attention over
    keys, no head)."""
    return 2 * (m["num_layers"] * attn_params(m)
                + dense_layers(m) * dense_ffn_params(m)
                + moe_layers(m) * ffn_params_per_token(m))


def prefill_attn_flops(m: dict, keys: int) -> int:
    """q.k and p@v of queries over ``keys`` keys in all, decompressed."""
    h, r, dn, dr, dv = _widths(m)
    return m["num_layers"] * 2 * h * (dn + dr + dv) * keys


def decode_attn_flops(m: dict, keys: int) -> int:
    """Scores over the latent and shared key, and the weighted latent, of
    one query over ``keys`` cached positions."""
    h, r, dn, dr, dv = _widths(m)
    return m["num_layers"] * 2 * h * (2 * r + dr) * keys


def decode_flops(m: dict, position: int) -> int:
    return token_flops(m) + decode_attn_flops(m, position + 1) + head_flops(m)


def prefill_flops(m: dict, length: int) -> int:
    return (length * token_flops(m)
            + prefill_attn_flops(m, length * (length + 1) // 2)
            + head_flops(m))


def decode_step_bytes(m: dict, positions: list[int], experts=None) -> int:
    if experts is None:
        raise ValueError("the MoE's step bytes need the experts it used")
    d, n, e = m["d_model"], len(positions), elem(m)
    r = m["kv_lora_rank"]
    norms = 2 * d * F32
    attn = m["num_layers"] * (attn_params(m) * e + r * F32 + norms)
    ffn = (dense_layers(m) * dense_ffn_params(m) * e
           + moe_layers(m) * ((d + 1) * m["num_experts"] * F32
                              + 3 * d * m.get("shared_expert_ff", 0) * e)
           + sum(experts) * 3 * d * m["d_ff"] * e)
    head = d * m["vocab_size"] * e + d * F32 + n * d * e
    return attn + ffn + head + kv_bytes_per_slot(m) * (sum(positions) + n)


def prefill_attention_bytes_ops(m: dict, batch: int,
                                length: int) -> tuple[int, int]:
    """The prefill-attention calls of one prefill of ``batch`` rows of
    ``length`` tokens, every layer: q and k (``qk_nope_head_dim +
    qk_rope_head_dim`` wide) and v and the output (``v_head_dim``) of every
    head read or written once; the operations of q.k and p@v, each
    position over its whole causal prefix, every row the kernel computes."""
    h, r, dn, dr, dv = _widths(m)
    nbytes = batch * length * h * (2 * (dn + dr) + 2 * dv) * elem(m)
    ops = 2 * batch * h * (dn + dr + dv) * length * (length + 1) // 2
    return m["num_layers"] * nbytes, m["num_layers"] * ops


def decode_attention_bytes_ops(m: dict, lens, slots: int) -> tuple[int, int]:
    """The latent decode-attention calls of one step, every layer: each
    live row's cached latent and shared key read once (the value is the
    row's leading ``kv_lora_rank`` values, read with it), every head's
    query over the latent read and its weighted latent written, the
    lengths read; the operations of the scores over ``kv_lora_rank +
    qk_rope_head_dim`` and of p@v over ``kv_lora_rank``, every live row.
    ``lens`` are all rows' lengths as the call was given them (the new
    token goes at ``lens[i]``, written before the call)."""
    h, r, dn, dr, dv = _widths(m)
    e, b = elem(m), len(lens)
    live = sum(min(int(n) + 1, slots) for n in lens)
    nbytes = live * (r + dr) * e + b * h * (r + dr + r) * e + b * 4
    ops = 2 * h * (2 * r + dr) * live
    return m["num_layers"] * nbytes, m["num_layers"] * ops
