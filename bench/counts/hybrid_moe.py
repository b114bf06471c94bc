"""Operations and bytes of the hybrid MoE family's serving work
(granite-4.0-h-small: Mamba-2 mixers and a few attention layers, each
followed by a routed MoE FFN and a shared expert).

As the dense and MoE families count (``bench.counts.dense``,
``bench.counts.moe``): each byte read once and written once, a FLOP one
multiply or one add, a prefill row's LM head at its last position only,
rows the program computes and throws away not counted.  By layer kind:

* a Mamba-2 layer's token: its projections (z, x, B, C, dt in, out), the
  conv, and the SSM's work.  A prefill token counts the chunked dual form
  as it needs it (``ssm_chunk`` Q, heads H of P, state N): C.B over the
  causal pairs of its chunk, their decay-weighted sum of x, the chunk
  state's input and the chunk state's read-out; a decode token the
  recurrence (decay, input, add: 3 H P N; read-out 2 H P N);
* an attention layer's token: q, k, v, o, and q.k and p@v over its keys
  (``attn_flops``, over the attention layers alone);
* every layer's FFN: the router, ``num_experts_per_tok`` experts and the
  shared expert.

A decode step reads every layer's mixer weights, the router (float32),
the experts its tokens picked (``experts``: the distinct experts per MoE
layer, from the benchmark's own router), the shared experts, the tied
embedding as the LM head and its tokens' rows; it reads and writes each
occupied row's SSM state (float32) and conv window, reads its keys and
values and writes the new ones.
"""

from __future__ import annotations

from bench.counts import dense
from bench.counts.dense import elem

F32 = 4


def _layers(m: dict, kind: str) -> int:
    pattern = list(m["pattern"])
    groups, rest = divmod(m["num_layers"], len(pattern))
    return groups * pattern.count(kind) + pattern[:rest].count(kind)


def mamba_layers(m: dict) -> int:
    return _layers(m, "mamba_moe")


def attn_layers(m: dict) -> int:
    return _layers(m, "attn_moe")


def _attn_only(m: dict) -> dict:
    """``m`` with its depth cut to the attention layers, for the dense
    family's attention counts."""
    return dict(m, num_layers=attn_layers(m))


def _ssm(m: dict) -> tuple[int, int, int, int, int]:
    d = m["d_model"]
    di = m["ssm_expand"] * d
    h = m["ssm_heads"]
    return di, h, di // h, m["ssm_state"], di + 2 * m["ssm_state"]


def mamba_params(m: dict) -> int:
    """The weights of one Mamba-2 mixer's products: in- and out-projection."""
    d = m["d_model"]
    di, h, _, n, _ = _ssm(m)
    return d * (2 * di + 2 * n + h) + di * d


def mamba_small_bytes(m: dict) -> int:
    """One mixer's conv weights and bias, per-head constants and gated
    norm scale, as the program holds them."""
    di, h, _, _, c = _ssm(m)
    w = m["conv_width"]
    return w * c * elem(m) + (c if m.get("conv_bias") else 0) * F32 \
        + 3 * h * F32 + di * F32


def ffn_params_per_token(m: dict) -> int:
    d, f = m["d_model"], m["d_ff"]
    return (d * m["num_experts"] + m["num_experts_per_tok"] * 3 * d * f
            + 3 * d * m.get("shared_expert_ff", 0))


def ssd_prefill_flops(m: dict) -> int:
    """The chunked SSD's work per prompt token, one layer."""
    _, h, p, n, _ = _ssm(m)
    q = m["ssm_chunk"]
    pairs = (q + 1) / 2                    # causal pairs per token
    return int(pairs * (2 * n + h * (2 * p + 1)) + 4 * h * p * n)


def ssd_decode_flops(m: dict) -> int:
    _, h, p, n, _ = _ssm(m)
    return 5 * h * p * n


def conv_flops(m: dict) -> int:
    return 2 * m["conv_width"] * _ssm(m)[4]


def token_flops(m: dict, decode: bool = False) -> int:
    """One token's weight products and SSM work through every layer (no
    attention over keys, no head)."""
    ssd = ssd_decode_flops(m) if decode else ssd_prefill_flops(m)
    mixers = (mamba_layers(m) * (2 * mamba_params(m) + conv_flops(m) + ssd)
              + attn_layers(m) * 2 * dense.attn_params(m))
    return mixers + m["num_layers"] * 2 * ffn_params_per_token(m)


def attn_flops(m: dict, keys: int) -> int:
    return dense.attn_flops(_attn_only(m), keys)


def head_flops(m: dict) -> int:
    return dense.head_flops(m)


def decode_flops(m: dict, position: int) -> int:
    return (token_flops(m, decode=True) + attn_flops(m, position + 1)
            + head_flops(m))


def prefill_flops(m: dict, length: int) -> int:
    return (length * token_flops(m)
            + attn_flops(m, length * (length + 1) // 2) + head_flops(m))


def state_bytes_per_row(m: dict) -> int:
    """One row's SSM state (float32) and conv window, every Mamba layer."""
    _, h, p, n, c = _ssm(m)
    return mamba_layers(m) * (h * p * n * F32
                              + (m["conv_width"] - 1) * c * elem(m))


def kv_bytes_per_slot(m: dict) -> int:
    return dense.kv_bytes_per_slot(_attn_only(m))


def decode_step_bytes(m: dict, positions: list[int], experts=None) -> int:
    if experts is None:
        raise ValueError("the MoE's step bytes need the experts it used")
    d, f, n = m["d_model"], m["d_ff"], len(positions)
    e = elem(m)
    norms = 2 * d * F32
    mixers = (mamba_layers(m) * (mamba_params(m) * e + mamba_small_bytes(m)
                                 + norms)
              + attn_layers(m) * (dense.attn_params(m) * e + norms))
    ffn = (m["num_layers"] * (d * m["num_experts"] * F32
                              + 3 * d * m.get("shared_expert_ff", 0) * e)
           + sum(experts) * 3 * d * f * e)
    head = d * m["vocab_size"] * e + d * F32 + n * d * e
    state = 2 * n * state_bytes_per_row(m)
    kv = kv_bytes_per_slot(m) * (sum(positions) + n)
    return mixers + ffn + head + state + kv


def decode_attention_bytes_ops(m: dict, lens, slots: int) -> tuple[int, int]:
    """The fused decode-attention calls of one step, the attention layers
    alone (NoPE: the identity angles are read as rotary angles are)."""
    return dense.decode_attention_bytes_ops(_attn_only(m), lens, slots)


def prefill_attention_bytes_ops(m: dict, batch: int,
                                length: int) -> tuple[int, int]:
    """The prefill-attention calls of one prefill, the attention layers
    alone."""
    return dense.prefill_attention_bytes_ops(_attn_only(m), batch, length)
