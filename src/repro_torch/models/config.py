"""Model configuration covering all assigned architecture families.

A copy of ``repro/models/config.py``: the same frozen ``ModelConfig``,
``BLOCK_KINDS`` and ``scaled_down``, so a config built by either package
compares equal on every field the reference has.  The port adds what
granite-4.0-h's hybrid stack needs (a Mamba2 mixer followed by an MoE
FFN, NoPE attention, a shared expert, the conv bias and four scalar
multipliers) and what DeepSeek-V3's layers need (multi-head latent
attention over a dense or an MoE FFN, a dense FFN width beside the expert
width, a sigmoid router with a score-correction bias and a scaling of its
weights, interleaved rotary pairs); each new field defaults to a neutral
value that leaves the reference's configurations, and the work their steps
do, unchanged.

The layer stack is described by ``pattern``: one repeating *group* of block
kinds. ``num_layers = len(pattern) * full_groups + len(tail)`` — parameters
of the full groups are stacked along a leading axis, and the tail blocks
are kept apart.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

BLOCK_KINDS = (
    "attn",          # global attention + dense FFN
    "local",         # sliding-window attention + dense FFN
    "attn_moe",      # global attention + MoE FFN
    "mamba",         # Mamba2 (SSD) block
    "shared_attn",   # hybrid: invoke the single shared transformer block
    "mamba_moe",     # Mamba2 (SSD) mixer + MoE FFN (granite-4.0-h)
    "mla",           # multi-head latent attention + dense FFN (DeepSeek-V3)
    "mla_moe",       # multi-head latent attention + MoE FFN
)
#: The block kinds whose mixer is a Mamba2 SSD (an SSM and a conv cache).
MAMBA_KINDS = ("mamba", "mamba_moe")
#: The block kinds whose mixer is multi-head latent attention (one latent
#: per position in the cache, shared by every head).
MLA_KINDS = ("mla", "mla_moe")
#: The block kinds whose FFN is the MoE.
MOE_KINDS = ("attn_moe", "mamba_moe", "mla_moe")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    # Attention.
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0              # 0 => d_model // num_heads
    rope_variant: str = "full"     # full | half (ChatGLM 2D) | mrope
    #                                (Qwen2-VL) | none (NoPE)
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, ...] = ()   # half-dims per (t, h, w) stream
    sliding_window: int = 0        # window for "local" blocks
    # Layer stack.
    pattern: tuple[str, ...] = ("attn",)
    # FFN.
    act: str = "silu"
    gated_mlp: bool = True
    # MoE.
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_groups: int = 1            # routing groups (>= #shards at scale)
    capacity_factor: float = 1.25
    shared_expert_ff: int = 0      # a shared gated expert of this width
    # The router: "softmax" over the top-k logits, or DeepSeek-V3's
    # "sigmoid": experts picked by sigmoid(logit) plus a per-expert
    # score-correction bias (each MoE block's ``router_bias`` leaf),
    # weighted by their sigmoid scores normalised over the k, times
    # ``routed_scaling``.
    router_scoring: str = "softmax"
    routed_scaling: float = 1.0
    # The dense FFN's width where it differs from ``d_ff`` (the experts'):
    # DeepSeek-V3's leading dense layers.  0 => d_ff.
    dense_d_ff: int = 0
    # Multi-head latent attention (DeepSeek-V2/V3, ``mla`` kinds): q straight
    # from the hidden state, ``qk_nope_head_dim + qk_rope_head_dim`` wide per
    # head; one ``kv_lora_rank``-wide latent and one shared rotary key of
    # ``qk_rope_head_dim`` cached per position; values ``v_head_dim`` wide.
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # Rotary pairs (2i, 2i + 1) instead of (i, i + W): DeepSeek-V3's
    # ``rope_interleave``.
    rope_interleave: bool = False
    # SSM (Mamba2 / SSD).
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_width: int = 4
    conv_bias: bool = False
    # Misc.
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # Pad the embedding table rows to a multiple of this (Megatron-style),
    # so the vocab dim shards evenly; logits over padded ids are masked.
    vocab_pad_to: int = 1
    # Serving: store the KV cache as int8 with per-vector f32 scales —
    # halves the decode memory-roofline term (EXPERIMENTS.md §Perf cell 3).
    kv_quant: bool = False
    dtype: str = "bfloat16"
    frontend: str = ""             # "" | audio_frames | vision_patches
    max_seq_len: int = 131_072
    # Granite's scalar multipliers; the defaults change nothing (and add
    # no operation).  ``attention_multiplier`` 0 is 1/sqrt(head_dim).
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    logits_scaling: float = 1.0

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if not self.pattern:
            raise ValueError("pattern must be non-empty")
        if self.num_layers < len(self.pattern):
            raise ValueError("num_layers smaller than one pattern group")
        for k in self.pattern:
            if k not in BLOCK_KINDS:
                raise ValueError(f"unknown block kind {k!r}")
        if self.router_scoring not in ("softmax", "sigmoid"):
            raise ValueError(f"unknown router scoring {self.router_scoring!r}")
        if any(k in MLA_KINDS for k in self.pattern) and not (
                self.kv_lora_rank and self.qk_rope_head_dim
                and self.qk_nope_head_dim and self.v_head_dim):
            raise ValueError("mla blocks need kv_lora_rank, qk_nope_head_dim,"
                             " qk_rope_head_dim and v_head_dim")

    @property
    def qk_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def mla_latent_dim(self) -> int:
        """The width of one cached MLA position: the latent and the shared
        rotary key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def vocab_padded(self) -> int:
        q = self.vocab_pad_to
        return -(-self.vocab_size // q) * q

    @property
    def full_groups(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def tail(self) -> tuple[str, ...]:
        return self.pattern[: self.num_layers % len(self.pattern)]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_heads or (self.d_inner // self.ssm_head_dim)

    @property
    def has_attention(self) -> bool:
        return any(k not in MAMBA_KINDS for k in self.pattern)

    @property
    def uses_shared_block(self) -> bool:
        return "shared_attn" in self.pattern

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode: never materializes O(S^2) state and
        keeps at most a windowed or constant-size per-layer cache, except for
        a small number of global/full layers (linear in cache for 1-token
        decode)."""
        kinds = set(self.pattern)
        if kinds <= {"mamba", "shared_attn"}:
            return True
        if "local" in kinds and kinds <= {"local", "attn"}:
            return True  # mostly-local (gemma3-style 5:1)
        return False

    def param_count(self) -> int:
        """Analytic parameter count (used for 6*N*D MODEL_FLOPS in §Roofline)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_padded
        n = v * d  # embeddings
        if not self.tie_embeddings:
            n += v * d
        per_kind: dict[str, int] = {}
        hd = self.qk_head_dim
        attn_p = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
            + self.num_heads * hd * d
        mlp_p = d * f * (3 if self.gated_mlp else 2)
        per_kind["attn"] = attn_p + mlp_p + 2 * d
        per_kind["local"] = per_kind["attn"]
        moe_f = f  # assigned configs quote per-expert d_ff
        moe_p = (d * self.num_experts
                 + self.num_experts * d * moe_f * (3 if self.gated_mlp else 2)
                 + 3 * d * self.shared_expert_ff)      # the shared expert
        if self.router_scoring == "sigmoid":
            moe_p += self.num_experts              # the router's bias
        per_kind["attn_moe"] = attn_p + moe_p + 2 * d
        h, r = self.num_heads, self.kv_lora_rank
        mla_p = (d * h * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                 + d * self.mla_latent_dim + r     # kv_a and its norm
                 + r * h * (self.qk_nope_head_dim + self.v_head_dim)
                 + h * self.v_head_dim * d)
        dense_f = self.dense_d_ff or f
        per_kind["mla"] = mla_p + d * dense_f * (3 if self.gated_mlp else 2) \
            + 2 * d
        per_kind["mla_moe"] = mla_p + moe_p + 2 * d
        di, ns, nh = self.d_inner, self.ssm_state, self.ssm_num_heads
        g_bc = 2 * ns  # single B/C group
        per_kind["mamba"] = (d * (2 * di + g_bc + nh)  # w_z/w_x/w_bc/w_dt
                             + (self.conv_width + self.conv_bias)
                             * (di + g_bc)              # conv (+ bias)
                             + 3 * nh                   # A_log, D, dt_bias
                             + di                        # gated norm
                             + di * d + d)               # out_proj + norm
        per_kind["mamba_moe"] = per_kind["mamba"] + moe_p + d
        per_kind["shared_attn"] = 0  # counted once below
        counts = {}
        for k in self.pattern:
            counts[k] = counts.get(k, 0) + 1
        total_blocks = dict(counts)
        for k in self.tail:
            total_blocks[k] = total_blocks.get(k, 0)
        n_groups = self.full_groups
        for k, c_in_pattern in counts.items():
            occurrences = c_in_pattern * n_groups + sum(
                1 for t in self.tail if t == k)
            n += occurrences * per_kind[k]
        if self.uses_shared_block:
            n += per_kind["attn"]  # one shared transformer block
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        moe_layers = sum(1 for k in self.pattern if k in MOE_KINDS) \
            * self.full_groups + sum(1 for k in self.tail if k in MOE_KINDS)
        idle = (self.num_experts - self.num_experts_per_tok) * self.d_model \
            * self.d_ff * (3 if self.gated_mlp else 2)
        return self.param_count() - moe_layers * idle


def scaled_down(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced config of the same family for CPU smoke tests."""
    small = dict(
        num_layers=len(cfg.pattern) * 2 + len(cfg.tail),
        d_model=64,
        d_ff=128,
        vocab_size=128,
        vocab_pad_to=1,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=16 if cfg.num_heads else 0,
        num_experts=8 if cfg.num_experts else 0,
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
        moe_groups=1,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_heads=0,
        ssm_head_dim=16,
        ssm_chunk=8,
        shared_expert_ff=128 if cfg.shared_expert_ff else 0,
        dense_d_ff=192 if cfg.dense_d_ff else 0,
        kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        qk_nope_head_dim=16 if cfg.qk_nope_head_dim else 0,
        qk_rope_head_dim=8 if cfg.qk_rope_head_dim else 0,
        v_head_dim=16 if cfg.v_head_dim else 0,
        sliding_window=8 if cfg.sliding_window else 0,
        mrope_sections=(4, 2, 2) if cfg.rope_variant == "mrope" else (),
        max_seq_len=256,
        dtype="float32",
    )
    small.update(overrides)
    return replace(cfg, **small)
