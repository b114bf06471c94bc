"""zamba2-1.2b [hybrid]: Mamba2 backbone + one shared attention block.

38L d_model=2048, shared attn 32H (kv=32, MHA) d_ff=8192 vocab=32000,
ssm_state=64 [arXiv:2411.15242]. Stack: 6 groups of (5 mamba + 1 shared
attention invocation) + 2 tail mamba layers = 38 blocks; the shared
transformer block's weights are stored once and re-invoked per group
(each invocation has its own KV cache).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    d_ff=8192,
    vocab_pad_to=256,
    vocab_size=32000,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "shared_attn"),
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
)
