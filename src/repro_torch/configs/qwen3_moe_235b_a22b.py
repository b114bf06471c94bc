"""qwen3-moe-235b-a22b [moe]: 128 experts, top-8, GQA(kv=4).

94L d_model=4096 64H d_ff(expert)=1536 vocab=151936 [hf:Qwen/Qwen3].
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    d_ff=1536,
    vocab_pad_to=256,
    vocab_size=151_936,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    pattern=("attn_moe",),
    num_experts=128,
    num_experts_per_tok=8,
    rope_theta=1_000_000.0,
)
