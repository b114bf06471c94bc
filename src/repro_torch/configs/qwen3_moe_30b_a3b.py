"""qwen3-moe-30b-a3b [moe]: 128 experts, top-8, GQA(kv=4).

48L d_model=2048 32H d_ff(expert)=768 vocab=151936 [hf:Qwen/Qwen3-30B-A3B].
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    d_ff=768,
    vocab_pad_to=256,
    vocab_size=151_936,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    pattern=("attn_moe",),
    num_experts=128,
    num_experts_per_tok=8,
    rope_theta=1_000_000.0,
)
