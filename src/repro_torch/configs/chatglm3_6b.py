"""chatglm3-6b [dense]: 2D-RoPE (rotary on half the head dim), GQA(kv=2).

28L d_model=4096 32H d_ff=13696 vocab=65024 [arXiv:2406.12793].
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    d_ff=13696,
    vocab_pad_to=256,
    vocab_size=65024,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    rope_variant="half",
)
