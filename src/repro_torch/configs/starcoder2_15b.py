"""starcoder2-15b [dense]: GQA(kv=4), RoPE [arXiv:2402.19173].

40L d_model=6144 48H d_ff=24576 vocab=49152.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    d_ff=24576,
    vocab_pad_to=256,
    vocab_size=49152,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    act="gelu",
    gated_mlp=False,
)
