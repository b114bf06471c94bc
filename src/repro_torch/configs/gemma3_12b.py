"""gemma3-12b [dense]: 5:1 local:global attention, 128k context.

48L d_model=3840 16H (kv=8) d_ff=15360 vocab=262144, sliding window 1024,
head_dim 256 [hf:google/gemma-3]. Pattern = 5 local + 1 global per group
(8 groups of 6 = 48 layers).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    d_ff=15360,
    vocab_pad_to=256,
    vocab_size=262_144,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    pattern=("local", "local", "local", "local", "local", "attn"),
    sliding_window=1024,
    act="gelu",
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
)
