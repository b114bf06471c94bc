"""qwen2-vl-72b [vlm]: M-RoPE, dynamic resolution [arXiv:2409.12191].

80L d_model=8192 64H (kv=8) d_ff=29568 vocab=152064. The vision frontend is
a stub: input_specs provides precomputed patch embeddings (B, S, d); the
M-RoPE sections (16, 24, 24 half-dims) are driven by (t, h, w) position
streams (identical for text-only decode).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    d_ff=29568,
    vocab_pad_to=256,
    vocab_size=152_064,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    rope_variant="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    frontend="vision_patches",
)
