"""mamba2-370m [ssm]: attention-free SSD (state-space duality).

48L d_model=1024 vocab=50280 ssm_state=128 [arXiv:2405.21060].
d_inner = 2*1024 = 2048, head_dim 64 => 32 SSM heads.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    d_ff=0,
    vocab_pad_to=256,
    vocab_size=50280,
    pattern=("mamba",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    tie_embeddings=True,
)
