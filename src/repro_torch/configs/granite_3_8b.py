"""granite-3-8b [dense]: GQA(kv=8) [hf:ibm-granite/granite-3.0].

40L d_model=4096 32H d_ff=12800 vocab=49155.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    d_ff=12800,
    vocab_pad_to=256,
    vocab_size=49155,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
)
