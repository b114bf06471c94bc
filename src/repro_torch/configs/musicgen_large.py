"""musicgen-large [audio]: decoder-only over EnCodec tokens.

48L d_model=2048 32H (kv=32 => MHA) d_ff=8192 vocab=2048 [arXiv:2306.05284].
The EnCodec frontend is a stub: the sequence *is* the audio-token stream
(vocab 2048); input_specs provides precomputed frame-token ids.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    d_ff=8192,
    vocab_pad_to=256,
    vocab_size=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    act="gelu",
    gated_mlp=False,
    frontend="audio_frames",
)
