"""kanana-2-30b-a3b [moe, mla]: multi-head latent attention over a
sigmoid-routed MoE of 128 experts, top-6, and two shared experts.

48L d_model=2048 32H (q 128+64, latent 512, v 128) one dense layer of
6144, then 47 MoE layers of 128 experts of 768 and a shared expert of
1536; vocab=128256 [hf:kakaocorp/kanana-2-30b-a3b-instruct-2601,
model_type deepseek_v3].

Not among ``ARCH_IDS`` (the reference's ten): the JAX package has no
latent attention.  ``get_config("kanana-2-30b-a3b")`` finds it all the same.
``SCALED_DOWN`` is its narrow form for CPU tests: the leading dense layer
and three MoE layers in one group, at ``scaled_down``'s widths.
"""

from repro_torch.models.config import ModelConfig, scaled_down

CONFIG = ModelConfig(
    name="kanana-2-30b-a3b",
    family="mla_moe",
    num_layers=48,
    d_model=2048,
    d_ff=768,                      # one routed expert's width
    dense_d_ff=6144,               # the leading dense layer's
    vocab_size=128_256,
    vocab_pad_to=256,
    num_heads=32,
    num_kv_heads=32,
    head_dim=192,
    pattern=("mla",) + ("mla_moe",) * 47,
    num_experts=128,
    num_experts_per_tok=6,
    shared_expert_ff=1536,         # two shared experts of 768, as one
    router_scoring="sigmoid",
    routed_scaling=2.448,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_interleave=True,
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
    max_seq_len=32_768,
)

SCALED_DOWN = scaled_down(CONFIG, num_layers=4,
                          pattern=("mla",) + ("mla_moe",) * 3,
                          num_heads=4, num_kv_heads=4, head_dim=24,
                          num_experts_per_tok=2)
