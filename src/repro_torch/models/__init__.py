"""Dense decoder stack: config, layers, model and the reference-weight bridge."""

from .config import ModelConfig, scaled_down
from .layers import NO_SHARD, ShardCtx
from .model import (cache_bytes, cross_entropy, decode_step, forward,
                    init_cache, init_params, merge_cache_slots, prefill)

__all__ = ["ModelConfig", "scaled_down", "ShardCtx", "NO_SHARD", "init_params", "forward",
           "cross_entropy", "decode_step", "init_cache", "merge_cache_slots",
           "prefill", "cache_bytes"]
