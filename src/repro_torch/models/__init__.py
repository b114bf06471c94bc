"""Dense decoder stack: config, layers, model and the reference-weight bridge."""

from .config import ModelConfig, scaled_down
from .model import (cross_entropy, decode_step, forward, init_cache,
                    init_params, merge_cache_slots, prefill)

__all__ = ["ModelConfig", "scaled_down", "init_params", "forward",
           "cross_entropy", "decode_step", "init_cache", "merge_cache_slots",
           "prefill"]
