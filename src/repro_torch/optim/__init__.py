"""Optimizers: AdamW with f32 moments, global-norm clipping, LR schedules."""

from .adamw import (AdamWConfig, adamw_update, clip_by_global_norm,
                    cosine_schedule, global_norm, init_opt_state)

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "global_norm",
           "clip_by_global_norm", "cosine_schedule"]
