"""Step factories: prefill / slot prefill / decode, each emitting credits.

The port of ``repro/launch/steps.py`` (serving steps; the train step waits
for ROADMAP A10).  Each factory returns a plain function; PyTorch runs
eagerly, so there is nothing to compile and nothing to shard.  Every step
returns ``{"next_token", "caches", "credits"}``:

  * ``next_token`` is the greedy argmax of the last position's logits;
  * ``caches`` are updated in place — the counterpart of the reference's
    ``donate_argnums`` — and returned;
  * ``credits`` is the credit-counter scalar (``core.sync.emit_credits``):
    the host blocks on those 4 bytes alone to learn the step is done and
    its outputs are finite.
"""

from __future__ import annotations

import torch

from repro_torch.core.sync import emit_credits
from repro_torch.models import (decode_step as model_decode, init_cache,
                                merge_cache_slots, prefill as model_prefill)
from repro_torch.models.config import ModelConfig


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_prefill_step(cfg: ModelConfig, batch_size: int, *, max_len: int,
                      device: torch.device):
    """``fn(params, batch) -> step outputs`` over fresh caches."""

    def prefill_step(params, batch):
        caches = init_cache(cfg, batch_size, max_len=max_len, device=device)
        logits, caches = model_prefill(params, cfg, caches=caches,
                                       tokens=batch["tokens"])
        last = logits[:, -1]
        return {"next_token": _argmax(last), "caches": caches,
                "credits": emit_credits({"last": last})}

    return prefill_step


def make_slot_prefill_step(cfg: ModelConfig, batch_size: int, *,
                           max_len: int, device: torch.device):
    """``fn(params, batch, live_caches, slot_mask)``: prefill new prompts
    *into freed slots* of live caches (DESIGN.md §6).

    A full-batch prefill runs on fresh caches — rows of still-running
    requests compute garbage that is discarded — and only the
    ``slot_mask`` rows are merged into ``live_caches``, in place, so rows
    of running requests keep their KV state bit for bit.
    """

    def slot_prefill_step(params, batch, live_caches, slot_mask):
        fresh = init_cache(cfg, batch_size, max_len=max_len, device=device)
        logits, fresh = model_prefill(params, cfg, caches=fresh,
                                      tokens=batch["tokens"])
        last = logits[:, -1]
        merged = merge_cache_slots(live_caches, fresh, slot_mask)
        return {"next_token": _argmax(last), "caches": merged,
                "credits": emit_credits({"last": last})}

    return slot_prefill_step


def make_decode_step(cfg: ModelConfig, *, fused: bool = False):
    """``fn(params, tokens (B,1), caches, cache_len)`` -> step outputs.

    ``cache_len`` is a per-slot (B,) vector or a scalar.  ``fused=True``
    runs every attention layer through the fused decode-attention kernel.
    """

    def decode_fn(params, tokens, caches, cache_len):
        logits, caches = model_decode(params, cfg, tokens, caches, cache_len,
                                      fused=fused)
        return {"next_token": _argmax(logits[:, 0]), "caches": caches,
                "credits": emit_credits({"logits": logits})}

    return decode_fn
