"""Step factories: train / prefill / slot prefill / decode, each emitting
credits.

The port of ``repro/launch/steps.py``.  Each factory returns a plain
function; PyTorch runs eagerly, so there is nothing to compile and nothing
to shard.

``make_train_step`` returns ``fn(params, opt_state, batch) -> (params,
opt_state, metrics)``: autograd of the mean next-token loss, global-norm
clipping, and one AdamW step that updates params and moments in place (the
reference's ``donate_argnums=(0, 1)``), with ``metrics = {"loss",
"grad_norm", "credits"}``.

The serving steps return ``{"next_token", "caches", "credits"}``:

  * ``next_token`` is the greedy argmax of the last position's logits;
  * ``caches`` are updated in place — the counterpart of the reference's
    ``donate_argnums`` — and returned;
  * ``credits`` is the credit-counter scalar (``core.sync.emit_credits``):
    the host blocks on those 4 bytes alone to learn the step is done and
    its outputs are finite.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.sync import emit_credits
from repro_torch.models import (cross_entropy, decode_step as model_decode,
                                forward, init_cache, merge_cache_slots,
                                prefill as model_prefill)
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_update, clip_by_global_norm


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _loss_fn(params, batch, cfg: ModelConfig, *, remat: bool):
    if "embeds" in batch:
        logits = forward(params, cfg, embeds=batch["embeds"], remat=remat)
        labels = batch["labels"]
    else:
        logits = forward(params, cfg, tokens=batch["tokens"], remat=remat)
        labels = batch["tokens"]
    return cross_entropy(logits, labels)


def make_train_step(cfg: ModelConfig, *, opt_cfg: AdamWConfig | None = None,
                    remat: bool = True, fused_adamw: bool = False):
    """``fn(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``batch`` is ``{"tokens": (B, S) int}`` (or ``{"embeds", "labels"}``).
    Gradients are taken with respect to detached aliases of the parameter
    leaves, so ``params`` itself never requires grad; the update then
    writes ``params`` and the moments in place.  ``remat`` recomputes each
    layer group's activations in the backward pass; ``fused_adamw`` sends
    every leaf of 128 elements or more through the fused AdamW kernel
    (the reference optimizer's ``use_pallas``).
    """
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch):
        leaves, spec = pytree.tree_flatten(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_() for p in leaves]
            loss = _loss_fn(pytree.tree_unflatten(live, spec), batch, cfg,
                            remat=remat)
            grads = torch.autograd.grad(loss, live, allow_unused=True,
                                        materialize_grads=True)
        loss = loss.detach()
        grads, gnorm = clip_by_global_norm(
            pytree.tree_unflatten(list(grads), spec), opt_cfg.clip_norm)
        new_params, new_state = adamw_update(params, grads, opt_state,
                                             opt_cfg, use_kernel=fused_adamw)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "credits": emit_credits({"loss": loss, "p": new_params})}
        return new_params, new_state, metrics

    return train_step


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
