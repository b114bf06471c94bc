"""Step factories: train / prefill / slot prefill / decode, each emitting
credits.

The port of ``repro/launch/steps.py``.  Each factory returns a plain
function that runs eagerly.  Compiling is the caller's: the serving engine
wraps each step in a ``launch.compile.CompiledStep`` (one CUDA graph per
input shape, as the reference's ``jax.jit`` keeps one executable), with
the parameters and its own caches as the static arguments, and
``launch.train.build`` wraps the train step with the parameters and the
optimizer state static.  Given a
``DeviceMesh`` (``mesh=``), a step runs the same model code on DTensors:
its inputs are placed by ``runtime.sharding``'s specs (a leaf that is
already a DTensor is taken as it is), the model applies the reference's
sharding constraints through an active ``ShardCtx``, and the credits are
summed over the mesh's devices.  ``bundle_for`` builds the step of an
(arch x shape) cell with its spec trees and meta-device arguments, for
the dry run.

``make_train_step`` returns ``fn(params, opt_state, batch) -> (params,
opt_state, metrics)``: autograd of the mean next-token loss, global-norm
clipping, and one AdamW step that updates params, moments and the step
count in place (the reference's ``donate_argnums=(0, 1)``) and returns
them, with ``metrics = {"loss", "grad_norm", "credits"}``.  Everything in
it stays on the device and nothing reads a value back to the host, so the
whole step (autograd's backward included) can be captured into one CUDA
graph.

The serving steps return ``{"next_token", "caches", "credits"}``:

  * ``next_token`` is the greedy argmax of the last position's logits;
  * ``caches`` are updated in place — the counterpart of the reference's
    ``donate_argnums`` — and returned, so a compiled step's caches stay at
    their addresses from one replay to the next;
  * ``credits`` is the credit-counter scalar (``core.sync.emit_credits``):
    the host blocks on those 4 bytes alone to learn the step is done and
    its outputs are finite.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.sync import emit_credits
from repro_torch.models import (NO_SHARD, cross_entropy,
                                decode_step as model_decode, forward,
                                init_cache, init_params, merge_cache_slots,
                                prefill as model_prefill)
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (AdamWConfig, adamw_update, clip_by_global_norm,
                               init_opt_state)
from repro_torch.runtime.sharding import (P, batch_specs, cache_specs,
                                          make_shard_ctx, opt_specs,
                                          param_specs, to_shardings)


@dataclasses.dataclass
class StepBundle:
    """A step with its placements, the counterpart of the reference's.

    ``in_shardings`` are spec trees (``PartitionSpec`` leaves) over
    ``meta["mesh"]``; ``abstract_args`` are meta tensors.  The reference's
    ``out_shardings`` have no counterpart: a step's outputs take the
    placements its ops give them.  Nor has ``donate_argnums``: the
    arguments a step updates are updated in place, and a
    ``CompiledStep`` holds them as static arguments at fixed addresses.
    """

    fn: Any
    in_shardings: Any
    abstract_args: tuple
    meta: dict


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(logits, DTensor):
        # Vocab-sharded logits: gather the vocabulary, then each device
        # picks its rows' argmax (DTensor has no sharded argmax).
        last = logits.ndim - 1
        logits = logits.redistribute(logits.device_mesh, [
            Replicate() if isinstance(p, Shard) and p.dim == last else p
            for p in logits.placements])
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _ctx(mesh):
    return NO_SHARD if mesh is None else make_shard_ctx(mesh)


def _placed_batch(batch, mesh):
    """``batch`` with every plain tensor leaf placed by ``batch_specs``."""
    if mesh is None:
        return batch
    return to_shardings(batch, batch_specs(batch, mesh), mesh)


def _abstract_params(cfg: ModelConfig):
    return init_params(cfg, device="meta")


def _loss_fn(params, batch, cfg: ModelConfig, *, remat: bool,
             ctx=NO_SHARD):
    if "embeds" in batch:
        logits = forward(params, cfg, embeds=batch["embeds"], remat=remat,
                         ctx=ctx)
        labels = batch["labels"]
    else:
        logits = forward(params, cfg, tokens=batch["tokens"], remat=remat,
                         ctx=ctx)
        labels = batch["tokens"]
    with ctx.scope():
        return cross_entropy(logits, labels)


def make_train_step(cfg: ModelConfig, *, opt_cfg: AdamWConfig | None = None,
                    remat: bool = True, fused_adamw: bool = False,
                    mesh=None):
    """``fn(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``batch`` is ``{"tokens": (B, S) int}`` (or ``{"embeds", "labels"}``).
    Gradients are taken with respect to detached aliases of the parameter
    leaves, so ``params`` itself never requires grad; the update then
    writes ``params`` and the moments in place.  ``remat`` recomputes each
    layer group's activations in the backward pass; ``fused_adamw`` sends
    every leaf of 128 elements or more through the fused AdamW kernel
    (the reference optimizer's ``use_pallas``).

    With a ``mesh``, params and moments must already be DTensors placed by
    ``param_specs``/``opt_specs`` (they are updated in place); the batch is
    placed by ``batch_specs`` (inside the step, so a compiled step places
    the batch buffer it copied in; a DTensor leaf is taken as it is), and
    the gradients are redistributed to the params' placements before the
    update (a reduce-scatter over the data axes, the reference's
    ``with_sharding_constraint`` on the grads).
    """
    opt_cfg = opt_cfg or AdamWConfig()
    ctx = _ctx(mesh)

    def train_step(params, opt_state, batch):
        batch = _placed_batch(batch, mesh)
        leaves, spec = pytree.tree_flatten(params)
        with torch.enable_grad(), ctx.scope():
            live = [p.detach().requires_grad_() for p in leaves]
            loss = _loss_fn(pytree.tree_unflatten(live, spec), batch, cfg,
                            remat=remat, ctx=ctx)
            grads = torch.autograd.grad(loss, live, allow_unused=True,
                                        materialize_grads=True)
        with ctx.scope():
            if mesh is not None:
                grads = [g.redistribute(mesh, p.placements)
                         for g, p in zip(grads, leaves)]
            loss = loss.detach()
            grads, gnorm = clip_by_global_norm(
                pytree.tree_unflatten(list(grads), spec), opt_cfg.clip_norm)
            new_params, new_state = adamw_update(
                params, grads, opt_state, opt_cfg, use_kernel=fused_adamw)
            metrics = {"loss": loss, "grad_norm": gnorm,
                       "credits": emit_credits({"loss": loss,
                                                "p": new_params}, mesh)}
        return new_params, new_state, metrics

    return train_step


def _fresh_caches(cfg, batch_size, max_len, device, mesh):
    caches = init_cache(cfg, batch_size, max_len=max_len, device=device)
    if mesh is None:
        return caches
    return to_shardings(caches, cache_specs(caches, cfg, mesh), mesh)


def _model_inputs(batch):
    return ({"embeds": batch["embeds"]} if "embeds" in batch
            else {"tokens": batch["tokens"]})


def zero_caches(caches):
    """Zero every leaf of ``caches`` in place; returns ``caches``."""
    for leaf in pytree.tree_leaves(caches):
        leaf.zero_()
    return caches


def make_prefill_step(cfg: ModelConfig, batch_size: int, *, max_len: int,
                      device: torch.device, mesh=None):
    """``fn(params, batch, caches=None) -> step outputs``.

    Without ``caches`` the step fills fresh ones.  With them (a serving
    engine's own, which its compiled step holds at fixed addresses) it
    zeroes them and fills them in place, the same values.
    """
    ctx = _ctx(mesh)

    def prefill_step(params, batch, caches=None):
        batch = _placed_batch(batch, mesh)
        if caches is None:
            caches = _fresh_caches(cfg, batch_size, max_len, device, mesh)
        else:
            zero_caches(caches)
        logits, caches = model_prefill(params, cfg, caches=caches, ctx=ctx,
                                       **_model_inputs(batch))
        with ctx.scope():
            last = logits[:, -1]
            return {"next_token": _argmax(last), "caches": caches,
                    "credits": emit_credits({"last": last}, mesh)}

    return prefill_step


def make_slot_prefill_step(cfg: ModelConfig, batch_size: int, *,
                           max_len: int, device: torch.device, mesh=None):
    """``fn(params, batch, live_caches, slot_mask)``: prefill new prompts
    *into freed slots* of live caches (DESIGN.md §6).

    A full-batch prefill runs on fresh caches — rows of still-running
    requests compute garbage that is discarded — and only the
    ``slot_mask`` rows are merged into ``live_caches``, in place, so rows
    of running requests keep their KV state bit for bit.  On a mesh the
    live caches are DTensors placed by ``cache_specs``; the slot mask is
    replicated.  The LM head runs on the last position alone, the one
    whose token the step returns.
    """
    ctx = _ctx(mesh)

    def slot_prefill_step(params, batch, live_caches, slot_mask):
        batch = _placed_batch(batch, mesh)
        fresh = _fresh_caches(cfg, batch_size, max_len, device, mesh)
        logits, fresh = model_prefill(params, cfg, caches=fresh, ctx=ctx,
                                      last_only=True, **_model_inputs(batch))
        with ctx.scope():
            last = logits[:, -1]
            merged = merge_cache_slots(live_caches, fresh, slot_mask)
            return {"next_token": _argmax(last), "caches": merged,
                    "credits": emit_credits({"last": last}, mesh)}

    return slot_prefill_step


def make_decode_step(cfg: ModelConfig, *, fused: bool = False, mesh=None):
    """``fn(params, tokens (B,1), caches, cache_len)`` -> step outputs.

    ``cache_len`` is a per-slot (B,) vector or a scalar.  ``fused=True``
    runs every attention layer through the fused decode-attention kernel;
    on a mesh each device launches it on its batch rows of the whole
    cache.
    """
    ctx = _ctx(mesh)

    def decode_fn(params, tokens, caches, cache_len):
        tokens = _placed_batch(tokens, mesh)
        logits, caches = model_decode(params, cfg, tokens, caches, cache_len,
                                      fused=fused, ctx=ctx)
        with ctx.scope():
            return {"next_token": _argmax(logits[:, 0]), "caches": caches,
                    "credits": emit_credits({"logits": logits}, mesh)}

    return decode_fn


def bundle_for(cfg: ModelConfig, mesh, shape_name: str, specs: dict,
               *, fused: bool = False) -> StepBundle:
    """Route an (arch x shape) cell to its step, with spec trees and the
    meta-device arguments ``abstract_args`` (``configs.shapes.input_specs``
    gives ``specs``)."""
    from repro_torch.configs.shapes import SHAPES
    kind = SHAPES[shape_name]["kind"]
    p_abs = _abstract_params(cfg)
    p_spec = param_specs(p_abs, cfg, mesh)
    meta = {"kind": kind, "param_spec": p_spec, "mesh": mesh}
    if kind == "train":
        o_abs = init_opt_state(p_abs)
        b_spec = batch_specs(specs, mesh)
        return StepBundle(
            fn=make_train_step(cfg, mesh=mesh),
            in_shardings=(p_spec, opt_specs(p_spec), b_spec),
            abstract_args=(p_abs, o_abs, specs),
            meta={**meta, "batch_spec": b_spec})
    batch_size = next(iter(specs.values())).shape[0]
    if kind == "prefill":
        max_len = SHAPES[shape_name]["seq"]
        return StepBundle(
            fn=make_prefill_step(cfg, batch_size, max_len=max_len,
                                 device=torch.device(mesh.device_type),
                                 mesh=mesh),
            in_shardings=(p_spec, batch_specs(specs, mesh)),
            abstract_args=(p_abs, specs), meta=meta)
    c_spec = cache_specs(specs["caches"], cfg, mesh)
    return StepBundle(
        fn=make_decode_step(cfg, fused=fused, mesh=mesh),
        in_shardings=(p_spec, batch_specs(specs["tokens"], mesh), c_spec,
                      P()),
        abstract_args=(p_abs, specs["tokens"], specs["caches"],
                       specs["cache_len"]),
        meta={**meta, "fused": fused})
