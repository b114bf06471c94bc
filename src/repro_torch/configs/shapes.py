"""Assigned input shapes and their meta-device stand-ins.

The port of ``repro/configs/shapes.py``: the same four shapes, the same
applicability rule and routing-group choice.  Where the reference returns
``jax.ShapeDtypeStruct``s, ``input_specs`` returns tensors on the ``meta``
device, which carry shape and dtype and allocate nothing.

Four shapes per LM architecture (40 cells total):

  train_4k     seq 4,096   x global_batch 256   -> train_step
  prefill_32k  seq 32,768  x global_batch 32    -> serve prefill
  decode_32k   seq 32,768  x global_batch 128   -> serve decode (1 new token,
                                                   KV cache of seq_len)
  long_500k    seq 524,288 x global_batch 1     -> long-context decode; only
               sub-quadratic archs (SSM / hybrid / mostly-local) run it —
               pure full-attention archs skip it (recorded in DESIGN.md §5).

``input_specs`` allocates nothing: every input (including decode caches) is a
meta tensor, suitable for a dry run under ``FakeTensorMode``.
Modality frontends are stubs per the assignment: [vlm] train/prefill inputs
are precomputed patch *embeddings*; [audio] sequences are EnCodec token ids.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import ModelConfig, init_cache
from repro_torch.models.model import _dtype

SHAPES: dict[str, dict[str, Any]] = {
    "train_4k": dict(kind="train", seq=4_096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32_768, batch=32),
    "decode_32k": dict(kind="decode", seq=32_768, batch=128),
    "long_500k": dict(kind="decode", seq=524_288, batch=1),
}
SHAPE_NAMES = tuple(SHAPES)


def shape_applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(applicable?, reason). All assigned archs are decoder-style, so decode
    shapes apply to everyone; long_500k needs a sub-quadratic stack."""
    spec = SHAPES[shape_name]
    if spec["kind"] == "decode" and spec["seq"] > 262_144:
        if not cfg.sub_quadratic:
            return False, ("pure full-attention arch: 500k dense KV context "
                           "is out of scope (see DESIGN.md §5)")
    return True, ""


def _uses_embeds(cfg: ModelConfig, kind: str) -> bool:
    """VLM train/prefill consume precomputed patch embeddings (stub
    frontend); decode continues over text tokens. Audio (EnCodec) sequences
    are token ids by construction."""
    return cfg.frontend == "vision_patches" and kind in ("train", "prefill")


def pick_moe_groups(cfg: ModelConfig, tokens: int, parts: int) -> int:
    """Largest divisor of ``tokens`` that is <= parts (#shards): routing
    groups must evenly split the token stream."""
    if cfg.num_experts == 0:
        return 1
    g = min(tokens, parts)
    while tokens % g:
        g -= 1
    return max(g, 1)


def config_for_shape(cfg: ModelConfig, shape_name: str,
                     num_shards: int = 1) -> ModelConfig:
    """Shape-specialized config (routing groups sized to the token count)."""
    spec = SHAPES[shape_name]
    tokens = spec["batch"] * (spec["seq"] if spec["kind"] == "train" else
                              (spec["seq"] if spec["kind"] == "prefill"
                               else 1))
    return dataclasses.replace(
        cfg, moe_groups=pick_moe_groups(cfg, tokens, num_shards))


def input_specs(cfg: ModelConfig, shape_name: str) -> dict[str, Any]:
    """Meta-tensor stand-ins for every input of the step function."""
    spec = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape_name)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape_name}: {why}")
    b, s = spec["batch"], spec["seq"]
    i32 = torch.int32
    dt = _dtype(cfg.dtype)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if spec["kind"] == "train":
        if _uses_embeds(cfg, "train"):
            return {
                "embeds": meta((b, s, cfg.d_model), dt),
                "labels": meta((b, s), i32),
            }
        return {"tokens": meta((b, s), i32)}

    if spec["kind"] == "prefill":
        if _uses_embeds(cfg, "prefill"):
            return {"embeds": meta((b, s, cfg.d_model), dt)}
        return {"tokens": meta((b, s), i32)}

    # decode: one new token against a cache of seq_len.
    caches = init_cache(cfg, b, max_len=s, device="meta")
    return {
        "tokens": meta((b, 1), i32),
        "caches": caches,
        "cache_len": meta((), i32),
    }


def cell_table(arch_cfgs: dict[str, ModelConfig]) -> list[tuple[str, str, bool, str]]:
    """All (arch, shape) cells with applicability — the 40-cell matrix."""
    rows = []
    for name, cfg in arch_cfgs.items():
        for shape in SHAPE_NAMES:
            ok, why = shape_applicable(cfg, shape)
            rows.append((name, shape, ok, why))
    return rows
