"""Assigned-architecture registry: ``get_config(arch_id)``.

The port of ``repro/configs/__init__.py``: the same ten ``ARCH_IDS`` and
one module per architecture holding its ``CONFIG``.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "musicgen-large",
    "starcoder2-15b",
    "granite-3-8b",
    "gemma3-12b",
    "chatglm3-6b",
    "zamba2-1.2b",
    "qwen3-moe-235b-a22b",
    "qwen3-moe-30b-a3b",
    "mamba2-370m",
    "qwen2-vl-72b",
)

#: Configurations of the port's own, beyond the reference's: the JAX
#: package cannot run them, so they stay out of ``ARCH_IDS``.
PORT_ARCH_IDS = ("kanana-2-30b-a3b",)

_MODULES = {a: a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS + PORT_ARCH_IDS}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{ARCH_IDS + PORT_ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


from .shapes import SHAPE_NAMES, input_specs, shape_applicable  # noqa: E402

__all__ = ["ARCH_IDS", "PORT_ARCH_IDS", "get_config", "all_configs",
           "SHAPE_NAMES", "input_specs", "shape_applicable"]
