"""Architecture registry: the 10 assigned configs + shape cells."""

from . import (granite_20b, jamba_52b, mistral_large_123b, mixtral_8x22b,
               phi35_moe_42b, qwen2_vl_72b, qwen3_32b, qwen15_110b,
               rwkv6_3b, seamless_m4t_medium)
from .base import MambaConfig, MoEConfig, ModelConfig
from .shapes import LONG_CONTEXT_OK, SHAPES, ShapeCell, cells_for, skipped_cells_for

_MODULES = {
    "qwen2-vl-72b": qwen2_vl_72b,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b,
    "mixtral-8x22b": mixtral_8x22b,
    "qwen3-32b": qwen3_32b,
    "qwen1.5-110b": qwen15_110b,
    "granite-20b": granite_20b,
    "mistral-large-123b": mistral_large_123b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "rwkv6-3b": rwkv6_3b,
    "jamba-v0.1-52b": jamba_52b,
}

ARCHS = list(_MODULES)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    mod = _MODULES[name]
    return mod.REDUCED if reduced else mod.CONFIG


__all__ = ["ARCHS", "get_config", "ModelConfig", "MoEConfig", "MambaConfig",
           "SHAPES", "ShapeCell", "cells_for", "skipped_cells_for",
           "LONG_CONTEXT_OK"]
