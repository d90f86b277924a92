"""Model factory and input descriptors for every (arch × shape) cell."""

from __future__ import annotations

import torch

from ..configs import ModelConfig, ShapeCell
from .common import Desc
from .encdec import EncDecModel
from .hybrid import HybridModel
from .rwkv_model import RWKVModel
from .transformer import TransformerModel

# fraction of the sequence that is image patches for the VLM cells
VLM_PATCH_FRAC = 0.25


def build_model(cfg: ModelConfig
                ) -> TransformerModel | EncDecModel | RWKVModel | HybridModel:
    """The model for `cfg`, of every kind in the registry."""
    if cfg.kind in ("dense", "moe", "vlm"):
        return TransformerModel(cfg)
    if cfg.kind == "encdec":
        return EncDecModel(cfg)
    if cfg.kind == "rwkv":
        return RWKVModel(cfg)
    if cfg.kind == "hybrid":
        return HybridModel(cfg)
    raise ValueError(f"unknown model kind {cfg.kind!r}")


def batch_desc(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Input descriptors (shape, dtype) for one shape cell, as the JAX
    package's `batch_desc` gives them.

    `train`/`prefill` feed full sequences; `decode` feeds one token against
    a cache created by `model.cache_desc`. Modality frontends are stubs:
    VLM cells get precomputed patch embeddings + M-RoPE ids; the encdec
    arch gets precomputed encoder frame embeddings.
    """
    B, S = cell.global_batch, cell.seq_len
    d: dict = {}
    if cfg.kind == "vlm":
        if cell.step == "decode":
            d["tokens"] = Desc((B, 1), dtype=torch.int32)
            d["positions"] = Desc((B, 1, 3), dtype=torch.int32)
        else:
            s_img = int(S * VLM_PATCH_FRAC)
            d["tokens"] = Desc((B, S - s_img), dtype=torch.int32)
            d["patches"] = Desc((B, s_img, cfg.d_model), dtype=torch.bfloat16)
            d["positions"] = Desc((B, S, 3), dtype=torch.int32)
    elif cfg.kind == "encdec":
        if cell.step == "decode":
            d["tokens"] = Desc((B, 1), dtype=torch.int32)
        else:
            d["frames"] = Desc((B, S, cfg.d_model), dtype=torch.bfloat16)
            d["tokens"] = Desc((B, S), dtype=torch.int32)
    else:
        d["tokens"] = Desc((B, 1 if cell.step == "decode" else S),
                           dtype=torch.int32)
    if cell.step == "train":
        d["labels"] = Desc((B, S), dtype=torch.int32)
    return d
