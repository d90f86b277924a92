"""Model factory, input descriptors and input specs for every (arch ×
shape) cell."""

from __future__ import annotations

import torch

from ..configs import SHAPES, ModelConfig, ShapeCell
from ..configs.seamless_m4t_medium import ENC_FRAMES
from .common import NULL_RULES, AxisRules, Desc, abstract_params
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
            d["tokens"] = Desc((B, 1), ("dp", None), dtype=torch.int32)
            d["positions"] = Desc((B, 1, 3), ("dp", None, None),
                                  dtype=torch.int32)
        else:
            s_img = int(S * VLM_PATCH_FRAC)
            d["tokens"] = Desc((B, S - s_img), ("dp", None), dtype=torch.int32)
            d["patches"] = Desc((B, s_img, cfg.d_model), ("dp", None, None),
                                dtype=torch.bfloat16)
            d["positions"] = Desc((B, S, 3), ("dp", None, None),
                                  dtype=torch.int32)
    elif cfg.kind == "encdec":
        if cell.step == "decode":
            d["tokens"] = Desc((B, 1), ("dp", None), dtype=torch.int32)
        else:
            d["frames"] = Desc((B, S, cfg.d_model), ("dp", None, None),
                               dtype=torch.bfloat16)
            d["tokens"] = Desc((B, S), ("dp", None), dtype=torch.int32)
    else:
        d["tokens"] = Desc((B, 1 if cell.step == "decode" else S),
                           ("dp", None), dtype=torch.int32)
    if cell.step == "train":
        d["labels"] = Desc((B, S), ("dp", None), dtype=torch.int32)
    return d


def input_specs(cfg: ModelConfig, cell_name: str,
                rules: AxisRules | None = None) -> dict:
    """Meta stand-ins for every model input of a cell, as the JAX
    package's `input_specs` gives its `ShapeDtypeStruct`s: {"batch": ...}
    and, at decode, {"cache": ...} (the encoder-decoder's with
    `ENC_FRAMES` encoder frames). With `rules` over a mesh, meta DTensors
    placed by `AxisRules.physical` of each leaf's axes. Nothing is
    allocated."""
    cell = SHAPES[cell_name]
    model = build_model(cfg)
    specs: dict = {"batch": batch_desc(cfg, cell)}
    if cell.step == "decode":
        extra = {"enc_len": ENC_FRAMES} if cfg.kind == "encdec" else {}
        specs["cache"] = model.cache_desc(cell.global_batch, cell.seq_len,
                                          **extra)
    return abstract_params(specs, rules or NULL_RULES)
