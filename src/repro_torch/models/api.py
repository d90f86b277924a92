"""Model factory: the kinds this port runs so far."""

from __future__ import annotations

from ..configs import ModelConfig
from .rwkv_model import RWKVModel
from .transformer import TransformerModel


def build_model(cfg: ModelConfig) -> TransformerModel | RWKVModel:
    """The model for `cfg`. The dense transformer and RWKV-6 are ported;
    MoE, VLM, encoder-decoder and hybrid (Mamba) models raise."""
    if cfg.kind == "dense":
        return TransformerModel(cfg)
    if cfg.kind == "rwkv":
        return RWKVModel(cfg)
    if cfg.kind in ("moe", "vlm", "encdec", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: model kind {cfg.kind!r} is not ported yet (ROADMAP "
            "queue 1, item 7)")
    raise ValueError(f"unknown model kind {cfg.kind!r}")
