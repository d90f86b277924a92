"""Model factory: the kinds this port runs so far."""

from __future__ import annotations

from ..configs import ModelConfig
from .transformer import TransformerModel


def build_model(cfg: ModelConfig) -> TransformerModel:
    """The model for `cfg`. Only the dense transformer is ported; MoE,
    VLM, encoder-decoder, hybrid (Mamba) and RWKV models raise."""
    if cfg.kind == "dense":
        return TransformerModel(cfg)
    if cfg.kind in ("moe", "vlm", "encdec", "rwkv", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: model kind {cfg.kind!r} is not ported yet (ROADMAP "
            "queue 1, item 7)")
    raise ValueError(f"unknown model kind {cfg.kind!r}")
