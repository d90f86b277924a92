"""Model factory: the kinds this port runs so far."""

from __future__ import annotations

from ..configs import ModelConfig
from .hybrid import HybridModel
from .rwkv_model import RWKVModel
from .transformer import TransformerModel


def build_model(cfg: ModelConfig
                ) -> TransformerModel | RWKVModel | HybridModel:
    """The model for `cfg`. The dense and MoE transformers (without a
    sliding window), RWKV-6 and the Jamba hybrid are ported; VLM and
    encoder-decoder models raise."""
    if cfg.kind in ("dense", "moe"):
        return TransformerModel(cfg)
    if cfg.kind == "rwkv":
        return RWKVModel(cfg)
    if cfg.kind == "hybrid":
        return HybridModel(cfg)
    if cfg.kind in ("vlm", "encdec"):
        raise NotImplementedError(
            f"{cfg.name}: model kind {cfg.kind!r} is not ported yet (ROADMAP "
            "queue 1, item 7)")
    raise ValueError(f"unknown model kind {cfg.kind!r}")
