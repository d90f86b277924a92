"""Mixtral 8x22B [arXiv:2401.04088; hf].

56L, d_model 6144, 48 heads (GQA kv=8), d_ff 16384, vocab 32768,
MoE 8 experts top-2, sliding-window attention. SWA gives a bounded
rolling KV cache, so the long_500k decode cell RUNS for this arch.
"""

from .base import MoEConfig, ModelConfig

SWA_WINDOW = 4096

CONFIG = ModelConfig(
    name="mixtral-8x22b", kind="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv=8, d_ff=16384,
    vocab=32768, swa=SWA_WINDOW, rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=8, top_k=2, every=1),
)

REDUCED = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
    swa=64, moe=MoEConfig(n_experts=4, top_k=2, every=1), attn_chunk=32)
