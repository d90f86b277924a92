"""Qwen3-32B [hf:Qwen/Qwen3-8B family; hf].

64L, d_model 5120, 64 heads (GQA kv=8), d_ff 25600, vocab 151936,
QK-norm (RMSNorm on per-head q and k), head_dim 128.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", kind="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv=8, d_ff=25600,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1_000_000.0,
)

REDUCED = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
    head_dim=32, attn_chunk=64)
