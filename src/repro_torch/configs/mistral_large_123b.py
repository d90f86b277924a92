"""Mistral-Large-123B [hf:mistralai/Mistral-Large-Instruct-2407; unverified].

88L, d_model 12288, 96 heads (GQA kv=8), d_ff 28672, vocab 32768.
Largest dense arch in the pool — the FSDP stress test.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", kind="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv=8, d_ff=28672,
    vocab=32768, head_dim=128, rope_theta=1_000_000.0,
)

REDUCED = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
    head_dim=32, attn_chunk=64)
