"""Granite-20B code model [arXiv:2405.04324; hf].

52L, d_model 6144, 48 heads, MQA (kv=1), d_ff 24576, vocab 49152,
llama-style architecture.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", kind="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv=1, d_ff=24576,
    vocab=49152, rope_theta=10_000.0,
)

REDUCED = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv=1, d_ff=256, vocab=512,
    attn_chunk=64)
