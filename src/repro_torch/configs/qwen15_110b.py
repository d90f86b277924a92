"""Qwen1.5-110B [hf:Qwen/Qwen1.5 family; hf].

80L, d_model 8192, 64 heads (GQA kv=8), d_ff 49152, vocab 152064, QKV bias.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", kind="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv=8, d_ff=49152,
    vocab=152064, qkv_bias=True, rope_theta=1_000_000.0,
)

REDUCED = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=384, vocab=512,
    attn_chunk=64)
