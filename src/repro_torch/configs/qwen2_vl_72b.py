"""Qwen2-VL-72B backbone [arXiv:2409.12191; hf].

80L, d_model 8192, 64 heads (GQA kv=8), d_ff 29568, vocab 152064, M-RoPE.
The vision frontend is a stub: `input_specs()` feeds precomputed patch
embeddings alongside text tokens, with 3-D (t, h, w) M-RoPE position ids.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", kind="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv=8, d_ff=29568,
    vocab=152064, qkv_bias=True, rope="mrope", mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
)

REDUCED = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
    mrope_sections=(4, 6, 6), attn_chunk=64)
