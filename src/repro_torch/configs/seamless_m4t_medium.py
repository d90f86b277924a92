"""SeamlessM4T-medium backbone [arXiv:2308.11596; hf].

Encoder-decoder, d_model 1024, 16 heads (kv=16 → full MHA), d_ff 4096,
vocab 256206. We build 12 encoder + 12 decoder layers. The audio frontend
(fbank conv feature extractor) is a stub: `input_specs()` provides
precomputed frame embeddings of shape (B, S_enc, d_model).
"""

from .base import ModelConfig

ENC_FRAMES = 4096   # encoder memory length used by decode shape cells

CONFIG = ModelConfig(
    name="seamless-m4t-medium", kind="encdec",
    n_layers=12, n_dec_layers=12, d_model=1024, n_heads=16, n_kv=16,
    d_ff=4096, vocab=256206, rope_theta=10_000.0,
)

REDUCED = CONFIG.with_(
    n_layers=2, n_dec_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=256,
    vocab=512, attn_chunk=64)
