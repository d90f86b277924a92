"""RWKV-6 (Finch) 3B [arXiv:2404.05892; hf].

32L, d_model 2560, attention-free (data-dependent decay linear recurrence),
d_ff 8960, vocab 65536, head size 64 (40 heads). Constant-size recurrent
state → the long_500k decode cell RUNS for this arch.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", kind="rwkv",
    n_layers=32, d_model=2560, n_heads=40, n_kv=40, d_ff=8960,
    vocab=65536, rwkv_head_dim=64,
)

REDUCED = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=512,
    rwkv_head_dim=32)
