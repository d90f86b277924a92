"""Jamba v0.1 52B [arXiv:2403.19887; hf].

32L hybrid: attention : mamba = 1 : 7 (one attention layer per 8),
d_model 4096, 32 heads (GQA kv=8), d_ff 14336, MoE 16 experts top-2 every
second layer, vocab 65536. Mamba state + only 4 KV-cached layers → the
long_500k decode cell RUNS for this arch.
"""

from .base import MambaConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", kind="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
    vocab=65536, attn_every=8, rope_theta=10_000.0,
    moe=MoEConfig(n_experts=16, top_k=2, every=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
)

REDUCED = CONFIG.with_(
    n_layers=8, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
    attn_every=4, moe=MoEConfig(n_experts=4, top_k=2, every=2),
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2), attn_chunk=32)
