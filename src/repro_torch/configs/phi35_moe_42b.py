"""Phi-3.5-MoE (42B total / 6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct].

32L, d_model 4096, 32 heads (GQA kv=8), d_ff 6400, vocab 32064,
MoE 16 experts top-2 in every layer. 16 experts == model-axis size, so
expert parallelism maps 1:1 onto the production mesh.
"""

from .base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", kind="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=6400,
    vocab=32064, rope_theta=10_000.0,
    moe=MoEConfig(n_experts=16, top_k=2, every=1),
)

REDUCED = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=192, vocab=512,
    moe=MoEConfig(n_experts=4, top_k=2, every=1), attn_chunk=64)
