"""Transformer building blocks: RMSNorm, RoPE, GQA attention projections
and the SwiGLU FFN.

Each keeps the JAX package's dtype steps (`repro/models/blocks.py`): norms
and RoPE compute in float32 and cast back, matrix products run in the
parameters' dtype. Attention itself is not written here: the model calls
`kernels.attention.ops.attention` with explicit positions, which runs the
hand-written flash kernel on a card. M-RoPE (VLM) and the MoE FFN wait
for their own slices (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import Desc


# ---------------------------------------------------------------------- norm
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    x32 = x.float()
    var = x32.pow(2).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


# ---------------------------------------------------------------------- rope
def rope_cos_sin(positions: torch.Tensor, dh: int, theta: float):
    """cos/sin tables (…, S, dh // 2) in float32 for 1-D RoPE.

    The inverse frequencies are computed in float32 on the positions'
    device, as the JAX package computes them with numpy (equal to an
    ulp): a host-to-device copy here would make every decode step wait
    for the card to finish the step before it."""
    half = dh // 2
    inv = 1.0 / theta ** (torch.arange(0, half, dtype=torch.float32,
                                       device=positions.device) / half)
    freqs = positions[..., None].float() * inv
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (B, S, H, dh); cos/sin: (S, half) or (B, S, half)."""
    half = x.shape[-1] // 2
    cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention
def attention_desc(cfg: ModelConfig) -> dict:
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.dh
    p = {
        "wq": Desc((D, H * dh)),
        "wk": Desc((D, KV * dh)),
        "wv": Desc((D, KV * dh)),
        "wo": Desc((H * dh, D)),
    }
    if cfg.qkv_bias:
        p["bq"] = Desc((H * dh,), init="zeros")
        p["bk"] = Desc((KV * dh,), init="zeros")
        p["bv"] = Desc((KV * dh,), init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = Desc((dh,), init="ones")
        p["k_norm"] = Desc((dh,), init="ones")
    return p


def qkv_project(x: torch.Tensor, p: dict, cfg: ModelConfig):
    """(B, S, D) → q (B, S, H, dh), k and v (B, S, KV, dh), with optional
    bias and per-head QK-norm (after the reshape, before RoPE)."""
    B, S, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv, cfg.dh
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, KV, dh)
    v = v.reshape(B, S, KV, dh)
    if "q_norm" in p:                      # qwen3: per-head RMS on q, k
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def attn_out(attn: torch.Tensor, p: dict) -> torch.Tensor:
    B, S, H, dh = attn.shape
    return attn.reshape(B, S, H * dh) @ p["wo"]


# ---------------------------------------------------------------------- ffn
def ffn_desc(cfg: ModelConfig) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return {"w_in": Desc((D, Fd)), "w_gate": Desc((D, Fd)),
            "w_out": Desc((Fd, D))}


def swiglu_ffn(x: torch.Tensor, p: dict) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_in"])) @ p["w_out"]
