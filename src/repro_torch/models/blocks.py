"""Transformer building blocks: RMSNorm, RoPE and M-RoPE, GQA attention
projections (self and cross), the SwiGLU FFN and the top-k MoE FFN.

Each keeps the JAX package's dtype steps (`repro/models/blocks.py`): norms
and RoPE compute in float32 and cast back, matrix products run in the
parameters' dtype, the MoE router in float32. Attention itself is not
written here: the model calls `kernels.attention.ops.attention` with
explicit positions, which runs the hand-written flash kernel on a card.
The MoE FFN is plain PyTorch (top-k, gathers, batched products over the
experts, `index_add_`), as JAX computes it outside any Pallas kernel.
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
def rope_cos_sin(positions: torch.Tensor, dh: int, theta: float,
                 sections: tuple[int, int, int] | None = None):
    """cos/sin tables (…, S, dh // 2) in float32.

    positions: (…, S) for 1-D RoPE, or (…, S, 3) for M-RoPE (Qwen2-VL:
    the temporal, height and width ids each turn their own `sections`
    of the frequency bands). The inverse frequencies are computed in
    float32 on the positions' device, as the JAX package computes them
    with numpy (equal to an ulp): a host-to-device copy here would make
    every decode step wait for the card to finish the step before it."""
    half = dh // 2
    inv = 1.0 / theta ** (torch.arange(0, half, dtype=torch.float32,
                                       device=positions.device) / half)
    if sections is None:
        freqs = positions[..., None].float() * inv
    else:
        if sum(sections) != half:
            raise ValueError(f"M-RoPE sections {sections} must sum to "
                             f"dh // 2 = {half}")
        pos = positions.float()                          # (…, S, 3)
        bounds = [0, sections[0], sections[0] + sections[1], half]
        freqs = torch.cat([pos[..., i:i + 1] * inv[bounds[i]:bounds[i + 1]]
                           for i in range(3)], dim=-1)   # (…, S, half)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (B, S, H, dh); cos/sin: (S, half) or (B, S, half)."""
    half = x.shape[-1] // 2
    cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention
def attention_desc(cfg: ModelConfig, cross: bool = False) -> dict:
    """Q/K/V/O projections; a cross-attention block (`cross`) has neither
    bias nor QK-norm, as in the JAX package."""
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.dh
    p = {
        "wq": Desc((D, H * dh)),
        "wk": Desc((D, KV * dh)),
        "wv": Desc((D, KV * dh)),
        "wo": Desc((H * dh, D)),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = Desc((H * dh,), init="zeros")
        p["bk"] = Desc((KV * dh,), init="zeros")
        p["bv"] = Desc((KV * dh,), init="zeros")
    if cfg.qk_norm and not cross:
        p["q_norm"] = Desc((dh,), init="ones")
        p["k_norm"] = Desc((dh,), init="ones")
    return p


def qkv_project(x: torch.Tensor, p: dict, cfg: ModelConfig,
                kv_x: torch.Tensor | None = None):
    """(B, S, D) → q (B, S, H, dh), k and v (B, Tk, KV, dh), with optional
    bias and per-head QK-norm (after the reshape, before RoPE). K and V
    project `kv_x` (B, Tk, D) for cross-attention, else x itself."""
    B, S, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv, cfg.dh
    src = x if kv_x is None else kv_x
    Tk = src.shape[1]
    q, k, v = x @ p["wq"], src @ p["wk"], src @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, Tk, KV, dh)
    v = v.reshape(B, Tk, KV, dh)
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


# ---------------------------------------------------------------------- moe
def moe_desc(cfg: ModelConfig) -> dict:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return {
        "router": Desc((D, E), dtype=torch.float32),
        "w_in": Desc((E, D, Fd)),
        "w_gate": Desc((E, D, Fd)),
        "w_out": Desc((E, Fd, D)),
    }


def moe_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.moe_impl == "grouped":
        return moe_ffn_grouped(x, p, cfg)
    return moe_ffn_global(x, p, cfg)


def _route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """float32 router → `keep` (…, E): each token's renormalised top-k
    router probabilities on its chosen experts, zeros elsewhere."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    top_vals, top_idx = torch.topk(probs, top_k, dim=-1)
    top_vals = top_vals / top_vals.sum(-1, keepdim=True)
    # one nonzero term per (token, expert): JAX's one-hot sum, exactly
    return torch.zeros_like(probs).scatter_(-1, top_idx, top_vals)


def _experts(xg: torch.Tensor, p: dict, gate: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its gathered tokens xg (…, E, C, D),
    weighted by `gate` (…, E, C); a slot whose gate is 0 contributes 0."""
    h = F.silu(torch.einsum("...ecd,edf->...ecf", xg, p["w_gate"])) \
        * torch.einsum("...ecd,edf->...ecf", xg, p["w_in"])
    y = torch.einsum("...ecf,efd->...ecd", h, p["w_out"])
    return y * (gate * (gate > 0.0))[..., None].to(y.dtype)


def moe_ffn_global(x: torch.Tensor, p: dict, cfg: ModelConfig
                   ) -> torch.Tensor:
    """Token-choice top-k MoE with per-expert capacity over the whole
    token pool (GShard-style dropping, highest router probability first):
    gather → batched product over the experts → scatter-add, as JAX's
    `moe_ffn_global`. Each expert takes its C highest-`keep` tokens; with
    fewer than C routed to it, `topk` fills the rest from tokens of
    `keep` 0, whose order among themselves may differ from `lax.top_k`'s
    — they carry gate 0 and add 0, so the result does not depend on it.
    A token gets at most top_k contributions onto zeros, and a sum of two
    terms does not depend on their order, so `index_add_` (atomics on a
    card) gives JAX's `.at[].add` bit for bit."""
    moe = cfg.moe
    B, S, D = x.shape
    N = B * S
    E, K = moe.n_experts, moe.top_k
    xf = x.reshape(N, D)
    keep = _route(xf, p["router"], K)                      # (N, E)
    C = max(int(moe.capacity_factor * K * N / E), 1)
    C = min(C, N)
    gate_t, tok_idx = torch.topk(keep.T, C, dim=-1)        # (E, C)
    xg = xf[tok_idx.reshape(-1)].reshape(E, C, D)
    y = _experts(xg, p, gate_t)
    out = torch.zeros((N, D), dtype=y.dtype, device=x.device)
    out.index_add_(0, tok_idx.reshape(-1), y.reshape(E * C, D))
    return out.reshape(B, S, D)


def moe_ffn_grouped(x: torch.Tensor, p: dict, cfg: ModelConfig
                    ) -> torch.Tensor:
    """The same MoE with capacity per batch row, as JAX's
    `moe_ffn_grouped`: routing, top-C, gather and scatter-add stay within
    each row."""
    moe = cfg.moe
    B, S, D = x.shape
    E, K = moe.n_experts, moe.top_k
    keep = _route(x, p["router"], K)                       # (B, S, E)
    C = max(min(int(moe.capacity_factor * K * S / E), S), 1)
    gate_t, tok_idx = torch.topk(keep.transpose(1, 2), C, dim=-1)  # (B,E,C)
    rows = torch.arange(B, device=x.device)[:, None, None]
    xg = x[rows, tok_idx]                                  # (B, E, C, D)
    y = _experts(xg, p, gate_t)
    out = torch.zeros((B * S, D), dtype=y.dtype, device=x.device)
    out.index_add_(0, (rows * S + tok_idx).reshape(-1), y.reshape(-1, D))
    return out.reshape(B, S, D)
