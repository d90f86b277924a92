"""Model configuration dataclasses for the assigned architecture pool.

One `ModelConfig` describes any of the 10 architectures; per-arch files in
this package pin the exact published numbers. `reduced()` variants are used
by CPU smoke tests; the full configs are only ever lowered via the dry-run
(ShapeDtypeStruct, no allocation).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int = 2
    every: int = 1            # MoE FFN every k-th layer (jamba: 2)
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


@dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str                 # dense | moe | vlm | encdec | rwkv | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int | None = None      # default d_model // n_heads
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen1.5 / qwen2-vl
    rope: str = "1d"                 # "1d" | "mrope" (qwen2-vl)
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    rope_theta: float = 1_000_000.0
    swa: int | None = None           # sliding-window size (mixtral)
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    attn_every: int | None = None    # hybrid: 1 attention layer per k layers
    n_dec_layers: int | None = None  # encdec: decoder depth (n_layers = enc)
    rwkv_head_dim: int = 64          # rwkv6
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # runtime knobs (not architecture):
    attn_chunk: int = 512            # q-chunk for blockwise attention
    remat: str = "dots"              # "none" | "dots" | "full"
    scan_layers: bool = True
    moe_impl: str = "global"         # "global" (baseline) | "grouped" (opt)
    kv_quant: bool = False           # int8 KV cache (opt decode variant)
    ce_chunk: int = 512              # CE sequence chunk; opt uses full-S
    #   (per-chunk scan re-reduces the lm_head grad every chunk — §Perf)

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # ------------------------------------------------------- parameter count
    def param_count(self) -> int:
        """Exact parameter count of this implementation (used for 6ND)."""
        D, F, V, H, dh, KV = (self.d_model, self.d_ff, self.vocab,
                              self.n_heads, self.dh, self.n_kv)
        if self.kind == "rwkv":
            return _rwkv_params(self)
        att = D * (H * dh) + 2 * D * (KV * dh) + (H * dh) * D
        if self.qkv_bias:
            att += H * dh + 2 * KV * dh
        if self.qk_norm:
            att += 2 * dh
        ffn_dense = 3 * D * F
        emb = V * D * (1 if self.tie_embeddings else 2)
        norms_per_layer = 2 * D

        def ffn_at(i: int) -> int:
            if self.moe is not None and (i % self.moe.every
                                         == self.moe.every - 1):
                return self.moe.n_experts * ffn_dense + D * self.moe.n_experts
            return ffn_dense

        def mixer_at(i: int) -> int:
            if self.attn_every is not None and (i % self.attn_every
                                                != self.attn_every - 1):
                return _mamba_params(self)
            return att

        total = emb + D  # final norm
        for i in range(self.n_layers):
            total += mixer_at(i) + ffn_at(i) + norms_per_layer
        if self.n_dec_layers:
            for i in range(self.n_dec_layers):
                # self-attn + cross-attn + ffn + 3 norms
                total += 2 * att + ffn_dense + 3 * D
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        dense_ffn = 3 * D * F
        inactive_per_moe_layer = (self.moe.n_experts - self.moe.top_k) * dense_ffn
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if i % self.moe.every == self.moe.every - 1)
        return self.param_count() - n_moe_layers * inactive_per_moe_layer


def _mamba_params(cfg: ModelConfig) -> int:
    m = cfg.mamba
    D = cfg.d_model
    di, ds, dc = m.d_inner(D), m.d_state, m.d_conv
    dt_rank = max(D // 16, 1)
    return (D * 2 * di            # in_proj (x, z)
            + di * dc             # depthwise conv
            + di * (dt_rank + 2 * ds)   # x_proj -> (dt, B, C)
            + dt_rank * di + di   # dt_proj
            + di * ds + di        # A_log, D
            + di * D)             # out_proj


def _rwkv_params(cfg: ModelConfig) -> int:
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    lora_w, lora_mix = 64, 32
    tmix = (5 * D * D                    # r k v g o projections
            + 5 * D                      # token-shift mus (r,k,v,g,w)
            + D + lora_w * D * 2         # decay base + lora
            + 5 * (D * lora_mix + lora_mix * D)  # data-dependent mix loras
            + D                          # bonus u
            + 2 * (D // cfg.rwkv_head_dim) * cfg.rwkv_head_dim)  # group norm
    cmix = 2 * D + D * F + F * D         # token-shift mus + two mats
    return V * D * 2 + D + cfg.n_layers * (tmix + cmix + 2 * D)
