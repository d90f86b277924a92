"""RWKV-6 "Finch" [arXiv:2404.05892]: attention-free LM with
data-dependent per-channel decay.

Mirrors `repro/models/rwkv6.py` over a tree of tensors, without its
`rules` argument. Time-mix: token-shift lerps with LoRA-produced
data-dependent mixing, r/k/v/g projections, decay w_t = exp(-exp(w0 +
lora(x))) ∈ (0, 1), and the wkv linear recurrence over a float32 state
S[h, i, j] (key index i, value index j):

    out_t = r_t · (S_{t-1} + u ⊙ k_t ⊗ v_t)
    S_t   = diag(w_t) S_{t-1} + k_t ⊗ v_t

The recurrence goes through `kernels.rwkv.ops.wkv`: on a card the
hand-written wkv kernel (or, with `wkv_impl="ref"`, its plain PyTorch
version, for comparison), on the CPU the plain version. The JAX model's
own two-level chunked form (`wkv_chunked`) is not copied: the tests hold
this model, through the plain version, against the JAX model through it.
Each step keeps the JAX package's dtypes: norms in float32 cast back,
products in the parameters' dtype, the decay in float32, the wkv output
cast to r's dtype before the group norm.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.rwkv.ops import wkv
from .common import Desc

LORA_MIX = 32
LORA_W = 64


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)   # as jnp.var
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def group_norm_heads(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     n_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm with one group per head over the flattened (H*dh) dim."""
    shape = x.shape
    x32 = x.reshape(shape[:-1] + (n_heads, shape[-1] // n_heads)).float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    normed = ((x32 - mu) * torch.rsqrt(var + eps)).reshape(shape)
    return normed.to(x.dtype) * w + b


def rwkv_layer_desc(cfg: ModelConfig) -> dict:
    D, F_, H = cfg.d_model, cfg.d_ff, cfg.n_heads
    dh = cfg.rwkv_head_dim
    assert H * dh == D, (H, dh, D)
    return {
        "ln1_w": Desc((D,), init="ones"),
        "ln1_b": Desc((D,), init="zeros"),
        "ln2_w": Desc((D,), init="ones"),
        "ln2_b": Desc((D,), init="zeros"),
        # time-mix
        "mu_x": Desc((D,), init="zeros"),
        "mu_rkvgw": Desc((5, D), init="zeros"),
        "tm_w1": Desc((D, 5 * LORA_MIX)),
        "tm_w2": Desc((5, LORA_MIX, D)),
        "wr": Desc((D, D)),
        "wk": Desc((D, D)),
        "wv": Desc((D, D)),
        "wg": Desc((D, D)),
        "wo": Desc((D, D)),
        "w0": Desc((D,), init="scaled", scale=0.5),
        "w1": Desc((D, LORA_W)),
        "w2": Desc((LORA_W, D)),
        "u": Desc((H, dh), init="scaled", scale=0.5),
        "lnx_w": Desc((D,), init="ones"),
        "lnx_b": Desc((D,), init="zeros"),
        # channel-mix
        "cmu_k": Desc((D,), init="zeros"),
        "cmu_r": Desc((D,), init="zeros"),
        "ck": Desc((D, F_)),
        "cv": Desc((F_, D)),
        "cr": Desc((D, D)),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x_{t-1} along axis 1; `prev` (B, D) seeds t=0 (decode), else 0."""
    if prev is None:
        prev = torch.zeros_like(x[:, 0])
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _time_mix_inputs(x: torch.Tensor, xprev: torch.Tensor, p: dict,
                     cfg: ModelConfig):
    """Data-dependent token-shift lerps → (r, k, v, g, logw)."""
    B, S, D = x.shape
    H, dh = cfg.n_heads, cfg.rwkv_head_dim
    dx = xprev - x
    xxx = x + dx * p["mu_x"]
    lora = torch.tanh(xxx @ p["tm_w1"]).reshape(B, S, 5, LORA_MIX)
    deltas = torch.einsum("bsfm,fmd->bsfd", lora, p["tm_w2"])   # (B,S,5,D)
    mixed = x[:, :, None] + dx[:, :, None] * (p["mu_rkvgw"] + deltas)
    xr, xk, xv, xg, xw = mixed.unbind(dim=2)
    r = (xr @ p["wr"]).reshape(B, S, H, dh)
    k = (xk @ p["wk"]).reshape(B, S, H, dh)
    v = (xv @ p["wv"]).reshape(B, S, H, dh)
    g = F.silu(xg @ p["wg"])
    # w0 (bf16) + a float32 product promotes to float32, as in JAX
    w_raw = p["w0"] + ((xw @ p["w1"]) @ p["w2"]).float()
    logw = -torch.exp(w_raw.float()).reshape(B, S, H, dh)   # log decay < 0
    return r, k, v, g, logw


def rwkv_time_mix(x: torch.Tensor, p: dict, cfg: ModelConfig,
                  state: dict | None = None, wkv_impl: str = "cuda"
                  ) -> tuple[torch.Tensor, dict]:
    B, S, D = x.shape
    H = cfg.n_heads
    prev = state["shift_t"] if state else None
    s0 = state["S"] if state else None                      # None: zeros
    xprev = _token_shift(x, prev)
    r, k, v, g, logw = _time_mix_inputs(x, xprev, p, cfg)
    out, s_fin = wkv(r, k, v, torch.exp(logw), p["u"].float(), s0,
                     impl=wkv_impl, device=x.device)
    out = group_norm_heads(out.to(r.dtype).reshape(B, S, D), p["lnx_w"],
                           p["lnx_b"], H)
    out = (out * g) @ p["wo"]
    return out, {"shift_t": x[:, -1], "S": s_fin}


def rwkv_channel_mix(x: torch.Tensor, p: dict, state: dict | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    prev = state["shift_c"] if state else None
    dx = _token_shift(x, prev) - x
    xk = x + dx * p["cmu_k"]
    xr = x + dx * p["cmu_r"]
    k = torch.square(torch.relu(xk @ p["ck"]))
    val = k @ p["cv"]
    rgate = torch.sigmoid(xr @ p["cr"])
    return rgate * val, x[:, -1]


def rwkv_layer(x: torch.Tensor, p: dict, cfg: ModelConfig,
               state: dict | None = None, wkv_impl: str = "cuda"
               ) -> tuple[torch.Tensor, dict]:
    tm_in = layer_norm(x, p["ln1_w"], p["ln1_b"], cfg.norm_eps)
    tm_out, tstate = rwkv_time_mix(tm_in, p, cfg, state, wkv_impl)
    x = x + tm_out
    cm_in = layer_norm(x, p["ln2_w"], p["ln2_b"], cfg.norm_eps)
    cm_out, shift_c = rwkv_channel_mix(cm_in, p, state)
    x = x + cm_out
    return x, {"shift_t": tstate["shift_t"], "S": tstate["S"],
               "shift_c": shift_c}


def rwkv_state_desc(cfg: ModelConfig, batch: int) -> dict:
    D, H, dh = cfg.d_model, cfg.n_heads, cfg.rwkv_head_dim
    return {
        "shift_t": Desc((batch, D), init="zeros"),
        "shift_c": Desc((batch, D), init="zeros"),
        "S": Desc((batch, H, dh, dh), init="zeros", dtype=torch.float32),
    }
