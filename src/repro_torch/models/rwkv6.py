"""RWKV-6 "Finch" [arXiv:2404.05892]: attention-free LM with
data-dependent per-channel decay.

Mirrors `repro/models/rwkv6.py` over a tree of tensors, with its
`rules` argument (`models.common.AxisRules`, default `NULL_RULES`: one
card) and its constraint sites. Time-mix: token-shift lerps with LoRA-produced
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
Under a mesh the kernel runs on each rank's local heads (`rules.local`):
r, k, v and w are sharded over "tp" by heads (D = H·dh), `u` is cut to
the rank's heads, and the state enters as (dp, tp, -, -) by heads and
leaves in the cache's placement, sharded on its last dh axis as the JAX
package stores it.
Each step keeps the JAX package's dtypes: norms in float32 cast back,
products in the parameters' dtype, the decay in float32, the wkv output
cast to r's dtype before the group norm.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.rwkv.ops import wkv
from .blocks import split_heads
from .common import NULL_RULES, AxisRules, Desc

LORA_MIX = 32
LORA_W = 64


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)   # as jnp.var
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def group_norm_heads(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     n_heads: int, eps: float = 1e-5,
                     rules: AxisRules = NULL_RULES) -> torch.Tensor:
    """GroupNorm with one group per head over the flattened (H*dh) dim.
    Under a mesh the flattened result is pinned to ("dp", None, None), so
    that its gradient, which the products after it may shard over "tp",
    is gathered before the heads are split again in backward: DTensor
    cannot unflatten an uneven split (40 heads over 16 ranks)."""
    shape = x.shape
    x32 = x.reshape(shape[:-1] + (n_heads, shape[-1] // n_heads)).float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    normed = rules.constrain(((x32 - mu) * torch.rsqrt(var + eps)).reshape(
        shape), "dp", None, None)
    return normed.to(x.dtype) * w + b


def rwkv_layer_desc(cfg: ModelConfig) -> dict:
    D, F_, H = cfg.d_model, cfg.d_ff, cfg.n_heads
    dh = cfg.rwkv_head_dim
    assert H * dh == D, (H, dh, D)
    return {
        "ln1_w": Desc((D,), (None,), init="ones"),
        "ln1_b": Desc((D,), (None,), init="zeros"),
        "ln2_w": Desc((D,), (None,), init="ones"),
        "ln2_b": Desc((D,), (None,), init="zeros"),
        # time-mix
        "mu_x": Desc((D,), (None,), init="zeros"),
        "mu_rkvgw": Desc((5, D), (None, None), init="zeros"),
        "tm_w1": Desc((D, 5 * LORA_MIX), ("fsdp", None)),
        "tm_w2": Desc((5, LORA_MIX, D), (None, None, "fsdp")),
        "wr": Desc((D, D), ("fsdp", "tp")),
        "wk": Desc((D, D), ("fsdp", "tp")),
        "wv": Desc((D, D), ("fsdp", "tp")),
        "wg": Desc((D, D), ("fsdp", "tp")),
        "wo": Desc((D, D), ("tp", "fsdp")),
        "w0": Desc((D,), (None,), init="scaled", scale=0.5),
        "w1": Desc((D, LORA_W), ("fsdp", None)),
        "w2": Desc((LORA_W, D), (None, "fsdp")),
        "u": Desc((H, dh), (None, None), init="scaled", scale=0.5),
        "lnx_w": Desc((D,), (None,), init="ones"),
        "lnx_b": Desc((D,), (None,), init="zeros"),
        # channel-mix
        "cmu_k": Desc((D,), (None,), init="zeros"),
        "cmu_r": Desc((D,), (None,), init="zeros"),
        "ck": Desc((D, F_), ("fsdp", "tp")),
        "cv": Desc((F_, D), ("tp", "fsdp")),
        "cr": Desc((D, D), ("fsdp", "tp")),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x_{t-1} along axis 1; `prev` (B, D) seeds t=0 (decode), else 0."""
    if prev is None:
        prev = torch.zeros_like(x[:, 0])
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _time_mix_inputs(x: torch.Tensor, xprev: torch.Tensor, p: dict,
                     cfg: ModelConfig, rules: AxisRules = NULL_RULES):
    """Data-dependent token-shift lerps → (r, k, v, g, logw). Under a
    mesh the LoRA (two narrow products, split into five parts between
    them) runs on each rank's rows with its weights whole (`rules.local`,
    their gradients partial sums over the "dp" ranks): DTensor would
    otherwise shard the five parts unevenly."""
    B, S, D = x.shape
    H, dh = cfg.n_heads, cfg.rwkv_head_dim
    dx = xprev - x
    xxx = x + dx * p["mu_x"]

    def lora(xxx, w1, w2):
        h = torch.tanh(xxx @ w1).reshape(*xxx.shape[:2], 5, LORA_MIX)
        return torch.einsum("bsfm,fmd->bsfd", h, w2)       # (B,S,5,D)

    if rules.mesh is not None:
        xpl = rules.placements(("dp", None, None), tuple(x.shape))
        w1pl, w2pl = (rules.placements((None,) * p[n].dim())
                      for n in ("tm_w1", "tm_w2"))
        batch = rules.split_by(("dp", None, None), x.shape, 0)
        lora = rules.local(
            lora, ins=(xpl, w1pl, w2pl),
            outs=(rules.placements(("dp", None, None, None),
                                   (B, S, 5, D)),),
            grads=(xpl, rules.partial(w1pl, batch),
                   rules.partial(w2pl, batch)))
    deltas = lora(xxx, p["tm_w1"], p["tm_w2"])
    mixed = x[:, :, None] + dx[:, :, None] * (p["mu_rkvgw"] + deltas)
    xr, xk, xv, xg, xw = mixed.unbind(dim=2)
    r = split_heads(xr @ p["wr"], H, rules)
    k = split_heads(xk @ p["wk"], H, rules)
    v = split_heads(xv @ p["wv"], H, rules)
    g = F.silu(xg @ p["wg"])
    # w0 (bf16) + a float32 product promotes to float32, as in JAX
    w_raw = p["w0"] + ((xw @ p["w1"]) @ p["w2"]).float()
    logw = -torch.exp(w_raw.float()).reshape(B, S, H, dh)   # log decay < 0
    return r, k, v, g, logw


def _wkv(r, k, v, w, u, s0, rules: AxisRules, impl: str, device):
    """`kernels.rwkv.ops.wkv`; under a mesh on each rank's local heads,
    `u`'s gradient a partial sum over the "dp" ranks (it sums over the
    batch), the final state returned in the cache's placement."""
    if rules.mesh is None:
        return wkv(r, k, v, w, u, s0, impl=impl, device=device)
    heads = ("dp", None, "tp", None)
    xpl = rules.placements(heads, tuple(r.shape))
    upl = rules.placements(("tp", None), tuple(u.shape))
    spl = rules.placements(("dp", "tp", None, None),
                           (r.shape[0], r.shape[2], r.shape[3], r.shape[3]))

    def local(r, k, v, w, u, s0):
        return wkv(r, k, v, w, u, s0, impl=impl, device=device)

    out, s_fin = rules.local(
        local, ins=(xpl,) * 4 + (upl, None if s0 is None else spl),
        outs=(xpl, spl),
        grads=(xpl,) * 4 + (rules.partial(upl, rules.split_by(
            heads, r.shape, 0)),
                            None if s0 is None else spl))(r, k, v, w, u, s0)
    return out, rules.constrain(s_fin, "dp", None, None, "tp")


def rwkv_time_mix(x: torch.Tensor, p: dict, cfg: ModelConfig,
                  state: dict | None = None, wkv_impl: str = "cuda",
                  rules: AxisRules = NULL_RULES
                  ) -> tuple[torch.Tensor, dict]:
    B, S, D = x.shape
    H = cfg.n_heads
    prev = state["shift_t"] if state else None
    s0 = state["S"] if state else None                      # None: zeros
    xprev = _token_shift(x, prev)
    r, k, v, g, logw = _time_mix_inputs(x, xprev, p, cfg, rules)
    out, s_fin = _wkv(r, k, v, torch.exp(logw), p["u"].float(), s0, rules,
                      wkv_impl, x.device)
    out = group_norm_heads(out.to(r.dtype).reshape(B, S, D), p["lnx_w"],
                           p["lnx_b"], H, rules=rules)
    out = (out * g) @ p["wo"]
    return rules.constrain(out, "dp", None, None), {"shift_t": x[:, -1],
                                                    "S": s_fin}


def rwkv_channel_mix(x: torch.Tensor, p: dict, state: dict | None = None,
                     rules: AxisRules = NULL_RULES
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    prev = state["shift_c"] if state else None
    dx = _token_shift(x, prev) - x
    xk = x + dx * p["cmu_k"]
    xr = x + dx * p["cmu_r"]
    k = rules.constrain(torch.square(torch.relu(xk @ p["ck"])),
                        "dp", None, "tp")
    val = k @ p["cv"]
    rgate = torch.sigmoid(xr @ p["cr"])
    return rules.constrain(rgate * val, "dp", None, None), x[:, -1]


def rwkv_layer(x: torch.Tensor, p: dict, cfg: ModelConfig,
               state: dict | None = None, wkv_impl: str = "cuda",
               rules: AxisRules = NULL_RULES) -> tuple[torch.Tensor, dict]:
    p = rules.gathered(p)
    tm_in = layer_norm(x, p["ln1_w"], p["ln1_b"], cfg.norm_eps)
    tm_out, tstate = rwkv_time_mix(tm_in, p, cfg, state, wkv_impl, rules)
    x = x + tm_out
    cm_in = layer_norm(x, p["ln2_w"], p["ln2_b"], cfg.norm_eps)
    cm_out, shift_c = rwkv_channel_mix(cm_in, p, state, rules)
    x = x + cm_out
    return x, {"shift_t": tstate["shift_t"], "S": tstate["S"],
               "shift_c": shift_c}


def rwkv_state_desc(cfg: ModelConfig, batch: int) -> dict:
    D, H, dh = cfg.d_model, cfg.n_heads, cfg.rwkv_head_dim
    return {
        "shift_t": Desc((batch, D), ("dp", None), init="zeros"),
        "shift_c": Desc((batch, D), ("dp", None), init="zeros"),
        "S": Desc((batch, H, dh, dh), ("dp", None, None, "tp"), init="zeros",
                  dtype=torch.float32),
    }
