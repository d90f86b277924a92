"""Mamba (S6) selective-state-space block [arXiv:2312.00752], used by the
Jamba hybrid architecture.

Mirrors `repro/models/mamba.py` over a tree of tensors, without its
`rules` argument. The diagonal recurrence

    h_t = exp(dt_t · A) ⊙ h_{t-1} + (dt_t · B_t) x_t,    y_t = h_t · C_t

goes through `kernels.ssm.ops.selective_scan`, at prefill over the whole
prompt and at decode as one step from the cached state: on a card the
hand-written scan kernel (or, with `scan_impl="ref"`, its plain PyTorch
version, for comparison), on the CPU the plain version. The scan returns
y and the final state directly, so the JAX model's `chunked_diag_scan`
and its (B, S, d_inner, d_state) tensor of every state are not built.
Each step keeps the JAX package's dtypes: products in the parameters'
dtype, dt in that dtype and then float32, the scan in float32, y cast
back to the activations' dtype before the gate.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.ssm.ops import selective_scan
from .common import Desc


def mamba_desc(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    m = cfg.mamba
    di, ds, dc = m.d_inner(D), m.d_state, m.d_conv
    dt_rank = max(D // 16, 1)
    return {
        "in_proj": Desc((D, 2 * di)),
        "conv_w": Desc((dc, di)),
        "conv_b": Desc((di,), init="zeros"),
        "x_proj": Desc((di, dt_rank + 2 * ds)),
        "dt_w": Desc((dt_rank, di)),
        "dt_b": Desc((di,), init="ones"),
        "A_log": Desc((di, ds), init="scaled", scale=0.5,
                      dtype=torch.float32),
        "D": Desc((di,), init="ones", dtype=torch.float32),
        "out_proj": Desc((di, D)),
    }


def mamba_state_desc(cfg: ModelConfig, batch: int) -> dict:
    m = cfg.mamba
    di = m.d_inner(cfg.d_model)
    return {
        "conv": Desc((batch, m.d_conv - 1, di), init="zeros"),
        "h": Desc((batch, di, m.d_state), init="zeros", dtype=torch.float32),
    }


def _causal_dw_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                    ) -> torch.Tensor:
    """Depthwise causal conv1d as JAX writes it: d_conv shifted products
    summed in order (not `F.conv1d`, whose cuDNN path runs float32 in TF32
    and sums in another order). x: (B, S, di); w: (dc, di)."""
    dc, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, dc - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, dc):
        out = out + pad[:, i:i + S] * w[i]
    return out + b


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """JAX's softplus, log(1 + e^x) = max(x, 0) + log1p(e^-|x|), with no
    linear branch above a threshold (`F.softplus` has one at 20)."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_inputs(x_act: torch.Tensor, p: dict, cfg: ModelConfig):
    """Selective (input-dependent) SSM coefficients: a (B, S, di, ds)
    transition, b (B, S, di, ds) input, c (B, S, ds), all float32.

    a and b are the largest tensors of the layer (4.2 GB each at 4 × 2000
    tokens of Jamba); each is built with one temporary, the rest in
    place, which rounds as the JAX expressions do."""
    ds = cfg.mamba.d_state
    dt_rank = p["dt_w"].shape[0]
    proj = x_act @ p["x_proj"]
    dt_raw, B_, C_ = (proj[..., :dt_rank], proj[..., dt_rank:dt_rank + ds],
                      proj[..., dt_rank + ds:])
    dt = _softplus(dt_raw @ p["dt_w"] + p["dt_b"]).float()   # (B, S, di)
    A = -torch.exp(p["A_log"])                                # (di, ds)
    a = torch.mul(dt[..., None], A).exp_()
    b = torch.mul(dt[..., None], B_[:, :, None, :].float()).mul_(
        x_act[..., None].float())
    return a, b, C_.float()


def mamba_forward(x: torch.Tensor, p: dict, cfg: ModelConfig,
                  h0: torch.Tensor | None = None, scan_impl: str = "cuda"
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba block. x: (B, S, D) → (out (B, S, D), final ssm
    state (B, di, ds) float32, conv tail (B, dc - 1, di)).

    The conv tail — the last d_conv - 1 pre-conv inputs, which seed
    decode — is returned beside JAX's two outputs: JAX's hybrid model
    recomputes it (`_conv_tail`) from the same `in_proj` product of the
    same inputs. A prompt shorter than that is left-padded with zeros,
    as the causal conv pads it."""
    S = x.shape[1]
    m = cfg.mamba
    di = m.d_inner(cfg.d_model)
    xz = x @ p["in_proj"]
    x_in, z = xz[..., :di], xz[..., di:]
    x_act = F.silu(_causal_dw_conv(x_in, p["conv_w"], p["conv_b"]))
    a, b, c = _ssm_inputs(x_act, p, cfg)
    y, h_fin = selective_scan(a, b, c, h0, impl=scan_impl, device=x.device)
    del a, b
    y = (y + p["D"] * x_act.float()).to(x.dtype)
    out = (y * F.silu(z)) @ p["out_proj"]
    tail = x_in[:, max(S - (m.d_conv - 1), 0):]
    if tail.shape[1] < m.d_conv - 1:
        tail = F.pad(tail, (0, 0, m.d_conv - 1 - tail.shape[1], 0))
    return out, h_fin, tail.contiguous()


def mamba_decode_step(x: torch.Tensor, p: dict, cfg: ModelConfig,
                      state: dict, scan_impl: str = "cuda"
                      ) -> tuple[torch.Tensor, dict]:
    """One-token step. x: (B, 1, D); state: {conv: (B, dc-1, di), h: (B,
    di, ds) float32}. The step goes through the scan as S = 1 from
    h0 = state["h"]. Returns (out (B, 1, D), new state); the given state
    is left as it was."""
    di = cfg.mamba.d_inner(cfg.d_model)
    xz = x @ p["in_proj"]
    x_in, z = xz[..., :di], xz[..., di:]
    hist = torch.cat([state["conv"].to(x_in.dtype), x_in], dim=1)  # (B,dc,di)
    x_conv = torch.einsum("bci,ci->bi", hist, p["conv_w"]) + p["conv_b"]
    x_act = F.silu(x_conv)[:, None, :]                        # (B, 1, di)
    a, b, c = _ssm_inputs(x_act, p, cfg)
    y, h = selective_scan(a, b, c, state["h"], impl=scan_impl,
                          device=x.device)
    y = (y[:, 0] + p["D"] * x_act[:, 0].float()).to(x.dtype)
    out = (y * F.silu(z[:, 0])) @ p["out_proj"]
    return out[:, None, :], {"conv": hist[:, 1:], "h": h}
