"""Mamba (S6) selective-state-space block [arXiv:2312.00752], used by the
Jamba hybrid architecture.

Mirrors `repro/models/mamba.py` over a tree of tensors, with its
`rules` argument (`models.common.AxisRules`, default `NULL_RULES`) and
its constraint sites. The diagonal recurrence

    h_t = exp(dt_t · A) ⊙ h_{t-1} + (dt_t · B_t) x_t,    y_t = h_t · C_t

goes through `kernels.ssm.ops.selective_scan_fused`, at prefill over the
whole prompt and at decode as one step from the cached state: on a card
the hand-written fused scan kernel (or, with `scan_impl="ref"`, its plain
PyTorch version, for comparison), on the CPU the plain version. The
kernel takes dt, A, B_, C_ and x and builds exp(dt · A) and dt · B_ · x
itself, so neither the (B, S, d_inner, d_state) a and b that JAX's
`_ssm_inputs` returns nor the JAX model's `chunked_diag_scan` tensor of
every state is built; it returns y with the D skip and the final state.
Under a mesh the scan runs on each rank's channels (`rules.local`): x,
dt, A, D and the state are sharded over d_inner ("tp"), while B_ and C_,
shared by every channel, are whole on each rank, so their gradients
come out as partial sums over the "tp" ranks (and A's and D's over the
"dp" ranks, which split the batch).
Each step keeps the JAX package's dtypes: products in the parameters'
dtype, dt in that dtype and then float32, the scan in float32, y cast
back to the activations' dtype before the gate.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.ssm.ops import selective_scan_fused
from .common import NULL_RULES, AxisRules, Desc


def mamba_desc(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    m = cfg.mamba
    di, ds, dc = m.d_inner(D), m.d_state, m.d_conv
    dt_rank = max(D // 16, 1)
    return {
        "in_proj": Desc((D, 2 * di), ("fsdp", "tp")),
        "conv_w": Desc((dc, di), (None, "tp")),
        "conv_b": Desc((di,), ("tp",), init="zeros"),
        "x_proj": Desc((di, dt_rank + 2 * ds), ("tp", None)),
        "dt_w": Desc((dt_rank, di), (None, "tp")),
        "dt_b": Desc((di,), ("tp",), init="ones"),
        "A_log": Desc((di, ds), ("tp", None), init="scaled", scale=0.5,
                      dtype=torch.float32),
        "D": Desc((di,), ("tp",), init="ones", dtype=torch.float32),
        "out_proj": Desc((di, D), ("tp", "fsdp")),
    }


def mamba_state_desc(cfg: ModelConfig, batch: int) -> dict:
    m = cfg.mamba
    di = m.d_inner(cfg.d_model)
    return {
        "conv": Desc((batch, m.d_conv - 1, di), ("dp", None, "tp"),
                     init="zeros"),
        "h": Desc((batch, di, m.d_state), ("dp", "tp", None), init="zeros",
                  dtype=torch.float32),
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


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          rules: AxisRules) -> torch.Tensor:
    """`_causal_dw_conv`; under a mesh on each rank's channels (a
    depthwise conv needs no other), the weights' gradients partial sums
    over the "dp" ranks."""
    if rules.mesh is None:
        return _causal_dw_conv(x, w, b)
    xpl = rules.placements(("dp", None, "tp"), tuple(x.shape))
    wpl = rules.placements((None, "tp"), tuple(w.shape))
    bpl = rules.placements(("tp",), tuple(b.shape))
    batch = rules.split_by(("dp", None, "tp"), x.shape, 0)
    return rules.local(_causal_dw_conv, ins=(xpl, wpl, bpl), outs=(xpl,),
                       grads=(xpl, rules.partial(wpl, batch),
                              rules.partial(bpl, batch)))(x, w, b)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """JAX's softplus, log(1 + e^x) = max(x, 0) + log1p(e^-|x|), with no
    linear branch above a threshold (`F.softplus` has one at 20)."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_inputs(x_act: torch.Tensor, p: dict, cfg: ModelConfig):
    """The selective (input-dependent) SSM coefficients' factors, from
    which the scan builds a = exp(dt · A) and b = dt · B_ · x_act: dt (B,
    S, di) float32, A (di, ds) float32, and B_ and C_ (B, S, ds) in the
    activations' dtype, strided views of the x projection."""
    ds = cfg.mamba.d_state
    dt_rank = p["dt_w"].shape[0]
    proj = x_act @ p["x_proj"]
    dt_raw, B_, C_ = (proj[..., :dt_rank], proj[..., dt_rank:dt_rank + ds],
                      proj[..., dt_rank + ds:])
    dt = _softplus(dt_raw @ p["dt_w"] + p["dt_b"]).float()   # (B, S, di)
    A = -torch.exp(p["A_log"])                                # (di, ds)
    return dt, A, B_, C_


def _scan(dt, A, B_, C_, x, D, h0, rules: AxisRules, impl: str, device):
    """`kernels.ssm.ops.selective_scan_fused`; under a mesh on each rank's
    d_inner channels."""
    if rules.mesh is None:
        return selective_scan_fused(dt, A, B_, C_, x, D, h0, impl=impl,
                                    device=device)
    chan = rules.placements(("dp", None, "tp"), tuple(x.shape))
    apl = rules.placements(("tp", None), tuple(A.shape))
    bpl = rules.placements(("dp", None, None), tuple(B_.shape))
    dpl = rules.placements(("tp",), tuple(D.shape))
    hpl = rules.placements(("dp", "tp", None),
                           (x.shape[0], x.shape[2], A.shape[1]))

    def local(dt, A, B_, C_, x, D, h0):
        return selective_scan_fused(dt, A, B_, C_, x, D, h0, impl=impl,
                                    device=device)

    batch = rules.split_by(("dp", None, "tp"), x.shape, 0)
    bgrad = rules.partial(bpl, rules.split_by(("dp", None, "tp"),
                                              x.shape, 2))
    hin = None if h0 is None else hpl
    return rules.local(
        local, ins=(chan, apl, bpl, bpl, chan, dpl, hin),
        outs=(chan, hpl),
        grads=(chan, rules.partial(apl, batch), bgrad, bgrad, chan,
               rules.partial(dpl, batch), hin))(dt, A, B_, C_, x, D, h0)


def mamba_forward(x: torch.Tensor, p: dict, cfg: ModelConfig,
                  h0: torch.Tensor | None = None, scan_impl: str = "cuda",
                  rules: AxisRules = NULL_RULES
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
    x_in = rules.constrain(x_in, "dp", None, "tp")
    x_act = F.silu(_conv(x_in, p["conv_w"], p["conv_b"], rules))
    dt, A, B_, C_ = _ssm_inputs(x_act, p, cfg)
    y, h_fin = _scan(dt, A, B_, C_, x_act, p["D"], h0, rules, scan_impl,
                     x.device)
    y = y.to(x.dtype)
    out = rules.constrain((y * F.silu(z)) @ p["out_proj"], "dp", None, None)
    tail = x_in[:, max(S - (m.d_conv - 1), 0):]
    if tail.shape[1] < m.d_conv - 1:
        tail = F.pad(tail, (0, 0, m.d_conv - 1 - tail.shape[1], 0))
    return out, h_fin, tail.contiguous()


def mamba_decode_step(x: torch.Tensor, p: dict, cfg: ModelConfig,
                      state: dict, scan_impl: str = "cuda",
                      rules: AxisRules = NULL_RULES
                      ) -> tuple[torch.Tensor, dict]:
    """One-token step. x: (B, 1, D); state: {conv: (B, dc-1, di), h: (B,
    di, ds) float32}. The step goes through the fused scan as S = 1 from
    h0 = state["h"]. Returns (out (B, 1, D), new state); the given state
    is left as it was."""
    di = cfg.mamba.d_inner(cfg.d_model)
    xz = x @ p["in_proj"]
    x_in, z = xz[..., :di], xz[..., di:]
    x_in = rules.constrain(x_in, "dp", None, "tp")
    hist = torch.cat([rules.constrain(state["conv"].to(x_in.dtype), "dp",
                                      None, "tp"), x_in], dim=1)  # (B,dc,di)
    x_conv = torch.einsum("bci,ci->bi", hist, p["conv_w"]) + p["conv_b"]
    x_act = F.silu(x_conv)[:, None, :]                        # (B, 1, di)
    dt, A, B_, C_ = _ssm_inputs(x_act, p, cfg)
    y, h = _scan(dt, A, B_, C_, x_act, p["D"], state["h"], rules, scan_impl,
                 x.device)
    y = y[:, 0].to(x.dtype)
    out = rules.constrain((y * F.silu(z[:, 0])) @ p["out_proj"], "dp", None)
    return out[:, None, :], {"conv": hist[:, 1:], "h": h}
