"""The selective-scan kernels' functions in plain PyTorch: the sequential
Mamba diagonal recurrence, in float32.

CPU tensors take them, and the card's kernels are held against them.
`selective_scan_ref` is the counterpart of the JAX package's
`kernels/ssm/ref.py::selective_scan_ref`, with the same layout and the
same final state: for each (b, d, n) and step t,

    h_t = a_t ⊙ h_{t-1} + b_t,    y_t[d] = Σ_n h_t[d, n] · c_t[n]

A Python loop over time stands in for JAX's `lax.scan`; `a_t * h` and
`+ b_t` are two roundings, as the kernel makes them.

`selective_scan_fused_ref` is the same scan from the Mamba layer's own
inputs: a and b built by the expressions of JAX's `_ssm_inputs`
(`repro/models/mamba.py:59-62`), the scan, then the D skip y + D·x.

`selective_scan_fused_bwd_ref` is the backward kernel's function: that
scan's gradients by an explicit reverse loop, in float32. With a_t =
exp(dt_t·A), G_t the gradient with respect to h_t (G_{S-1} = dy_{S-1}
C_{S-1} + dh_fin) and h_{t-1} the state before step t,

    G_t   = dy_t[d] C_t[n] + a_{t+1} G_{t+1}
    d(dt) = Σ_n (G_t h_{t-1} a_t A + G_t B_t x_t)
    dx    = dt Σ_n G_t B_t + D dy_t,     dD = Σ_{b,t} dy_t x_t
    dA    = Σ_{b,t} G_t h_{t-1} a_t dt
    dB_t  = Σ_d G_t dt x_t,              dC_t = Σ_d dy_t h_t
    dh0   = a_0 G_0

It keeps every h_{t-1} of the forward loop rather than divide by a,
which underflows to 0 for dt·A below about -104. Given the forward's
saved `states` (the state before every chunk-th step, as
`selective_scan_fused_ref(..., states=True)` returns them) it restarts
the loop from each instead, as the kernel recomputes its chunks.
"""

from __future__ import annotations

import torch

from .kernel import BWD_CHUNK


def selective_scan_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                       h0: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """a, b: (B, S, D, N); c: (B, S, N); h0: (B, D, N) or None (zeros).
    Returns (y (B, S, D) float32, final h (B, D, N) float32)."""
    B, S, D, N = a.shape
    af, bf, cf = a.float(), b.float(), c.float()
    h = (torch.zeros((B, D, N), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        h = af[:, t] * h + bf[:, t]
        ys.append((h * cf[:, t, None, :]).sum(-1))
    return torch.stack(ys, dim=1), h


def selective_scan_fused_ref(dt: torch.Tensor, A: torch.Tensor,
                             B_: torch.Tensor, C_: torch.Tensor,
                             x: torch.Tensor, D: torch.Tensor | None = None,
                             h0: torch.Tensor | None = None, *,
                             states: bool = False,
                             chunk: int = BWD_CHUNK) -> tuple:
    """dt (B, S, D) float32, A (D, N) float32, B_ and C_ (B, S, N), x (B,
    S, D), D (D,) or None, h0 (B, D, N) or None. Returns (y + D·x (B, S,
    D) float32, final h (B, D, N) float32), and with `states` the state
    before every `chunk`-th step (B, ceil(S / chunk), D, N) as a third
    output. a and b are built with one temporary each, the rest in place,
    rounding as the JAX expressions do."""
    a = torch.mul(dt[..., None], A).exp_()
    b = torch.mul(dt[..., None], B_[:, :, None, :].float()).mul_(
        x[..., None].float())
    if states:
        Bsz, S, Di, N = a.shape
        h = (torch.zeros((Bsz, Di, N), dtype=torch.float32,
                         device=dt.device) if h0 is None else h0.float())
        saved, ys = [], []
        for t0 in range(0, S, chunk):
            saved.append(h)
            y, h = selective_scan_ref(a[:, t0:t0 + chunk],
                                      b[:, t0:t0 + chunk],
                                      C_[:, t0:t0 + chunk].float(), h)
            ys.append(y)
        y = torch.cat(ys, 1)
    else:
        y, h = selective_scan_ref(a, b, C_.float(), h0)
    del a, b
    if D is not None:
        y = y + D * x.float()
    return (y, h, torch.stack(saved, 1)) if states else (y, h)


def selective_scan_fused_bwd_ref(dt: torch.Tensor, A: torch.Tensor,
                                 B_: torch.Tensor, C_: torch.Tensor,
                                 x: torch.Tensor, D: torch.Tensor | None,
                                 h0: torch.Tensor | None, dy: torch.Tensor,
                                 dh_fin: torch.Tensor | None = None,
                                 states: torch.Tensor | None = None,
                                 chunk: int = BWD_CHUNK) -> tuple:
    """The gradients of `selective_scan_fused_ref(dt, A, B_, C_, x, D,
    h0)` for y's gradient `dy` (B, S, D) and the final state's `dh_fin`
    (B, D, N) or None (zeros). Returns (d(dt) (B, S, D) float32, dA (D, N)
    float32, dB_ and dC_ (B, S, N) and dx (B, S, D) in x's dtype, dD (D,)
    float32 or None when D is None, dh0 (B, D, N) float32 or None when h0
    is None). With the forward's `states` (B, ceil(S / chunk), D, N), the
    loop restarts from states[:, c] at step c·chunk."""
    Bsz, S, Di = dt.shape
    N = A.shape[1]
    dtf, Af, dyf = dt.float(), A.float(), dy.float()
    Bf, Cf, xf = B_.float(), C_.float(), x.float()
    h = (torch.zeros((Bsz, Di, N), dtype=torch.float32, device=dt.device)
         if h0 is None else h0.float())
    before = []                                   # h_{t-1} of each step
    for t in range(S):
        if states is not None and t % chunk == 0:
            h = states[:, t // chunk].float()
        before.append(h)
        a = torch.exp(dtf[:, t, :, None] * Af)
        h = a * h + (dtf[:, t, :, None] * Bf[:, t, None, :]) * xf[:, t, :,
                                                                  None]
    carry = (torch.zeros_like(h) if dh_fin is None else dh_fin.float())
    ddt, dx = (torch.empty((Bsz, S, Di), dtype=torch.float32,
                           device=dt.device) for _ in range(2))
    dB, dC = (torch.empty((Bsz, S, N), dtype=torch.float32, device=dt.device)
              for _ in range(2))
    dA = torch.zeros((Di, N), dtype=torch.float32, device=dt.device)
    after = h                                     # h_t, from the last step
    for t in reversed(range(S)):
        dt_t, x_t, dy_t = dtf[:, t], xf[:, t], dyf[:, t]      # (B, D)
        b_t, c_t = Bf[:, t, None, :], Cf[:, t, None, :]       # (B, 1, N)
        a = torch.exp(dt_t[..., None] * Af)
        g = carry + dy_t[..., None] * c_t
        dC[:, t] = (dy_t[..., None] * after).sum(1)
        prev = before[t]
        da = g * prev * a
        dA += (da * dt_t[..., None]).sum(0)
        gb = (g * b_t).sum(-1)                                # (B, D)
        ddt[:, t] = (da * Af).sum(-1) + gb * x_t
        dx[:, t] = gb * dt_t
        dB[:, t] = (g * (dt_t * x_t)[..., None]).sum(1)
        carry = a * g
        after = prev
    dD = None
    if D is not None:
        dx += D.float() * dyf
        dD = (dyf * xf).sum((0, 1))
    return (ddt, dA, dB.to(x.dtype), dC.to(x.dtype), dx.to(x.dtype), dD,
            None if h0 is None else carry)
