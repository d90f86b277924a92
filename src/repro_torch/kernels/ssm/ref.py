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
"""

from __future__ import annotations

import torch


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
                             h0: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """dt (B, S, D) float32, A (D, N) float32, B_ and C_ (B, S, N), x (B,
    S, D), D (D,) or None, h0 (B, D, N) or None. Returns (y + D·x (B, S,
    D) float32, final h (B, D, N) float32). a and b are built with one
    temporary each, the rest in place, rounding as the JAX expressions
    do."""
    a = torch.mul(dt[..., None], A).exp_()
    b = torch.mul(dt[..., None], B_[:, :, None, :].float()).mul_(
        x[..., None].float())
    y, h = selective_scan_ref(a, b, C_.float(), h0)
    del a, b
    if D is not None:
        y = y + D * x.float()
    return y, h
