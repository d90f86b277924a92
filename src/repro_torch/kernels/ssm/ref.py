"""The selective-scan kernel's function in plain PyTorch: the sequential
Mamba diagonal recurrence, in float32.

CPU tensors take it, and the card's kernel is held against it. It is the
counterpart of the JAX package's `kernels/ssm/ref.py::selective_scan_ref`,
with the same layout and the same final state: for each (b, d, n) and
step t,

    h_t = a_t ⊙ h_{t-1} + b_t,    y_t[d] = Σ_n h_t[d, n] · c_t[n]

A Python loop over time stands in for JAX's `lax.scan`; `a_t * h` and
`+ b_t` are two roundings, as the kernel makes them.
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
