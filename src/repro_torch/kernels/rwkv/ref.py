"""The wkv kernel's function in plain PyTorch: the sequential RWKV-6
recurrence, in float32.

CPU tensors take it, and the card's kernel is held against it. It is the
counterpart of the JAX package's `kernels/rwkv/ref.py::wkv_ref`, with the
same layout and the same final state: for each (b, h) and step t,

    out_t = r_t · (S + u ⊙ k_t v_tᵀ),   then   S ← diag(w_t) S + k_t v_tᵀ

over a (dh, dh) state S[i, j] (key index i, value index j). A Python
loop over time stands in for JAX's `lax.scan`.
"""

from __future__ import annotations

import torch


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor,
            s0: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: (B, S, H, dh), w the decay in (0, 1); u: (H, dh);
    s0: (B, H, dh, dh) or None (zeros). Returns (out (B, S, H, dh)
    float32, final state (B, H, dh, dh) float32)."""
    B, S, H, dh = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[:, :, None]                              # (H, dh, 1)
    s = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    outs = []
    for t in range(S):
        r_t, k_t, v_t, w_t = (x[:, t] for x in (rf, kf, vf, wf))
        kv = k_t[..., :, None] * v_t[..., None, :]          # (B, H, dh, dh)
        outs.append(torch.einsum("bhi,bhij->bhj", r_t, s + uf * kv))
        s = w_t[..., :, None] * s + kv
    return torch.stack(outs, dim=1), s
