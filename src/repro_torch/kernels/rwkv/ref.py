"""The wkv kernel's function in plain PyTorch: the sequential RWKV-6
recurrence, in float32.

CPU tensors take it, and the card's kernel is held against it. It is the
counterpart of the JAX package's `kernels/rwkv/ref.py::wkv_ref`, with the
same layout and the same final state: for each (b, h) and step t,

    out_t = r_t · (S + u ⊙ k_t v_tᵀ),   then   S ← diag(w_t) S + k_t v_tᵀ

over a (dh, dh) state S[i, j] (key index i, value index j). A Python
loop over time stands in for JAX's `lax.scan`.

`wkv_bwd_ref` is the backward kernel's function: the same recurrence's
gradients by an explicit reverse loop, in float32. With S_{t-1} the
state before step t and G_t the gradient of the loss with respect to
the state after it (G at the end is the final state's gradient),

    dr_t = S_{t-1} dout_t + u ⊙ k_t (v_t · dout_t)
    dk_t = G_t v_t + r_t ⊙ u (v_t · dout_t)
    dv_t = G_tᵀ k_t + dout_t (r_t · (u ⊙ k_t))
    dw_t = rowsum(G_t ⊙ S_{t-1})          (the decay w itself, not log w)
    du   = Σ_{b, t} r_t ⊙ k_t (v_t · dout_t)
    G_{t-1} = diag(w_t) G_t + r_t dout_tᵀ,     ds0 = G_{-1}

It keeps every S_{t-1} of the forward loop: the plain version divides
by no decay, which may underflow to 0.
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


def wkv_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor | None,
                dout: torch.Tensor, ds_fin: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, ...]:
    """The gradients of `wkv_ref(r, k, v, w, u, s0)` for the output's
    gradient `dout` (B, S, H, dh) and the final state's `ds_fin` (B, H,
    dh, dh) or None (zeros). Returns (dr, dk, dv in r's dtype, dw (B, S,
    H, dh) float32, du (H, dh) float32, ds0 (B, H, dh, dh) float32 or
    None when s0 is None)."""
    B, S, H, dh = r.shape
    rf, kf, vf, wf, df = (x.float() for x in (r, k, v, w, dout))
    uf = u.float()
    s = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    before = []                                   # S_{t-1} of each step
    for t in range(S):
        before.append(s)
        s = wf[:, t, ..., None] * s + kf[:, t, ..., None] * vf[:, t, :,
                                                                None, :]
    g = (torch.zeros_like(s) if ds_fin is None else ds_fin.float().clone())
    dr, dk, dv, dw = (torch.empty((B, S, H, dh), dtype=torch.float32,
                                  device=r.device) for _ in range(4))
    du = torch.zeros((H, dh), dtype=torch.float32, device=r.device)
    for t in reversed(range(S)):
        r_t, k_t, v_t, w_t, d_t = (x[:, t] for x in (rf, kf, vf, wf, df))
        vd = (v_t * d_t).sum(-1, keepdim=True)              # (B, H, 1)
        prev = before[t]
        dr[:, t] = torch.einsum("bhij,bhj->bhi", prev, d_t) + uf * k_t * vd
        dk[:, t] = torch.einsum("bhij,bhj->bhi", g, v_t) + r_t * uf * vd
        dv[:, t] = (torch.einsum("bhij,bhi->bhj", g, k_t)
                    + d_t * (r_t * uf * k_t).sum(-1, keepdim=True))
        dw[:, t] = (g * prev).sum(-1)
        du += (r_t * k_t * vd).sum(0)
        g = w_t[..., None] * g + r_t[..., None] * d_t[..., None, :]
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw, du,
            None if s0 is None else g)
