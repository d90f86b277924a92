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

The backward kernel splits that work in two, and each half has its
plain version here. `wkv_chunk_matrices_ref` is its states pass: over
chunks of T steps, with products of w only (the chunked form of the
prefill kernel), the state S_c before each chunk and the gradient G_c
after each chunk's last step,

    S ← W ⊙ S + Σ_t k~_t v_tᵀ,   k~_t = k_t ⊙ Π_{s>t} w_s,   W = Π_t w_t
    G ← W ⊙ G + Σ_t r~_t dout_tᵀ, r~_t = r_t ⊙ Π_{s<t} w_s

(the products over the chunk's steps; the second pass from the last
chunk, its last G being ds0). `wkv_bwd_chunks_ref` is its chunk pass:
every chunk at once from S_c and G_c, the same reverse loop as
`wkv_bwd_ref` over T steps.
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


def _chunked(x: torch.Tensor, T: int, fill: float) -> torch.Tensor:
    """(B, S, H, dh) as float32 (B, C, T, H, dh), steps past S `fill`."""
    B, S, H, dh = x.shape
    C = -(-S // T)
    out = torch.full((B, C * T, H, dh), fill, dtype=torch.float32,
                     device=x.device)
    out[:, :S] = x.float()
    return out.view(B, C, T, H, dh)


def wkv_chunk_matrices_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           w: torch.Tensor, s0: torch.Tensor | None,
                           dout: torch.Tensor,
                           ds_fin: torch.Tensor | None = None,
                           chunk: int = 16) -> tuple[torch.Tensor, ...]:
    """The backward's states pass: (S_c, G_c, ds0), S_c and G_c (B, H, C,
    dh, dh) float32 for the C = ceil(S / chunk) chunks (steps past S take
    w = 1 and zeros), ds0 (B, H, dh, dh) the gradient before the first
    step. Products of w only, taken in step order."""
    rc, kc, vc, dc = (_chunked(x, chunk, 0.0) for x in (r, k, v, dout))
    wc = _chunked(w, chunk, 1.0)
    B, C, T, H, dh = rc.shape
    kt, rt = torch.empty_like(kc), torch.empty_like(rc)
    p = torch.ones((B, C, H, dh), dtype=torch.float32, device=r.device)
    for t in reversed(range(T)):                  # k~: the later decays
        kt[:, :, t] = kc[:, :, t] * p
        p = p * wc[:, :, t]
    decay = p                                     # W of each chunk
    p = torch.ones_like(p)
    for t in range(T):                            # r~: the earlier decays
        rt[:, :, t] = rc[:, :, t] * p
        p = p * wc[:, :, t]
    zeros = torch.zeros((B, H, dh, dh), dtype=torch.float32,
                        device=r.device)
    s = zeros if s0 is None else s0.float()
    g = zeros if ds_fin is None else ds_fin.float()
    smat = torch.empty((B, H, C, dh, dh), dtype=torch.float32,
                       device=r.device)
    gmat = torch.empty_like(smat)
    for c in range(C):
        smat[:, :, c] = s
        s = decay[:, c, ..., None] * s + torch.einsum(
            "bthi,bthj->bhij", kt[:, c], vc[:, c])
    for c in reversed(range(C)):
        gmat[:, :, c] = g
        g = decay[:, c, ..., None] * g + torch.einsum(
            "bthi,bthj->bhij", rt[:, c], dc[:, c])
    return smat, gmat, g


def wkv_bwd_chunks_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor, dout: torch.Tensor,
                       smat: torch.Tensor, gmat: torch.Tensor,
                       chunk: int = 16) -> tuple[torch.Tensor, ...]:
    """The backward's chunk pass: from `wkv_chunk_matrices_ref`'s S_c
    (the state before the chunk) and G_c (the gradient after its last
    step), every chunk's gradients at once as chunk products, with no
    walk over the steps' states. Within a chunk of T steps, per key i,
    with P_t = Π_{s<t} w_s, Q_t = Π_{s>t} w_s and π(a, b) = Π_{a<s<b} w_s
    (products of w only):

        X = S_c Doutᵀ, Y = G_c Vᵀ (dh × T), B = Dout Vᵀ (T × T),
        g = rowsum(G_c ⊙ S_c), Z = (K ⊙ Q) G_c (T × dh)
        Cw[t][σ] = k_σ π(σ, t) (σ < t),  Rw[t][τ] = r_τ π(t, τ) (τ > t)
        dr_t = P_t X[t] + Σ_σ Cw[t][σ] B[t][σ] + u k_t B[t][t]
        dk_t = Q_t Y[t] + Σ_τ Rw[t][τ] B[τ][t] + r_t u B[t][t]
        dw_t = Q_t P_t g + Q_t Σ_σ Cw[t][σ] Y[σ] + P_t Σ_τ Rw[t][τ] X[τ]
               + Σ_τ Σ_σ Rw[t][τ] Cw[t][σ] B[τ][σ]
        dv_t = Z_t + Σ_{τ>t} A[τ][t] dout_τ + A[t][t] dout_t,
        A[τ][t] = Σ_i r_τ Cw[τ][t],  A[t][t] = Σ_i r_t u k_t
        du = Σ r_t k_t B[t][t]

    (S_{t-1} and G_t expanded from S_c and G_c over the chunk's steps).
    Returns (dr, dk, dv in r's dtype, dw (B, S, H, dh) float32, du (H,
    dh) float32)."""
    B, S, H, dh = r.shape
    T = chunk
    # (B, C, H, T, dh)
    rc, kc, vc, dc = (_chunked(x, T, 0.0).transpose(2, 3)
                      for x in (r, k, v, dout))
    wc = _chunked(w, T, 1.0).transpose(2, 3)
    C, uf = rc.shape[1], u.float()[:, None, :]           # (H, 1, dh)
    s0 = smat.transpose(1, 2).float()                     # (B, C, H, dh, dh)
    ge = gmat.transpose(1, 2).float()
    ones = torch.ones_like(wc[:, :, :, 0])
    pre, suf = [ones], [ones]                             # P_t, Q_t
    for t in range(1, T):
        pre.append(pre[-1] * wc[:, :, :, t - 1])
        suf.append(suf[-1] * wc[:, :, :, T - t])
    P, Q = torch.stack(pre, 3), torch.stack(suf[::-1], 3)
    pi = torch.zeros(rc.shape[:3] + (T, T, dh), dtype=torch.float32,
                     device=r.device)                     # π(a, b), a < b
    for a in range(T):
        p = ones
        for b in range(a + 1, T):
            pi[:, :, :, a, b] = p
            p = p * wc[:, :, :, b]
    cw = kc[:, :, :, None, :, :] * pi.transpose(3, 4)     # [t][σ]: k_σ π(σ,t)
    rw = rc[:, :, :, None, :, :] * pi                     # [t][τ]: r_τ π(t,τ)
    X = torch.einsum("bchij,bchtj->bchti", s0, dc)        # X[t][i]
    Y = torch.einsum("bchij,bchtj->bchti", ge, vc)
    Bm = torch.einsum("bchtj,bchsj->bchts", dc, vc)
    g = (ge * s0).sum(-1)                                 # (B, C, H, dh)
    Z = torch.einsum("bchti,bchij->bchtj", kc * Q, ge)
    diag = torch.diagonal(Bm, 0, 3, 4)[..., None]         # v_t . dout_t
    dr = P * X + torch.einsum("bchtsi,bchts->bchti", cw, Bm) + uf * kc * diag
    dk = Q * Y + torch.einsum("bchtsi,bchst->bchti", rw, Bm) + rc * uf * diag
    dw = (Q * P * g[:, :, :, None] + Q * torch.einsum("bchtsi,bchsi->bchti",
                                                      cw, Y)
          + P * torch.einsum("bchtsi,bchsi->bchti", rw, X)
          + torch.einsum("bchtai,bchtsi,bchas->bchti", rw, cw, Bm))
    A = torch.einsum("bchti,bchtsi->bchts", rc, cw)       # [τ][t], t < τ
    A = A + torch.diag_embed((rc * uf * kc).sum(-1))
    dv = Z + torch.einsum("bchst,bchsj->bchtj", A, dc)
    du = (rc * kc * diag).sum((0, 1, 3))
    dr, dk, dv, dw = (x.transpose(2, 3).reshape(B, C * T, H, dh)[:, :S]
                      for x in (dr, dk, dv, dw))
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype),
            dw.contiguous(), du)
