"""The flash-attention kernel's function in plain PyTorch, in float32.

CPU tensors take it, and the card's kernel is held against it. It takes
the kernel's layout — q (B, S, H, dh), k and v (B, T, KV, dh), head h
reading KV head h // (H // KV) — where the JAX package's `attention_ref`
takes (B, H, S, dh) after repeating K/V; without positions the two
compute the same function. Scores, softmax and PV are float32 (on a card
only with TF32 off, PyTorch's default for matrix products); the output
is in q's dtype. A query row that may attend to no key comes out as
zeros, as from the kernel.
"""

from __future__ import annotations

import math

import torch

MASKED = -1e30                 # score of a masked pair, as the kernels use


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  q_positions: torch.Tensor | None = None,
                  kv_positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full-materialisation attention over (S, T) scores.

    Without positions, queries sit at arange(S) + T - S and keys at
    arange(T) (ends aligned). A negative key position is an empty slot."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    dev = q.device
    qpos = (torch.arange(S, device=dev) + (T - S) if q_positions is None
            else q_positions.to(dev, torch.int64))
    kpos = (torch.arange(T, device=dev) if kv_positions is None
            else kv_positions.to(dev, torch.int64))
    ok = (kpos >= 0)[None, :].expand(S, T)
    if causal:
        ok = ok & (qpos[:, None] >= kpos[None, :])
    if window is not None:
        ok = ok & (qpos[:, None] - kpos[None, :] < window)

    qg = q.float().reshape(B, S, KV, H // KV, dh) * (1.0 / math.sqrt(dh))
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    s.masked_fill_(~ok, MASKED)
    p = torch.softmax(s, dim=-1)
    del s
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    out = out * ok.any(dim=-1).to(out.dtype)[None, :, None, None, None]
    return out.reshape(B, S, H, dh).to(q.dtype)
