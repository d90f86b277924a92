"""The flash-attention kernel's function in plain PyTorch, in float32.

CPU tensors take it, and the card's kernel is held against it. It takes
the kernel's layout — q (B, S, H, dh), k and v (B, T, KV, dh), head h
reading KV head h // (H // KV) — where the JAX package's `attention_ref`
takes (B, H, S, dh) after repeating K/V; without positions the two
compute the same function. Scores, softmax and PV are float32 (on a card
only with TF32 off, PyTorch's default for matrix products); the output
is in q's dtype. A query row that may attend to no key comes out as
zeros, as from the kernel. `attention_split_ref` computes the same
function the way the decode kernel does, key range by key range, and is
there for the tests of that merge rule.
"""

from __future__ import annotations

import math

import torch

MASKED = -1e30                 # score of a masked pair, as the kernels use


def _allowed(S: int, T: int, causal: bool, window: int | None,
             q_positions, kv_positions, dev) -> torch.Tensor:
    """(S, T) bool: may query s attend to key t. Without positions,
    queries sit at arange(S) + T - S and keys at arange(T) (ends
    aligned). A negative key position is an empty slot."""
    qpos = (torch.arange(S, device=dev) + (T - S) if q_positions is None
            else q_positions.to(dev, torch.int64))
    kpos = (torch.arange(T, device=dev) if kv_positions is None
            else kv_positions.to(dev, torch.int64))
    ok = (kpos >= 0)[None, :].expand(S, T)
    if causal:
        ok = ok & (qpos[:, None] >= kpos[None, :])
    if window is not None:
        ok = ok & (qpos[:, None] - kpos[None, :] < window)
    return ok


def _scores(q, k, ok):
    """Masked float32 scores (B, KV, g, S, T) of q (B, S, H, dh) against
    k (B, T, KV, dh)."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, S, KV, H // KV, dh) * (1.0 / math.sqrt(dh))
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    return s.masked_fill_(~ok, MASKED)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  q_positions: torch.Tensor | None = None,
                  kv_positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full-materialisation attention over (S, T) scores."""
    B, S, H, dh = q.shape
    ok = _allowed(S, k.shape[1], causal, window, q_positions, kv_positions,
                  q.device)
    p = torch.softmax(_scores(q, k, ok), dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    out = out * ok.any(dim=-1).to(out.dtype)[None, :, None, None, None]
    return out.reshape(B, S, H, dh).to(q.dtype)


def attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, split_keys: int, causal: bool = True,
                        window: int | None = None,
                        q_positions: torch.Tensor | None = None,
                        kv_positions: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Attention as split-KV computes it: each range of `split_keys` keys
    gives float32 (m, l, acc) per row — its largest allowed score, the sum
    of exp(score - m) over its allowed keys and their sum of
    exp(score - m)·v — with l = 0 and acc = 0 where it has no allowed key;
    then o = Σ exp(m_i - M)·acc_i / Σ exp(m_i - M)·l_i with M = max m_i,
    and zeros where no range had an allowed key."""
    B, S, H, dh = q.shape
    T = k.shape[1]
    ok = _allowed(S, T, causal, window, q_positions, kv_positions, q.device)
    s = _scores(q, k, ok)
    parts = []
    for t0 in range(0, T, split_keys):
        sl = slice(t0, t0 + split_keys)
        seen = ok[:, sl].any(dim=-1)[:, None]            # (S, 1)
        m = s[..., sl].amax(dim=-1, keepdim=True)
        p = torch.exp(s[..., sl] - m).masked_fill_(~ok[:, sl], 0.0)
        acc = torch.einsum("bkgst,btkd->bkgsd", p, v[:, sl].float())
        parts.append((m.masked_fill(~seen, MASKED), p.sum(-1, keepdim=True),
                      acc))
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    weights = [torch.exp(m - top) for m, _, _ in parts]
    num = sum(w * acc for w, (_, _, acc) in zip(weights, parts))
    den = sum(w * l for w, (_, l, _) in zip(weights, parts))
    out = num / den.clamp_min(1e-30) * (top > MASKED)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dh).to(q.dtype)
