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

`attention_int8_ref` is the int8 KV cache's attention exactly as the JAX
package's `blockwise_attention` computes it with `k_scale`/`v_scale`
(quantized q, integer products, scales folded into the scores and into
p, p quantized per row), which the int8 decode kernel is held against;
`attention_bwd_ref` is the backward of `attention_ref` by its explicit
formulas, which the backward kernel is held against, and
`attention_lse_ref` the rows' log-sum-exp that the forward prefill kernel
writes for it.
"""

from __future__ import annotations

import math

import torch

MASKED = -1e30                 # score of a masked pair, as the kernels use


def _allowed(B: int, S: int, T: int, causal: bool, window: int | None,
             q_positions, kv_positions, dev) -> torch.Tensor:
    """(B, S, T) bool: may query s of batch row b attend to key t.
    Positions are (S,)/(T,), shared by the batch, or (B, S)/(B, T), one
    row each. Without them, queries sit at arange(S) + T - S and keys at
    arange(T) (ends aligned). A negative key position is an empty slot."""
    qpos = (torch.arange(S, device=dev) + (T - S) if q_positions is None
            else q_positions.to(dev, torch.int64))
    kpos = (torch.arange(T, device=dev) if kv_positions is None
            else kv_positions.to(dev, torch.int64))
    qpos = qpos.expand(B, S)[:, :, None]
    kpos = kpos.expand(B, T)[:, None, :]
    ok = (kpos >= 0).expand(B, S, T)
    if causal:
        ok = ok & (qpos >= kpos)
    if window is not None:
        ok = ok & (qpos - kpos < window)
    return ok


def _scores(q, k, ok):
    """Masked float32 scores (B, KV, g, S, T) of q (B, S, H, dh) against
    k (B, T, KV, dh); `ok` is (B, S, T)."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, S, KV, H // KV, dh) * (1.0 / math.sqrt(dh))
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    return s.masked_fill_(~ok[:, None, None], MASKED)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  q_positions: torch.Tensor | None = None,
                  kv_positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full-materialisation attention over (S, T) scores."""
    B, S, H, dh = q.shape
    ok = _allowed(B, S, k.shape[1], causal, window, q_positions,
                  kv_positions, q.device)
    p = torch.softmax(_scores(q, k, ok), dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    out = out * ok.any(dim=-1).to(out.dtype)[:, :, None, None, None]
    return out.reshape(B, S, H, dh).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      q_positions: torch.Tensor | None = None,
                      kv_positions: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Each row's natural log-sum-exp of its allowed scaled scores
    q·k / sqrt(dh), float32 (B, S, H); +inf for a row with no allowed key
    (its probabilities exp(s - lse) are then all 0)."""
    B, S, H, dh = q.shape
    ok = _allowed(B, S, k.shape[1], causal, window, q_positions,
                  kv_positions, q.device)
    s = _scores(q, k, ok).masked_fill_(~ok[:, None, None], -math.inf)
    lse = torch.logsumexp(s, dim=-1)                    # (B, KV, g, S)
    lse = lse.masked_fill_(~ok.any(dim=-1)[:, None, None], math.inf)
    return lse.permute(0, 3, 1, 2).reshape(B, S, H)


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
    ok = _allowed(B, S, T, causal, window, q_positions, kv_positions,
                  q.device)
    s = _scores(q, k, ok)
    ok = ok[:, None, None]                               # (B, 1, 1, S, T)
    parts = []
    for t0 in range(0, T, split_keys):
        sl = slice(t0, t0 + split_keys)
        seen = ok[..., sl].any(dim=-1, keepdim=True)     # (B, 1, 1, S, 1)
        m = s[..., sl].amax(dim=-1, keepdim=True)
        p = torch.exp(s[..., sl] - m).masked_fill_(~ok[..., sl], 0.0)
        acc = torch.einsum("bkgst,btkd->bkgsd", p, v[:, sl].float())
        parts.append((m.masked_fill(~seen, MASKED), p.sum(-1, keepdim=True),
                      acc))
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    weights = [torch.exp(m - top) for m, _, _ in parts]
    num = sum(w * acc for w, (_, _, acc) in zip(weights, parts))
    den = sum(w * l for w, (_, l, _) in zip(weights, parts))
    out = num / den.clamp_min(1e-30) * (top > MASKED)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dh).to(q.dtype)


# keys a step of the integer products: 1024 · 127 · 127 < 2**24, so each
# step's float32 sum of int8 products is exact
_INT_CHUNK = 1024


def attention_int8_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       k_scale: torch.Tensor, v_scale: torch.Tensor, *,
                       causal: bool = True, window: int | None = None,
                       q_positions: torch.Tensor | None = None,
                       kv_positions: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Attention of q (B, S, H, dh) against int8 k, v (B, T, KV, dh) with
    bf16 scales (B, T, KV), as `repro/models/blocks.py:112-147`: q
    quantized per (b, s, head) row (qs = max|q| / 127 + 1e-9), s =
    (q8·k8) · qs · 1/sqrt(dh) · k_scale, masked to -1e30, p = softmax(s)
    · v_scale, ps = max p / 127 + 1e-12, p8 = round(p / ps) (half to
    even), out = (p8·v8) · ps in q's dtype. A row whose keys are all
    masked averages over them, as JAX's softmax does. The integer
    products are exact: float32 sums of at most `_INT_CHUNK` keys,
    added in int64."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    g = H // KV
    dev = q.device
    qg = q.float().reshape(B, S, KV, g, dh)
    qs = qg.abs().amax(-1, keepdim=True) / 127.0 + 1e-9    # (B, S, KV, g, 1)
    q8 = torch.clamp(torch.round(qg / qs), -127, 127)
    dots = torch.cat([
        torch.einsum("bskgd,btkd->bkgst", q8, k[:, t0:t0 + _INT_CHUNK].float())
        for t0 in range(0, T, _INT_CHUNK)], dim=-1)
    qk_scale = torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
    s = dots * qs[..., 0].permute(0, 2, 3, 1)[..., None] * qk_scale \
        * k_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    qpos = (torch.arange(S, device=dev) + (T - S) if q_positions is None
            else q_positions.to(dev, torch.int64)).expand(B, S)[:, :, None]
    kpos = (torch.arange(T, device=dev) if kv_positions is None
            else kv_positions.to(dev, torch.int64)).expand(B, T)[:, None, :]
    ok = (kpos >= 0).expand(B, S, T)
    if causal:
        ok = ok & (qpos >= kpos)
    if window is not None:
        ok = ok & (qpos - kpos < window)
    s = s.masked_fill(~ok[:, None, None], MASKED)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    p = p * v_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    ps = p.amax(-1, keepdim=True) / 127.0 + 1e-12          # (B, KV, g, S, 1)
    p8 = torch.clamp(torch.round(p / ps), -127, 127)
    acc = torch.zeros(B, KV, g, S, dh, dtype=torch.int64, device=dev)
    for t0 in range(0, T, _INT_CHUNK):
        acc += torch.einsum("bkgst,btkd->bkgsd", p8[..., t0:t0 + _INT_CHUNK],
                            v[:, t0:t0 + _INT_CHUNK].float()).to(torch.int64)
    out = acc.float() * ps
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dh).to(q.dtype)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, dout: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      q_positions: torch.Tensor | None = None,
                      kv_positions: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of `attention_ref(q, k, v, ...)` whose
    output was `out`, for the output's gradient `dout`, by the explicit
    formulas in float32: P = softmax(q·k^T / sqrt(dh)) over the allowed
    keys (0 for a row with none), dV = P^T·dO, dP = dO·V^T, Δ =
    rowsum(dO ∘ out), dS = P ∘ (dP - Δ), dQ = dS·K / sqrt(dh), dK =
    dS^T·Q / sqrt(dh), dK and dV summed over each KV head's query heads;
    each in its input's dtype."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = 1.0 / math.sqrt(dh)
    ok = _allowed(B, S, T, causal, window, q_positions, kv_positions,
                  q.device)
    p = torch.softmax(_scores(q, k, ok), dim=-1)
    p = p * ok.any(dim=-1)[:, None, None, :, None]       # (B, KV, g, S, T)
    do = dout.float().reshape(B, S, KV, g, dh)
    dv = torch.einsum("bkgst,bskgd->btkd", p, do)
    dp = torch.einsum("bskgd,btkd->bkgst", do, v.float())
    delta = (do * out.float().reshape(B, S, KV, g, dh)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds,
                      q.float().reshape(B, S, KV, g, dh)) * scale
    return (dq.reshape(B, S, H, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
