"""GQA-aware attention entry point in the model's layout.

q (B, S, H, dh); k, v (B, T, KV, dh) with H a multiple of KV. A CUDA
tensor goes to the hand-written kernel (`kernel.flash_attention`) — or,
with `impl="ref"`, to the plain PyTorch version on the card, for
comparison; a CPU tensor takes the plain version. Nothing falls back:
without a card `device="cuda"` raises. Unlike the JAX wrapper this one
never repeats K/V: the kernel maps query head h to KV head h // (H // KV)
by index.
"""

from __future__ import annotations

import torch

from ..intersect.ops import resolve_device
from .kernel import flash_attention
from .ref import attention_ref


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              q_positions=None, kv_positions=None, impl: str = "cuda",
              device="cuda") -> torch.Tensor:
    """Attention on `device`; returns (B, S, H, dh) in q's dtype.

    `q_positions` (S,) or (B, S) and `kv_positions` (T,) or (B, T) are
    absolute token positions (negative = empty cache slot), one row
    shared by the batch or one a batch row; without them the ends of the
    query and key ranges are aligned. K/V are cast to q's dtype first (a
    bf16 cache against float32 queries)."""
    if impl not in ("cuda", "ref"):
        raise ValueError(f"impl must be 'cuda' or 'ref', not {impl!r}")
    dev = resolve_device(device)
    q = torch.as_tensor(q).to(dev)
    k, v = (torch.as_tensor(x).to(dev, q.dtype) for x in (k, v))
    q_positions, kv_positions = (
        None if p is None else torch.as_tensor(p).to(dev, torch.int32)
        for p in (q_positions, kv_positions))
    if impl == "ref" or dev.type != "cuda":
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_positions=q_positions,
                             kv_positions=kv_positions)
    return flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        window=window,
        q_positions=None if q_positions is None else q_positions.contiguous(),
        kv_positions=(None if kv_positions is None
                      else kv_positions.contiguous()))
