"""Plain PyTorch versions of the intersect kernels.

Bitmaps travel as `torch.int32` tensors holding the uint32 bit patterns
(CPU `torch.uint32` has no `~`, `>>` or `-`); counts come back as int64.
Only int32/int64 ops are used, so these run on CPU and CUDA tensors
alike: the CPU path of every wrapper in `ops.py`, and what the CUDA
kernels are held against on the card.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-element bit count of int32-held uint32 words → int64."""
    x = x.to(torch.int64) & _U32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _U32) >> 24


def intersect_ref(bitmaps: torch.Tensor,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """L-way AND + popcount. bitmaps: (L, W) int32 document bitsets.

    Returns (intersection bitmap (W,), total matching documents ())."""
    out = bitmaps[0]
    for l in range(1, bitmaps.shape[0]):
        out = out & bitmaps[l]
    return out, popcount(out).sum()


def intersect_batch_ref(bitmaps: torch.Tensor,
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched L-way AND. bitmaps: (Q, L, W) int32 → ((Q, W), (Q,))."""
    out = bitmaps[:, 0]
    for l in range(1, bitmaps.shape[1]):
        out = out & bitmaps[:, l]
    return out, popcount(out).sum(dim=1)


def combine_batch_ref(bitmaps: torch.Tensor, programs: torch.Tensor,
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """AND/OR/ANDNOT program evaluator, all queries in step.

    bitmaps: (Q, L, W) int32; programs: (Q, S, 3) rows of
    (opcode, slot_a, slot_b) — slots 0..L-1 are the layers, step s
    writes slot L+s, slot L+S-1 is the query's result. Opcode 0 is AND,
    1 OR, anything else ANDNOT. Returns ((Q, W), (Q,))."""
    Q, L, W = bitmaps.shape
    prog = programs.to(device=bitmaps.device, dtype=torch.int64)
    S = prog.shape[1]
    slots = torch.empty((Q, L + S, W), dtype=bitmaps.dtype,
                        device=bitmaps.device)
    slots[:, :L] = bitmaps
    rows = torch.arange(Q, device=bitmaps.device)
    for s in range(S):
        op = prog[:, s, 0, None]
        va, vb = slots[rows, prog[:, s, 1]], slots[rows, prog[:, s, 2]]
        slots[:, L + s] = torch.where(
            op == 0, va & vb, torch.where(op == 1, va | vb, va & ~vb))
    out = slots[:, L + S - 1].clone()
    return out, popcount(out).sum(dim=1)


def combine_cluster_ref(bitmaps: torch.Tensor, programs: torch.Tensor,
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """`combine_batch_ref` over a leading shard-unit axis.

    bitmaps: (G, Q, L, W); programs: (G, Q, S, 3) → ((G, Q, W), (G, Q))."""
    G, Q, L, W = bitmaps.shape
    S = programs.shape[2]
    out, cnt = combine_batch_ref(bitmaps.reshape(G * Q, L, W),
                                 programs.reshape(G * Q, S, 3))
    return out.reshape(G, Q, W), cnt.reshape(G, Q)
