"""Plain PyTorch versions of the intersect kernels.

Bitmaps travel as `torch.int32` tensors holding the uint32 bit patterns
(CPU `torch.uint32` has no `~`, `>>` or `-`); counts come back as int64.
Only int32/int64 ops are used, so these run on CPU and CUDA tensors
alike: the CPU path of every wrapper in `ops.py`, and what the CUDA
kernels are held against on the card.

`combine_postings_ref` and `bits_to_keys_ref` are the route from posting
ranks to candidate keys: ranks in CSR form (one flat int32 array and
(rows, L, 2) [start, end) bounds into it), result words laid out as
(rows, tiles · tile_w) with a (rows, tiles) int32 popcount per tile,
exactly as the CUDA kernels lay them out. `intersect_keys_ref` and
`combine_keys_ref` compute the route's entry points' function from the
rows' leaf key lists by set operations on the host, with neither ranks
nor bitmaps.
"""

from __future__ import annotations

from functools import reduce

import numpy as np
import torch

# a combine program's step operators, as `ops.py` numbers them
_AND, _OR, _ANDNOT = 0, 1, 2

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


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) → int32 tensors holding the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def postings_bitmaps_ref(ranks: torch.Tensor, bounds: torch.Tensor,
                         n_words: int) -> torch.Tensor:
    """CSR rank lists → (rows, L, n_words) int32 bitsets.

    The ranks of one list are distinct, so their bits within a word are
    distinct powers of two and the word's OR is their sum."""
    rows, L, _ = bounds.shape
    start = bounds[..., 0].reshape(-1).to(torch.int64)
    length = (bounds[..., 1] - bounds[..., 0]).reshape(-1).to(torch.int64)
    dev = ranks.device
    total = int(length.sum())
    seg = torch.repeat_interleave(torch.arange(rows * L, device=dev), length)
    first = torch.cumsum(length, 0) - length
    pos = torch.arange(total, device=dev) - first[seg] + start[seg]
    r = ranks[pos].to(torch.int64)
    words = torch.zeros(rows * L * n_words, dtype=torch.int64, device=dev)
    words.index_add_(0, seg * n_words + (r >> 5),
                     torch.ones_like(r) << (r & 31))
    return _to_int32_bits(words).view(rows, L, n_words)


def combine_postings_ref(ranks: torch.Tensor, bounds: torch.Tensor,
                         programs: torch.Tensor, tiles: int, tile_w: int,
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Evaluate (rows, S, 3) programs over CSR rank lists.

    ranks: (n,) int32, each (row, layer)'s [start, end) slice sorted;
    bounds: (rows, L, 2) int32. Returns the result words (rows,
    tiles · tile_w) int32 and each tile's popcount (rows, tiles) int32.
    """
    bm = postings_bitmaps_ref(ranks, bounds, tiles * tile_w)
    if programs.shape[1]:
        out, _ = combine_batch_ref(bm, programs)
    else:
        out = bm[:, -1].clone()
    tile_cnt = popcount(out).view(out.shape[0], tiles, tile_w).sum(-1)
    return out, tile_cnt.to(torch.int32)


def bits_to_keys_ref(words: torch.Tensor,
                     universe: torch.Tensor | None = None,
                     ranks: bool = False,
                     ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """(rows, n_words) int32 result words → the set bits' keys, int64,
    row after row in ascending order: `universe[rank]`, or the rank
    itself without a universe. With `ranks`, (keys, the keys' int32
    ranks)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    rk = torch.nonzero(bits.view(words.shape[0], -1))[:, 1]
    keys = rk if universe is None else universe[rk]
    return (keys, rk.to(torch.int32)) if ranks else keys


def _set_keys(rows: list, programs: list | None,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's result by NumPy set operations on its leaves' uint64
    keys (the AND of all of them, or its program's last slot) → (flat
    int64 keys row after row, each row ascending; (rows,) int64 counts)."""
    found = []
    for q, row in enumerate(rows):
        slots = [np.unique(np.asarray(a).astype(np.uint64)) for a in row]
        if programs is None:
            found.append(reduce(np.intersect1d, slots) if slots
                         else np.empty(0, np.uint64))
            continue
        for op, a, b in programs[q]:
            va, vb = slots[a], slots[b]
            slots.append(np.intersect1d(va, vb) if op == _AND else
                         np.union1d(va, vb) if op == _OR else
                         np.setdiff1d(va, vb))
        found.append(slots[-1])
    keys = np.concatenate(found) if found else np.empty(0, np.uint64)
    return (torch.from_numpy(keys.astype(np.uint64).view(np.int64)),
            torch.tensor([len(f) for f in found], dtype=torch.int64))


def intersect_keys_ref(rows: list, n_docs: int | None = None,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """`ops.intersect_keys`'s function: each row's L-way AND of its
    sorted leaf key lists → (keys, counts), the keys as one flat int64
    tensor (uint64 posting keys as their bits), row after row, each row
    ascending. A key is the leaf's own value in either universe (document
    ids below `n_docs`, or posting keys), so `n_docs` changes nothing."""
    return _set_keys(rows, None)


def combine_keys_ref(rows: list, programs: list, groups: int | None = None,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """`ops.combine_keys`'s function (without lengths): each row's
    AND/OR/ANDNOT program over its own slots (its leaves first, then one
    slot a step; the last step is the result) → (keys, counts), the
    counts (G, Q) with `groups` = G."""
    keys, counts = _set_keys(rows, programs)
    return keys, counts if groups is None else counts.view(groups, -1)
