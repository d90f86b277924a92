"""Public ops for IoU intersection: bitmap conversion + kernel dispatch.

The host helpers (postings ↔ bitsets, program packing) are NumPy, as in
the reference. The four entry points take NumPy arrays or tensors, move
them to `device`, and return tensors there: bitmaps as `torch.int32`
holding the uint32 bits (`to_numpy` gives the `np.uint32` view back),
counts as int64. A CUDA tensor goes to the hand-written kernel
(`csrc/intersect.cu`) — or, with `impl="ref"`, to the plain PyTorch
version on the card, for comparison; a CPU tensor takes the plain
version. Nothing falls back: without a card `device="cuda"` raises.

The index path's route takes no bitmaps: `intersect_keys` (L-way AND)
and `combine_keys` (AND/OR/ANDNOT programs) take each row's sorted leaf
key lists, rank them into one universe on `device` (`rank_postings`),
and return the rows' candidate keys, flat int64, with per-row counts
(`keys_per_row` splits them on the host). On a card they run the CUDA
kernels `combine_postings` and `bits_to_keys`; on the CPU the plain
versions.

`LAUNCHES[name]` counts each entry point's kernel launches (the main
path's proof that it ran on the card): the four bitmap entry points
under their own names, the key route under `intersect_keys` (the
sketch's doc ids), `intersect_batch_keys`, `combine_batch_keys` and
`combine_cluster_keys`. `LAST_SHAPE[name]` holds the input shapes of
its latest launch: (bitmaps,) or (bitmaps, programs), and a dict of
sizes for the key route. Both are updated under one lock
(`count_launch`): the serving tier launches from several threads.
`launch`, `launch_combine_postings` and `launch_bits_to_keys` are the
bare kernel calls beneath the entry points, for timing: they check no
input and count nothing.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ...analysis.locks import OrderedLock
from .._build import Library
from .ref import (bits_to_keys_ref, combine_batch_ref,
                  combine_cluster_ref, combine_postings_ref,
                  intersect_batch_ref, intersect_ref)

# opcodes of the combine program (shared with the planner)
OP_AND, OP_OR, OP_ANDNOT = 0, 1, 2

_MAX_GRID_Y = 65535          # CUDA's limit on gridDim.y (one row each)
_MAX_INT = 2**31 - 1         # the kernels index words with int
MAX_TILE_W = 1024            # words a combine_postings tile holds at most
_SMEM_DEFAULT = 48 * 1024    # shared memory a block gets without opting in
_SMEM_MAX = 224 * 1024       # what combine_postings may opt into (of 227 KiB)
KEY_CHUNK = 1 << 20          # result keys key_lengths takes at a time


def _declare(handle: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    handle.intersect_max_steps.argtypes = []
    handle.intersect_max_steps.restype = i
    handle.and_popcount_launch.argtypes = [vp, vp, vp, i, i, i, vp]
    handle.and_popcount_launch.restype = i
    handle.combine_program_launch.argtypes = [vp, vp, vp, vp, i, i, i, i, vp]
    handle.combine_program_launch.restype = i
    handle.combine_postings_launch.argtypes = [vp, vp, vp, vp, vp, i, i, i,
                                               i, i, vp]
    handle.combine_postings_launch.restype = i
    handle.bits_to_keys_launch.argtypes = [vp, vp, vp, vp, vp, i, i, i,
                                           vp]
    handle.bits_to_keys_launch.restype = i


# `csrc/intersect.cu`, built by nvcc on first launch
LIBRARY = Library("intersect", Path(__file__).resolve().parent / "csrc",
                  _declare)

LAUNCHES: dict[str, int] = dict.fromkeys(
    ("intersect", "intersect_batch", "combine_batch", "combine_cluster",
     "intersect_keys", "intersect_batch_keys", "combine_batch_keys",
     "combine_cluster_keys"), 0)
LAST_SHAPE: dict[str, tuple | None] = dict.fromkeys(LAUNCHES)
_COUNT_LOCK = OrderedLock("kernels.intersect.launch_counts")


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
            LAST_SHAPE[name] = None


def count_launch(name: str, shape) -> None:
    """Count one launch of `name` with input `shape`, atomically: a
    `ClusterSearcher`'s shard legs and a `Frontend` launch from their
    own threads, and an unlocked `+= 1` can lose a count."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        LAST_SHAPE[name] = shape


def postings_to_bitmap(postings: list[np.ndarray], n_docs: int) -> np.ndarray:
    """Sorted doc-id arrays → (L, ceil(n_docs/32)) uint32 bitsets."""
    W = (n_docs + 31) // 32
    out = np.zeros((len(postings), W), dtype=np.uint32)
    for l, docs in enumerate(postings):
        docs = np.asarray(docs, dtype=np.uint64)
        np.bitwise_or.at(out[l], (docs // 32).astype(np.int64),
                         np.uint32(1) << (docs % 32).astype(np.uint32))
    return out


def postings_to_bitmap_batch(postings_batch: list[list[np.ndarray]],
                             n_docs: int) -> np.ndarray:
    """Ragged batch of doc-id lists → (Q, L_max, W) uint32 bitsets.

    Queries with fewer than L_max postings lists are padded with all-ones
    layers — the AND identity — so one fused kernel call handles a batch
    of queries with different term counts.
    """
    L_max = max(len(p) for p in postings_batch)
    W = (n_docs + 31) // 32
    out = np.full((len(postings_batch), L_max, W), 0xFFFFFFFF,
                  dtype=np.uint32)
    for q, posts in enumerate(postings_batch):
        out[q, :len(posts)] = postings_to_bitmap(posts, n_docs)
    return out


def bitmap_to_docs(bitmap: np.ndarray) -> np.ndarray:
    """Intersection bitset → sorted uint32 doc ids."""
    bits = np.unpackbits(
        np.asarray(bitmap, dtype=np.uint32).view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.uint32)


def pack_programs(programs: list[list[tuple[int, int, int]]],
                  n_layers: int) -> np.ndarray:
    """Ragged per-query combine programs → one (Q, S_max, 3) int32 array.

    Each program row is (opcode, slot_a, slot_b); slots 0..n_layers-1
    are the query's input layers and step s writes slot n_layers+s.
    Shorter programs are padded with AND(result, result) — the identity
    — so the whole batch evaluates in one fused kernel call. An empty
    program (single-layer query) becomes AND(layer0, layer0).
    """
    S = max(1, max(len(p) for p in programs))
    out = np.empty((len(programs), S, 3), dtype=np.int32)
    for q, prog in enumerate(programs):
        for s in range(S):
            if s < len(prog):
                out[q, s] = prog[s]
            else:                 # chain the last result through: r & r
                prev = n_layers + s - 1 if s else 0
                out[q, s] = (OP_AND, prev, prev)
    return out


def pack_cluster_programs(programs: list[list[list[tuple[int, int, int]]]],
                          n_layers: int) -> np.ndarray:
    """Ragged per-(shard, query) programs → one (G, Q, S_max, 3) array.

    `programs[g][q]` is shard-unit g's combine program for query q; all
    groups must cover the same Q queries. Flattens through
    `pack_programs` so every program is padded to the cluster-wide
    S_max with the chained identity step (AND of the previous result
    with itself) — zero-padding here would overwrite each result slot
    with layer 0.
    """
    Q = len(programs[0])
    if any(len(g) != Q for g in programs):
        raise ValueError("all shard groups must carry the same Q queries")
    flat = pack_programs([p for g in programs for p in g], n_layers)
    return flat.reshape(len(programs), Q, flat.shape[1], 3)


# ---------------------------------------------------------------- tensors
def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA card is available; pass "
            "device='cpu' to run the plain PyTorch versions")
    return dev


def to_numpy(bitmaps: torch.Tensor) -> np.ndarray:
    """int32-held bitmaps on any device → np.uint32 array (same bits)."""
    return bitmaps.cpu().numpy().view(np.uint32)


def _bitmaps(x, device, ndim: int) -> torch.Tensor:
    """Bitsets as a contiguous int32 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            x = x.view(torch.int32)
        elif x.dtype != torch.int32:
            raise TypeError(f"bitmaps must be int32 or uint32, not {x.dtype}")
    else:
        arr = np.ascontiguousarray(np.asarray(x).astype(np.uint32,
                                                        copy=False))
        x = torch.from_numpy(arr.view(np.int32))
    if x.dim() != ndim:
        raise ValueError(f"bitmaps must be {ndim}-D, got {tuple(x.shape)}")
    if x.shape[-2] < 1:
        raise ValueError("bitmaps need at least one layer")
    return x.to(resolve_device(device)).contiguous()


def _programs(p, n_layers: int, shape: tuple, device) -> torch.Tensor:
    """Validated (…, S, 3) int32 programs on `device`.

    Every step's opcode must be AND/OR/ANDNOT and its operands earlier
    slots (a layer or a previous step) — the kernel indexes slots with
    them, so a bad program is refused on the host, never evaluated."""
    host = (p.cpu().numpy() if isinstance(p, torch.Tensor)
            else np.asarray(p)).astype(np.int32, copy=False)
    if host.shape[:-2] != shape or host.ndim < 2 or host.shape[-1] != 3:
        raise ValueError(f"programs must be {(*shape, 'S', 3)}, "
                         f"got {host.shape}")
    ops, slots = host[..., 0], host[..., 1:]
    limit = n_layers + np.arange(host.shape[-2])[:, None]     # (S, 1)
    if ((ops < OP_AND) | (ops > OP_ANDNOT)).any():
        raise ValueError("program opcodes must be AND=0, OR=1 or ANDNOT=2")
    if ((slots < 0) | (slots >= limit)).any():
        raise ValueError("program step reads a slot it has not written")
    return torch.from_numpy(np.ascontiguousarray(host)).to(device)


def _launch(name: str, shapes: tuple, bm: torch.Tensor,
            prog: torch.Tensor | None = None,
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run a CUDA kernel over (rows, L, W) bitmaps on their card:
    `and_popcount`, or `combine_program` when (rows, S, 3) programs are
    given. `shapes` are the caller's input shapes, kept in LAST_SHAPE."""
    rows, L, W = bm.shape
    if bm.device.type != "cuda" or bm.dtype != torch.int32 \
            or not bm.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous int32 CUDA "
                         "tensors")
    if rows > _MAX_GRID_Y or W > _MAX_INT - 255:
        raise ValueError(f"{rows} rows of {W} words exceed the kernel's "
                         "grid")
    lib = LIBRARY.lib()
    if prog is not None:
        S = prog.shape[1]
        if prog.device != bm.device or prog.dtype != torch.int32 \
                or not prog.is_contiguous() or prog.shape != (rows, S, 3):
            raise ValueError("programs must be contiguous int32 "
                             "(rows, S, 3) on the bitmaps' device")
        if S > lib.intersect_max_steps():
            raise ValueError(f"program of {S} steps exceeds the kernel's "
                             f"cap of {lib.intersect_max_steps()}")
    out = torch.empty((rows, W), dtype=torch.int32, device=bm.device)
    cnt = torch.zeros(rows, dtype=torch.int64, device=bm.device)
    if rows and W:
        with torch.cuda.device(bm.device):
            launch(name, bm, prog, out, cnt)
        count_launch(name, shapes)
    return out, cnt


def launch(name: str, bm: torch.Tensor, prog: torch.Tensor | None,
           out: torch.Tensor, cnt: torch.Tensor) -> None:
    """Bare launch on the current stream into preallocated `out`
    (rows, W) int32 and `cnt` (rows,) int64, which the kernel adds to.

    Checks no input and counts no launch: `_launch` does both before it
    calls this. Raises if the launch itself fails."""
    lib = LIBRARY.lib()
    rows, L, W = bm.shape
    stream = torch.cuda.current_stream().cuda_stream
    if prog is None:
        rc = lib.and_popcount_launch(bm.data_ptr(), out.data_ptr(),
                                     cnt.data_ptr(), rows, L, W, stream)
    else:
        rc = lib.combine_program_launch(
            bm.data_ptr(), prog.data_ptr(), out.data_ptr(), cnt.data_ptr(),
            rows, L, prog.shape[1], W, stream)
    if rc:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {rc}")


def _dispatch(impl: str, bm: torch.Tensor) -> bool:
    """True when the call goes to the CUDA kernel."""
    if impl not in ("cuda", "ref"):
        raise ValueError(f"impl must be 'cuda' or 'ref', not {impl!r}")
    return impl == "cuda" and bm.device.type == "cuda"


# ------------------------------------------------------------ entry points
def intersect(bitmaps, impl: str = "cuda", device="cuda"):
    """(L, W) bitsets → (bitmap (W,) int32, count () int64)."""
    bm = _bitmaps(bitmaps, device, 2)
    if not _dispatch(impl, bm):
        return intersect_ref(bm)
    out, cnt = _launch("intersect", (tuple(bm.shape),), bm[None])
    return out[0], cnt[0]


def intersect_batch(bitmaps, impl: str = "cuda", device="cuda"):
    """(Q, L, W) bitsets → (bitmaps (Q, W) int32, counts (Q,) int64)."""
    bm = _bitmaps(bitmaps, device, 3)
    if not _dispatch(impl, bm):
        return intersect_batch_ref(bm)
    return _launch("intersect_batch", (tuple(bm.shape),), bm)


def combine_batch(bitmaps, programs, impl: str = "cuda", device="cuda"):
    """Evaluate per-query AND/OR/ANDNOT programs over layered bitsets.

    bitmaps: (Q, L, W); programs: (Q, S, 3) (see `pack_programs`) →
    (result bitmaps (Q, W) int32, counts (Q,) int64).
    """
    bm = _bitmaps(bitmaps, device, 3)
    prog = _programs(programs, bm.shape[1], bm.shape[:1], bm.device)
    if not _dispatch(impl, bm):
        return combine_batch_ref(bm, prog)
    return _launch("combine_batch", (tuple(bm.shape), tuple(prog.shape)),
                   bm, prog)


def combine_cluster(bitmaps, programs, impl: str = "cuda", device="cuda"):
    """Evaluate a whole cluster's combine round in one fused launch.

    bitmaps: (G, Q, L, W) — axis 0 is the shard unit; programs:
    (G, Q, S, 3) (`pack_cluster_programs`). Returns (result bitmaps
    (G, Q, W) int32, counts (G, Q) int64) — the counts are the
    per-(shard, query) candidate totals that drive the global top-K
    sampling budget.
    """
    bm = _bitmaps(bitmaps, device, 4)
    prog = _programs(programs, bm.shape[2], bm.shape[:2], bm.device)
    if not _dispatch(impl, bm):
        return combine_cluster_ref(bm, prog)
    G, Q, L, W = bm.shape
    out, cnt = _launch("combine_cluster",
                       (tuple(bm.shape), tuple(prog.shape)),
                       bm.view(G * Q, L, W),
                       prog.view(G * Q, prog.shape[2], 3))
    return out.view(G, Q, W), cnt.view(G, Q)


# -------------------------------------------- posting ranks → candidate keys
@dataclass
class Ranked:
    """Rows of sorted leaf lists ranked into one universe on a device.

    `ranks` (n,) int32 holds every distinct leaf's ranks, concatenated
    (a leaf shared by rows or layers is shipped and ranked once);
    `bounds` (rows, L, 2) int32 gives each (row, layer)'s [start, end)
    in it, [0, 0) for a row's padding layers; `universe` (U,) int64 is
    the sorted union of the leaves' keys, or None for the identity
    universe of `n_bits` document ids, where a key is its own rank.
    `offsets` (host, distinct leaves + 1) delimit the distinct leaves in
    `ranks`; `lengths` (n,) int64, when the leaves came with lengths,
    holds each rank's document length."""

    ranks: torch.Tensor
    bounds: torch.Tensor
    universe: torch.Tensor | None
    n_bits: int
    offsets: np.ndarray
    lengths: torch.Tensor | None = None


def _leaf_int64(leaf) -> np.ndarray:
    a = np.asarray(leaf)
    if a.ndim != 1 or a.dtype.kind not in "iu":
        raise TypeError("leaves must be 1-D integer arrays, not "
                        f"{a.dtype} of shape {a.shape}")
    if a.dtype == np.uint64:         # keys >= 2**63 turn negative: refused
        return a.view(np.int64)
    return a.astype(np.int64, copy=False)


def rank_postings(rows: list[list], n_docs: int | None = None,
                  device="cuda", n_layers: int | None = None,
                  lengths: list[list] | None = None) -> Ranked:
    """Rank every row's leaves into one sorted universe on `device`.

    Each leaf is a sorted array of non-negative integer keys (uint64
    posting keys, or document ids); a leaf whose keys fall raises
    ValueError, as does a key >= 2**63. A key that repeats inside its
    leaf is kept once, with the length of its first occurrence: the
    bitmap route sets its bit once, and a posting list built from a
    corpus that holds one document twice repeats its key (ROADMAP §3,
    the duplicate-document fault). The distinct leaves (by
    identity) are concatenated and shipped once; `torch.unique` sorts
    them into the universe and `torch.searchsorted` ranks each leaf.
    With `n_docs`, leaves are document ids below it and rank as
    themselves. One universe for all rows gives each row the same sets
    as its own would: a row's results lie in its leaves' union, and the
    ranks keep the keys' order. `n_layers` pads the bounds to that many
    layers (default: the longest row). `lengths`, shaped as `rows`, are
    the leaves' document lengths, shipped beside them."""
    dev = resolve_device(device)
    if n_docs is not None and not 0 <= n_docs <= _MAX_INT:
        raise ValueError(f"n_docs={n_docs} exceeds the kernels' int32 ranks")
    L = max((len(r) for r in rows), default=0) if n_layers is None \
        else n_layers
    index: dict[tuple, int] = {}
    distinct: list[np.ndarray] = []
    distinct_len: list[np.ndarray] = []
    ids = np.full((len(rows), L), -1, dtype=np.int64)
    for i, row in enumerate(rows):
        if len(row) > L:
            raise ValueError(f"row {i} has {len(row)} leaves, more than "
                             f"n_layers={L}")
        for l, leaf in enumerate(row):
            ln = None if lengths is None else lengths[i][l]
            d = index.get((id(leaf), id(ln)))
            if d is None:
                d = index[(id(leaf), id(ln))] = len(distinct)
                distinct.append(_leaf_int64(leaf))
                if ln is not None:
                    distinct_len.append(_leaf_int64(ln))
                    if len(distinct_len[-1]) != len(distinct[-1]):
                        raise ValueError(f"row {i} leaf {l}: "
                                         f"{len(distinct_len[-1])} lengths "
                                         f"for {len(distinct[-1])} keys")
            ids[i, l] = d
    offsets = np.zeros(len(distinct) + 1, dtype=np.int64)
    np.cumsum([len(a) for a in distinct], out=offsets[1:])
    n = int(offsets[-1])
    if n > _MAX_INT:
        raise ValueError(f"{n} posting keys exceed the kernels' int32 ranks")
    keys = torch.from_numpy(np.concatenate(distinct) if distinct
                            else np.empty(0, np.int64)).to(dev)
    # one read-back for the four checks: each leaf non-decreasing (pairs
    # that straddle two leaves excepted), keys in [0, 2**63), document
    # ids below n_docs, and whether a key repeats inside its leaf
    cuts = offsets[1:-1]
    cuts = torch.from_numpy(cuts[(cuts > 0) & (cuts < n)] - 1).to(dev)
    falls, repeats = keys[1:] < keys[:-1], keys[1:] == keys[:-1]
    falls[cuts] = False
    repeats[cuts] = False
    flags = [(keys < 0).any(), falls.any(), repeats.any()]
    if n_docs is not None:
        flags.append((keys >= n_docs).any())
    flags = torch.stack(flags).tolist()
    if flags[0]:               # first: a uint64 key >= 2**63 also "falls"
        raise ValueError("posting keys must lie in [0, 2**63)")
    if flags[1]:
        raise ValueError("each leaf's keys must be sorted")
    if n_docs is not None and flags[3]:
        raise ValueError(f"document ids must be below n_docs={n_docs}")
    keep = None
    if flags[2]:               # keep each repeated key's first occurrence
        keep = torch.cat([torch.ones(min(n, 1), dtype=torch.bool,
                                     device=dev), ~repeats])
        keys = keys[keep]
        kept = torch.cumsum(keep, 0, dtype=torch.int64).cpu().numpy()
        offsets = np.concatenate([[0], kept])[offsets]
        n = int(offsets[-1])
    if n_docs is None:
        universe = torch.unique(keys)
        ranks = torch.searchsorted(universe, keys, out_int32=True)
        n_bits = universe.numel()
    else:
        universe, ranks, n_bits = None, keys.to(torch.int32), int(n_docs)
    safe = np.maximum(ids, 0)
    bounds = np.stack([np.where(ids >= 0, offsets[safe], 0),
                       np.where(ids >= 0, offsets[safe + 1], 0)], axis=-1)
    doc_lengths = None if lengths is None else torch.from_numpy(
        np.concatenate(distinct_len) if distinct_len
        else np.empty(0, np.int64)).to(dev)
    if doc_lengths is not None and keep is not None:
        doc_lengths = doc_lengths[keep]
    return Ranked(ranks, torch.from_numpy(bounds.astype(np.int32)).to(dev),
                  universe, n_bits, offsets, doc_lengths)


def key_lengths(ranked: Ranked, key_ranks: torch.Tensor,
                counts: torch.Tensor, chunk: int = KEY_CHUNK,
                ) -> torch.Tensor:
    """Each result key's document length, int64 on the keys' device:
    from the last of its row's leaves that holds it (0 if none does),
    the rule of the planner's host-side `_recover_lengths`.

    `key_ranks` are the rows' flat keys' int32 ranks in the universe (as
    `bits_to_keys` writes them beside the keys) and `counts` the per-row
    counts. One `torch.searchsorted` per layer over (leaf start · U +
    rank), a key that is sorted across all distinct leaves at once. The
    keys go `chunk` at a time, so the temporaries stay a few `chunk`
    int64 values however many keys there are."""
    if ranked.lengths is None:
        raise ValueError("the leaves were ranked without lengths")
    dev = key_ranks.device
    out = torch.zeros(key_ranks.numel(), dtype=torch.int64, device=dev)
    n, U = ranked.ranks.numel(), ranked.n_bits
    if not n or not out.numel():
        return out
    off = torch.from_numpy(ranked.offsets).to(dev)
    comp = torch.repeat_interleave(off[:-1], off[1:] - off[:-1],
                                   output_size=n) * U \
        + ranked.ranks.to(torch.int64)
    ends = torch.cumsum(counts.reshape(-1), 0)
    bounds = ranked.bounds.to(torch.int64)
    for c0 in range(0, out.numel(), chunk):
        c1 = min(c0 + chunk, out.numel())
        row = torch.searchsorted(ends, torch.arange(c0, c1, device=dev),
                                 right=True)
        rank, got = key_ranks[c0:c1].to(torch.int64), out[c0:c1]
        for l in range(bounds.shape[1]):
            start, end = bounds[row, l, 0], bounds[row, l, 1]
            want = start * U + rank
            pos = torch.searchsorted(comp, want).clamp_(max=n - 1)
            hit = (end > start) & (comp[pos] == want)
            got.copy_(torch.where(hit, ranked.lengths[pos], got))
    return out


def _postings_smem(L: int, S: int, tile_w: int) -> int:
    """Shared bytes combine_postings takes (csrc `postings_smem`)."""
    return 4 * ((3 * S + 2 * L + 3) & ~3) + 4 * (L + S) * tile_w


def plan_tile(L: int, S: int) -> int:
    """combine_postings' words per tile: MAX_TILE_W, halved (to 32 at
    least) until the L + S slot tiles fit the 48 KiB a block gets
    without opting in; programs that do not fit the card even at 32
    words are refused."""
    tile_w = MAX_TILE_W
    while tile_w > 32 and _postings_smem(L, S, tile_w) > _SMEM_DEFAULT:
        tile_w //= 2
    if _postings_smem(L, S, tile_w) > _SMEM_MAX:
        raise ValueError(f"{L} layers and {S} program steps exceed the "
                         "shared memory of one combine_postings block")
    return tile_w


def _and_chain(n: int, L: int) -> list[tuple[int, int, int]]:
    """The L-way AND of a row's n leaves as n - 1 AND steps (slots
    numbered for L layers)."""
    if n < 2:
        return []
    return [(OP_AND, 0, 1)] + [(OP_AND, L + s - 1, s + 1)
                               for s in range(1, n - 1)]


@dataclass
class KeyPlan:
    """What the key route's kernels take: the ranked leaves, the
    (rows, S, 3) programs over L = `ranked.bounds.shape[1]` layers, and
    the tiling: `tiles` tiles of `tile_w` words a row."""

    ranked: Ranked
    programs: torch.Tensor
    tile_w: int
    tiles: int


def plan_keys(rows: list[list], programs: list | None = None,
              n_docs: int | None = None, device="cuda",
              lengths: list[list] | None = None) -> KeyPlan:
    """Rank the rows' leaves (and ship their `lengths`, if given) and
    pack their programs for the kernels.

    `programs[i]` is row i's steps over its own slots (its leaves, then
    one slot per step); None means each row's L-way AND."""
    L = max(1, max((len(r) for r in rows), default=0))
    if programs is None:
        steps = [_and_chain(len(r), L) for r in rows]
    else:
        if len(programs) != len(rows):
            raise ValueError(f"{len(programs)} programs for {len(rows)} "
                             "rows")
        # re-point step slots at the common layer count
        steps = [[(op, a if a < len(r) else a + L - len(r),
                   b if b < len(r) else b + L - len(r)) for op, a, b in p]
                 for r, p in zip(rows, programs)]
    ranked = rank_postings(rows, n_docs, device, n_layers=L,
                           lengths=lengths)
    dev = ranked.ranks.device
    packed = pack_programs(steps, L) if rows else \
        np.zeros((0, 1, 3), dtype=np.int32)
    prog = _programs(packed, L, (len(rows),), dev)
    tile_w = plan_tile(L, prog.shape[1])
    return KeyPlan(ranked, prog, tile_w,
                   -(-ranked.n_bits // (32 * tile_w)) if rows else 0)


def keys_plain(plan: KeyPlan, ranks: bool = False) -> tuple:
    """The plain versions: (result words, tile counts, keys, the keys'
    int32 ranks if `ranks` else None)."""
    r = plan.ranked
    words, tile_cnt = combine_postings_ref(r.ranks, r.bounds, plan.programs,
                                           plan.tiles, plan.tile_w)
    if not ranks:
        return words, tile_cnt, bits_to_keys_ref(words, r.universe), None
    return (words, tile_cnt) + bits_to_keys_ref(words, r.universe, True)


def keys_kernels(plan: KeyPlan, ranks: bool = False) -> tuple:
    """The CUDA kernels on the plan's card: `combine_postings`, the tile
    counts' exclusive prefix (a torch.cumsum), `bits_to_keys`. Returns
    (result words, tile counts, keys, the keys' int32 ranks if `ranks`
    else None); counts no launch. The plan comes from `plan_keys`, which
    checked its values; here its tensors' types, layout and device are
    checked before their pointers are passed."""
    r = plan.ranked
    dev = r.ranks.device
    want = [(r.ranks, torch.int32, 1), (r.bounds, torch.int32, 3),
            (plan.programs, torch.int32, 3)]
    if r.universe is not None:
        want.append((r.universe, torch.int64, 1))
    if dev.type != "cuda" or any(
            t.device != dev or t.dtype != dtype or t.dim() != ndim
            or not t.is_contiguous() for t, dtype, ndim in want):
        raise ValueError("the CUDA kernels take contiguous CUDA tensors "
                         "on one card, as plan_keys makes them")
    if r.n_bits > _MAX_INT - 32 * plan.tile_w:
        raise ValueError(f"a universe of {r.n_bits} keys exceeds the "
                         "kernels' int32 ranks")
    rows = plan.programs.shape[0]
    words = torch.empty((rows, plan.tiles * plan.tile_w), dtype=torch.int32,
                        device=dev)
    tile_cnt = torch.empty((rows, plan.tiles), dtype=torch.int32,
                           device=dev)
    with torch.cuda.device(dev):
        launch_combine_postings(r.ranks, r.bounds, plan.programs, words,
                                tile_cnt, plan.tiles, plan.tile_w)
        flat = tile_cnt.view(-1).to(torch.int64)
        ends = torch.cumsum(flat, 0)
        n_keys = int(ends[-1])
        keys = torch.empty(n_keys, dtype=torch.int64, device=dev)
        key_ranks = torch.empty(n_keys, dtype=torch.int32, device=dev) \
            if ranks else None
        launch_bits_to_keys(words, ends - flat, r.universe, keys,
                            plan.tiles, plan.tile_w, key_ranks)
    return words, tile_cnt, keys, key_ranks


def intersect_keys(rows: list[list], n_docs: int | None = None,
                   impl: str = "cuda", device="cuda",
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """L-way AND of each row's sorted leaf lists → (keys, counts).

    With `n_docs`, the leaves are document ids below it and the key of a
    match is its id (the identity universe; counted as
    `intersect_keys`); otherwise uint64 posting keys, ranked into one
    universe built on `device` (`intersect_batch_keys`). Returns the
    rows' keys as one flat int64 tensor, row after row, each row
    ascending, and the (rows,) int64 counts; a row with an empty leaf
    (or none) has no keys."""
    route = "intersect_keys" if n_docs is not None else \
        "intersect_batch_keys"
    keys, counts, _ = _keys(route, plan_keys(rows, None, n_docs, device),
                            impl)
    return keys, counts


def combine_keys(rows: list[list], programs: list[list[tuple[int, int,
                                                             int]]],
                 groups: int | None = None, impl: str = "cuda",
                 device="cuda", lengths: list[list] | None = None,
                 ) -> tuple[torch.Tensor, ...]:
    """Evaluate each row's AND/OR/ANDNOT program over its leaf lists →
    (keys, counts).

    `programs[i]` is row i's steps over its own slots: its leaves are
    slots 0..len(rows[i])-1 and step s writes slot len(rows[i]) + s (the
    planner's layout); the last step is the row's result. Keys come back
    as in `intersect_keys`. With `groups` = G, the rows are a cluster's
    (G, Q) (shard, query) pairs flattened and the counts come back
    (G, Q) (counted as `combine_cluster_keys`, else
    `combine_batch_keys`). With `lengths` (the leaves' document lengths,
    shaped as `rows`), a third tensor gives each key's length
    (`key_lengths`), recovered on the device from the ranks
    `bits_to_keys` writes beside the keys."""
    if groups is not None and (groups < 1 or len(rows) % groups):
        raise ValueError(f"{len(rows)} rows do not split into {groups} "
                         "groups")
    route = "combine_cluster_keys" if groups is not None else \
        "combine_batch_keys"
    plan = plan_keys(rows, programs, None, device, lengths)
    keys, counts, key_ranks = _keys(route, plan, impl,
                                    ranks=lengths is not None)
    out = (keys, counts if groups is None else counts.view(groups, -1))
    return out if lengths is None else \
        out + (key_lengths(plan.ranked, key_ranks, counts),)


def keys_per_row(keys: torch.Tensor, counts: torch.Tensor,
                 ) -> list[np.ndarray]:
    """Flat keys and their per-row counts → one sorted np.uint64 array a
    row, after one read-back."""
    counts = counts.reshape(-1).cpu().numpy()
    if not counts.size:
        return []
    return np.split(keys.cpu().numpy().view(np.uint64),
                    np.cumsum(counts)[:-1])


def _keys(route: str, plan: KeyPlan, impl: str, ranks: bool = False,
          ) -> tuple:
    """Run a plan: the CUDA kernels for CUDA tensors, else the plain
    versions. Returns (keys, per-row int64 counts, the keys' int32 ranks
    if `ranks` else None)."""
    if impl not in ("cuda", "ref"):
        raise ValueError(f"impl must be 'cuda' or 'ref', not {impl!r}")
    rows = plan.programs.shape[0]
    dev = plan.ranked.ranks.device
    if not plan.tiles:                   # no rows, or an empty universe
        return (torch.empty(0, dtype=torch.int64, device=dev),
                torch.zeros(rows, dtype=torch.int64, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev)
                if ranks else None)
    if impl == "ref" or dev.type != "cuda":
        _words, tile_cnt, keys, key_ranks = keys_plain(plan, ranks)
    else:
        _words, tile_cnt, keys, key_ranks = keys_kernels(plan, ranks)
        count_launch(route, {
            "rows": rows, "L": plan.ranked.bounds.shape[1],
            "S": plan.programs.shape[1], "ranks": plan.ranked.ranks.numel(),
            "universe": plan.ranked.n_bits, "tile_w": plan.tile_w,
            "tiles": plan.tiles, "keys": keys.numel()})
    return keys, tile_cnt.sum(1, dtype=torch.int64), key_ranks


def launch_combine_postings(ranks: torch.Tensor, bounds: torch.Tensor,
                            prog: torch.Tensor, words: torch.Tensor,
                            tile_cnt: torch.Tensor, tiles: int,
                            tile_w: int) -> None:
    """Bare `combine_postings` launch on the current stream into
    preallocated (rows, tiles · tile_w) `words` and (rows, tiles)
    `tile_cnt`. Checks no input and counts no launch; raises if the
    launch fails."""
    rows, L, _ = bounds.shape
    rc = LIBRARY.lib().combine_postings_launch(
        ranks.data_ptr(), bounds.data_ptr(), prog.data_ptr(),
        words.data_ptr(), tile_cnt.data_ptr(), rows, L, prog.shape[1],
        tiles, tile_w, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"combine_postings: CUDA kernel launch failed "
                           f"with cudaError {rc}")


def launch_bits_to_keys(words: torch.Tensor, offsets: torch.Tensor,
                        universe: torch.Tensor | None, keys: torch.Tensor,
                        tiles: int, tile_w: int,
                        key_ranks: torch.Tensor | None = None) -> None:
    """Bare `bits_to_keys` launch on the current stream: `offsets` are
    the exclusive int64 prefix sums of the flattened tile counts, `keys`
    (int64) and `key_ranks` (int32, or None for none) are preallocated
    to their total. Checks no input and counts no launch; raises if the
    launch fails."""
    rc = LIBRARY.lib().bits_to_keys_launch(
        words.data_ptr(), offsets.data_ptr(),
        None if universe is None else universe.data_ptr(), keys.data_ptr(),
        None if key_ranks is None else key_ranks.data_ptr(),
        words.shape[0], tiles, tile_w,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"bits_to_keys: CUDA kernel launch failed with "
                           f"cudaError {rc}")
