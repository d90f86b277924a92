"""Public ops for IoU intersection: bitmap conversion + kernel dispatch.

The host helpers (postings ↔ bitsets, program packing) are NumPy, as in
the reference. The four entry points take NumPy arrays or tensors, move
them to `device`, and return tensors there: bitmaps as `torch.int32`
holding the uint32 bits (`to_numpy` gives the `np.uint32` view back),
counts as int64. A CUDA tensor goes to the hand-written kernel
(`csrc/intersect.cu`) — or, with `impl="ref"`, to the plain PyTorch
version on the card, for comparison; a CPU tensor takes the plain
version. Nothing falls back: without a card `device="cuda"` raises.

`LAUNCHES[name]` counts each entry point's kernel launches (the main
path's proof that it ran on the card); `LAST_SHAPE[name]` holds the
input shapes of its latest launch: (bitmaps,) or (bitmaps, programs).
`launch` is the bare kernel call beneath the entry points, for timing:
it checks no input and counts nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from .ref import (combine_batch_ref, combine_cluster_ref,
                  intersect_batch_ref, intersect_ref)

# opcodes of the combine program (shared with the planner)
OP_AND, OP_OR, OP_ANDNOT = 0, 1, 2

_MAX_GRID_Y = 65535          # CUDA's limit on gridDim.y (one row each)
_MAX_INT = 2**31 - 1         # the kernels index words with int

LAUNCHES: dict[str, int] = dict.fromkeys(
    ("intersect", "intersect_batch", "combine_batch", "combine_cluster"), 0)
LAST_SHAPE: dict[str, tuple | None] = dict.fromkeys(LAUNCHES)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        LAST_SHAPE[name] = None


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
    from . import _build

    rows, L, W = bm.shape
    if bm.device.type != "cuda" or bm.dtype != torch.int32 \
            or not bm.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous int32 CUDA "
                         "tensors")
    if rows > _MAX_GRID_Y or W > _MAX_INT - 255:
        raise ValueError(f"{rows} rows of {W} words exceed the kernel's "
                         "grid")
    lib = _build.lib()
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
        LAUNCHES[name] += 1
        LAST_SHAPE[name] = shapes
    return out, cnt


def launch(name: str, bm: torch.Tensor, prog: torch.Tensor | None,
           out: torch.Tensor, cnt: torch.Tensor) -> None:
    """Bare launch on the current stream into preallocated `out`
    (rows, W) int32 and `cnt` (rows,) int64, which the kernel adds to.

    Checks no input and counts no launch: `_launch` does both before it
    calls this. Raises if the launch itself fails."""
    from . import _build

    lib = _build.lib()
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
