"""Edge cases of the key route (`intersect_keys`, `combine_keys`).

The inputs that the CPU tests hold the plain versions to the JAX
package's kernels with, and that the card tests and `chip_smoke.py`'s
`edge` phase hold the CUDA kernels `combine_postings` and `bits_to_keys`
to their plain versions with: an empty leaf; universes of 1, 31, 32, 33
and TILE_BITS ± 1 keys (TILE_BITS = 32 · MAX_TILE_W, one full tile) and
identity universes of 1, 33 and TILE_BITS + 1 doc ids; a row whose
postings fill one tile (every lane of a warp on one word's atomic); a
row with postings in 2 tiles of 12; ANDNOT and identity-padded
programs; keys with blob keys just below 2**23 (keys just below 2**63).
Made from fixed seeds with NumPy; imports only NumPy and `ops`'
constants.

`numpy_sets` and `host_lengths` are the NumPy reference all three hold
the route's keys and lengths to: set operations on the keys themselves,
and the planner's last-leaf length rule, written apart from the port's
code.
"""

from __future__ import annotations

from functools import reduce

import numpy as np

from .ops import MAX_TILE_W, OP_AND as AND, OP_ANDNOT as ANDNOT, OP_OR as OR

TILE_BITS = 32 * MAX_TILE_W


def posting_keys(rng, n: int, high: bool = False) -> np.ndarray:
    """n distinct sorted uint64 posting keys (blob << 40 | offset); with
    `high`, blob keys just below 2**23, so keys just below 2**63."""
    blob = rng.integers(2**23 - 4 if high else 0, 2**23 if high else 16,
                        size=4 * n + 8, dtype=np.uint64)
    off = rng.integers(0, 2**40, size=blob.size, dtype=np.uint64)
    keys = np.unique((blob << np.uint64(40)) | off)
    return np.sort(rng.choice(keys, n, replace=False))


def subset(rng, keys: np.ndarray, frac: float) -> np.ndarray:
    return keys[rng.random(keys.size) < frac]


def edge_case(name: str) -> tuple[list, list | None, int | None]:
    """One case: rows of leaf key arrays, each row's program over its
    own slots (None: the L-way AND), and the identity universe's n_docs
    (None: uint64 posting keys, ranked into a universe)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "empty_leaf":
        u = posting_keys(rng, 3000)
        a, b = subset(rng, u, 0.5), subset(rng, u, 0.5)
        e = np.empty(0, np.uint64)
        return [[a, e], [a, b, e], [a, b]], \
            [[(AND, 0, 1)], [(OR, 0, 2), (ANDNOT, 3, 1)], [(OR, 0, 1)]], None
    if name.startswith("universe_"):
        n = int(name.split("_")[1])
        u = posting_keys(rng, n)
        rows = [[u, subset(rng, u, 0.6)], [subset(rng, u, 0.7),
                                            subset(rng, u, 0.7)]]
        return rows, [[(AND, 0, 1)], [(OR, 0, 1)]], None
    if name.startswith("identity_"):
        n = int(name.split("_")[1])
        ids = np.arange(n, dtype=np.uint32)
        rows = [[subset(rng, ids, 0.8), subset(rng, ids, 0.8),
                 subset(rng, ids, 0.9)]]
        return rows, None, n
    if name == "one_tile":
        # every posting of row 0 in tile 0, all bits set: each word's 32
        # lanes meet in one shared atomic; row 1 spreads over 9 tiles
        ids = np.arange(9 * TILE_BITS, dtype=np.uint64)
        dense = ids[:TILE_BITS]
        rows = [[dense, dense[::3]], [subset(rng, ids, 0.3), dense]]
        return rows, [[(AND, 0, 1)], [(ANDNOT, 0, 1)]], None
    if name == "sparse_tiles":
        ids = np.arange(12 * TILE_BITS, dtype=np.uint64)
        few = np.concatenate([ids[2 * TILE_BITS:2 * TILE_BITS + 40],
                              ids[7 * TILE_BITS + 5:7 * TILE_BITS + 9]])
        rows = [[few, few[::2]], [subset(rng, ids, 0.05), few]]
        return rows, [[(AND, 0, 1)], [(OR, 0, 1)]], None
    if name == "andnot_identity":
        u = posting_keys(rng, 5000)
        ls = [subset(rng, u, 0.5) for _ in range(3)]
        rows = [ls, ls, ls[:1], ls[:2], ls]
        progs = [[(ANDNOT, 0, 1)],
                 [(OR, 0, 1), (ANDNOT, 3, 2)],
                 [],                                  # single leaf
                 [(AND, 0, 1)],
                 [(AND, 0, 1), (OR, 3, 2), (ANDNOT, 4, 0)]]
        return rows, progs, None
    if name == "high_blob":
        u = posting_keys(rng, 4000, high=True)
        assert int(u[-1]) >= 2**62
        rows = [[subset(rng, u, 0.5), subset(rng, u, 0.5)],
                [subset(rng, u, 0.4), subset(rng, u, 0.9)]]
        return rows, [[(AND, 0, 1)], [(ANDNOT, 1, 0)]], None
    raise KeyError(name)


EDGE_CASES = ["empty_leaf", "universe_1", "universe_31", "universe_32",
              "universe_33", f"universe_{TILE_BITS - 1}",
              f"universe_{TILE_BITS + 1}", "identity_1", "identity_33",
              f"identity_{TILE_BITS + 1}", "one_tile", "sparse_tiles",
              "andnot_identity", "high_blob"]


def numpy_sets(rows: list, progs: list | None) -> list[np.ndarray]:
    """Each row's result by NumPy set operations on its uint64 keys:
    the AND of all its leaves (`progs` None), or its program's last
    slot (leaves first, then one slot per step)."""
    out = []
    for q, row in enumerate(rows):
        slots = [np.asarray(a).astype(np.uint64) for a in row]
        if progs is None:
            out.append(reduce(np.intersect1d, slots))
            continue
        for op, a, b in progs[q]:
            va, vb = slots[a], slots[b]
            slots.append(np.intersect1d(va, vb) if op == AND else
                         np.union1d(va, vb) if op == OR else
                         np.setdiff1d(va, vb))
        out.append(slots[-1])
    return out


def host_lengths(found: np.ndarray, row: list, lengths: list,
                 ) -> np.ndarray:
    """The planner's rule for a row's result keys `found`: each key's
    length from the last of the row's leaves that holds it, 0 if none
    does."""
    out = np.zeros(len(found), dtype=np.uint64)
    for keys, ln in zip(row, lengths):
        keys = np.asarray(keys, dtype=np.uint64)
        if len(keys):
            idx = np.clip(np.searchsorted(keys, found), 0, len(keys) - 1)
            hit = keys[idx] == found
            out[hit] = ln[idx[hit]]
    return out
