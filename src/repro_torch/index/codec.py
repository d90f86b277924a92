"""Superpost compaction codec (paper §IV-C).

Two block kinds persist on cloud storage:

  * superpost blocks — serialized superposts back to back, so each bin is
    retrievable with a single range read given (block, offset, length);
  * one header block — hash seeds, bin-pointer dictionary, the string
    table that compresses repeated blob names to integer keys, common-word
    table, profile metadata.

Postings are (blob_key, offset, length) triples (paper §III-A), delta +
LEB128-varint encoded in sorted order. The paper uses Protocol Buffers;
offline we implement an equivalent compact encoding by hand — same role,
measurably smaller, zero dependencies. The header rides on MessagePack,
through the dependency-free subset in `_msgpack` (byte-identical to
`msgpack.packb(..., use_bin_type=True)` for every type a header holds).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import _msgpack

MAGIC = b"AIRP"
VERSION = 3


# --------------------------------------------------------------------- varint
def encode_varints(values: np.ndarray) -> bytes:
    """LEB128 encode a non-negative int64/uint64 array."""
    v = np.asarray(values, dtype=np.uint64)
    out = bytearray()
    for x in v:
        x = int(x)
        while True:
            b = x & 0x7F
            x >>= 7
            if x:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
    return bytes(out)


def decode_varints(data: bytes, count: int) -> tuple[np.ndarray, int]:
    """Decode `count` LEB128 varints; returns (values, bytes_consumed).

    Vectorized: value boundaries are the bytes with the continuation bit
    clear; each byte contributes its low 7 bits shifted by 7 × its position
    within the value, and `np.add.reduceat` sums the disjoint bit groups.
    This is the hot path of every superpost decode on the read path.
    """
    count = int(count)
    if count == 0:
        return np.empty(0, dtype=np.uint64), 0
    # a u64 varint is at most 10 bytes — never scan past what `count`
    # values could possibly occupy (decode_superpost passes whole tails)
    buf = np.frombuffer(data, dtype=np.uint8)[:count * 10]
    ends = np.flatnonzero((buf & 0x80) == 0)
    if len(ends) < count:
        raise ValueError(
            f"truncated varint stream: {len(ends)} values, need {count}")
    ends = ends[:count]
    consumed = int(ends[-1]) + 1
    buf = buf[:consumed]
    starts = np.empty(count, dtype=np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    byte_pos = np.arange(consumed, dtype=np.int64) \
        - np.repeat(starts, ends - starts + 1)
    contrib = (buf & np.uint8(0x7F)).astype(np.uint64) \
        << (np.uint64(7) * byte_pos.astype(np.uint64))
    return np.add.reduceat(contrib, starts), consumed


# ---------------------------------------------------------------- superposts
# A posting is (blob_key, offset, length) — paper §III-A. We pack identity
# into a single sortable u64 key: blob_key << OFFSET_BITS | offset. That
# keeps intersection a flat u64 merge and makes delta-varint encoding of a
# sorted superpost maximally compact (the paper's string-compression idea,
# taken one step further).
OFFSET_BITS = 40                      # supports 1 TB blobs
_OFFSET_MASK = (1 << OFFSET_BITS) - 1


def posting_key(blob_key: np.ndarray, offset: np.ndarray) -> np.ndarray:
    return (np.asarray(blob_key, dtype=np.uint64) << np.uint64(OFFSET_BITS)) \
        | np.asarray(offset, dtype=np.uint64)


def split_posting_key(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    keys = np.asarray(keys, dtype=np.uint64)
    return (keys >> np.uint64(OFFSET_BITS)).astype(np.int64), \
        (keys & np.uint64(_OFFSET_MASK)).astype(np.int64)


def encode_superpost(keys: np.ndarray, lengths: np.ndarray) -> bytes:
    """Serialize one superpost: count + delta(sorted keys) + lengths."""
    keys = np.asarray(keys, dtype=np.uint64)
    lengths = np.asarray(lengths, dtype=np.uint64)
    assert keys.shape == lengths.shape
    if keys.size:
        deltas = np.empty_like(keys)
        deltas[0] = keys[0]
        deltas[1:] = keys[1:] - keys[:-1]
    else:
        deltas = keys
    return (encode_varints(np.array([keys.size], dtype=np.uint64))
            + encode_varints(deltas) + encode_varints(lengths))


def decode_superpost(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Returns (sorted u64 posting keys, u64 lengths)."""
    view = memoryview(data)               # zero-copy section slicing
    (count,), pos = decode_varints(view, 1)
    count = int(count)
    deltas, used = decode_varints(view[pos:], count)
    pos += used
    lengths, _ = decode_varints(view[pos:], count)
    return np.cumsum(deltas).astype(np.uint64), lengths


# -------------------------------------------------------------------- header
@dataclass(frozen=True)
class BinPointer:
    """Locator of one superpost: (block id, byte offset, byte length)."""

    block: int
    offset: int
    length: int


def encode_header(payload: dict) -> bytes:
    return MAGIC + bytes([VERSION]) + _msgpack.packb(payload)


def decode_header(data: bytes) -> dict:
    if data[:4] != MAGIC:
        raise ValueError("not an Airphant index header")
    if data[4] != VERSION:
        raise ValueError(f"index version {data[4]} != supported {VERSION}")
    return _msgpack.unpackb(data[5:])


def pack_pointers(ptrs: list[BinPointer]) -> bytes:
    """Columnar varint encoding of the MHT bin-pointer dictionary."""
    blocks = np.array([p.block for p in ptrs], dtype=np.uint64)
    offs = np.array([p.offset for p in ptrs], dtype=np.uint64)
    lens = np.array([p.length for p in ptrs], dtype=np.uint64)
    head = encode_varints(np.array([len(ptrs)], dtype=np.uint64))
    return head + encode_varints(blocks) + encode_varints(offs) + \
        encode_varints(lens)


def unpack_pointers(data: bytes) -> list[BinPointer]:
    (count,), pos = decode_varints(data, 1)
    count = int(count)
    blocks, used = decode_varints(data[pos:], count)
    pos += used
    offs, used = decode_varints(data[pos:], count)
    pos += used
    lens, _ = decode_varints(data[pos:], count)
    return [BinPointer(int(b), int(o), int(n))
            for b, o, n in zip(blocks, offs, lens)]
