"""The port's codec against msgpack and the JAX package's codec.

The port writes its index header through its own MessagePack subset
(`repro_torch.index._msgpack`); it must be byte-identical to
`msgpack.packb(..., use_bin_type=True)`, and read back what
`msgpack.unpackb(..., raw=False, strict_map_key=False)` reads. Varints,
superposts and bin pointers must match the JAX codec byte for byte.
"""

import msgpack
import numpy as np
import pytest

from repro.data import make_logs_like, write_corpus
from repro.index import Builder, BuilderConfig
from repro.index import codec as jcodec
from repro.storage import InMemoryBlobStore
from repro_torch.index import _msgpack
from repro_torch.index import codec as tcodec

INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
             2**63, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -2**31, -2**31 - 1, -2**63]


def _reference(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def _unpack_reference(data: bytes):
    return msgpack.unpackb(data, raw=False, strict_map_key=False)


@pytest.mark.parametrize("obj", [
    *INT_EDGES,
    None, True, False, 0.0, -1.5, 1e300, float("inf"), np.float64(0.25),
    "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65535, "f" * 65536,
    "ünï©ødé", b"", b"x" * 255, b"y" * 256, b"z" * 65535, b"w" * 65536,
    list(range(15)), list(range(16)), list(range(70000)), (1, 2),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {i: str(i) for i in range(70000)}, {1: [2, {3: b"4"}], "k": None},
], ids=lambda o: type(o).__name__)
def test_packb_is_byte_identical_to_msgpack(obj):
    data = _msgpack.packb(obj)
    assert data == _reference(obj)
    assert _msgpack.unpackb(data) == _unpack_reference(data)


def test_random_nested_payloads_round_trip():
    rng = np.random.default_rng(0)

    def value(depth):
        kind = int(rng.integers(0, 8 if depth < 3 else 5))
        if kind == 0:
            return INT_EDGES[int(rng.integers(0, len(INT_EDGES)))]
        if kind == 1:
            return float(rng.normal())
        if kind == 2:
            return "s" * int(rng.integers(0, 300))
        if kind == 3:
            return bytes(rng.integers(0, 256, int(rng.integers(0, 300)),
                                      dtype=np.uint8))
        if kind == 4:
            return [None, True, False][int(rng.integers(0, 3))]
        if kind == 5:
            return [value(depth + 1) for _ in range(int(rng.integers(0, 20)))]
        return {f"k{i}": value(depth + 1)
                for i in range(int(rng.integers(0, 20)))}

    for _ in range(50):
        obj = value(0)
        data = _msgpack.packb(obj)
        assert data == _reference(obj)
        assert _msgpack.unpackb(data) == _unpack_reference(data)


@pytest.mark.parametrize("obj", [np.int64(5), {1, 2}, object(), 2**64,
                                 -2**63 - 1])
def test_unsupported_values_raise_like_msgpack(obj):
    with pytest.raises((TypeError, OverflowError)):
        _reference(obj)
    with pytest.raises((TypeError, OverflowError)):
        _msgpack.packb(obj)


def test_truncated_and_trailing_data_are_refused():
    data = _msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError):
        _msgpack.unpackb(data[:-1])
    with pytest.raises(ValueError):
        _msgpack.unpackb(data + b"\x00")


@pytest.mark.parametrize("ngrams", [0, 3])
def test_built_headers_re_encode_byte_identically(ngrams):
    store = InMemoryBlobStore()
    corpus = write_corpus(store, "c", make_logs_like(600, seed=4), n_blobs=2)
    Builder(BuilderConfig(B=900, F0=1.0, index_ngrams=ngrams)).build(
        corpus, store, "i")
    hdr = store.get("i/header.airp")
    payload = jcodec.decode_header(hdr)
    assert tcodec.encode_header(payload) == hdr
    assert tcodec.decode_header(hdr) == payload


def test_varints_superposts_and_pointers_match_the_jax_codec():
    rng = np.random.default_rng(1)
    values = np.concatenate([rng.integers(0, 2**63, 200, dtype=np.uint64),
                             np.array([0, 127, 128, 2**64 - 1], np.uint64)])
    enc = tcodec.encode_varints(values)
    assert enc == jcodec.encode_varints(values)
    dec, used = tcodec.decode_varints(enc, len(values))
    assert used == len(enc) and (dec == values).all()

    keys = np.unique(rng.integers(0, 2**50, 300, dtype=np.uint64))
    lengths = rng.integers(1, 5000, len(keys), dtype=np.uint64)
    blob = tcodec.encode_superpost(keys, lengths)
    assert blob == jcodec.encode_superpost(keys, lengths)
    k, n = tcodec.decode_superpost(blob)
    assert (k == keys).all() and (n == lengths).all()

    ptrs = [tcodec.BinPointer(int(b), int(o), int(n)) for b, o, n in
            zip(rng.integers(0, 9, 50), rng.integers(0, 2**33, 50),
                rng.integers(0, 2**20, 50))]
    packed = tcodec.pack_pointers(ptrs)
    assert packed == jcodec.pack_pointers(
        [jcodec.BinPointer(p.block, p.offset, p.length) for p in ptrs])
    assert tcodec.unpack_pointers(packed) == ptrs


def test_posting_keys_match_the_jax_codec():
    blob = np.array([0, 1, 7, 2**20], dtype=np.int64)
    off = np.array([0, 5, 2**39, 12345], dtype=np.int64)
    keys = tcodec.posting_key(blob, off)
    assert (keys == jcodec.posting_key(blob, off)).all()
    for a, b in zip(tcodec.split_posting_key(keys),
                    jcodec.split_posting_key(keys)):
        assert (a == b).all()
