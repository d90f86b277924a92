"""The port's four intersect entry points against the JAX package's.

Same inputs (made with numpy from a seed) go through the JAX Pallas
kernels in interpret mode, the JAX refs, and the port's plain PyTorch
versions on the CPU (`device="cpu"`). Bitmaps and counts are integers:
every comparison is exact. The CUDA kernels themselves are held against
the plain versions on a card by `test_torch_cuda.py`.
"""

import numpy as np
import pytest
import torch

from repro.kernels import intersect as jx
from repro_torch.kernels import intersect as tx


def _random_postings(rng, L, n_docs):
    return [np.unique(rng.integers(0, n_docs, max(n_docs // 3, 2)))
            .astype(np.uint32) for _ in range(L)]


def _random_programs(rng, Q, L):
    """One random well-formed combine program per query."""
    progs = []
    for _ in range(Q):
        steps = []
        n_steps = int(rng.integers(0, L))
        for s in range(n_steps):
            op = int(rng.choice([tx.OP_AND, tx.OP_OR, tx.OP_ANDNOT]))
            hi = L + s        # slots written so far: leaves + prior steps
            a = L + s - 1 if s else int(rng.integers(0, hi))
            steps.append((op, a, int(rng.integers(0, hi))))
        progs.append(steps)
    return progs


def _bits(t):
    return tx.to_numpy(t)


def _same(port, *refs):
    """Port (bitmap, counts) equals each JAX (bitmap, counts), exactly."""
    out_p, cnt_p = port
    assert out_p.dtype == torch.int32 and cnt_p.dtype == torch.int64
    for out_r, cnt_r in refs:
        out_r, cnt_r = np.asarray(out_r), np.asarray(cnt_r)
        assert _bits(out_p).shape == out_r.shape
        assert (_bits(out_p) == out_r).all()
        assert cnt_p.shape == cnt_r.shape
        assert (cnt_p.numpy() == cnt_r.astype(np.int64)).all()


# ------------------------------------------------------------ parity (CPU)
@pytest.mark.parametrize("L,n_docs", [(1, 100), (3, 40_000), (4, 2048),
                                      (2, 1), (2, 31), (3, 33)])
def test_intersect_matches_jax(L, n_docs):
    rng = np.random.default_rng(L + n_docs)
    bm = jx.postings_to_bitmap(_random_postings(rng, L, n_docs), n_docs)
    _same(tx.intersect(bm, device="cpu"),
          jx.intersect(bm, impl="pallas"), jx.intersect_ref(bm))


@pytest.mark.parametrize("Q,L,n_docs", [(1, 2, 100), (5, 3, 33_000),
                                        (3, 1, 32), (4, 2, 65)])
def test_intersect_batch_matches_jax(Q, L, n_docs):
    rng = np.random.default_rng(Q * 7 + L)
    bm = jx.postings_to_bitmap_batch(
        [_random_postings(rng, L, n_docs) for _ in range(Q)], n_docs)
    _same(tx.intersect_batch(bm, device="cpu"),
          jx.intersect_batch(bm, impl="pallas"), jx.intersect_batch_ref(bm))


def test_intersect_batch_ragged_all_ones_padding():
    """Ragged L: the helper pads with all-ones layers, the AND identity."""
    rng = np.random.default_rng(3)
    batch = [_random_postings(rng, L, 500) for L in (1, 3, 2)]
    bm = tx.postings_to_bitmap_batch(batch, 500)
    assert (bm == jx.postings_to_bitmap_batch(batch, 500)).all()
    out, cnt = tx.intersect_batch(bm, device="cpu")
    for q, posts in enumerate(batch):
        single, c = tx.intersect(tx.postings_to_bitmap(posts, 500),
                                 device="cpu")
        assert (_bits(out[q]) == _bits(single)).all()
        assert int(cnt[q]) == int(c)


@pytest.mark.parametrize("Q,L,n_docs", [(4, 3, 5000), (7, 4, 40_000),
                                        (2, 1, 1), (3, 2, 100)])
def test_combine_batch_matches_jax(Q, L, n_docs):
    rng = np.random.default_rng(Q * 13 + L)
    bm = jx.postings_to_bitmap_batch(
        [_random_postings(rng, L, n_docs) for _ in range(Q)], n_docs)
    progs = _random_programs(rng, Q, L)
    packed = tx.pack_programs(progs, L)
    assert (packed == jx.pack_programs(progs, L)).all()
    _same(tx.combine_batch(bm, packed, device="cpu"),
          jx.combine_batch(bm, packed, impl="pallas"),
          jx.combine_batch_ref(bm, packed))


def test_combine_batch_andnot_and_identity_padding():
    """Hand-written programs: ANDNOT, OR, and chained-identity padding."""
    rng = np.random.default_rng(17)
    L, n_docs = 3, 3000
    bm = jx.postings_to_bitmap_batch(
        [_random_postings(rng, L, n_docs) for _ in range(4)], n_docs)
    progs = [[(tx.OP_ANDNOT, 0, 1)],
             [(tx.OP_OR, 0, 1), (tx.OP_ANDNOT, 3, 2)],
             [],
             [(tx.OP_AND, 0, 1), (tx.OP_OR, 3, 2), (tx.OP_ANDNOT, 4, 0)]]
    packed = tx.pack_programs(progs, L)
    assert packed.shape == (4, 3, 3)
    out, cnt = tx.combine_batch(bm, packed, device="cpu")
    _same((out, cnt), jx.combine_batch(bm, packed, impl="pallas"))
    b = bm.astype(np.uint64)
    expect = [b[0, 0] & ~b[0, 1], (b[1, 0] | b[1, 1]) & ~b[1, 2], b[2, 0],
              ((b[3, 0] & b[3, 1]) | b[3, 2]) & ~b[3, 0]]
    for q in range(4):
        assert (_bits(out[q]) == (expect[q] & 0xFFFFFFFF)).all()


@pytest.mark.parametrize("G,Q,L,n_docs", [(3, 4, 3, 5000), (8, 2, 2, 2048),
                                          (1, 1, 1, 31), (2, 3, 2, 100),
                                          (3, 5, 4, 40_000)])
def test_combine_cluster_matches_jax(G, Q, L, n_docs):
    rng = np.random.default_rng(G * 100 + Q * 10 + L)
    bm = np.stack([jx.postings_to_bitmap_batch(
        [_random_postings(rng, L, n_docs) for _ in range(Q)], n_docs)
        for _ in range(G)])
    progs = [_random_programs(rng, Q, L) for _ in range(G)]
    packed = tx.pack_cluster_programs(progs, L)
    assert (packed == jx.pack_cluster_programs(progs, L)).all()
    port = tx.combine_cluster(bm, packed, device="cpu")
    _same(port, jx.combine_cluster(bm, packed, impl="pallas"),
          jx.combine_cluster_ref(bm, packed))
    for g in range(G):           # the G=1 case is combine_batch
        _same(tx.combine_batch(bm[g], tx.pack_programs(progs[g], L),
                               device="cpu"), (_bits(port[0][g]), port[1][g].numpy()))


def test_zero_step_programs_yield_the_last_layer():
    rng = np.random.default_rng(23)
    bm = jx.postings_to_bitmap_batch(
        [_random_postings(rng, 3, 300) for _ in range(4)], 300)
    empty = np.zeros((4, 0, 3), dtype=np.int32)
    _same(tx.combine_batch(bm, empty, device="cpu"),
          jx.combine_batch_ref(bm, empty))
    _same(tx.combine_cluster(bm[None], empty[None], device="cpu"),
          jx.combine_cluster_ref(bm[None], empty[None]))


# ---------------------------------------------------- helpers + contracts
def test_host_helpers_match_jax():
    rng = np.random.default_rng(0)
    posts = _random_postings(rng, 3, 777)
    bm = tx.postings_to_bitmap(posts, 777)
    assert (bm == jx.postings_to_bitmap(posts, 777)).all()
    assert (tx.bitmap_to_docs(bm[0]) == jx.bitmap_to_docs(bm[0])).all()
    assert (tx.bitmap_to_docs(bm[0]) == posts[0]).all()


def test_popcount_matches_jax():
    words = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x55555555, 12345678],
                     dtype=np.uint32)
    got = tx.popcount(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int64
    assert (got.numpy() == np.asarray(jx.popcount(words))).all()


def test_uint32_tensors_and_numpy_give_the_same_bits():
    rng = np.random.default_rng(9)
    bm = jx.postings_to_bitmap(_random_postings(rng, 3, 4000), 4000)
    a = tx.intersect(bm, device="cpu")
    b = tx.intersect(torch.from_numpy(bm.view(np.int32)), device="cpu")
    c = tx.intersect(torch.from_numpy(bm.view(np.int32)).view(torch.uint32),
                     device="cpu")
    for out, cnt in (b, c):
        assert (_bits(out) == _bits(a[0])).all() and int(cnt) == int(a[1])


def test_cpu_tensors_take_the_plain_version_without_launching():
    tx.reset_launches()
    bm = np.full((2, 3, 4), 0xFFFFFFFF, dtype=np.uint32)
    tx.intersect_batch(bm, device="cpu")
    tx.combine_batch(bm, tx.pack_programs([[], []], 3), device="cpu")
    tx.intersect_batch(bm, impl="ref", device="cpu")
    assert set(tx.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("programs,err", [
    ([[(0, 0, 3)]], "has not written"),     # reads slot L before step 0
    ([[(0, -1, 0)]], "has not written"),
    ([[(5, 0, 1)]], "opcodes"),
])
def test_bad_programs_are_refused(programs, err):
    bm = np.zeros((1, 3, 2), dtype=np.uint32)
    with pytest.raises(ValueError, match=err):
        tx.combine_batch(bm, np.asarray(programs, dtype=np.int32),
                         device="cpu")


def test_bad_inputs_are_refused():
    with pytest.raises(ValueError, match="3-D"):
        tx.intersect_batch(np.zeros((2, 3), np.uint32), device="cpu")
    with pytest.raises(TypeError, match="int32 or uint32"):
        tx.intersect(torch.zeros((2, 3), dtype=torch.float32), device="cpu")
    with pytest.raises(ValueError, match="at least one layer"):
        tx.intersect(np.zeros((0, 3), np.uint32), device="cpu")
    with pytest.raises(ValueError, match="impl"):
        tx.intersect(np.zeros((1, 3), np.uint32), impl="pallas",
                     device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less path")
    bm = np.zeros((2, 4), dtype=np.uint32)
    for call in (lambda: tx.intersect(bm),
                 lambda: tx.intersect_batch(bm[None]),
                 lambda: tx.combine_batch(bm[None], [[(0, 0, 1)]]),
                 lambda: tx.combine_cluster(bm[None, None],
                                            [[[(0, 0, 1)]]])):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


# each library's CUDA sources, built into one shared library
SOURCES = {"intersect": ["intersect.cu"],
           "attention": ["attention.cu", "attention_bwd.cu",
                         "decode_int8.cu"]}


@pytest.mark.parametrize("package", ["intersect", "attention"])
def test_kernel_build_needs_nvcc_and_reuses_a_built_library(tmp_path,
                                                            monkeypatch,
                                                            package):
    import importlib

    from repro_torch.kernels import _build
    library = importlib.import_module(f"repro_torch.kernels.{package}").LIBRARY
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        library.build()
    built = library.library_path()
    assert built.parent == tmp_path and built.name.startswith(f"lib{package}-")
    assert [p.name for p in library.sources()] == SOURCES[package]
    built.write_bytes(b"")          # same sources and flags: no rebuild
    assert library.build() == built
    assert library.build_info["seconds"] == 0.0
