"""The port's CUDA kernels on a card, against their plain versions.

Marked `cuda`: they skip without a card (the kernels have no CPU mode)
and run on one with `python -m pytest -m cuda tests/test_torch_cuda.py`.
Only the port, torch and numpy are imported, so they run where JAX is
not installed. Every comparison is exact (integer bitmaps and counts).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import intersect as tx

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _random_programs(rng, Q, L):
    progs = []
    for _ in range(Q):
        steps = []
        for s in range(int(rng.integers(0, L + 2))):
            op = int(rng.integers(0, 3))
            a = L + s - 1 if s else int(rng.integers(0, L))
            steps.append((op, a, int(rng.integers(0, L + s))))
        progs.append(steps)
    return progs


def _numpy_combine(bm, progs, L):
    """Independent NumPy evaluation of one (L, W) query's program."""
    slots = [bm[l] for l in range(L)]
    for op, a, b in progs:
        va, vb = slots[a], slots[b]
        slots.append(va & vb if op == 0 else va | vb if op == 1
                     else va & ~vb)
    return slots[-1]


@pytest.mark.parametrize("G,Q,L,W", [(1, 1, 1, 1), (1, 3, 2, 31),
                                     (2, 4, 3, 257), (4, 5, 4, 1250),
                                     (3, 2, 6, 40_000)])
def test_kernels_match_plain_on_card(card, G, Q, L, W):
    rng = np.random.default_rng(G * 1000 + Q * 10 + L)
    bm = rng.integers(0, 2**32, size=(G, Q, L, W), dtype=np.uint32)
    progs = [_random_programs(rng, Q, L) for _ in range(G)]
    packed = tx.pack_cluster_programs(progs, L)
    tx.reset_launches()
    pairs = {}
    for name, args in (("intersect", (bm[0, 0],)),
                       ("intersect_batch", (bm[0],)),
                       ("combine_batch", (bm[0], packed[0])),
                       ("combine_cluster", (bm, packed))):
        fn = getattr(tx, name)
        pairs[name] = (fn(*args, device=card),
                       fn(*args, impl="ref", device=card))
    torch.cuda.synchronize()
    for (out_k, cnt_k), (out_r, cnt_r) in pairs.values():
        assert out_k.is_cuda and torch.equal(out_k, out_r)
        assert torch.equal(cnt_k, cnt_r)
    assert set(tx.LAUNCHES.values()) == {1}
    out = tx.to_numpy(pairs["combine_cluster"][0][0])
    for g in range(G):
        for q in range(Q):
            prog = [tuple(r) for r in packed[g, q]]
            assert (out[g, q] == _numpy_combine(bm[g, q], prog, L)).all()
    want = np.bitwise_and.reduce(bm[0], axis=1)
    assert (tx.to_numpy(pairs["intersect_batch"][0][0]) == want).all()


def test_programs_over_the_cap_are_refused(card):
    L = 2
    steps = [(tx.OP_AND, 0, 1)] + [(tx.OP_AND, L + s, L + s)
                                   for s in range(200)]
    packed = tx.pack_programs([steps], L)
    bm = np.zeros((1, L, 8), dtype=np.uint32)
    with pytest.raises(ValueError, match="cap"):
        tx.combine_batch(bm, packed, device=card)
    out, _ = tx.combine_batch(bm, packed, impl="ref", device=card)
    assert out.shape == (1, 8)


def test_searcher_on_card_matches_cpu(card):
    from repro_torch import Builder, BuilderConfig, Searcher, parse
    from repro_torch.data import make_logs_like, write_corpus
    from repro_torch.storage import (InMemoryBlobStore, SimCloudStore,
                                     SimCloudTransport)

    store = InMemoryBlobStore()
    corpus = write_corpus(store, "c", make_logs_like(3000, seed=1),
                          n_blobs=3)
    Builder(BuilderConfig(B=2500, F0=1.0)).build(corpus, store, "idx")
    queries = [parse(t) for t in (
        "info AND blk_12", "warn AND node7 AND exception", '"block blk_3"',
        "(error OR warn) AND NOT info", "info AND NOT block")]
    results = {}
    tx.reset_launches()
    for dev in (card, "cpu"):
        s = Searcher(SimCloudTransport(SimCloudStore(store, seed=3)), "idx",
                     device=dev)
        results[str(dev)] = s.query_batch(queries, top_k=5)
    assert tx.LAUNCHES["intersect_batch"] == 1
    assert tx.LAUNCHES["combine_batch"] == 1
    a, b = results.values()
    assert [(r.refs, r.texts, r.stats) for r in a] == \
        [(r.refs, r.texts, r.stats) for r in b]
