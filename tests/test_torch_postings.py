"""The port's route from posting keys to candidate keys, on the CPU.

`intersect_keys` and `combine_keys` take each row's sorted leaf key
lists, rank them into one universe (`rank_postings`), and evaluate the
L-way AND or the row's AND/OR/ANDNOT program over the ranks
(`combine_postings_ref`, then `bits_to_keys_ref`): the plain versions of
the CUDA kernels `combine_postings` and `bits_to_keys`. Here they are
held, exactly, to the JAX package's four Pallas kernels (interpret mode)
fed bitmaps built from the same ranks by the JAX package's own
`postings_to_bitmap_batch`: result words, counts and keys. The edge
cases (`kernels/intersect/cases.py`) are those `chip_smoke.py`'s
`edge` phase and the card tests hold the CUDA kernels to. A
hypothesis test holds `combine_planned(impl="bitmap")` to
`impl="sorted"` and to the JAX package's planner.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, assume, given, settings
from hypothesis import strategies as st

import repro.index.planner as j_planner
import repro.index.query as j_query
import repro_torch.index.planner as t_planner
import repro_torch.index.query as t_query
from repro.core.hashing import word_fingerprint
from repro.kernels import intersect as jx
from repro_torch.kernels import intersect as tx
from repro_torch.kernels.intersect import ops as txo
from repro_torch.kernels.intersect.cases import (EDGE_CASES, edge_case,
                                                 host_lengths, numpy_sets,
                                                 posting_keys, subset)

AND, OR, ANDNOT = tx.OP_AND, tx.OP_OR, tx.OP_ANDNOT


def _jax_inputs(rows, progs, n_docs):
    """Ranks by NumPy, bitmaps by the JAX package: (universe or None,
    n_bits, bitmaps (rows, L, W) zero-padded, programs (rows, S, 3)
    re-pointed at L or None for the AND route, and the AND route's
    all-ones-padded bitmaps)."""
    if n_docs is None:
        universe = np.unique(np.concatenate([a for r in rows for a in r]))
        ranked = [[np.searchsorted(universe, a).astype(np.uint32) for a in r]
                  for r in rows]
        n_bits = universe.size
    else:
        universe, n_bits = None, n_docs
        ranked = [[a.astype(np.uint32) for a in r] for r in rows]
    L = max(len(r) for r in rows)
    W = (n_bits + 31) // 32
    bm = np.zeros((len(rows), L, W), dtype=np.uint32)
    for q, r in enumerate(ranked):
        bm[q, :len(r)] = jx.postings_to_bitmap(r, n_bits)
    packed = None if progs is None else jx.pack_programs(
        [[(op, a if a < len(r) else a + L - len(r),
           b if b < len(r) else b + L - len(r)) for op, a, b in p]
         for r, p in zip(rows, progs)], L)
    return (universe, n_bits, bm, packed,
            jx.postings_to_bitmap_batch(ranked, n_bits))


def _keys_from_words(words, universe):
    bits = np.unpackbits(np.asarray(words, np.uint32).view(np.uint8),
                         bitorder="little")
    sel = np.flatnonzero(bits)
    return sel.astype(np.uint64) if universe is None else universe[sel]


def _port(rows, progs, n_docs):
    """The port's plain route, end to end and kernel by kernel."""
    keys, counts = (tx.intersect_keys(rows, n_docs=n_docs, device="cpu")
                    if progs is None else
                    tx.combine_keys(rows, progs, device="cpu"))
    words, tile_cnt, plain_keys, _ = txo.keys_plain(
        txo.plan_keys(rows, progs, n_docs, "cpu"))
    assert torch.equal(plain_keys, keys)
    assert torch.equal(tile_cnt.sum(1, dtype=torch.int64), counts)
    return keys, counts, tx.to_numpy(words), tile_cnt.numpy()


@pytest.mark.parametrize("case", EDGE_CASES)
def test_fused_plain_versions_match_jax_kernels(case):
    rows, progs, n_docs = edge_case(case)
    universe, n_bits, bm, packed, bm_ones = _jax_inputs(rows, progs, n_docs)
    keys, counts, words, tile_cnt = _port(rows, progs, n_docs)
    W = bm.shape[-1]
    assert not words[:, W:].any()            # tiles past the universe
    if progs is None:
        want = [jx.intersect_batch(bm_ones, impl="pallas")]
        if len(rows) == 1:
            want.append(tuple(np.asarray(x)[None] for x in
                              jx.intersect(bm_ones[0], impl="pallas")))
    else:
        want = [jx.combine_batch(bm, packed, impl="pallas")]
        G = 2 if len(rows) % 2 == 0 else 1
        out, cnt = jx.combine_cluster(
            bm.reshape(G, -1, *bm.shape[1:]),
            packed.reshape(G, -1, *packed.shape[1:]), impl="pallas")
        want.append((np.asarray(out).reshape(len(rows), W),
                     np.asarray(cnt).reshape(-1)))
        t_keys, t_cnt = tx.combine_keys(rows, progs, groups=G,
                                        device="cpu")
        assert torch.equal(t_keys, keys)
        assert t_cnt.shape == (G, len(rows) // G)
        assert (t_cnt.reshape(-1).numpy() == np.asarray(cnt).reshape(-1)).all()
    found = tx.keys_per_row(keys, counts)
    for out, cnt in want:
        out = np.asarray(out)
        assert (words[:, :W] == out).all()
        assert (counts.numpy() == np.asarray(cnt).astype(np.int64)).all()
        assert (tile_cnt.sum(1) == counts.numpy()).all()
        for q in range(len(rows)):
            assert (found[q] == _keys_from_words(out[q], universe)).all()


@pytest.mark.parametrize("case", EDGE_CASES)
def test_fused_route_matches_numpy_sets(case):
    """An independent NumPy set evaluation of each row."""
    rows, progs, n_docs = edge_case(case)
    keys, counts = (tx.intersect_keys(rows, n_docs=n_docs, device="cpu")
                    if progs is None else
                    tx.combine_keys(rows, progs, device="cpu"))
    for found, want in zip(tx.keys_per_row(keys, counts),
                           numpy_sets(rows, progs), strict=True):
        assert found.dtype == np.uint64
        assert (found == want).all()


def test_one_universe_for_all_rows_gives_per_row_sets():
    """A shared universe and a per-row universe give the same keys."""
    rng = np.random.default_rng(5)
    u = posting_keys(rng, 20_000)
    rows = [[subset(rng, u[:5000], 0.5), subset(rng, u[:5000], 0.5)],
            [subset(rng, u[10_000:], 0.3), subset(rng, u[10_000:], 0.9)]]
    together = tx.keys_per_row(*tx.intersect_keys(rows, device="cpu"))
    for row, got in zip(rows, together):
        alone = tx.keys_per_row(*tx.intersect_keys([row], device="cpu"))[0]
        assert (got == alone).all()


def test_shared_leaves_are_ranked_once():
    rng = np.random.default_rng(6)
    u = posting_keys(rng, 1000)
    a, b = subset(rng, u, 0.5), subset(rng, u, 0.5)
    ranked = tx.rank_postings([[a, b], [b, a], [a, a]], device="cpu")
    assert ranked.ranks.numel() == a.size + b.size
    assert ranked.bounds.shape == (3, 2, 2)
    assert torch.equal(ranked.bounds[0, 0], ranked.bounds[1, 1])
    assert torch.equal(ranked.universe,
                       torch.from_numpy(np.union1d(a, b).view(np.int64)))


@pytest.mark.parametrize("leaf,err", [
    (np.array([1, 2**63], dtype=np.uint64), r"\[0, 2\*\*63\)"),
    (np.array([2**64 - 1], dtype=np.uint64), r"\[0, 2\*\*63\)"),
    (np.array([-3, 4], dtype=np.int64), r"\[0, 2\*\*63\)"),
    (np.array([5, 3, 9], dtype=np.uint64), "must be sorted"),
    (np.array([3, 9, 9, 4], dtype=np.uint64), "must be sorted"),
])
def test_the_helper_refuses_bad_leaves(leaf, err):
    ok = np.array([0, 7], dtype=np.uint64)
    for call in (lambda: tx.rank_postings([[ok, leaf]], device="cpu"),
                 lambda: tx.intersect_keys([[ok], [ok, leaf]],
                                           device="cpu"),
                 lambda: tx.combine_keys([[leaf, ok]], [[(OR, 0, 1)]],
                                         device="cpu")):
        with pytest.raises(ValueError, match=err):
            call()


@pytest.mark.parametrize("n_docs", [None, 20])
def test_repeated_keys_count_once_with_their_first_length(n_docs):
    """A key that repeats in its leaf (a corpus that holds one document
    twice) is one result, as the bitmap route gives, with the length of
    its first place; the ranks stay unique within each leaf."""
    a = np.array([2, 5, 5, 5, 9, 11, 11], dtype=np.uint64)
    b = np.array([5, 9, 9, 11], dtype=np.uint64)
    la = np.array([1, 2, 3, 4, 5, 6, 7], dtype=np.uint64)
    lb = np.array([8, 9, 10, 11], dtype=np.uint64)
    ranked = tx.rank_postings([[a, b]], n_docs, device="cpu",
                              lengths=[[la, lb]])
    assert ranked.ranks.tolist() == ([0, 1, 2, 3, 1, 2, 3] if n_docs is None
                                     else [2, 5, 9, 11, 5, 9, 11])
    assert ranked.bounds.tolist() == [[[0, 4], [4, 7]]]
    assert ranked.lengths.tolist() == [1, 2, 5, 6, 8, 9, 11]
    keys, counts, key_len = tx.combine_keys(
        [[a, b], [a]], [[(OR, 0, 1)], []], device="cpu",
        lengths=[[la, lb], [la]])
    assert keys.tolist() == [2, 5, 9, 11, 2, 5, 9, 11]
    assert counts.tolist() == [4, 4]
    assert key_len.tolist() == [1, 8, 9, 11, 1, 2, 5, 6]
    keys, counts = tx.intersect_keys([[a, b], [a, a]], n_docs=n_docs,
                                     device="cpu")
    assert keys.tolist() == [5, 9, 11, 2, 5, 9, 11]


def test_leaves_that_straddle_each_other_are_not_unsorted():
    """Only pairs inside a leaf are checked, not across two leaves."""
    a = np.array([5, 9], dtype=np.uint64)
    b = np.array([1, 2], dtype=np.uint64)
    keys, counts = tx.combine_keys([[a, b]], [[(OR, 0, 1)]], device="cpu")
    assert keys.tolist() == [1, 2, 5, 9] and counts.tolist() == [4]


def test_the_helper_refuses_ids_past_n_docs_and_non_integers():
    with pytest.raises(ValueError, match="below n_docs=10"):
        tx.intersect_keys([[np.array([1, 10], np.uint32)]], n_docs=10,
                          device="cpu")
    with pytest.raises(ValueError, match="int32 ranks"):
        tx.intersect_keys([[np.array([1], np.uint64)]], n_docs=2**31,
                          device="cpu")
    plan = txo.plan_keys([[np.array([1, 3], np.uint64)]], None, None,
                         "cpu")
    with pytest.raises(ValueError, match="contiguous CUDA tensors"):
        txo.keys_kernels(plan)
    with pytest.raises(TypeError, match="integer"):
        tx.intersect_keys([[np.array([1.0, 2.0])]], device="cpu")
    with pytest.raises(ValueError, match="groups"):
        tx.combine_keys([[np.array([1], np.uint64)]] * 3, [[]] * 3,
                        groups=2, device="cpu")


def test_key_route_on_the_cpu_launches_nothing_and_empty_batches():
    tx.reset_launches()
    a = np.array([1, 4, 8], dtype=np.uint64)
    tx.intersect_keys([[a, a]], device="cpu")
    tx.intersect_keys([[a]], n_docs=9, device="cpu")
    tx.combine_keys([[a]], [[]], groups=1, device="cpu")
    assert set(tx.LAUNCHES.values()) == {0}
    keys, counts = tx.intersect_keys([], device="cpu")
    assert keys.numel() == 0 and counts.shape == (0,)
    assert tx.keys_per_row(keys, counts) == []
    assert t_planner.combine_planned([], [], _is_common, impl="bitmap",
                                     device="cpu") == []
    e = np.empty(0, np.uint64)
    keys, counts = tx.combine_keys([[e], [e, e]], [[], [(OR, 0, 1)]],
                                   device="cpu")
    assert keys.numel() == 0 and counts.tolist() == [0, 0]


@pytest.mark.parametrize("case", ["empty_leaf", "universe_33",
                                  "andnot_identity", "high_blob",
                                  "one_tile", "repeated_keys"])
def test_key_lengths_follow_the_last_leaf_holding_each_key(case):
    rows, progs, _ = edge_case(case)
    rng = np.random.default_rng(11)
    # lengths differ between leaves for the same key, so the rule shows
    lengths = [[rng.integers(1, 2**40, len(a), dtype=np.uint64)
                for a in row] for row in rows]
    keys, counts, key_len = tx.combine_keys(rows, progs, device="cpu",
                                            lengths=lengths)
    found = tx.keys_per_row(keys, counts)
    for q, got in enumerate(tx.keys_per_row(key_len, counts)):
        assert got.dtype == np.uint64
        assert (got == host_lengths(found[q], rows[q], lengths[q])).all()


def test_key_lengths_need_lengths_and_matching_sizes():
    a = np.array([1, 4, 8], dtype=np.uint64)
    with pytest.raises(ValueError, match="2 lengths for 3 keys"):
        tx.combine_keys([[a]], [[]], device="cpu",
                        lengths=[[np.array([1, 2], np.uint64)]])
    plan = txo.plan_keys([[a]], [[]], None, "cpu")
    with pytest.raises(ValueError, match="without lengths"):
        txo.key_lengths(plan.ranked, torch.tensor([1], dtype=torch.int32),
                        torch.tensor([1]))
    # one key array with two length arrays stays two leaves
    l1, l2 = np.array([5, 6, 7], np.uint64), np.array([9, 9, 9], np.uint64)
    ranked = tx.rank_postings([[a, a]], device="cpu", lengths=[[l1, l2]])
    assert ranked.ranks.numel() == 6
    _, _, got = tx.combine_keys([[a, a]], [[(OR, 0, 1)]], device="cpu",
                                lengths=[[l1, l2]])
    assert got.tolist() == [9, 9, 9]


@pytest.mark.parametrize("chunk", [1, 7, 1000, txo.KEY_CHUNK])
def test_key_lengths_in_chunks_equal_one_pass(chunk):
    """key_lengths takes the keys `chunk` at a time; a row's keys may
    straddle chunks, and every chunk size gives the host rule's lengths."""
    rows, progs, _ = edge_case("andnot_identity")
    rng = np.random.default_rng(12)
    lengths = [[rng.integers(1, 2**40, len(a), dtype=np.uint64)
                for a in row] for row in rows]
    plan = txo.plan_keys(rows, progs, None, "cpu", lengths)
    _w, tile_cnt, keys, key_ranks = txo.keys_plain(plan, ranks=True)
    counts = tile_cnt.sum(1, dtype=torch.int64)
    got = txo.key_lengths(plan.ranked, key_ranks, counts, chunk=chunk)
    found = tx.keys_per_row(keys, counts)
    for q, ln in enumerate(tx.keys_per_row(got, counts)):
        assert (ln == host_lengths(found[q], rows[q], lengths[q])).all()


@pytest.mark.parametrize("case", ["universe_33", "high_blob",
                                  "identity_33"])
def test_bits_to_keys_ranks_are_the_keys_places_in_the_universe(case):
    rows, progs, n_docs = edge_case(case)
    plan = txo.plan_keys(rows, progs, n_docs, "cpu")
    words, _c, keys, key_ranks = txo.keys_plain(plan, ranks=True)
    assert key_ranks.dtype == torch.int32
    assert torch.equal(tx.bits_to_keys_ref(words, plan.ranked.universe),
                       keys)
    universe = plan.ranked.universe
    want = keys if universe is None else torch.searchsorted(universe, keys)
    assert torch.equal(key_ranks.to(torch.int64), want)


def test_tiles_shrink_to_fit_long_programs_and_huge_ones_are_refused():
    assert txo.plan_tile(3, 2) == txo.MAX_TILE_W
    assert txo.plan_tile(40, 60) < txo.MAX_TILE_W
    with pytest.raises(ValueError, match="shared memory"):
        txo.plan_tile(1000, 1000)
    # a long OR chain over many leaves, at a smaller tile, on the CPU
    rng = np.random.default_rng(8)
    u = posting_keys(rng, 3000)
    row = [subset(rng, u, 0.01) for _ in range(40)]
    prog = [(OR, 0, 1)] + [(OR, 40 + s - 1, s + 1) for s in range(1, 39)]
    keys, counts = tx.combine_keys([row], [prog], device="cpu")
    assert (tx.keys_per_row(keys, counts)[0]
            == np.unique(np.concatenate(row))).all()


# ----------------------------------------------- the planner, hypothesis
WORDS = ["w0", "w1", "w2", "w3", "w4"]
COMMON = {"w3", "w4"}           # exact postings: ANDNOT-able


def _tree(strategy_words):
    leaf = st.one_of(
        strategy_words.map(lambda w: ("term", w)),
        st.lists(strategy_words, min_size=2, max_size=3).map(
            lambda ws: ("phrase", tuple(ws))))
    return st.recursive(leaf, lambda ch: st.one_of(
        st.lists(ch, min_size=2, max_size=3).map(lambda xs: ("and", xs)),
        st.lists(ch, min_size=2, max_size=3).map(lambda xs: ("or", xs)),
        ch.map(lambda x: ("not", x))), max_leaves=6)


def _build(mod, node):
    kind, arg = node
    if kind == "term":
        return mod.Term(arg)
    if kind == "phrase":
        return mod.Phrase(arg)
    if kind == "not":
        return mod.Not(_build(mod, arg))
    cls = mod.And if kind == "and" else mod.Or
    return cls(tuple(_build(mod, x) for x in arg))


class _Unit:
    common = {word_fingerprint(w) for w in COMMON}


def _is_common(w):
    return w in COMMON


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(trees=st.lists(_tree(st.sampled_from(WORDS)), min_size=1,
                      max_size=4),
       seed=st.integers(0, 2**32 - 1), sizes=st.lists(
           st.integers(0, 400), min_size=len(WORDS), max_size=len(WORDS)))
def test_combine_planned_bitmap_equals_sorted_and_jax(trees, seed, sizes):
    rng = np.random.default_rng(seed)
    u = posting_keys(rng, 500)
    per_word = {}
    for w, n in zip(WORDS, sizes):
        keys = np.sort(rng.choice(u, min(n, u.size), replace=False))
        per_word[w] = (keys, rng.integers(1, 900, keys.size,
                                          dtype=np.uint64))
    t_plans, j_plans = [], []
    for tree in trees:              # pure negations have no plan
        try:
            t_plans.append(t_planner.physical_plan(
                t_query.normalize(_build(t_query, tree)), (_Unit(),)))
        except t_planner.PureNegationError:
            continue
        j_plans.append(j_planner.physical_plan(
            j_query.normalize(_build(j_query, tree)), (_Unit(),)))
    assume(t_plans)
    trees = trees[:len(t_plans)]
    words = [dict(per_word) for _ in trees]
    bitmap = t_planner.combine_planned(t_plans, words, _is_common,
                                       impl="bitmap", device="cpu")
    plain = t_planner.combine_planned(t_plans, words, _is_common,
                                      impl="sorted")
    jax_bitmap = j_planner.combine_planned(j_plans, words, _is_common,
                                           impl="bitmap")
    for got, want, ref in zip(bitmap, plain, jax_bitmap):
        for a, b, c in zip(got, want, ref):
            assert a.dtype == np.uint64
            assert (a == b).all() and (a == c).all()
    clustered, counts = t_planner.combine_cluster_planned(
        [t_plans], [words], [_is_common], device="cpu")
    assert counts.dtype == np.int64 and counts.shape == (1, len(trees))
    for q, (got, want) in enumerate(zip(clustered[0], plain)):
        assert counts[0, q] == len(want[0])
        assert all((a == b).all() for a, b in zip(got, want))


@pytest.mark.parametrize("case", EDGE_CASES)
def test_key_route_entry_points_match_their_set_references(case):
    """`intersect_keys` and `combine_keys` (the plain route here) against
    `intersect_keys_ref` and `combine_keys_ref`, the same function by set
    operations on the leaf keys, with neither ranks nor bitmaps."""
    from repro_torch.kernels.intersect.ref import (combine_keys_ref,
                                                   intersect_keys_ref)
    rows, progs, n_docs = edge_case(case)
    if progs is None:
        got = tx.intersect_keys(rows, n_docs=n_docs, device="cpu")
        want = intersect_keys_ref(rows, n_docs)
    else:
        G = 2 if len(rows) % 2 == 0 else 1
        got = tx.combine_keys(rows, progs, groups=G, device="cpu")
        want = combine_keys_ref(rows, progs, groups=G)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), case
