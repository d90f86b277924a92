"""The port's index path against the JAX package, end to end, on the CPU.

For logs-, cranfield- and zipf-shaped corpora, with and without
`index_ngrams=3`, both packages build the same corpus in this process
(so `PYTHONHASHSEED` tie-breaks match) and must agree exactly: the
built blobs byte for byte; `query_batch` under `impl="sorted"` and
`impl="bitmap"` in refs, texts and every `FetchStats` field, including
the virtual-clock latencies of a `SimCloudStore` with the same seed;
`IoUSketch.query(impl="bitmap")`; `combine_cluster_planned`; and an
index built by either package opened by the other. The JAX side runs
its Pallas kernels in interpret mode, the port its plain PyTorch
versions (`device="cpu"`).
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.sketch as j_sketch
import repro.data as j_data
import repro.index as j_index
import repro.index.planner as j_planner
import repro.index.searcher as j_searcher
import repro.storage as j_storage
import repro_torch.core.sketch as t_sketch
import repro_torch.data as t_data
import repro_torch.index as t_index
import repro_torch.index.planner as t_planner
import repro_torch.index.searcher as t_searcher
import repro_torch.storage as t_storage
from repro.core.hashing import word_fingerprint

CORPORA = {
    "logs": lambda m: m.make_logs_like(1200, seed=3),
    "cranfield": lambda m: m.make_cranfield_like(250, vocab=1500, seed=1),
    "zipf": lambda m: m.make_zipf(1200, 600, 10, seed=2),
}
B = {"logs": 1500, "cranfield": 3000, "zipf": 1500}
B_NGRAMS = {"logs": 1500, "cranfield": 9000, "zipf": 1500}


def _query_texts(docs: list[str], ngrams: int, seed: int) -> list[str]:
    """Terms, ANDs, ORs, NOTs, phrases, nesting (+ regex with n-grams),
    drawn from the corpus so most queries have answers."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(6):
        words = j_data.parse_words(docs[int(rng.integers(len(docs)))])
        w = [words[int(i)] for i in rng.integers(0, len(words), 4)]
        i = int(rng.integers(0, len(words) - 1))
        out += [w[0], f"{w[0]} AND {w[1]}", f"{w[0]} {w[1]} {w[2]}",
                f"{w[1]} OR {w[3]}", f"{w[0]} AND NOT {w[3]}",
                f'"{words[i]} {words[i + 1]}"',
                f"({w[2]} OR {w[3]}) AND {w[0]}"]
        if ngrams:
            lit = next((x for x in words if len(x) >= 4 and x.isalnum()),
                       None)
            if lit:
                out.append(f"re:/{lit[:4]}[a-z0-9]*/")
    return out


@pytest.fixture(scope="module", params=[(c, n) for c in CORPORA
                                        for n in (0, 3)],
                ids=lambda p: f"{p[0]}-ngrams{p[1]}")
def built(request):
    """Both packages build the same corpus into their own stores."""
    name, ngrams = request.param
    docs = CORPORA[name](j_data)
    assert docs == CORPORA[name](t_data)
    cfg = dict(B=(B_NGRAMS if ngrams else B)[name], F0=1.0,
               index_ngrams=ngrams)
    out = {"docs": docs, "ngrams": ngrams, "name": name}
    for side, data, index, storage in (("j", j_data, j_index, j_storage),
                                       ("t", t_data, t_index, t_storage)):
        store = storage.InMemoryBlobStore()
        corpus = data.write_corpus(store, "corpus", docs, n_blobs=3)
        index.Builder(index.BuilderConfig(**cfg)).build(corpus, store, "idx")
        out[side] = store
    return out


def _sim(storage, store):
    return storage.SimCloudTransport(storage.SimCloudStore(store, seed=7))


def _plain(results):
    return [([dataclasses.astuple(r) for r in res.refs], res.texts,
             dataclasses.asdict(res.stats)) for res in results]


def _run_both(j_store, t_store, texts, **kw):
    js = j_index.Searcher(_sim(j_storage, j_store), "idx")
    ts = t_index.Searcher(_sim(t_storage, t_store), "idx", device="cpu")
    jq = [j_index.parse(t) for t in texts]
    tq = [t_index.parse(t) for t in texts]
    out = []
    for impl in ("sorted", "bitmap"):
        a = _plain(js.query_batch(jq, impl=impl, **kw))
        b = _plain(ts.query_batch(tq, impl=impl, **kw))
        out.append((a, b))
    return out


def test_builds_are_blob_for_blob_identical(built):
    j, t = built["j"], built["t"]
    assert j.list("") == t.list("")
    for name in j.list(""):
        assert j.get(name) == t.get(name), name


@pytest.mark.parametrize("top_k", [None, 5])
def test_query_batch_matches_jax_with_virtual_clock(built, top_k):
    texts = _query_texts(built["docs"], built["ngrams"], seed=11)
    runs = _run_both(built["j"], built["t"], texts, top_k=top_k)
    for a, b in runs:
        assert a == b
    sorted_run, bitmap_run = runs
    # sorted and bitmap combines agree on results (only clocks move on)
    assert [r[:2] for r in sorted_run[1]] == [r[:2] for r in bitmap_run[1]]
    assert any(r[0] for r in sorted_run[1])      # the queries find things


def test_carried_state_opens_both_ways(built):
    """Each package's blobs, copied into the other's store, answer as
    the other package's own build does."""
    texts = _query_texts(built["docs"], built["ngrams"], seed=5)
    j_items = [(n, built["j"].get(n)) for n in built["j"].list("")]
    t_from_j = t_storage.from_items(j_items)
    j_from_t = j_storage.InMemoryBlobStore()
    for name in built["t"].list(""):
        j_from_t.put(name, built["t"].get(name))
    for a, b in _run_both(built["j"], t_from_j, texts, top_k=4):
        assert a == b
    for a, b in _run_both(j_from_t, built["t"], texts, top_k=4):
        assert a == b


def test_sketch_bitmap_query_matches_jax(built):
    docs = built["docs"]
    _, j_posts = j_index.Builder().profile(j_data.write_corpus(
        j_storage.InMemoryBlobStore(), "c", docs))
    _, t_posts = t_index.Builder().profile(t_data.write_corpus(
        t_storage.InMemoryBlobStore(), "c", docs))
    assert list(j_posts) == list(t_posts)
    common = list(j_posts)[:3]
    js = j_sketch.IoUSketch.build(j_posts, j_sketch.SketchSpec(
        B=600, L=3, n_common=3, seed=4), common_words=common)
    ts = t_sketch.IoUSketch.build(t_posts, t_sketch.SketchSpec(
        B=600, L=3, n_common=3, seed=4), common_words=common)
    rng = np.random.default_rng(0)
    words = list(j_posts)
    for w in [common[0]] + [words[int(i)] for i in
                            rng.integers(0, len(words), 6)]:
        expect = js.query(w, impl="bitmap", n_docs=len(docs))
        got = ts.query(w, impl="bitmap", n_docs=len(docs), device="cpu")
        assert (got == expect).all()
        assert (got == ts.query(w, impl="sorted")).all()
        assert (ts.query(w, impl="bitmap", wait_for=2, device="cpu")
                == js.query(w, impl="bitmap", wait_for=2)).all()


def _planned(searcher_mod, planner_mod, searcher, queries):
    jobs = [j for j in planner_mod.plan_batch(queries, units=(searcher,))
            if j.plan is not None]
    outs, _stats = searcher_mod.lookup_units(
        [searcher], [j.lookup_q for j in jobs], searcher._fetcher)
    return [j.plan for j in jobs], outs[0]


def test_combine_cluster_planned_matches_jax(built):
    texts = [t for t in _query_texts(built["docs"], built["ngrams"], seed=3)
             if " OR " in t or " NOT " in t or '"' in t or "re:" in t]
    js = j_index.Searcher(j_storage.as_transport(built["j"]), "idx")
    ts = t_index.Searcher(t_storage.as_transport(built["t"]), "idx",
                          device="cpu")
    j_plans, j_words = _planned(j_searcher, j_planner, js,
                                [j_index.parse(t) for t in texts])
    t_plans, t_words = _planned(t_searcher, t_planner, ts,
                                [t_index.parse(t) for t in texts])
    G = 3
    Q = len(t_plans) // G
    assert Q >= 2

    def common(unit):
        return lambda w: word_fingerprint(w) in unit.common

    j_res, j_cnt = j_planner.combine_cluster_planned(
        [j_plans[g * Q:(g + 1) * Q] for g in range(G)],
        [j_words[g * Q:(g + 1) * Q] for g in range(G)], [common(js)] * G)
    t_res, t_cnt = t_planner.combine_cluster_planned(
        [t_plans[g * Q:(g + 1) * Q] for g in range(G)],
        [t_words[g * Q:(g + 1) * Q] for g in range(G)], [common(ts)] * G,
        device="cpu")
    assert t_cnt.dtype == np.int64 and (t_cnt == j_cnt).all()
    for g in range(G):
        per_group = t_planner.combine_planned(
            t_plans[g * Q:(g + 1) * Q], t_words[g * Q:(g + 1) * Q],
            common(ts), impl="sorted")
        for q in range(Q):
            for got, jax_res, plain in zip(t_res[g][q], j_res[g][q],
                                           per_group[q]):
                assert (got == jax_res).all() and (got == plain).all()
            assert t_cnt[g, q] == len(t_res[g][q][0])


def test_default_searcher_needs_a_card(built):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less path")
    transport = t_storage.as_transport(built["t"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_index.Searcher(transport, "idx")
    s = t_index.Searcher(transport, "idx", device="cpu")
    assert s.device == torch.device("cpu")
