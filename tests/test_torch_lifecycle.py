"""The port's index lifecycle against the JAX package, on the CPU.

One scenario runs on each package in this process (so `PYTHONHASHSEED`
tie-breaks match), with `uuid.uuid4` — the stdlib function both
packages draw writer tokens from — patched to one deterministic
sequence, restarted for each side. The scenario builds an `Index`,
appends and commits a delta segment, adds a memory segment
(`MemorySegment`) and commits it, merges, and sweeps with
`collect_garbage` under a `LeaseRegistry` and with pinned clocks; it
also builds the `BTreeIndex` and `SkipListIndex` baselines. Every read
runs through a `SimCloudStore` with a fixed seed, so virtual-clock
latencies are exact. The two traces must agree key by key: blobs and
manifests byte for byte; `query_batch` under `impl="sorted"` and
`impl="bitmap"` in refs, texts and every `FetchStats` field; memory
segment results before and after `commit()`; leases; `GCReport`s; and
the baselines' results and stats. The JAX side runs its Pallas kernels
in interpret mode, the port its plain PyTorch versions
(`device="cpu"`).
"""

import dataclasses
import itertools
import sys
import threading
import uuid
from types import SimpleNamespace
from unittest import mock

import pytest
import torch

import repro.data as j_data
import repro.index as j_index
import repro.index.baselines as j_baselines
import repro.index.lifecycle as j_lifecycle
import repro.storage as j_storage
import repro_torch.data as t_data
import repro_torch.index as t_index
import repro_torch.index.baselines as t_baselines
import repro_torch.index.lifecycle as t_lifecycle
import repro_torch.storage as t_storage
from repro_torch.kernels.intersect import ops as t_ops

SIDES = {
    "j": SimpleNamespace(data=j_data, index=j_index, lc=j_lifecycle,
                         storage=j_storage, baselines=j_baselines, dev={}),
    "t": SimpleNamespace(data=t_data, index=t_index, lc=t_lifecycle,
                         storage=t_storage, baselines=t_baselines,
                         dev={"device": "cpu"}),
}
CFG = dict(B=1200, F0=1.0, hedge_layers=1, index_ngrams=3)
QUERIES = ["error", "info AND block", "error block node7",
           "warn OR node7", "error AND NOT block", "(warn OR info) AND block",
           '"received block"', "re:/blk_[0-9]+/"]
BASELINE_WORDS = ["error", "info", "block", "node7", "nosuchword"]


def uuid_sequence():
    """Patch `uuid.uuid4` with a fresh deterministic sequence whose hex
    prefix (what writer tokens take) differs call to call."""
    counter = itertools.count(1)
    return mock.patch.object(uuid, "uuid4",
                             lambda: uuid.UUID(int=next(counter) << 96))


def _blobs(store, prefix=""):
    return {name: store.get(name) for name in store.list(prefix)}


def _plain(results):
    return [([dataclasses.astuple(r) for r in res.refs], res.texts,
             dataclasses.asdict(res.stats)) for res in results]


def _all_impls(s, searcher, queries):
    out = {}
    for impl in ("sorted", "bitmap"):
        for top_k in (None, 4):
            out[f"{impl}/{top_k}"] = _plain(
                searcher.query_batch(queries, top_k=top_k, impl=impl))
    return out


def lifecycle_trace(s) -> dict:
    """The scenario on one package `s`; returns every observable."""
    trace: dict = {}
    store = s.storage.InMemoryBlobStore()
    docs = [s.data.make_logs_like(n, seed=seed)
            for n, seed in ((500, 21), (150, 22), (120, 23))]
    c1, c2, c3 = (s.data.write_corpus(store, f"corpus/{i}", d, n_blobs=2)
                  for i, d in enumerate(docs))
    cloud = s.storage.SimCloudTransport(s.storage.SimCloudStore(store,
                                                                seed=5))
    queries = [s.index.parse(q) for q in QUERIES]
    cfg = s.index.BuilderConfig(**CFG)
    with uuid_sequence():
        idx = s.index.Index.build(c1, cfg, cloud, "idx", **s.dev)
        trace["build"] = _blobs(store, "idx/")
        w = idx.writer()
        w.append(c2)
        w.commit()
        trace["commit"] = _blobs(store, "idx/")
        trace["manifest"] = idx.manifest
        reader = s.index.Index.open(cloud, "idx", **s.dev).searcher()
        trace["segmented"] = (type(reader).__name__, reader.n_units,
                              dataclasses.asdict(reader.init_stats))
        trace["query_batch"] = _all_impls(s, reader, queries)
        trace["query"] = [_plain([reader.query(q, top_k=3)])
                          for q in queries[:4]]
        trace["regex_query"] = _plain([reader.regex_query("blk_[0-9]+")])

        w = idx.writer()
        report = w.add(c3)
        seg = idx.memory_segments[0]
        trace["memory_segment"] = (
            report.n_docs, seg.prefix, seg.staged_bytes,
            {n: seg._staging.get(n) for n in seg.blob_names()},
            idx.nrt_seq)
        pre = _all_impls(s, idx.searcher(), queries)
        w.commit()
        post = _all_impls(s, idx.searcher(), queries)
        trace["memory_pre"] = pre
        trace["memory_post"] = post
        trace["memory_published"] = (_blobs(store, "idx/"), idx.generation,
                                     idx.nrt_seq)
        many = s.lc.open_many(cloud, ["idx", "idx"], [2, None], **s.dev)
        trace["open_many"] = [(h.generation, h.segment_prefixes)
                              for h in many]

        leases = s.index.LeaseRegistry()
        lease = leases.acquire("idx", 3)
        idx.writer().merge()
        gc = s.lc.collect_garbage(store, "idx", keep=1, grace_s=0.0,
                                  leases=leases)
        trace["gc_leased"] = (dataclasses.asdict(gc), leases.leased("idx"),
                              len(leases), leases.min_generation("idx"))
        lease.release()
        lease.release()                     # idempotent
        trace["gc_grace"] = dataclasses.asdict(s.lc.collect_garbage(
            store, "idx", keep=1, grace_s=600.0, dry_run=True, now=0.0))
        trace["gc"] = dataclasses.asdict(s.lc.collect_garbage(
            store, "idx", keep=1, grace_s=600.0, now=1e12))
        trace["reachable"] = sorted(s.lc.reachable_blobs(store, "idx",
                                                         keep=1))
        merged = s.index.Index.open(cloud, "idx", **s.dev).searcher()
        trace["merged"] = _all_impls(s, merged, queries)
        trace["final_blobs"] = _blobs(store)

    for cls in (s.baselines.BTreeIndex, s.baselines.SkipListIndex):
        tree = cls(store, f"baseline/{cls.kind}")
        header = tree.build(c1)
        opened = tree.open(s.storage.SimCloudStore(store, seed=9))
        trace[f"baseline_{cls.kind}"] = (
            header, _blobs(store, f"baseline/{cls.kind}/"),
            dataclasses.asdict(opened.init_stats),
            [_plain([opened.query(w, top_k=k)])
             for w in BASELINE_WORDS for k in (None, 3)])
    return trace


KEYS = ["build", "commit", "manifest", "segmented", "query_batch", "query",
        "regex_query", "memory_segment", "memory_pre", "memory_post",
        "memory_published", "open_many", "gc_leased", "gc_grace", "gc",
        "reachable", "merged", "final_blobs", "baseline_btree",
        "baseline_skiplist"]


@pytest.fixture(scope="module")
def traces():
    return {side: lifecycle_trace(s) for side, s in SIDES.items()}


@pytest.mark.parametrize("key", KEYS)
def test_lifecycle_matches_jax(traces, key):
    assert sorted(traces["j"]) == sorted(KEYS) == sorted(traces["t"])
    assert traces["t"][key] == traces["j"][key], key


def test_scenario_exercises_what_it_compares(traces):
    """The scenario is not vacuous: segments, memory units, GC deletes,
    grace, leases, results and the bitmap route all took effect."""
    t = traces["t"]
    assert t["segmented"][:2] == ("MultiSegmentSearcher", 2)
    assert any(seg for _r, seg, _s in t["query_batch"]["bitmap/None"])
    # memory reads cost no fetch, so only the stats differ
    assert {k: [r[:2] for r in v] for k, v in t["memory_pre"].items()} == \
        {k: [r[:2] for r in v] for k, v in t["memory_post"].items()}
    assert [r[:2] for r in t["query_batch"]["sorted/None"]] == \
        [r[:2] for r in t["query_batch"]["bitmap/None"]]
    assert t["gc_leased"][0]["n_reachable"] < t["gc_leased"][0][
        "n_candidates"] or t["gc_leased"][0]["deleted"] == []
    assert t["gc_leased"][1] == {3: 1}
    assert t["gc_grace"]["kept_grace"] and not t["gc_grace"]["deleted"]
    assert t["gc"]["deleted"] and t["gc"]["bytes_reclaimed"] > 0
    assert any(r[0][0] for r in t["baseline_btree"][3])


def test_memory_segment_units_combine_on_the_index_device():
    store = t_storage.InMemoryBlobStore()
    c1 = t_data.write_corpus(store, "c/1", t_data.make_logs_like(200, seed=4))
    c2 = t_data.write_corpus(store, "c/2", t_data.make_logs_like(150,
                                                                 seed=5))
    idx = t_index.Index.build(c1, t_index.BuilderConfig(**CFG), store,
                              "idx", device="cpu")
    idx.writer().add(c2)
    reader = idx.searcher()
    assert [u.device for u in reader.units] == [torch.device("cpu")] * 2
    assert isinstance(reader.units[1], t_index.MemorySegment)


def test_entry_points_raise_without_a_card(monkeypatch):
    """`device="cuda"`, the default, raises when there is no card: no
    silent fallback to the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = t_storage.InMemoryBlobStore()
    corpus = t_data.write_corpus(store, "c", t_data.make_logs_like(50,
                                                                   seed=1))
    cfg = t_index.BuilderConfig(B=600, F0=1.0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_index.Index.build(corpus, cfg, store, "idx")
    assert store.list("idx/") == []                  # raised before building
    t_index.Index.build(corpus, cfg, store, "idx", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_index.Index.open(store, "idx")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_lifecycle.open_many(t_storage.as_transport(store), ["idx"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_index.MemorySegment.build(corpus, cfg, store, "mem")


def test_launch_counts_are_exact_from_eight_threads():
    """`count_launch` takes a lock: 8 threads counting at once lose no
    launch (an unlocked `+= 1` can, when a thread switch falls between
    its read and its write)."""
    t_ops.reset_launches()
    n, per = 8, 20_000
    barrier = threading.Barrier(n)

    def work(i):
        barrier.wait()
        for _ in range(per):
            t_ops.count_launch("combine_cluster_keys", {"thread": i})

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)         # switch threads as often as it can
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert t_ops.LAUNCHES["combine_cluster_keys"] == n * per
    assert t_ops.LAST_SHAPE["combine_cluster_keys"]["thread"] in range(n)
    t_ops.reset_launches()
    assert not any(t_ops.LAUNCHES.values())
