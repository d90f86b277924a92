"""The port's cluster management and cluster GC against the JAX package,
on the CPU.

Every scenario of `tests/test_resharding_gc.py` (cutover with continuous
serving, empty shards, split and merge in alias and rebuild mode,
routing, the four fault-injection stores, append with its stale-handle
and retry cases and into an aliased shard, the racing publishers, GC
after resharding on an in-memory and an on-disk store, keep-K and the
grace window, GC during the alias window and across a shared alias
source) and the cluster-lease GC cases of `tests/test_nrt.py` runs once
on each package in this process (so `PYTHONHASHSEED` tie-breaks match),
with `uuid.uuid4` patched to one deterministic sequence restarted per
side (staging prefixes and writer tokens draw from it). The two traces
must agree key by key, one parametrised test a key: blobs and cluster
manifests byte for byte, `GCReport`s (`now=` pinned), the step and the
message at which `ClusterConflict` (or the injected crash) is raised,
and results in refs, texts and fetch counts under `impl="sorted"` and
`impl="bitmap"` per shard and on the fused path under both budgets. The
JAX side runs its Pallas kernels in interpret mode, the port its plain
PyTorch versions (`device="cpu"`).

Each side is also held to its own unsharded index over the same corpus,
scenario by scenario; and a hypothesis machine draws random membership
histories (append, commit, alias reshard, split, merge, replicate,
compact, refresh, GC) that both packages run, equal step by step and
equal to their own oracle after every step.
"""

import dataclasses
import itertools
import os
import tempfile
import time
import uuid
import warnings
from types import SimpleNamespace
from unittest import mock

import pytest
from _hypothesis_compat import given, settings, st

import repro.compat as j_compat
import repro.data as j_data
import repro.index as j_index
import repro.serving as j_serving
import repro.serving.cluster as j_cluster
import repro.storage as j_storage
import repro_torch.compat as t_compat
import repro_torch.data as t_data
import repro_torch.index as t_index
import repro_torch.serving as t_serving
import repro_torch.serving.cluster as t_cluster
import repro_torch.storage as t_storage

SIDES = {
    "j": SimpleNamespace(data=j_data, index=j_index, serving=j_serving,
                         cluster=j_cluster, storage=j_storage,
                         compat=j_compat, dev={}),
    "t": SimpleNamespace(data=t_data, index=t_index, serving=t_serving,
                         cluster=t_cluster, storage=t_storage,
                         compat=t_compat, dev={"device": "cpu"}),
}
CFG = dict(B=1200, F0=1.0, index_ngrams=3)
NRT_CFG = dict(B=1200, F0=1.0, hedge_layers=1, index_ngrams=3)
BUDGET_QUERIES = ["error", "warn"]
# a sweep "now" far past every blob's mtime, so grace windows never spare
NOW = 4.0e9


def uuid_sequence():
    counter = itertools.count(1)
    return mock.patch.object(uuid, "uuid4",
                             lambda: uuid.UUID(int=next(counter) << 96))


def _queries(s):
    return ["error", "info", "warn", s.index.Regex(r"blk_1[0-9]2\b")]


def _blobs(store, prefix=""):
    return {name: store.get(name) for name in store.list(prefix)}


def _counts(st_):
    return (st_.n_candidates, st_.n_false_positives, st_.n_results,
            st_.rounds, st_.lookup.bytes_fetched, st_.lookup.n_requests,
            st_.docs.bytes_fetched, st_.docs.n_requests)


def _res(results):
    """Results as plain data: refs, texts and the fetch counts (the
    elapsed fields are wall clock over a bare store)."""
    return [([dataclasses.astuple(r) for r in res.refs], res.texts,
             _counts(res.stats)) for res in results]


def _flat(res):
    return [r[:2] for r in res]


def _error(exc):
    return (type(exc).__name__, str(exc))


def _gc(report):
    return dataclasses.asdict(report)


class Rec:
    """One side's trace of one scenario: `rec[key] = value` for what the
    two packages must agree on, `rec.agree(...)` for what one side must
    agree with its own unsharded index."""

    def __init__(self, s):
        self.s = s
        self.q = _queries(s)
        self.trace: dict = {}
        self.oracle: list = []

    def __setitem__(self, key, value):
        assert key not in self.trace, key
        self.trace[key] = value

    def __getitem__(self, key):
        return self.trace[key]

    def agree(self, label, got, want):
        self.oracle.append((label, got, want))

    def fixture(self, store, n_docs=700, n_shards=4, n_slots=None,
                prefix="cluster/rs", seed=13):
        """`tests/test_resharding_gc.py`'s fixture: a corpus, its
        unsharded index and a cluster over it; returns (corpus, cluster,
        the unsharded index's results)."""
        s = self.s
        name = prefix.split("/")[-1]
        corpus = s.data.write_corpus(store, f"corpus/{name}",
                                     s.data.make_logs_like(n_docs, seed=seed),
                                     n_blobs=3)
        mono = s.index.Index.build(corpus, s.index.BuilderConfig(**CFG),
                                   store, f"index/{name}", **s.dev)
        cluster = s.serving.ShardedIndex.build(
            corpus, s.index.BuilderConfig(**CFG), store, prefix,
            n_shards=n_shards, n_slots=n_slots, **s.dev)
        return corpus, cluster, self.mono(mono)

    def mono(self, index, queries=None):
        return _flat(_res(index.searcher().query_batch(queries or self.q)))

    def serve(self, key, cluster, expect, queries=None):
        """Every read path of the cluster's current generation: the
        per-shard legs under both impls, the fused path at top None and
        at top 5 under both budgets."""
        q = queries or self.q
        out = {}
        cs = cluster.searcher()
        for impl in ("sorted", "bitmap"):
            out[impl] = _res(cs.query_batch(q, impl=impl))
        cs.close()
        fs = cluster.searcher(fused=True)
        out["fused"] = _res(fs.query_batch(q))
        for budget in ("global", "per_shard"):
            out[budget] = _res(fs.query_batch(BUDGET_QUERIES, top_k=5,
                                              budget=budget))
        fs.close()
        self[key] = out
        for path in ("sorted", "bitmap", "fused"):
            self.agree(f"{key}/{path}", _flat(out[path]), expect)
        self.agree(f"{key}/budgets", _flat(out["global"]),
                   _flat(out["per_shard"]))

    def raises(self, key, exc_type, fn):
        """Run `fn`, which must raise `exc_type`; record what it said."""
        with pytest.raises(exc_type) as info:
            fn()
        self[key] = _error(info.value)

    def state(self, cluster):
        return (cluster.manifest, cluster.reader_generation,
                cluster.aliased_shards, cluster.n_docs)


def racing_store(s, hook, prefix="", text="", nth=2):
    """The fault-injection stores of `tests/test_resharding_gc.py` on
    package `s`: `hook="stage"` commits one document to a source shard
    at the first staged write (`_CommitDuringReshard`), `"cas"` at the
    CAS that publishes the next cluster generation (`_CommitAtPublish`,
    `_CommitAtAliasPublish`), `"kill"` raises at the `nth` staged write
    (`_KillNthStagedPut`)."""

    class Store(s.storage.InMemoryBlobStore):
        def __init__(self):
            super().__init__()
            self.armed = False
            self.fired = False
            self.seen = 0
            self.extra = None

        def _commit(self):
            self.fired = True
            victim = s.serving.ShardedIndex.open(self, prefix, **s.dev)
            self.extra = s.data.write_corpus(
                self, f"corpus/{prefix.split('/')[-1]}-extra", [text],
                n_blobs=1)
            routed = victim.partition(self.extra)
            target = next(i for i, p in enumerate(routed) if p.refs)
            w = victim.shard(target).writer()
            w.append(routed[target])
            w.commit()
            victim.close()

        def put(self, name, data):
            if self.armed and "/gen-" in name:
                if hook == "stage" and not self.fired:
                    self._commit()
                elif hook == "kill":
                    self.seen += 1
                    if self.seen == nth:
                        self.armed = False
                        raise RuntimeError("injected crash mid-compact")
            super().put(name, data)

        def put_if_absent(self, name, data):
            if hook == "cas" and self.armed and not self.fired \
                    and "/cluster-" in name:
                self._commit()
            return super().put_if_absent(name, data)

    return Store()


def _grown_oracle(rec, store, corpus, extra, name):
    """An unsharded index over `corpus` plus `extra`."""
    s = rec.s
    mono = s.index.Index.build(corpus, s.index.BuilderConfig(**CFG), store,
                               f"index/{name}", **s.dev)
    w = mono.writer()
    w.append(extra)
    w.commit()
    mono.refresh()
    return mono


# ------------------------------------------------------------------ scenarios
def cutover(rec, m):
    """`test_reshard_cutover_serves_continuously_byte_identical` and
    `test_search_service_refresh_follows_reshard`: a session opened
    before `reshard(m)` keeps serving the old generation."""
    s = rec.s
    store = s.storage.InMemoryBlobStore()
    _corpus, cluster, expect = rec.fixture(store)
    old = cluster.searcher()
    svc = s.serving.SearchService(
        s.serving.ShardedIndex.open(store, "cluster/rs", **s.dev),
        cache_size=8)
    rec["before"] = _res(old.query_batch(rec.q))
    rec.agree("before", _flat(rec["before"]), expect)
    cluster.reshard(m)
    rec["state"] = rec.state(cluster)
    rec["during"] = _res(old.query_batch(rec.q))
    rec.agree("during", _flat(rec["during"]), expect)
    old.close()
    svc_before = [svc.search(q) for q in rec.q]
    refreshed = svc.refresh()
    svc_after = [svc.search(q) for q in rec.q]
    rec["service"] = (_res(svc_before), refreshed, svc.index.n_shards,
                      _res(svc_after))
    rec.agree("service/before", _flat(_res(svc_before)), expect)
    rec.agree("service/after", _flat(_res(svc_after)), expect)
    svc.close()
    rec.serve("after", cluster, expect)
    stale = s.serving.ShardedIndex.open(store, "cluster/rs", generation=1,
                                        **s.dev)
    gen1 = stale.generation
    stale.refresh()
    rec["stale"] = (gen1, stale.generation, stale.n_shards)
    rec["blobs"] = _blobs(store)


def empty_shards(rec):
    """`test_reshard_cluster_with_empty_shards`."""
    s = rec.s
    store = s.storage.InMemoryBlobStore()
    corpus = s.data.write_corpus(store, "corpus/tiny-rs",
                                 s.data.make_logs_like(12, seed=3),
                                 n_blobs=1)
    mono = s.index.Index.build(corpus, s.index.BuilderConfig(**CFG), store,
                               "index/tiny-rs", **s.dev)
    cluster = s.serving.ShardedIndex.build(
        corpus, s.index.BuilderConfig(**CFG), store, "cluster/tiny-rs",
        n_shards=16, **s.dev)
    q = ["error", "info"]
    expect = rec.mono(mono, q)
    cluster.reshard(3)
    rec["shrunk"] = rec.state(cluster)
    rec.serve("shrink", cluster, expect, q)
    cluster.reshard(24)
    rec["grown"] = rec.state(cluster)
    rec.agree("empty slots", any(x is None for x in cluster.shards), True)
    rec.serve("grow", cluster, expect, q)
    rec["blobs"] = _blobs(store)


def split_merge(rec):
    """`test_split_and_merge_shards_stay_byte_identical` in alias mode,
    then in rebuild mode, and `test_split_single_slot_shard_raises`."""
    s = rec.s
    store = s.storage.InMemoryBlobStore()
    _corpus, cluster, expect = rec.fixture(store, n_shards=4, n_slots=8,
                                           prefix="cluster/sm")
    steps = [("split", lambda: cluster.split(1)),
             ("merge", lambda: cluster.merge_shards(0, 3)),
             ("split_rebuild", lambda: cluster.split(0, mode="rebuild")),
             ("merge_rebuild",
              lambda: cluster.merge_shards(1, 2, mode="rebuild"))]
    for key, step in steps:
        step()
        rec[f"{key}/state"] = rec.state(cluster)
        rec.serve(key, cluster, expect)
        covered = sorted(x for e in cluster.manifest["shards"]
                         for x in e["slots"])
        rec.agree(f"{key}/slots", covered, list(range(8)))
    rec["blobs"] = _blobs(store)
    _c, single, _e = rec.fixture(s.storage.InMemoryBlobStore(),
                                 n_docs=120, prefix="cluster/ss")
    rec.raises("single_slot", ValueError, lambda: single.split(0))


def routing(rec):
    """`test_routing_follows_membership_changes` and
    `test_reshard_preserves_slot_overprovisioning`."""
    s = rec.s
    store = s.storage.InMemoryBlobStore()
    corpus, cluster, _expect = rec.fixture(store, n_shards=4, n_slots=8,
                                           prefix="cluster/rt")
    cluster.split(2)
    cluster.merge_shards(0, 1)
    parts = cluster.partition(corpus)
    rec["routes"] = [[(dataclasses.astuple(r), cluster.route_ref(r))
                      for r in part.refs] for part in parts]
    rec.agree("all routed", sum(p.n_docs for p in parts), corpus.n_docs)
    for i, part in enumerate(parts):
        for ref in part.refs:
            rec.agree("route", cluster.route_ref(ref), i)
            rec.agree("slot", s.cluster.slot_of_ref(ref, cluster.n_slots)
                      in cluster.manifest["shards"][i]["slots"], True)
    store = s.storage.InMemoryBlobStore()
    _corpus, cluster, expect = rec.fixture(store, n_shards=4, n_slots=12,
                                           prefix="cluster/sp")
    cluster.reshard(6)
    after6 = (cluster.n_shards, cluster.n_slots)
    cluster.split(0)
    cluster.reshard(3, n_slots=3)
    rec["overprovisioned"] = (after6, rec.state(cluster))
    rec.serve("overprovisioned/serve", cluster, expect)


def race_rebuild(rec):
    """`test_concurrent_reshard_vs_commit_fails_typed_then_retries`."""
    s = rec.s
    store = racing_store(s, "stage", "cluster/race", "zzzsentinel error doc")
    corpus = s.data.write_corpus(store, "corpus/race",
                                 s.data.make_logs_like(120, seed=5),
                                 n_blobs=2)
    cluster = s.serving.ShardedIndex.build(
        corpus, s.index.BuilderConfig(**CFG), store, "cluster/race",
        n_shards=3, **s.dev)
    store.armed = True
    before = set(store.list("cluster/race/"))
    rec.raises("conflict", s.serving.ClusterConflict,
               lambda: cluster.reshard(5, mode="rebuild"))
    leftovers = set(store.list("cluster/race/")) - before
    rec["fired"] = (store.fired, sorted(leftovers))
    rec.agree("staging cleaned", [n for n in leftovers if "/gen-" in n], [])
    store.armed = False
    cluster.refresh()
    cluster.reshard(5, mode="rebuild")
    rec["state"] = rec.state(cluster)
    mono = _grown_oracle(rec, store, corpus, store.extra, "race")
    q = rec.q + ["zzzsentinel"]
    rec.serve("retry", cluster, rec.mono(mono, q), q)
    rec["blobs"] = _blobs(store)


def _race_cas(rec, prefix, text, m):
    """A shard commit lands at the CAS that publishes `reshard(m)`; the
    publish succeeds and re-applies the raced document."""
    s = rec.s
    store = racing_store(s, "cas", prefix, text)
    corpus, cluster, _expect = rec.fixture(store, n_docs=150, prefix=prefix)
    store.armed = True
    cluster.reshard(m)
    store.armed = False
    rec["state"] = (store.fired, rec.state(cluster))
    name = prefix.split("/")[-1]
    mono = _grown_oracle(rec, store, corpus, store.extra, f"{name}-grown")
    q = rec.q + [text.split()[0]]
    expect = rec.mono(mono, q)
    rec.serve("serve", cluster, expect, q)
    reopened = s.serving.ShardedIndex.open(store, prefix, **s.dev)
    rec.serve("reopened", reopened, expect, q)
    reopened.close()
    rec["blobs"] = _blobs(store)


def race_cas_window(rec):
    """`test_commit_in_recheck_cas_window_is_reapplied` (its 120-doc
    corpus became the shared 150-doc fixture)."""
    _race_cas(rec, "cluster/win", "zzzwindow error doc", 5)


def race_alias_cas(rec):
    """`test_commit_racing_alias_cas_window_is_reapplied`."""
    _race_cas(rec, "cluster/aw", "zzzaliaswin error doc", 6)


def compact_killed(rec):
    """`test_compact_killed_mid_build_cleans_staging_and_keeps_serving`."""
    s = rec.s
    store = racing_store(s, "kill")
    _corpus, cluster, expect = rec.fixture(store, n_docs=150,
                                           prefix="cluster/ck")
    cluster.reshard(3)
    target = cluster.aliased_shards[0]
    before = set(store.list("cluster/ck/"))
    store.armed = True
    rec.raises("crash", RuntimeError, lambda: cluster.compact(target))
    leftovers = set(store.list("cluster/ck/")) - before
    rec["after_crash"] = (store.seen, sorted(leftovers), rec.state(cluster))
    rec.agree("staging cleaned", [n for n in leftovers if "/gen-" in n], [])
    rec.serve("aliased", cluster, expect)
    cluster.compact(target)
    rec["compacted"] = rec.state(cluster)
    rec.agree("de-aliased", target in cluster.aliased_shards, False)
    rec.serve("compacted/serve", cluster, expect)
    rec["blobs"] = _blobs(store)


def append(rec):
    """`test_cluster_append_routes_and_materializes_empty_slots`,
    `test_append_on_stale_handle_fails_typed`,
    `test_append_retry_is_idempotent` and
    `test_append_into_aliased_shard_serves_alongside_aliases`."""
    s = rec.s
    cfg = s.index.BuilderConfig(**CFG)
    # empty slots materialize through a follow-up cluster generation
    store = s.storage.InMemoryBlobStore()
    corpus = s.data.write_corpus(store, "corpus/ap",
                                 s.data.make_logs_like(12, seed=3),
                                 n_blobs=1)
    cluster = s.serving.ShardedIndex.build(corpus, cfg, store, "cluster/ap",
                                           n_shards=16, **s.dev)
    extra = s.data.write_corpus(store, "corpus/ap-extra",
                                [f"apdoc{i} error new" for i in range(40)],
                                n_blobs=1)
    cluster.append(extra)
    rec["materialize"] = rec.state(cluster)
    mono = _grown_oracle(rec, store, corpus, extra, "ap")
    q = rec.q + ["apdoc3"]
    rec.serve("materialize/serve", cluster, rec.mono(mono, q), q)

    # a stale handle fails typed; the current one appends
    store = s.storage.InMemoryBlobStore()
    corpus, cluster, _e = rec.fixture(store, n_docs=150,
                                      prefix="cluster/st-ap")
    stale = s.serving.ShardedIndex.open(store, "cluster/st-ap", **s.dev)
    cluster.reshard(2)
    extra = s.data.write_corpus(store, "corpus/st-ap-x", ["zzzstale error"],
                                n_blobs=1)
    rec.raises("stale", s.serving.ClusterConflict,
               lambda: stale.append(extra))
    cluster.append(extra)
    mono = _grown_oracle(rec, store, corpus, extra, "st-ap-grown")
    q = rec.q + ["zzzstale"]
    rec.serve("stale/serve", cluster, rec.mono(mono, q), q)

    # the conflict retry: a second append of the same refs is a no-op
    store = s.storage.InMemoryBlobStore()
    corpus, cluster, _e = rec.fixture(store, n_docs=150,
                                      prefix="cluster/idem")
    extra = s.data.write_corpus(store, "corpus/idem-x",
                                [f"idemdoc{i} error" for i in range(6)],
                                n_blobs=1)
    cluster.append(extra)
    cluster.append(extra)
    rec["retry"] = rec.state(cluster)
    all_refs = [r for idx in cluster.shards if idx is not None
                for r in idx.corpus_refs()]
    rec.agree("no duplicates", len(all_refs), len(set(all_refs)))
    mono = _grown_oracle(rec, store, corpus, extra, "idem-grown")
    q = rec.q + ["idemdoc3"]
    rec.serve("retry/serve", cluster, rec.mono(mono, q), q)

    # into purely aliased shards: an overlay serves beside the aliases
    store = s.storage.InMemoryBlobStore()
    corpus, cluster, _e = rec.fixture(store, n_docs=150,
                                      prefix="cluster/aap")
    cluster.reshard(3)
    extra = s.data.write_corpus(store, "corpus/aap-x",
                                [f"aapdoc{i} error fresh" for i in range(8)],
                                n_blobs=1)
    cluster.append(extra)
    rec["aliased"] = rec.state(cluster)
    for i, idx in enumerate(cluster.shards):
        if idx is not None:
            rec.agree("overlay keeps aliases",
                      bool(cluster.manifest["shards"][i]["aliases"]), True)
    mono = _grown_oracle(rec, store, corpus, extra, "aap-grown")
    q = rec.q + ["aapdoc3"]
    expect = rec.mono(mono, q)
    rec.serve("aliased/serve", cluster, expect, q)
    gen = cluster.generation
    cluster.append(extra)
    rec.agree("aliased retry is a no-op", cluster.generation, gen)
    for i in list(cluster.aliased_shards):
        cluster.compact(i)
    rec["aliased/compacted"] = rec.state(cluster)
    rec.serve("aliased/compacted/serve", cluster, expect, q)
    rec["blobs"] = _blobs(store)


def racing_publishers(rec):
    """`test_racing_publisher_fails_typed_and_cleans_staging` and
    `test_racing_alias_publisher_fails_typed`."""
    s = rec.s
    store = s.storage.InMemoryBlobStore()
    _corpus, cluster, _e = rec.fixture(store, prefix="cluster/cas")
    manifest = dict(cluster.manifest)
    manifest["generation"] = cluster.generation + 1
    store.put(s.cluster._cluster_manifest_name("cluster/cas",
                                               cluster.generation + 1),
              s.cluster.encode_cluster_manifest(manifest))
    before = _blobs(store, "cluster/cas/")
    rec.raises("injected", s.serving.ClusterConflict,
               lambda: cluster.reshard(2))
    rec.agree("nothing written", _blobs(store, "cluster/cas/"), before)

    store = s.storage.InMemoryBlobStore()
    _corpus, cluster, expect = rec.fixture(store, n_docs=150,
                                           prefix="cluster/ar")
    rival = s.serving.ShardedIndex.open(store, "cluster/ar", **s.dev)
    rival.reshard(2)
    rec.raises("rival", s.serving.ClusterConflict,
               lambda: cluster.reshard(6))
    cluster.refresh()
    cluster.reshard(6)
    rec["retried"] = rec.state(cluster)
    rec.serve("retried/serve", cluster, expect)
    rec["blobs"] = _blobs(store)


def _gc_roundtrip(rec, store, prefix, expect, keep=1):
    """`tests/test_resharding_gc.py::_gc_roundtrip`: the dry run lists
    the orphans, the real run deletes exactly those, and the cluster
    reopens and serves as before."""
    s = rec.s
    leases = s.index.LeaseRegistry()
    dry = s.serving.collect_cluster_garbage(store, prefix, keep=keep,
                                            grace_s=0.0, dry_run=True,
                                            now=NOW, leases=leases)
    live = s.cluster.cluster_reachable_blobs(store, prefix, keep=keep)
    before = set(store.list(f"{prefix}/"))
    real = s.serving.collect_cluster_garbage(store, prefix, keep=keep,
                                             grace_s=0.0, now=NOW,
                                             leases=leases)
    rec["gc"] = (_gc(dry), sorted(live), _gc(real))
    rec.agree("dry run deletes nothing", dry.deleted, [])
    rec.agree("orphans unreachable", set(dry.unreachable) & live, set())
    rec.agree("everything classified",
              set(dry.unreachable) | live >= before, True)
    rec.agree("real == dry", real.deleted, dry.unreachable)
    rec.agree("deleted exactly", before - set(store.list(f"{prefix}/")),
              set(real.deleted))
    reopened = s.serving.ShardedIndex.open(store, prefix, **s.dev)
    rec.serve("reopened", reopened, expect)
    reopened.close()
    rec["blobs"] = _blobs(store)


def gc_reshard(rec):
    """`test_collect_garbage_after_reshard_sim_store`."""
    store = rec.s.storage.InMemoryBlobStore()
    _corpus, cluster, expect = rec.fixture(store, prefix="cluster/gc")
    cluster.reshard(2)
    cluster.reshard(5)
    _gc_roundtrip(rec, store, "cluster/gc", expect)


def gc_disk(rec):
    """`test_collect_garbage_after_reshard_disk_store`."""
    with tempfile.TemporaryDirectory() as root:
        store = rec.s.storage.LocalBlobStore(root)
        _corpus, cluster, expect = rec.fixture(store, n_docs=200,
                                               prefix="cluster/gcd")
        cluster.reshard(2)
        _gc_roundtrip(rec, store, "cluster/gcd", expect)


def gc_keep_grace(rec):
    """`test_gc_keeps_latest_k_generations_openable` and
    `test_gc_grace_window_spares_young_blobs`."""
    s = rec.s
    store = s.storage.InMemoryBlobStore()
    _corpus, cluster, expect = rec.fixture(store, prefix="cluster/gk")
    cluster.reshard(2)
    cluster.reshard(6)
    cluster.reshard(3)
    rec["keep"] = _gc(s.serving.collect_cluster_garbage(
        store, "cluster/gk", keep=2, grace_s=0.0, now=NOW,
        leases=s.index.LeaseRegistry()))
    for gen in (3, 4):
        c = s.serving.ShardedIndex.open(store, "cluster/gk", generation=gen,
                                        **s.dev)
        rec.serve(f"keep/{gen}", c, expect)
    rec.raises("keep/collected", KeyError, lambda: s.serving.ShardedIndex.open(
        store, "cluster/gk", generation=1, **s.dev))

    store = s.storage.InMemoryBlobStore()
    _corpus, cluster, _e = rec.fixture(store, n_docs=150,
                                       prefix="cluster/gw")
    cluster.reshard(2)
    young = s.serving.collect_cluster_garbage(store, "cluster/gw", keep=1,
                                              grace_s=3600.0,
                                              now=time.time())
    old = s.serving.collect_cluster_garbage(store, "cluster/gw", keep=1,
                                            grace_s=3600.0, now=NOW)
    rec["grace"] = (_gc(young), _gc(old))
    rec.agree("young spared", (young.deleted, young.kept_grace),
              ([], young.unreachable))
    rec.agree("old swept", (old.deleted, old.kept_grace),
              (young.unreachable, []))
    rec["blobs"] = _blobs(store)


def gc_alias_window(rec):
    """`test_gc_during_alias_window_never_collects_aliased_sources`."""
    s = rec.s
    store = s.storage.InMemoryBlobStore()
    _corpus, cluster, expect = rec.fixture(store, n_docs=150,
                                           prefix="cluster/gw2")
    sources = {n for n in store.list("cluster/gw2/") if "/shard-" in n}
    cluster.reshard(5)
    leases = s.index.LeaseRegistry()
    dry = s.serving.collect_cluster_garbage(store, "cluster/gw2", keep=1,
                                            grace_s=0.0, dry_run=True,
                                            now=NOW, leases=leases)
    real = s.serving.collect_cluster_garbage(store, "cluster/gw2", keep=1,
                                             grace_s=0.0, now=NOW,
                                             leases=leases)
    rec["gc"] = (_gc(dry), _gc(real))
    rec.agree("real == dry", sorted(real.deleted), sorted(dry.unreachable))
    rec.agree("sources kept", set(real.deleted) & sources, set())
    reopened = s.serving.ShardedIndex.open(store, "cluster/gw2", **s.dev)
    rec.serve("reopened", reopened, expect)
    rec["blobs"] = _blobs(store)


def gc_shared_alias(rec):
    """`test_gc_shared_alias_source_survives_until_last_manifest_ages_out`:
    a leased generation keeps an alias source alive; after `compact` and
    age-out the source is swept in full."""
    s = rec.s
    store = s.storage.InMemoryBlobStore()
    _corpus, cluster, expect = rec.fixture(store, n_docs=150,
                                           prefix="cluster/gx", n_slots=8)
    shard0 = "cluster/gx/shard-0000"
    shard0_blobs = set(store.list(shard0 + "/"))
    cluster.split(0)
    cluster.replicate(0, 2)
    rec["replicated"] = rec.state(cluster)
    leases = s.index.LeaseRegistry()
    pin = leases.acquire("cluster/gx", 2)
    pinned = s.serving.collect_cluster_garbage(store, "cluster/gx", keep=1,
                                               grace_s=0.0, now=NOW,
                                               leases=leases)
    rec.agree("pinned source kept", set(pinned.deleted) & shard0_blobs,
              set())
    for g in (2, 3):
        c = s.serving.ShardedIndex.open(store, "cluster/gx", generation=g,
                                        **s.dev)
        rec.serve(f"pinned/{g}", c, expect)
    pin.release()
    while cluster.aliased_shards:
        cluster.compact(min(cluster.aliased_shards))
    rec["compacted"] = rec.state(cluster)
    swept = s.serving.collect_cluster_garbage(store, "cluster/gx", keep=1,
                                              grace_s=0.0, now=NOW,
                                              leases=leases)
    rec["gc"] = (_gc(pinned), _gc(swept))
    rec.agree("source swept", (store.list(shard0 + "/"),
                               shard0_blobs <= set(swept.deleted)),
              ([], True))
    reopened = s.serving.ShardedIndex.open(store, "cluster/gx", **s.dev)
    rec.serve("swept/serve", reopened, expect)
    rec["blobs"] = _blobs(store)


def gc_leases(rec):
    """`tests/test_nrt.py::test_cluster_gc_respects_service_leases`: a
    service's leases on the cluster and its shards protect the snapshot
    it serves from an ungraced sweep, until it refreshes."""
    s = rec.s
    store = s.storage.InMemoryBlobStore()
    c1 = s.data.write_corpus(store, "corpus/nrt1",
                             s.data.make_logs_like(400, seed=71), n_blobs=3)
    c2 = s.data.write_corpus(store, "corpus/nrt2",
                             s.data.make_logs_like(300, seed=72), n_blobs=2)
    cfg = s.index.BuilderConfig(**NRT_CFG)
    cluster = s.serving.ShardedIndex.build(c1, cfg, store, "cluster/lease",
                                           n_shards=2, **s.dev)
    mono = s.index.Index.build(c1, cfg, store, "index/lease", **s.dev)
    q = ["error", "info", "block", "error AND block", "warn OR node7"]
    q = [s.index.parse(x) for x in q]
    reg = s.index.LeaseRegistry()
    svc = s.serving.SearchService(
        s.serving.ShardedIndex.open(store, "cluster/lease", **s.dev),
        leases=reg, cache_size=16)
    expect = _res(svc.search_batch(q))
    rec.agree("service", _flat(expect), rec.mono(mono, q))
    for i in range(cluster.n_shards):
        w = cluster.shard(i).writer()
        w.append(cluster.partition(c2)[i])
        w.commit()
        w.merge()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        leased = s.serving.collect_cluster_garbage(
            store, "cluster/lease", keep=1, grace_s=0.0, now=NOW,
            leases=reg)
    snapshot = _res(svc.search_batch(q))
    rec.agree("snapshot intact", _flat(snapshot), _flat(expect))
    refreshed = svc.refresh()
    swept = s.serving.collect_cluster_garbage(store, "cluster/lease", keep=1,
                                              grace_s=0.0, now=NOW,
                                              leases=reg)
    w = mono.writer()
    w.append(c2)
    w.commit()
    grown = _res(svc.search_batch(q))
    rec.agree("grown", _flat(grown), rec.mono(mono, q))
    rec["gc"] = (_gc(leased), refreshed, _gc(swept))
    rec["served"] = (expect, snapshot, grown)
    svc.close()
    rec["blobs"] = _blobs(store)


def gc_ungraced(rec):
    """`tests/test_nrt.py::test_grace_zero_without_registry_raises`, for
    the cluster sweep."""
    s = rec.s
    store = s.storage.InMemoryBlobStore()
    c1 = s.data.write_corpus(store, "corpus/nrt1",
                             s.data.make_logs_like(40, seed=71), n_blobs=3)
    index = s.index.Index.build(c1, s.index.BuilderConfig(**NRT_CFG), store,
                                "index/warn", **s.dev)
    expect = rec.mono(index)
    rec.raises("raises", s.compat.UngracedSweepError,
               lambda: s.serving.collect_cluster_garbage(
                   store, "index/warn", keep=1, grace_s=0.0, now=NOW))
    with mock.patch.dict(os.environ, {"REPRO_ALLOW_DEPRECATED": "1"}), \
            pytest.warns(DeprecationWarning, match="LeaseRegistry") as warned:
        report = s.serving.collect_cluster_garbage(
            store, "index/warn", keep=1, grace_s=0.0, now=NOW)
    rec["allowed"] = (_gc(report), [str(w.message) for w in warned])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        rec["graced"] = _gc(s.serving.collect_cluster_garbage(
            store, "index/warn", keep=1, grace_s=600.0, now=NOW))
    rec.agree("index intact", rec.mono(s.index.Index.open(
        store, "index/warn", **s.dev)), expect)
    rec["blobs"] = _blobs(store)


SCENARIOS = {
    "cutover_2": (lambda rec: cutover(rec, 2),
                  ["before", "state", "during", "service", "after", "stale",
                   "blobs"]),
    "cutover_7": (lambda rec: cutover(rec, 7),
                  ["before", "state", "during", "service", "after", "stale",
                   "blobs"]),
    "empty_shards": (empty_shards, ["shrunk", "shrink", "grown", "grow",
                                    "blobs"]),
    "split_merge": (split_merge,
                    [f"{k}{x}" for k in ("split", "merge", "split_rebuild",
                                         "merge_rebuild")
                     for x in ("/state", "")] + ["blobs", "single_slot"]),
    "routing": (routing, ["routes", "overprovisioned",
                          "overprovisioned/serve"]),
    "race_rebuild": (race_rebuild, ["conflict", "fired", "state", "retry",
                                    "blobs"]),
    "race_cas_window": (race_cas_window, ["state", "serve", "reopened",
                                          "blobs"]),
    "race_alias_cas": (race_alias_cas, ["state", "serve", "reopened",
                                        "blobs"]),
    "compact_killed": (compact_killed, ["crash", "after_crash", "aliased",
                                        "compacted", "compacted/serve",
                                        "blobs"]),
    "append": (append, ["materialize", "materialize/serve", "stale",
                        "stale/serve", "retry", "retry/serve", "aliased",
                        "aliased/serve", "aliased/compacted",
                        "aliased/compacted/serve", "blobs"]),
    "racing_publishers": (racing_publishers, ["injected", "rival", "retried",
                                              "retried/serve", "blobs"]),
    "gc_reshard": (gc_reshard, ["gc", "reopened", "blobs"]),
    "gc_disk": (gc_disk, ["gc", "reopened", "blobs"]),
    "gc_keep_grace": (gc_keep_grace, ["keep", "keep/3", "keep/4",
                                      "keep/collected", "grace", "blobs"]),
    "gc_alias_window": (gc_alias_window, ["gc", "reopened", "blobs"]),
    "gc_shared_alias": (gc_shared_alias, ["replicated", "pinned/2",
                                          "pinned/3", "compacted", "gc",
                                          "swept/serve", "blobs"]),
    "gc_leases": (gc_leases, ["gc", "served", "blobs"]),
    "gc_ungraced": (gc_ungraced, ["raises", "allowed", "graced", "blobs"]),
}
CASES = [(name, key) for name, (_fn, keys) in SCENARIOS.items()
         for key in keys]


@pytest.fixture(scope="module")
def run():
    """`run(name)` → {side: Rec}, each scenario run once per module."""
    done: dict = {}

    def get(name):
        if name not in done:
            recs = {}
            for side, s in SIDES.items():
                recs[side] = Rec(s)
                with uuid_sequence():
                    SCENARIOS[name][0](recs[side])
            done[name] = recs
        return done[name]

    return get


@pytest.mark.parametrize("name,key", CASES,
                         ids=[f"{n}-{k}" for n, k in CASES])
def test_cluster_management_matches_jax(run, name, key):
    recs = run(name)
    assert sorted(recs["j"].trace) == sorted(SCENARIOS[name][1]) == \
        sorted(recs["t"].trace)
    assert recs["t"].trace[key] == recs["j"].trace[key], (name, key)


@pytest.mark.parametrize("side", ["j", "t"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_agrees_with_the_unsharded_index(run, name, side):
    oracle = run(name)[side].oracle
    assert oracle
    for label, got, want in oracle:
        assert got == want, (name, side, label)


# ------------------------------------------------- the history machine
OPS = ["append", "commit", "reshard", "split", "merge_shards", "replicate",
       "compact", "refresh", "gc"]


def history(s, ops) -> list:
    """`test_membership_history_stays_byte_identical_to_oracle` on
    package `s`, with the op sequence drawn up front: every op's integer
    arguments are taken modulo the state it meets. Returns the trace
    after every step; asserts the oracle after every step."""
    rec = Rec(s)
    store = s.storage.InMemoryBlobStore()
    corpus = s.data.write_corpus(store, "corpus/hist",
                                 s.data.make_logs_like(80, seed=33),
                                 n_blobs=2)
    cfg = s.index.BuilderConfig(B=600, F0=1.0, index_ngrams=3)
    oracle = s.index.Index.build(corpus, cfg, store, "index/hist", **s.dev)
    cluster = s.serving.ShardedIndex.build(corpus, cfg, store,
                                           "cluster/hist", n_shards=3,
                                           n_slots=6, **s.dev)
    follower = s.serving.ShardedIndex.open(store, "cluster/hist", **s.dev)
    leases = s.index.LeaseRegistry()
    extra_i = 0
    out = []

    def grow(text):
        nonlocal extra_i
        extra_i += 1
        extra = s.data.write_corpus(
            store, f"corpus/hist-x{extra_i}",
            [f"{text}{extra_i} error blk_102 info"], n_blobs=1)
        w = oracle.writer()
        w.append(extra)
        w.commit()
        oracle.refresh()
        return extra

    for step, (op, a, b) in enumerate(ops):
        event = None
        if op == "append":
            cluster.append(grow("hista"))
        elif op == "commit":
            extra = grow("histc")
            routed = cluster.partition(extra)
            target = next(i for i, p in enumerate(routed) if p.refs)
            if cluster.shards[target] is not None:
                w = cluster.shard(target).writer()
                w.append(routed[target])
                w.commit()
            else:
                cluster.append(extra)
        elif op == "reshard":
            cluster.reshard(1 + a % 4, n_slots=6)
        elif op == "split":
            i = a % cluster.n_shards
            entry = cluster.manifest["shards"][i]
            if len(entry["slots"]) >= 2 and (
                    cluster.shards[i] is not None
                    or cluster.alias_sources[i]):
                cluster.split(i)
        elif op == "merge_shards":
            if cluster.n_shards >= 2:
                i = a % (cluster.n_shards - 1)
                cluster.merge_shards(i, i + 1)
        elif op == "replicate":
            cluster.replicate(a % cluster.n_shards, 1 + b % 3)
        elif op == "compact":
            if cluster.aliased_shards:
                cluster.compact(cluster.aliased_shards[
                    a % len(cluster.aliased_shards)])
        elif op == "refresh":
            follower.refresh()
            expect = rec.mono(oracle)
            cs = follower.searcher()
            event = _res(cs.query_batch(rec.q))
            cs.close()
            assert _flat(event) == expect, (step, op)
        elif op == "gc":
            follower.refresh()
            event = _gc(s.serving.collect_cluster_garbage(
                store, "cluster/hist", keep=1, grace_s=0.0, now=NOW,
                leases=leases))
        rec.trace = {}
        rec.oracle = []
        rec.serve("serve", cluster, rec.mono(oracle))
        for label, got, want in rec.oracle:
            assert got == want, (step, op, label)
        out.append((op, event, rec.state(cluster), rec.trace["serve"]))
    while cluster.aliased_shards:
        cluster.compact(cluster.aliased_shards[0])
    rec.trace = {}
    rec.oracle = []
    rec.serve("serve", cluster, rec.mono(oracle))
    for label, got, want in rec.oracle:
        assert got == want, ("compacted", label)
    out.append(("compacted", None, rec.state(cluster), rec.trace["serve"]))
    out.append(_blobs(store))
    return out


@settings(max_examples=5, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(OPS),
                          st.integers(min_value=0, max_value=11),
                          st.integers(min_value=0, max_value=11)),
                min_size=2, max_size=6))
def test_membership_history_matches_jax(ops):
    traces = {}
    for side, s in SIDES.items():
        with uuid_sequence():
            traces[side] = history(s, ops)
    assert len(traces["t"]) == len(traces["j"])
    for step, (a, b) in enumerate(zip(traces["j"], traces["t"])):
        assert b == a, (step, ops[step] if step < len(ops) else "end")
