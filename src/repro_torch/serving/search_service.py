"""Batched keyword-search serving — the paper's own application.

A search session is ~2 MB of MHT state: it boots from one header read
per index unit and serves queries statelessly (FaaS-style, paper
§III-A). The service wraps one reader per corpus with latency accounting
that mirrors the paper's benchmarks (mean / p99 / wait-vs-download
split).

The service fronts the index lifecycle (docs/index_lifecycle.md):
construct it from an `Index` handle and it serves that handle's current
generation — base plus any delta segments — through the multi-unit
engine; `refresh()` re-resolves the generation after a writer commits or
merges. Both caches are **generation-keyed**, so a refresh can never
serve pre-commit bytes (superpost cache) or pre-commit results (the LRU
over whole query results); entries of dead generations simply age out.

`search_batch` is the scale path: N concurrent queries are planned,
fetched, and decoded together through `query_batch`, so the whole batch
costs two shared fetch rounds instead of 2·N sequential ones
(docs/query_engine.md).

The legacy `SearchService(cloud, index_prefix)` constructor (a
`SimCloudStore` + prefix) survives as a deprecated shim over the
transport adapter; transports and bare blob stores are accepted too.

In this package the service combines on the handle's `device` (an
`Index` or `ShardedIndex` carries its own; the prefix form opens
`Index.open(source, prefix, device=device)`), and `search_batch`
defaults to `impl="bitmap"`: the CUDA kernels on a card, the plain
PyTorch versions on "cpu". `search` stays on the host's sorted path.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np

from ..compat import deprecated_call
from ..index.lifecycle import Index
from ..index.query import Query, Regex, normalize, parse
from ..index.searcher import Searcher
from ..storage.cache import LRUCache, SuperpostCache
from ..storage.simcloud import SimCloudStore
from ..storage.transport import SimCloudTransport
from .cluster import ShardedIndex


@dataclass
class LatencyStats:
    """Service-level latency accounting.

    One entry of `samples_s` is one **engine round**: a serial query, or
    a whole shared-round batch (recorded ONCE, tagged with its size in
    `batch_sizes`). Recording the batch's wall clock per member query —
    N copies of the same number — used to inflate mean/p50/p99 N-fold
    against serial runs of the same workload; a batch is one service
    event, so it is one sample.
    """

    samples_s: list = field(default_factory=list)
    batch_sizes: list = field(default_factory=list)   # ∥ samples_s
    wait_s: list = field(default_factory=list)
    download_s: list = field(default_factory=list)
    false_positives: int = 0
    results: int = 0
    cache_hits: int = 0          # query-result cache
    cache_lookups: int = 0
    # per-shard scatter accounting (cluster backends only): running sums
    # over every observed ScatterReport, index = shard position
    shard_candidates: list = field(default_factory=list)
    round2_bytes: list = field(default_factory=list)
    round2_requests: list = field(default_factory=list)
    scatter_rounds: int = 0
    fused_rounds: int = 0

    def observe(self, stats) -> None:
        self.samples_s.append(stats.total_s)
        self.batch_sizes.append(1)
        self.wait_s.append(stats.lookup.wait_s + stats.docs.wait_s)
        self.download_s.append(stats.lookup.download_s
                               + stats.docs.download_s)
        self.false_positives += stats.n_false_positives
        self.results += stats.n_results

    def observe_batch(self, stats_list) -> None:
        """Record one shared-round batch as ONE sample.

        Members share their fetch rounds, so the batch completes when its
        slowest member does — that wall clock (and its wait/download
        split) is the sample; false positives and results still sum over
        members."""
        if not stats_list:
            return
        self.samples_s.append(max(s.total_s for s in stats_list))
        self.batch_sizes.append(len(stats_list))
        self.wait_s.append(max(s.lookup.wait_s + s.docs.wait_s
                               for s in stats_list))
        self.download_s.append(max(s.lookup.download_s + s.docs.download_s
                                   for s in stats_list))
        for s in stats_list:
            self.false_positives += s.n_false_positives
            self.results += s.n_results

    def observe_scatter(self, report) -> None:
        """Fold one scatter-gather round's per-shard accounting in.

        Accepts any `ScatterReport`; rounds that predate the budget
        fields (or single-index backends) contribute nothing. The
        accumulators resize when cluster membership grew across a
        `refresh()` — sums stay per shard position."""
        per_shard = [getattr(report, "shard_candidates", []),
                     getattr(report, "round2_bytes", []),
                     getattr(report, "round2_requests", [])]
        sums = [self.shard_candidates, self.round2_bytes,
                self.round2_requests]
        for values, acc in zip(per_shard, sums):
            if len(acc) < len(values):
                acc.extend([0] * (len(values) - len(acc)))
            for i, v in enumerate(values):
                acc[i] += int(v)
        self.scatter_rounds += 1
        if getattr(report, "fused", False):
            self.fused_rounds += 1

    def summary(self) -> dict:
        arr = np.asarray(self.samples_s)
        n_queries = int(sum(self.batch_sizes))
        return {
            "n": len(arr),
            "n_queries": n_queries,
            "mean_batch_size": n_queries / len(arr) if len(arr) else 0.0,
            "mean_ms": float(arr.mean() * 1e3) if len(arr) else 0.0,
            "p50_ms": float(np.percentile(arr, 50) * 1e3) if len(arr) else 0.0,
            "p99_ms": float(np.percentile(arr, 99) * 1e3) if len(arr) else 0.0,
            "wait_ms": float(np.mean(self.wait_s) * 1e3) if len(arr) else 0.0,
            "download_ms": float(np.mean(self.download_s) * 1e3)
            if len(arr) else 0.0,
            "avg_false_positives": self.false_positives / max(n_queries, 1),
            "cache_hit_rate": self.cache_hits / self.cache_lookups
            if self.cache_lookups else 0.0,
            # scatter observability (empty/zero on single-index backends)
            "scatter_rounds": self.scatter_rounds,
            "fused_rounds": self.fused_rounds,
            "shard_candidates": list(self.shard_candidates),
            "round2_bytes_per_shard": list(self.round2_bytes),
            "round2_requests_per_shard": list(self.round2_requests),
            "round2_bytes": int(sum(self.round2_bytes)),
            "round2_requests": int(sum(self.round2_requests)),
        }


class SearchService:
    def __init__(self, source, index_prefix: str | None = None,
                 hedge: bool = False, cache_size: int = 0,
                 superpost_cache_bytes: int = 0,
                 coalesce_gap: int | None = 4096,
                 leases=None, device="cuda") -> None:
        self.superpost_cache = SuperpostCache(superpost_cache_bytes) \
            if superpost_cache_bytes else None
        self.hedge = hedge
        self.coalesce_gap = coalesce_gap
        self.stats = LatencyStats()
        # reader leases (index/nrt.py LeaseRegistry): when given, the
        # service registers every generation its live searcher pins, so
        # collect_garbage(..., leases=...) can never delete the snapshot
        # it is serving — even with grace_s=0.0
        self.leases = leases
        self._held: list = []
        self._subscription = None
        # query-result cache (paper §IV-A remark: memoization bounds the
        # worst case where a few irrelevant hot words dominate) — LRU, so
        # a burst of distinct queries evicts the coldest entry, not the
        # oldest hot one; keys carry the index generation so a committed
        # write can never serve pre-commit results
        self._cache: LRUCache | None = \
            LRUCache(cache_size) if cache_size else None

        if isinstance(source, (Index, ShardedIndex)):
            self._index = source
        else:
            if index_prefix is None:
                raise TypeError(
                    "SearchService(store_or_transport, index_prefix) "
                    "requires a prefix when not given an Index handle")
            if isinstance(source, SimCloudStore):
                # escalated from DeprecationWarning (compat.py):
                # raises unless REPRO_ALLOW_DEPRECATED=1 is set
                deprecated_call(
                    "SearchService(SimCloudStore, index_prefix) was "
                    "removed",
                    "pass an Index handle (Index.open(store, prefix)) "
                    "or a StorageTransport")
                source = SimCloudTransport(source)
            # the raw source goes straight to Index.open so a bare store
            # keeps owns_transport=True and close() actually releases it
            self._index = Index.open(source, index_prefix, device=device)
        self._open_searcher()

    def _open_searcher(self) -> None:
        old = getattr(self, "searcher", None)
        if old is not None and hasattr(old, "close"):
            old.close()          # a ClusterSearcher owns a thread pool
        self.searcher = self._index.searcher(
            cache=self.superpost_cache, coalesce_gap=self.coalesce_gap)
        # the snapshot this service serves until the next swap — result
        # caches key on it, leases pin it
        self._pin = self._reader_pin()
        self._lease_pins()

    def _lease_pins(self) -> None:
        """Acquire leases on everything the new searcher pins, THEN
        release the old set — the GC never observes a moment where
        neither snapshot is protected. A cluster session leases the
        cluster prefix and every live shard prefix (shards commit and
        collect independently), plus every aliased source prefix at its
        manifest-pinned generation — an aliased shard's bytes live
        under the source prefix, not its own."""
        if self.leases is None:
            return
        idx = self._index
        fresh = [self.leases.acquire(idx.prefix, idx.generation)]
        if isinstance(idx, ShardedIndex):
            fresh += [self.leases.acquire(sh.prefix, sh.generation)
                      for sh in idx.shards if sh is not None]
            fresh += [self.leases.acquire(src.prefix, src.generation)
                      for aliases in idx.alias_sources
                      for src, _slots in aliases]
        old, self._held = self._held, fresh
        for lease in old:
            lease.release()

    # ------------------------------------------------------------ lifecycle
    @property
    def index(self) -> Index | ShardedIndex:
        return self._index

    @property
    def generation(self):
        return self._index.generation

    def _reader_pin(self):
        """The visibility state a freshly opened searcher would pin —
        `(generation, nrt_seq)` for an `Index`, `(reader_generation,
        per-shard nrt_seqs)` for a `ShardedIndex` (shards commit
        independently). The NRT sequence numbers (index/nrt.py) make a
        memory-segment add/retract — same durable generation, different
        visible document set — a distinct pin, so result caches and
        swap decisions treat it like any other generation change."""
        idx = self._index
        if isinstance(idx, ShardedIndex):
            return (idx.reader_generation, idx.nrt_seq)
        return (idx.generation, idx.nrt_seq)

    def refresh(self) -> bool:
        """Pick up the index's current visibility state (after a
        writer's commit/merge/add). Returns True when a new snapshot was
        opened. Cache entries of the old snapshot become unreachable
        (keys are pin-qualified) and age out of the LRUs. Cheap no-op
        when nothing changed: one LIST, zero range reads, no reopen."""
        self._index.refresh()
        if self._reader_pin() == self._pin:
            return False
        self._open_searcher()
        return True

    def follow(self, bus) -> "SearchService":
        """Swap on push instead of poll: `refresh()` whenever `bus`
        (serving/notify.py GenerationBus) delivers a visibility event.
        An event for an unrelated prefix costs one no-op refresh. On a
        threaded bus the swap runs on the delivery thread — front the
        service with `Frontend.follow` when queries run concurrently,
        which defers the swap to a batch boundary. Returns self."""
        self._subscription = bus.subscribe(lambda _event: self.refresh())
        return self

    @property
    def cache_hits(self) -> int:
        return self.stats.cache_hits

    def close(self) -> None:
        """Release the index handle's transport (worker pools), any bus
        subscription, and every held lease."""
        if self._subscription is not None:
            self._subscription.cancel()
            self._subscription = None
        for lease in self._held:
            lease.release()
        self._held = []
        if hasattr(self.searcher, "close"):
            self.searcher.close()
        self._index.close()

    # ------------------------------------------------------------ internals
    def _cache_key(self, query, top_k):
        # keyed by the pin captured when the serving searcher opened —
        # NOT the Index handle's live state, which a shared writer may
        # have bumped ahead of refresh(); results cached between a
        # commit and a refresh() must stay filed under the snapshot that
        # produced them. Query trees key by their NORMALIZED form, so
        # equivalent spellings — `a AND (b AND c)` vs `a b c`,
        # `-(x OR y)` vs `NOT x NOT y` — share one cache entry.
        if isinstance(query, Query):
            query = normalize(query)
        return (self._pin, query, top_k)

    def _cache_get(self, key):
        if self._cache is None:
            return None
        hit = self._cache.get(key)
        # mirror the LRU's own counters into the latency report
        self.stats.cache_lookups += 1
        if hit is not None:
            self.stats.cache_hits += 1
        return hit

    def _cache_put(self, key, result) -> None:
        if self._cache is not None:
            self._cache.put(key, result)

    def _observe_scatter(self) -> None:
        """After a cluster-backed round, fold the searcher's
        `last_scatter` per-shard accounting into the latency stats
        (single-index searchers expose no scatter report)."""
        report = getattr(self.searcher, "last_scatter", None)
        if report is not None:
            self.stats.observe_scatter(report)

    # -------------------------------------------------------------- serving
    def search(self, query: Query | str, top_k: int | None = None):
        """Serve one query: any query-language tree (Term/And/Or/Not/
        Phrase/Regex) or query text for `parse`."""
        if isinstance(query, str):
            query = parse(query)
        key = self._cache_key(query, top_k)
        hit = self._cache_get(key)
        if hit is not None:
            return hit
        result = self.searcher.query(query, top_k=top_k, hedge=self.hedge)
        self.stats.observe(result.stats)
        self._observe_scatter()
        self._cache_put(key, result)
        return result

    def search_regex(self, pattern: str, ngram: int = 3,
                     top_k: int | None = None):
        """Removed shim (escalated from DeprecationWarning): regex is a
        first-class query node — use `search(Regex(pattern, ngram))`.
        With `REPRO_ALLOW_DEPRECATED=1` the shim still routes through
        the same planner path (shared result cache, top_k)."""
        deprecated_call(
            "SearchService.search_regex was removed",
            "use search(Regex(pattern, ngram))")
        return self.search(Regex(pattern, ngram), top_k=top_k)

    def search_batch(self, queries, top_k: int | None = None,
                     batched: bool = True, impl: str = "bitmap"):
        """Serve a batch of queries (Query trees, strings, or `Regex`).

        `batched=True` plans and fetches the whole batch together — two
        shared rounds of range reads for all N queries; duplicate
        queries (same normalized cache key) are planned/fetched ONCE and
        the single result fans back out to every occurrence.
        `batched=False` is the serial per-query loop, kept for
        comparison benchmarks. Results are identical either way; only
        latency and request count differ. `impl="bitmap"` (the default)
        combines on the index's device, `impl="sorted"` on the host.
        """
        if not batched:
            return [self.search(q, top_k=top_k) for q in queries]
        qs = [parse(q) if isinstance(q, str) else q for q in queries]
        results: list = [None] * len(qs)
        to_fetch: list = []                      # deduplicated cold queries
        pos_of: dict = {}                        # cache key -> to_fetch idx
        assign: list[tuple[int, int]] = []       # (result slot, to_fetch idx)
        for i, q in enumerate(qs):
            key = self._cache_key(q, top_k)
            hit = self._cache_get(key)
            if hit is not None:
                results[i] = hit
                continue
            pos = pos_of.get(key)
            if pos is None:
                pos = pos_of[key] = len(to_fetch)
                to_fetch.append(q)
            assign.append((i, pos))
        if to_fetch:
            batch = self.searcher.query_batch(
                to_fetch, top_k=top_k, hedge=self.hedge, impl=impl)
            # the whole batch shares its fetch rounds: ONE latency sample
            self.stats.observe_batch([res.stats for res in batch])
            self._observe_scatter()
            for key, pos in pos_of.items():
                self._cache_put(key, batch[pos])
            for i, pos in assign:
                results[i] = batch[pos]
        return results
