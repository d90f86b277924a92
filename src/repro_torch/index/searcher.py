"""Airphant Searcher (paper §III-C): initialize once, query in two rounds.

Initialization is a single header read; after that the MHT (hash seeds +
bin pointers) lives in memory. A query is:

  round 1 — ONE batch of concurrent range reads for all needed superposts
            (all layers of all query words, plus hedged extras §IV-G);
  intersect/combine in memory (no false negatives, ~F0 false positives);
  round 2 — ONE batch of concurrent range reads for candidate documents,
            then filter by actual content → perfect precision.

There is never a dependent read chain — that is the paper's whole thesis.

The engine is phase-split so a *batch* of queries scales with concurrency
instead of query count (docs/query_engine.md):

  plan   — every query's superpost pointers are gathered together, bins
           shared across words AND across queries are deduplicated;
  fetch  — near-adjacent ranges in the same block are coalesced into one
           spanning read (`fetch_plan`), an optional byte-bounded LRU
           `SuperpostCache` serves hot bins with zero network cost, and
           whatever remains goes out as ONE transport batch;
  decode — each unique superpost is decoded once and distributed to all
           queries that wanted it; combine/top-K/document filtering then
           run per query, with round-2 document reads again deduplicated,
           coalesced, and batched across the whole query batch.

`lookup`/`query` are the single-query views of the same three phases, so
serial and batched execution are result-identical by construction.

Queries arrive as trees of the composable query language (Term/And/Or/
Not/Phrase/Regex — docs/query_language.md); the logical→physical planner
(`index/planner.py`) lowers each tree to a lookup word set, a candidate
algebra, and a content verifier before the phases run. Classic
Term/And/Or and standalone-Regex shapes compile to the pre-planner jobs
bit-for-bit.

Since the lifecycle redesign (docs/index_lifecycle.md) the executor is
**multi-unit**: the same plan/fetch/decode pipeline fans one query batch
across several index units (a base index plus delta segments), sharing
the fetch rounds, then unions the per-unit results. A single-unit run is
bit-identical to the pre-lifecycle engine. All bytes move through a
`StorageTransport` (storage/transport.py) — the Searcher never touches a
concrete store; the legacy `Searcher(SimCloudStore, prefix)` constructor
survives as a deprecated shim over the transport adapter.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field, replace

import numpy as np

from ..compat import deprecated_call
from ..core.hashing import HashFamily, word_fingerprint
from ..core.sketch import intersect_sorted
from ..core.topk import sample_size
from ..data.corpus import DocRef
from ..storage.blobstore import RangeRequest
from ..storage.cache import SuperpostCache
from ..storage.simcloud import FetchStats, SimCloudStore
from ..storage.transport import (SimCloudTransport, StorageTransport,
                                 as_transport)
from . import codec
from .fetch_plan import coalesce_requests, slice_payloads
from .planner import (DocContent, Job as _Job,
                      _classic_matches as _matches, combine_planned,
                      make_job, plan_batch, regex_prefilter)
from .query import And, Or, Query, Regex, Term, query_words


@dataclass
class QueryStats:
    lookup: FetchStats = field(default_factory=FetchStats)
    docs: FetchStats = field(default_factory=FetchStats)
    n_candidates: int = 0
    n_false_positives: int = 0
    n_results: int = 0
    rounds: int = 0

    @property
    def total_s(self) -> float:
        return self.lookup.elapsed_s + self.docs.elapsed_s


@dataclass
class QueryResult:
    refs: list[DocRef]
    texts: list[str]
    stats: QueryStats


@dataclass
class BatchStats:
    """Whole-batch fetch accounting, each shared round counted ONCE.

    `execute_jobs` copies every shared fetch round's `FetchStats` into
    each member job's `QueryStats` (a job's latency IS the round it
    waited on), so summing per-job stats overcounts bytes and requests
    N-fold for an N-job batch. Callers that need the true wire totals —
    the serving tier's per-shard byte accounting — pass one of these
    through `query_batch(batch_stats=...)` instead."""

    lookup: FetchStats = field(default_factory=FetchStats)
    docs: FetchStats = field(default_factory=FetchStats)
    n_candidates: int = 0


def topk_order(keys: np.ndarray) -> np.ndarray:
    """Deterministic §IV-D sampling permutation over a candidate array.

    Seeded by the first (lowest) candidate key, so every path that holds
    the same candidate set — serial, batched, or the cluster-fused
    combine — draws the SAME permutation; the byte-identity guarantee
    between budgeted and unbudgeted top-K fetches rests on this being
    shared."""
    rng = np.random.default_rng(int(keys[0]) & 0xFFFF)
    return rng.permutation(len(keys))


@dataclass
class _LookupPlan:
    """Round-1 fetch plan: unique words -> unique superpost requests."""

    words: list[str]                      # first-appearance order
    word_reqs: dict[str, list[int]]       # word -> indices into `requests`
    requests: list[RangeRequest]          # deduplicated across the batch
    # requests that appear ONLY as §IV-G hedge layers (position >= L of
    # every word using them) — the only ones a hedged wait may abandon
    hedgeable: set[int] = field(default_factory=set)


@dataclass
class _Fetcher:
    """Shared fetch machinery: transport + cache + coalescing.

    One `_Fetcher` serves a whole reader — a lone `Searcher` or every
    unit of a multi-segment index — so cross-unit rounds share the same
    cache, coalescing policy, and (simulated) connections. `generation`
    qualifies every cache key: a committed writer bumps it, making
    pre-commit bytes unreachable (the stale-read guard)."""

    transport: StorageTransport
    cache: SuperpostCache | None = None
    coalesce_gap: int | None = 4096
    generation: int = 0

    def bind_telemetry(self, telemetry, prefix: str = "fetch",
                       ) -> "_Fetcher":
        """Export per-round fetch observations (latency, bytes, request
        and cache-hit counts) into a metrics registry — duck-typed
        `serving.telemetry.Telemetry`, so the index layer needs no
        serving import. The control plane reads these to see what a
        round *currently* costs. Returns self."""
        self._metrics = {
            "round_s": telemetry.histogram(f"{prefix}.round_s"),
            "bytes": telemetry.counter(f"{prefix}.bytes"),
            "requests": telemetry.counter(f"{prefix}.requests"),
            "cache_hits": telemetry.counter(f"{prefix}.cache_hits"),
        }
        return self

    def fetch_ranges(self, requests: list[RangeRequest], *,
                     hedge: bool = False,
                     hedgeable: set[int] | None = None,
                     use_cache: bool = False,
                     ) -> tuple[list[bytes | None], FetchStats]:
        """One batched round: cache → coalesce → fetch → slice.

        Hedging needs per-request completion granularity, so a hedged
        round skips coalescing; cached payloads never hit the network
        either way. `hedgeable` are the request indices a hedged wait is
        allowed to abandon — the budget is counted over the actual miss
        set, so a warm cache never causes non-hedge layers to be dropped.
        """
        stats = FetchStats()
        payloads: list[bytes | None] = [None] * len(requests)
        miss_idx: list[int] = []
        cache = self.cache if use_cache else None
        if cache is not None:
            for i, r in enumerate(requests):
                p = cache.get(r.blob, r.offset, r.length, self.generation) \
                    if r.length >= 0 else None
                if p is None:
                    miss_idx.append(i)
                else:
                    payloads[i] = p
                    stats.cache_hits += 1
                    stats.cache_bytes_saved += len(p)
        else:
            miss_idx = list(range(len(requests)))

        miss = [requests[i] for i in miss_idx]
        if miss:
            n_hedgeable = len((hedgeable or set()) & set(miss_idx)) \
                if hedge else 0
            if n_hedgeable:      # nothing to abandon -> coalesce instead
                wait_for = max(1, len(miss) - n_hedgeable)
                got, fstats = self.transport.fetch_batch(miss,
                                                         wait_for=wait_for)
            elif self.coalesce_gap is not None:
                merged, slices = coalesce_requests(miss, self.coalesce_gap)
                merged_payloads, fstats = self.transport.fetch_batch(merged)
                got = slice_payloads(miss, merged_payloads, slices)
            else:
                got, fstats = self.transport.fetch_batch(miss)
            stats.add(fstats)
            for i, p in zip(miss_idx, got):
                payloads[i] = p
                if p is not None and cache is not None \
                        and requests[i].length >= 0:
                    cache.put(requests[i].blob, requests[i].offset,
                              requests[i].length, p, self.generation)
        m = getattr(self, "_metrics", None)
        if m is not None:
            if miss:
                m["round_s"].observe(float(stats.elapsed_s))
            m["bytes"].inc(int(stats.bytes_fetched))
            m["requests"].inc(int(stats.n_requests))
            m["cache_hits"].inc(int(stats.cache_hits))
        return payloads, stats


class Searcher:
    """One index unit: opens its header, answers queries in two fetch
    rounds.

    Only `query_batch` reaches the card: its default `impl="bitmap"`
    combines candidates with the CUDA kernels on `device`. `query` and
    `regex_query` run the reference's `impl="sorted"` NumPy path on the
    host, whatever `device` is."""

    # Optional served-document predicate (DocRef -> bool). When set, the
    # unit serves only the refs the predicate admits: candidates are
    # dropped immediately after round-1 combine — before sampling
    # budgets, round-2 fetches, and candidate counts — so a filtered
    # unit is byte-identical to an index that only ever contained the
    # admitted documents. The serving tier uses this to alias a shard's
    # slot-subset of another shard's immutable blobs (serving/cluster.py
    # "aliased generations").
    ref_filter = None

    def __init__(self, source, prefix: str,
                 cache: SuperpostCache | None = None,
                 coalesce_gap: int | None = 4096,
                 generation: int = 0,
                 header: bytes | None = None,
                 device="cuda") -> None:
        from ..kernels.intersect import resolve_device

        # where `impl="bitmap"` combines run: the CUDA kernels on a card,
        # the plain PyTorch versions on "cpu"; "cuda" with no card raises
        self.device = resolve_device(device)
        if isinstance(source, SimCloudStore):
            # escalated from DeprecationWarning (compat.py): raises
            # unless REPRO_ALLOW_DEPRECATED=1 restores the old shim
            deprecated_call(
                "Searcher(SimCloudStore, prefix) was removed",
                "pass a StorageTransport (storage.as_transport / "
                "SimCloudTransport) or use "
                "Index.open(store, prefix).searcher()")
        transport = as_transport(source)
        self.transport = transport
        self.prefix = prefix
        self._fetcher = _Fetcher(transport, cache, coalesce_gap,
                                 int(generation))
        # --- initialization: ONE read of the header block (skipped when
        # the lifecycle pre-fetched all units' headers in one batch) ----
        if header is None:
            header, self.init_stats = transport.fetch(
                RangeRequest(f"{prefix}/header.airp"))
        else:
            self.init_stats = FetchStats()
        hdr = codec.decode_header(header)
        self.spec = hdr["spec"]
        self.L = int(self.spec["L"])
        self.L_total = int(self.spec["L_total"])
        self.bins_per_layer = int(self.spec["bins_per_layer"])
        self.hashes = HashFamily.from_dict(hdr["hashes"])
        self.string_table: list[str] = list(hdr["string_table"])
        self.blocks: list[str] = list(hdr["blocks"])
        self.pointers = codec.unpack_pointers(hdr["bin_pointers"])
        common_ptrs = codec.unpack_pointers(hdr["common_pointers"])
        self.common: dict[int, codec.BinPointer] = {
            int(fp): p for fp, p in zip(hdr["common_fps"], common_ptrs)}
        self.profile = hdr["profile"]
        self.F0 = float(self.profile.get("F0", 1.0))
        # n-gram size the index was built with: 0 = no n-gram postings,
        # None = unknown (header predates the field). The planner raises
        # GramlessIndexError when a gramful regex hits a known-gramless
        # or mismatched-n unit.
        raw_ngrams = self.profile.get("index_ngrams")
        self.ngram_n: int | None = \
            None if raw_ngrams is None else int(raw_ngrams)

    def bind_telemetry(self, telemetry, prefix: str = "fetch",
                       ) -> "Searcher":
        """Export this reader's fetch rounds (latency, bytes) and its
        transport's traffic into a metrics registry. Returns self."""
        self._fetcher.bind_telemetry(telemetry, prefix)
        self.transport.bind_telemetry(telemetry, f"{prefix}.transport")
        return self

    # fetch knobs live in ONE place — the _Fetcher every round goes
    # through — so post-construction mutation keeps taking effect
    @property
    def cache(self) -> SuperpostCache | None:
        return self._fetcher.cache

    @cache.setter
    def cache(self, value: SuperpostCache | None) -> None:
        self._fetcher.cache = value

    @property
    def coalesce_gap(self) -> int | None:
        return self._fetcher.coalesce_gap

    @coalesce_gap.setter
    def coalesce_gap(self, value: int | None) -> None:
        self._fetcher.coalesce_gap = value

    @property
    def generation(self) -> int:
        return self._fetcher.generation

    @generation.setter
    def generation(self, value: int) -> None:
        self._fetcher.generation = int(value)

    # ------------------------------------------------------------- pointers
    def _pointers_for_word(self, word: str) -> tuple[list[codec.BinPointer], bool]:
        """(superpost pointers, is_common). Common words need ONE pointer."""
        fp = word_fingerprint(word)
        if fp in self.common:
            return [self.common[fp]], True
        bins = self.hashes.bins_for_word(word)          # (L_total,)
        return [self.pointers[l * self.bins_per_layer + int(bins[l])]
                for l in range(self.L_total)], False

    def _request(self, ptr: codec.BinPointer) -> RangeRequest:
        return RangeRequest(self.blocks[ptr.block], ptr.offset, ptr.length)

    # ----------------------------------------------------------- phase: plan
    def _plan_words(self, word_lists: list[list[str]]) -> _LookupPlan:
        """Merge all queries' words into one deduplicated request list."""
        plan = _LookupPlan(words=[], word_reqs={}, requests=[])
        req_index: dict[codec.BinPointer, int] = {}
        required: set[int] = set()
        for wl in word_lists:
            for w in wl:
                if w in plan.word_reqs:
                    continue
                ptrs, is_common = self._pointers_for_word(w)
                idxs = []
                for p in ptrs:
                    if p not in req_index:
                        req_index[p] = len(plan.requests)
                        plan.requests.append(self._request(p))
                    idxs.append(req_index[p])
                if is_common:
                    required.update(idxs)
                else:
                    required.update(idxs[:self.L])
                    plan.hedgeable.update(idxs[self.L:])
                plan.words.append(w)
                plan.word_reqs[w] = idxs
        plan.hedgeable -= required      # shared with a non-hedge layer
        return plan

    # ---------------------------------------------------------- phase: fetch
    def _fetch_ranges(self, requests: list[RangeRequest], *,
                      hedge: bool = False,
                      hedgeable: set[int] | None = None,
                      use_cache: bool = False,
                      ) -> tuple[list[bytes | None], FetchStats]:
        return self._fetcher.fetch_ranges(
            requests, hedge=hedge, hedgeable=hedgeable, use_cache=use_cache)

    # ---------------------------------------------------------------- lookup
    def lookup(self, q: Query | str, hedge: bool = False,
               ) -> tuple[dict[str, tuple[np.ndarray, np.ndarray]], QueryStats]:
        """Term-index lookup: candidate postings per query word.

        One batch of concurrent reads covers every word's layers. With
        `hedge=True` (and an index built with hedge_layers > 0) we issue
        all L_total requests but only wait for the fastest L per word
        (§IV-G built-in replication; exact for single-term queries,
        batch-approximate for multi-term ones).
        """
        q = Term(q) if isinstance(q, str) else q
        outs, stats = self.lookup_batch([q], hedge=hedge)
        return outs[0], stats

    def lookup_batch(self, queries: list[Query | str], hedge: bool = False,
                     ) -> tuple[list[dict[str, tuple[np.ndarray, np.ndarray]]],
                                QueryStats]:
        """Round 1 for a whole batch: plan together, fetch once, decode once.

        Bins shared across words and across queries are fetched (and
        decoded) exactly once; near-adjacent bins in the same block ride
        one coalesced range read.
        """
        outs_per_unit, stats = lookup_units([self], queries, self._fetcher,
                                            hedge=hedge)
        return outs_per_unit[0], stats

    # ----------------------------------------------------------------- query
    def query(self, q: Query | str, top_k: int | None = None,
              hedge: bool = False, delta: float = 1e-6,
              fetch_documents: bool = True) -> QueryResult:
        q = Term(q) if isinstance(q, str) else q
        job = make_job(q, top_k=top_k, delta=delta,
                       fetch_documents=fetch_documents, units=(self,))
        return self._execute_jobs([job], hedge=hedge)[0]

    def query_batch(self, queries: list[Query | str],
                    top_k: int | None = None, hedge: bool = False,
                    impl: str = "bitmap",
                    batch_stats: BatchStats | None = None,
                    ) -> list[QueryResult]:
        """Execute a whole batch of queries in two shared fetch rounds.

        Accepts any query-language tree (Term/And/Or/Not/Phrase/Regex,
        composed freely — see docs/query_language.md) plus raw strings
        (single terms). Every query goes through the logical→physical
        planner (`index/planner.py`); classic Term/And/Or and standalone
        Regex shapes compile to exactly the pre-planner jobs, so their
        requests and results stay byte-identical. Results equal per-query
        `query`; only the (simulated) latency and request count differ.
        With `impl="bitmap"` (the default), candidate combines run
        through the batched kernels (`kernels/intersect`) on the
        searcher's `device`; `impl="sorted"` runs NumPy set ops.
        """
        jobs = plan_batch(queries, units=(self,), top_k=top_k)
        return self._execute_jobs(jobs, hedge=hedge, impl=impl,
                                  batch_stats=batch_stats)

    def _execute_jobs(self, jobs: list[_Job], hedge: bool = False,
                      impl: str = "sorted",
                      batch_stats: BatchStats | None = None,
                      ) -> list[QueryResult]:
        return execute_jobs([self], jobs, self._fetcher,
                            hedge=hedge, impl=impl,
                            batch_stats=batch_stats)

    def regex_query(self, pattern: str, ngram: int = 3) -> QueryResult:
        """RegEx search via n-gram prefilter (paper §IV-F).

        The sketch's AND over the pattern's literal n-grams yields a
        candidate superset (no false negatives); fetched documents are
        then matched against the real regex — superpost false positives
        never affect correctness.
        """
        return self._execute_jobs(
            [make_job(Regex(pattern, ngram), units=(self,))])[0]

    # ----------------------------------------------------------------- utils
    def _refs(self, keys: np.ndarray, lengths: np.ndarray) -> list[DocRef]:
        blob_keys, offsets = codec.split_posting_key(keys)
        return [DocRef(self.string_table[int(b)], int(o), int(n))
                for b, o, n in zip(blob_keys, offsets, lengths)]


# =================================================================== executor
# The phases below operate on a LIST of units (Searchers over a base
# index and its delta segments) sharing one `_Fetcher`: every unit's
# requests ride the same fetch rounds, then per-unit results are
# unioned. With one unit this is exactly the classic engine — request
# order, RNG draws, and payloads are bit-identical.

def _filter_unit_candidates(unit: Searcher, keys: np.ndarray,
                            lengths: np.ndarray,
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Drop round-1 candidates the unit's `ref_filter` does not serve.

    Applied before sampling budgets and round-2 fetches so every
    downstream decision (sample sizes, RNG permutation seeds, fetch
    legs) sees exactly the candidate set an equivalent physical index
    would produce — the core of the aliased-shard byte-identity
    invariant (serving/cluster.py)."""
    filt = getattr(unit, "ref_filter", None)
    if filt is None or not len(keys):
        return keys, lengths
    mask = np.fromiter((filt(r) for r in unit._refs(keys, lengths)),
                       dtype=bool, count=len(keys))
    return keys[mask], lengths[mask]

def lookup_units(units: list[Searcher], queries: list[Query | str],
                 fetcher: _Fetcher, hedge: bool = False,
                 ) -> tuple[list[list[dict[str, tuple[np.ndarray, np.ndarray]]]],
                            QueryStats]:
    """Round 1 across units: plan everything, ONE shared fetch, decode once.

    Returns `(outs_per_unit, stats)` where `outs_per_unit[u][q]` maps each
    of query q's words to its candidate `(keys, lengths)` in unit u.
    """
    qs = [Term(q) if isinstance(q, str) else q for q in queries]
    word_lists = [query_words(q) for q in qs]
    stats = QueryStats()
    plans = [u._plan_words(word_lists) for u in units]
    requests: list[RangeRequest] = []
    hedgeable: set[int] = set()
    bases: list[int] = []
    local: dict[int, bytes] = {}
    for unit, plan in zip(units, plans):
        base = len(requests)
        bases.append(base)
        requests.extend(plan.requests)
        resolve = getattr(unit, "resolve_local", None)
        if resolve is not None:
            # memory-resident unit (index/nrt.py): its superposts never
            # touch the wire — answered synchronously from process memory,
            # excluded from the shared fetch round and from hedging
            for i, req in enumerate(plan.requests):
                local[base + i] = resolve(req)
        else:
            hedgeable.update(i + base for i in plan.hedgeable)
    if local:
        net = [i for i in range(len(requests)) if i not in local]
        net_payloads, fstats = fetcher.fetch_ranges(
            [requests[i] for i in net], hedge=hedge,
            hedgeable={k for k, i in enumerate(net) if i in hedgeable},
            use_cache=True)
        payloads = [None] * len(requests)
        for k, i in enumerate(net):
            payloads[i] = net_payloads[k]
        for i, p in local.items():
            payloads[i] = p
    else:
        # no memory units: the exact pre-NRT single-batch path
        payloads, fstats = fetcher.fetch_ranges(
            requests, hedge=hedge, hedgeable=hedgeable, use_cache=True)
    stats.lookup = fstats
    stats.rounds += 1

    # hedging must keep >= 1 layer per word per unit: re-fetch (in ONE
    # batch) the first layer of any word whose every request was abandoned
    missing: list[int] = []
    for plan, base in zip(plans, bases):
        missing.extend(base + plan.word_reqs[w][0] for w in plan.words
                       if all(payloads[base + i] is None
                              for i in plan.word_reqs[w]))
    if missing:
        fb, extra = fetcher.transport.fetch_batch(
            [requests[i] for i in missing])
        stats.lookup.add(extra)
        for i, p in zip(missing, fb):
            payloads[i] = p

    # --- phase: decode (each unique superpost exactly once) -------------
    outs_per_unit: list[list[dict[str, tuple[np.ndarray, np.ndarray]]]] = []
    n_candidates = 0
    for plan, base in zip(plans, bases):
        decoded: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        word_out: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        for w in plan.words:
            posts = []
            for i in plan.word_reqs[w]:
                if payloads[base + i] is None:   # hedged-away straggler
                    continue
                if i not in decoded:
                    decoded[i] = codec.decode_superpost(payloads[base + i])
                posts.append(decoded[i])
            keys = intersect_sorted([k for k, _len in posts])
            # recover lengths from whichever layer, via searchsorted
            k0, l0 = posts[0]
            lengths = l0[np.searchsorted(k0, keys)]
            word_out[w] = (keys, lengths)
        outs = [{w: word_out[w] for w in wl} for wl in word_lists]
        n_candidates += int(
            sum(len(k) for d in outs for k, _ in d.values()))
        outs_per_unit.append(outs)
    stats.n_candidates = n_candidates
    return outs_per_unit, stats


def execute_jobs(units: list[Searcher], jobs: list[_Job], fetcher: _Fetcher,
                 hedge: bool = False, impl: str = "sorted",
                 batch_stats: BatchStats | None = None,
                 ) -> list[QueryResult]:
    """Run a job batch over base + segments in two shared fetch rounds."""
    n_units = len(units)
    outs_per_unit, lstats = lookup_units(
        units, [j.lookup_q for j in jobs], fetcher, hedge=hedge)
    if batch_stats is not None:
        batch_stats.lookup.add(lstats.lookup)
    combined = [_combine_jobs(jobs, outs, impl, unit)
                for unit, outs in zip(units, outs_per_unit)]
    for u, unit in enumerate(units):
        if getattr(unit, "ref_filter", None) is not None:
            combined[u] = [_filter_unit_candidates(unit, k, le)
                           for k, le in combined[u]]

    results: list[QueryResult | None] = [None] * len(jobs)
    stats_of = [QueryStats(lookup=replace(lstats.lookup), rounds=1)
                for _ in jobs]

    # --- top-K sampling (§IV-D, Eq. 6) per (unit, job) ------------------
    sampled: list[list[tuple[np.ndarray, np.ndarray]]] = \
        [[None] * len(jobs) for _ in units]    # type: ignore[list-item]
    orders: list[list[np.ndarray]] = \
        [[None] * len(jobs) for _ in units]    # type: ignore[list-item]
    wants: list[int] = [0] * len(jobs)
    for j, job in enumerate(jobs):
        total = sum(len(combined[u][j][0]) for u in range(n_units))
        stats_of[j].n_candidates = total
        if batch_stats is not None:
            batch_stats.n_candidates += total
        want = total
        if job.top_k is not None and total:
            want = job.top_k
        wants[j] = want
        for u, unit in enumerate(units):
            keys, lengths = combined[u][j]
            order = np.arange(len(keys))
            if job.top_k is not None and len(keys):
                rk = sample_size(len(keys), job.top_k, unit.F0, job.delta)
                order = topk_order(keys)
                sampled[u][j] = (keys[order[:rk]], lengths[order[:rk]])
            else:
                sampled[u][j] = (keys, lengths)
            orders[u][j] = order
        if not job.fetch_documents:
            refs, _texts = _merge_results(
                [units[u]._refs(*combined[u][j]) for u in range(n_units)],
                None, already_merged=n_units == 1,
                sort=job.top_k is None)
            results[j] = QueryResult(refs=refs, texts=[],
                                     stats=stats_of[j])

    # --- round 2: ONE deduplicated+coalesced batch for all units+jobs ---
    live = [j for j in range(len(jobs)) if results[j] is None]
    unit_job_refs = [{j: units[u]._refs(*sampled[u][j]) for j in live}
                     for u in range(n_units)]
    batch_docs = batch_stats.docs if batch_stats is not None else None
    texts_of, refs_of = _fetch_and_filter_units(
        units, jobs, unit_job_refs, stats_of, fetcher,
        batch_docs=batch_docs)

    # --- Eq. 6 failure (prob < delta) or tiny candidate set: fall back
    # to fetching the remainder — again ONE batch for every unit of every
    # job that came up short.
    fallback: list[dict[int, list[DocRef]]] = [{} for _ in units]
    if any(jobs[j].top_k is not None for j in live):
        for j in live:
            if jobs[j].top_k is None:
                continue
            # count unique doc identities — a doc accepted by several
            # units (duplicate append) merges to ONE result, so a per-
            # unit sum could skip a fallback the deduped set still needs
            accepted = len({(r.blob, r.offset, r.length)
                            for u in range(n_units)
                            for r in refs_of[u][j]})
            if accepted >= wants[j]:
                continue
            for u in range(n_units):
                keys, lengths = combined[u][j]
                n_sampled = len(sampled[u][j][0])
                if len(keys) > n_sampled:
                    rest = orders[u][j][n_sampled:]
                    fallback[u][j] = units[u]._refs(keys[rest],
                                                    lengths[rest])
    if any(fallback):
        t2, r2 = _fetch_and_filter_units(units, jobs, fallback, stats_of,
                                         fetcher, batch_docs=batch_docs)
        for u in range(n_units):
            for j in fallback[u]:
                texts_of[u][j] += t2[u][j]
                refs_of[u][j] += r2[u][j]

    # --- union per job across units (dedupe doc identity; non-top-K
    # results restored to the monolithic (blob, offset) order) -----------
    for j in live:
        refs, texts = _merge_results(
            [refs_of[u][j] for u in range(n_units)],
            [texts_of[u][j] for u in range(n_units)],
            already_merged=n_units == 1,
            sort=jobs[j].top_k is None)
        if jobs[j].top_k is not None:
            texts, refs = texts[:wants[j]], refs[:wants[j]]
        stats_of[j].n_results = len(texts)
        results[j] = QueryResult(refs=refs, texts=texts,
                                 stats=stats_of[j])
    return results  # type: ignore[return-value]


def _merge_results(refs_lists: list[list[DocRef]],
                   texts_lists: list[list[str]] | None,
                   already_merged: bool, sort: bool,
                   ) -> tuple[list[DocRef], list[str]]:
    """Union per-unit results into one list.

    Documents are deduplicated by (blob, offset, length) identity — a doc
    appended twice is indexed in two units but is one result, matching a
    monolithic rebuild where duplicate posting keys collapse. `sort`
    restores ascending (blob, offset), the order a monolithic index emits
    (its posting keys are blob_key<<40|offset with blob keys assigned in
    sorted-name order); sampled top-K results keep unit-major order.
    """
    if already_merged:       # single unit: preserve the classic path as-is
        refs = refs_lists[0]
        return refs, (texts_lists[0] if texts_lists is not None else [])
    seen: set[tuple[str, int, int]] = set()
    refs: list[DocRef] = []
    texts: list[str] = []
    for u, rl in enumerate(refs_lists):
        tl = texts_lists[u] if texts_lists is not None else [""] * len(rl)
        for r, t in zip(rl, tl):
            key = (r.blob, r.offset, r.length)
            if key in seen:
                continue
            seen.add(key)
            refs.append(r)
            texts.append(t)
    if sort:
        order = sorted(range(len(refs)),
                       key=lambda i: (refs[i].blob, refs[i].offset))
        refs = [refs[i] for i in order]
        texts = [texts[i] for i in order]
    return refs, (texts if texts_lists is not None else [])


def _fetch_and_filter_units(units: list[Searcher], jobs: list[_Job],
                            unit_job_refs: list[dict[int, list[DocRef]]],
                            stats_of: list[QueryStats], fetcher: _Fetcher,
                            batch_docs: FetchStats | None = None,
                            ) -> tuple[list[dict[int, list[str]]],
                                       list[dict[int, list[DocRef]]]]:
    """Round 2 for many jobs across units: documents wanted by several
    queries (or several units) are fetched once; ranges are coalesced;
    false positives filtered per job by its own acceptance predicate."""
    uniq: dict[tuple[str, int, int], int] = {}
    requests: list[RangeRequest] = []
    for refs_by_job in unit_job_refs:
        for j in sorted(refs_by_job):
            for r in refs_by_job[j]:
                key = (r.blob, r.offset, r.length)
                if key not in uniq:
                    uniq[key] = len(requests)
                    requests.append(RangeRequest(r.blob, r.offset, r.length))
    texts_of = [{j: [] for j in refs_by_job}
                for refs_by_job in unit_job_refs]
    refs_of = [{j: [] for j in refs_by_job}
               for refs_by_job in unit_job_refs]
    if not requests:
        return texts_of, refs_of
    payloads, fstats = fetcher.fetch_ranges(requests)
    if batch_docs is not None:
        batch_docs.add(fstats)
    # a job's doc round is accounted once, no matter how many units fed it
    rounds_jobs = sorted({j for refs_by_job in unit_job_refs
                          for j, refs in refs_by_job.items() if refs})
    for j in rounds_jobs:
        stats_of[j].docs.add(fstats)
        stats_of[j].rounds += 1
    # decode-once: a document wanted by several queries is utf-8
    # decoded (and tokenized, for word/content filters) a single time —
    # one DocContent serves classic word filters and planner verifiers
    texts_u: list[str | None] = [None] * len(requests)
    content_u: list[DocContent | None] = [None] * len(requests)
    # a doc indexed by several units is ONE false positive for a job, as
    # it would be in a monolithic rebuild — dedupe rejections by identity
    rejected: dict[int, set[int]] = {}
    for u, refs_by_job in enumerate(unit_job_refs):
        for j, refs in refs_by_job.items():
            if not refs:         # done after round 1 — no doc round for it
                continue
            job = jobs[j]
            for ref in refs:
                i = uniq[(ref.blob, ref.offset, ref.length)]
                if texts_u[i] is None:
                    payload = payloads[i]
                    assert payload is not None
                    texts_u[i] = payload.decode("utf-8")
                text = texts_u[i]
                if job.accept_text is not None:
                    ok = job.accept_text(text)
                else:
                    if content_u[i] is None:
                        content_u[i] = DocContent(text)
                    if job.accept_doc is not None:
                        ok = job.accept_doc(content_u[i])
                    else:
                        ok = job.accept_words(content_u[i].words)
                if ok:
                    texts_of[u][j].append(text)
                    refs_of[u][j].append(ref)
                elif i not in rejected.setdefault(j, set()):
                    rejected[j].add(i)
                    stats_of[j].n_false_positives += 1
    return texts_of, refs_of


# ----------------------------------------------------------- combine
def _combine_jobs(jobs: list[_Job],
                  per_word_list: list[dict],
                  impl: str,
                  unit: "Searcher",
                  ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per-job candidate combine for one unit.

    Classic jobs run the ∪/∩ distribution (`impl="bitmap"` batches every
    multi-term AND through one `intersect_keys` call, with the results
    the pre-planner engine gave); planner-compiled jobs evaluate their
    candidate algebra — AND/OR plus exact-common-word ANDNOT — via
    `planner.combine_planned` (one `combine_keys` call for the whole
    planned set under `impl="bitmap"`). Launches run on the unit's
    `device`.
    """
    out: list[tuple[np.ndarray, np.ndarray] | None] = [None] * len(jobs)
    bitmap_jobs: list[int] = []
    planned_jobs: list[int] = []
    for j, (job, per_word) in enumerate(zip(jobs, per_word_list)):
        q = job.lookup_q
        if job.plan is not None:
            planned_jobs.append(j)
        elif impl == "bitmap" and isinstance(q, And) \
                and all(isinstance(s, Term) for s in q.items) \
                and len(per_word) >= 2:
            bitmap_jobs.append(j)
        else:
            out[j] = _combine(q, per_word)
    if bitmap_jobs:
        parts_list = [[per_word_list[j][w]
                       for w in query_words(jobs[j].lookup_q)]
                      for j in bitmap_jobs]
        for j, res in zip(bitmap_jobs,
                          _bitmap_and_batch(parts_list, unit.device)):
            out[j] = res
    if planned_jobs:
        is_common = lambda w: word_fingerprint(w) in unit.common  # noqa: E731
        results = combine_planned(
            [jobs[j].plan for j in planned_jobs],
            [per_word_list[j] for j in planned_jobs],
            is_common, impl=impl, device=unit.device)
        for j, res in zip(planned_jobs, results):
            out[j] = res
    return out  # type: ignore[return-value]


def _combine(q: Query, per_word: dict[str, tuple[np.ndarray, np.ndarray]],
             ) -> tuple[np.ndarray, np.ndarray]:
    """Distribute ∪/∩ over per-word candidates (paper §IV-F)."""
    if isinstance(q, Term):
        return per_word[q.word]
    parts = [_combine(sub, per_word) for sub in q.items]
    keys_list = [k for k, _l in parts]
    if isinstance(q, And):
        keys = intersect_sorted(keys_list)
    else:
        assert isinstance(q, Or)
        keys = np.unique(np.concatenate(keys_list)) if keys_list else \
            np.empty(0, np.uint64)
    # recover lengths from any part containing each key
    lengths = np.zeros(len(keys), dtype=np.uint64)
    for k, l in parts:
        idx = np.searchsorted(k, keys)
        idx = np.clip(idx, 0, max(len(k) - 1, 0))
        if len(k):
            hit = k[idx] == keys
            lengths[hit] = l[idx[hit]]
    return keys, lengths


def _bitmap_and_batch(parts_list: list[list[tuple[np.ndarray, np.ndarray]]],
                      device) -> list[tuple[np.ndarray, np.ndarray]]:
    """Batched multi-way AND on `device`, in ONE `intersect_keys` call.

    Every job's posting keys are ranked into one universe on the device
    (the batch's distinct word lists, shipped once); the kernels set the
    bits, AND each job's layers and read back its candidate keys, not
    its bitmap. Lengths come from the job's first word.
    """
    from ..kernels.intersect import intersect_keys, keys_per_row

    keys, counts = intersect_keys([[k for k, _l in parts]
                                   for parts in parts_list], device=device)
    out: list[tuple[np.ndarray, np.ndarray]] = []
    for parts, found in zip(parts_list, keys_per_row(keys, counts)):
        k0, l0 = parts[0]
        out.append((found, l0[np.searchsorted(k0, found)]))
    return out


