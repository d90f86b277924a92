"""Index lifecycle façade: build, open, append, commit, merge.

The paper's engine "builds, optimizes, and manages" indexes on cloud
storage (§III); this module is the public API for that management plane:

    index = Index.build(corpus, BuilderConfig(...), store, "idx/logs")
    index = Index.open(store, "idx/logs")            # from a blob prefix
    results = index.searcher().query_batch([...])    # read session
    w = index.writer()                               # write session
    w.append(more_corpus); w.commit()                # delta segment
    w.merge()                                        # compact to one base

Layout on the object store (all blobs immutable once visible):

    prefix/manifest-00000001.airm    versioned manifest, one per generation
    prefix/header.airp               base index (legacy layout, so the
    prefix/superposts-*.blk            pre-lifecycle Searcher still boots)
    prefix/seg-00000002-<tok>-0000/  delta segments (self-contained small
                                       sketches: own header + blocks; the
                                       token is unique per write session)
    prefix/base-00000003/...         merged bases (never overwrite a live
                                       generation's blobs)

The **manifest** is the unit of atomicity, Lucene `segments_N`-style: a
commit writes `manifest-<generation+1>` and readers resolve the current
index as the highest-numbered manifest under the prefix — writers never
block readers, readers never see a half-commit. The generation number
also keys every cache on the read path (`SuperpostCache`, the
`SearchService` result LRU), so a commit or merge can never serve
pre-commit bytes or results.

Readers over a segmented index fan one batch plan across base + segments
with shared fetch rounds (`MultiSegmentSearcher`, built on the searcher's
multi-unit executor) and union the per-unit results — query results over
base+segments are identical to a monolithic rebuild of the concatenated
corpus (enforced by tests/test_index_lifecycle.py).
"""

from __future__ import annotations

import time
import uuid
import warnings
from dataclasses import asdict, dataclass, field, replace

from ..compat import UngracedSweepError, deprecated_call
from ..data.corpus import Corpus, DocRef
from ..storage.blobstore import RangeRequest
from ..storage.cache import SuperpostCache
from ..storage.simcloud import FetchStats
from ..storage.transport import StorageTransport, as_transport
from . import _msgpack
from .builder import Builder, BuilderConfig, BuildReport
from .nrt import MemorySegment
from .planner import make_job, plan_batch
from .query import Query, Regex, Term
from .searcher import (QueryResult, Searcher, _Fetcher, execute_jobs,
                       lookup_units)

MANIFEST_MAGIC = b"AIRM"
MANIFEST_VERSION = 1


# ------------------------------------------------------------- manifest codec
def _manifest_name(prefix: str, generation: int) -> str:
    return f"{prefix}/manifest-{generation:08d}.airm"


def latest_generation(blobs, prefix: str, stem: str = "manifest") -> int:
    """Current committed generation under `prefix`: highest-numbered
    `{stem}-<gen>` blob (0 when none exist). Shared by index manifests and
    the serving tier's cluster manifests (serving/cluster.py)."""
    names = blobs.list(f"{prefix}/{stem}-")
    if not names:
        return 0
    # zero-padded generations sort lexicographically
    tail = max(names).rsplit(f"{stem}-", 1)[1]
    return int(tail.split(".")[0])


def publish_generation(blobs, name: str, payload: bytes,
                       generation: int, prefix: str) -> None:
    """Publish one generation blob with compare-and-swap semantics.

    `put_if_absent` is the linearization point: of two writers racing to
    publish the same generation number, exactly one creates the blob —
    the loser gets the same "concurrent writer" error the pre-publish
    generation check raises, never a silent overwrite.
    """
    if not blobs.put_if_absent(name, payload):
        raise RuntimeError(
            f"concurrent writer already published generation "
            f"{generation} of {prefix!r}; refresh and retry")


def _pack_refs(refs: list[DocRef]) -> dict:
    """Compact corpus map: blob-name string table + per-doc triples.

    The manifest carries each ingest's document refs so `merge()` can
    re-profile the concatenated corpus without a side channel.
    """
    blobs: list[str] = []
    blob_key: dict[str, int] = {}
    docs = []
    for r in refs:
        k = blob_key.get(r.blob)
        if k is None:
            k = blob_key[r.blob] = len(blobs)
            blobs.append(r.blob)
        docs.append((k, r.offset, r.length))
    return {"blobs": blobs, "docs": docs}


def _unpack_refs(packed: dict) -> list[DocRef]:
    blobs = packed["blobs"]
    return [DocRef(blobs[k], int(o), int(n)) for k, o, n in packed["docs"]]


def encode_manifest(manifest: dict) -> bytes:
    return MANIFEST_MAGIC + bytes([MANIFEST_VERSION]) + \
        _msgpack.packb(manifest)


def decode_manifest(data: bytes) -> dict:
    if data[:4] != MANIFEST_MAGIC:
        raise ValueError("not an Airphant index manifest")
    if data[4] != MANIFEST_VERSION:
        raise ValueError(
            f"manifest version {data[4]} != supported {MANIFEST_VERSION}")
    return _msgpack.unpackb(data[5:])


def _latest_generation(blobs, prefix: str) -> int:
    return latest_generation(blobs, prefix, stem="manifest")


def _publish(blobs, prefix: str, manifest: dict) -> None:
    generation = int(manifest["generation"])
    publish_generation(blobs, _manifest_name(prefix, generation),
                       encode_manifest(manifest), generation, prefix)


# ===================================================================== reader
class MultiSegmentSearcher:
    """Reader over a base index + delta segments.

    One plan/fetch/decode pipeline fans the whole query batch across
    every unit with **shared** fetch rounds (still two rounds total, not
    two per segment), then unions per-unit results and dedupes document
    identities — so readers never block on writers and a segmented index
    answers exactly like its monolithic rebuild. Mirrors the `Searcher`
    query surface (`query`, `query_batch`, `regex_query`). Raw lookups
    are exposed as `lookup_units`/`lookup_batch_units` — deliberately
    NOT named `lookup*`: per-unit posting keys index per-unit string
    tables and cannot be unioned into one `Searcher.lookup`-shaped dict,
    so the different shape carries a different name.
    """

    def __init__(self, units: list[Searcher], fetcher: _Fetcher,
                 init_stats: FetchStats | None = None) -> None:
        assert units, "need at least a base unit"
        self.units = units
        self._fetcher = fetcher
        if init_stats is None:
            init_stats = FetchStats()
            for u in units:
                init_stats.add(u.init_stats)
        self.init_stats = init_stats
        self.F0 = max(u.F0 for u in units)

    @property
    def n_units(self) -> int:
        return len(self.units)

    # live views into the shared fetcher, same as Searcher's properties —
    # post-construction mutation keeps taking effect
    @property
    def cache(self):
        return self._fetcher.cache

    @cache.setter
    def cache(self, value) -> None:
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

    # -- lookups ----------------------------------------------------------
    def lookup_batch_units(self, queries: list[Query | str],
                           hedge: bool = False):
        """Per-unit candidate postings: `outs[u][q][word] -> (keys, lens)`."""
        return lookup_units(self.units, queries, self._fetcher, hedge=hedge)

    def lookup_units(self, q: Query | str, hedge: bool = False):
        outs, stats = self.lookup_batch_units([q], hedge=hedge)
        return [per_unit[0] for per_unit in outs], stats

    # -- queries ----------------------------------------------------------
    def query(self, q: Query | str, top_k: int | None = None,
              hedge: bool = False, delta: float = 1e-6,
              fetch_documents: bool = True) -> QueryResult:
        q = Term(q) if isinstance(q, str) else q
        job = make_job(q, top_k=top_k, delta=delta,
                       fetch_documents=fetch_documents,
                       units=tuple(self.units))
        return execute_jobs(self.units, [job], self._fetcher,
                            hedge=hedge)[0]

    def query_batch(self, queries: list[Query | str],
                    top_k: int | None = None, hedge: bool = False,
                    impl: str = "bitmap",
                    batch_stats=None) -> list[QueryResult]:
        """`Searcher.query_batch` over every unit: under `impl="bitmap"`
        (the default) each unit combines on its own `device`."""
        jobs = plan_batch(queries, units=tuple(self.units), top_k=top_k)
        return execute_jobs(self.units, jobs, self._fetcher,
                            hedge=hedge, impl=impl,
                            batch_stats=batch_stats)

    def regex_query(self, pattern: str, ngram: int = 3) -> QueryResult:
        return execute_jobs(self.units,
                            [make_job(Regex(pattern, ngram),
                                      units=tuple(self.units))],
                            self._fetcher)[0]


# ===================================================================== handle
class Index:
    """Handle on one index prefix: owns the manifest, vends sessions.

    `searcher(...)` opens a read session pinned to this handle's
    generation; `writer()` opens a write session that stages delta
    segments. `refresh()` re-resolves the current generation (cheap: one
    LIST + at most one manifest read). `device` is where the searchers
    it vends combine under `impl="bitmap"` (their units, memory segments
    included).
    """

    def __init__(self, transport: StorageTransport, prefix: str,
                 manifest: dict, report: BuildReport | None = None,
                 owns_transport: bool = False, device="cuda") -> None:
        from ..kernels.intersect import resolve_device

        # "cuda" with no card raises here, before any session opens
        self.device = resolve_device(device)
        self.transport = transport
        self.prefix = prefix
        self._manifest = manifest
        self.report = report
        self._owns_transport = owns_transport
        # NRT state (index/nrt.py): memory-resident segments staged by an
        # IndexWriter.add() but not yet published, a sequence number that
        # bumps on every memory add/retract (so searcher pins can tell
        # "same generation, more memory docs" apart), a per-unit header
        # byte cache (a handle that just published a memory segment never
        # refetches the header bytes it built), and an optional
        # GenerationBus the write path posts visibility changes to.
        self._nrt: list[MemorySegment] = []
        self._nrt_seq = 0
        self._headers: dict[str, bytes] = {}
        self._bus = None

    # -- introspection ----------------------------------------------------
    @property
    def manifest(self) -> dict:
        return self._manifest

    @property
    def generation(self) -> int:
        return int(self._manifest["generation"])

    @property
    def base_prefix(self) -> str:
        return self._manifest["base"]["prefix"]

    @property
    def segment_prefixes(self) -> list[str]:
        return [s["prefix"] for s in self._manifest["segments"]]

    @property
    def n_segments(self) -> int:
        return len(self._manifest["segments"])

    @property
    def config(self) -> BuilderConfig | None:
        cfg = self._manifest.get("config")
        return BuilderConfig(**cfg) if cfg is not None else None

    @property
    def nrt_seq(self) -> int:
        """Bumps whenever the memory-resident segment set changes; a
        searcher pin over this handle is `(generation, nrt_seq)`."""
        return self._nrt_seq

    @property
    def memory_segments(self) -> list[MemorySegment]:
        """Memory-resident segments searchable now, publishable later."""
        return list(self._nrt)

    def attach_bus(self, bus) -> "Index":
        """Post visibility changes (memory adds, publishes) under this
        prefix to `bus` (serving/notify.py GenerationBus). Writers opened
        from this handle inherit it. Returns self for chaining."""
        self._bus = bus
        return self

    def _notify(self, kind: str) -> None:
        if self._bus is not None:
            self._bus.post_generation(prefix=self.prefix, kind=kind,
                                      generation=self.generation,
                                      seq=self._nrt_seq)

    def corpus_refs(self) -> list[DocRef]:
        """Every document ref this generation indexes (base + segments,
        in ingest order) — the manifest-recorded corpus map that `merge`
        re-profiles and the serving tier's `reshard` repartitions."""
        if self._manifest["base"]["corpus"] is None:
            raise ValueError(
                f"legacy index {self.prefix!r} has no corpus map; rebuild "
                "with Index.build(...) to enable merge/reshard")
        refs = _unpack_refs(self._manifest["base"]["corpus"])
        for seg in self._manifest["segments"]:
            refs += _unpack_refs(seg["corpus"])
        return refs

    def __repr__(self) -> str:
        return (f"Index(prefix={self.prefix!r}, "
                f"generation={self.generation}, "
                f"segments={self.n_segments})")

    def close(self) -> None:
        """Release the transport if this handle created it (a bare store
        was passed to build/open); a transport the caller supplied stays
        the caller's to close. Idempotent."""
        if self._owns_transport:
            self.transport.close()

    def __enter__(self) -> "Index":
        return self

    def __exit__(self, *_exc) -> None:
        self.close()

    # -- lifecycle --------------------------------------------------------
    @classmethod
    def build(cls, corpus: Corpus, config: BuilderConfig | None,
              store, prefix: str, device="cuda") -> "Index":
        """Build a base index at `prefix` and commit generation N+1.

        The base uses the legacy single-index layout (`header.airp` +
        superpost blocks at the prefix root), so the deprecated
        `Searcher(cloud, prefix)` constructor keeps booting from the same
        prefix. Rebuilding an existing prefix overwrites those base blobs
        in place — the bumped generation is what keeps caches of the old
        bytes unreachable.
        """
        from ..kernels.intersect import resolve_device

        device = resolve_device(device)     # raise before building
        owns = not isinstance(store, StorageTransport)
        transport = as_transport(store)
        cfg = config or BuilderConfig()
        report = Builder(cfg).build(corpus, transport.blobs, prefix)
        generation = _latest_generation(transport.blobs, prefix) + 1
        manifest = {
            "generation": generation,
            "base": {"prefix": prefix, "corpus": _pack_refs(corpus.refs)},
            "segments": [],
            "config": asdict(cfg),
        }
        # one CAS attempt, no retry: a competing builder has ALREADY
        # overwritten these base blobs in place, so claiming the next
        # generation slot would publish a corpus map for someone else's
        # bytes — erroring out is the only honest outcome of that race
        _publish(transport.blobs, prefix, manifest)
        return cls(transport, prefix, manifest, report=report,
                   owns_transport=owns, device=device)

    @classmethod
    def open(cls, store, prefix: str,
             generation: int | None = None, device="cuda") -> "Index":
        """Open the current generation of the index at `prefix`.

        One LIST resolves the newest manifest; one range read fetches it.
        A prefix holding only a legacy `header.airp` (built before the
        lifecycle existed) opens read-only as generation 0. Passing
        `generation` pins an older, still-uncollected generation instead
        (time-travel reads; `collect_garbage` keeps the latest K).
        """
        owns = not isinstance(store, StorageTransport)
        transport = as_transport(store)
        if generation is None:
            generation = _latest_generation(transport.blobs, prefix)
        if generation == 0:
            if not transport.blobs.exists(f"{prefix}/header.airp"):
                raise FileNotFoundError(
                    f"no manifest or header under {prefix!r}")
            manifest = {"generation": 0,
                        "base": {"prefix": prefix, "corpus": None},
                        "segments": [], "config": None}
            return cls(transport, prefix, manifest, owns_transport=owns,
                       device=device)
        data, _stats = transport.fetch(
            RangeRequest(_manifest_name(prefix, generation)))
        return cls(transport, prefix, decode_manifest(data),
                   owns_transport=owns, device=device)

    def refresh(self) -> "Index":
        """Re-resolve the current generation (after another writer's
        commit/merge); no-op when already current. Returns self."""
        generation = _latest_generation(self.transport.blobs, self.prefix)
        if generation not in (0, self.generation):
            data, _stats = self.transport.fetch(
                RangeRequest(_manifest_name(self.prefix, generation)))
            self._manifest = decode_manifest(data)
        return self

    # -- sessions ---------------------------------------------------------
    def searcher(self, cache: SuperpostCache | None = None,
                 coalesce_gap: int | None = 4096,
                 transport: StorageTransport | None = None,
                 ) -> Searcher | MultiSegmentSearcher:
        """Open a read session pinned to this generation.

        Boots with ONE batched fetch of every unit's header (base +
        segments — a parallel round, never a per-segment chain), all
        keyed to this generation in the optional shared `cache`. Returns
        a plain `Searcher` when there are no segments — byte-identical
        to the classic engine — and a `MultiSegmentSearcher` otherwise.
        `transport` overrides the handle's own data plane — how the
        serving tier (serving/cluster.py) reads one shard through several
        replica transports (different VMs / simulated clocks) while the
        handle keeps owning the control plane.
        """
        gen = self.generation
        data_plane = self.transport if transport is None else transport
        prefixes = [self.base_prefix] + self.segment_prefixes
        # header bytes are immutable per unit prefix, so this handle
        # caches them: a reopen after a push-notified swap (commit seeds
        # the cache with the bytes it just published) costs ZERO fetches
        missing = [p for p in prefixes if p not in self._headers]
        init_stats = FetchStats()
        if missing:
            payloads, init_stats = data_plane.fetch_batch(
                [RangeRequest(f"{p}/header.airp") for p in missing])
            for p, h in zip(missing, payloads):
                self._headers[p] = h
        units: list[Searcher] = [
            Searcher(data_plane, p, cache=cache,
                     coalesce_gap=coalesce_gap, generation=gen,
                     header=self._headers[p], device=self.device)
            for p in prefixes]
        # memory-resident segments (index/nrt.py) ride along as extra
        # units: searchable now, byte-identical once published
        units += self._nrt
        if len(units) == 1:
            units[0].init_stats = init_stats
            return units[0]
        return MultiSegmentSearcher(units, units[0]._fetcher,
                                    init_stats=init_stats)

    def writer(self) -> "IndexWriter":
        """Open a write session (stage segments, then commit/merge)."""
        return IndexWriter(self)


def open_many(transport: StorageTransport,
              prefixes: list[str],
              generations: list[int | None] | None = None,
              device="cuda") -> list[Index]:
    """Open several index prefixes with ONE batched manifest fetch.

    The serving tier (serving/cluster.py) boots N shards at once; N
    sequential `Index.open` calls would pay N dependent first-byte
    rounds on a medium where one parallel batch costs one. LISTs stay
    per-prefix (control plane, not latency-modelled); the manifest range
    reads ride a single `fetch_batch`. Legacy header-only prefixes fall
    back to the single-open path. Handles never own the transport.

    `generations` pins individual prefixes to a specific generation
    (None resolves latest as before).  Pinned entries skip the
    per-prefix LIST entirely — cluster manifests that alias immutable
    shard blobs (serving/cluster.py) record the generation they alias,
    so opening them costs zero control-plane rounds. Every handle
    combines on `device`.
    """
    from ..kernels.intersect import resolve_device

    device = resolve_device(device)
    if generations is None:
        generations = [None] * len(prefixes)
    gens = [int(pin) if pin is not None
            else latest_generation(transport.blobs, p)
            for p, pin in zip(prefixes, generations)]
    where = [i for i, g in enumerate(gens) if g > 0]
    out: list[Index | None] = [None] * len(prefixes)
    if where:
        payloads, _stats = transport.fetch_batch(
            [RangeRequest(_manifest_name(prefixes[i], gens[i]))
             for i in where])
        for i, data in zip(where, payloads):
            out[i] = Index(transport, prefixes[i], decode_manifest(data),
                           device=device)
    for i, g in enumerate(gens):
        if g == 0:
            out[i] = Index.open(transport, prefixes[i], device=device)
    return out  # type: ignore[return-value]


# ===================================================================== writer
class IndexWriter:
    """Segmented write session: append/add → commit, or merge to compact.

    Appends build **delta segments** — small self-contained sketches
    (own header + superpost blocks) over just the new documents — under
    the index prefix. `append()` builds the segment durably (store
    writes, invisible until commit); `add()` builds the same segment
    into process memory (index/nrt.py `MemorySegment`), which makes its
    documents **searchable immediately** through the handle's searchers
    while still staying invisible to other openers until `commit()`
    publishes the identical bytes. Either way nothing is durable-visible
    until `commit()` writes the next manifest generation; `abort()`
    deletes staged blobs and retracts memory segments. `merge()`
    compacts base + committed segments back into a single base index by
    re-profiling the concatenated corpus (so the optimizer's L and the
    common-word table reflect the full document set again).
    """

    def __init__(self, index: Index) -> None:
        if index.manifest.get("config") is None:
            raise ValueError(
                "index was opened from a legacy header-only layout (no "
                "manifest); rebuild it with Index.build(...) to enable "
                "writes")
        self._index = index
        self._config = BuilderConfig(**index.manifest["config"])
        self._base_generation = index.generation
        self._staged: list[dict] = []          # manifest segment entries
        self._staged_prefixes: list[str] = []
        self._memory: dict[str, MemorySegment] = {}   # seg prefix -> unit
        # per-session token: two writers based on the same generation must
        # never stage to the same blob names — else the loser's abort()
        # could delete blobs the winner's commit already published
        self._token = uuid.uuid4().hex[:8]

    @property
    def n_staged(self) -> int:
        return len(self._staged)

    def _segment_config(self, corpus: Corpus) -> BuilderConfig:
        """Scale the bin budget to the delta so tiny appends do not pay a
        full-size header; accuracy knobs (F0, seed, hedge layers, n-gram
        indexing) are inherited from the base config."""
        B = min(self._config.B, max(128, 8 * corpus.n_docs))
        return replace(self._config, B=B)

    def _next_seg_prefix(self) -> str:
        return (f"{self._index.prefix}/"
                f"seg-{self._base_generation + 1:08d}"
                f"-{self._token}-{len(self._staged):04d}")

    def append(self, corpus: Corpus) -> BuildReport:
        """Stage one delta segment over `corpus` (not yet visible)."""
        seg_prefix = self._next_seg_prefix()
        report = Builder(self._segment_config(corpus)).build(
            corpus, self._index.transport.blobs, seg_prefix)
        self._staged.append({"prefix": seg_prefix,
                             "corpus": _pack_refs(corpus.refs)})
        self._staged_prefixes.append(seg_prefix)
        return report

    def add(self, corpus: Corpus) -> BuildReport:
        """Stage one delta segment **in memory**: searchable through this
        handle's searchers milliseconds from now, durable at `commit()`.

        The segment is built under the exact prefix `commit()` will
        publish it to, into a process-local staging store — so the
        header bytes, hash draws, and false-positive sets a reader sees
        pre-publish are byte-for-byte the ones every reader sees
        post-publish (enforced by tests/test_nrt.py). Posts a
        `"memory"` event to the handle's attached `GenerationBus`.
        """
        seg_prefix = self._next_seg_prefix()
        seg = MemorySegment.build(corpus, self._segment_config(corpus),
                                  self._index.transport, seg_prefix,
                                  device=self._index.device)
        self._staged.append({"prefix": seg_prefix,
                             "corpus": _pack_refs(corpus.refs)})
        self._staged_prefixes.append(seg_prefix)
        self._memory[seg_prefix] = seg
        idx = self._index
        idx._nrt.append(seg)
        idx._nrt_seq += 1
        idx._notify("memory")
        return seg.report

    def _check_not_raced(self) -> int:
        current = _latest_generation(self._index.transport.blobs,
                                     self._index.prefix)
        if current != self._base_generation:
            raise RuntimeError(
                f"concurrent writer committed generation {current} "
                f"(this session is based on {self._base_generation}); "
                "refresh the index and retry")
        return current + 1

    def commit(self) -> Index:
        """Publish staged segments as the next manifest generation.

        Memory segments staged by `add()` are written to the store first
        (byte-identical to what they served from memory), then the
        manifest CAS-publishes; on a lost race the copied blobs are
        rolled back but the memory segments stay searchable, so a retry
        after `Index.refresh()` loses no visibility. On success the
        memory units retire — the identical published blobs take over —
        the handle's header cache is seeded with the bytes just
        published (the reopen swap costs zero fetches), and a
        `"published"` event is posted to the attached bus.
        """
        if not self._staged:
            return self._index
        generation = self._check_not_raced()
        idx = self._index
        published: list[str] = []
        for seg in self._memory.values():
            published += seg.publish(idx.transport.blobs)
        manifest = {
            "generation": generation,
            "base": idx.manifest["base"],
            "segments": list(idx.manifest["segments"]) + self._staged,
            "config": idx.manifest["config"],
        }
        try:
            _publish(idx.transport.blobs, idx.prefix, manifest)
        except BaseException:
            for name in published:
                idx.transport.blobs.delete(name)
            raise
        for seg in self._memory.values():
            idx._headers[seg.prefix] = seg.header_bytes
        self._retire_memory()
        idx._manifest = manifest
        self._base_generation = generation
        self._staged = []
        self._staged_prefixes = []
        idx._notify("published")
        return idx

    def _retire_memory(self) -> None:
        """Drop this session's memory units from the handle (their
        documents are now reachable another way, or retracted)."""
        if not self._memory:
            return
        idx = self._index
        idx._nrt = [s for s in idx._nrt if s.prefix not in self._memory]
        idx._nrt_seq += 1
        self._memory = {}

    def abort(self) -> None:
        """Drop staged segments: delete durable staged blobs (readers
        never saw them — segments only become reachable through a
        manifest) and retract memory segments (this handle's searchers
        saw those; the `"memory"` event tells followers to swap off)."""
        blobs = self._index.transport.blobs
        for seg_prefix in self._staged_prefixes:
            for name in blobs.list(seg_prefix + "/"):
                blobs.delete(name)
        retracted = bool(self._memory)
        self._retire_memory()
        self._staged = []
        self._staged_prefixes = []
        if retracted:
            self._index._notify("memory")

    def merge(self) -> Index:
        """Compact base + committed segments into one new base index.

        Rebuilds from the concatenated corpus (manifest-recorded doc
        refs, texts range-read back from the store) under a fresh
        `base-<generation>` prefix — live generations' blobs are never
        overwritten, so concurrent readers on the old generation keep
        working; their blobs can be garbage-collected once unreferenced.
        """
        if self._staged:
            raise RuntimeError(
                "commit() or abort() staged segments before merge()")
        idx = self._index
        refs = idx.corpus_refs()
        generation = self._check_not_raced()
        corpus = Corpus(store=idx.transport.blobs, refs=refs)
        new_base = f"{idx.prefix}/base-{generation:08d}"
        Builder(self._config).build(corpus, idx.transport.blobs, new_base)
        manifest = {
            "generation": generation,
            "base": {"prefix": new_base, "corpus": _pack_refs(refs)},
            "segments": [],
            "config": idx.manifest["config"],
        }
        _publish(idx.transport.blobs, idx.prefix, manifest)
        idx._manifest = manifest
        self._base_generation = generation
        return idx


# ============================================================ garbage collection
@dataclass
class GCReport:
    """What one `collect_garbage` sweep saw and did.

    `unreachable` is the full orphan set (what a dry run reports);
    `deleted` is the subset actually removed (empty on dry runs),
    `kept_grace` the subset spared because it is younger than the grace
    window. `bytes_reclaimed` measures `deleted` (or, on a dry run, what
    a real run would reclaim right now).
    """

    prefix: str
    keep: int
    n_candidates: int = 0
    n_reachable: int = 0
    unreachable: list[str] = field(default_factory=list)
    kept_grace: list[str] = field(default_factory=list)
    deleted: list[str] = field(default_factory=list)
    bytes_reclaimed: int = 0
    dry_run: bool = False


def blobs_of(source):
    """The control-plane `BlobStore` behind any store-ish handle a caller
    holds (transport, simulated cloud, or the store itself)."""
    if isinstance(source, StorageTransport):
        return source.blobs
    backing = getattr(source, "backing", None)   # SimCloudStore
    if backing is not None:
        return backing
    return source


def unit_blob_names(all_names: list[str], unit_prefix: str) -> set[str]:
    """The blobs one index unit (a base or a delta segment) is made of:
    its header plus its superpost blocks. Matching on names — rather than
    listing `unit_prefix/` wholesale — keeps a base living at the index
    root (the legacy layout) from claiming segment/manifest blobs that
    merely share the prefix."""
    return {n for n in all_names
            if n == f"{unit_prefix}/header.airp"
            or n.startswith(f"{unit_prefix}/superposts-")}


def manifest_reachable(manifest: dict, all_names: list[str]) -> set[str]:
    """Blobs one decoded index manifest keeps alive: every unit's header
    and blocks, plus the corpus blobs its document refs point into (so a
    corpus written under the index prefix is never collected)."""
    out: set[str] = set()
    entries = [manifest["base"]] + list(manifest["segments"])
    for entry in entries:
        out |= unit_blob_names(all_names, entry["prefix"])
        packed = entry.get("corpus")
        if packed is not None:
            out.update(packed["blobs"])
    return out


def _manifest_generation(name: str) -> int:
    """Generation number encoded in a manifest blob name (zero-padded,
    so name order is generation order)."""
    tail = name.rsplit("-", 1)[1]
    return int(tail.split(".")[0])


def reachable_blobs(blobs, prefix: str, keep: int = 2,
                    all_names: list[str] | None = None,
                    min_generation: int | None = None) -> set[str]:
    """The blob set reachable from the kept manifests of the index at
    `prefix` (manifests included). Kept = the latest `keep` manifests,
    widened down to `min_generation` when given — that is how reader
    leases (index/nrt.py `LeaseRegistry`) pin old generations: the keep
    floor is `min(latest-keep, min(leased generations))`, so a leased
    snapshot's blobs stay reachable no matter how many commits have
    happened since. A legacy header-only prefix (no manifests) reports
    everything reachable — there is no manifest history to walk, so
    nothing is provably garbage. `all_names` skips the LIST when the
    caller already holds one covering the prefix (how cluster GC walks
    N shard prefixes on a single cluster-level LIST)."""
    if all_names is None:
        all_names = blobs.list(f"{prefix}/")
    else:
        all_names = [n for n in all_names if n.startswith(f"{prefix}/")]
    manifests = sorted(n for n in all_names
                       if n.startswith(f"{prefix}/manifest-")
                       and n.endswith(".airm"))
    if not manifests:
        return set(all_names)
    kept = manifests[-max(1, int(keep)):]
    if min_generation is not None:
        floor = min(int(min_generation), _manifest_generation(kept[0]))
        kept = [m for m in manifests if _manifest_generation(m) >= floor]
    out: set[str] = set(kept)
    for name in kept:
        manifest = decode_manifest(blobs.get(name))
        out |= manifest_reachable(manifest, all_names)
    return out


DEFAULT_GRACE_S = 600.0


def warn_ungraced_sweep(grace_s: float, leases) -> None:
    """`grace_s=0.0` with no `LeaseRegistry` deletes out from under any
    reader the sweep cannot see. Escalated from DeprecationWarning
    (compat.py): raises `UngracedSweepError` unless
    REPRO_ALLOW_DEPRECATED=1 restores the old warn-and-sweep."""
    if grace_s <= 0.0 and leases is None:
        deprecated_call(
            "collect_garbage(grace_s=0.0) without a LeaseRegistry has "
            "no protection for in-flight readers",
            "pass leases=<registry> (index/nrt.py) or keep a grace "
            "window", error=UngracedSweepError, stacklevel=4)


def collect_garbage(source, prefix: str, keep: int = 2,
                    grace_s: float = DEFAULT_GRACE_S,
                    dry_run: bool = False,
                    now: float | None = None,
                    reachable: set[str] | None = None,
                    leases=None) -> GCReport:
    """Delete blobs under `prefix` unreachable from the kept manifest
    generations: the latest `keep`, widened down to the oldest leased
    generation when a `LeaseRegistry` is passed.

    Old generations accumulate by design — `merge()` writes a fresh
    `base-<gen>` and never overwrites live blobs, the serving tier's
    `reshard` builds whole new shard sets (serving/cluster.py) — so an
    index that is written to forever leaks storage without this sweep.
    Reachability is computed from the manifests (`reachable_blobs`);
    everything else under the prefix is garbage, EXCEPT blobs younger
    than `grace_s` (by `BlobStore.mtime`), which are spared until the
    next sweep.

    Two mechanisms protect in-flight readers, in order of preference:

      * **Leases** (`leases=`, an `index.nrt.LeaseRegistry`): a reader
        that registered the generation it pins is protected exactly —
        every manifest at or above the minimum leased generation stays
        reachable, for as long as the lease lives, even with
        `grace_s=0.0`.
      * **The grace window** is the fallback for whatever holds no
        lease: a reader that just resolved a manifest and is about to
        range-read the blobs it points at, and a membership change's
        staging blobs (serving/cluster.py `_stage_prefix`) written but
        not yet published — deleting those would let the change
        CAS-publish a manifest pointing at nothing. It defaults ON
        (`DEFAULT_GRACE_S`, 10 min).

    `grace_s=0.0` with an active registry is safe for registered
    readers (how tests/test_nrt.py exercises exactness); `grace_s=0.0`
    with NO registry deletes out from under any concurrent reader and
    now raises `UngracedSweepError` (compat.py;
    REPRO_ALLOW_DEPRECATED=1 demotes it back to a warning) — allow it
    only where no reader or writer can be in flight (offline
    compaction). `dry_run=True`
    reports the orphan set without deleting. `reachable` overrides the
    root set (how cluster-level GC folds shard reachability in, leases
    already applied); `now` pins the clock for deterministic tests.

    Works on any store handle: a `BlobStore`, `SimCloudStore`, or
    `StorageTransport` (GC is control-plane — LIST/DELETE — so no
    latency model mediates it).
    """
    blobs = blobs_of(source)
    if reachable is None:
        warn_ungraced_sweep(grace_s, leases)
    candidates = blobs.list(f"{prefix}/")
    min_gen = leases.min_generation(prefix) if leases is not None else None
    live = reachable if reachable is not None else \
        reachable_blobs(blobs, prefix, keep, min_generation=min_gen)
    orphans = sorted(n for n in candidates if n not in live)
    # mtime-grace fallback compares against real blob mtimes, so the
    # default clock must be the wall clock  # lint: allow RAW-CLOCK
    t_now = time.time() if now is None else now
    report = GCReport(prefix=prefix, keep=int(keep),
                      n_candidates=len(candidates),
                      n_reachable=len(candidates) - len(orphans),
                      unreachable=orphans, dry_run=dry_run)
    for name in orphans:
        try:
            if grace_s > 0.0 and t_now - blobs.mtime(name) < grace_s:
                report.kept_grace.append(name)
                continue
            size = blobs.size(name)
        except (KeyError, FileNotFoundError, OSError):
            continue    # vanished since the LIST (concurrent sweep or
            #             a conflicted change's abort): already collected
        report.bytes_reclaimed += size
        if not dry_run:
            blobs.delete(name)
            report.deleted.append(name)
    return report
