"""Near-real-time ingest: memory-resident segments and reader leases.

The lifecycle layer (lifecycle.py) makes a document searchable only
after `commit()` publishes blobs *and* a reader polls `refresh()` —
write-read coupling that costs seconds of freshness on a medium whose
unit of durability is a PUT. This module decouples the two, following
the dedicated-indexer architecture of the Write-Read Decoupling survey
(PAPERS.md):

  * `MemorySegment` — a delta segment built by `IndexWriter.add()` into
    an in-process `InMemoryBlobStore` under the **final** segment
    prefix. It subclasses `Searcher`, so it plugs into
    `MultiSegmentSearcher`/`lookup_units` as just another unit; its
    round-1 superpost reads resolve from memory (`resolve_local`) while
    round-2 document reads ride the shared fetcher to the real corpus
    blobs. Because `commit()` publishes the *same bytes* the memory
    unit was built from, pre-publish results are byte-identical to the
    post-publish blob path — same sketch, same false-positive sets,
    same top-K sampling order.
  * `LeaseRegistry` — readers register the generation they pin;
    `collect_garbage(..., leases=...)` keeps every manifest at or above
    the minimum leased generation, so the mtime grace window becomes a
    fallback for unregistered readers rather than the only protection.

The notification half of the subsystem (push-triggered refresh instead
of polling) lives in serving/notify.py — `GenerationBus`.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..analysis.locks import OrderedLock
from ..data.corpus import Corpus, DocRef
from ..storage.blobstore import InMemoryBlobStore, RangeRequest
from .builder import Builder, BuilderConfig
from .searcher import Searcher


# ============================================================= memory segment
class MemorySegment(Searcher):
    """A delta segment searchable from memory before its blobs exist.

    Built by `Builder` into a private `InMemoryBlobStore` under the
    segment prefix `commit()` will later publish to — the header bytes,
    block layout, and hash draws are exactly what the durable segment
    will contain, which is what makes pre-publish results byte-identical
    to post-publish ones. The multi-unit executor detects the
    `resolve_local` attribute and answers this unit's round-1 range
    reads synchronously from the staging store (zero fetch rounds, zero
    bytes on the wire); round-2 document reads go through the shared
    fetcher like any other unit, because the *corpus* blobs are durable
    already (`Corpus` text lives in the store before indexing starts).
    """

    def __init__(self, staging: InMemoryBlobStore, transport, prefix: str,
                 doc_refs: list[DocRef], report, device="cuda") -> None:
        self._staging = staging
        super().__init__(transport, prefix,
                         header=staging.get(f"{prefix}/header.airp"),
                         device=device)
        self.doc_refs = doc_refs
        self.report = report

    @classmethod
    def build(cls, corpus: Corpus, config: BuilderConfig, transport,
              prefix: str, device="cuda") -> "MemorySegment":
        """Build `corpus`'s sketch into memory under `prefix` (no store
        writes); `transport` is the data plane round-2 doc reads use,
        `device` where the unit's `impl="bitmap"` combines run."""
        staging = InMemoryBlobStore()
        report = Builder(config).build(corpus, staging, prefix)
        return cls(staging, transport, prefix, list(corpus.refs), report,
                   device=device)

    # -- executor hooks ---------------------------------------------------
    def resolve_local(self, req: RangeRequest) -> bytes:
        """Answer one of this unit's round-1 range reads from memory."""
        return self._staging.get_range(req)

    # -- publication ------------------------------------------------------
    @property
    def header_bytes(self) -> bytes:
        return self._staging.get(f"{self.prefix}/header.airp")

    @property
    def staged_bytes(self) -> int:
        return self._staging.total_bytes(self.prefix)

    def blob_names(self) -> list[str]:
        return self._staging.list(f"{self.prefix}/")

    def publish(self, blobs) -> list[str]:
        """Copy the staged blobs, byte-for-byte, into the durable store.

        Returns the published names (so a failed CAS can roll them
        back). After this the segment is an ordinary blob-backed unit:
        a reader opening the published manifest fetches the *same*
        header and blocks this memory unit has been serving."""
        names = self.blob_names()
        for name in names:
            blobs.put(name, self._staging.get(name))
        return names


# ===================================================================== leases
@dataclass
class Lease:
    """One reader's pin on `(prefix, generation)`; release via
    `release()` or by using the lease as a context manager. Idempotent —
    double release is a no-op."""

    registry: "LeaseRegistry"
    prefix: str
    generation: int
    released: bool = False

    def release(self) -> None:
        self.registry.release(self)

    def __enter__(self) -> "Lease":
        return self

    def __exit__(self, *_exc) -> None:
        self.release()


class LeaseRegistry:
    """Who is reading which generation — the GC keep-floor's source.

    A searcher (or the `SearchService` wrapping one) acquires a lease on
    the generation it pins at open/refresh time and releases it on swap;
    `collect_garbage(..., leases=registry)` then never deletes a blob
    reachable from a leased generation, even with `grace_s=0.0`. One
    registry can cover many prefixes — a cluster session leases the
    cluster prefix *and* each shard prefix it serves. Thread-safe:
    serving refreshes and GC sweeps run on different threads.
    """

    def __init__(self) -> None:
        self._lock = OrderedLock("nrt.leases")
        self._held: dict[str, dict[int, int]] = {}   # prefix -> gen -> count

    def acquire(self, prefix: str, generation: int) -> Lease:
        generation = int(generation)
        with self._lock:
            gens = self._held.setdefault(prefix, {})
            gens[generation] = gens.get(generation, 0) + 1
        return Lease(self, prefix, generation)

    def release(self, lease: Lease) -> None:
        if lease.released:
            return
        lease.released = True
        with self._lock:
            gens = self._held.get(lease.prefix)
            if not gens:
                return
            n = gens.get(lease.generation, 0) - 1
            if n > 0:
                gens[lease.generation] = n
            else:
                gens.pop(lease.generation, None)
                if not gens:
                    self._held.pop(lease.prefix, None)

    def min_generation(self, prefix: str) -> int | None:
        """The oldest generation any live lease pins under `prefix`
        (None when nothing is leased — GC falls back to latest-K)."""
        with self._lock:
            gens = self._held.get(prefix)
            return min(gens) if gens else None

    def leased(self, prefix: str) -> dict[int, int]:
        """Snapshot of `generation -> live lease count` under `prefix`."""
        with self._lock:
            return dict(self._held.get(prefix, {}))

    def __len__(self) -> int:
        with self._lock:
            return sum(sum(g.values()) for g in self._held.values())
