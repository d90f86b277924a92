"""Sharded serving tier: scatter-gather over per-shard stateless indexes.

The paper's premise (§III-A) is that stateless compute scales
independently of cloud storage; this module is the scaling unit on the
compute side. A corpus is partitioned into N **doc-hash shards**, each a
completely normal `Index` (own manifest, own generations, own writer)
under `prefix/shard-XXXX`; a tiny **cluster manifest** records membership
and the per-shard generations at publish time, CAS-published exactly like
index manifests (`cluster-<gen>.airc`, highest wins).

`ClusterSearcher` scatter-gathers a query batch across every shard:

  * per-shard fetch rounds are **concurrently driven** — each shard's
    two-round `query_batch` runs on its own thread over its own
    `StorageTransport` workers, so cluster wall-clock is the slowest
    shard, not the sum (IoU Sketch makes this unusually cheap: every
    shard costs the same bounded two rounds, so the scatter is balanced
    by construction);
  * each shard may have several **replicas** (independent transports over
    the same bytes — e.g. different VMs or simulated regions); the
    searcher picks the replica with the fewest in-flight requests and,
    past `hedge_after_s`, retries a straggling shard on the next-best
    replica, first responder wins;
  * per-shard results are merged — top-K truncated after the union, doc
    hits unioned and restored to monolithic (blob, offset) order — so a
    sharded cluster answers **byte-identically** to the unsharded index
    over the same corpus (shards partition documents, verification makes
    each shard exact, and the union of disjoint exact sets is exact).

Simulated transports (`SimCloudTransport`) carry their own virtual
clocks; when every shard drives a distinct clock the scatter is measured
as true overlap (`wall_s` = max over shards) while shards that share one
virtual clock are driven sequentially to keep the simulation
deterministic. Real transports (`BlobStoreTransport`) always run
genuinely concurrent threads.

Membership is **fluid** (docs/serving_cluster.md "Resharding & GC"):
documents route doc-hash → slot → physical shard, and
`reshard`/`split`/`merge_shards` publish a new slot map as the next
cluster generation while live readers keep serving the old one until
`refresh()` swaps — the cutover is a manifest CAS, never a blob
mutation. Superseded generations are reclaimed by
`collect_cluster_garbage` (latest-K reachability + grace window).

Because shard blobs are immutable, membership changes default to
**aliased generations** (docs/serving_cluster.md "Aliased
generations"): instead of rebuilding moved documents, the new
manifest's entries *alias* existing physical shard blob sets with a
served-slot filter — `reshard`/`split`/`merge_shards` then write
O(manifest) bytes, `replicate` scales a hot shard out for the cost of
a manifest, and a background `compact(shard_i)` lazily materializes a
real per-shard blob set and CAS-publishes the de-aliased generation.
Readers serve an aliased shard by scatter-gathering its source units
in the same batched rounds and dropping round-1 candidates outside the
served slots before any budget decision, so results stay
byte-identical to the unsharded index throughout the alias window.
`cluster_reachable_blobs` follows alias edges, so a source blob set
referenced by any kept generation survives the sweep.

In this package the read half is ported: routing, the cluster manifest
codec (alias entries included), `ShardedIndex.build`/`open`/`refresh`/
`searcher`, and `ClusterSearcher`'s per-shard and fused scatter-gather.
Membership changes (`reshard`, `split`, `merge_shards`, `replicate`,
`compact`, `append`) and cluster GC raise `NotImplementedError` (ROADMAP
queue 1, item 5). Every shard unit combines on the handle's `device`:
the per-shard legs through their units' `query_batch`, the fused path
through ONE `combine_cluster_planned` call on the gather side.
"""

from __future__ import annotations

import hashlib
import heapq
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import asdict, dataclass, field, replace

from ..analysis.locks import OrderedLock
from ..core.hashing import word_fingerprint
from ..core.topk import sample_size
from ..data.corpus import Corpus, DocRef
from ..index import _msgpack
from ..index.builder import BuilderConfig
from ..index.lifecycle import (DEFAULT_GRACE_S, Index,
                               MultiSegmentSearcher, latest_generation,
                               open_many, publish_generation)
from ..index.planner import (DocContent, combine_cluster_planned,
                             physical_plan, plan_batch, shard_quotas)
from ..index.query import Query, Regex
from ..index.searcher import (BatchStats, QueryResult, QueryStats, Searcher,
                              _filter_unit_candidates, _merge_results,
                              lookup_units, topk_order)
from ..storage.blobstore import RangeRequest
from ..storage.cache import SuperpostCache
from ..storage.simcloud import FetchStats
from ..storage.transport import (SimCloudTransport, StorageTransport,
                                 as_transport)

CLUSTER_MAGIC = b"AIRC"
CLUSTER_VERSION = 1


class ClusterConflict(RuntimeError):
    """A cluster membership change (reshard/split/merge_shards) lost a
    race: another publisher claimed the next cluster generation, or a
    shard writer committed while the new shards were being built from
    the old corpus snapshot. The staged blobs have been deleted;
    `refresh()` the handle and retry."""


# ---------------------------------------------------------------- partitioning
def slot_of_ref(ref: DocRef, n_slots: int) -> int:
    """Stable doc-hash slot assignment from the document's storage
    identity (blob, offset, length) — process- and seed-independent, so
    appends route to the same slot the original build chose."""
    ident = f"{ref.blob}:{ref.offset}:{ref.length}".encode()
    digest = hashlib.blake2b(ident, digest_size=8).digest()
    return int.from_bytes(digest, "big") % n_slots


# a cluster built with n_slots == n_shards routes slot i to shard i, so
# the classic name is the same function — kept as the public alias every
# existing caller and test uses
shard_of_ref = slot_of_ref


def partition_by_slots(corpus: Corpus, n_slots: int,
                       shard_of_slot: list[int],
                       n_shards: int) -> list[Corpus]:
    """Split a corpus into `n_shards` sub-corpora through the slot map
    (doc → hash slot → physical shard). Views over the same blobs — no
    bytes are copied."""
    refs: list[list[DocRef]] = [[] for _ in range(n_shards)]
    texts: list[list[str]] | None = \
        [[] for _ in range(n_shards)] if corpus.texts is not None else None
    for i, ref in enumerate(corpus.refs):
        s = shard_of_slot[slot_of_ref(ref, n_slots)]
        refs[s].append(ref)
        if texts is not None:
            texts[s].append(corpus.texts[i])
    return [Corpus(store=corpus.store, refs=refs[s],
                   texts=texts[s] if texts is not None else None)
            for s in range(n_shards)]


def partition_corpus(corpus: Corpus, n_shards: int) -> list[Corpus]:
    """Split a corpus into `n_shards` doc-hash sub-corpora (the identity
    slot map: slot i → shard i, what `build` uses)."""
    return partition_by_slots(corpus, n_shards, list(range(n_shards)),
                              n_shards)


# ------------------------------------------------------- cluster manifest codec
def _cluster_manifest_name(prefix: str, generation: int) -> str:
    return f"{prefix}/cluster-{generation:08d}.airc"


def encode_cluster_manifest(manifest: dict) -> bytes:
    return CLUSTER_MAGIC + bytes([CLUSTER_VERSION]) + \
        _msgpack.packb(manifest)


def decode_cluster_manifest(data: bytes) -> dict:
    if data[:4] != CLUSTER_MAGIC:
        raise ValueError("not an Airphant cluster manifest")
    if data[4] != CLUSTER_VERSION:
        raise ValueError(
            f"cluster manifest version {data[4]} != supported "
            f"{CLUSTER_VERSION}")
    return _normalize_cluster_manifest(
        _msgpack.unpackb(data[5:]))


def _normalize_cluster_manifest(manifest: dict) -> dict:
    """Fill in slot routing for pre-resharding manifests: a cluster that
    never resharded has the identity map (slot i → shard i, one slot per
    shard), which is exactly what `build` used to imply. Alias entries
    (`entry["aliases"]`, absent on physical shards) are normalized to
    int generations and slot lists so downstream code never re-coerces
    msgpack output."""
    manifest.setdefault("n_slots", int(manifest["n_shards"]))
    for i, entry in enumerate(manifest["shards"]):
        entry.setdefault("slots", [i])
        if entry.get("aliases"):
            entry["aliases"] = [
                {"prefix": a["prefix"],
                 "generation": int(a["generation"]),
                 "slots": [int(x) for x in a["slots"]]}
                for a in entry["aliases"]]
    return manifest


def _shard_of_slot(manifest: dict) -> list[int]:
    """Invert the per-shard slot lists into one slot → shard array."""
    out = [-1] * int(manifest["n_slots"])
    for s, entry in enumerate(manifest["shards"]):
        for slot in entry["slots"]:
            out[int(slot)] = s
    if any(s < 0 for s in out):
        # a hole would silently route documents to refs[-1] — refuse the
        # manifest outright rather than misroute
        missing = [i for i, s in enumerate(out) if s < 0]
        raise ValueError(
            f"cluster manifest slot map leaves slots {missing} unassigned")
    return out


def _slot_member(slots: frozenset, n_slots: int):
    """Served-slot predicate over storage identity — the `ref_filter`
    an aliased unit gets so it serves exactly its entry's slot subset
    of the source blobs (see Searcher.ref_filter)."""
    def served(ref: DocRef) -> bool:
        return slot_of_ref(ref, n_slots) in slots
    return served


def _open_member_shards(transport: StorageTransport, manifest: dict,
                        device) -> tuple[list[Index | None],
                                   list[list[tuple[Index, list[int]]]]]:
    """Open every member shard AND every distinct alias source with ONE
    batched manifest fetch (`index.lifecycle.open_many`), keeping empty
    slots as None.

    Returns `(shards, alias_sources)`: `shards[i]` is the shard's own
    `Index` handle (resolved at its latest generation — shard commits
    stay shard-local), `alias_sources[i]` the shard's aliased source
    handles as `(Index pinned at the manifest-recorded generation,
    served slot list)` pairs. A source prefix aliased by several shards
    is opened once and shared."""
    own = [s["prefix"] for s in manifest["shards"]
           if s["prefix"] is not None]
    alias_at: dict[tuple[str, int], int] = {}
    alias_keys: list[tuple[str, int]] = []
    for entry in manifest["shards"]:
        for a in entry.get("aliases") or []:
            k = (a["prefix"], int(a["generation"]))
            if k not in alias_at:
                alias_at[k] = len(own) + len(alias_keys)
                alias_keys.append(k)
    opened = open_many(
        transport,
        own + [p for p, _g in alias_keys],
        generations=[None] * len(own) + [g for _p, g in alias_keys],
        device=device)
    it = iter(opened[:len(own)])
    shards = [None if s["prefix"] is None else next(it)
              for s in manifest["shards"]]
    alias_sources = [
        [(opened[alias_at[(a["prefix"], int(a["generation"]))]],
          [int(x) for x in a["slots"]])
         for a in entry.get("aliases") or []]
        for entry in manifest["shards"]]
    return shards, alias_sources


# ===================================================================== handle
class ShardedIndex:
    """Handle on a sharded cluster: N shard `Index` handles + membership.

    `build` partitions and builds every shard, then CAS-publishes the
    cluster manifest; `open` resolves the newest cluster manifest and
    opens each member shard at its **current** generation (shards commit
    independently — the cluster manifest records membership, not a
    snapshot). `searcher()` vends a `ClusterSearcher`. Every shard and
    alias source opens on `device`, where the cluster's combines run.
    """

    def __init__(self, transport: StorageTransport, prefix: str,
                 manifest: dict, shards: list[Index | None],
                 owns_transport: bool = False,
                 alias_sources: list[list[tuple[Index, list[int]]]]
                 | None = None, device="cuda") -> None:
        from ..kernels.intersect import resolve_device

        self.device = resolve_device(device)
        self.transport = transport
        self.prefix = prefix
        self._manifest = manifest
        self.shards = shards                 # None for empty shard slots
        # per shard: aliased source handles as (Index pinned at the
        # manifest-recorded generation, served slot list) — empty for
        # physical shards (see _open_member_shards)
        self.alias_sources = alias_sources \
            if alias_sources is not None else [[] for _ in shards]
        self._owns_transport = owns_transport
        self._bus = None

    # -- introspection ----------------------------------------------------
    @property
    def manifest(self) -> dict:
        return self._manifest

    @property
    def generation(self) -> int:
        return int(self._manifest["generation"])

    @property
    def n_shards(self) -> int:
        return int(self._manifest["n_shards"])

    @property
    def n_slots(self) -> int:
        """Hash-slot count (the routing modulus). Fixed for the life of
        the cluster by `build(n_slots=...)` unless a full `reshard`
        replaces it; `split`/`merge_shards` only move slots between
        physical shards."""
        return int(self._manifest["n_slots"])

    @property
    def shard_prefixes(self) -> list[str | None]:
        return [s["prefix"] for s in self._manifest["shards"]]

    @property
    def n_docs(self) -> int:
        return sum(int(s["n_docs"]) for s in self._manifest["shards"])

    @property
    def config(self) -> BuilderConfig | None:
        cfg = self._manifest.get("config")
        return BuilderConfig(**cfg) if cfg is not None else None

    @property
    def aliased_shards(self) -> list[int]:
        """Shards currently serving through alias entries — the
        `compact()` worklist a background maintenance loop drains."""
        return [s for s, e in enumerate(self._manifest["shards"])
                if e.get("aliases")]

    @property
    def reader_generation(self) -> tuple:
        """What a freshly opened `ClusterSearcher` pins: the cluster
        generation plus every shard's own generation (shards commit
        independently of the cluster manifest). Generation-keyed caches
        over a cluster key on this tuple."""
        return (self.generation,
                *(0 if idx is None else idx.generation
                  for idx in self.shards))

    @property
    def nrt_seq(self) -> tuple:
        """Per-shard NRT sequence numbers (index/nrt.py): bumps when any
        shard's memory-resident segment set changes. Together with
        `reader_generation` this pins the full visibility state."""
        return tuple(0 if idx is None else idx.nrt_seq
                     for idx in self.shards)

    def attach_bus(self, bus) -> "ShardedIndex":
        """Post visibility changes to `bus` (serving/notify.py): cluster
        membership publishes under the cluster prefix, and — via each
        member shard's handle — shard commits and memory adds under the
        shard prefixes. Survives `refresh()` re-opening shard handles.
        Returns self for chaining."""
        self._bus = bus
        self._attach_shard_buses()
        return self

    def _attach_shard_buses(self) -> None:
        if self._bus is not None:
            for idx in self.shards:
                if idx is not None:
                    idx.attach_bus(self._bus)

    def shard(self, i: int) -> Index:
        """The i-th shard's `Index` handle (writers go through this —
        shard commits are shard-local and need no cluster republish)."""
        idx = self.shards[i]
        if idx is None:
            raise IndexError(f"shard {i} of {self.prefix!r} is empty")
        return idx

    def __repr__(self) -> str:
        return (f"ShardedIndex(prefix={self.prefix!r}, "
                f"generation={self.generation}, n_shards={self.n_shards})")

    def close(self) -> None:
        if self._owns_transport:
            self.transport.close()

    def __enter__(self) -> "ShardedIndex":
        return self

    def __exit__(self, *_exc) -> None:
        self.close()

    # -- lifecycle --------------------------------------------------------
    @classmethod
    def build(cls, corpus: Corpus, config: BuilderConfig | None,
              store, prefix: str, n_shards: int,
              n_slots: int | None = None,
              device="cuda") -> "ShardedIndex":
        """Partition `corpus` into `n_shards` doc-hash shards, build each
        as a normal `Index` under `prefix/shard-XXXX`, and CAS-publish the
        cluster manifest. A shard the hash leaves empty is recorded as an
        empty slot (no index is built for it).

        `n_slots` over-provisions the routing modulus beyond the physical
        shard count (contiguous slot ranges per shard) so later targeted
        `split()` calls can move slots without rebuilding the world; the
        default (`n_slots == n_shards`, the identity map) routes exactly
        like the pre-resharding tier.
        """
        from ..kernels.intersect import resolve_device

        device = resolve_device(device)     # raise before building
        if n_shards < 1:
            raise ValueError("need at least one shard")
        n_slots = n_shards if n_slots is None else int(n_slots)
        if n_slots < n_shards:
            raise ValueError(
                f"n_slots={n_slots} must be >= n_shards={n_shards}")
        owns = not isinstance(store, StorageTransport)
        transport = as_transport(store)
        cfg = config or BuilderConfig()
        # shard i serves the contiguous slot range [i*S/N, (i+1)*S/N)
        slots_of = [list(range(s * n_slots // n_shards,
                               (s + 1) * n_slots // n_shards))
                    for s in range(n_shards)]
        shard_of_slot = [s for s in range(n_shards) for _ in slots_of[s]]
        parts = partition_by_slots(corpus, n_slots, shard_of_slot,
                                   n_shards)
        shards: list[Index | None] = []
        entries: list[dict] = []
        for s, part in enumerate(parts):
            if not part.refs:
                shards.append(None)
                entries.append({"prefix": None, "generation": 0,
                                "n_docs": 0, "slots": slots_of[s]})
                continue
            shard_prefix = f"{prefix}/shard-{s:04d}"
            idx = Index.build(part, cfg, transport, shard_prefix,
                              device=device)
            shards.append(idx)
            entries.append({"prefix": shard_prefix,
                            "generation": idx.generation,
                            "n_docs": part.n_docs,
                            "slots": slots_of[s]})
        generation = latest_generation(transport.blobs, prefix,
                                       stem="cluster") + 1
        manifest = {"generation": generation, "n_shards": n_shards,
                    "n_slots": n_slots, "shards": entries,
                    "config": asdict(cfg)}
        publish_generation(
            transport.blobs, _cluster_manifest_name(prefix, generation),
            encode_cluster_manifest(manifest), generation, prefix)
        return cls(transport, prefix, manifest, shards,
                   owns_transport=owns, device=device)

    @classmethod
    def open(cls, store, prefix: str,
             generation: int | None = None,
             device="cuda") -> "ShardedIndex":
        """Open the newest cluster generation (or a pinned older one
        that `collect_garbage` has not yet collected)."""
        from ..kernels.intersect import resolve_device

        device = resolve_device(device)
        owns = not isinstance(store, StorageTransport)
        transport = as_transport(store)
        if generation is None:
            generation = latest_generation(transport.blobs, prefix,
                                           stem="cluster")
        if generation == 0:
            raise FileNotFoundError(
                f"no cluster manifest under {prefix!r}")
        data = transport.blobs.get(
            _cluster_manifest_name(prefix, generation))
        manifest = decode_cluster_manifest(data)
        shards, alias_sources = _open_member_shards(transport, manifest,
                                                    device)
        return cls(transport, prefix, manifest, shards,
                   owns_transport=owns, alias_sources=alias_sources,
                   device=device)

    def refresh(self) -> "ShardedIndex":
        """Re-resolve cluster membership AND every shard's generation
        (each shard commits independently of the cluster manifest)."""
        generation = latest_generation(self.transport.blobs, self.prefix,
                                       stem="cluster")
        if generation != self.generation:
            data = self.transport.blobs.get(
                _cluster_manifest_name(self.prefix, generation))
            self._manifest = decode_cluster_manifest(data)
            self.shards, self.alias_sources = _open_member_shards(
                self.transport, self._manifest, self.device)
            self._attach_shard_buses()
        else:
            # usually 0-1 shards have moved; Index.refresh only fetches
            # a manifest when its generation actually changed
            for idx in self.shards:
                if idx is not None:
                    idx.refresh()
        return self

    def _slot_map(self) -> list[int]:
        """Slot → shard array for the CURRENT manifest, computed once
        per manifest swap (per-document routing must not rebuild an
        O(n_slots) array per call)."""
        cached = getattr(self, "_slot_cache", None)
        if cached is None or cached[0] is not self._manifest:
            self._slot_cache = (self._manifest,
                                _shard_of_slot(self._manifest))
        return self._slot_cache[1]

    def partition(self, corpus: Corpus) -> list[Corpus]:
        """Route new documents with the cluster's own slot map (one
        sub-corpus per physical shard, in shard order)."""
        return partition_by_slots(corpus, self.n_slots,
                                  self._slot_map(), self.n_shards)

    def route_ref(self, ref: DocRef) -> int:
        """The physical shard index serving `ref` in this generation."""
        return self._slot_map()[slot_of_ref(ref, self.n_slots)]

    # -- membership changes (online resharding) ---------------------------
    def _require_config(self) -> BuilderConfig:
        cfg = self.config
        if cfg is None:
            raise ValueError(
                f"cluster {self.prefix!r} has no recorded BuilderConfig; "
                "membership changes need it to rebuild shards")
        return cfg

    def shard_corpus_refs(self, s: int) -> list[DocRef]:
        """Every document ref shard `s` serves in this generation:
        aliased source refs filtered to the served slots (alias order —
        those documents predate the alias), then the shard's own
        overlay refs. This IS ingest order, so a `compact()` built from
        it reproduces what a rebuild would have."""
        refs: list[DocRef] = []
        m = self.n_slots
        for src, slots in self.alias_sources[s]:
            sset = set(int(x) for x in slots)
            refs += [r for r in src.corpus_refs()
                     if slot_of_ref(r, m) in sset]
        idx = self.shards[s]
        if idx is not None:
            refs += idx.corpus_refs()
        return refs

    # -- membership changes and GC: not ported yet ------------------------
    def reshard(self, n_shards: int, n_slots: int | None = None,
                mode: str = "alias") -> "ShardedIndex":
        _management("ShardedIndex.reshard")

    def split(self, shard_i: int, mode: str = "alias") -> "ShardedIndex":
        _management("ShardedIndex.split")

    def merge_shards(self, a: int, b: int,
                     mode: str = "alias") -> "ShardedIndex":
        _management("ShardedIndex.merge_shards")

    def replicate(self, shard_i: int, n_replicas: int) -> "ShardedIndex":
        _management("ShardedIndex.replicate")

    def compact(self, shard_i: int) -> "ShardedIndex":
        _management("ShardedIndex.compact")

    def append(self, corpus: Corpus) -> "ShardedIndex":
        _management("ShardedIndex.append")

    def collect_garbage(self, keep: int = 2,
                        grace_s: float = DEFAULT_GRACE_S,
                        dry_run: bool = False, now: float | None = None,
                        leases=None):
        _management("ShardedIndex.collect_garbage")

    # -- sessions ---------------------------------------------------------
    def searcher(self, cache: SuperpostCache | None = None,
                 coalesce_gap: int | None = 4096,
                 replica_sources: list | None = None,
                 hedge_after_s: float | None = None,
                 concurrent: bool = True,
                 fused: bool = False,
                 picker=None,
                 telemetry=None) -> "ClusterSearcher":
        """Open a scatter-gather read session over all non-empty shards.

        `replica_sources` names the data plane(s): each entry serves one
        replica per shard and is either a transport/store shared by every
        shard or a callable `shard_index -> transport/store` (what the
        simulator needs — each shard gets its own virtual clock). The
        default (`None`) is one replica over the handle's own transport.
        `hedge_after_s` enables per-shard hedged retry on a straggling
        replica; `concurrent=False` forces the serial per-shard loop
        (the comparison baseline). `picker` selects the replica policy
        (`None`/"least_loaded", "p2c", or any object with `.pick` —
        serving/control.py); `telemetry` is a
        `serving.telemetry.Telemetry` the session exports per-replica
        in-flight gauges and scatter-round observations into.
        """
        entries = self._manifest["shards"]
        live: list[tuple[int, Index | None, list, int]] = []
        for s, idx in enumerate(self.shards):
            aliases = self.alias_sources[s]
            if idx is None and not aliases:
                continue
            n_rep = max(1, int(entries[s].get("replicas") or 1))
            live.append((s, idx, aliases, n_rep))
        if not live:
            raise ValueError(
                f"cluster {self.prefix!r} has no non-empty shards to "
                "serve (built from an empty corpus?)")
        owned: list[StorageTransport] = []
        transports: list[list[StorageTransport]] = []
        for s, _idx, _aliases, n_rep in live:
            row: list[StorageTransport] = []
            for src in (replica_sources or [self.transport]):
                # a factory mints a fresh source per shard, and a bare
                # store becomes a fresh transport in as_transport —
                # either way the session caused the transport to exist,
                # so the session must close it (worker pools); a
                # transport instance the caller handed in stays theirs.
                # a `replicate(s, n)` marker multiplies each source into
                # n replica rows over the same immutable blob set
                for _rep in range(n_rep):
                    made = src(s) if callable(src) else src
                    transport = as_transport(made)
                    if callable(src) or not isinstance(made,
                                                       StorageTransport):
                        owned.append(transport)
                    row.append(transport)
            transports.append(row)

        # unit specs per live shard: aliased source units first (those
        # documents predate the alias), then the shard's own units —
        # each as (prefix, pinned generation, served-slot set | None)
        unit_specs: list[list[tuple[str, int, frozenset | None]]] = []
        for s, idx, aliases, _n in live:
            specs: list[tuple[str, int, frozenset | None]] = []
            for src, slots in aliases:
                sset = frozenset(int(x) for x in slots)
                specs += [(p, src.generation, sset)
                          for p in [src.base_prefix]
                          + src.segment_prefixes]
            if idx is not None:
                specs += [(p, idx.generation, None)
                          for p in [idx.base_prefix]
                          + idx.segment_prefixes]
            unit_specs.append(specs)

        # ONE batched header round per distinct transport: every unit
        # header (alias sources + base + delta segments) of every shard
        # a transport serves rides one fetch_batch — booting a 16-shard
        # cluster costs one parallel round, never a per-shard chain
        # (the same boot discipline Index.searcher applies within one
        # index). Deduped per (transport, prefix): replicas of one blob
        # set and shards aliasing one source share the header bytes.
        groups: dict[int, tuple[StorageTransport, dict[str, None]]] = {}
        for si, trow in enumerate(transports):
            for t in trow:
                _t, want = groups.setdefault(id(t), (t, {}))
                for p, _g, _f in unit_specs[si]:
                    want.setdefault(p)
        headers: dict[tuple[int, str], bytes] = {}
        boot_stats = FetchStats()
        for t, want in groups.values():
            prefixes = list(want)
            payloads, fstats = t.fetch_batch(
                [RangeRequest(f"{p}/header.airp") for p in prefixes])
            boot_stats.add(fstats)
            for p, h in zip(prefixes, payloads):
                headers[(id(t), p)] = h

        n_slots = self.n_slots
        shard_replicas: list[list[_Replica]] = []
        for si, (_s, idx, _aliases, _n) in enumerate(live):
            replicas = []
            # the shard handle's memory-resident segments (index/nrt.py)
            # serve every replica: their round-1 reads resolve from
            # process memory, so no replica transport mediates them —
            # documents a shard writer add()ed are cluster-searchable
            # before the shard commit publishes their blobs
            memory = idx.memory_segments if idx is not None else []
            for t in transports[si]:
                units = []
                for p, gen, sset in unit_specs[si]:
                    u = Searcher(t, p, cache=cache,
                                 coalesce_gap=coalesce_gap,
                                 generation=gen,
                                 header=headers[(id(t), p)],
                                 device=self.device)
                    if sset is not None:
                        # aliased unit: serve only the entry's slots of
                        # the source blobs — candidates outside them are
                        # dropped before any budget decision, so the
                        # shard answers exactly like a physical one
                        u.ref_filter = _slot_member(sset, n_slots)
                    units.append(u)
                units = units + memory
                reader = units[0] if len(units) == 1 else \
                    MultiSegmentSearcher(units, units[0]._fetcher,
                                         init_stats=FetchStats())
                replicas.append(_Replica(reader=reader, transport=t))
            shard_replicas.append(replicas)
        return ClusterSearcher(shard_replicas,
                               hedge_after_s=hedge_after_s,
                               concurrent=concurrent,
                               generation=self.reader_generation,
                               owned_transports=owned,
                               init_stats=boot_stats,
                               fused=fused,
                               picker=picker,
                               telemetry=telemetry)


# ================================================================ scatter-gather
@dataclass
class _Replica:
    """One replica serving one shard: a reader plus its transport and a
    least-in-flight load gauge (queries currently executing on it)."""

    reader: Searcher | MultiSegmentSearcher
    transport: StorageTransport
    in_flight: int = 0

    @property
    def sim_clock(self):
        """The replica's virtual clock owner, when simulated."""
        t = self.transport
        return t.cloud if isinstance(t, SimCloudTransport) else None


@dataclass
class ScatterReport:
    """Accounting for one scatter-gather round (benchmarks read this).

    The per-shard lists make the top-K budget decision observable:
    `shard_candidates` are the round-1 candidate totals that fed the
    quota computation, `round2_bytes`/`round2_requests` what the
    resulting document round actually cost per shard on the wire (each
    shared round counted once — never the per-job N-fold copies)."""

    shard_elapsed_s: list[float] = field(default_factory=list)
    replica_of: list[int] = field(default_factory=list)
    wall_s: float = 0.0              # concurrent: max; serial: sum
    serial_wall_s: float = 0.0       # sum either way (the loop baseline)
    concurrent: bool = True
    n_hedges_issued: int = 0
    n_hedge_wins: int = 0
    fused: bool = False              # cluster-fused combine path?
    budget: str | None = None        # "global" | "per_shard" | None
    shard_candidates: list[int] = field(default_factory=list)
    round2_bytes: list[int] = field(default_factory=list)
    round2_requests: list[int] = field(default_factory=list)


class ClusterSearcher:
    """Scatter one query batch across shards, gather + merge the results.

    Mirrors the `Searcher` query surface (`query`, `query_batch`,
    `regex_query`). Results are byte-identical to the unsharded index
    over the same corpus; `last_scatter` reports per-shard wall clocks
    for the round that produced them.
    """

    def __init__(self, shard_replicas: list[list[_Replica]],
                 hedge_after_s: float | None = None,
                 concurrent: bool = True,
                 generation: tuple = (),
                 owned_transports: list[StorageTransport] | None = None,
                 init_stats: FetchStats | None = None,
                 fused: bool = False,
                 picker=None,
                 telemetry=None) -> None:
        assert shard_replicas, "need at least one non-empty shard"
        self.shard_replicas = shard_replicas
        self.hedge_after_s = hedge_after_s
        self.concurrent = concurrent
        # default for query_batch(fused=None): run the cluster-fused
        # combine + global top-K budget path instead of per-shard
        # query_batch legs
        self.fused = fused
        # generation pin for result caches (matches reader_generation of
        # the ShardedIndex that opened this session)
        self.generation = generation
        self._owned_transports = owned_transports or []
        self.last_scatter = ScatterReport()
        self._lock = OrderedLock("cluster.scatter")
        self._pool: ThreadPoolExecutor | None = None
        # boot cost: the batched header round(s), plus whatever any
        # reader fetched on its own (zero when the session pre-fetched)
        self.init_stats = init_stats or FetchStats()
        for replicas in shard_replicas:
            for r in replicas:
                self.init_stats.add(r.reader.init_stats)
        # replica policy + exported gauges (serving/control.py): the
        # picker sees a load vector, never the replica objects; with a
        # telemetry registry every replica's in-flight level is exported
        # as `replica.s<shard>.r<idx>.in_flight` — the shared-nothing
        # signal other frontend processes' pickers read
        from .control import as_picker
        self._picker = as_picker(picker)
        self.telemetry = telemetry
        self._replica_gauges: dict[int, object] = {}
        if telemetry is not None:
            self._h_round = telemetry.histogram("cluster.round_s")
            self._c_hedges = telemetry.counter("cluster.hedges_issued")
            self._c_hedge_wins = telemetry.counter("cluster.hedge_wins")
            self._c_r2_bytes = telemetry.counter("cluster.round2_bytes")
            for si, replicas in enumerate(shard_replicas):
                for ri, r in enumerate(replicas):
                    g = telemetry.gauge(
                        f"replica.s{si}.r{ri}.in_flight")
                    self._replica_gauges[id(r)] = g
                    fetcher = getattr(r.reader, "_fetcher", None)
                    if fetcher is not None:
                        fetcher.bind_telemetry(
                            telemetry, prefix=f"fetch.s{si}.r{ri}")
                    r.transport.bind_telemetry(
                        telemetry, prefix=f"transport.s{si}.r{ri}")

    # -- plumbing ---------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self.shard_replicas)

    @property
    def n_replicas(self) -> int:
        return len(self.shard_replicas[0])

    def close(self) -> None:
        """Shut the scatter pool and every replica transport this
        session caused to exist (factory-minted or store-wrapped) —
        long-lived servers reopen sessions on refresh, and unclosed
        replica pools would accumulate threads. Idempotent."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        for t in self._owned_transports:
            t.close()
        self._owned_transports = []

    def __enter__(self) -> "ClusterSearcher":
        return self

    def __exit__(self, *_exc) -> None:
        self.close()

    def _executor(self) -> ThreadPoolExecutor:
        if self._pool is None:
            # 3x shards: on the real-transport hedge path every scatter
            # leg occupies a worker AND submits its primary to the pool,
            # so a correlated straggle across all shards needs leg +
            # primary + backup workers simultaneously — 2x would queue
            # the backups behind the very stragglers they must race
            self._pool = ThreadPoolExecutor(
                max_workers=3 * self.n_shards,
                thread_name_prefix="scatter")
        return self._pool

    def _pick_replica(self, replicas: list[_Replica],
                      exclude: int | None = None) -> int:
        """Replica choice, delegated to the session's picker policy
        (default `LeastLoaded`: argmin, ties to the lowest index;
        `PowerOfTwoChoices` for multi-frontend deployments —
        serving/control.py explains why).

        Load is the replica's executing shard queries plus its
        transport's own outstanding range-GETs (`in_flight` gauge,
        storage/transport.py) — a transport shared with other readers
        counts their traffic too."""
        with self._lock:
            loads = [r.in_flight + r.transport.in_flight
                     for r in replicas]
            best = self._picker.pick(loads, exclude=exclude)
            r = replicas[best]
            r.in_flight += 1
            self._export_load(r)
            return best

    def _release(self, replica: _Replica) -> None:
        with self._lock:
            replica.in_flight -= 1
            self._export_load(replica)

    def _export_load(self, replica: _Replica) -> None:
        g = self._replica_gauges.get(id(replica))
        if g is not None:
            g.set(replica.in_flight)

    def _observe_scatter(self, report: ScatterReport) -> None:
        if self.telemetry is None:
            return
        self._h_round.observe(report.wall_s)
        if report.n_hedges_issued:
            self._c_hedges.inc(report.n_hedges_issued)
        if report.n_hedge_wins:
            self._c_hedge_wins.inc(report.n_hedge_wins)
        r2 = sum(report.round2_bytes)
        if r2:
            self._c_r2_bytes.inc(r2)

    # -- one shard --------------------------------------------------------
    def _run_on(self, replica: _Replica, queries, top_k, hedge, impl,
                ) -> tuple[list[QueryResult], float, BatchStats]:
        """Execute the batch on one replica; returns (results, elapsed,
        batch-level fetch stats).

        Elapsed is the replica's virtual-clock delta when simulated, real
        wall time otherwise."""
        clock = replica.sim_clock
        t0 = clock.clock_s if clock is not None else time.perf_counter()
        bstats = BatchStats()
        try:
            out = replica.reader.query_batch(queries, top_k=top_k,
                                             hedge=hedge, impl=impl,
                                             batch_stats=bstats)
        finally:
            self._release(replica)
        t1 = clock.clock_s if clock is not None else time.perf_counter()
        return out, t1 - t0, bstats

    def _query_shard(self, replicas: list[_Replica], queries, top_k,
                     hedge, impl) -> tuple[list[QueryResult], float, int,
                                           int, int, BatchStats]:
        """One shard's scatter leg: pick replica, run, hedge a straggler.

        Returns (results, effective_elapsed, replica_idx, hedges, wins,
        batch_stats)."""
        primary_i = self._pick_replica(replicas)
        primary = replicas[primary_i]
        threshold = self.hedge_after_s

        if threshold is not None and len(replicas) > 1 \
                and primary.sim_clock is None:
            # real transports: race the primary against a duplicate
            # issued once the threshold passes, first responder wins
            t0 = time.perf_counter()
            fut = self._executor().submit(self._run_on, primary, queries,
                                          top_k, hedge, impl)
            done, _ = wait([fut], timeout=threshold)
            if done:
                out, _elapsed, bstats = fut.result()
                return (out, time.perf_counter() - t0, primary_i, 0, 0,
                        bstats)
            backup_i = self._pick_replica(replicas, exclude=primary_i)
            bfut = self._executor().submit(
                self._run_on, replicas[backup_i], queries, top_k, hedge,
                impl)
            done, _ = wait([fut, bfut], return_when=FIRST_COMPLETED)
            winner = fut if fut in done else bfut
            loser = bfut if winner is fut else fut
            loser.add_done_callback(lambda f: f.exception())
            out, _elapsed, bstats = winner.result()
            return (out, time.perf_counter() - t0,
                    backup_i if winner is bfut else primary_i, 1,
                    1 if winner is bfut else 0, bstats)

        out, elapsed, bstats = self._run_on(primary, queries, top_k,
                                            hedge, impl)
        if threshold is not None and len(replicas) > 1 \
                and elapsed > threshold:
            # simulated transports: the duplicate is issued AT the
            # threshold on the backup's own clock; the faster completion
            # wins (same math as transport-level hedging)
            backup_i = self._pick_replica(replicas, exclude=primary_i)
            bout, belapsed, bbstats = self._run_on(
                replicas[backup_i], queries, top_k, hedge, impl)
            if threshold + belapsed < elapsed:
                return (bout, threshold + belapsed, backup_i, 1, 1,
                        bbstats)
            return (out, elapsed, primary_i, 1, 0, bstats)
        return (out, elapsed, primary_i, 0, 0, bstats)

    # -- queries ----------------------------------------------------------
    def query_batch(self, queries: list[Query | str],
                    top_k: int | None = None, hedge: bool = False,
                    impl: str = "bitmap", fused: bool | None = None,
                    budget: str = "global") -> list[QueryResult]:
        """Scatter the batch to every shard, gather, merge per query.

        Under `impl="bitmap"` (the default) each shard leg combines on
        its units' device; `impl="sorted"` runs NumPy set ops on the
        host. The fused path always combines on the device.

        Shards with distinct (or no) virtual clocks run concurrently —
        the round costs the slowest shard; shards sharing one simulated
        clock fall back to a deterministic sequential drive.

        `fused=True` (default: the session's `fused` flag) switches to
        the cluster-fused path: shards only run round 1, every (shard,
        query) candidate combine executes in ONE `combine_cluster_keys`
        call on the gather side (on the units' device), and round-2
        document work scatters back out under a top-K sampling `budget`
        — `"global"` evaluates Eq. 6 once over the pooled cluster
        candidates (~k docs total), `"per_shard"` evaluates it
        independently per shard unit (~N·k docs, the unbudgeted
        baseline). Both budgets return byte-identical
        results: the final top-K is always the first k accepted docs in
        the canonical candidate order, and a completion round fetches
        whatever the initial quota left unproven.
        """
        fused = self.fused if fused is None else fused
        if fused:
            return self._query_batch_fused(queries, top_k, hedge, budget)
        concurrent = self.concurrent and self._independent_clocks()
        if concurrent and self.n_shards > 1:
            futs = [self._executor().submit(
                self._query_shard, replicas, queries, top_k, hedge, impl)
                for replicas in self.shard_replicas]
            legs = [f.result() for f in futs]
        else:
            legs = [self._query_shard(replicas, queries, top_k, hedge,
                                      impl)
                    for replicas in self.shard_replicas]

        report = ScatterReport(
            shard_elapsed_s=[leg[1] for leg in legs],
            replica_of=[leg[2] for leg in legs],
            serial_wall_s=sum(leg[1] for leg in legs),
            concurrent=concurrent,
            n_hedges_issued=sum(leg[3] for leg in legs),
            n_hedge_wins=sum(leg[4] for leg in legs),
            shard_candidates=[leg[5].n_candidates for leg in legs],
            round2_bytes=[int(leg[5].docs.bytes_fetched) for leg in legs],
            round2_requests=[int(leg[5].docs.n_requests) for leg in legs])
        report.wall_s = max(report.shard_elapsed_s) if concurrent \
            else report.serial_wall_s
        self.last_scatter = report
        self._observe_scatter(report)
        return [self._merge(j, [leg[0] for leg in legs], top_k, report)
                for j in range(len(queries))]

    # -- fused scatter-gather ----------------------------------------------
    def _fused_round1(self, replica: _Replica, queries, top_k, hedge):
        """Round-1 leg on one shard: plan against the shard's own units
        and run the shared superpost round. No combine happens here —
        the per-word postings travel to the gather side, where the whole
        cluster's combine work runs as one fused kernel launch."""
        clock = replica.sim_clock
        t0 = clock.clock_s if clock is not None else time.perf_counter()
        reader = replica.reader
        units = reader.units if isinstance(reader, MultiSegmentSearcher) \
            else [reader]
        jobs = plan_batch(queries, units=tuple(units), top_k=top_k)
        outs_per_unit, lstats = lookup_units(
            units, [j.lookup_q for j in jobs], reader._fetcher,
            hedge=hedge)
        t1 = clock.clock_s if clock is not None else time.perf_counter()
        return units, jobs, outs_per_unit, lstats, t1 - t0

    def _fused_fetch(self, replica: _Replica, requests,
                     ) -> tuple[list, FetchStats, float]:
        """One round-2 leg: a raw batched document fetch on the shard's
        own fetcher (documents are not cached, matching the single-index
        round-2 path)."""
        clock = replica.sim_clock
        t0 = clock.clock_s if clock is not None else time.perf_counter()
        payloads, fstats = replica.reader._fetcher.fetch_ranges(requests)
        t1 = clock.clock_s if clock is not None else time.perf_counter()
        return payloads, fstats, t1 - t0

    @staticmethod
    def _next_pending(st: dict, top_k: int | None) -> set:
        """Completion step of the budget loop.

        The final answer is defined as the first `top_k` ACCEPTED docs
        in the canonical candidate order — a property of the candidate
        sets, the verifier, and the shared §IV-D permutations alone, so
        it is independent of whatever the initial quota policy selected
        (this is what makes "global" and "per_shard" budgets
        byte-identical). With k docs accepted, any unfetched candidate
        ranked before the k-th accepted could still displace it — fetch
        exactly those; with fewer than k accepted, fall back to the
        unbudgeted fetch (everything left). Each branch strictly shrinks
        the unproven set, so the loop terminates in <= 2 extra rounds
        past the initial quota fetch."""
        canon, fetched = st["canon"], st["fetched"]
        if top_k is None:
            return set()          # everything was selected up front
        accepted = [i for i in canon if st["accepted"].get(i)]
        if len(accepted) < top_k:
            return {i for i in canon if i not in fetched}
        threshold = st["prio"][accepted[top_k - 1]]
        return {i for i in canon
                if i not in fetched and st["prio"][i] < threshold}

    def _query_batch_fused(self, queries, top_k, hedge, budget,
                           ) -> list[QueryResult]:
        """Phase-split scatter-gather: concurrent round-1 legs → ONE
        cluster-fused combine → budgeted round-2 scatter → canonical
        selection with a completion loop. See `query_batch`."""
        if budget not in ("global", "per_shard"):
            raise ValueError(
                f"unknown budget policy {budget!r}: use 'global' or "
                "'per_shard'")
        if not queries:
            return []
        concurrent = self.concurrent and self._independent_clocks()
        n_shards = self.n_shards
        Q = len(queries)
        picked: list[tuple[int, _Replica]] = []
        for replicas in self.shard_replicas:
            i = self._pick_replica(replicas)
            picked.append((i, replicas[i]))
        try:
            # --- phase 1: per-shard superpost rounds (concurrent) -------
            if concurrent and n_shards > 1:
                futs = [self._executor().submit(
                    self._fused_round1, r, queries, top_k, hedge)
                    for _i, r in picked]
                legs = [f.result() for f in futs]
            else:
                legs = [self._fused_round1(r, queries, top_k, hedge)
                        for _i, r in picked]

            # --- phase 2: ONE fused combine over (shard, query) ---------
            # groups flatten every shard's units; group order is
            # shard-major so group index breaks priority ties the same
            # way the non-fused merge breaks shard ties
            groups: list[tuple[int, Searcher]] = []
            plans_by_group, words_by_group, common_by_group = [], [], []
            for si, (units, jobs, outs_per_unit, _l, _e) in enumerate(legs):
                for ui, unit in enumerate(units):
                    groups.append((si, unit))
                    plans_by_group.append(
                        [job.plan if job.plan is not None
                         else physical_plan(job.lookup_q, ())
                         for job in jobs])
                    words_by_group.append(outs_per_unit[ui])
                    common_by_group.append(
                        lambda w, u=unit: word_fingerprint(w) in u.common)
            devices = {unit.device for _si, unit in groups}
            if len(devices) != 1:
                raise ValueError(
                    f"the fused combine runs on one device; this "
                    f"cluster's units sit on {sorted(map(str, devices))}")
            combined, counts = combine_cluster_planned(
                plans_by_group, words_by_group, common_by_group,
                device=devices.pop())
            shard_candidates = [0] * n_shards
            for g, (si, _u) in enumerate(groups):
                shard_candidates[si] += int(counts[g].sum())
            F0s = [unit.F0 for _si, unit in groups]

            # --- phase 3: quotas + canonical candidate order per job ----
            job_state: list[dict] = []
            for j in range(Q):
                per_group_refs: list[list[DocRef]] = []
                R_gs: list[int] = []
                for g, (si, unit) in enumerate(groups):
                    keys, lengths = combined[g][j]
                    # aliased units serve a slot subset of their source
                    # blobs: drop out-of-slot candidates BEFORE the
                    # permutation and the quota computation, so budgets
                    # and tie-breaks match a physical shard exactly
                    keys, lengths = _filter_unit_candidates(unit, keys,
                                                            lengths)
                    if top_k is not None and len(keys):
                        order = topk_order(keys)
                        keys, lengths = keys[order], lengths[order]
                    per_group_refs.append(unit._refs(keys, lengths))
                    R_gs.append(len(keys))
                # dedup into the canonical order: priority = (rank in the
                # group's permutation, group); a doc indexed by several
                # units keeps its smallest priority
                prio: dict[tuple, tuple] = {}
                ref_of: dict[tuple, DocRef] = {}
                shard_of: dict[tuple, int] = {}
                for g, refs in enumerate(per_group_refs):
                    si = groups[g][0]
                    for rank, ref in enumerate(refs):
                        ident = (ref.blob, ref.offset, ref.length)
                        p = (rank, g)
                        if ident not in prio or p < prio[ident]:
                            prio[ident] = p
                            ref_of[ident] = ref
                            shard_of[ident] = si
                canon = sorted(prio, key=lambda i: prio[i])
                delta = legs[0][1][j].delta
                if top_k is None:
                    quotas = R_gs
                elif budget == "global":
                    quotas = shard_quotas(R_gs, top_k, F0s, delta)
                else:    # per_shard: independent Eq. 6 per group (~N·k)
                    quotas = [sample_size(R, top_k, f0, delta) if R else 0
                              for R, f0 in zip(R_gs, F0s)]
                pending: set = set()
                for g, refs in enumerate(per_group_refs):
                    for ref in refs[:quotas[g]]:
                        pending.add((ref.blob, ref.offset, ref.length))
                job_state.append(dict(
                    prio=prio, ref_of=ref_of, shard_of=shard_of,
                    canon=canon, pending=pending, fetched=set(),
                    accepted={}))

            # --- phase 4: budgeted round-2 scatter + completion loop ----
            round2_stats = [FetchStats() for _ in range(n_shards)]
            round2_elapsed = [0.0] * n_shards
            n_rounds2 = 0
            texts_cache: dict[tuple, str] = {}
            content_cache: dict[tuple, DocContent] = {}
            fp_count = [0] * Q
            while any(st["pending"] for st in job_state):
                per_shard_idents: list[list[tuple]] = \
                    [[] for _ in range(n_shards)]
                queued: set = set()
                for st in job_state:
                    for ident in st["pending"]:
                        if ident not in queued and ident not in texts_cache:
                            queued.add(ident)
                            per_shard_idents[st["shard_of"][ident]].append(
                                ident)

                def fetch_leg(si: int):
                    idents = per_shard_idents[si]
                    if not idents:
                        return [], FetchStats(), 0.0
                    return self._fused_fetch(
                        picked[si][1],
                        [RangeRequest(*ident) for ident in idents])

                if concurrent and n_shards > 1:
                    futs = [self._executor().submit(fetch_leg, si)
                            for si in range(n_shards)]
                    legs2 = [f.result() for f in futs]
                else:
                    legs2 = [fetch_leg(si) for si in range(n_shards)]
                for si, (payloads, fstats, elapsed) in enumerate(legs2):
                    round2_stats[si].add(fstats)
                    round2_elapsed[si] += elapsed
                    for ident, payload in zip(per_shard_idents[si],
                                              payloads):
                        texts_cache[ident] = payload.decode("utf-8")
                n_rounds2 += 1

                for j, st in enumerate(job_state):
                    for ident in st["pending"]:
                        st["fetched"].add(ident)
                        job = legs[st["shard_of"][ident]][1][j]
                        ok = _accept(job, ident, texts_cache[ident],
                                     content_cache)
                        st["accepted"][ident] = ok
                        if not ok:
                            fp_count[j] += 1
                    st["pending"] = self._next_pending(st, top_k)

            # --- gather: canonical selection + stats --------------------
            lookup_merged = _merge_fetch([leg[3].lookup for leg in legs],
                                         concurrent)
            docs_merged = _merge_fetch(round2_stats, concurrent)
            results: list[QueryResult] = []
            for j, st in enumerate(job_state):
                accepted = [i for i in st["canon"]
                            if st["accepted"].get(i)]
                if top_k is not None:
                    chosen = accepted[:top_k]
                else:
                    # non-top-K: monolithic (blob, offset) order, same as
                    # the non-fused merge
                    chosen = sorted(accepted)
                stats = QueryStats(
                    lookup=replace(lookup_merged),
                    docs=replace(docs_merged),
                    n_candidates=int(counts[:, j].sum()),
                    n_false_positives=fp_count[j],
                    n_results=len(chosen),
                    rounds=1 + n_rounds2)
                results.append(QueryResult(
                    refs=[st["ref_of"][i] for i in chosen],
                    texts=[texts_cache[i] for i in chosen],
                    stats=stats))

            shard_elapsed = [legs[si][4] + round2_elapsed[si]
                             for si in range(n_shards)]
            report = ScatterReport(
                shard_elapsed_s=shard_elapsed,
                replica_of=[i for i, _r in picked],
                serial_wall_s=sum(shard_elapsed),
                concurrent=concurrent,
                fused=True,
                budget=budget if top_k is not None else None,
                shard_candidates=shard_candidates,
                round2_bytes=[int(s.bytes_fetched)
                              for s in round2_stats],
                round2_requests=[int(s.n_requests)
                                 for s in round2_stats])
            report.wall_s = max(shard_elapsed) if concurrent \
                else report.serial_wall_s
            self.last_scatter = report
            self._observe_scatter(report)
            return results
        finally:
            for _i, r in picked:
                self._release(r)

    def query(self, q: Query | str, top_k: int | None = None,
              hedge: bool = False) -> QueryResult:
        return self.query_batch([q], top_k=top_k, hedge=hedge)[0]

    def regex_query(self, pattern: str, ngram: int = 3) -> QueryResult:
        return self.query(Regex(pattern, ngram))

    # -- merge ------------------------------------------------------------
    def _independent_clocks(self) -> bool:
        """True when no two shards share a simulated virtual clock (each
        leg's latency is then independent and threads stay deterministic;
        real transports have no shared clock at all)."""
        seen: set[int] = set()
        for replicas in self.shard_replicas:
            clocks = {id(r.sim_clock) for r in replicas
                      if r.sim_clock is not None}
            if clocks & seen:
                return False
            seen |= clocks
        return True

    def _merge(self, j: int, per_shard: list[list[QueryResult]],
               top_k: int | None, report: ScatterReport) -> QueryResult:
        """Union shard j-results for query `j` into one QueryResult.

        Shards hold disjoint document sets and each is exact after
        verification, so the union is exact; non-top-K results are
        restored to the monolithic (blob, offset) order, making the
        merged set byte-identical to the unsharded index. Latency stats
        model the scatter: elapsed fields take the max over shards when
        concurrent (the gather barrier) and the sum when serial; count
        fields always sum.
        """
        shard_results = [res[j] for res in per_shard]
        if top_k is not None:
            # bounded-heap pick keyed (rank-in-shard, shard): O(M log k),
            # deterministic, never a full union sort or a shard-major
            # truncation
            refs, texts = _topk_select(
                [r.refs for r in shard_results],
                [r.texts for r in shard_results], top_k)
        else:
            refs, texts = _merge_results(
                [r.refs for r in shard_results],
                [r.texts for r in shard_results],
                already_merged=len(shard_results) == 1,
                sort=True)
        stats = QueryStats(
            lookup=_merge_fetch([r.stats.lookup for r in shard_results],
                                report.concurrent),
            docs=_merge_fetch([r.stats.docs for r in shard_results],
                              report.concurrent),
            n_candidates=sum(r.stats.n_candidates for r in shard_results),
            n_false_positives=sum(r.stats.n_false_positives
                                  for r in shard_results),
            n_results=len(refs),
            rounds=max(r.stats.rounds for r in shard_results))
        return QueryResult(refs=refs, texts=texts, stats=stats)


def _accept(job, ident: tuple, text: str,
            content_cache: dict) -> bool:
    """Run one job's acceptance predicate on a fetched document, sharing
    the lazy `DocContent` (tokenization, word set) across every job that
    verifies the same document."""
    if job.accept_text is not None:
        return job.accept_text(text)
    content = content_cache.get(ident)
    if content is None:
        content = content_cache[ident] = DocContent(text)
    if job.accept_doc is not None:
        return job.accept_doc(content)
    return job.accept_words(content.words)


def _topk_select(refs_lists: list[list[DocRef]],
                 texts_lists: list[list[str]],
                 k: int) -> tuple[list[DocRef], list[str]]:
    """Deterministic bounded-heap top-K selection across shard results.

    Keyed (position-in-shard-ranking, shard): rank r of every shard
    outranks rank r+1 of any shard, so the pick interleaves the shard
    rankings instead of truncating the shard-major concatenation (which
    kept whole early shards and dropped late ones wholesale).
    `heapq.nsmallest` keeps a k-item heap — O(M log k) over M shard
    results, never a full union sort."""
    best: dict[tuple, tuple] = {}
    for s, (rl, tl) in enumerate(zip(refs_lists, texts_lists)):
        for pos, (r, t) in enumerate(zip(rl, tl)):
            ident = (r.blob, r.offset, r.length)
            key = (pos, s)
            cur = best.get(ident)
            if cur is None or key < cur[0]:
                best[ident] = (key, r, t)
    picked = heapq.nsmallest(k, best.values(), key=lambda e: e[0])
    return [e[1] for e in picked], [e[2] for e in picked]


def _merge_fetch(parts: list[FetchStats], concurrent: bool) -> FetchStats:
    """Scatter-gather FetchStats: time overlaps (max) when concurrent,
    chains (sum) when serial; request/byte counters always add."""
    out = FetchStats()
    for p in parts:
        out.add(p)
    if concurrent and parts:
        out.elapsed_s = max(p.elapsed_s for p in parts)
        out.wait_s = max(p.wait_s for p in parts)
        out.download_s = max(p.download_s for p in parts)
    return out


# ============================================================ garbage collection
def cluster_reachable_blobs(blobs, prefix: str, keep: int = 2,
                            leases=None) -> set[str]:
    _management("cluster_reachable_blobs")


def collect_cluster_garbage(source, prefix: str, keep: int = 2,
                            grace_s: float = DEFAULT_GRACE_S,
                            dry_run: bool = False, now: float | None = None,
                            leases=None):
    _management("collect_cluster_garbage")


def _management(name: str):
    raise NotImplementedError(
        f"{name} is not ported yet: ROADMAP queue 1, item 5 (cluster "
        "management)")
