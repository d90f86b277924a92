"""Weight-bounded LRU caching for the read path.

Two users:

  * `SuperpostCache` sits between the Searcher and `SimCloudStore` so hot
    bins (common words, repeated query terms) stop paying first-byte
    latency at all — each hit removes one range read from the next batch;
  * `SearchService` reuses the plain `LRUCache` for whole query results
    (the paper's §IV-A memoization remark), replacing its old unbounded
    FIFO dict.

Both are deliberately synchronous and in-process: a Searcher is FaaS-style
per-worker state (paper §III-A), so its cache is too. `SuperpostCache`
additionally takes a lock per get/put: the serving tier
(serving/cluster.py) shares ONE superpost cache across shard readers it
drives on concurrent threads, and an unsynchronized OrderedDict corrupts
under that. The plain `LRUCache` stays lock-free — single-caller state.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable

from ..analysis.locks import OrderedLock

_MISSING = object()          # sentinel: a stored None is a real entry


class LRUCache:
    """LRU mapping bounded by total weight (entry count by default).

    `weigh` turns a value into its weight; pass `len` to bound by bytes.
    A single value heavier than `max_weight` is simply not admitted.
    """

    def __init__(self, max_weight: int,
                 weigh: Callable[[object], int] = lambda v: 1) -> None:
        self.max_weight = int(max_weight)
        self.weigh = weigh
        self._data: OrderedDict = OrderedDict()
        self.weight = 0
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._data     # does not touch recency or counters

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def get(self, key: Hashable, default=None):
        try:
            value = self._data[key]
        except KeyError:
            self.misses += 1
            return default
        self._data.move_to_end(key)
        self.hits += 1
        return value

    def put(self, key: Hashable, value) -> None:
        w = self.weigh(value)
        old = self._data.pop(key, _MISSING)
        if old is not _MISSING:
            self.weight -= self.weigh(old)
        if w > self.max_weight:
            return              # never admit — and never keep a stale entry
        self._data[key] = value
        self.weight += w
        while self.weight > self.max_weight:
            _k, v = self._data.popitem(last=False)
            self.weight -= self.weigh(v)

    def clear(self) -> None:
        self._data.clear()
        self.weight = 0


class SuperpostCache:
    """Byte-bounded LRU over raw superpost payloads, keyed by range.

    Keys are `(generation, blob, offset, length)` — a `RangeRequest`'s
    identity qualified by the **index generation** that fetched it — so a
    hit returns the same bytes the store would, and cached runs stay
    result-identical to uncached ones. The generation term is the
    stale-read guard for the index lifecycle (docs/index_lifecycle.md):
    a `writer.commit()`/`merge()` bumps the generation, so a reader
    reopened on the new generation can never be served pre-commit bytes
    even when a rebuild reused the same blob names and ranges. Entries of
    dead generations age out of the LRU naturally. `bytes_saved` counts
    payload bytes served from memory instead of the (simulated) network.
    """

    def __init__(self, max_bytes: int = 32 << 20) -> None:
        self._lru = LRUCache(max_bytes, weigh=len)
        self.bytes_saved = 0
        self._lock = OrderedLock("storage.superpost_cache")

    # -- stats ------------------------------------------------------------
    @property
    def hits(self) -> int:
        return self._lru.hits

    @property
    def misses(self) -> int:
        return self._lru.misses

    @property
    def hit_rate(self) -> float:
        return self._lru.hit_rate

    @property
    def cached_bytes(self) -> int:
        return self._lru.weight

    def __len__(self) -> int:
        return len(self._lru)

    # -- access -----------------------------------------------------------
    @staticmethod
    def _key(blob: str, offset: int, length: int, generation: int) -> tuple:
        return (int(generation), blob, int(offset), int(length))

    def get(self, blob: str, offset: int, length: int,
            generation: int = 0) -> bytes | None:
        with self._lock:
            payload = self._lru.get(
                self._key(blob, offset, length, generation))
            if payload is not None:
                self.bytes_saved += len(payload)
            return payload

    def put(self, blob: str, offset: int, length: int, payload: bytes,
            generation: int = 0) -> None:
        with self._lock:
            self._lru.put(self._key(blob, offset, length, generation),
                          payload)

    def summary(self) -> dict:
        return {
            "hits": self.hits, "misses": self.misses,
            "hit_rate": self.hit_rate, "bytes_saved": self.bytes_saved,
            "cached_bytes": self.cached_bytes, "entries": len(self),
        }
