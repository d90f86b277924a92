"""Lock-cheap metrics registry for the serving control plane.

The control loops in `serving/control.py` steer the frontend from
*observed* behaviour — queue depth, batch service time, per-replica
in-flight — so every layer of the read path exports what it sees:

  * `StorageTransport` — in-flight requests, retries, hedges
  * `Searcher` / `ClusterSearcher` — fetch-round latency and bytes,
    per-replica in-flight gauges
  * `Frontend` — queue depth, queue wait, admitted/shed/deadline-miss

Three metric kinds cover all of it:

  * `Counter` — monotone event count (`inc`).
  * `Gauge` — instantaneous level (`set`/`inc`/`dec`); replica pickers
    read these, so `value` is cheap and lockless on CPython reads.
  * `WindowedHistogram` — a fixed-size ring of recent observations.
    Quantiles are computed over the ring only, so old traffic *decays
    out* by eviction — a windowed estimate, not an all-time one — and
    are cached between observations so a controller polling
    `quantile()` every batch costs O(1) amortized.

Everything is guarded by one small lock per metric (never a registry
lock on the hot path); a metric update is a few instructions, which is
what lets the searcher and transport record per-round without showing
up in the load curves themselves.

The registry is *passive*: layers that are handed a `Telemetry` record
into it, layers that are not skip it entirely (`telemetry=None` is the
default everywhere), so the data plane has zero new obligations.
"""

from __future__ import annotations

import math
from bisect import bisect_left, insort

from ..analysis.locks import OrderedLock


class Counter:
    """Monotone event counter."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = OrderedLock("telemetry.counter")
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Instantaneous level; readable without the lock (single attribute
    load — CPython makes that atomic, and pickers only need a snapshot
    that is *recent*, not serialized)."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = OrderedLock("telemetry.gauge")
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        return self._value


class WindowedHistogram:
    """Quantiles over the last `window` observations.

    A ring buffer plus a sorted mirror kept in sync by `insort`/remove:
    `observe` is O(log w + w) on the mirror's memmove — at the control
    plane's window sizes (≤ a few hundred) that is tens of nanoseconds
    of contiguous doubles, far cheaper than re-sorting per quantile
    query, and `quantile()` itself is O(1) interpolation. The window IS
    the decay: an estimate never goes stale by more than `window`
    observations.
    """

    __slots__ = ("_lock", "_window", "_ring", "_next", "_sorted",
                 "_count", "_sum")

    def __init__(self, window: int = 256) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._lock = OrderedLock("telemetry.histogram")
        self._window = window
        self._ring: list[float] = []
        self._next = 0                 # ring slot the next observe evicts
        self._sorted: list[float] = []
        self._count = 0                # all-time observation count
        self._sum = 0.0                # windowed sum (tracks the ring)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if len(self._ring) < self._window:
                self._ring.append(v)
            else:
                old = self._ring[self._next]
                self._ring[self._next] = v
                self._sum -= old
                # remove exactly one instance of the evicted value
                i = self._index_of(old)
                del self._sorted[i]
            self._next = (self._next + 1) % self._window
            insort(self._sorted, v)

    def _index_of(self, v: float) -> int:
        i = bisect_left(self._sorted, v)
        assert i < len(self._sorted) and self._sorted[i] == v
        return i

    @property
    def count(self) -> int:
        return self._count

    def __len__(self) -> int:
        return len(self._ring)

    def mean(self) -> float:
        with self._lock:
            return self._sum / len(self._ring) if self._ring else 0.0

    def quantile(self, q: float) -> float:
        """Linear-interpolated quantile over the window; 0.0 when empty
        (callers gate on `count` before trusting estimates)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            s = self._sorted
            if not s:
                return 0.0
            if len(s) == 1:
                return s[0]
            pos = q * (len(s) - 1)
            lo = int(math.floor(pos))
            hi = min(lo + 1, len(s) - 1)
            frac = pos - lo
            return s[lo] * (1.0 - frac) + s[hi] * frac

    def summary(self) -> dict:
        with self._lock:
            s = self._sorted
            n = len(s)
        return {
            "count": self._count, "window_n": n,
            "mean": self.mean(),
            "p50": self.quantile(0.50), "p99": self.quantile(0.99),
        }


class Telemetry:
    """Registry of named metrics.

    `counter`/`gauge`/`histogram` are get-or-create (idempotent, so
    every layer can ask for its metric without coordination); the
    registry lock is taken only there, never on updates. `snapshot()`
    flattens everything into one dict for benchmarks and debugging.
    """

    def __init__(self) -> None:
        self._lock = OrderedLock("telemetry.registry")
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, WindowedHistogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            m = self._counters.get(name)
            if m is None:
                m = self._counters[name] = Counter()
            return m

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            m = self._gauges.get(name)
            if m is None:
                m = self._gauges[name] = Gauge()
            return m

    def histogram(self, name: str, window: int = 256) -> WindowedHistogram:
        with self._lock:
            m = self._histograms.get(name)
            if m is None:
                m = self._histograms[name] = WindowedHistogram(window)
            return m

    def gauges_matching(self, prefix: str) -> dict[str, Gauge]:
        """Gauges whose name starts with `prefix` — how a picker reads
        the per-replica in-flight family without knowing its size."""
        with self._lock:
            return {k: g for k, g in self._gauges.items()
                    if k.startswith(prefix)}

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        out: dict = {}
        for k, c in counters.items():
            out[k] = c.value
        for k, g in gauges.items():
            out[k] = g.value
        for k, h in histograms.items():
            out[k] = h.summary()
        return out
