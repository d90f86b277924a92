"""StorageTransport: the batched async range-GET protocol the read path
speaks (paper §III-A: "lookups are asynchronous parallel range-GETs").

The Searcher never talks to a concrete store anymore — it submits batches
of `RangeRequest`s to a transport and gets back futures plus a
`FetchStats`. That one seam is where cloud realities live:

  * **deadlines + retry** — a request whose first byte does not arrive
    within `deadline_s` is re-issued up to `max_retries` times (the
    standard cure for cloud-storage stragglers that are slow-start, not
    slow-transfer);
  * **hedged duplicates** — with `hedge_after_s`, a duplicate GET is
    issued for any request still headerless after the threshold and the
    first responder wins (§IV-G tail-latency mitigation at the transport
    level, complementary to the sketch's built-in hedge layers);
  * **accounting** — retries, deadline misses, hedges issued/won are all
    threaded into `FetchStats` so services and benchmarks can see them.

Three adapters cover the repo's stores:

  * `SimCloudTransport` over `SimCloudStore` — the default read path.
    With a default policy it delegates straight to `fetch_batch`, so the
    virtual clock, RNG stream, and payloads are bit-identical to the
    pre-transport engine. With a policy it simulates per-request retry /
    hedging on the same latency model.
  * `BlobStoreTransport` over `LocalBlobStore` / `InMemoryBlobStore` —
    real threads, zero latency model; retries re-issue failed reads.

`as_transport` normalizes whatever callers hold (a transport, a
`SimCloudStore`, a bare `BlobStore`) into a transport, which is how the
legacy `Searcher(cloud, prefix)` constructors keep working.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..analysis.locks import OrderedLock
from .blobstore import BlobStore, RangeRequest
from .simcloud import FetchStats, SimCloudStore


class TransportError(RuntimeError):
    """A range-GET failed after exhausting its retry budget.

    `retries` carries how many re-issues actually happened before the
    failure (0 for deterministic fail-fast errors), so accounting stays
    truthful even for failed requests."""

    def __init__(self, message: str, retries: int = 0) -> None:
        super().__init__(message)
        self.retries = retries


@dataclass(frozen=True)
class TransportPolicy:
    """Per-request delivery knobs for one submitted batch.

    The default (no deadline, no hedging) is the pass-through fast path:
    adapters must make it behave exactly like the underlying store.
    """

    deadline_s: float | None = None    # per-attempt first-byte deadline
    max_retries: int = 0               # re-issues after a miss / error
    hedge_after_s: float | None = None  # duplicate GET past this threshold

    @property
    def is_default(self) -> bool:
        return self.deadline_s is None and self.hedge_after_s is None \
            and self.max_retries == 0


DEFAULT_POLICY = TransportPolicy()


class FetchFuture:
    """Result handle for one submitted range-GET.

    `result()` returns the payload bytes, `None` if the request was
    abandoned (hedged wait), or raises `TransportError` if every attempt
    failed.
    """

    __slots__ = ("request", "_payload", "_error", "_done", "_waiter")

    def __init__(self, request: RangeRequest) -> None:
        self.request = request
        self._payload: bytes | None = None
        self._error: BaseException | None = None
        self._done = False
        self._waiter: Callable[[], None] | None = None

    def _resolve(self, payload: bytes | None) -> None:
        self._payload = payload
        self._done = True

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._done = True

    def done(self) -> bool:
        return self._done

    def result(self) -> bytes | None:
        if not self._done and self._waiter is not None:
            self._waiter()
        if not self._done:
            raise TransportError(f"request {self.request} never completed")
        if self._error is not None:
            if isinstance(self._error, TransportError):
                raise self._error          # keep .retries accounting
            raise TransportError(str(self._error)) from self._error
        return self._payload


class TransportBatch:
    """One submitted batch: per-request futures + aggregate FetchStats.

    `results()` blocks until every future is settled and returns
    `(payloads, stats)` — the same shape `SimCloudStore.fetch_batch`
    produced, so call sites migrate mechanically.
    """

    def __init__(self, futures: list[FetchFuture],
                 finalize: Callable[[], FetchStats]) -> None:
        self.futures = futures
        self._finalize = finalize
        self._stats: FetchStats | None = None

    def stats(self) -> FetchStats:
        if self._stats is None:
            self._stats = self._finalize()
        return self._stats

    def results(self) -> tuple[list[bytes | None], FetchStats]:
        payloads = [f.result() for f in self.futures]
        return payloads, self.stats()


class StorageTransport(ABC):
    """Batched async range-GETs plus the blob-level control plane.

    `blobs` exposes the underlying `BlobStore` for writes and listings
    (manifests, index builds) — the data plane (`submit`) is the only
    part a latency model mediates, matching real object stores where
    LIST/PUT are control-plane calls.
    """

    blobs: BlobStore
    policy: TransportPolicy
    _metrics: dict | None = None     # bound by bind_telemetry

    def bind_telemetry(self, telemetry, prefix: str = "transport",
                       ) -> "StorageTransport":
        """Export this transport's traffic into a metrics registry
        (serving/telemetry.py `Telemetry`, duck-typed so the storage
        layer stays import-free of serving): request/retry/hedge/byte
        counters, an in-flight gauge, and a round-latency histogram —
        the observations the serving control plane steers from.
        Returns self for chaining."""
        self._metrics = {
            "requests": telemetry.counter(f"{prefix}.requests"),
            "retries": telemetry.counter(f"{prefix}.retries"),
            "deadline_misses":
                telemetry.counter(f"{prefix}.deadline_misses"),
            "hedges_issued": telemetry.counter(f"{prefix}.hedges_issued"),
            "hedge_wins": telemetry.counter(f"{prefix}.hedge_wins"),
            "bytes": telemetry.counter(f"{prefix}.bytes"),
            "round_s": telemetry.histogram(f"{prefix}.round_s"),
            "in_flight": telemetry.gauge(f"{prefix}.in_flight"),
        }
        return self

    def _observe_fetch(self, stats: FetchStats) -> None:
        m = self._metrics
        if m is None:
            return
        m["requests"].inc(int(stats.n_requests))
        m["retries"].inc(int(stats.n_retries))
        m["deadline_misses"].inc(int(stats.n_deadline_misses))
        m["hedges_issued"].inc(int(stats.n_hedges_issued))
        m["hedge_wins"].inc(int(stats.n_hedge_wins))
        m["bytes"].inc(int(stats.bytes_fetched))
        m["round_s"].observe(float(stats.elapsed_s))

    @property
    def in_flight(self) -> int:
        """Outstanding range-GETs on this transport right now — the load
        signal least-in-flight replica selection reads
        (serving/cluster.py). Adapters with real concurrency maintain
        it; synchronous adapters (the simulator resolves a batch before
        `submit` returns) are always 0."""
        return 0

    @abstractmethod
    def submit(self, requests: list[RangeRequest], *,
               wait_for: int | None = None,
               policy: TransportPolicy | None = None) -> TransportBatch:
        """Issue all `requests` concurrently; `wait_for=k` returns once
        any k have completed (stragglers resolve to None)."""

    # -- synchronous conveniences (what the Searcher phases call) ---------
    def fetch_batch(self, requests: list[RangeRequest],
                    wait_for: int | None = None,
                    ) -> tuple[list[bytes | None], FetchStats]:
        return self.submit(requests, wait_for=wait_for).results()

    def fetch(self, req: RangeRequest) -> tuple[bytes, FetchStats]:
        payloads, stats = self.fetch_batch([req])
        if payloads[0] is None:
            raise TransportError(f"request {req} was abandoned")
        return payloads[0], stats

    # -- lifecycle --------------------------------------------------------
    def close(self) -> None:
        """Release transport resources (worker threads). Idempotent; a
        no-op for transports that own none."""

    def __enter__(self) -> "StorageTransport":
        return self

    def __exit__(self, *_exc) -> None:
        self.close()


class SimCloudTransport(StorageTransport):
    """Transport over `SimCloudStore`'s virtual-clock latency model.

    Default policy delegates to `fetch_batch` untouched — bit-identical
    clocks and payloads to the pre-transport engine (the invariant the
    batched-engine tests pin). A policy with deadlines / hedging
    simulates the extra attempts per request on the same `NetworkModel`
    and advances the store's clock with the resulting batch stats.
    """

    def __init__(self, cloud: SimCloudStore,
                 policy: TransportPolicy | None = None) -> None:
        self.cloud = cloud
        self.blobs = cloud.backing
        self.policy = policy or DEFAULT_POLICY

    def submit(self, requests: list[RangeRequest], *,
               wait_for: int | None = None,
               policy: TransportPolicy | None = None) -> TransportBatch:
        pol = policy or self.policy
        if pol.deadline_s is None and pol.hedge_after_s is None:
            payloads, stats = self.cloud.fetch_batch(requests,
                                                     wait_for=wait_for)
        else:
            payloads, stats = self._fetch_with_policy(requests, pol,
                                                      wait_for)
        futures = []
        for req, p in zip(requests, payloads):
            f = FetchFuture(req)
            f._resolve(p)
            futures.append(f)
        self._observe_fetch(stats)
        return TransportBatch(futures, lambda s=stats: s)

    def _fetch_with_policy(self, requests: list[RangeRequest],
                           pol: TransportPolicy, wait_for: int | None,
                           ) -> tuple[list[bytes | None], FetchStats]:
        """Per-request retry/hedge simulation on the store's model.

        Each request's effective first-byte time is shaped by the policy:
        attempts slower than `deadline_s` are cut off and re-sampled (a
        re-issued GET), and past `hedge_after_s` a duplicate races the
        primary. Scheduling over virtual connections and the shared-NIC
        download time mirror `SimCloudStore.fetch_batch`.
        """
        cloud = self.cloud
        n = len(requests)
        if n == 0:
            return [], FetchStats()
        payloads = [cloud.backing.get_range(r) for r in requests]
        sizes = np.array([len(p) for p in payloads], dtype=np.float64)
        first = cloud.sample_first_byte(n)
        n_retries = n_misses = n_hedges = n_wins = 0
        comp = np.empty(n)
        for i in range(n):
            t = float(first[i])
            spent = 0.0
            if pol.deadline_s is not None:
                tries = 0
                while t > pol.deadline_s and tries < pol.max_retries:
                    spent += pol.deadline_s
                    t = float(cloud.sample_first_byte(1)[0])
                    tries += 1
                    n_retries += 1
                if t > pol.deadline_s:
                    n_misses += 1       # budget exhausted: wait it out
            total = spent + t
            # the hedge threshold is absolute: a request still headerless
            # past hedge_after_s (retry waits included) gets a duplicate
            # issued AT the threshold, racing whatever is in flight
            if pol.hedge_after_s is not None and total > pol.hedge_after_s:
                dup = float(cloud.sample_first_byte(1)[0])
                n_hedges += 1
                if pol.hedge_after_s + dup < total:
                    total = pol.hedge_after_s + dup
                    n_wins += 1
            comp[i] = total

        wait, download, abandoned = cloud.schedule_batch(comp, sizes,
                                                         wait_for)
        out: list[bytes | None] = [
            None if i in abandoned else payloads[i] for i in range(n)]
        stats = FetchStats(
            elapsed_s=wait + download, wait_s=wait, download_s=download,
            bytes_fetched=int(sizes[sorted(set(range(n)) - abandoned)].sum()),
            n_requests=n + n_retries + n_hedges,
            n_hedged_abandoned=len(abandoned),
            n_retries=n_retries, n_deadline_misses=n_misses,
            n_hedges_issued=n_hedges, n_hedge_wins=n_wins)
        cloud.advance(stats)
        return out, stats


class BlobStoreTransport(StorageTransport):
    """Threaded range-GETs straight at a `BlobStore` (no latency model).

    The paper's 32-thread downloader, for real: each request runs on a
    pool worker; **transient** read errors (`OSError`) are retried up to
    `max_retries` with `n_retries` accounted, while deterministic
    failures (missing blob, invalid range) fail fast. There is no
    simulated clock, so `deadline_s` is advisory: a read still running
    past its budget is recorded as a deadline miss and then waited out —
    a slow-but-successful read never poisons the batch. Hedging a read
    of an in-process store cannot win anything, so `hedge_after_s` is
    ignored here.
    """

    def __init__(self, store: BlobStore,
                 policy: TransportPolicy | None = None,
                 max_workers: int = 32) -> None:
        self.blobs = store
        self.policy = policy or DEFAULT_POLICY
        self._max_workers = max_workers
        self._pool: ThreadPoolExecutor | None = None
        self._in_flight = 0
        self._gauge_lock = OrderedLock("transport.gauge")

    @property
    def in_flight(self) -> int:
        return self._in_flight

    def _executor(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self._max_workers,
                thread_name_prefix="blob-transport")
        return self._pool

    def close(self) -> None:
        """Shut down the worker pool. Long-lived processes that open many
        transports (`as_transport` makes one per `Index.open` on a bare
        store) should close them — or share one transport — so idle
        worker threads do not accumulate."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def _dec_in_flight(self, _fut) -> None:
        with self._gauge_lock:
            self._in_flight -= 1
        m = self._metrics
        if m is not None:
            m["in_flight"].set(self._in_flight)

    def _get_with_retry(self, req: RangeRequest,
                        pol: TransportPolicy) -> tuple[bytes, int]:
        attempts = 1 + max(0, pol.max_retries)
        last: BaseException | None = None
        for attempt in range(attempts):
            try:
                return self.blobs.get_range(req), attempt
            except OSError as exc:       # transient I/O: worth re-issuing
                last = exc
            except (KeyError, ValueError) as exc:
                raise TransportError(f"{req} failed: {exc}",
                                     retries=attempt) from exc
        assert last is not None
        raise TransportError(
            f"{req} failed after {attempts} attempts: {last}",
            retries=attempts - 1) from last

    def submit(self, requests: list[RangeRequest], *,
               wait_for: int | None = None,
               policy: TransportPolicy | None = None) -> TransportBatch:
        del wait_for    # no virtual clock: every issued read completes
        pol = policy or self.policy
        t0 = time.perf_counter()
        futures = [FetchFuture(r) for r in requests]
        # gauge counts from SUBMISSION, not execution start: requests
        # queued behind a saturated worker pool are load too, and the
        # least-in-flight replica picker must see them
        with self._gauge_lock:
            self._in_flight += len(requests)
        if self._metrics is not None:
            self._metrics["in_flight"].set(self._in_flight)
        raw = [self._executor().submit(self._get_with_retry, r, pol)
               for r in requests]
        for f in raw:
            f.add_done_callback(self._dec_in_flight)
        timeout = None
        if pol.deadline_s is not None:
            timeout = pol.deadline_s * (1 + max(0, pol.max_retries))

        sizes = [0] * len(requests)
        retries = [0] * len(requests)
        misses = [0] * len(requests)

        def _settle(i: int) -> None:
            if futures[i].done():
                return
            try:
                try:
                    payload, n_retry = raw[i].result(timeout=timeout)
                except FuturesTimeout:
                    misses[i] = 1        # budget blown: note it, wait on
                    payload, n_retry = raw[i].result()
            except TransportError as exc:
                retries[i] = exc.retries   # re-issues that really happened
                futures[i]._fail(exc)
            else:
                # budget is measured from submission: a read that already
                # finished by settle time still missed if it ran long
                if timeout is not None \
                        and time.perf_counter() - t0 > timeout:
                    misses[i] = 1
                sizes[i] = len(payload)
                retries[i] = n_retry
                futures[i]._resolve(payload)

        for i, f in enumerate(futures):
            f._waiter = lambda i=i: _settle(i)

        def _finalize() -> FetchStats:
            for i in range(len(futures)):
                _settle(i)
            n_retries = sum(retries)
            stats = FetchStats(
                elapsed_s=time.perf_counter() - t0,
                bytes_fetched=sum(sizes),
                n_requests=len(requests) + n_retries,
                n_retries=n_retries,
                n_deadline_misses=sum(misses))
            self._observe_fetch(stats)
            return stats

        return TransportBatch(futures, _finalize)


def as_transport(source, policy: TransportPolicy | None = None,
                 ) -> StorageTransport:
    """Normalize a store handle into a `StorageTransport`.

    Accepts an existing transport (returned as-is; `policy` must then be
    None), a `SimCloudStore`, or a bare `BlobStore`.
    """
    if isinstance(source, StorageTransport):
        if policy is not None:
            raise ValueError("pass the policy to the transport itself")
        return source
    if isinstance(source, SimCloudStore):
        return SimCloudTransport(source, policy=policy)
    if isinstance(source, BlobStore):
        return BlobStoreTransport(source, policy=policy)
    raise TypeError(
        f"cannot build a StorageTransport from {type(source).__name__}")
