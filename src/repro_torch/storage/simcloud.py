"""Simulated cloud storage: the paper's Fig. 2 affine latency model.

The container is offline and CPU-only, so instead of measuring GCS we model
it: every request pays a first-byte latency (lognormal around a base, with a
long-tail mixture for stragglers — paper §IV-G) plus bytes/bandwidth. A batch
of requests is scheduled over `concurrency` virtual connections exactly like
the paper's 32-thread downloader. All timing flows through a deterministic
seeded virtual clock — no sleeping — so benchmark latencies are reproducible
bit-for-bit while preserving the paper's trends (within-region vs cross-region,
wait-time vs download-time breakdowns, hedged-read tail mitigation).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from .blobstore import BlobStore, RangeRequest


@dataclass(frozen=True)
class NetworkModel:
    """Affine latency model of a VM <-> cloud-storage link (paper Fig. 2).

    latency(request) = first_byte * lognormal(jitter) * tail + bytes / bandwidth
    """

    first_byte_s: float = 0.030       # ~30 ms to first byte, within-region
    bandwidth_bps: float = 100e6      # ~100 MB/s effective per connection
    jitter_sigma: float = 0.20        # lognormal sigma on first-byte latency
    tail_prob: float = 0.01           # long-tail stragglers (paper §IV-G)
    tail_scale: float = 8.0           # straggler first-byte multiplier
    name: str = "us-central1"

    def scaled(self, factor: float, name: str) -> "NetworkModel":
        """A farther region: first-byte latency scales with distance."""
        return replace(self, first_byte_s=self.first_byte_s * factor, name=name)


# The paper's cross-region setup (§V-B0b): VM in Iowa / London / Singapore,
# bucket in multi-region US. First-byte grows with physical distance;
# cross-continent bandwidth degrades too.
REGIONS = {
    "us-central1": NetworkModel(),
    "europe-west2": NetworkModel(first_byte_s=0.110, bandwidth_bps=60e6,
                                 name="europe-west2"),
    "asia-southeast1": NetworkModel(first_byte_s=0.230, bandwidth_bps=35e6,
                                    name="asia-southeast1"),
}


@dataclass
class FetchStats:
    """Per-batch latency accounting (drives the Fig. 8 breakdown)."""

    elapsed_s: float = 0.0       # wall clock of the whole batch
    wait_s: float = 0.0          # sum over the critical path of first-byte time
    download_s: float = 0.0      # critical-path transfer time
    bytes_fetched: int = 0
    n_requests: int = 0
    n_hedged_abandoned: int = 0  # hedged requests we did not wait for
    cache_hits: int = 0          # range reads served by a SuperpostCache
    cache_bytes_saved: int = 0   # payload bytes those hits avoided fetching
    # transport-level accounting (storage/transport.py policies)
    n_retries: int = 0           # re-issued after a deadline miss / error
    n_deadline_misses: int = 0   # requests that ran out of retry budget
    n_hedges_issued: int = 0     # duplicate GETs issued for tail latency
    n_hedge_wins: int = 0        # duplicates that beat their primary

    def add(self, other: "FetchStats") -> None:
        self.elapsed_s += other.elapsed_s
        self.wait_s += other.wait_s
        self.download_s += other.download_s
        self.bytes_fetched += other.bytes_fetched
        self.n_requests += other.n_requests
        self.n_hedged_abandoned += other.n_hedged_abandoned
        self.cache_hits += other.cache_hits
        self.cache_bytes_saved += other.cache_bytes_saved
        self.n_retries += other.n_retries
        self.n_deadline_misses += other.n_deadline_misses
        self.n_hedges_issued += other.n_hedges_issued
        self.n_hedge_wins += other.n_hedge_wins


class SimCloudStore:
    """A BlobStore view through a simulated network.

    `fetch_batch` is the core primitive: one batch of concurrent range reads,
    returning both payloads and the simulated latency. This is exactly the
    operation IoU Sketch was designed around — its whole point is that a
    lookup costs ONE such batch, never a dependent chain.
    """

    def __init__(self, backing: BlobStore, model: NetworkModel | None = None,
                 concurrency: int = 32, seed: int = 0) -> None:
        self.backing = backing
        self.model = model or NetworkModel()
        self.concurrency = int(concurrency)
        self._rng = np.random.default_rng(seed)
        self.clock_s = 0.0           # virtual wall clock, advanced per batch
        self.totals = FetchStats()   # lifetime accounting

    # -- single-request latency sample ------------------------------------
    def _sample_first_byte(self, n: int) -> np.ndarray:
        m = self.model
        base = m.first_byte_s * np.exp(
            self._rng.normal(0.0, m.jitter_sigma, size=n))
        tail = self._rng.random(n) < m.tail_prob
        return np.where(tail, base * m.tail_scale, base)

    def sample_first_byte(self, n: int) -> np.ndarray:
        """Draw `n` first-byte latencies from the model (advances the RNG).

        Public so a `StorageTransport` policy (retry, hedged duplicates)
        can simulate extra attempts on the same latency distribution.
        """
        return self._sample_first_byte(n)

    def advance(self, stats: FetchStats) -> None:
        """Account a batch simulated outside `fetch_batch` (transport
        policies): advance the virtual clock and lifetime totals."""
        self.clock_s += stats.elapsed_s
        self.totals.add(stats)

    def schedule_batch(self, service_s: np.ndarray, sizes: np.ndarray,
                       wait_for: int | None,
                       ) -> tuple[float, float, set[int]]:
        """The batch latency model, shared with transport policies.

        Per-request service times (first-byte latencies, however shaped)
        are assigned greedily to `concurrency` virtual connections in
        issue order (matches a thread-pool downloader); first-byte
        latencies overlap across connections, while transfers share the
        VM's aggregate NIC bandwidth — total-bytes / bandwidth no matter
        how many connections carry it. This is what makes big fetch
        batches bandwidth-bound and small chatty ones latency-bound
        (Fig. 2). Returns `(wait, download, abandoned)` where
        `abandoned` are the requests a `wait_for=k` hedged wait gave up
        on.
        """
        n = len(service_s)
        conn_free = np.zeros(min(self.concurrency, n))
        done = np.empty(n)
        for i in range(n):
            c = int(np.argmin(conn_free))
            done[i] = conn_free[c] + service_s[i]
            conn_free[c] = done[i]
        k = n if wait_for is None else min(int(wait_for), n)
        order = np.argsort(done)
        kept = order[:k]
        wait = float(done[kept[-1]])
        download = float(sizes[kept].sum() / self.model.bandwidth_bps)
        return wait, download, set(order[k:].tolist())

    def _transfer_time(self, sizes: np.ndarray) -> np.ndarray:
        return sizes / self.model.bandwidth_bps

    # -- batched fetch ------------------------------------------------------
    def fetch_batch(self, requests: list[RangeRequest],
                    wait_for: int | None = None) -> tuple[list[bytes | None], FetchStats]:
        """Issue all `requests` concurrently; return payloads + latency.

        `wait_for=k` enables the paper's §IV-G hedging: return as soon as any
        k requests complete; the stragglers are abandoned (their payload slot
        is None). Default waits for all.

        Scheduling: requests are assigned greedily to `concurrency` virtual
        connections in issue order (matches a thread-pool downloader).
        """
        n = len(requests)
        if n == 0:
            return [], FetchStats()
        payloads: list[bytes | None] = [
            self.backing.get_range(r) for r in requests]
        sizes = np.array([len(p) for p in payloads], dtype=np.float64)

        first_byte = self._sample_first_byte(n)
        wait, download, abandoned = self.schedule_batch(first_byte, sizes,
                                                        wait_for)
        elapsed = wait + download
        out: list[bytes | None] = [
            None if i in abandoned else payloads[i] for i in range(n)]

        stats = FetchStats(
            elapsed_s=elapsed, wait_s=wait, download_s=download,
            bytes_fetched=int(sizes[list(set(range(n)) - abandoned)].sum()),
            n_requests=n, n_hedged_abandoned=len(abandoned))
        self.clock_s += elapsed
        self.totals.add(stats)
        return out, stats

    def fetch(self, req: RangeRequest) -> tuple[bytes, FetchStats]:
        out, stats = self.fetch_batch([req])
        assert out[0] is not None
        return out[0], stats

    # -- sequential chain (what hierarchical indexes are forced into) ------
    def fetch_chain(self, requests: list[RangeRequest]) -> tuple[list[bytes], FetchStats]:
        """Dependent back-to-back reads: each must finish before the next is
        issued. This is the access pattern of B-trees / skip lists on cloud
        storage (paper §II-B) and exists so baselines can be simulated
        faithfully."""
        outs: list[bytes] = []
        total = FetchStats()
        for r in requests:
            payload, stats = self.fetch(r)
            outs.append(payload)
            total.add(stats)
        return outs, total
