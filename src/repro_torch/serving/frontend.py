"""Admission-controlled serving frontend: bounded queue + micro-batching.

The scatter-gather tier (serving/cluster.py) makes one *batch* cheap; the
frontend is what turns **many users' single queries** into those batches.
Three serving-tier mechanics live here, each deliberately boring and
typed:

  * **admission control** — a bounded request queue; a request arriving
    when the queue is full is shed *immediately* with a typed
    `Overloaded` error (never buffered into unbounded latency). Shedding
    is deterministic: admission is a pure function of queue depth.
  * **deadlines** — each request may carry a timeout; a request whose
    deadline passes while it queues is failed with `DeadlineExceeded`
    at dispatch time instead of wasting a fetch round on an answer
    nobody is waiting for.
  * **dynamic micro-batching** — requests arriving within
    `batch_window_s` of the first waiter (or up to `max_batch`) are
    planned/fetched as ONE shared `search_batch`/`query_batch` round,
    amortizing first-byte latency across users exactly as PR 1's
    batched engine amortized it across queries. The window trades a
    bounded added wait for a large drop in per-request round cost; the
    load generator (benchmarks/serving_tier.py) sweeps it.

The frontend runs either **threaded** (`start()` spawns the batching
loop; `submit` returns a `Future`) or **stepped** (`run_once()` forms and
serves one batch synchronously — what deterministic tests and the
virtual-clock load generator drive).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field

from ..analysis.locks import ordered_condition
from ..index.query import Query


class Overloaded(RuntimeError):
    """Load shed: the bounded request queue is full.

    Typed so callers can distinguish "retry later / spill to another
    frontend" from a query error; carries the depth/limit it shed at.
    """

    def __init__(self, depth: int, limit: int) -> None:
        super().__init__(
            f"request queue full ({depth}/{limit}); shedding")
        self.depth = depth
        self.limit = limit


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before it was dispatched."""


@dataclass(frozen=True)
class FrontendConfig:
    max_queue: int = 64              # admission bound (requests waiting)
    batch_window_s: float = 0.002    # micro-batch collection window
    max_batch: int = 16              # dispatch early once this many wait
    default_timeout_s: float | None = None   # per-request deadline


@dataclass
class FrontendStats:
    """Frontend accounting, identical between stepped and threaded modes.

    Every mutation happens under the frontend's condition lock —
    `submit` runs on caller threads while `_serve` runs on the batching
    loop, and unlocked increments would drop counts under contention
    (tests/test_control_plane.py pins both modes to the same counters
    on the same arrival trace). `n_expired` counts requests whose
    deadline passed while queued (failed at dispatch); `n_deadline_miss`
    is its audit-friendly alias. `n_shed` counts queue-full rejections
    (`Overloaded`), `n_shed_predicted` predictive rejections
    (`PredictedDeadlineMiss` — serving/control.py); both are refused at
    the door, so `n_admitted` counts neither. `queue_wait_s` samples the
    dispatch−arrival wait of every *served* request."""

    n_admitted: int = 0
    n_shed: int = 0
    n_shed_predicted: int = 0
    n_expired: int = 0
    n_batches: int = 0
    batch_sizes: list = field(default_factory=list)
    queue_high_water: int = 0
    queue_wait_s: list = field(default_factory=list)

    @property
    def n_deadline_miss(self) -> int:
        return self.n_expired

    def summary(self) -> dict:
        n_served = sum(self.batch_sizes)
        waits = self.queue_wait_s
        return {
            "n_admitted": self.n_admitted, "n_shed": self.n_shed,
            "n_shed_predicted": self.n_shed_predicted,
            "n_expired": self.n_expired,
            "n_deadline_miss": self.n_deadline_miss,
            "n_batches": self.n_batches,
            "n_served": n_served,
            "mean_batch_size": n_served / self.n_batches
            if self.n_batches else 0.0,
            "queue_high_water": self.queue_high_water,
            "mean_queue_wait_s": sum(waits) / len(waits)
            if waits else 0.0,
        }


@dataclass
class _Pending:
    query: Query | str
    top_k: int | None
    deadline: float | None           # absolute, on the frontend clock
    future: Future
    arrival: float


class Frontend:
    """Micro-batching admission gate in front of any batch-capable reader.

    `backend` is a `SearchService` (its `search_batch` keeps the result
    cache and latency accounting in the loop) or anything exposing
    `query_batch` (a `Searcher`, `MultiSegmentSearcher`, or
    `ClusterSearcher`). `clock` is injectable for **deadlines and
    stepped mode** (what deterministic tests control); the threaded
    loop's batching window always runs on real time, because that is
    what `Condition.wait` sleeps on.
    """

    def __init__(self, backend, config: FrontendConfig | None = None,
                 clock=time.monotonic, controller=None, shedder=None,
                 telemetry=None) -> None:
        self.backend = backend
        self.config = config or FrontendConfig()
        self.clock = clock
        self.stats = FrontendStats()
        # control plane (serving/control.py), all optional: a
        # `BatchController` replaces the static `batch_window_s`, a
        # `DeadlineShedder` adds predictive admission control, and a
        # `Telemetry` registry exports queue depth / wait / shed — the
        # plain static frontend is the `None, None, None` special case
        self.controller = controller
        self.shedder = shedder
        self.telemetry = telemetry
        if telemetry is not None:
            self._g_depth = telemetry.gauge("frontend.queue_depth")
            self._h_wait = telemetry.histogram("frontend.queue_wait_s")
            self._c_admitted = telemetry.counter("frontend.admitted")
            self._c_shed = telemetry.counter("frontend.shed")
            self._c_miss = telemetry.counter("frontend.deadline_miss")
        else:
            self._g_depth = self._h_wait = None
            self._c_admitted = self._c_shed = self._c_miss = None
        self._queue: deque[_Pending] = deque()
        self._cond = ordered_condition("frontend.cond")
        self._thread: threading.Thread | None = None
        self._closed = False
        self._refresh_pending = False
        self._subscription = None
        if not hasattr(backend, "search_batch") \
                and not hasattr(backend, "query_batch"):
            raise TypeError(
                f"{type(backend).__name__} exposes neither search_batch "
                "nor query_batch")

    # -- admission --------------------------------------------------------
    @property
    def depth(self) -> int:
        return len(self._queue)

    def submit(self, query: Query | str, top_k: int | None = None,
               timeout_s: float | None = None) -> Future:
        """Admit one request; returns its `Future`.

        Raises `Overloaded` *synchronously* when the queue is full —
        shedding at the door is the whole point: the caller learns about
        overload after zero fetch rounds and zero queue wait.
        """
        cfg = self.config
        timeout = cfg.default_timeout_s if timeout_s is None else timeout_s
        now = self.clock()
        deadline = None if timeout is None else now + timeout
        with self._cond:
            if self._closed:
                raise RuntimeError("frontend is closed")
            if len(self._queue) >= cfg.max_queue:
                self.stats.n_shed += 1
                if self._c_shed is not None:
                    self._c_shed.inc()
                raise Overloaded(len(self._queue), cfg.max_queue)
            if self.shedder is not None:
                # predictive admission control: raises
                # PredictedDeadlineMiss (a DeadlineExceeded) when the
                # estimated completion already misses the deadline —
                # refusing now costs the caller zero queue wait and the
                # cluster zero fetch rounds
                try:
                    self.shedder.admit(now, deadline, len(self._queue))
                except DeadlineExceeded:
                    self.stats.n_shed_predicted += 1
                    raise
            fut: Future = Future()
            self._queue.append(_Pending(
                query=query, top_k=top_k, deadline=deadline,
                future=fut, arrival=now))
            self.stats.n_admitted += 1
            self.stats.queue_high_water = max(self.stats.queue_high_water,
                                              len(self._queue))
            if self.controller is not None:
                self.controller.on_arrival(now)
            if self._c_admitted is not None:
                self._c_admitted.inc()
            if self._g_depth is not None:
                self._g_depth.set(len(self._queue))
            self._cond.notify()
        return fut

    def search(self, query: Query | str, top_k: int | None = None,
               timeout_s: float | None = None):
        """Blocking convenience over `submit` (threaded mode)."""
        return self.submit(query, top_k=top_k,
                           timeout_s=timeout_s).result()

    # -- dispatch ---------------------------------------------------------
    def run_once(self) -> int:
        """Form ONE micro-batch from whatever is queued and serve it
        synchronously (no window wait). Returns requests dispatched
        (expired ones included). Stepped mode for tests/simulators."""
        with self._cond:
            batch = self._take(self.config.max_batch)
        return self._serve(batch)

    def _take(self, n: int) -> list[_Pending]:
        batch = []
        while self._queue and len(batch) < n:
            batch.append(self._queue.popleft())
        if self._g_depth is not None:
            self._g_depth.set(len(self._queue))
        return batch

    def _window_s(self) -> float:
        """Micro-batch window for the batch opening now: the
        controller's decision when one is attached, the static config
        knob otherwise. Called with the condition lock held."""
        if self.controller is not None:
            return self.controller.window(len(self._queue),
                                          now=self.clock())
        return self.config.batch_window_s

    def follow(self, bus) -> "Frontend":
        """Swap the backend's generation on push (serving/notify.py
        GenerationBus) instead of polling: an event only *flags* the
        refresh; the actual `backend.refresh()` runs on the dispatch
        thread at the next batch boundary — never mid-batch, so every
        request in one micro-batch is served from one snapshot. Requires
        a backend exposing `refresh` (a `SearchService`). Returns self."""
        if not hasattr(self.backend, "refresh"):
            raise TypeError(
                f"{type(self.backend).__name__} exposes no refresh(); "
                "follow() needs a SearchService backend")
        self._subscription = bus.subscribe(self._on_generation)
        return self

    def _on_generation(self, _event) -> None:
        with self._cond:
            self._refresh_pending = True
            self._cond.notify()      # wake the loop so the swap is prompt

    def _maybe_refresh(self) -> None:
        if self._refresh_pending:
            self._refresh_pending = False
            self.backend.refresh()

    def _serve(self, batch: list[_Pending]) -> int:
        self._maybe_refresh()
        if not batch:
            return 0
        now = self.clock()
        live: list[_Pending] = []
        expired: list[_Pending] = []
        for p in batch:
            # a caller may have cancelled its Future while it queued;
            # claiming it here (PENDING -> RUNNING) makes the later
            # set_result/set_exception safe and skips cancelled entries
            # instead of letting InvalidStateError kill the batch loop
            if not p.future.set_running_or_notify_cancel():
                continue
            if p.deadline is not None and now > p.deadline:
                expired.append(p)
                p.future.set_exception(DeadlineExceeded(
                    f"queued {now - p.arrival:.3f}s past its deadline"))
            else:
                live.append(p)
        waits = [now - p.arrival for p in live]
        # stats mutate under the condition lock: `submit` (caller
        # threads) and this method (the batching loop) update the same
        # object, and the stepped/threaded consistency audit only holds
        # if neither side drops increments
        with self._cond:
            self.stats.n_expired += len(expired)
            if live:
                self.stats.n_batches += 1
                self.stats.batch_sizes.append(len(live))
                self.stats.queue_wait_s.extend(waits)
        if self._c_miss is not None and expired:
            self._c_miss.inc(len(expired))
        if self._h_wait is not None:
            for w in waits:
                self._h_wait.observe(w)
        if not live:
            return len(batch)
        # one shared plan/fetch round per distinct top_k (almost always
        # one group — mixed-k batches split but still amortize within k)
        by_k: dict[object, list[_Pending]] = {}
        for p in live:
            by_k.setdefault(p.top_k, []).append(p)
        t0 = self.clock()
        for top_k, group in by_k.items():
            try:
                results = self._execute([p.query for p in group], top_k)
            except BaseException as exc:
                # fan the failure out so no future is abandoned — but
                # only swallow ordinary Exceptions; KeyboardInterrupt/
                # SystemExit must still stop the stepped-mode caller
                for p in group:
                    p.future.set_exception(exc)
                if not isinstance(exc, Exception):
                    raise
            else:
                for p, res in zip(group, results):
                    p.future.set_result(res)
        service_s = self.clock() - t0
        # service feedback drives the window controller and the
        # predictive shedder; on a virtual clock (stepped mode) the
        # delta is the backend's simulated wall, threaded it is real
        if self.controller is not None:
            self.controller.on_batch(service_s, len(live))
        if self.shedder is not None:
            self.shedder.on_batch(service_s, len(live))
        return len(batch)

    def _execute(self, queries: list, top_k) -> list:
        if hasattr(self.backend, "search_batch"):
            return self.backend.search_batch(queries, top_k=top_k)
        return self.backend.query_batch(queries, top_k=top_k)

    # -- threaded mode ----------------------------------------------------
    def start(self) -> "Frontend":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="frontend-batcher",
                                            daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        cfg = self.config
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed and not self._queue:
                    return
                # dynamic window: collect arrivals for the window
                # (static config, or the BatchController's decision)
                # after the first waiter, dispatch early at max_batch.
                # Condition.wait sleeps in real time, so the window is
                # measured in real time too — an injected `clock` only
                # governs deadlines and stepped mode, never this loop
                # (a fake clock would otherwise leave it waiting forever)
                t_close = time.monotonic() + self._window_s()  # lint: allow RAW-CLOCK
                while len(self._queue) < cfg.max_batch:
                    remaining = t_close - time.monotonic()  # lint: allow RAW-CLOCK
                    if remaining <= 0 or self._closed:
                        break
                    self._cond.wait(timeout=remaining)
                batch = self._take(cfg.max_batch)
            self._serve(batch)

    def close(self) -> None:
        """Stop accepting work; queued requests are drained first.

        Threaded mode: the loop serves what is queued, then exits.
        Stepped mode has no loop, so `close` serves the remainder
        itself — a submitted request's future is ALWAYS completed, never
        silently abandoned."""
        if self._subscription is not None:
            self._subscription.cancel()
            self._subscription = None
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        while self._queue:
            self.run_once()

    def __enter__(self) -> "Frontend":
        return self

    def __exit__(self, *_exc) -> None:
        self.close()
