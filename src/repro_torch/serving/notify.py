"""Generation notifications: push-triggered refresh instead of polling.

`GenerationBus` is a small in-process pub/sub channel between the write
path and the serving tier. `IndexWriter.add()`/`commit()` (and the
cluster's membership publishes) post a `GenerationEvent`; subscribed
readers — `SearchService.follow`, `Frontend.follow`, or any callback —
swap to the new generation when the event is delivered, so freshness is
bounded by delivery latency (microseconds in-process) rather than by a
poll interval.

Like the `Frontend`, the bus runs in two modes mirroring the repo's dual
drive:

  * **threaded** (`GenerationBus(threaded=True)`) — a daemon thread
    delivers events as they are posted; what a real deployment uses.
  * **stepped** (the default) — posts buffer until `drain()` delivers
    them synchronously on the caller's thread; what deterministic tests
    and the virtual-clock benchmarks drive (delivery is a simulation
    step, not a race).

Delivery is at-least-once per subscriber and in post order. Callback
exceptions are counted (`n_callback_errors`) and swallowed so one broken
subscriber cannot wedge the writer or starve other subscribers.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass

from ..analysis.locks import ordered_condition


@dataclass(frozen=True)
class GenerationEvent:
    """One visibility change under `prefix`.

    `kind` is `"memory"` (an `IndexWriter.add()` made documents
    searchable from a memory segment, or an abort retracted one) or
    `"published"` (a commit/merge/membership change CAS-published a new
    durable generation). `generation` is the durable generation at post
    time; `seq` the poster's NRT sequence number (bumps on every memory
    segment add/retract, so (generation, seq) totally orders visibility
    states of one prefix).
    """

    prefix: str
    kind: str
    generation: int
    seq: int = 0


class Subscription:
    """Handle returned by `subscribe`; `cancel()` to stop delivery."""

    def __init__(self, bus: "GenerationBus", callback) -> None:
        self._bus = bus
        self.callback = callback

    def cancel(self) -> None:
        self._bus.unsubscribe(self)


class GenerationBus:
    def __init__(self, threaded: bool = False) -> None:
        self._cond = ordered_condition("notify.bus")
        self._subs: list[Subscription] = []
        self._pending: deque[GenerationEvent] = deque()
        self._threaded = threaded
        self._closed = False
        self.n_posted = 0
        self.n_delivered = 0
        self.n_callback_errors = 0
        self._thread: threading.Thread | None = None
        if threaded:
            self._thread = threading.Thread(target=self._loop,
                                            name="generation-bus",
                                            daemon=True)
            self._thread.start()

    # -- subscription -----------------------------------------------------
    def subscribe(self, callback) -> Subscription:
        """Register `callback(event)`; returns a cancellable handle."""
        sub = Subscription(self, callback)
        with self._cond:
            self._subs.append(sub)
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        with self._cond:
            if sub in self._subs:
                self._subs.remove(sub)

    # -- posting ----------------------------------------------------------
    def post(self, event: GenerationEvent) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("generation bus is closed")
            self._pending.append(event)
            self.n_posted += 1
            self._cond.notify()

    def post_generation(self, prefix: str, kind: str, generation: int,
                        seq: int = 0) -> None:
        """Convenience for posters (the index layer posts through this so
        it never needs to import the serving tier's event type)."""
        self.post(GenerationEvent(prefix=prefix, kind=kind,
                                  generation=int(generation),
                                  seq=int(seq)))

    # -- delivery ---------------------------------------------------------
    @property
    def pending(self) -> int:
        with self._cond:
            return len(self._pending)

    def drain(self) -> int:
        """Deliver every buffered event synchronously; returns how many.

        The stepped-mode drive. Safe (and a no-op most of the time) on a
        threaded bus too — the pop is atomic, so an event is delivered
        by exactly one drainer."""
        events = self._take()
        self._deliver(events)
        return len(events)

    def _take(self) -> list[GenerationEvent]:
        with self._cond:
            events = list(self._pending)
            self._pending.clear()
            return events

    def _deliver(self, events: list[GenerationEvent]) -> None:
        for event in events:
            with self._cond:
                subs = list(self._subs)
            for sub in subs:
                try:
                    sub.callback(event)
                except Exception:
                    self.n_callback_errors += 1
            self.n_delivered += 1

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if self._closed and not self._pending:
                    return
                events = list(self._pending)
                self._pending.clear()
            self._deliver(events)

    def close(self) -> None:
        """Stop the bus; buffered events are delivered first (a posted
        visibility change is never silently dropped — the no-lost-update
        property tests rely on this)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.drain()

    def __enter__(self) -> "GenerationBus":
        return self

    def __exit__(self, *_exc) -> None:
        self.close()
