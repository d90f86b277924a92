"""OrderedLock: named locks with runtime lock-order inversion detection.

The serving stack is increasingly multi-threaded — scatter-gather pools,
hedge racers, the frontend batching loop, `GenerationBus` callbacks,
lease handoffs — and a lock-order inversion between any two of those
paths would surface as a *hang*, which the soak test can only report by
timing out.  `OrderedLock` turns the hang into a deterministic failure:

  * every lock in `src/repro_torch` is created through this module (the
    BARE-LOCK lint rule enforces it) and carries a **name**;
  * when armed (``REPRO_LOCK_CHECK=1``, or `arm()`), each acquisition
    records a directed edge *held → acquiring* into one global
    acquisition-order graph.  A cycle in that graph is a potential
    deadlock even if this particular run never interleaved into one, so
    the offending acquire raises `LockOrderViolation` with the cycle
    spelled out in lock names — fail fast, never hang;
  * cycle checking is cheap: edges are deduplicated by a set lookup, a
    union-find over the graph's connected components skips the DFS
    entirely for edges that bridge two components (adding an edge
    between components can never close a cycle), and the DFS runs only
    on the rare same-component insertion;
  * when disarmed the wrapper is a flag check + delegation — no graph,
    no thread-local bookkeeping, no clock reads.

Detection is **per-thread-history**, not per-schedule: a single thread
that acquires A→B in one call path and B→A in another is enough to trip
the detector, so ordinary single-threaded unit tests exercise it.

Contention accounting (the serving control plane's satellite): every
lock counts `contentions` (acquisitions that found the lock held) and,
once `bind_telemetry(registry)` installs a `serving.telemetry.Telemetry`
(duck-typed — this module never imports serving), each contended
acquire's wait lands in a ``lock.<name>.wait_s`` `WindowedHistogram` and
a ``lock.<name>.contentions`` counter, so lock hot-spots show up in
`snapshot()` alongside the in-flight gauges.
"""

from __future__ import annotations

import os
import threading
import weakref
from itertools import count
from threading import get_ident
from time import perf_counter

_ENV_FLAG = "REPRO_LOCK_CHECK"


class LockOrderViolation(RuntimeError):
    """Acquiring this lock would close a cycle in the global
    acquisition-order graph — two code paths take the same locks in
    opposite orders, i.e. a potential deadlock.  `cycle` carries the
    lock names along the offending cycle."""

    def __init__(self, message: str, cycle: list[str]) -> None:
        super().__init__(message)
        self.cycle = cycle


class _Detector:
    """Global acquisition-order graph + union-find over its components.

    All state is guarded by one raw mutex (the detector's own lock is
    necessarily outside the ordering it checks).  Thread-held stacks
    live in a `threading.local` invalidated wholesale by bumping
    `epoch` — `reset()` never has to chase other threads' state.
    """

    def __init__(self) -> None:
        # the detector's own mutex sits outside the order it checks
        self.mutex = threading.Lock()   # lint: allow BARE-LOCK
        self.edges: dict[int, set[int]] = {}
        self.edge_set: set[tuple[int, int]] = set()
        self.parent: dict[int, int] = {}
        self.names: dict[int, str] = {}
        self.epoch = 0
        self.tls = threading.local()

    # -- thread-held stack ------------------------------------------------
    def held(self) -> list:
        tls = self.tls
        if getattr(tls, "epoch", None) != self.epoch:
            tls.epoch = self.epoch
            tls.held = []
        return tls.held

    # -- union-find (callers hold self.mutex) -----------------------------
    def find(self, x: int) -> int:
        parent = self.parent
        root = x
        while parent.get(root, root) != root:
            root = parent[root]
        while parent.get(x, x) != x:            # path compression
            parent[x], x = root, parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb

    # -- cycle search (callers hold self.mutex) ---------------------------
    def path(self, src: int, dst: int) -> list[int] | None:
        """Directed path src → dst in the edge graph, or None."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, trail = stack.pop()
            if node == dst:
                return trail
            for nxt in self.edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, trail + [nxt]))
        return None

    def record(self, held_ids: list[int], new_id: int) -> None:
        """Record held → new edges; raise on the edge that closes a
        cycle (the violating edge is NOT committed, so one bad call
        site does not poison every later check)."""
        with self.mutex:
            for a in held_ids:
                b = new_id
                if a == b or (a, b) in self.edge_set:
                    continue
                if self.find(a) == self.find(b):
                    trail = self.path(b, a)
                    if trail is not None:
                        names = [self.names.get(i, f"lock#{i}")
                                 for i in trail + [b]]
                        raise LockOrderViolation(
                            "lock-order inversion: acquiring "
                            f"{self.names.get(b, b)!r} while holding "
                            f"{self.names.get(a, a)!r} closes the cycle "
                            + " -> ".join(names), cycle=names)
                self.edge_set.add((a, b))
                self.edges.setdefault(a, set()).add(b)
                self.union(a, b)

    def snapshot_edges(self) -> dict[str, set[str]]:
        with self.mutex:
            out: dict[str, set[str]] = {}
            for a, succs in self.edges.items():
                name = self.names.get(a, f"lock#{a}")
                out.setdefault(name, set()).update(
                    self.names.get(b, f"lock#{b}") for b in succs)
            return out

    def reset(self) -> None:
        with self.mutex:
            self.edges.clear()
            self.edge_set.clear()
            self.parent.clear()
            self.epoch += 1


_detector = _Detector()
_ids = count(1)
_registry: "weakref.WeakSet[OrderedLock]" = weakref.WeakSet()
_telemetry = None
_telemetry_prefix = "lock"


def _env_armed() -> bool:
    return os.environ.get(_ENV_FLAG, "") not in ("", "0", "false", "False")


_armed = _env_armed()


def arm(enabled: bool = True) -> None:
    """Turn order checking on/off for the process (overrides the env
    flag; tests use this + `reset()` for isolation)."""
    global _armed
    _armed = enabled


def armed() -> bool:
    return _armed


def reset() -> None:
    """Clear the acquisition-order graph and every thread's held stack
    (epoch bump — no cross-thread mutation). Locks stay registered."""
    _detector.reset()


def order_edges() -> dict[str, set[str]]:
    """The recorded acquisition-order graph, by lock name (a lock-name
    appearing as key acquired **before** each name in its value set).
    By construction the graph is acyclic — a cycle raises at the
    acquire that would have closed it."""
    return _detector.snapshot_edges()


def bind_telemetry(telemetry, prefix: str = "lock") -> None:
    """Export every OrderedLock's contention into a metrics registry
    (`serving.telemetry.Telemetry`, duck-typed): per-name
    ``<prefix>.<name>.contentions`` counters and
    ``<prefix>.<name>.wait_s`` histograms of blocked-acquire waits.
    Applies to existing locks and to locks created afterwards; pass
    ``None`` to unbind."""
    global _telemetry, _telemetry_prefix
    _telemetry, _telemetry_prefix = telemetry, prefix
    for lock in list(_registry):
        lock._bind(telemetry, prefix)


def contention_summary() -> dict[str, dict]:
    """Aggregate contention by lock name (live locks only)."""
    out: dict[str, dict] = {}
    for lock in list(_registry):
        agg = out.setdefault(lock.name,
                             {"locks": 0, "contentions": 0, "wait_s": 0.0})
        agg["locks"] += 1
        agg["contentions"] += lock.contentions
        agg["wait_s"] += lock.wait_s
    return out


class OrderedLock:
    """Named Lock/RLock wrapper participating in global order checking.

    Drop-in for `threading.Lock` (`acquire`/`release`/`locked`, context
    manager) and accepted by `threading.Condition` (implements
    `_is_owned`).  `reentrant=True` wraps an RLock; re-acquisition by
    the owning thread records no order edge.  Disarmed cost is one
    global flag check per acquire; contended acquires additionally
    count `contentions` and (when telemetry is bound) observe the wait.
    """

    __slots__ = ("__weakref__", "name", "reentrant", "_raw", "_id",
                 "_owner", "_depth", "contentions", "wait_s",
                 "_m_contentions", "_m_wait")

    def __init__(self, name: str, reentrant: bool = False) -> None:
        self.name = name
        self.reentrant = reentrant
        # the one sanctioned raw-lock creation site (BARE-LOCK exempts
        # this module): every other lock in src/repro_torch wraps through here
        self._raw = threading.RLock() if reentrant else threading.Lock()
        self._id = next(_ids)
        self._owner: int | None = None
        self._depth = 0
        self.contentions = 0
        self.wait_s = 0.0
        self._m_contentions = self._m_wait = None
        with _detector.mutex:
            _detector.names[self._id] = name
        _registry.add(self)
        if _telemetry is not None:
            self._bind(_telemetry, _telemetry_prefix)

    def _bind(self, telemetry, prefix: str) -> None:
        if telemetry is None or self.name.startswith("telemetry."):
            # the registry's own internal locks must not create metrics
            # in the registry they implement (endless recursion)
            self._m_contentions = self._m_wait = None
            return
        self._m_contentions = telemetry.counter(
            f"{prefix}.{self.name}.contentions")
        self._m_wait = telemetry.histogram(f"{prefix}.{self.name}.wait_s")

    # -- acquisition ------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = get_ident()
        if self.reentrant and self._owner == me:
            got = self._raw.acquire(blocking, timeout)
            if got:
                self._depth += 1
            return got
        if _armed and blocking:
            # a non-blocking try-acquire cannot deadlock (it fails
            # instead of waiting), so it records no order edges
            held = _detector.held()
            if held:
                if any(h is self for h in held):
                    # a non-reentrant lock re-acquired by its owner is a
                    # guaranteed self-deadlock — report it, don't hang
                    raise LockOrderViolation(
                        f"self-deadlock: thread already holds "
                        f"{self.name!r} (use reentrant=True if "
                        "re-entry is intended)", cycle=[self.name])
                _detector.record([h._id for h in held], self._id)
        got = self._raw.acquire(False)
        if not got:
            if not blocking:
                return False
            self.contentions += 1
            if self._m_wait is not None:
                t0 = perf_counter()
                got = self._raw.acquire(True, timeout)
                dt = perf_counter() - t0
                if got:
                    self.wait_s += dt
                    self._m_wait.observe(dt)
                    self._m_contentions.inc()
            else:
                got = self._raw.acquire(True, timeout)
            if not got:
                return False
        self._owner = me
        self._depth = 1
        if _armed:
            _detector.held().append(self)
        return True

    def release(self) -> None:
        if self.reentrant and self._owner == get_ident() and self._depth > 1:
            self._depth -= 1
            self._raw.release()
            return
        # clear ownership BEFORE the raw release: the instant the raw
        # lock frees, another thread's acquire may set _owner
        self._owner = None
        self._depth = 0
        if _armed:
            held = _detector.held()
            for i in range(len(held) - 1, -1, -1):
                if held[i] is self:
                    del held[i]
                    break
        self._raw.release()

    def locked(self) -> bool:
        return self._owner is not None

    def _is_owned(self) -> bool:
        """`threading.Condition` protocol: is the calling thread the
        owner?"""
        return self._owner == get_ident()

    def _release_save(self) -> int:
        """`threading.Condition.wait` protocol: fully release (all
        reentrant levels) and return the state to restore."""
        depth = self._depth if self.reentrant else 1
        for _ in range(depth):
            self.release()
        return depth

    def _acquire_restore(self, depth: int) -> None:
        for _ in range(depth):
            self.acquire()

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *_exc) -> None:
        self.release()

    def __repr__(self) -> str:
        state = "locked" if self._owner is not None else "unlocked"
        return f"OrderedLock({self.name!r}, {state})"


def ordered_condition(name: str) -> threading.Condition:
    """A `threading.Condition` over an `OrderedLock` — the registered
    replacement for argless ``threading.Condition()`` (whose implicit
    RLock would escape order checking)."""
    return threading.Condition(OrderedLock(name, reentrant=True))
