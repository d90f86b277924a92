"""Runtime correctness tooling: `OrderedLock`, the named lock wrapper
with lock-order inversion detection (armed via ``REPRO_LOCK_CHECK=1``).
Stdlib only, so storage and index import it without cycles."""

from .locks import (LockOrderViolation, OrderedLock, arm, armed,
                    bind_telemetry, contention_summary, order_edges,
                    ordered_condition, reset)

__all__ = [
    "LockOrderViolation", "OrderedLock", "arm", "armed",
    "bind_telemetry", "contention_summary", "order_edges",
    "ordered_condition", "reset",
]
