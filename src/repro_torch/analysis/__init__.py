"""Correctness tooling, stdlib only, so storage and index import it
without cycles:

  * `analysis.locks` — `OrderedLock`, the named lock wrapper with
    lock-order inversion detection (armed via ``REPRO_LOCK_CHECK=1``);
  * `analysis.lint` — the AST invariant linter over `src/repro_torch`
    (raw clocks, direct store calls, unregistered locks,
    deprecated-surface references, kernel/ref parity, swallowed
    exceptions). Run ``python -m repro_torch.analysis.lint --strict``.

The linter's names load on first use, so that ``python -m`` runs the
module once."""

from .locks import (LockOrderViolation, OrderedLock, arm, armed,
                    bind_telemetry, contention_summary, order_edges,
                    ordered_condition, reset)

_LINT = {"BaselineError", "Finding", "RULE_IDS", "apply_baseline",
         "load_baseline", "run_lint"}


def __getattr__(name: str):
    if name in _LINT:
        from . import lint
        return getattr(lint, name)
    if name == "lint_main":
        from .lint import main
        return main
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BaselineError", "Finding", "RULE_IDS", "apply_baseline",
    "lint_main", "load_baseline", "run_lint",
    "LockOrderViolation", "OrderedLock", "arm", "armed",
    "bind_telemetry", "contention_summary", "order_edges",
    "ordered_condition", "reset",
]
