"""Deprecation escalation: typed errors behind one compat flag.

The long-deprecated shims — `SearchService.search_regex`, the
`(cloud, prefix)` searcher constructors, and ungraced GC sweeps without
a `LeaseRegistry` — spent several releases as `DeprecationWarning`s.
They now raise typed errors by default; every in-repo caller has been
migrated to the modern API (`search(Regex(...))`, transports /
`Index.open(...).searcher()`, lease-registered sweeps).

Out-of-repo callers that cannot migrate yet set the environment flag

    REPRO_ALLOW_DEPRECATED=1

which restores the old warn-and-work behaviour verbatim — one flag for
all three shims, read at call time (tests flip it with
`monkeypatch.setenv`), so a process can never half-opt-in.

`DeprecatedAPIError` subclasses `TypeError` (misuse of an API surface)
and `UngracedSweepError` subclasses `ValueError` (a dangerous argument
combination); both also subclass `DeprecationWarning`'s conceptual
role — the `.hint` attribute carries the migration target.
"""

from __future__ import annotations

import os
import warnings

_FLAG = "REPRO_ALLOW_DEPRECATED"


class DeprecatedAPIError(TypeError):
    """A removed compatibility shim was called without the compat flag.

    `hint` names the modern replacement."""

    def __init__(self, message: str, hint: str) -> None:
        super().__init__(f"{message} (migrate: {hint}; or set "
                         f"{_FLAG}=1 to restore the deprecated "
                         "behaviour)")
        self.hint = hint


class UngracedSweepError(ValueError, DeprecatedAPIError):
    """GC sweep with `grace_s=0.0` and no `LeaseRegistry`: nothing
    protects a reader that opened its snapshot moments ago."""

    def __init__(self, message: str, hint: str) -> None:
        DeprecatedAPIError.__init__(self, message, hint)


def allow_deprecated() -> bool:
    """True when the process opted back into deprecated shims."""
    return os.environ.get(_FLAG, "") not in ("", "0", "false", "False")


def deprecated_call(message: str, hint: str,
                    error: type = DeprecatedAPIError,
                    stacklevel: int = 3) -> None:
    """Gate a deprecated shim: raise `error` by default, fall back to
    the historical `DeprecationWarning` when the compat flag is set.

    `stacklevel` is counted from the *caller of the shim* as warnings
    always did (this helper adds one frame)."""
    if allow_deprecated():
        warnings.warn(f"{message} (migrate: {hint})", DeprecationWarning,
                      stacklevel=stacklevel)
        return
    raise error(message, hint)
