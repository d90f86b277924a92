"""AST-based invariant linter for the port's cross-cutting architecture
rules (`src/repro_torch`).

The engine's correctness story rests on conventions that no unit test
sees whole: storage reads flow through `StorageTransport` so hedging /
deadlines / telemetry apply, control-plane code takes `now` injected so
the virtual-clock replays stay honest, every hand-written kernel's entry
point is pinned to a plain PyTorch `*_ref` by a parity test, deprecated
surfaces stay quarantined behind `repro_torch/compat.py`, and every lock
is an `analysis.locks.OrderedLock` so the lock-order detector covers it.
This module turns each convention into a checkable rule:

  RAW-CLOCK      no wall/monotonic clock reads in control-plane code
  RAW-STORE      no direct BlobStore calls from serving code
  BARE-LOCK      no `threading.Lock`/`RLock`/argless `Condition` outside
                 `analysis/locks.py`
  DEPRECATED-REF no references to quarantined surfaces outside
                 `repro_torch/compat.py`
  KERNEL-PARITY  every kernel entry point has a `*_ref` and a test
  SWALLOWED-EXC  no silently-dropped exceptions in serving/storage paths

Findings carry file:line, the rule id, and a fix hint.  Suppression is
explicit and local: a ``# lint: allow RULE-ID`` pragma on the finding's
line (or the line above) for sites that are *correct* exceptions, and a
checked-in `analysis/baseline.toml` for known debt — the baseline must
only ever shrink (strict mode fails on entries that no longer match
anything, so fixed debt cannot linger as dead allowlist).

Usage: ``python -m repro_torch.analysis.lint [--strict] [paths...]`` or
`run_lint(root)` directly (tests point it at fixture trees). The JAX
package keeps its own linter (`scripts/lint_invariants.py`).
"""

from __future__ import annotations

import argparse
import ast
import re
import sys
from dataclasses import dataclass
from pathlib import Path

# --------------------------------------------------------------------------
# findings, pragmas, baseline
# --------------------------------------------------------------------------

_PRAGMA_RE = re.compile(r"#\s*lint:\s*allow\s+([A-Z0-9\-,\s]+)")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str          # posix-relative to the linted root
    line: int
    message: str
    hint: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}\n" \
               f"    hint: {self.hint}"


@dataclass(frozen=True)
class BaselineEntry:
    """One allowlisted (rule, path) pair with its justification."""

    rule: str
    path: str
    reason: str


class BaselineError(ValueError):
    """analysis/baseline.toml is malformed."""


_KV_RE = re.compile(r'^\s*([A-Za-z_]+)\s*=\s*"([^"]*)"\s*(?:#.*)?$')


def load_baseline(path: Path) -> list[BaselineEntry]:
    """Parse `baseline.toml` — a TOML subset of ``[[baseline]]`` tables
    with quoted-string values (the runtime has no `tomllib`; keeping the
    format trivial keeps the parser honest)."""
    entries: list[BaselineEntry] = []
    current: dict[str, str] | None = None

    def flush() -> None:
        nonlocal current
        if current is None:
            return
        missing = {"rule", "path", "reason"} - current.keys()
        if missing:
            raise BaselineError(
                f"{path}: baseline entry missing {sorted(missing)}: {current}")
        if not current["reason"].strip():
            raise BaselineError(
                f"{path}: baseline entry for {current['path']} needs a "
                "non-empty justification")
        entries.append(BaselineEntry(
            rule=current["rule"], path=current["path"],
            reason=current["reason"]))
        current = None

    for lineno, raw in enumerate(path.read_text().splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[baseline]]":
            flush()
            current = {}
            continue
        m = _KV_RE.match(raw)
        if m is None:
            raise BaselineError(f"{path}:{lineno}: unparseable line {raw!r} "
                                "(expected [[baseline]] or key = \"value\")")
        if current is None:
            raise BaselineError(f"{path}:{lineno}: key outside a "
                                "[[baseline]] table")
        current[m.group(1)] = m.group(2)
    flush()
    return entries


def apply_baseline(findings: list[Finding], entries: list[BaselineEntry],
                   ) -> tuple[list[Finding], list[BaselineEntry]]:
    """Split findings against the allowlist.  Returns ``(remaining,
    unused_entries)`` — an unused entry means the debt it excused is
    gone and the entry must be deleted (shrink-only baseline)."""
    keys = {(e.rule, e.path) for e in entries}
    remaining = [f for f in findings if (f.rule, f.path) not in keys]
    hit = {(f.rule, f.path) for f in findings}
    unused = [e for e in entries if (e.rule, e.path) not in hit]
    return remaining, unused


# --------------------------------------------------------------------------
# per-file context
# --------------------------------------------------------------------------

class _FileCtx:
    """Parsed view of one source file handed to every rule."""

    def __init__(self, root: Path, path: Path) -> None:
        self.path = path
        self.rel = path.relative_to(root).as_posix()
        self.source = path.read_text()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=str(path))
        allowed: dict[int, set[str]] = {}
        for lineno, text in enumerate(self.lines, 1):
            m = _PRAGMA_RE.search(text)
            if m:
                ids = {t.strip() for t in m.group(1).split(",") if t.strip()}
                # pragma covers its own line and the line below, so it
                # can ride above the statement it excuses
                allowed.setdefault(lineno, set()).update(ids)
                allowed.setdefault(lineno + 1, set()).update(ids)
        self.allowed = allowed

    def suppressed(self, rule: str, line: int) -> bool:
        return rule in self.allowed.get(line, ())


def _in(rel: str, *prefixes: str) -> bool:
    return any(rel == p or rel.startswith(p) for p in prefixes)


def _receiver_name(node: ast.AST) -> str | None:
    """Final attribute/name of a call receiver: ``self.store`` -> store."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _import_aliases(tree: ast.AST, module: str, names: set[str]) -> set[str]:
    """Local names bound by ``from <module> import <name> [as alias]``."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == module:
            for alias in node.names:
                if alias.name in names:
                    out.add(alias.asname or alias.name)
    return out


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------

class Rule:
    id: str
    hint: str

    def applies(self, rel: str) -> bool:          # pragma: no cover - abstract
        raise NotImplementedError

    def check(self, ctx: _FileCtx) -> list[Finding]:   # pragma: no cover
        raise NotImplementedError

    def _finding(self, ctx: _FileCtx, line: int, message: str) -> Finding:
        return Finding(rule=self.id, path=ctx.rel, line=line,
                       message=message, hint=self.hint)


class RawClockRule(Rule):
    """Control-plane code must take ``now`` injected.  A raw
    `time.time()` / `time.monotonic()` silently bypasses the virtual
    clock that the 1M-request replay gates depend on;
    `time.perf_counter()` stays legal for measuring *local* durations.
    Genuinely real-time sites (the frontend's threaded batching loop)
    carry a ``# lint: allow RAW-CLOCK`` pragma."""

    id = "RAW-CLOCK"
    hint = ("inject `now` (clock parameter) instead of reading the wall "
            "clock; `time.perf_counter()` is allowed for local durations; "
            "genuinely real-time sites take a `# lint: allow RAW-CLOCK` "
            "pragma")

    _time_attrs = {"time", "monotonic", "monotonic_ns", "time_ns"}

    def applies(self, rel: str) -> bool:
        return _in(rel, "src/repro_torch/serving/", "src/repro_torch/index/",
                   "src/repro_torch/storage/transport.py")

    def check(self, ctx: _FileCtx) -> list[Finding]:
        out = []
        bare = _import_aliases(ctx.tree, "time", self._time_attrs)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            what = None
            if (isinstance(func, ast.Attribute)
                    and isinstance(func.value, ast.Name)):
                mod, attr = func.value.id, func.attr
                if mod == "time" and attr in self._time_attrs:
                    what = f"time.{attr}()"
                elif (attr in ("now", "utcnow") and mod in
                        ("datetime", "dt") and not node.args
                        and not node.keywords):
                    what = f"{mod}.{attr}()"
            elif (isinstance(func, ast.Attribute)
                    and isinstance(func.value, ast.Attribute)
                    and func.value.attr == "datetime"
                    and func.attr in ("now", "utcnow")
                    and not node.args and not node.keywords):
                what = f"datetime.{func.attr}()"
            elif isinstance(func, ast.Name) and func.id in bare:
                what = f"{func.id}() (imported from time)"
            if what is not None:
                out.append(self._finding(
                    ctx, node.lineno, f"raw clock read {what} in "
                    "control-plane code"))
        return out


class RawStoreRule(Rule):
    """Serving code must not talk to a `BlobStore` directly — data-plane
    reads go through `StorageTransport` (hedging/deadlines/telemetry)
    and control-plane manifest traffic through the documented
    ``transport.blobs`` seam."""

    id = "RAW-STORE"
    hint = ("route reads through StorageTransport (`transport.get_range`) "
            "or the `transport.blobs` control-plane seam instead of "
            "holding a raw BlobStore")

    _methods = {"get", "put", "delete", "put_if_absent", "get_range"}
    _store_names = {"store", "blobstore", "blob_store", "backing",
                    "staging", "_store", "_blobstore", "blob"}

    def applies(self, rel: str) -> bool:
        return _in(rel, "src/repro_torch/serving/")

    def _store_like(self, name: str | None) -> bool:
        if name is None:
            return False
        if name == "blobs" or name.endswith("blobs"):
            return False            # the sanctioned control-plane seam
        return (name in self._store_names or name.endswith("_store")
                or name.endswith("blobstore"))

    def check(self, ctx: _FileCtx) -> list[Finding]:
        out = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self._methods):
                continue
            recv = _receiver_name(node.func.value)
            if self._store_like(recv):
                out.append(self._finding(
                    ctx, node.lineno,
                    f"direct BlobStore call `{recv}.{node.func.attr}(...)` "
                    "bypasses the transport layer"))
        return out


class BareLockRule(Rule):
    """Every lock in `src/repro_torch` must be an `analysis.locks.OrderedLock`
    (or `ordered_condition`) so the lock-order detector covers it.  An
    argless ``threading.Condition()`` counts too — its implicit RLock
    would escape order checking."""

    id = "BARE-LOCK"
    hint = ("create locks via repro_torch.analysis.locks: "
            "`OrderedLock(\"layer.purpose\")`, `OrderedLock(name, "
            "reentrant=True)` for RLock, `ordered_condition(name)` for "
            "Condition")

    _ctors = {"Lock", "RLock", "Condition"}

    def applies(self, rel: str) -> bool:
        return (_in(rel, "src/repro_torch/")
                and rel != "src/repro_torch/analysis/locks.py")

    def check(self, ctx: _FileCtx) -> list[Finding]:
        out = []
        bare = _import_aliases(ctx.tree, "threading", self._ctors)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            ctor = None
            if (isinstance(func, ast.Attribute)
                    and isinstance(func.value, ast.Name)
                    and func.value.id == "threading"
                    and func.attr in self._ctors):
                ctor = func.attr
            elif isinstance(func, ast.Name) and func.id in bare:
                ctor = func.id
            if ctor is None:
                continue
            if ctor == "Condition" and (node.args or node.keywords):
                continue            # Condition(existing_lock) is fine
            out.append(self._finding(
                ctx, node.lineno,
                f"bare threading.{ctor}() escapes lock-order checking"))
        return out


class DeprecatedRefRule(Rule):
    """Deprecated surfaces (`search_regex`, the `(cloud, prefix)`
    constructors, ungraced sweeps) are quarantined behind
    `repro_torch/compat.py`; nothing outside the quarantine and its tests may
    reference them, so the surface can only shrink."""

    id = "DEPRECATED-REF"
    hint = ("the deprecated window is closing: migrate the call site "
            "(Query language / keyword ctor / lease-registry GC) or, for "
            "the shim host itself, carry a baseline entry until deletion")

    _names = {"search_regex", "deprecated_call", "warn_ungraced_sweep",
              "allow_deprecated"}

    def applies(self, rel: str) -> bool:
        return (_in(rel, "src/repro_torch/")
                and rel != "src/repro_torch/compat.py")

    def check(self, ctx: _FileCtx) -> list[Finding]:
        out = []
        seen: set[int] = set()
        for node in ast.walk(ctx.tree):
            name = None
            if isinstance(node, ast.Name) and node.id in self._names:
                name = node.id
            elif isinstance(node, ast.Attribute) and node.attr in self._names:
                name = node.attr
            elif (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name in self._names):
                name = node.name
            elif isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    if alias.name in self._names:
                        name = alias.name
                        break
            if name is not None and node.lineno not in seen:
                seen.add(node.lineno)
                out.append(self._finding(
                    ctx, node.lineno,
                    f"reference to deprecated surface `{name}`"))
        return out


class KernelParityRule(Rule):
    """Every entry point of a hand-written kernel in `kernels/*/ops.py`
    must have a plain PyTorch `<name>_ref` in the sibling `ref.py` and be
    named in a `tests/test_torch_*.py`, so the kernel stays pinned to its
    plain version.

    How the rule finds an entry point, per ops.py: a module-level
    function *launches* when its body names `LIBRARY` (the nvcc-built
    library), a name the file imports from its sibling `kernel` module,
    or an attribute of `kernel`; it *reaches a launch* when it launches
    or calls, by name, a function of the same file that reaches one, at
    any depth. An entry point is a public function that reaches a
    launch and takes an `impl` argument — the switch between the kernel
    and its plain version that every entry point of the port has. The
    bare launches (`launch*`) and timing helpers below the entry points
    take no `impl` and are held through them.

    Cross-file by nature: checked once per ops.py against its sibling
    and the test tree."""

    id = "KERNEL-PARITY"
    hint = ("add `<name>_ref` to the sibling ref.py and pin "
            "`<name>` against it in a tests/test_torch_*.py parity test")

    def applies(self, rel: str) -> bool:
        return (rel.startswith("src/repro_torch/kernels/")
                and rel.endswith("/ops.py"))

    @staticmethod
    def _tests(root: Path) -> str:
        tests_dir = root / "tests"
        if not tests_dir.is_dir():
            return ""
        return "\n".join(p.read_text()
                         for p in sorted(tests_dir.glob("test_torch_*.py")))

    @staticmethod
    def _kernel_names(tree: ast.Module) -> set[str]:
        """Local names bound by ``from .kernel import ...``."""
        return {alias.asname or alias.name
                for node in tree.body
                if isinstance(node, ast.ImportFrom) and node.level >= 1
                and node.module == "kernel" for alias in node.names}

    def _reaching(self, tree: ast.Module) -> set[str]:
        """Names of the module-level functions that reach a launch."""
        funcs = {n.name: n for n in tree.body
                 if isinstance(n, ast.FunctionDef)}
        names = self._kernel_names(tree) | {"LIBRARY"}
        direct, calls = set(), {}
        for name, fn in funcs.items():
            calls[name] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Name) and node.id in names or (
                        isinstance(node, ast.Attribute)
                        and isinstance(node.value, ast.Name)
                        and node.value.id == "kernel"):
                    direct.add(name)
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id in funcs):
                    calls[name].add(node.func.id)
        reach = set(direct)
        while True:
            more = {n for n, callees in calls.items() if callees & reach}
            if more <= reach:
                return reach
            reach |= more

    @staticmethod
    def _takes_impl(fn: ast.FunctionDef) -> bool:
        args = fn.args
        return any(a.arg == "impl" for a in
                   args.posonlyargs + args.args + args.kwonlyargs)

    def check(self, ctx: _FileCtx) -> list[Finding]:
        root = ctx.path.parents[len(Path(ctx.rel).parts) - 1]
        ref_path = ctx.path.parent / "ref.py"
        ref_src = ref_path.read_text() if ref_path.exists() else ""
        tests = self._tests(root)
        reach = self._reaching(ctx.tree)
        out = []
        for node in ctx.tree.body:
            if not (isinstance(node, ast.FunctionDef)
                    and not node.name.startswith("_")
                    and node.name in reach and self._takes_impl(node)):
                continue
            if not re.search(rf"\bdef {node.name}_ref\b", ref_src):
                out.append(self._finding(
                    ctx, node.lineno,
                    f"kernel entry point `{node.name}` has no "
                    f"`{node.name}_ref` in {ctx.path.parent.name}/ref.py"))
            elif not re.search(rf"\b{node.name}\b", tests):
                out.append(self._finding(
                    ctx, node.lineno,
                    f"kernel entry point `{node.name}` is never named in a "
                    "tests/test_torch_*.py — parity unpinned"))
        return out


class SwallowedExcRule(Rule):
    """A bare ``except:`` (or ``except Exception: pass``) in a serving
    or storage path turns real failures — lost leases, half-published
    manifests, dead replicas — into silence.  Handlers must log, count,
    re-raise, or narrow the type."""

    id = "SWALLOWED-EXC"
    hint = ("narrow the exception type, or make the handler observable "
            "(telemetry counter / re-raise); deliberate drops must say "
            "why in code, not in silence")

    _broad = {"Exception", "BaseException"}

    def applies(self, rel: str) -> bool:
        return _in(rel, "src/repro_torch/serving/", "src/repro_torch/storage/",
                   "src/repro_torch/index/")

    @staticmethod
    def _body_is_noop(body: list[ast.stmt]) -> bool:
        for stmt in body:
            if isinstance(stmt, ast.Pass):
                continue
            if (isinstance(stmt, ast.Expr)
                    and isinstance(stmt.value, ast.Constant)):
                continue            # docstring / Ellipsis
            return False
        return True

    def check(self, ctx: _FileCtx) -> list[Finding]:
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                out.append(self._finding(
                    ctx, node.lineno,
                    "bare `except:` catches everything, including "
                    "KeyboardInterrupt"))
                continue
            tname = None
            if isinstance(node.type, ast.Name):
                tname = node.type.id
            elif isinstance(node.type, ast.Attribute):
                tname = node.type.attr
            if tname in self._broad and self._body_is_noop(node.body):
                out.append(self._finding(
                    ctx, node.lineno,
                    f"`except {tname}: pass` silently swallows failures"))
        return out


RULES: tuple[Rule, ...] = (RawClockRule(), RawStoreRule(), BareLockRule(),
                           DeprecatedRefRule(), KernelParityRule(),
                           SwallowedExcRule())

RULE_IDS: tuple[str, ...] = tuple(r.id for r in RULES)


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

_SCAN_ROOTS = ("src/repro_torch",)


def _collect(root: Path) -> list[Path]:
    files: list[Path] = []
    for sub in _SCAN_ROOTS:
        base = root / sub
        if base.is_dir():
            files.extend(p for p in sorted(base.rglob("*.py"))
                         if "__pycache__" not in p.parts)
    return files


def run_lint(root: Path, files: list[Path] | None = None) -> list[Finding]:
    """Lint the tree rooted at `root` (or just `files`, which must live
    under it).  Returns pragma-filtered findings sorted by location —
    the baseline has *not* been applied (callers decide)."""
    root = Path(root).resolve()
    targets = ([Path(f).resolve() for f in files] if files is not None
               else _collect(root))
    findings: list[Finding] = []
    for path in targets:
        rel = path.relative_to(root).as_posix()
        active = [r for r in RULES if r.applies(rel)]
        if not active:
            continue
        ctx = _FileCtx(root, path)
        for rule in active:
            findings.extend(f for f in rule.check(ctx)
                            if not ctx.suppressed(f.rule, f.line))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


# --------------------------------------------------------------------------
# command line
# --------------------------------------------------------------------------

REPO_ROOT = Path(__file__).resolve().parents[3]


def main(argv: list[str] | None = None) -> int:
    """Lint the port. Exit status: 0 clean (every finding baselined; with
    --strict the baseline is also exact), 1 findings not in the baseline,
    2 stale baseline entries under --strict (the debt they excused is
    fixed; delete them: the baseline shrinks, never grows)."""
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Run the port's invariant linter over src/repro_torch.")
    parser.add_argument("paths", nargs="*", type=Path,
                        help="files to lint (default: the whole port)")
    parser.add_argument("--root", type=Path, default=REPO_ROOT,
                        help="tree root (default: the repo)")
    parser.add_argument("--baseline", type=Path, default=None,
                        help="allowlist file (default: <root>/src/"
                             "repro_torch/analysis/baseline.toml)")
    parser.add_argument("--strict", action="store_true",
                        help="also fail on stale baseline entries")
    args = parser.parse_args(argv)

    root = args.root.resolve()
    files = [p if p.is_absolute() else Path.cwd() / p
             for p in args.paths] or None
    findings = run_lint(root, files)
    baseline_path = (args.baseline or root / "src" / "repro_torch"
                     / "analysis" / "baseline.toml")
    entries = load_baseline(baseline_path) if baseline_path.exists() else []
    remaining, unused = apply_baseline(findings, entries)

    for finding in remaining:
        print(finding.render())
    if remaining:
        print(f"\n{len(remaining)} finding(s) "
              f"({len(findings) - len(remaining)} baselined)")
        return 1
    # partial runs (explicit paths) can't judge baseline staleness:
    # entries for unlinted files would look unused
    if args.strict and files is None and unused:
        for entry in unused:
            print(f"stale baseline entry: {entry.rule} @ {entry.path} "
                  f"({entry.reason}) — the violation is gone; delete the "
                  "entry")
        return 2
    print(f"clean: 0 findings ({len(entries)} baselined, "
          f"{len(findings)} total matched)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
