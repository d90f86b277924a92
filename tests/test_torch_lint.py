"""The port's invariant linter (`repro_torch.analysis.lint`).

Each golden fixture of `tests/test_static_analysis.py`, rewritten under
`src/repro_torch/`, must trip the same rule at the same line (and its
fixed twin must not), so a rule can never silently stop firing; the
port's KERNEL-PARITY rule finds entry points by what they reach rather
than by the word "pallas"; the real port tree must be clean with its
baseline exact; and `python -m repro_torch.analysis.lint --strict` must
exit 0. The JAX package's linter keeps linting only `src/repro` and
`benchmarks`.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis.lint import run_lint as jax_run_lint
from repro_torch.analysis import (RULE_IDS, BaselineError, apply_baseline,
                                  load_baseline, run_lint)

REPO_ROOT = Path(__file__).resolve().parent.parent
PORT = "src/repro_torch"


def _tree(tmp_path: Path, files: dict[str, str]) -> Path:
    for rel, body in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(body))
    return tmp_path


def _found(tmp_path, files):
    return [(f.rule, f.path, f.line)
            for f in run_lint(_tree(tmp_path, files))]


def test_raw_clock_trips_and_perf_counter_passes(tmp_path):
    findings = run_lint(_tree(tmp_path, {
        f"{PORT}/serving/svc.py": """\
            import time
            from time import monotonic

            def bad():
                return time.time() + monotonic()

            def fine():
                return time.perf_counter()
            """,
    }))
    assert [(f.rule, f.line) for f in findings] == \
        [("RAW-CLOCK", 5), ("RAW-CLOCK", 5)]
    assert "now" in findings[0].hint


def test_raw_clock_scope_and_pragma(tmp_path):
    """core/ may read clocks, a pragma above suppresses, the transport is
    in scope; the port has no benchmarks/ and the linter scans none."""
    assert _found(tmp_path, {
        f"{PORT}/core/clock_user.py": "import time\nx = time.time()\n",
        f"{PORT}/index/sweep.py": """\
            import time
            # lint: allow RAW-CLOCK
            t = time.time()
            """,
        f"{PORT}/storage/transport.py": "import time\nt0 = time.monotonic()\n",
        "benchmarks/bench.py": "import time\nt0 = time.monotonic()\n",
    }) == [("RAW-CLOCK", f"{PORT}/storage/transport.py", 2)]


def test_raw_store_trips_and_blobs_seam_passes(tmp_path):
    findings = run_lint(_tree(tmp_path, {
        f"{PORT}/serving/svc.py": """\
            def bad(store):
                return store.get("manifest")

            def fine(transport):
                transport.blobs.put("manifest", b"x")
                return transport.get_range(None)
            """,
    }))
    assert [(f.rule, f.line) for f in findings] == [("RAW-STORE", 2)]
    assert "transport" in findings[0].hint


def test_bare_lock_trips_ordered_condition_passes(tmp_path):
    findings = run_lint(_tree(tmp_path, {
        f"{PORT}/storage/widget.py": """\
            import threading
            from threading import RLock

            a = threading.Lock()
            b = RLock()
            c = threading.Condition()
            d = threading.Condition(a)   # explicit lock: not a creation
            """,
        f"{PORT}/analysis/locks.py": "import threading\n"
                                     "m = threading.Lock()\n",
    }))
    assert [(f.rule, f.line) for f in findings] == \
        [("BARE-LOCK", 4), ("BARE-LOCK", 5), ("BARE-LOCK", 6)]
    assert "repro_torch.analysis.locks" in findings[0].hint


def test_deprecated_ref_trips_outside_compat(tmp_path):
    findings = run_lint(_tree(tmp_path, {
        f"{PORT}/serving/svc.py": """\
            def f(s):
                return s.search_regex("a.b")
            """,
        f"{PORT}/compat.py": "def deprecated_call():\n    pass\n",
    }))
    assert [(f.rule, f.path, f.line) for f in findings] == \
        [("DEPRECATED-REF", f"{PORT}/serving/svc.py", 2)]
    assert "search_regex" in findings[0].message


def test_swallowed_exc_trips_and_observable_handler_passes(tmp_path):
    findings = run_lint(_tree(tmp_path, {
        f"{PORT}/storage/io.py": """\
            def f():
                try:
                    g()
                except:
                    pass

            def g():
                try:
                    h()
                except Exception:
                    pass

            def h():
                try:
                    f()
                except Exception:
                    counter.inc()          # observable: fine
                try:
                    f()
                except ValueError:         # narrowed: fine
                    pass
            """,
    }))
    assert [(f.rule, f.line) for f in findings] == \
        [("SWALLOWED-EXC", 4), ("SWALLOWED-EXC", 10)]


# ---- KERNEL-PARITY: entry points found by what they reach --------------
OPS = f"{PORT}/kernels/foo/ops.py"
OPS_SRC = """\
    from .._build import Library
    from .kernel import foo_cuda

    LIBRARY = Library("foo", None, None)

    def op(x, impl="cuda"):            # reaches LIBRARY through _run
        return _run(x)

    def _run(x):
        return LIBRARY.lib().op_launch(x)

    def fused(x, *, impl="cuda"):      # a name from the kernel module
        return foo_cuda(x)

    def launch(x):                     # bare launch: no impl, not held
        return LIBRARY.lib().op_launch(x)

    def helper(x, impl="cuda"):        # plain torch: no twin required
        return x
    """


def test_kernel_parity_missing_ref_and_missing_test(tmp_path):
    files = {OPS: OPS_SRC, f"{PORT}/kernels/foo/ref.py": ""}
    findings = run_lint(_tree(tmp_path, files))
    assert [(f.rule, f.line) for f in findings] == \
        [("KERNEL-PARITY", 6), ("KERNEL-PARITY", 12)]
    assert "op_ref" in findings[0].message
    assert "fused_ref" in findings[1].message

    # the refs but no test: still unpinned
    (tmp_path / f"{PORT}/kernels/foo/ref.py").write_text(
        "def op_ref(x):\n    return x\n\n\ndef fused_ref(x):\n    return x\n")
    findings = run_lint(tmp_path)
    assert [(f.rule, f.line) for f in findings] == \
        [("KERNEL-PARITY", 6), ("KERNEL-PARITY", 12)]
    assert all("never named in a" in f.message for f in findings)

    # named in a test of the JAX package only: still unpinned
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests/test_foo.py").write_text("op fused\n")
    assert len(run_lint(tmp_path)) == 2

    # refs + a port test naming both: clean
    (tmp_path / "tests/test_torch_foo.py").write_text(
        "from repro_torch.kernels.foo.ops import op, fused\n")
    assert run_lint(tmp_path) == []


def test_kernel_parity_holds_every_entry_point_of_the_port():
    """On the real tree the rule finds each kernel package's entry points
    (and only those): deleting any one's `_ref` from a copy of its ref.py
    must trip it."""
    from repro_torch.analysis.lint import KernelParityRule, _FileCtx
    rule = KernelParityRule()
    found = {}
    for ops in sorted((REPO_ROOT / PORT / "kernels").glob("*/ops.py")):
        ctx = _FileCtx(REPO_ROOT, ops)
        reach = rule._reaching(ctx.tree)
        found[ops.parent.name] = sorted(
            n.name for n in ctx.tree.body if getattr(n, "name", "_")[0] != "_"
            and n.name in reach and rule._takes_impl(n))
    assert found == {
        "attention": ["attention", "attention_bwd", "attention_int8"],
        "intersect": ["combine_batch", "combine_cluster", "combine_keys",
                      "intersect", "intersect_batch", "intersect_keys"],
        "rwkv": ["wkv"],
        "ssm": ["selective_scan", "selective_scan_fused"],
    }


def test_every_rule_has_a_tripping_fixture(tmp_path):
    """The union of the golden fixtures covers all six rules."""
    hit = set()
    for sub, files in {
        "a": {f"{PORT}/serving/a.py": "import time\nt = time.time()\n"},
        "b": {f"{PORT}/serving/b.py": "def f(store):\n    store.get('x')\n"},
        "c": {f"{PORT}/index/c.py": "import threading\nl = threading.Lock()\n"},
        "d": {f"{PORT}/index/d.py":
              "from repro_torch.compat import deprecated_call\n"},
        "e": {f"{PORT}/kernels/k/ops.py":
              "def op(x, impl='cuda'):\n    return LIBRARY.lib()(x)\n",
              f"{PORT}/kernels/k/ref.py": ""},
        "f": {f"{PORT}/storage/f.py":
              "try:\n    pass\nexcept Exception:\n    pass\n"},
    }.items():
        hit |= {f.rule for f in run_lint(_tree(tmp_path / sub, files))}
    assert hit == set(RULE_IDS)
    assert len(RULE_IDS) == 6


def test_the_two_linters_keep_to_their_own_trees(tmp_path):
    """The same violation under each package: each linter sees its own."""
    root = _tree(tmp_path, {
        "src/repro/serving/a.py": "import time\nt = time.time()\n",
        f"{PORT}/serving/a.py": "import time\nt = time.time()\n",
    })
    assert [f.path for f in run_lint(root)] == [f"{PORT}/serving/a.py"]
    assert [f.path for f in jax_run_lint(root)] == ["src/repro/serving/a.py"]


# ---- baseline and the real tree -----------------------------------------
def test_baseline_rejects_missing_reason(tmp_path):
    p = tmp_path / "b.toml"
    p.write_text('[[baseline]]\nrule = "X"\npath = "y.py"\nreason = ""\n')
    with pytest.raises(BaselineError):
        load_baseline(p)


def test_real_port_tree_is_clean_and_baseline_exact():
    findings = run_lint(REPO_ROOT)
    baseline = load_baseline(REPO_ROOT / PORT / "analysis/baseline.toml")
    assert len(baseline) <= 4, "the baseline grows never — fix, don't add"
    assert {e.rule for e in baseline} == {"DEPRECATED-REF"}
    remaining, unused = apply_baseline(findings, baseline)
    assert remaining == [], "un-baselined violations:\n" + \
        "\n".join(f.render() for f in remaining)
    assert unused == [], "stale baseline entries (delete them): " + \
        str([(e.rule, e.path) for e in unused])
    assert all(f.path.startswith(f"{PORT}/") for f in findings)


def _cli(*args, cwd=REPO_ROOT):
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", *args],
        capture_output=True, text=True, env=env, cwd=cwd, timeout=120)


def test_cli_strict_exits_zero():
    proc = _cli("--strict")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stdout and not proc.stderr


def test_cli_exit_codes_on_findings_and_stale_entries(tmp_path):
    root = _tree(tmp_path, {
        f"{PORT}/serving/a.py": "import time\nt = time.time()\n",
        "stale.toml": '[[baseline]]\nrule = "RAW-STORE"\n'
                      f'path = "{PORT}/serving/gone.py"\nreason = "fixed"\n',
        "covers.toml": '[[baseline]]\nrule = "RAW-CLOCK"\n'
                       f'path = "{PORT}/serving/a.py"\nreason = "debt"\n',
    })
    assert _cli("--root", str(root)).returncode == 1
    both = tmp_path / "both.toml"
    both.write_text((root / "covers.toml").read_text()
                    + (root / "stale.toml").read_text())
    assert _cli("--root", str(root), "--baseline", str(both)).returncode == 0
    assert _cli("--root", str(root), "--baseline", str(both),
                "--strict").returncode == 2
