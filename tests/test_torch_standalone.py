"""The port stands alone: it runs with JAX, the JAX package and msgpack
out of reach, and none of its files (nor `chip_smoke.py`) imports them.

The blocking happens in a subprocess: blocking modules in this process
would leak into every later test of the same worker."""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro", "msgpack"}

_SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "repro", "msgpack"):
    sys.modules[name] = None          # any import of them now raises

import repro_torch
assert "torch" not in sys.modules     # the façade imports lazily
from repro_torch import Builder, BuilderConfig, Searcher, as_transport, parse
from repro_torch.data import make_logs_like, write_corpus
from repro_torch.storage import InMemoryBlobStore

store = InMemoryBlobStore()
corpus = write_corpus(store, "c", make_logs_like(800, seed=2), n_blobs=2)
Builder(BuilderConfig(B=1200, F0=1.0, index_ngrams=3)).build(
    corpus, store, "idx")
searcher = Searcher(as_transport(store), "idx", device="cpu")
qs = ["info", parse("info AND warn"), parse("info AND NOT warn"),
      parse("re:/blk_1[0-9]*/")]
bitmap = searcher.query_batch(qs, top_k=3)
plain = searcher.query_batch(qs, top_k=3, impl="sorted")
assert [r.refs for r in bitmap] == [r.refs for r in plain]
assert any(r.refs for r in bitmap)
leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in {"jax", "jaxlib", "repro", "msgpack"})
assert not leaked, leaked
print("standalone ok", [len(r.refs) for r in bitmap])
"""


def test_port_builds_and_queries_with_jax_repro_msgpack_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "standalone ok" in proc.stdout


def _imported_roots(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_no_port_file_imports_jax_repro_or_msgpack():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        bad = _imported_roots(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_import_scan_sees_every_import_form(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom repro.index import x\n"
                     "import importlib\nimportlib.import_module('msgpack')\n"
                     "from . import sibling\n")
    assert _imported_roots(probe) == {"jax", "repro", "importlib",
                                      "msgpack"}
