"""The port stands alone: it runs with JAX, the JAX package, msgpack and
ml_dtypes out of reach, and none of its files (nor `chip_smoke.py`)
imports them.

The blocking happens in a subprocess: blocking modules in this process
would leak into every later test of the same worker."""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro", "msgpack", "ml_dtypes"}

_SCRIPT = r"""
import sys
BLOCKED = {"jax", "jaxlib", "repro", "msgpack", "ml_dtypes"}
for name in BLOCKED:
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

from repro_torch.serving import (Frontend, FrontendConfig, SearchService,
                                 ShardedIndex)
cluster = ShardedIndex.build(corpus, BuilderConfig(B=1200, F0=1.0), store,
                             "cluster", n_shards=2, device="cpu")
svc = SearchService(cluster)
served = svc.search_batch(["info", "info AND warn"], top_k=3)
assert [r.refs for r in served] == [r.refs for r in svc.search_batch(
    ["info", "info AND warn"], top_k=3, impl="sorted")]
fe = Frontend(svc, FrontendConfig(max_queue=4))
fut = fe.submit("info", top_k=3)
fe.run_once()
assert fut.result().refs == served[0].refs
fused = cluster.searcher(fused=True).query_batch(["info AND warn"])
assert fused[0].refs == svc.search_batch(["info AND warn"])[0].refs
svc.close()

import runpy
sys.argv = ["serve", "--mode", "search", "--device", "cpu", "--queries",
            "5"]
runpy.run_module("repro_torch.launch.serve", run_name="__main__")

import torch
import repro_torch.configs, repro_torch.models, repro_torch.launch.serve
from repro_torch.kernels import attention as ta
from repro_torch.configs import get_config
from repro_torch.launch.serve import decode_loop
from repro_torch.models import build_model, init_params
cfg = get_config("qwen3-32b", reduced=True)
model = build_model(cfg)
params = init_params(model.param_desc(), torch.Generator().manual_seed(0),
                     "cpu")
out = decode_loop(model, params, torch.randint(4, cfg.vocab, (2, 9)), 2)
assert out.tokens.shape == (2, 2) and torch.isfinite(out.logits).all()
q = torch.randn(1, 5, 4, 32)
assert ta.attention(q, q[:, :, :2], q[:, :, :2], device="cpu").shape == q.shape

from repro_torch.kernels import rwkv as tr
cfg = get_config("rwkv6-3b", reduced=True)
model = build_model(cfg)
params = init_params(model.param_desc(), torch.Generator().manual_seed(0),
                     "cpu")
out = decode_loop(model, params, torch.randint(4, cfg.vocab, (2, 9)), 2)
assert out.tokens.shape == (2, 2) and torch.isfinite(out.logits).all()
x = torch.rand(1, 5, 2, 32)
o, s = tr.wkv(x, x, x, x, x[0, 0], device="cpu")
assert o.shape == x.shape and s.shape == (1, 2, 32, 32)
cfg = get_config("qwen3-32b", reduced=True).with_(kv_quant=True)
model = build_model(cfg)
params = init_params(model.param_desc(), torch.Generator().manual_seed(0),
                     "cpu")
out = decode_loop(model, params, torch.randint(4, cfg.vocab, (2, 9)), 2)
assert out.tokens.shape == (2, 2) and torch.isfinite(out.logits).all()

import tempfile
import repro_torch.training, repro_torch.launch.steps
with tempfile.TemporaryDirectory() as workdir:
    sys.argv = ["train", "--device", "cpu", "--reduced", "--steps", "2",
                "--batch", "2", "--seq", "16", "--ckpt-every", "2",
                "--workdir", workdir]
    runpy.run_module("repro_torch.launch.train", run_name="__main__")
leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("standalone ok", [len(r.refs) for r in bitmap])
"""


def test_port_builds_and_queries_with_jax_repro_msgpack_blocked():
    """Index path, the serving tier (a 2-shard cluster behind
    `SearchService`, a `Frontend`, the fused path, `serve --mode
    search`), then configs, models, attention, the serve loop, RWKV's
    model and wkv, the int8 KV cache, and `repro_torch.training` through
    `python -m repro_torch.launch.train`."""
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
    """Nor ml_dtypes."""
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
