"""The port's indexed data loader and RAG pipeline against the JAX
package's, on the CPU.

The fixture is `tests/test_pipeline_serving.py`'s: 1,500 log lines in
three blobs, indexed with `Builder(B=800)`, built once by each package
(the same bytes). `IndexedCorpusLoader` must give bit-identical batches
at steps 0, 3 and 17 (packed and unpacked rows), the same host shards,
and the same keyword-filtered texts. `RAGPipeline` runs on the reduced
`granite-20b` of that file (2 layers, d_model 64, 2 query heads on one
KV head) with the JAX package's weights, cast to float32, carried over
by `params_from_numpy`: the retrieved texts and the retrieval time (a
`SimCloudStore` virtual clock, seed 0), the prompt ids and the greedy
tokens must be equal, with the port's decode attention rounding to bf16
where JAX's does (`tests/test_torch_transformer.py` explains why), and
the prefill logits within 1e-5 of their scale.

The decode logits of that run are held to 1e-2 of their scale, the
decode tolerance of `tests/test_torch_transformer.py`: both caches are
bf16, and a float32 difference of one part in 1e7 can round one new K
entry to the neighbouring bf16 value (measured: 1.0e-3 of the scale
after that flip on "error AND fetch", 3e-7 on "block", where none
flipped). So the decode steps are also run from JAX's prefill cache,
carried across with K/V in float32, where nothing rounds to bf16: there
the logits agree within 1e-5 of their scale, step by step.

Both packages raise `TypeError` for `rwkv6-3b`, whose prefill takes no
`pad_to`, and `--mode rag` of the port's serve CLI runs on the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_transformer import _attention_rounded_as_jax_decode

import repro.configs as j_configs
import repro.data as j_data
import repro.data.pipeline as j_pipeline
import repro.index as j_index
import repro.models as j_models
from repro.models import NULL_RULES
import repro.serving as j_serving
import repro.storage as j_storage
import repro_torch.configs as t_configs
import repro_torch.data as t_data
import repro_torch.data.pipeline as t_pipeline
import repro_torch.index as t_index
import repro_torch.models as t_models
import repro_torch.serving as t_serving
import repro_torch.storage as t_storage
from repro_torch.models import transformer

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
DECODE_TOL = 1e-2
GRANITE = dict(n_layers=2, d_model=64, n_heads=2, n_kv=1, d_ff=128,
               vocab=512)


def _setup(data, index, storage):
    store = storage.InMemoryBlobStore()
    docs = data.make_logs_like(1500, seed=4)
    corpus = data.write_corpus(store, "corpus/p", docs, n_blobs=3)
    index.Builder(index.BuilderConfig(B=800, F0=1.0, hedge_layers=1)).build(
        corpus, store, "index/p")
    return store


@pytest.fixture(scope="module")
def stores():
    j = _setup(j_data, j_index, j_storage)
    t = _setup(t_data, t_index, t_storage)
    assert {n: j.get(n) for n in j.list()} == {n: t.get(n) for n in t.list()}
    return j, t


def _loaders(stores, **kw):
    j, t = stores
    cloud_seed = kw.pop("cloud_seed", 0)
    cfg = kw.pop("cfg")
    return (j_pipeline.IndexedCorpusLoader(
                j_storage.SimCloudStore(j, seed=cloud_seed), "index/p",
                j_pipeline.PipelineConfig(**cfg), **kw),
            t_pipeline.IndexedCorpusLoader(
                t_storage.SimCloudStore(t, seed=cloud_seed), "index/p",
                t_pipeline.PipelineConfig(**cfg), device="cpu", **kw))


@pytest.mark.parametrize("pack", [True, False])
def test_loader_batches_match_jax(stores, pack):
    cfg = dict(seq_len=32, batch_size=4, vocab_size=1000, seed=5, pack=pack)
    j, t = _loaders(stores, cfg=cfg)
    for step in (0, 3, 17):
        bj, bt = j.batch(step), t.batch(step)
        assert sorted(bj) == sorted(bt) == ["labels", "tokens"]
        for k in bj:
            assert bt[k].dtype == bj[k].dtype == np.int32
            np.testing.assert_array_equal(bt[k], bj[k])
    # a restarted host on another cloud seed replays the same batches
    _j2, t2 = _loaders(stores, cfg=cfg, cloud_seed=99)
    for step in (0, 3, 17):
        np.testing.assert_array_equal(t2.batch(step)["tokens"],
                                      t.batch(step)["tokens"])


def test_loader_host_shards_match_jax(stores):
    cfg = dict(seq_len=32, batch_size=4, vocab_size=1000)
    texts = []
    for h in range(4):
        j, t = _loaders(stores, cfg=cfg, host=h, n_hosts=4)
        assert t._texts == j._texts
        np.testing.assert_array_equal(t.batch(2)["tokens"],
                                      j.batch(2)["tokens"])
        texts.append(set(t._texts))
    for a in range(4):
        for b in range(a + 1, 4):
            assert not (texts[a] & texts[b])
    assert sum(len(x) for x in texts) > 0


def test_loader_keyword_filter_matches_jax(stores):
    cfg = dict(seq_len=32, batch_size=2, vocab_size=1000)
    j, t = _loaders(stores, cfg=cfg, query="error")
    assert t._texts == j._texts and t._texts
    assert all("error" in x.lower() for x in t._texts)
    np.testing.assert_array_equal(t.batch(0)["tokens"], j.batch(0)["tokens"])
    assert t.batch(0)["labels"].shape == (2, 32)


# ------------------------------------------------------------------ RAG
def _recording(rag, calls):
    """Wrap a pipeline's prefill and decode to record their inputs and
    logits as NumPy arrays."""
    prefill, decode = rag._prefill, rag._decode

    def rec_prefill(params, batch, pad_to):
        logits, cache = prefill(params, batch, pad_to)
        calls.append((np.asarray(batch["tokens"]), pad_to,
                      np.asarray(logits, np.float32), cache))
        return logits, cache

    def rec_decode(params, cache, batch):
        logits, cache = decode(params, cache, batch)
        calls.append((np.asarray(batch["tokens"]), None,
                      np.asarray(logits, np.float32), None))
        return logits, cache

    rag._prefill, rag._decode = rec_prefill, rec_decode


@pytest.fixture(scope="module")
def granite():
    cfg = j_configs.get_config("granite-20b", reduced=True).with_(**GRANITE)
    model = j_models.build_model(cfg)
    params = j_models.init_params(model.param_desc(), jax.random.PRNGKey(0))
    params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
    return cfg, model, params


def _generate(serving, storage, store, model, params, vocab, query,
              calls, **kw):
    svc = serving.SearchService(
        storage.SimCloudTransport(storage.SimCloudStore(store, seed=0)),
        "index/p", **kw)
    rag = serving.RAGPipeline(svc, model, params, vocab_size=vocab,
                              max_context=48)
    _recording(rag, calls)
    out = rag.generate(query, top_k_docs=2, max_new_tokens=4)
    svc.close()
    return out


@pytest.mark.parametrize("query", ["block", "error AND fetch"])
def test_rag_matches_jax(stores, granite, monkeypatch, query):
    cfg, jmodel, jparams = granite
    tcfg = t_configs.get_config("granite-20b", reduced=True).with_(**GRANITE)
    model = t_models.build_model(tcfg)
    params = t_models.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    plain = transformer.attention
    monkeypatch.setattr(transformer, "attention", lambda q, k, v, **kw: (
        _attention_rounded_as_jax_decode(q, k, v, **kw) if q.shape[1] == 1
        else plain(q, k, v, **kw)))
    jcalls, tcalls = [], []
    want = _generate(j_serving, j_storage, stores[0], jmodel, jparams,
                     cfg.vocab, query, jcalls)
    got = _generate(t_serving, t_storage, stores[1], model, params,
                    tcfg.vocab, query, tcalls, device="cpu")
    assert isinstance(got, t_serving.RAGResult)
    assert got.query == want.query == query
    assert got.retrieved == want.retrieved and len(got.retrieved) == 2
    assert got.retrieval_ms == want.retrieval_ms > 0
    assert got.n_decoded == want.n_decoded == 4
    assert got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert len(tcalls) == len(jcalls) == 5
    for step, (t, j) in enumerate(zip(tcalls, jcalls)):
        np.testing.assert_array_equal(t[0], j[0])   # prompt ids, then tokens
        assert t[1] == j[1]
        scale = max(float(np.abs(j[2]).max()), 1.0)
        assert float(np.abs(t[2] - j[2]).max()) <= \
            (DECODE_TOL if step else TOL) * scale, step
    assert jcalls[0][1] == jcalls[0][0].shape[1] + 4

    # decode from JAX's prefill cache with K/V in float32 on both sides
    monkeypatch.setattr(transformer, "attention", plain)
    cache = {k: v.astype(jnp.float32) if k in ("k", "v") else v
             for k, v in jcalls[0][3].items()}
    for tok, _pad, _logits, _cache in jcalls[1:]:
        ported = {k: torch.from_numpy(np.array(v))
                  for k, v in cache.items()}
        want, cache = jmodel.decode_step(jparams, cache,
                                         {"tokens": jnp.asarray(tok)},
                                         NULL_RULES)
        got, _ = model.decode_step(params, ported,
                                   {"tokens": torch.from_numpy(np.array(tok))})
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1.0)
        assert float(np.abs(got.numpy() - want).max()) <= TOL * scale


def test_rag_raises_type_error_on_rwkv_in_both_packages(stores):
    jcfg = j_configs.get_config("rwkv6-3b", reduced=True)
    jmodel = j_models.build_model(jcfg)
    jparams = j_models.init_params(jmodel.param_desc(), jax.random.PRNGKey(0))
    tcfg = t_configs.get_config("rwkv6-3b", reduced=True)
    tmodel = t_models.build_model(tcfg)
    tparams = t_models.init_params(
        tmodel.param_desc(), torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(TypeError, match="pad_to"):
        _generate(j_serving, j_storage, stores[0], jmodel, jparams,
                  jcfg.vocab, "block", [])
    with pytest.raises(TypeError, match="pad_to"):
        _generate(t_serving, t_storage, stores[1], tmodel, tparams,
                  tcfg.vocab, "block", [], device="cpu")


def test_serve_cli_rag_mode_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "rag",
         "--device", "cpu", "--tokens", "4"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "retrieved 3 docs" in out.stdout
    assert "decoded 4 tokens" in out.stdout
