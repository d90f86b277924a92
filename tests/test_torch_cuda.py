"""The port's CUDA kernels on a card, against their plain versions.

Marked `cuda`: they skip without a card (the kernels have no CPU mode)
and run on one with `python -m pytest -m cuda tests/test_torch_cuda.py`.
Only the port, torch and numpy are imported, so they run where JAX is
not installed. The intersect comparisons are exact (integer bitmaps,
counts and keys; the key route's kernels on `kernels.intersect.cases`);
flash attention is held to 2e-5 in float32 and 2e-2 in bfloat16
(the JAX package's tolerances for its Pallas kernel), with TF32 off in
the plain version; the wkv kernel to 1e-4 of the largest |value| of its
output and of its final state, the JAX package's wkv tolerance; the
selective scans, unfused and fused, to 1e-5 of the largest |value| of y
and of its final state, since only the order of y's sums differs from the
plain version. The int8 decode kernel is held to 1e-2 (float32) and 2e-2
(bf16) of its output's scale (one step of a quantized probability, and a
bf16 rounding, see its test) and the
attention backward to 1e-4 (float32) and 2e-2 (bf16) of its gradients'
scale.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import attention as ta
from repro_torch.kernels.attention.cases import bwd_cases, int8_cases
from repro_torch.kernels import intersect as tx
from repro_torch.kernels import rwkv as tr
from repro_torch.kernels.intersect import ops as txo
from repro_torch.kernels.intersect.cases import (EDGE_CASES, edge_case,
                                                 host_lengths)
from repro_torch.kernels import ssm as ts

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _random_programs(rng, Q, L):
    progs = []
    for _ in range(Q):
        steps = []
        for s in range(int(rng.integers(0, L + 2))):
            op = int(rng.integers(0, 3))
            a = L + s - 1 if s else int(rng.integers(0, L))
            steps.append((op, a, int(rng.integers(0, L + s))))
        progs.append(steps)
    return progs


def _numpy_combine(bm, progs, L):
    """Independent NumPy evaluation of one (L, W) query's program."""
    slots = [bm[l] for l in range(L)]
    for op, a, b in progs:
        va, vb = slots[a], slots[b]
        slots.append(va & vb if op == 0 else va | vb if op == 1
                     else va & ~vb)
    return slots[-1]


@pytest.mark.parametrize("G,Q,L,W", [(1, 1, 1, 1), (1, 3, 2, 31),
                                     (2, 4, 3, 257), (4, 5, 4, 1250),
                                     (3, 2, 6, 40_000)])
def test_kernels_match_plain_on_card(card, G, Q, L, W):
    rng = np.random.default_rng(G * 1000 + Q * 10 + L)
    bm = rng.integers(0, 2**32, size=(G, Q, L, W), dtype=np.uint32)
    progs = [_random_programs(rng, Q, L) for _ in range(G)]
    packed = tx.pack_cluster_programs(progs, L)
    tx.reset_launches()
    pairs = {}
    for name, args in (("intersect", (bm[0, 0],)),
                       ("intersect_batch", (bm[0],)),
                       ("combine_batch", (bm[0], packed[0])),
                       ("combine_cluster", (bm, packed))):
        fn = getattr(tx, name)
        pairs[name] = (fn(*args, device=card),
                       fn(*args, impl="ref", device=card))
    torch.cuda.synchronize()
    for (out_k, cnt_k), (out_r, cnt_r) in pairs.values():
        assert out_k.is_cuda and torch.equal(out_k, out_r)
        assert torch.equal(cnt_k, cnt_r)
    assert {tx.LAUNCHES[name] for name in pairs} == {1}
    out = tx.to_numpy(pairs["combine_cluster"][0][0])
    for g in range(G):
        for q in range(Q):
            prog = [tuple(r) for r in packed[g, q]]
            assert (out[g, q] == _numpy_combine(bm[g, q], prog, L)).all()
    want = np.bitwise_and.reduce(bm[0], axis=1)
    assert (tx.to_numpy(pairs["intersect_batch"][0][0]) == want).all()


def test_programs_over_the_cap_are_refused(card):
    L = 2
    steps = [(tx.OP_AND, 0, 1)] + [(tx.OP_AND, L + s, L + s)
                                   for s in range(200)]
    packed = tx.pack_programs([steps], L)
    bm = np.zeros((1, L, 8), dtype=np.uint32)
    with pytest.raises(ValueError, match="cap"):
        tx.combine_batch(bm, packed, device=card)
    out, _ = tx.combine_batch(bm, packed, impl="ref", device=card)
    assert out.shape == (1, 8)


def test_searcher_on_card_matches_cpu(card):
    from repro_torch import Builder, BuilderConfig, Searcher, parse
    from repro_torch.data import make_logs_like, write_corpus
    from repro_torch.storage import (InMemoryBlobStore, SimCloudStore,
                                     SimCloudTransport)

    store = InMemoryBlobStore()
    corpus = write_corpus(store, "c", make_logs_like(3000, seed=1),
                          n_blobs=3)
    Builder(BuilderConfig(B=2500, F0=1.0)).build(corpus, store, "idx")
    queries = [parse(t) for t in (
        "info AND blk_12", "warn AND node7 AND exception", '"block blk_3"',
        "(error OR warn) AND NOT info", "info AND NOT block")]
    results = {}
    tx.reset_launches()
    for dev in (card, "cpu"):
        s = Searcher(SimCloudTransport(SimCloudStore(store, seed=3)), "idx",
                     device=dev)
        results[str(dev)] = s.query_batch(queries, top_k=5)
    assert tx.LAUNCHES["intersect_batch_keys"] == 1
    assert tx.LAUNCHES["combine_batch_keys"] == 1
    a, b = results.values()
    assert [(r.refs, r.texts, r.stats) for r in a] == \
        [(r.refs, r.texts, r.stats) for r in b]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_fused_kernels_match_plain_on_card(card, case):
    """combine_postings and bits_to_keys (keys and their ranks) against
    their plain versions on the same plan, and the entry points against
    impl="ref": exact."""
    rows, progs, n_docs = edge_case(case)
    plan = txo.plan_keys(rows, progs, n_docs, card)
    got = txo.keys_kernels(plan, ranks=True)
    want = txo.keys_plain(plan, ranks=True)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.is_cuda and a.shape == b.shape and torch.equal(a, b)
    assert got[3].dtype == torch.int32
    assert txo.keys_kernels(plan)[3] is None

    def route(**kw):
        if progs is None:
            return tx.intersect_keys(rows, n_docs=n_docs, **kw)
        return tx.combine_keys(rows, progs, **kw)
    (k, c), (k_ref, c_ref) = route(device=card), route(impl="ref",
                                                       device=card)
    assert torch.equal(k, k_ref) and torch.equal(c, c_ref)
    assert torch.equal(k, want[2])


@pytest.mark.parametrize("case", ["empty_leaf", "andnot_identity",
                                  "one_tile", "high_blob"])
def test_key_lengths_on_card_follow_the_host_rule(card, case):
    """The lengths recovered on the card from bits_to_keys' ranks, in
    chunks of 7 keys and in one, against the planner's host rule."""
    rows, progs, _ = edge_case(case)
    rng = np.random.default_rng(3)
    lengths = [[rng.integers(1, 2**40, len(a), dtype=np.uint64)
                for a in row] for row in rows]
    keys, counts, key_len = tx.combine_keys(rows, progs, device=card,
                                            lengths=lengths)
    plan = txo.plan_keys(rows, progs, None, card, lengths)
    key_ranks = txo.keys_kernels(plan, ranks=True)[3]
    assert torch.equal(txo.key_lengths(plan.ranked, key_ranks, counts,
                                       chunk=7), key_len)
    found = tx.keys_per_row(keys, counts)
    for q, got in enumerate(tx.keys_per_row(key_len, counts)):
        assert (got == host_lengths(found[q], rows[q], lengths[q])).all()


def _small_index(card):
    from repro_torch import Builder, BuilderConfig, Searcher, parse
    from repro_torch.data import make_logs_like, write_corpus
    from repro_torch.storage import (InMemoryBlobStore, SimCloudStore,
                                     SimCloudTransport)
    docs = make_logs_like(3000, seed=2)
    store = InMemoryBlobStore()
    corpus = write_corpus(store, "c", docs, n_blobs=3)
    Builder(BuilderConfig(B=2500, F0=1.0)).build(corpus, store, "idx")
    queries = [parse(t) for t in (
        "info AND blk_12", "warn AND node7 AND exception", '"block blk_3"',
        "(error OR warn) AND NOT info", "info AND NOT block",
        "info AND block AND node3", '"info block" OR (warn AND node2)')]

    def searcher(dev):
        return Searcher(SimCloudTransport(SimCloudStore(store, seed=3)),
                        "idx", device=dev)
    return searcher, queries


def test_query_batch_on_card_matches_sorted(card):
    searcher, queries = _small_index(card)
    got = searcher(card).query_batch(queries, top_k=5)
    want = searcher(card).query_batch(queries, top_k=5, impl="sorted")
    assert [(r.refs, r.texts, r.stats) for r in got] == \
        [(r.refs, r.texts, r.stats) for r in want]
    assert any(r.refs for r in got)


def test_main_path_launches_only_the_key_route_on_card(card):
    """The routes chip_smoke's main phase counts: one key-route launch
    per combine call, none of the bitmap kernels."""
    from repro_torch.core.hashing import word_fingerprint
    from repro_torch.core.sketch import IoUSketch, SketchSpec
    from repro_torch.index import planner as tp
    from repro_torch.index.searcher import lookup_units

    searcher, queries = _small_index(card)
    s = searcher(card)
    tx.reset_launches()
    s.query_batch(queries, top_k=5)
    posts = {f"w{i}": np.unique(np.random.default_rng(i).integers(
        0, 500, 200)).astype(np.uint32) for i in range(6)}
    sketch = IoUSketch.build(posts, SketchSpec(B=40, L=3, n_common=0,
                                               seed=1))
    found = [sketch.query(w, impl="bitmap", n_docs=500, device=card)
             for w in posts]
    jobs = [j for j in tp.plan_batch(queries, units=(s,))
            if j.plan is not None]
    outs, _ = lookup_units([s], [j.lookup_q for j in jobs], s._fetcher)
    common = lambda w: word_fingerprint(w) in s.common  # noqa: E731
    tp.combine_cluster_planned([[j.plan for j in jobs]] * 2, [outs[0]] * 2,
                               [common] * 2, device=card)
    assert {k: v for k, v in tx.LAUNCHES.items() if v} == {
        "intersect_keys": len(posts), "intersect_batch_keys": 1,
        "combine_batch_keys": 1, "combine_cluster_keys": 1}
    for w, got in zip(posts, found):
        assert (got == sketch.query(w, impl="sorted")).all()


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,KV,dh,causal,window,slots", [
    (1, 128, 128, 2, 2, 64, True, None, False),
    (2, 100, 300, 8, 1, 128, True, None, False),   # S < T, ragged, g = 8
    (2, 77, 77, 4, 2, 32, True, 16, False),        # window, ragged
    (1, 65, 130, 2, 2, 64, False, None, False),    # bidirectional
    (3, 1, 77, 8, 1, 128, True, None, True),       # decode, kpos = -1 tail
    (2, 1, 200, 16, 2, 64, True, 50, True),        # decode with a window
    # bf16 runs the split-KV decode kernel for S·H/KV <= 64, else the
    # TMA + wgmma prefill kernel (`ta.plan`)
    (4, 1, 2032, 64, 8, 128, True, None, True),    # qwen3 decode: 8 of 9
                                                   # splits hold no key
    (1, 300, 300, 32, 8, 128, True, None, False),  # jamba: g = 4, prefill
    (4, 1, 2032, 32, 8, 128, True, None, True),    # jamba decode
    (2, 1, 40, 8, 1, 32, True, None, True),        # T under one split
    (2, 150, 333, 4, 1, 32, True, None, False),    # T not a multiple of
                                                   # the 128-key TMA box
    (1, 3, 100, 8, 1, 64, True, None, False),      # decode kernel, 24 rows
    (2, 4, 130, 16, 2, 128, True, 40, False),      # 32 rows, a window
    (1, 8, 77, 16, 2, 32, False, None, False),     # 64 rows, bidirectional
    # granite-20b's MQA, g = 48: a ragged RAG prefill, then a decode step
    # of 48 rows on one KV head in a padded cache
    (1, 101, 101, 48, 1, 128, True, None, False),
    (1, 1, 117, 48, 1, 128, True, None, True),
])
def test_flash_attention_matches_plain_on_card(card, B, S, T, H, KV, dh,
                                               causal, window, slots, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(B * 7 + S + T + dh)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
               .to(card, dtype) for shape in
               ((B, S, H, dh), (B, T, KV, dh), (B, T, KV, dh)))
    qpos = kpos = None
    if slots:                   # one query at 60 against a partly empty cache
        pos = min(60, T - 1)
        kpos = torch.full((T,), -1, dtype=torch.int32)
        kpos[:pos + 1] = torch.arange(pos + 1)
        qpos = torch.tensor([pos], dtype=torch.int32).to(card)
        kpos = kpos.to(card)
    ta.reset_launches()
    got = ta.attention(q, k, v, causal=causal, window=window,
                       q_positions=qpos, kv_positions=kpos, device=card)
    want = ta.attention(q, k, v, causal=causal, window=window,
                        q_positions=qpos, kv_positions=kpos, impl="ref",
                        device=card)
    torch.cuda.synchronize()
    assert ta.LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == (B, S, H, dh)
    err = float((got.float() - want.float()).abs().max())
    assert err <= ATTN_TOL[dtype], err


def test_flash_attention_rows_without_keys_are_zero_on_card(card):
    q, k, v = (torch.randn(1, n, 2, 64, device=card) for n in (2, 6, 6))
    out = ta.attention(q, k[:, :, :1], v[:, :, :1],
                       q_positions=torch.tensor([-5, 2], dtype=torch.int32),
                       kv_positions=torch.tensor([0, 1, 2, -1, -1, -1],
                                                 dtype=torch.int32),
                       device=card)
    assert not out[0, 0].any() and out[0, 1].abs().sum() > 0


def test_reduced_qwen3_decode_on_card_matches_plain_attention(card):
    """Prefill + 3 decode steps of the reduced qwen3-32b, bf16: the model
    through the kernel against the same model through the plain version,
    teacher-forced on the same tokens, logits to 3e-2 of their scale."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.transformer import TransformerModel

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-32b", reduced=True)
    kernel, plain = TransformerModel(cfg), TransformerModel(cfg, "ref")
    params = init_params(kernel.param_desc(),
                         torch.Generator(card).manual_seed(1), card)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        4, cfg.vocab, (2, 43))).to(card)
    ta.reset_launches()
    runs = []
    for model in (kernel, plain):
        logits, cache = model.prefill(params, {"tokens": toks[:, :40]},
                                      pad_to=43)
        steps = [logits]
        for t in range(3):
            logits, cache = model.decode_step(
                params, cache, {"tokens": toks[:, 40 + t:41 + t]})
            steps.append(logits)
        runs.append(torch.stack(steps))
    assert ta.LAUNCHES["flash_attention"] == 4 * cfg.n_layers
    scale = max(float(runs[1].abs().max()), 1.0)
    assert float((runs[0] - runs[1]).abs().max()) <= 3e-2 * scale


WKV_TOL = 1e-4


def _wkv_inputs(card, B, S, H, dh, dtype, seed, decay="uniform"):
    """`decay` "uniform" draws w in (0.5, 0.999); "model" the model's kind
    of decay, exp(-exp(N(0, 1))), with key 0 held at exactly 1 and key 1
    at exactly 0."""
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.normal(0, std, (B, S, H, dh)).astype(
        np.float32)).to(card, dtype) for std in (1.0, 0.3, 1.0))
    if decay == "uniform":
        w = rng.uniform(0.5, 0.999, (B, S, H, dh))
    else:
        w = np.exp(-np.exp(rng.normal(0, 1, (B, S, H, dh))))
        w[..., 0], w[..., 1] = 1.0, 0.0
    w = torch.from_numpy(w.astype(np.float32)).to(card)
    u = torch.from_numpy(rng.normal(0, 0.3, (H, dh)).astype(np.float32)
                         ).to(card)
    s0 = torch.from_numpy(rng.normal(0, 0.1, (B, H, dh, dh)).astype(
        np.float32)).to(card)
    return r, k, v, w, u, s0


def _scaled_err(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1.0)


def _wkv_case(card, B, S, H, dh, dtype, with_s0, decay, seed):
    r, k, v, w, u, s0 = _wkv_inputs(card, B, S, H, dh, dtype, seed, decay)
    s0 = s0 if with_s0 else None
    tr.reset_launches()
    out, s_fin = tr.wkv(r, k, v, w, u, s0, device=card)
    want_out, want_s = tr.wkv(r, k, v, w, u, s0, impl="ref", device=card)
    torch.cuda.synchronize()
    assert tr.LAUNCHES["wkv"] == 1
    assert out.dtype == s_fin.dtype == torch.float32
    assert out.shape == (B, S, H, dh) and s_fin.shape == (B, H, dh, dh)
    assert _scaled_err(out, want_out) <= WKV_TOL
    assert _scaled_err(s_fin, want_s) <= WKV_TOL


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("S", [1, 37, 128, 2000])
def test_wkv_matches_plain_on_card(card, S, dh, dtype, with_s0):
    """The `wkv_edge` grid of chip_smoke.py: out and s_fin within 1e-4 of
    their largest |value|."""
    _wkv_case(card, 2, S, 3, dh, dtype, with_s0, "uniform", S + dh)


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 33])
def test_wkv_matches_plain_on_card_at_model_decays(card, S, dh, dtype,
                                                   with_s0):
    """The model's decays with keys held at w = 0 and w = 1, at S = 1 and
    on either side of the prefill kernel's chunk of 16 steps (15, 16, 17,
    33), as in chip_smoke.py's `wkv_edge`."""
    assert tr.kernel.CHUNK == 16
    _wkv_case(card, 2, S, 3, dh, dtype, with_s0, "model", 7 * S + dh)


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("S", [37, 1])
def test_wkv_matches_plain_when_blocks_overfill_a_wave(card, S, with_s0):
    """B·H = 270: at dh 64, 270 prefill blocks (two fit on an SM) or 540
    decode blocks on 132 SMs, so the last wave runs part empty."""
    _wkv_case(card, 6, S, 45, 64, torch.bfloat16, with_s0, "model", S)


def test_wkv_wrapper_refuses_what_the_kernel_does_not_take(card):
    r, k, v, w, u, s0 = _wkv_inputs(card, 1, 8, 2, 64, torch.bfloat16, 0)
    tr.reset_launches()
    with pytest.raises(TypeError, match="w must be float32"):
        tr.wkv_cuda(r, k, v, w.bfloat16(), u)
    with pytest.raises(TypeError, match="w must be float32"):
        tr.wkv(r, k, v, w.bfloat16(), u, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        tr.wkv_cuda(r.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                    w, u)
    with pytest.raises(ValueError, match="s0"):
        tr.wkv_cuda(r, k, v, w, u, s0[:, :, :32].contiguous())
    with pytest.raises(TypeError, match="bfloat16 or all float32"):
        tr.wkv_cuda(r, k.float(), v, w, u)
    r, k, v, w, u, _ = _wkv_inputs(card, 1, 8, 2, 16, torch.float32, 0)
    with pytest.raises(ValueError, match="head size 16 not built"):
        tr.wkv_cuda(r, k, v, w, u)
    assert tr.LAUNCHES["wkv"] == 0              # refusals never launch


def test_reduced_rwkv_decode_on_card_matches_plain_wkv(card):
    """Prefill + 3 decode steps of the reduced rwkv6-3b, bf16: the model
    through the kernel against the same model through the plain wkv,
    teacher-forced on the same tokens, logits to 3e-2 of their scale."""
    from repro_torch.configs import get_config
    from repro_torch.models import RWKVModel, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("rwkv6-3b", reduced=True)
    kernel, plain = RWKVModel(cfg), RWKVModel(cfg, "ref")
    params = init_params(kernel.param_desc(),
                         torch.Generator(card).manual_seed(1), card)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        4, cfg.vocab, (2, 43))).to(card)
    tr.reset_launches()
    runs = []
    for model in (kernel, plain):
        logits, cache = model.prefill(params, {"tokens": toks[:, :40]})
        steps = [logits]
        for t in range(3):
            logits, cache = model.decode_step(
                params, cache, {"tokens": toks[:, 40 + t:41 + t]})
            steps.append(logits)
        runs.append(torch.stack(steps))
    assert tr.LAUNCHES["wkv"] == 4 * cfg.n_layers
    scale = max(float(runs[1].abs().max()), 1.0)
    assert float((runs[0] - runs[1]).abs().max()) <= 3e-2 * scale


SCAN_TOL = 1e-5


def _scan_inputs(card, B, S, D, N, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(x.astype(np.float32)).to(card) for x in (
        rng.uniform(0.4, 0.99, (B, S, D, N)), rng.normal(0, 0.3, (B, S, D, N)),
        rng.normal(0, 1, (B, S, N)), rng.normal(0, 0.1, (B, D, N))))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("D", [96, 8192])
@pytest.mark.parametrize("N", [3, 4, 16])
@pytest.mark.parametrize("S", [1, 37, 2000])
def test_selective_scan_matches_plain_on_card(card, S, N, D, with_h0):
    """Part of the `scan_edge` grid of chip_smoke.py, with N = 3 (a group
    of lanes with a dead one): y and h_fin within 1e-5 of their largest
    |value|."""
    a, b, c, h0 = _scan_inputs(card, 2, S, D, N, S + N + D)
    h0 = h0 if with_h0 else None
    ts.reset_launches()
    y, h_fin = ts.selective_scan(a, b, c, h0, device=card)
    want_y, want_h = ts.selective_scan(a, b, c, h0, impl="ref", device=card)
    torch.cuda.synchronize()
    assert ts.LAUNCHES["selective_scan"] == 1
    assert y.dtype == h_fin.dtype == torch.float32
    assert y.shape == (2, S, D) and h_fin.shape == (2, D, N)
    assert _scaled_err(y, want_y) <= SCAN_TOL
    assert _scaled_err(h_fin, want_h) <= SCAN_TOL


def test_selective_scan_wrapper_refuses_what_the_kernel_does_not_take(card):
    a, b, c, h0 = _scan_inputs(card, 1, 8, 64, 16, 0)
    ts.reset_launches()
    with pytest.raises(TypeError, match="a must be float32"):
        ts.selective_scan_cuda(a.double(), b, c)
    with pytest.raises(TypeError, match="b must be float32"):
        ts.selective_scan(a, b.bfloat16(), c, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        ts.selective_scan_cuda(a.transpose(1, 2).contiguous().transpose(1, 2),
                               b, c)
    with pytest.raises(ValueError, match="h0 must be"):
        ts.selective_scan_cuda(a, b, c, h0[:, :32].contiguous())
    a, b, c, _ = _scan_inputs(card, 1, 8, 4, 33, 0)
    with pytest.raises(ValueError, match="N = 33 exceeds"):
        ts.selective_scan_cuda(a, b, c)
    assert ts.LAUNCHES["selective_scan"] == 0   # refusals never launch


def _fused_inputs(card, B, S, D, N, dtype, seed):
    """The fused scan's inputs as the model draws them (dt = softplus of a
    normal, A = -exp(0.5 N(0, 1))), B_ and C_ strided slices of one
    projection in `dtype`; keys 1-3 reach exp's denormal range: dt·A =
    -95 with x = 0 (the state decays through denormals), -110 (a = 0), and
    from -80 across both edges over n."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(0, 1, (B, S, D))))
    A = -np.exp(rng.normal(0, 0.5, (D, N)))
    x = rng.normal(0, 1, (B, S, D))
    if D > 3:
        A[1:4] = -1.0
        A[3] = -(1.0 + np.arange(N) / 8.0)
        dt[..., 1], dt[..., 2], dt[..., 3] = 95.0, 110.0, 80.0
        x[..., 1] = 0.0
        x[..., 2:4] /= dt[..., 2:4]
    proj = rng.normal(0, 1, (B, S, 5 + 2 * N))

    def to(a, dt_=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(card, dt_)
    proj = to(proj, dtype)
    return (to(dt), to(A), proj[..., 5:5 + N], proj[..., 5 + N:],
            to(x, dtype), to(rng.normal(1, 0.1, D)),
            to(rng.normal(0, 0.1, (B, D, N))))


def _fused_case(card, args):
    ts.reset_launches()
    y, h_fin = ts.selective_scan_fused(*args, device=card)
    want_y, want_h = ts.selective_scan_fused(*args, impl="ref", device=card)
    torch.cuda.synchronize()
    assert ts.LAUNCHES == {"selective_scan": 0, "selective_scan_fused": 1,
                           "selective_scan_fused_bwd": 0}
    assert y.dtype == h_fin.dtype == torch.float32
    assert y.shape == want_y.shape and h_fin.shape == want_h.shape
    assert torch.isfinite(y).all() and torch.isfinite(h_fin).all()
    assert _scaled_err(y, want_y) <= SCAN_TOL
    assert _scaled_err(h_fin, want_h) <= SCAN_TOL


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [96, 8192])
@pytest.mark.parametrize("N", [3, 4, 16])
@pytest.mark.parametrize("S", [1, 37, 2000])
def test_selective_scan_fused_matches_plain_on_card(card, S, N, D, dtype,
                                                    with_h0):
    """The fused kernel against its plain version: strided B_ and C_, dt
    into exp's denormal range, the D skip; y and h_fin within 1e-5 of
    their largest |value|."""
    args = list(_fused_inputs(card, 2, S, D, N, dtype, S + N + D))
    args[6] = args[6] if with_h0 else None
    _fused_case(card, args)


@pytest.mark.parametrize("N", [1, 2, 5, 8, 32])
def test_selective_scan_fused_other_state_sizes_on_card(card, N):
    """N from 1 to 32 (32: two lanes share a d), ragged D, without D."""
    args = list(_fused_inputs(card, 3, 37, 200, N, torch.bfloat16, N))
    args[5] = None
    _fused_case(card, args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_fused_contiguous_rows_without_D_on_card(card, dtype):
    dt, A, B_, C_, x, _, h0 = _fused_inputs(card, 2, 37, 96, 16, dtype, 9)
    _fused_case(card, (dt, A, B_.contiguous(), C_.contiguous(), x, None, h0))


def test_selective_scan_fused_wrapper_refuses_what_the_kernel_does_not_take(
        card):
    dt, A, B_, C_, x, D, h0 = _fused_inputs(card, 2, 8, 64, 16,
                                            torch.bfloat16, 0)
    ts.reset_launches()
    with pytest.raises(TypeError, match="dt must be float32"):
        ts.selective_scan_fused_cuda(dt.double(), A, B_, C_, x)
    with pytest.raises(TypeError, match="all bfloat16 or all float32"):
        ts.selective_scan_fused(dt, A, B_.float(), C_, x, device=card)
    with pytest.raises(ValueError, match="dt must be contiguous"):
        ts.selective_scan_fused_cuda(
            dt.transpose(1, 2).contiguous().transpose(1, 2), A, B_, C_, x)
    with pytest.raises(ValueError, match="B_ must be rows"):
        ts.selective_scan_fused_cuda(dt, A, B_.transpose(0, 1).contiguous()
                                     .transpose(0, 1), C_, x)
    with pytest.raises(ValueError, match="h0 must be"):
        ts.selective_scan_fused_cuda(dt, A, B_, C_, x, D,
                                     h0[:, :32].contiguous())
    with pytest.raises(ValueError, match="on dt's CUDA device"):
        ts.selective_scan_fused_cuda(dt, A.cpu(), B_, C_, x)
    dt, A, B_, C_, x, _, _ = _fused_inputs(card, 1, 8, 4, 33, torch.float32,
                                           0)
    with pytest.raises(ValueError, match="N = 33 exceeds"):
        ts.selective_scan_fused_cuda(dt, A, B_, C_, x)
    assert ts.LAUNCHES == {"selective_scan": 0,     # refusals never launch
                           "selective_scan_fused": 0,
                           "selective_scan_fused_bwd": 0}


def test_reduced_jamba_on_card_matches_plain_scan(card):
    """Prefill + 3 decode steps of the reduced jamba-v0.1-52b in float32:
    the model through the fused scan kernel against the same model through
    its plain version, teacher-forced on the same tokens, logits to 1e-4 of
    their scale; the fused kernel runs once per Mamba layer and step, the
    unfused one never."""
    from repro_torch.configs import get_config
    from repro_torch.models import HybridModel, init_params
    from repro_torch.models.common import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("jamba-v0.1-52b", reduced=True)
    kernel, plain = HybridModel(cfg), HybridModel(cfg, scan_impl="ref")
    params = tree_map(lambda x: x.float(), init_params(
        kernel.param_desc(), torch.Generator(card).manual_seed(1), card))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        4, cfg.vocab, (2, 43))).to(card)
    ts.reset_launches()
    runs = []
    for model in (kernel, plain):
        logits, cache = model.prefill(params, {"tokens": toks[:, :40]},
                                      pad_to=43)
        steps = [logits]
        for t in range(3):
            logits, cache = model.decode_step(
                params, cache, {"tokens": toks[:, 40 + t:41 + t]})
            steps.append(logits)
        runs.append(torch.stack(steps))
    n_mamba = cfg.n_layers - cfg.n_layers // cfg.attn_every
    assert ts.LAUNCHES == {"selective_scan": 0,
                           "selective_scan_fused": 4 * n_mamba,
                           "selective_scan_fused_bwd": 0}
    scale = max(float(runs[1].abs().max()), 1.0)
    assert float((runs[0] - runs[1]).abs().max()) <= 1e-4 * scale


# ----------------------------------------------- the serving tier's callers
def _serving_fixture(card):
    """A segmented `Index` (base, a committed segment, a memory segment)
    and a 4-shard `ShardedIndex` over one corpus, for `device`."""
    from repro_torch import parse
    from repro_torch.data import make_logs_like, write_corpus
    from repro_torch.index import BuilderConfig, Index
    from repro_torch.serving import ShardedIndex
    from repro_torch.storage import InMemoryBlobStore

    store = InMemoryBlobStore()
    docs = make_logs_like(3000, seed=5)
    corpus = write_corpus(store, "c", docs[:2400], n_blobs=3)
    extra = [write_corpus(store, f"x{i}", part, n_blobs=1)
             for i, part in enumerate((docs[2400:2700], docs[2700:]))]
    cfg = BuilderConfig(B=2500, F0=1.0)

    def segmented(dev):
        idx = Index.build(corpus, cfg, store, f"idx-{dev.type}", device=dev)
        w = idx.writer()
        w.append(extra[0])
        w.commit()
        idx.writer().add(extra[1])
        return idx

    def cluster(dev):
        return ShardedIndex.build(corpus, cfg, store, f"cl-{dev.type}",
                                  n_shards=4, device=dev)

    queries = [parse(t) for t in (
        "info AND blk_12", "warn AND node7 AND exception", '"block blk_3"',
        "(error OR warn) AND NOT info", "info AND NOT block",
        "info AND block AND node3", '"info block" OR (warn AND node2)')]
    return store, segmented, cluster, queries


def _same(a, b):
    return [(r.refs, r.texts, r.stats) for r in a] == \
        [(r.refs, r.texts, r.stats) for r in b]


def test_segmented_index_on_card_matches_sorted_and_cpu(card):
    """`MultiSegmentSearcher` combines each unit on the card: one AND and
    one planner launch per unit, results equal to the host's."""
    from repro_torch.storage import SimCloudStore, SimCloudTransport
    store, segmented, _cluster, queries = _serving_fixture(card)
    runs = {}
    for dev in (card, torch.device("cpu")):
        idx = segmented(dev)
        idx.searcher()            # caches the units' headers on the handle
        for impl in ("bitmap", "sorted"):
            reader = idx.searcher(transport=SimCloudTransport(
                SimCloudStore(store, seed=3)))
            tx.reset_launches()
            runs[dev.type, impl] = reader.query_batch(queries, top_k=5,
                                                      impl=impl)
            runs[dev.type, impl, "launches"] = dict(tx.LAUNCHES)
    assert reader.n_units == 3
    assert _same(runs["cuda", "bitmap"], runs["cuda", "sorted"])
    assert _same(runs["cuda", "bitmap"], runs["cpu", "bitmap"])
    assert any(r.refs for r in runs["cuda", "bitmap"])
    got = {k: v for k, v in runs["cuda", "bitmap", "launches"].items() if v}
    assert got == {"intersect_batch_keys": 3, "combine_batch_keys": 3}
    assert not any(runs["cuda", "sorted", "launches"].values())


@pytest.mark.parametrize("fused", [False, True])
def test_cluster_on_card_matches_sorted_and_cpu(card, fused):
    """Per-shard legs run on their own threads, each launching on the
    card; the fused path makes exactly one `combine_cluster_keys` launch
    a batch and nothing else."""
    from repro_torch.storage import SimCloudStore, SimCloudTransport
    store, _segmented, cluster, queries = _serving_fixture(card)
    sources = [lambda i: SimCloudTransport(SimCloudStore(store,
                                                         seed=40 + i))]
    runs = {}
    for dev in (card, torch.device("cpu")):
        handle = cluster(dev)
        for impl in ("bitmap", "sorted"):
            # fresh simulated clocks for each run of the same batches
            cs = handle.searcher(replica_sources=sources, fused=fused)
            for k in (None, 5):
                tx.reset_launches()
                runs[dev.type, impl, k] = cs.query_batch(
                    queries, top_k=k, impl=impl)
                runs[dev.type, impl, k, "launches"] = {
                    n: v for n, v in tx.LAUNCHES.items() if v}
            cs.close()
    for k in (None, 5):
        assert _same(runs["cuda", "bitmap", k], runs["cpu", "bitmap", k])
        if not fused:
            assert _same(runs["cuda", "bitmap", k],
                         runs["cuda", "sorted", k])
        assert runs["cuda", "bitmap", k, "launches"] == (
            {"combine_cluster_keys": 1} if fused else
            {"intersect_batch_keys": 4, "combine_batch_keys": 4})
    assert any(r.refs for r in runs["cuda", "bitmap", 5])


def test_frontend_threads_on_card_match_the_host(card):
    """Four client threads through a started `Frontend` over a card
    `SearchService`: every future equals the host's sorted answer and
    the launches, counted from the batcher's thread, are exactly what
    the micro-batches it served launch when replayed one by one."""
    import threading
    from repro_torch.serving import Frontend, FrontendConfig, SearchService
    from repro_torch.serving import ShardedIndex
    store, _segmented, cluster, queries = _serving_fixture(card)
    cluster(card)
    svc = SearchService(ShardedIndex.open(store, "cl-cuda", device=card))
    want = svc.search_batch(queries * 4, top_k=5, impl="sorted")
    batches, search_batch = [], svc.search_batch

    def recording(qs, **kw):
        batches.append((list(qs), kw))
        return search_batch(qs, **kw)

    svc.search_batch = recording
    tx.reset_launches()
    fe = Frontend(svc, FrontendConfig(max_queue=64, max_batch=8)).start()
    futs = [None] * (4 * len(queries))

    def client(c):
        for i, q in enumerate(queries):
            futs[c * len(queries) + i] = fe.submit(q, top_k=5)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    got = [f.result(timeout=120) for f in futs]
    fe.close()
    order = [q for c in range(4) for q in queries]
    want_of = {str(q): r for q, r in zip(queries * 4, want)}
    assert [(r.refs, r.texts) for r in got] == \
        [(want_of[str(q)].refs, want_of[str(q)].texts) for q in order]
    threaded = {k: v for k, v in tx.LAUNCHES.items() if v}
    assert len(batches) == fe.stats.n_batches >= 1
    tx.reset_launches()
    for qs, kw in batches:
        search_batch(qs, **kw)
    assert threaded == {k: v for k, v in tx.LAUNCHES.items() if v}
    assert set(threaded) <= {"intersect_batch_keys", "combine_batch_keys"}
    svc.close()


def _admin_trace(dev):
    """Alias `reshard` → `split` → `compact` → `append` →
    `collect_garbage` on a small cluster on `dev`, with `uuid.uuid4`
    patched to one sequence: the manifests, every fused and per-shard
    answer (top None and top 5) after each step, the fused batches'
    launches, the GC report and the blobs."""
    import dataclasses
    import itertools
    import uuid
    from unittest import mock

    from repro_torch.data import make_logs_like, write_corpus
    from repro_torch.index import BuilderConfig, parse
    from repro_torch.serving import ShardedIndex
    from repro_torch.storage import (InMemoryBlobStore, SimCloudStore,
                                     SimCloudTransport)
    counter = itertools.count(1)
    queries = [parse(q) for q in (
        "error", "info AND block", "(error OR warn) AND NOT info",
        '"info block" OR (warn AND node2)')]
    trace, launches = [], []
    with mock.patch.object(uuid, "uuid4",
                           lambda: uuid.UUID(int=next(counter) << 96)):
        store = InMemoryBlobStore()
        corpus = write_corpus(store, "c", make_logs_like(600, seed=5),
                              n_blobs=3)
        extra = write_corpus(store, "x", make_logs_like(60, seed=6),
                             n_blobs=1)
        cluster = ShardedIndex.build(corpus, BuilderConfig(B=900, F0=1.0),
                                     store, "cl", n_shards=4, device=dev)
        steps = [lambda: cluster.reshard(4, n_slots=8),
                 lambda: cluster.split(0),
                 lambda: cluster.compact(cluster.aliased_shards[0]),
                 lambda: cluster.append(extra),
                 lambda: cluster.collect_garbage(keep=1, now=4.0e9)]
        for step in steps:
            out = step()
            cluster.refresh()
            trace.append(dataclasses.asdict(out) if out is not cluster
                         else cluster.manifest)
            for fused in (False, True):
                cs = cluster.searcher(replica_sources=[
                    lambda i: SimCloudTransport(SimCloudStore(store,
                                                              seed=40 + i))],
                    fused=fused)
                for k in (None, 5):
                    tx.reset_launches()
                    res = cs.query_batch(queries, top_k=k)
                    trace.append([(r.refs, r.texts, r.stats) for r in res])
                    if fused:
                        launches.append({n: v for n, v in
                                         tx.LAUNCHES.items() if v})
                cs.close()
        trace.append({n: store.get(n) for n in store.list()})
    return trace, launches


def test_cluster_management_on_card_matches_cpu(card):
    """Membership changes and GC give the same blobs and the same answers
    with the cluster's combines on the card as on the host; every fused
    batch is one `combine_cluster_keys` launch."""
    on_card, launches = _admin_trace(card)
    on_host, _ = _admin_trace(torch.device("cpu"))
    assert on_card == on_host
    assert launches == [{"combine_cluster_keys": 1}] * 10


def test_reduced_granite_rag_on_card_matches_plain_attention(card):
    """`RAGPipeline` over a card `SearchService` on the reduced
    granite-20b (MQA), bf16: prefill + 4 greedy decode steps, exactly
    5 attention launches a layer; the run's logits against the same
    model through the plain attention, teacher-forced on its prompt and
    tokens, within 3e-2 of their scale."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_logs_like, write_corpus
    from repro_torch.index import Builder, BuilderConfig
    from repro_torch.models import init_params
    from repro_torch.models.transformer import TransformerModel
    from repro_torch.serving import RAGPipeline, SearchService
    from repro_torch.storage import (InMemoryBlobStore, SimCloudStore,
                                     SimCloudTransport)

    torch.backends.cuda.matmul.allow_tf32 = False
    store = InMemoryBlobStore()
    corpus = write_corpus(store, "c", make_logs_like(800, seed=4), n_blobs=2)
    Builder(BuilderConfig(B=800, F0=1.0)).build(corpus, store, "ix")
    svc = SearchService(SimCloudTransport(SimCloudStore(store, seed=0)),
                        "ix", device=card)
    cfg = get_config("granite-20b", reduced=True)
    model, plain = TransformerModel(cfg), TransformerModel(cfg, "ref")
    params = init_params(model.param_desc(),
                         torch.Generator(card).manual_seed(2), card)
    rag = RAGPipeline(svc, model, params, vocab_size=cfg.vocab,
                      max_context=64)
    calls, prefill, decode = [], rag._prefill, rag._decode

    def rec_prefill(p, batch, pad_to):
        logits, cache = prefill(p, batch, pad_to)
        calls.append((batch["tokens"], pad_to, logits))
        return logits, cache

    def rec_decode(p, cache, batch):
        logits, cache = decode(p, cache, batch)
        calls.append((batch["tokens"], None, logits))
        return logits, cache

    rag._prefill, rag._decode = rec_prefill, rec_decode
    ta.reset_launches()
    out = rag.generate("error fetch", top_k_docs=3, max_new_tokens=4)
    assert ta.LAUNCHES["flash_attention"] == 5 * cfg.n_layers
    assert len(out.retrieved) == 3 and out.n_decoded == 4
    prompt, pad_to, _ = calls[0]
    assert prompt.is_cuda and pad_to == prompt.shape[1] + 4
    with torch.inference_mode():
        logits, cache = plain.prefill(params, {"tokens": prompt},
                                      pad_to=pad_to)
        want = [logits]
        for tok in out.tokens:
            logits, cache = plain.decode_step(params, cache, {
                "tokens": torch.tensor([[tok]], dtype=torch.int32,
                                       device=card)})
            want.append(logits)
    got = torch.stack([c[2] for c in calls])
    want = torch.stack(want)
    scale = max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= 3e-2 * scale
    svc.close()


# ---- positions per batch row, rings and the three new model kinds -------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(8))
def test_flash_attention_with_model_positions_matches_plain_on_card(
        card, case, dtype):
    """`kernels.attention.cases`: (B, S) and (B, T) positions in prefill
    and decode, a wrapped ring (key positions not sorted) in decode and
    prefill, non-causal cross-attention and an encoder."""
    from repro_torch.kernels.attention.cases import position_cases
    torch.backends.cuda.matmul.allow_tf32 = False
    name, (B, S, T, H, KV, dh), kw = position_cases(card)[case]
    gen = torch.Generator(card).manual_seed(case)
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype)
               for shape in ((B, S, H, dh), (B, T, KV, dh), (B, T, KV, dh)))
    ta.reset_launches()
    got = ta.attention(q, k, v, device=card, **kw)
    want = ta.attention(q, k, v, impl="ref", device=card, **kw)
    torch.cuda.synchronize()
    assert ta.LAUNCHES["flash_attention"] == 1
    err = float((got.float() - want.float()).abs().max())
    assert err <= ATTN_TOL[dtype], (name, err)


def _kernel_vs_plain(card, arch, batch, steps, pad_to, extra=None):
    """Prefill + decode `steps` of the reduced `arch` in bf16 through the
    kernel and through the plain attention, teacher-forced: the two
    (steps + 1, B, vocab) logits and the kernel's launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, reduced=True)
    kernel = build_model(cfg)
    plain = type(kernel)(cfg, attn_impl="ref")
    params = init_params(kernel.param_desc(),
                         torch.Generator(card).manual_seed(1), card)
    runs, launches = [], []
    for model in (kernel, plain):
        ta.reset_launches()
        logits, cache = model.prefill(params, batch, pad_to=pad_to)
        out = [logits]
        for t, tok in enumerate(steps):
            logits, cache = model.decode_step(
                params, cache, {"tokens": tok, **(extra(t) if extra else {})})
            out.append(logits)
        runs.append(torch.stack(out))
        launches.append(ta.LAUNCHES["flash_attention"])
    assert launches[1] == 0
    return runs[0], runs[1], launches[0], kernel, params, cache


def _close(a, b, tol=3e-2):
    scale = max(float(b.abs().max()), 1.0)
    assert bool(a.isfinite().all())
    assert float((a - b).abs().max()) <= tol * scale


def test_reduced_mixtral_ring_on_card_matches_the_full_cache(card):
    """Reduced mixtral (window 64), bf16: an 80-token prefill (the window
    masks) and 3 decode steps through the kernel against the plain
    attention; then the prompt's last 64 positions laid into a ring of
    64 slots at slot p % 64 decode the same tokens with the full cache's
    logits."""
    g = torch.Generator(card).manual_seed(2)
    toks = torch.randint(4, 512, (2, 83), generator=g, device=card)
    steps = [toks[:, 80 + t:81 + t] for t in range(3)]
    kern, plain, launches, model, params, _ = _kernel_vs_plain(
        card, "mixtral-8x22b", {"tokens": toks[:, :80]}, steps, 83)
    W, L = model.cfg.swa, model.cfg.n_layers
    assert W == 64 and launches == 4 * L
    _close(kern, plain)
    _, full = model.prefill(params, {"tokens": toks[:, :80]}, pad_to=83)
    ring = {"k": torch.zeros_like(full["k"][:, :, :W]),
            "v": torch.zeros_like(full["v"][:, :, :W]),
            "kpos": torch.full((W,), -1, dtype=torch.int32, device=card),
            "pos": torch.tensor(80, dtype=torch.int32)}
    held = torch.arange(80 - W, 80, device=card)
    for name in ("k", "v"):
        ring[name][:, :, held % W] = full[name][:, :, held]
    ring["kpos"][held % W] = held.to(torch.int32)
    for tok in steps:
        lf, full = model.decode_step(params, full, {"tokens": tok})
        lr, ring = model.decode_step(params, ring, {"tokens": tok})
        _close(lr, lf, 2e-2)
    assert sorted(ring["kpos"].tolist()) == list(range(83 - W, 83))


def test_reduced_vlm_and_encdec_on_card_match_plain_attention(card):
    """Reduced qwen2-vl (per-row M-RoPE ids: 16 patches on a 4×4 and a
    2×8 grid, 24 text tokens) and seamless-m4t (48 frames, a 20-token
    prompt), bf16, prefill + 3 decode steps through the kernel against
    the plain attention, teacher-forced."""
    g = torch.Generator(card).manual_seed(3)
    toks = torch.randint(4, 512, (2, 27), generator=g, device=card,
                         dtype=torch.int32)
    steps = [toks[:, 24 + t:25 + t] for t in range(3)]
    rows = []
    for h, w in ((4, 4), (2, 8)):
        r = torch.arange(h * w, device=card)
        img = torch.stack([torch.zeros_like(r), r // w, r % w], -1)
        txt = (max(h, w) + torch.arange(24, device=card))[:, None].expand(
            24, 3)
        rows.append(torch.cat([img, txt]))
    ids = torch.stack(rows).to(torch.int32)
    nxt = ids[:, -1, 0] + 1
    batch = {"tokens": toks[:, :24], "positions": ids,
             "patches": torch.randn(2, 16, 128, generator=g, device=card)
             .bfloat16()}
    kern, plain, launches, model, _, _ = _kernel_vs_plain(
        card, "qwen2-vl-72b", batch, steps, 43,
        lambda t: {"positions": (nxt + t)[:, None, None].expand(2, 1, 3)
                   .contiguous()})
    assert launches == 4 * model.cfg.n_layers
    _close(kern, plain)
    batch = {"tokens": toks[:, :20],
             "frames": torch.randn(2, 48, 128, generator=g, device=card)
             .bfloat16()}
    steps = [toks[:, 20 + t:21 + t] for t in range(3)]
    kern, plain, launches, model, _, cache = _kernel_vs_plain(
        card, "seamless-m4t-medium", batch, steps, 23)
    assert launches == model.cfg.n_layers + 4 * 2 * model.n_dec
    assert cache["cross_k"].shape[2] == 48
    _close(kern, plain)


# -------------------------------------------- int8 decode and backward
def _rel(got, want):
    scale = max(float(want.float().abs().max()), 1e-12)
    return float((got.float() - want.float()).abs().max()) / scale


_INT8_CASES = range(len(int8_cases("cpu")))    # counted without a card


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _INT8_CASES)
def test_flash_decode_int8_matches_plain_on_card(card, case, dtype):
    """`flash_decode_int8` against `attention_int8_ref` on the card on the
    int8 edge cases, within 1e-2 of the output's scale in float32 and
    2e-2 in bf16: the integer products and the scores' float32 products
    agree, but an exp or a softmax sum one ulp apart can move a p / ps on
    a rounding boundary by one step of ps · v8 (up to 1/127 of the
    scale), and a bf16 output rounds once more (2^-8)."""
    from repro_torch.kernels.attention.cases import int8_inputs
    name, shape, kw = int8_cases(card)[case]
    q, k8, v8, ks, vs = int8_inputs(shape, case, card, dtype)
    ta.reset_launches()
    got = ta.attention_int8(q, k8, v8, ks, vs, device=card, **kw)
    want = ta.attention_int8(q, k8, v8, ks, vs, device=card, impl="ref",
                             **kw)
    torch.cuda.synchronize()
    B, S, T, H, KV, dh = shape
    assert ta.LAUNCHES["flash_decode_int8"] == 1
    assert dict(ta.INT8_ROUTES) == {
        ta.plan_int8(B, T, KV, S * H // KV, dh)[0]: 1}
    assert got.dtype == dtype and got.shape == q.shape
    assert _rel(got, want) < (1e-2 if dtype == torch.float32 else 2e-2), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _INT8_CASES)
def test_flash_decode_int8_routes_on_card(card, case, dtype):
    """Each route that takes the case (the bare `launch_int8` with
    `route=`: the split route every case, the cluster route where
    `plan_int8` gives one) against `attention_int8_ref` within the
    tolerances above; the cluster route gives the same bits on a second
    run (the cluster's sums are in rank order, its int32 sums exact)."""
    from repro_torch.kernels.attention import kernel as tk
    from repro_torch.kernels.attention.cases import int8_inputs
    name, shape, kw = int8_cases(card)[case]
    B, S, T, H, KV, dh = shape
    q, k8, v8, ks, vs = int8_inputs(shape, case, card, dtype)
    want = ta.attention_int8(q, k8, v8, ks, vs, device=card, impl="ref",
                             **kw)
    args = (kw.get("causal", True), kw.get("window"), kw["q_positions"],
            kw["kv_positions"])
    routes = ["split"]
    if tk.plan_int8(B, T, KV, S * H // KV, dh)[0] == "cluster":
        routes.append("cluster")
    for route in routes:
        outs = [torch.full_like(q, float("nan")) for _ in range(2)]
        for out in outs:
            tk.launch_int8(q, k8, v8, ks, vs, out, *args, route=route)
        torch.cuda.synchronize()
        tol = 1e-2 if dtype == torch.float32 else 2e-2
        assert _rel(outs[0], want) < tol, (name, route)
        if route == "cluster":
            assert torch.equal(outs[0], outs[1]), name
    if "cluster" not in routes:
        with pytest.raises(ValueError, match="does not take"):
            tk.launch_int8(q, k8, v8, ks, vs, torch.empty_like(q), *args,
                           route="cluster")


_BWD_CASES = range(len(bwd_cases("cpu")))    # counted without a card


def _bwd_close(got, want, dtype, name):
    scale = max(float(w.float().abs().max()) for w in want)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert float((g.float() - w.float()).abs().max()) / scale < tol, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _BWD_CASES)
def test_flash_bwd_matches_plain_on_card(card, case, dtype):
    """`flash_bwd` against `attention_bwd_ref` (TF32 off) on the backward
    edge cases, each gradient within 1e-4 (float32) or 2e-2 (bf16, one
    rounding of each output) of the three gradients' joint scale, by
    the route `plan_bwd` names (the log-sum-exp recomputed)."""
    from repro_torch.kernels.attention.cases import bwd_inputs, kv_len
    name, shape, kw = bwd_cases(card)[case]
    q, k, v, do = bwd_inputs(shape, case, card, dtype, T=kv_len(shape, kw))
    out = ta.attention(q, k, v, device=card, **kw)
    ta.reset_launches()
    got = ta.attention_bwd(q, k, v, out, do, device=card, **kw)
    want = ta.attention_bwd(q, k, v, out, do, device=card, impl="ref", **kw)
    torch.cuda.synchronize()
    assert ta.LAUNCHES["flash_bwd"] == 1
    assert dict(ta.BWD_ROUTES) == {ta.plan_bwd(dtype, shape[4]): 1}
    _bwd_close(got, want, dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _BWD_CASES)
def test_flash_bwd_through_autograd_matches_plain_on_card(card, case, dtype):
    """The gradients autograd takes through `attention` on the card (the
    forward kernel, which in bf16 prefill also writes the log-sum-exp the
    backward then reads) against `attention_bwd_ref` at the forward's
    output, within the tolerances above."""
    from repro_torch.kernels.attention.cases import bwd_inputs, kv_len
    name, shape, kw = bwd_cases(card)[case]
    q, k, v, do = bwd_inputs(shape, case, card, dtype, T=kv_len(shape, kw))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ta.reset_launches()
    out = ta.attention(*leaves, device=card, **kw)
    got = torch.autograd.grad(out, leaves, do)
    want = ta.attention_bwd(q, k, v, out.detach(), do, device=card,
                            impl="ref", **kw)
    torch.cuda.synchronize()
    assert ta.LAUNCHES["flash_bwd"] == 1
    _bwd_close(got, want, dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [0, 3, 7, 9, 10])
def test_flash_bwd_is_deterministic_on_card(card, case, dtype):
    """Two `flash_bwd` calls on the same inputs give the same dq, dk and
    dv bit for bit, on both routes, with and without the forward's
    log-sum-exp: no float atomics, every sum in a fixed order."""
    from repro_torch.kernels.attention.cases import bwd_inputs, kv_len
    name, shape, kw = bwd_cases(card)[case]
    q, k, v, do = bwd_inputs(shape, case, card, dtype, T=kv_len(shape, kw))
    lse = None
    if ta.forward_lse(q, k):
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=card)
    out = ta.flash_attention(q, k, v, lse=lse, **kw)
    for given in (None,) if lse is None else (None, lse):
        first = ta.flash_bwd(q, k, v, out, do, lse=given, **kw)
        second = ta.flash_bwd(q, k, v, out, do, lse=given, **kw)
        for a, b in zip(first, second):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("case", _BWD_CASES)
def test_flash_attention_lse_matches_plain_on_card(card, case):
    """The log-sum-exp the bf16 prefill kernel writes beside its output
    against `attention_lse_ref` on the same bf16 inputs: +inf on the same
    rows (none allowed), elsewhere within 1e-4 of max(1, |lse|) (float32
    sums in another order; the output itself is unchanged)."""
    from repro_torch.kernels.attention.cases import bwd_inputs, kv_len
    name, shape, kw = bwd_cases(card)[case]
    q, k, v, _ = bwd_inputs(shape, case, card, torch.bfloat16,
                            T=kv_len(shape, kw))
    if not ta.forward_lse(q, k):
        with pytest.raises(ValueError, match="log-sum-exp"):
            ta.flash_attention(q, k, v, lse=torch.empty(
                q.shape[:3], dtype=torch.float32, device=card), **kw)
        return
    lse = torch.full(q.shape[:3], float("nan"), device=card)
    out = ta.flash_attention(q, k, v, lse=lse, **kw)
    want = ta.attention_lse_ref(q, k, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, ta.flash_attention(q, k, v, **kw)), name
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(lse), inf) and not lse.isnan().any()
    err = (lse - want).abs()[~inf] / want.abs()[~inf].clamp_min(1.0)
    assert float(err.max()) < 1e-4, name


def test_attention_on_card_keeps_the_autograd_graph(card):
    """Any attention input on the card that requires grad gives an output
    with a grad_fn, and its gradients come from `flash_bwd`; without
    grad the forward kernel alone runs."""
    from repro_torch.kernels.attention.cases import bwd_inputs
    q, k, v, do = bwd_inputs((2, 70, 8, 2, 64), 3, card, torch.bfloat16)
    for which in range(3):
        leaves = [x.clone().requires_grad_(i == which)
                  for i, x in enumerate((q, k, v))]
        ta.reset_launches()
        out = ta.attention(*leaves, device=card)
        assert out.grad_fn is not None, which
        out.backward(do)
        assert ta.LAUNCHES["flash_bwd"] == 1
        assert leaves[which].grad is not None
    with torch.no_grad():
        assert ta.attention(q.requires_grad_(), k, v,
                            device=card).grad_fn is None


def test_reduced_training_resumes_on_card_with_the_same_losses(card):
    """The reduced qwen3-32b trained 6 steps on the card, and again killed
    after its checkpoint at step 3 and resumed from fresh parameters:
    the same losses at steps 4-6 and the same parameters, bit for bit
    (every kernel on the path is deterministic: no float atomics)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params
    from repro_torch.models.common import tree_leaves
    from repro_torch.storage import InMemoryBlobStore
    from repro_torch.training import (CheckpointManager, OptimizerConfig,
                                      TrainLoopConfig, run)

    cfg = get_config("qwen3-32b", reduced=True)
    model = build_model(cfg)

    class Batches:
        def batches(self, start, n):
            for step in range(start, start + n):
                rng = np.random.default_rng(step)
                toks = torch.from_numpy(rng.integers(
                    0, cfg.vocab, (2, 65)).astype(np.int32))
                yield step, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def fresh(seed):
        return init_params(model.param_desc(),
                           torch.Generator(device=card).manual_seed(seed),
                           card)

    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=6)
    loop = dict(checkpoint_every=3, log_every=1)
    ta.reset_launches()
    whole, wlog = run(model, fresh(0), Batches(), None,
                      TrainLoopConfig(total_steps=6, **loop), opt)
    assert ta.LAUNCHES["flash_bwd"] == 6 * cfg.n_layers
    ckpt = CheckpointManager(InMemoryBlobStore())
    _, first = run(model, fresh(0), Batches(), ckpt,
                   TrainLoopConfig(total_steps=3, **loop), opt)
    state, second = run(model, fresh(1), Batches(), ckpt,
                        TrainLoopConfig(total_steps=6, **loop), opt)
    assert second.resumed_from == 3
    assert first.losses + second.losses == wlog.losses
    for a, b in zip(tree_leaves(whole), tree_leaves(state)):
        assert torch.equal(a, b)


# ------------------------------------- the wkv and fused scan backwards
from repro_torch.kernels.rwkv import cases as wkv_cases  # noqa: E402
from repro_torch.kernels.ssm import cases as scan_cases  # noqa: E402

_WKV_BWD = wkv_cases.bwd_cases()
_SCAN_BWD = scan_cases.bwd_cases()
_WKV_NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def _grads_close(got, want, names, tol, name):
    """Each gradient within `tol` of its dtype of the plain version's
    largest |value| (None where the plain version gives None)."""
    for what, g, w in zip(names, got, want):
        assert (g is None) == (w is None), (name, what)
        if g is None:
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, (name, what)
        limit = tol["bfloat16" if g.dtype == torch.bfloat16 else "float32"]
        scale = max(float(w.float().abs().max()), 1e-30)
        err = float((g.float() - w.float()).abs().max()) / scale
        assert err <= limit, (name, what, err)


@pytest.mark.parametrize("case", range(len(_WKV_BWD)),
                         ids=[c[0] for c in _WKV_BWD])
def test_wkv_bwd_matches_plain_on_card(card, case):
    """`wkv_bwd_cuda` against `wkv_bwd_ref` on every backward edge case
    (`kernels.rwkv.cases`): float32 gradients within 1e-4 of their scale,
    bf16 ones (dr, dk, dv of bf16 r, k, v) one rounding more; one launch
    counted; a second call equal bit for bit."""
    args = wkv_cases.bwd_inputs(_WKV_BWD[case], case, card)
    tr.reset_launches()
    got = tr.wkv_bwd_cuda(*args)
    assert tr.LAUNCHES["wkv_bwd"] == 1
    want = tr.wkv_bwd_ref(*args)
    torch.cuda.synchronize()
    _grads_close(got, want, _WKV_NAMES, wkv_cases.BWD_TOL, _WKV_BWD[case][0])
    for a, b in zip(got, tr.wkv_bwd_cuda(*args)):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("case", [0, 5, 16, 27])
def test_wkv_through_autograd_uses_the_backward_kernel_on_card(card, case):
    """Gradients that autograd takes through `ops.wkv` on the card come
    from one forward and one `wkv_bwd` launch and equal the plain
    backward's at the kernel forward's inputs."""
    r, k, v, w, u, s0, dout, ds_fin = wkv_cases.bwd_inputs(_WKV_BWD[case],
                                                           case, card)
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u)]
    init = None if s0 is None else s0.clone().requires_grad_()
    tr.reset_launches()
    out, s_fin = tr.wkv(*leaves, init, device=card)
    loss = (out * dout).sum()
    if ds_fin is not None:
        loss = loss + (s_fin * ds_fin).sum()
    got = torch.autograd.grad(loss, leaves + ([] if init is None
                                              else [init]))
    assert tr.LAUNCHES == {"wkv": 1, "wkv_bwd": 1}
    want = [g for g in tr.wkv_bwd_ref(r, k, v, w, u, s0, dout, ds_fin)
            if g is not None]
    _grads_close(got, want, _WKV_NAMES, wkv_cases.BWD_TOL, case)


@pytest.mark.parametrize("case", range(len(_SCAN_BWD)),
                         ids=[c[0] for c in _SCAN_BWD])
def test_scan_fused_bwd_matches_plain_on_card(card, case):
    """`selective_scan_fused_bwd_cuda` against
    `selective_scan_fused_bwd_ref` on every backward edge case
    (`kernels.ssm.cases`: strided B_ and C_, exp's denormal range), from
    the states a forward launch saved: float32 gradients within 1e-4 of
    their scale, bf16 ones (dB_, dC_, dx) one rounding more; one forward
    and one backward launch counted; a second call equal bit for bit."""
    args = scan_cases.bwd_inputs(_SCAN_BWD[case], case, card)
    ts.reset_launches()
    states = ts.selective_scan_fused_cuda(*args[:7], states=True)[2]
    got = ts.selective_scan_fused_bwd_cuda(*args, states)
    assert ts.LAUNCHES == {"selective_scan": 0, "selective_scan_fused": 1,
                           "selective_scan_fused_bwd": 1}
    want = ts.selective_scan_fused_bwd_ref(*args)
    torch.cuda.synchronize()
    _grads_close(got, want, scan_cases.GRADS, scan_cases.BWD_TOL,
                 _SCAN_BWD[case][0])
    for a, b in zip(got, ts.selective_scan_fused_bwd_cuda(*args, states)):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("case", range(len(_SCAN_BWD)),
                         ids=[c[0] for c in _SCAN_BWD])
def test_scan_fused_saved_states_match_plain_on_card(card, case):
    """The fused scan kernel asked for its states: y and h_fin equal the
    same launch's without them bit for bit, and the state before every
    `BWD_CHUNK`-th step equals the plain forward's
    (`selective_scan_fused_ref(..., states=True)`) within 1e-5 of its
    scale, the fused scan's own tolerance."""
    args = scan_cases.bwd_inputs(_SCAN_BWD[case], case, card)[:7]
    y, h, states = ts.selective_scan_fused_cuda(*args, states=True)
    y1, h1 = ts.selective_scan_fused_cuda(*args)
    assert torch.equal(y, y1) and torch.equal(h, h1)
    want = ts.selective_scan_fused_ref(*args, states=True,
                                       chunk=scan_cases.BWD_CHUNK)[2]
    torch.cuda.synchronize()
    assert states.shape == want.shape
    scale = max(float(want.abs().max()), 1e-30)
    assert float((states - want).abs().max()) / scale <= 1e-5


@pytest.mark.parametrize("case", [0, 3, 17, 20])
def test_scan_fused_through_autograd_uses_the_backward_kernel_on_card(
        card, case):
    """Gradients that autograd takes through `ops.selective_scan_fused`
    on the card (B_ and C_ strided views of one projection) come from one
    forward and one backward launch and equal the plain backward's."""
    dt, A, B_, C_, x, D, h0, dy, dh_fin = scan_cases.bwd_inputs(
        _SCAN_BWD[case], case, card)
    leaves = [t.clone().requires_grad_() for t in (dt, A, x)]
    N = A.shape[1]
    proj = torch.cat([B_, C_], -1).clone().requires_grad_()
    extra = [None if t is None else t.clone().requires_grad_()
             for t in (D, h0)]
    ts.reset_launches()
    y, h = ts.selective_scan_fused(leaves[0], leaves[1], proj[..., :N],
                                   proj[..., N:], leaves[2], *extra,
                                   device=card)
    assert ts.LAUNCHES["selective_scan_fused_bwd"] == 0
    loss = (y * dy).sum()
    if dh_fin is not None:
        loss = loss + (h * dh_fin).sum()
    got = torch.autograd.grad(loss, leaves + [proj] + [
        t for t in extra if t is not None])
    assert ts.LAUNCHES["selective_scan_fused"] == 1
    assert ts.LAUNCHES["selective_scan_fused_bwd"] == 1
    ddt, dA, dB, dC, dx, dD, dh0 = ts.selective_scan_fused_bwd_ref(
        dt, A, B_, C_, x, D, h0, dy, dh_fin)
    want = [ddt, dA, dx, torch.cat([dB, dC], -1)] + [
        g for g in (dD, dh0) if g is not None]
    _grads_close(got, want, ("ddt", "dA", "dx", "dproj", "dD", "dh0"),
                 scan_cases.BWD_TOL, case)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_reduced_rwkv_and_jamba_training_resume_on_card(card, arch):
    """The reduced RWKV-6 and Jamba trained 4 steps on the card through
    the wkv and fused scan backwards (and flash_bwd), and again killed
    after the step-2 checkpoint and resumed from fresh parameters: the
    same losses and parameters bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params
    from repro_torch.models.common import tree_leaves
    from repro_torch.storage import InMemoryBlobStore
    from repro_torch.training import (CheckpointManager, OptimizerConfig,
                                      TrainLoopConfig, run)

    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)

    class Batches:
        def batches(self, start, n):
            for step in range(start, start + n):
                rng = np.random.default_rng(step)
                toks = torch.from_numpy(rng.integers(
                    0, cfg.vocab, (2, 65)).astype(np.int32))
                yield step, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def fresh(seed):
        return init_params(model.param_desc(),
                           torch.Generator(device=card).manual_seed(seed),
                           card)

    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    loop = dict(checkpoint_every=2, log_every=1)
    for mod in (tr, ts, ta):
        mod.reset_launches()
    whole, wlog = run(model, fresh(0), Batches(), None,
                      TrainLoopConfig(total_steps=4, **loop), opt)
    bwd = (tr.LAUNCHES["wkv_bwd"] if arch == "rwkv6-3b"
           else ts.LAUNCHES["selective_scan_fused_bwd"])
    assert bwd == 4 * (cfg.n_layers if arch == "rwkv6-3b"
                       else cfg.n_layers - cfg.n_layers // cfg.attn_every)
    ckpt = CheckpointManager(InMemoryBlobStore())
    _, first = run(model, fresh(0), Batches(), ckpt,
                   TrainLoopConfig(total_steps=2, **loop), opt)
    state, second = run(model, fresh(1), Batches(), ckpt,
                        TrainLoopConfig(total_steps=4, **loop), opt)
    assert second.resumed_from == 2
    assert first.losses + second.losses == wlog.losses
    for a, b in zip(tree_leaves(whole), tree_leaves(state)):
        assert torch.equal(a, b)
