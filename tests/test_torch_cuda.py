"""The port's CUDA kernels on a card, against their plain versions.

Marked `cuda`: they skip without a card (the kernels have no CPU mode)
and run on one with `python -m pytest -m cuda tests/test_torch_cuda.py`.
Only the port, torch and numpy are imported, so they run where JAX is
not installed. The intersect comparisons are exact (integer bitmaps and
counts); flash attention is held to 2e-5 in float32 and 2e-2 in bfloat16
(the JAX package's tolerances for its Pallas kernel), with TF32 off in
the plain version; the wkv kernel to 1e-4 of the largest |value| of its
output and of its final state, the JAX package's wkv tolerance; the
selective scan to 1e-5 of the largest |value| of y and of its final
state, since only the order of y's sums differs from the plain version.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import attention as ta
from repro_torch.kernels import intersect as tx
from repro_torch.kernels import rwkv as tr
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
    assert set(tx.LAUNCHES.values()) == {1}
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
    assert tx.LAUNCHES["intersect_batch"] == 1
    assert tx.LAUNCHES["combine_batch"] == 1
    a, b = results.values()
    assert [(r.refs, r.texts, r.stats) for r in a] == \
        [(r.refs, r.texts, r.stats) for r in b]


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


def test_reduced_jamba_on_card_matches_plain_scan(card):
    """Prefill + 3 decode steps of the reduced jamba-v0.1-52b in float32:
    the model through the scan kernel against the same model through the
    plain scan, teacher-forced on the same tokens, logits to 1e-4 of their
    scale; the kernel runs once per Mamba layer and step."""
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
    assert ts.LAUNCHES["selective_scan"] == 4 * n_mamba
    scale = max(float(runs[1].abs().max()), 1.0)
    assert float((runs[0] - runs[1]).abs().max()) <= 1e-4 * scale
