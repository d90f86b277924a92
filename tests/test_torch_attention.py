"""The port's attention (`repro_torch.kernels.attention`) against the JAX
package's, on the CPU.

The port runs with `device="cpu"`, so its entry point takes the plain
PyTorch version; the JAX side runs as its own tests run it (the Pallas
kernel in interpret mode, and the model's `blockwise_attention`). Inputs
come from a numpy seed. Tolerances are those of the JAX package's own
tests: 2e-5 in float32 and 2e-2 in bfloat16 against the Pallas kernel
(`tests/test_kernels.py`), 3e-5 against `blockwise_attention`
(`tests/test_models_smoke.py`).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import attention as jax_attention
from repro.models.blocks import blockwise_attention
from repro.models.common import NULL_RULES
from repro_torch.kernels import attention as ta
from repro_torch.kernels.attention.cases import bwd_cases, int8_cases

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
BWD_CASES = range(len(bwd_cases("cpu")))


def _inputs(rng, B, S, T, H, KV, dh):
    return (rng.normal(0, 1, (B, S, H, dh)).astype(np.float32),
            rng.normal(0, 1, (B, T, KV, dh)).astype(np.float32),
            rng.normal(0, 1, (B, T, KV, dh)).astype(np.float32))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,S,T,dh,causal,window", [
    (1, 2, 2, 128, 128, 64, True, None),
    (2, 4, 2, 256, 256, 64, True, None),       # GQA
    (1, 2, 1, 128, 256, 128, True, None),      # MQA, decode-ish S<T
    (2, 2, 2, 256, 256, 64, True, 128),        # sliding window
    (1, 2, 2, 128, 128, 64, False, None),      # bidirectional
])
def test_attention_matches_pallas_kernel(B, H, KV, S, T, dh, causal, window,
                                         dtype):
    q, k, v = _inputs(np.random.default_rng(0), B, S, T, H, KV, dh)
    want = jax_attention(*(jnp.asarray(x, getattr(jnp, dtype))
                           for x in (q, k, v)),
                         causal=causal, window=window, impl="pallas")
    got = ta.attention(*(_torch(x, dtype) for x in (q, k, v)),
                       causal=causal, window=window, device="cpu")
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, H, dh)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL[dtype])


def _positions_case(name):
    """(S, T, q_positions, kv_positions) of a model-shaped call."""
    if name == "ragged_prefill":               # S = T = 100, arange
        pos = np.arange(100, dtype=np.int32)
        return 100, 100, pos, pos
    # decode: one query at position 60 against a 77-slot cache whose
    # slots past 60 are empty (kpos = -1), as after prefill(pad_to=77)
    kpos = np.full(77, -1, np.int32)
    kpos[:61] = np.arange(61)
    return 1, 77, np.array([60], np.int32), kpos


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("case", ["ragged_prefill", "decode"])
def test_attention_with_positions_matches_blockwise_attention(case, window):
    S, T, qpos, kpos = _positions_case(case)
    B, H, KV, dh = 2, 8, 2, 64
    q, k, v = _inputs(np.random.default_rng(1), B, S, T, H, KV, dh)
    want = blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
        causal=True, window=window, chunk=32, rules=NULL_RULES)
    got = ta.attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), causal=True, window=window,
                       q_positions=torch.from_numpy(qpos),
                       kv_positions=torch.from_numpy(kpos), device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_default_positions_are_end_aligned():
    q, k, v = (torch.from_numpy(x) for x in
               _inputs(np.random.default_rng(2), 1, 3, 10, 4, 2, 32))
    implicit = ta.attention(q, k, v, window=4, device="cpu")
    explicit = ta.attention(q, k, v, window=4, device="cpu",
                            q_positions=torch.arange(7, 10),
                            kv_positions=torch.arange(10))
    assert torch.equal(implicit, explicit)


def test_rows_without_keys_are_zero_and_mixed_dtypes_cast_to_q():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(x) for x in _inputs(rng, 1, 2, 6, 2, 1, 32))
    kpos = torch.tensor([0, 1, 2, -1, -1, -1], dtype=torch.int32)
    qpos = torch.tensor([-5, 2], dtype=torch.int32)   # row 0 sees no key
    out = ta.attention(q, k.bfloat16(), v.bfloat16(), q_positions=qpos,
                       kv_positions=kpos, device="cpu")
    assert out.dtype == torch.float32
    assert not out[0, 0].any() and out[0, 1].abs().sum() > 0
    want = torch.softmax(
        torch.einsum("hd,td->ht", q[0, 1], k.bfloat16().float()[0, :3, 0])
        / np.sqrt(32), dim=-1) @ v.bfloat16().float()[0, :3, 0]
    torch.testing.assert_close(out[0, 1], want, atol=2e-6, rtol=0)


def test_cpu_tensors_never_reach_the_kernel_and_cuda_without_a_card_raises():
    q, k, v = (torch.from_numpy(x) for x in
               _inputs(np.random.default_rng(4), 1, 4, 4, 2, 2, 32))
    ta.reset_launches()
    ta.attention(q, k, v, device="cpu")
    assert ta.LAUNCHES["flash_attention"] == 0
    with pytest.raises(ValueError, match="impl"):
        ta.attention(q, k, v, impl="pallas", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less path")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ta.attention(q, k, v)


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """The checks run before any build or launch, so they hold here."""
    q = torch.zeros(1, 4, 2, 48)
    with pytest.raises(ValueError, match="head size"):
        ta.flash_attention(q, q, q)
    q = torch.zeros(1, 4, 3, 64)
    with pytest.raises(ValueError, match="multiple of KV"):
        ta.flash_attention(q, torch.zeros(1, 4, 2, 64),
                           torch.zeros(1, 4, 2, 64))
    q = torch.zeros(1, 4, 2, 64)
    with pytest.raises(TypeError, match="bfloat16 or all float32"):
        ta.flash_attention(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError, match="CUDA device"):
        ta.flash_attention(q, q, q)
    assert ta.LAUNCHES["flash_attention"] == 0


# ---- the decode kernel's split-KV merge rule and the kernel choice -------
# `attention_split_ref` computes attention the way the decode kernel does:
# per range of keys a (m, l, acc) triple, merged by the rescale-and-add
# rule. It must equal the full attention, splits with no valid key and
# rows with no key at all included.

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,H,KV,dh", [
    (2, 1, 256, 16, 2, 64),     # decode, g = 8
    (2, 1, 300, 8, 2, 128),     # decode, g = 4, ragged last split
    (1, 5, 77, 4, 2, 32),       # a small prefill the decode kernel takes
])
def test_split_kv_merge_matches_attention_ref_and_jax(B, S, T, H, KV, dh,
                                                      dtype):
    q, k, v = _inputs(np.random.default_rng(5), B, S, T, H, KV, dh)
    tq, tk, tv = (_torch(x, dtype) for x in (q, k, v))
    kind, n_split, keys = ta.plan(B, S, T, H, KV)
    assert kind == "decode"
    want_jax = np.asarray(jax_attention(
        *(jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)),
        causal=True, impl="ref"), np.float32)
    want_ref = ta.attention_ref(tq, tk, tv).float().numpy()
    for split_keys in sorted({keys, 16, 64, T}):
        got = ta.attention_split_ref(tq, tk, tv, split_keys=split_keys)
        assert got.dtype == getattr(torch, dtype)
        got = got.float().numpy()
        np.testing.assert_allclose(got, want_ref, atol=TOL[dtype])
        np.testing.assert_allclose(got, want_jax, atol=TOL[dtype])


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("split_keys", [16, 50, 77])
def test_split_kv_merge_with_empty_splits_matches_blockwise_attention(
        split_keys, window):
    """A 200-slot cache filled up to position 60 (as after prefill with
    pad_to): whole splits hold no valid key. Query 0 sits at -5 and may
    attend to no key: it comes out as zeros (blockwise_attention averages
    such a row instead, so only the other queries are compared to it)."""
    B, S, T, H, KV, dh = 2, 2, 200, 8, 2, 64
    q, k, v = _inputs(np.random.default_rng(6), B, S, T, H, KV, dh)
    kpos = np.full(T, -1, np.int32)
    kpos[:61] = np.arange(61)
    qpos = np.array([-5, 60], np.int32)
    want = np.asarray(blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
        causal=True, window=window, chunk=32, rules=NULL_RULES))
    kw = dict(causal=True, window=window, q_positions=torch.from_numpy(qpos),
              kv_positions=torch.from_numpy(kpos))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = ta.attention_split_ref(tq, tk, tv, split_keys=split_keys, **kw)
    assert not got[:, 0].any()
    np.testing.assert_allclose(got[:, 1].numpy(), want[:, 1], atol=3e-5)
    np.testing.assert_allclose(got.numpy(),
                               ta.attention_ref(tq, tk, tv, **kw).numpy(),
                               atol=2e-5)


@pytest.mark.parametrize("B,T,H,KV", [
    (4, 2032, 64, 8),           # qwen3-32b decode on the LM path
    (4, 2032, 32, 8),           # jamba-v0.1-52b decode
    (1, 2032, 64, 8), (3, 77, 8, 1), (2, 200, 16, 2), (64, 4096, 64, 8),
    (1, 100_000, 8, 1),
])
def test_decode_plan_covers_every_key_with_no_empty_split(B, T, H, KV):
    kind, n_split, keys = ta.plan(B, 1, T, H, KV)
    assert kind == "decode"
    assert 1 <= n_split <= ta.kernel.DECODE_MAX_SPLITS
    assert (n_split - 1) * keys < T <= n_split * keys
    most = min(-(-T // ta.kernel.DECODE_TILE), ta.kernel.DECODE_MAX_SPLITS)
    assert n_split <= most                  # no more splits than tiles
    # two waves of blocks on the card's 132 SMs where the keys allow
    assert B * KV * n_split >= 2 * ta.kernel.SMS or n_split == most


def test_main_path_decode_fills_two_waves_and_prefill_goes_to_prefill():
    for H in (64, 32):          # qwen3-32b and jamba-v0.1-52b
        kind, n_split, _ = ta.plan(4, 1, 2032, H, 8)
        assert kind == "decode" and 4 * 8 * n_split >= 264
        assert ta.plan(4, 2000, 2000, H, 8)[0] == "prefill"
    assert ta.plan(1, 300, 300, 32, 8)[0] == "prefill"
    # the decode kernel takes up to 64 rows (query position, head) per
    # (batch, KV head), so small prefills go to it too
    assert ta.plan(1, 5, 3, 2, 1)[0] == "decode"
    assert ta.plan(1, 8, 8, 8, 1)[0] == "decode"
    assert ta.plan(1, 9, 9, 8, 1) == ("prefill", 1, 9)


# ---- positions per batch row, and a rolling cache ------------------------
def _per_row_case(name, rng):
    """(S, T, q_positions, kv_positions) with one row of positions per
    batch row (B = 3), as a VLM's M-RoPE temporal ids give them: a run of
    equal ids (image patches) and then text from an offset that differs
    by row; in decode one query a row against a shared cache."""
    offsets = np.array([4, 9, 30])
    if name == "prefill":                      # (B, S) and (B, T), S = T
        qpos = np.stack([np.concatenate([np.zeros(12), o + np.arange(28)])
                         for o in offsets]).astype(np.int32)
        return 40, 40, qpos, qpos
    kpos = np.full(50, -1, np.int32)           # row 0's ids, then empty
    kpos[:40] = np.concatenate([np.zeros(12), 4 + np.arange(28)])
    # each row's query past the cache's last id, all within the window
    return 1, 50, np.array([[32], [33], [35]], np.int32), kpos


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("case", ["prefill", "decode"])
def test_per_row_positions_match_blockwise_attention(case, window):
    rng = np.random.default_rng(7)
    S, T, qpos, kpos = _per_row_case(case, rng)
    B, H, KV, dh = 3, 8, 2, 32
    q, k, v = _inputs(rng, B, S, T, H, KV, dh)
    want = np.asarray(blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
        causal=True, window=window, chunk=8, rules=NULL_RULES))
    kw = dict(causal=True, window=window, q_positions=torch.from_numpy(qpos),
              kv_positions=torch.from_numpy(kpos))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = ta.attention(tq, tk, tv, device="cpu", **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)
    # each row alone, with its own row of positions, gives the same rows
    for b in range(B):
        row = ta.attention(tq[b:b + 1], tk[b:b + 1], tv[b:b + 1],
                           device="cpu", causal=True, window=window,
                           q_positions=kw["q_positions"][b],
                           kv_positions=(kw["kv_positions"][b]
                                         if kpos.ndim == 2
                                         else kw["kv_positions"]))
        torch.testing.assert_close(row[0], got[b], atol=0, rtol=0)
    # the decode kernel's split-KV merge rule over per-row positions
    for split_keys in (8, 16, T):
        np.testing.assert_allclose(
            ta.attention_split_ref(tq, tk, tv, split_keys=split_keys,
                                   **kw).numpy(), want, atol=3e-5)


@pytest.mark.parametrize("split_keys", [7, 16, 24])
def test_rolling_cache_after_a_wrap_matches_blockwise_attention(split_keys):
    """A ring of T = window = 24 slots after 73 positions: slot p % 24
    holds position p, so the key positions run 72, 73, 50, 51, ... 71 —
    not sorted. Attention over the ring equals attention over the same
    keys laid out in order, and JAX's over the ring."""
    B, H, KV, dh, W = 2, 4, 2, 64, 24
    rng = np.random.default_rng(8)
    q, k, v = _inputs(rng, B, 1, W, H, KV, dh)
    kpos = np.empty(W, np.int32)
    for p in range(73 - W + 1, 74):
        kpos[p % W] = p
    qpos = np.array([73], np.int32)
    assert not np.all(np.diff(kpos) > 0)
    want = np.asarray(blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
        causal=True, window=W, chunk=8, rules=NULL_RULES))
    kw = dict(causal=True, window=W, q_positions=torch.from_numpy(qpos),
              kv_positions=torch.from_numpy(kpos))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = ta.attention(tq, tk, tv, device="cpu", **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)
    order = np.argsort(kpos)
    sorted_out = ta.attention(tq, tk[:, order], tv[:, order], device="cpu",
                              **dict(kw, kv_positions=torch.from_numpy(
                                  kpos[order])))
    np.testing.assert_allclose(got.numpy(), sorted_out.numpy(), atol=2e-6)
    np.testing.assert_allclose(
        ta.attention_split_ref(tq, tk, tv, split_keys=split_keys,
                               **kw).numpy(), want, atol=3e-5)


def test_kernel_wrapper_takes_per_row_positions_and_refuses_others():
    """(S,)/(B, S) and (T,)/(B, T) pass the wrapper's checks (which then
    stop at the CPU tensors); any other shape is refused."""
    q = torch.zeros(2, 4, 2, 64)
    kv = torch.zeros(2, 6, 2, 64)
    for qp, kp in (((4,), (6,)), ((2, 4), (2, 6)), ((2, 4), (6,))):
        with pytest.raises(ValueError, match="CUDA device"):
            ta.flash_attention(q, kv, kv,
                               q_positions=torch.zeros(qp, dtype=torch.int32),
                               kv_positions=torch.zeros(kp,
                                                        dtype=torch.int32))
    for name, qp, kp in (("q_positions", (3, 4), (6,)),
                         ("kv_positions", (4,), (1, 6)),
                         ("kv_positions", (4,), (2, 5))):
        with pytest.raises(ValueError, match=name):
            ta.kernel._check(q, kv, kv,
                             torch.zeros(qp, dtype=torch.int32),
                             torch.zeros(kp, dtype=torch.int32), None)


# ----------------------------------------------- int8 KV cache attention
def _jax_int8(q, k8, v8, ks, vs, kw):
    """JAX's `blockwise_attention` with k_scale/v_scale on the same
    numbers (the scales as the same bf16 values)."""
    pos = {n: jnp.asarray(kw[n].numpy()) for n in ("q_positions",
                                                    "kv_positions")}
    return np.asarray(blockwise_attention(
        jnp.asarray(q.float().numpy()).astype(
            jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(k8.numpy()), jnp.asarray(v8.numpy()),
        causal=kw.get("causal", True), window=kw.get("window"), chunk=512,
        rules=NULL_RULES,
        k_scale=jnp.asarray(ks.float().numpy()).astype(jnp.bfloat16),
        v_scale=jnp.asarray(vs.float().numpy()).astype(jnp.bfloat16),
        **pos).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(int8_cases("cpu"))))
def test_attention_int8_ref_matches_blockwise_attention(case, dtype):
    """`attention_int8_ref` (and the entry point on the CPU) against JAX's
    int8 path on every int8 edge case. Tolerance 1e-2 of the output's
    scale: the scores are the same float32 products in the same order,
    but the softmax's exp and sum may differ by an ulp, which moves a
    p / ps that lies within an ulp of a rounding boundary by one step
    (ps · v8, at most 1/127 of the row's largest p · v_scale times |v8|).
    In float32 q, most cases agree to 1e-6."""
    from repro_torch.kernels.attention.cases import int8_cases, int8_inputs
    name, shape, kw = int8_cases("cpu")[case]
    kw = {"causal": True, **kw}
    q, k8, v8, ks, vs = int8_inputs(shape, case, "cpu",
                                    getattr(torch, dtype))
    want = _jax_int8(q, k8, v8, ks, vs, kw)
    got = ta.attention_int8(q, k8, v8, ks, vs, device="cpu", **kw)
    assert torch.equal(got, ta.attention_int8_ref(q, k8, v8, ks, vs, **kw))
    assert torch.equal(got, ta.attention(q, k8, v8, k_scale=ks, v_scale=vs,
                                         device="cpu", **kw))
    assert got.dtype == q.dtype and got.shape == q.shape
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got.float().numpy() - want).max() / scale < 1e-2, name


def test_attention_int8_ref_at_several_queries_and_without_positions():
    """S > 1 rows per KV head and end-aligned default positions, as JAX's
    int8 path computes them (float32, 1e-5 of the scale)."""
    from repro_torch.kernels.attention.cases import int8_inputs
    q, k8, v8, ks, vs = int8_inputs((2, 5, 70, 8, 2, 32), 3, "cpu",
                                    torch.float32)
    kw = {"q_positions": torch.arange(65, 70, dtype=torch.int32),
          "kv_positions": torch.arange(70, dtype=torch.int32)}
    want = _jax_int8(q, k8, v8, ks, vs, {"window": 20, **kw})
    got = ta.attention_int8_ref(q, k8, v8, ks, vs, window=20)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-5


def test_int8_wrapper_refuses_what_the_kernel_does_not_take():
    from repro_torch.kernels.attention import kernel as tk
    from repro_torch.kernels.attention.cases import int8_inputs
    q, k8, v8, ks, vs = int8_inputs((1, 1, 64, 8, 8, 64), 0, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tk.flash_decode_int8(q, k8, v8, ks, vs)
    with pytest.raises(TypeError, match="int8"):
        tk.flash_decode_int8(q, k8.float(), v8, ks, vs)
    big = int8_inputs((1, 9, 64, 8, 1, 64), 0, "cpu")
    with pytest.raises(ValueError, match="at most 64"):
        tk.flash_decode_int8(*big)
    with pytest.raises(ValueError, match="impl"):
        ta.attention_int8(q, k8, v8, ks, vs, impl="pallas", device="cpu")


def _covers(n, keys, T):
    """n ranges of `keys` keys hold T keys, each key once, none empty."""
    return n * keys >= T and (n - 1) * keys < T


def test_plan_int8_routes():
    """decode_32k's shape (128, 32768, 8 rows of dh 128) and the lm_int8
    path's (4, 2032) take the cluster route, the latter with C >= 4 for
    the SMs; every key lies in one block; each block's shared memory
    (scores, v_scale, ring) fits the budget; C <= 16; 48 rows against
    20,000 keys, whose scores no cluster holds, take the split route."""
    from repro_torch.kernels.attention import kernel as tk
    assert tk.plan_int8(128, 32768, 8, 8, 128) == ("cluster", 16, 2048)
    route, c, keys = tk.plan_int8(4, 2032, 8, 8, 128)
    assert route == "cluster" and c >= 4 and 4 * 8 * c >= tk.SMS
    route, n, keys = tk.plan_int8(1, 20000, 1, 48, 128)
    assert route == "split" and _covers(n, keys, 20000) and n <= 64
    assert 48 * math.ceil(20000 / 16) * 4 > tk.INT8_SMEM_MAX
    for B, T, KV, R, dh in [(128, 32768, 8, 8, 128), (4, 2032, 8, 8, 128),
                            (1, 4097, 1, 1, 64), (3, 70, 8, 64, 32),
                            (2, 333, 1, 48, 128), (1, 13000, 1, 48, 128),
                            (128, 40000, 8, 8, 128), (1, 1, 1, 1, 32)]:
        route, c, keys = tk.plan_int8(B, T, KV, R, dh)
        assert route == "cluster" and c in tk.INT8_CLUSTERS and c <= 16
        assert _covers(c, keys, T), (B, T, KV, R, dh)
        assert R * keys * 4 < tk.int8_cluster_smem(R, keys, dh) \
            <= tk.INT8_SMEM_MAX
    smem = tk.int8_cluster_smem(8, 2048, 128)
    assert smem <= tk.INT8_SMEM_PAIR and 8 * 2048 * 4 <= smem
    with pytest.raises(ValueError, match="at most 64"):
        tk.plan_int8(1, 64, 1, 65, 64)


# ------------------------------------------------- attention backward
@pytest.mark.parametrize("case", BWD_CASES)
def test_attention_bwd_ref_matches_jax_vjp(case):
    """`attention_bwd_ref` against `jax.vjp` of `blockwise_attention` on
    every backward edge case, float32, 1e-4 of the three gradients'
    joint scale (sums in other orders)."""
    import jax
    from repro_torch.kernels.attention.cases import (bwd_cases, bwd_inputs,
                                                     kv_len)
    name, (B, S, H, KV, dh), kw = bwd_cases("cpu")[case]
    T = kv_len((B, S, H, KV, dh), kw)
    q, k, v, do = bwd_inputs((B, S, H, KV, dh), case, "cpu", torch.float32,
                             T=T)
    pos, kpos = kw.get("q_positions"), kw.get("kv_positions")
    pos = np.arange(S, dtype=np.int32) if pos is None else pos.numpy()
    kpos = np.arange(T, dtype=np.int32) if kpos is None else kpos.numpy()
    out, vjp = jax.vjp(lambda q_, k_, v_: blockwise_attention(
        q_, k_, v_, q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(
            kpos), causal=kw["causal"], window=kw.get("window"), chunk=512,
        rules=NULL_RULES), *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want = vjp(jnp.asarray(do.numpy()))
    got = ta.attention_bwd(q, k, v, torch.from_numpy(np.array(out)), do,
                           device="cpu", **kw)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() / scale < 1e-4, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_CASES)
def test_attention_bwd_ref_matches_autograd_of_attention_ref(case, dtype):
    """The explicit formulas against autograd through `attention_ref` (the
    CPU path of `attention`): 2e-5 of the joint scale in float32; in bf16
    each gradient is rounded to bf16 once on both sides, 1e-2."""
    from repro_torch.kernels.attention.cases import (bwd_cases, bwd_inputs,
                                                     kv_len)
    name, shape, kw = bwd_cases("cpu")[case]
    q, k, v, do = bwd_inputs(shape, case, "cpu", getattr(torch, dtype),
                             T=kv_len(shape, kw))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ta.attention(*leaves, device="cpu", **kw)
    assert out.grad_fn is not None
    want = torch.autograd.grad(out, leaves, do)
    got = ta.attention_bwd_ref(q, k, v, out.detach(), do, **kw)
    scale = max(float(w.float().abs().max()) for w in want)
    tol = 2e-5 if dtype == "float32" else 1e-2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert float((g.float() - w.float()).abs().max()) / scale < tol, name


def test_bwd_wrapper_refuses_what_the_kernel_does_not_take():
    from repro_torch.kernels.attention import kernel as tk
    from repro_torch.kernels.attention.cases import bwd_inputs
    q, k, v, do = bwd_inputs((1, 8, 4, 2, 64), 0, "cpu", torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tk.flash_bwd(q, k, v, q, do)
    with pytest.raises(ValueError, match="out and dout"):
        tk.flash_bwd(q, k, v, q[:, :4], do)
    with pytest.raises(ValueError, match="impl"):
        ta.attention_bwd(q, k, v, q, do, impl="triton", device="cpu")


def test_bwd_routes_and_the_forward_lse_are_chosen_openly():
    """`plan_bwd`: bf16 at dh 64 and 128 on the tensor cores, float32 and
    dh 32 on FMAs; `forward_lse`: only the bf16 prefill kernel writes the
    log-sum-exp; a bare launch on a route that does not take the dtype
    or dh raises before any library is loaded."""
    from repro_torch.kernels.attention import kernel as tk
    from repro_torch.kernels.attention.cases import bwd_inputs
    assert [tk.plan_bwd(torch.bfloat16, dh) for dh in (32, 64, 128)] == \
        ["fma", "tc", "tc"]
    assert {tk.plan_bwd(torch.float32, dh) for dh in (32, 64, 128)} == \
        {"fma"}
    q, k, _, _ = bwd_inputs((2, 300, 16, 2, 64), 0, "cpu", torch.bfloat16)
    assert tk.forward_lse(q, k)                       # 2400 rows a KV head
    assert not tk.forward_lse(q.float(), k.float())   # flash_fwd_f32
    assert not tk.forward_lse(q[:, :4, :8], k[:, :, :1])  # decode: 32 rows
    q, k, v, do = bwd_inputs((1, 8, 4, 2, 32), 0, "cpu", torch.bfloat16)
    for route, dtype in (("tc", torch.float32), ("tc", torch.bfloat16),
                         ("wgmma", torch.bfloat16)):
        x = [t.to(dtype) for t in (q, k, v, do)]
        with pytest.raises(ValueError, match="route"):
            tk.launch_bwd(*x[:3], x[0], x[3], *x[:3], True, None, None,
                          None, route=route)
    tk.reset_launches()
    tk.BWD_ROUTES["tc"] += 1
    tk.reset_launches()
    assert not tk.BWD_ROUTES


@pytest.mark.parametrize("case", BWD_CASES)
def test_attention_lse_ref_matches_jax_logsumexp(case):
    """`attention_lse_ref` (what the prefill kernel writes for the
    backward) against `jax.nn.logsumexp` of the scores masked as the JAX
    package's `blockwise_attention` masks them, float32, on every
    backward edge case: within 1e-5 of max(1, |lse|); +inf exactly where
    no key is allowed."""
    import jax
    from repro_torch.kernels.attention.cases import bwd_inputs, kv_len
    name, (B, S, H, KV, dh), kw = bwd_cases("cpu")[case]
    T = kv_len((B, S, H, KV, dh), kw)
    q, k, _, _ = bwd_inputs((B, S, H, KV, dh), case, "cpu", torch.float32,
                            T=T)
    pos, kpos = kw.get("q_positions"), kw.get("kv_positions")
    pos = np.arange(S, dtype=np.int32) if pos is None else pos.numpy()
    kpos = np.arange(T, dtype=np.int32) if kpos is None else kpos.numpy()
    pos, kpos = np.broadcast_to(pos, (B, S)), np.broadcast_to(kpos, (B, T))
    qj = jnp.asarray(q.numpy()).reshape(B, S, KV, H // KV, dh)
    s = jnp.einsum("bckgd,btkd->bkgct", qj, jnp.asarray(k.numpy()),
                   preferred_element_type=jnp.float32) / np.sqrt(dh)
    qp, kp = pos[:, None, None, :, None], kpos[:, None, None, None, :]
    mask = (kp >= 0) & (qp >= kp if kw["causal"] else True)
    if kw.get("window") is not None:
        mask &= (qp - kp) < kw["window"]
    want = jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1)
    want = np.asarray(jnp.transpose(want, (0, 3, 1, 2))).reshape(B, S, H)
    got = ta.attention_lse_ref(q, k, **kw).numpy()
    seen = np.broadcast_to(np.asarray(mask).any(-1), (B, KV, H // KV, S))
    none = ~seen.transpose(0, 3, 1, 2).reshape(B, S, H)
    assert np.array_equal(np.isposinf(got), none), name
    err = np.abs(got - want)[~none] / np.maximum(np.abs(want[~none]), 1.0)
    assert err.max() < 1e-5, name


def test_attention_lse_ref_is_inf_on_rows_without_keys():
    """A row whose keys are all masked (empty slots) has lse = +inf, so
    its probabilities exp(s - lse) vanish, as the kernels' zeros."""
    rng = np.random.default_rng(0)
    q, k, _ = _inputs(rng, 1, 3, 6, 2, 1, 64)
    kv_positions = torch.tensor([0, 1, 2, -1, -1, -1], dtype=torch.int32)
    q_positions = torch.tensor([0, 1, 2], dtype=torch.int32)
    lse = ta.attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                               q_positions=q_positions,
                               kv_positions=kv_positions - 5)
    assert torch.isinf(lse).all() and (lse > 0).all()
    lse = ta.attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                               q_positions=q_positions,
                               kv_positions=kv_positions)
    assert torch.isfinite(lse).all()
