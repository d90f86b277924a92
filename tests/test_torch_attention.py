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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import attention as jax_attention
from repro.models.blocks import blockwise_attention
from repro.models.common import NULL_RULES
from repro_torch.kernels import attention as ta

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


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
