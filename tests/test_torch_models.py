"""The port's sliding-window MoE (`mixtral-8x22b`), VLM (`qwen2-vl-72b`),
encoder-decoder (`seamless-m4t-medium`), the dense configs no other test
holds (`granite-20b`, `qwen1.5-110b`, `mistral-large-123b`) and a Jamba
with a sliding window, against the JAX package's models, on the CPU.

The reduced configs of `tests/test_models_smoke.py`. The JAX package
initialises the parameters and `params_from_numpy` carries them across;
tokens, image patches, M-RoPE ids and encoder frames come from numpy
seeds. On the CPU the port's attention is the plain PyTorch version of
the flash kernel.

Tolerances, as a fraction of the largest |value| compared: 2e-5 in
float32 and 3e-2 in bfloat16 (bf16 roundings of the activations, which
the two frameworks take at different places). A cached K/V is bf16 on
both sides: within one bf16 ulp (2^-7) more.

Decode runs on both sides from JAX's prefill cache, carried across, so
that a one-ulp difference between the two prefills' bf16 K/V does not
enter the comparison of the steps after it. JAX's decode attention rounds
its probabilities and its output to bf16 against a bf16 cache
(`repro/models/blocks.py:149`), where the port, like the TPU kernel,
keeps them in float32 (ROADMAP §3, by design): in float32 the port's
attention is swapped for one that rounds where JAX's does, as
`tests/test_torch_transformer.py` does. The long decodes through a
rolling cache (more than a hundred steps, each writing new bf16 K/V that
the two sides may round to different neighbours) hold K/V in float32 on
both sides instead, so nothing rounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import NULL_RULES
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro_torch.configs import SHAPES, get_config
from repro_torch.kernels import attention as ta
from repro_torch.kernels.attention.ref import _allowed
from repro_torch.models import (EncDecModel, TransformerModel, batch_desc,
                                build_model, init_params, param_count,
                                params_from_numpy)
from repro_torch.models import encdec, hybrid, transformer
from repro_torch.models.common import tree_map

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
BF16_ULP = 2.0**-7
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
B, EXTRA = 2, 3


def _rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


def _both(arch, dtype, seed=1, **changes):
    """(JAX model, JAX params, port model, port params) for the reduced
    `arch` with `changes`, float32 or bf16 parameters alike."""
    jcfg = jax_get_config(arch, reduced=True).with_(**changes)
    jmodel = jax_build_model(jcfg)
    jparams = jax_init_params(jmodel.param_desc(), jax.random.PRNGKey(seed))
    if dtype == "float32":
        jparams = jax.tree.map(lambda x: x.astype(jnp.float32), jparams)
    model = build_model(get_config(arch, reduced=True).with_(**changes))
    return jmodel, jparams, model, params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


def _activations(rng, shape, dtype=jnp.bfloat16):
    """The same values for both sides: JAX's array and the tensor."""
    x = jnp.asarray(rng.normal(0, 1, shape), dtype)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, jnp.dtype(dtype).name))


def _attention_rounded_as_jax(plain):
    """The port's attention, except against a bf16 cache with float32
    queries: then float32 scores and softmax, and probabilities and output
    rounded to bf16, as JAX's `blockwise_attention` computes them."""
    def attend(q, k, v, *, causal, window, q_positions, kv_positions, **kw):
        if q.dtype != torch.float32 or v.dtype != torch.bfloat16:
            return plain(q, k, v, causal=causal, window=window,
                         q_positions=q_positions, kv_positions=kv_positions,
                         **kw)
        Bq, S, H, dh = q.shape
        KV = k.shape[2]
        ok = _allowed(Bq, S, k.shape[1], causal, window, q_positions,
                      kv_positions, q.device)[:, None, None]
        s = torch.einsum("bskgd,btkd->bkgst",
                         q.float().reshape(Bq, S, KV, -1, dh),
                         k.float()) / np.sqrt(dh)
        p = torch.softmax(s.masked_fill(~ok, -1e30), dim=-1)
        out = torch.einsum("bkgst,btkd->bskgd", p.bfloat16().float(),
                           v.float())
        return out.bfloat16().float().reshape(Bq, S, H, dh)
    return attend


@pytest.fixture
def jax_rounding(monkeypatch):
    """Swap every model module's attention for the JAX-rounded one."""
    for module in (transformer, hybrid, encdec):
        monkeypatch.setattr(module, "attention",
                            _attention_rounded_as_jax(module.attention))


def _check_cache(got: dict, want: dict, tol: float, what) -> None:
    assert np.array_equal(got["kpos"].numpy(), want["kpos"]), what
    assert int(got["pos"]) == int(want["pos"]), what
    for name in ("k", "v", "cross_k", "cross_v"):
        if name not in want:
            continue
        g, w = got[name], want[name]
        assert g.shape == w.shape, (what, name)
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, \
            (what, name)
        bound = tol + (BF16_ULP if w.dtype.name == "bfloat16" else 0)
        assert _rel_err(g, w) <= bound, (what, name, _rel_err(g, w))


def _carried(cache_np: dict) -> dict:
    """JAX's cache as the port's: the same tensors, `pos` on the host."""
    cache = params_from_numpy(cache_np, "cpu")
    cache["pos"] = torch.tensor(int(cache_np["pos"]), dtype=torch.int32)
    return cache


def _prefill_then_decode(jmodel, jparams, model, params, dtype, jbatch,
                         batch, steps, pad_to):
    """Prefill on both sides (logits and cache compared), then decode
    `steps` — pairs of JAX and port batches — on both from JAX's prefill
    cache (logits and cache compared after each)."""
    tol = TOL[dtype]
    lj, cj = jax.jit(lambda p, b: jmodel.prefill(
        p, b, NULL_RULES, pad_to=pad_to))(jparams, jbatch)
    cj = jax.tree.map(np.asarray, cj)
    ta.reset_launches()
    logits, cache = model.prefill(params, batch, pad_to=pad_to)
    assert logits.dtype == torch.float32 and logits.shape == lj.shape
    assert _rel_err(logits, lj) <= tol, ("prefill", _rel_err(logits, lj))
    _check_cache(cache, cj, tol, "prefill")
    dec = jax.jit(lambda p, c, b: jmodel.decode_step(p, c, b, NULL_RULES))
    cache = _carried(cj)
    for step, (jb, tb) in enumerate(steps, 1):
        lj, cj = dec(jparams, cj, jb)
        cj = jax.tree.map(np.asarray, cj)
        logits, cache = model.decode_step(params, cache, tb)
        assert _rel_err(logits, lj) <= tol, (step, _rel_err(logits, lj))
        _check_cache(cache, cj, tol, step)
    assert ta.LAUNCHES["flash_attention"] == 0      # CPU: the plain version


def _token_steps(toks, S):
    return [({"tokens": jnp.asarray(toks[:, S + t:S + t + 1])},
             {"tokens": torch.from_numpy(toks[:, S + t:S + t + 1])})
            for t in range(EXTRA)]


# ------------------------------------------------------------- LMs
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,S", [
    ("granite-20b", 40),            # MQA, one KV head
    ("qwen1.5-110b", 40),           # QKV bias
    ("mistral-large-123b", 40),     # head_dim given by the config
    ("mixtral-8x22b", 80),          # window 64: it masks in prefill
])
def test_lm_prefill_and_decode_match_jax(arch, S, dtype, jax_rounding):
    jmodel, jparams, model, params = _both(arch, dtype)
    assert isinstance(model, TransformerModel)
    toks = np.random.default_rng(2).integers(
        4, model.cfg.vocab, (B, S + EXTRA)).astype(np.int32)
    _prefill_then_decode(jmodel, jparams, model, params, dtype,
                         {"tokens": jnp.asarray(toks[:, :S])},
                         {"tokens": torch.from_numpy(toks[:, :S])},
                         _token_steps(toks, S), pad_to=S + EXTRA)


def _empty_cache(jmodel, model, cache_len, f32_kv):
    """An empty `cache_desc` cache on both sides; K/V in float32 where
    `f32_kv` (so that neither side rounds a new K/V entry)."""
    cj = jax.tree.map(np.asarray, jax_init_params(
        jmodel.cache_desc(B, cache_len), jax.random.PRNGKey(0)))
    cache = init_params(model.cache_desc(B, cache_len), torch.Generator(),
                        "cpu")
    assert np.array_equal(cache["kpos"].numpy(), cj["kpos"])
    if f32_kv:
        kv_j = cj["slots"][f"slot{jmodel.period - 1}"] if "slots" in cj \
            else cj
        kv_t = cache["slots"][f"slot{model.period - 1}"] if "slots" in cache \
            else cache
        for name in ("k", "v"):
            kv_j[name] = kv_j[name].astype(np.float32)
            kv_t[name] = kv_t[name].float()
    return cj, cache


def _ring_decode(jmodel, jparams, model, params, dtype, cache_len, steps,
                 window):
    """`steps` decode steps from an empty rolling cache on both sides:
    every step's logits, the ring's `kpos` (slot p % window holds
    position p) and `pos` compared."""
    cj, cache = _empty_cache(jmodel, model, cache_len, dtype == "float32")
    toks = np.random.default_rng(4).integers(
        4, model.cfg.vocab, (B, steps)).astype(np.int32)
    dec = jax.jit(lambda p, c, b: jmodel.decode_step(p, c, b, NULL_RULES))
    worst = 0.0
    for t in range(steps):
        lj, cj = dec(jparams, cj, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        logits, cache = model.decode_step(
            params, cache, {"tokens": torch.from_numpy(toks[:, t:t + 1])})
        err = _rel_err(logits, lj)
        worst = max(worst, err)
        assert err <= TOL[dtype], (t, err)
        kpos = np.asarray(cj["kpos"])
        assert np.array_equal(cache["kpos"].numpy(), kpos), t
        assert int(cache["pos"]) == int(cj["pos"]) == t + 1
    want = np.arange(steps - window, steps)        # the last window
    assert kpos.shape == (window,)
    assert np.array_equal(kpos[want % window], want)
    return worst


def test_mixtral_rolling_cache_wraps_twice_as_jax():
    """mixtral's window of 64: a `cache_desc` cache of 200 positions has
    64 slots; 140 steps wrap it twice, so most steps attend to a ring
    whose key positions are not sorted. float32: in bf16 the two sides'
    roundings flip a top-2 routing or a capacity decision of the MoE
    within the 140 steps (0.37 of the logits' scale at step 83; 0.16 at
    step 11 with a capacity that drops nothing), which the ring does not
    cause; the bf16 ring runs in `chip_smoke.py`'s `mixtral` phase."""
    jmodel, jparams, model, params = _both("mixtral-8x22b", "float32",
                                           seed=5)
    window = model.cfg.swa
    assert window == 64
    assert model.cache_desc(B, 200)["k"].shape[2] == window
    _ring_decode(jmodel, jparams, model, params, "float32", 200,
                 2 * window + 12, window)


def test_jamba_with_a_window_decodes_past_its_ring_as_jax():
    """The reduced Jamba with `swa` = 16: its attention layers' cache of
    16 slots rolls as the transformer's does; 40 steps wrap it twice.
    float32: the whole bf16 hybrid grows one-ulp roundings beyond what a
    tolerance can tell apart (`tests/test_torch_hybrid.py`)."""
    jmodel, jparams, model, params = _both("jamba-v0.1-52b", "float32",
                                           seed=6, swa=16)
    _ring_decode(jmodel, jparams, model, params, "float32", 100, 40, 16)


# ------------------------------------------------------------- VLM
def _qwen2_vl_positions(grids, n_text):
    """Qwen2-VL's position ids (B, S, 3): an h × w grid of patches at
    (0, row, col), then text from the largest id + 1 with all three ids
    equal. Returns the ids and each row's next text id."""
    rows, nxt = [], []
    for h, w in grids:
        r, c = np.divmod(np.arange(h * w), w)
        img = np.stack([np.zeros_like(r), r, c], -1)
        start = max(h, w)
        txt = np.repeat(np.arange(start, start + n_text)[:, None], 3, -1)
        rows.append(np.concatenate([img, txt]))
        nxt.append(start + n_text)
    return np.stack(rows).astype(np.int32), np.array(nxt, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_prefill_and_decode_match_jax(dtype, jax_rounding):
    """Two rows, 16 patches each on other grids (4×4 and 2×8), so their
    text positions differ; 24 text tokens, then three decode steps with
    (B, 1, 3) ids. Patches share a temporal id and attend to one another.
    The cache's `kpos` is row 0's temporal ids, as JAX's."""
    jmodel, jparams, model, params = _both("qwen2-vl-72b", dtype)
    rng = np.random.default_rng(3)
    n_text, D = 24, model.cfg.d_model
    positions, nxt = _qwen2_vl_positions([(4, 4), (2, 8)], n_text)
    assert not np.array_equal(positions[0, :, 0], positions[1, :, 0])
    S = positions.shape[1]
    toks = rng.integers(4, model.cfg.vocab, (B, n_text + EXTRA)
                        ).astype(np.int32)
    jp, tp = _activations(rng, (B, S - n_text, D))
    jbatch = {"tokens": jnp.asarray(toks[:, :n_text]), "patches": jp,
              "positions": jnp.asarray(positions)}
    batch = {"tokens": torch.from_numpy(toks[:, :n_text]), "patches": tp,
             "positions": torch.from_numpy(positions)}
    steps = []
    for t in range(EXTRA):
        ids = np.repeat((nxt + t)[:, None, None], 3, -1)     # (B, 1, 3)
        tok = toks[:, n_text + t:n_text + t + 1]
        steps.append(({"tokens": jnp.asarray(tok),
                       "positions": jnp.asarray(ids)},
                      {"tokens": torch.from_numpy(tok),
                       "positions": torch.from_numpy(ids)}))
    _prefill_then_decode(jmodel, jparams, model, params, dtype, jbatch,
                         batch, steps, pad_to=S + EXTRA)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_decode_from_an_empty_cache_matches_jax(dtype, jax_rounding):
    """`tests/test_models_smoke.py::test_vlm_decode_runs`'s case: an empty
    cache of 64 slots at pos 5, ids (5, 5, 5) and token 1 in both rows."""
    jmodel, jparams, model, params = _both("qwen2-vl-72b", dtype, seed=0)
    cj = jax_init_params(jmodel.cache_desc(2, 64), jax.random.PRNGKey(0))
    cj = dict(cj, pos=jnp.int32(5))
    cache = _carried(jax.tree.map(np.asarray, cj))
    ids = np.full((2, 1, 3), 5, np.int32)
    lj, cj2 = jax.jit(lambda p, c, b: jmodel.decode_step(
        p, c, b, NULL_RULES))(jparams, cj, {"tokens": jnp.ones((2, 1),
                                                                jnp.int32),
                                            "positions": jnp.asarray(ids)})
    logits, cache2 = model.decode_step(
        params, cache, {"tokens": torch.ones((2, 1), dtype=torch.int32),
                        "positions": torch.from_numpy(ids)})
    assert logits.shape == (2, model.cfg.vocab)
    assert torch.isfinite(logits).all()
    assert _rel_err(logits, lj) <= TOL[dtype]
    _check_cache(cache2, jax.tree.map(np.asarray, cj2), TOL[dtype], "decode")
    assert int(cache2["pos"]) == 6


# ------------------------------------------------------- encoder-decoder
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_encode_prefill_and_decode_match_jax(dtype, jax_rounding,
                                                    monkeypatch):
    """48 encoder frames, a 20-token decoder prompt, three decode steps:
    the encoder's output, the logits, the self and cross caches.

    JAX's encoder casts the frames to bf16 and scans them through its
    layers, which cannot then take float32 weights (the scan's carry
    would change dtype). So the encoder runs in bf16 on both sides and
    its output is held at the bf16 tolerance; in the float32 case every
    other parameter is float32 and the port's decoder takes JAX's encoder
    output, so the decoder is held at 2e-5."""
    jmodel, jparams, model, params = _both("seamless-m4t-medium", "bfloat16")
    assert isinstance(model, EncDecModel)
    if dtype == "float32":
        jparams = {k: v if k == "enc_layers" else jax.tree.map(
            lambda x: x.astype(jnp.float32), v) for k, v in jparams.items()}
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(7)
    S, S_enc = 20, 48
    jf, tf = _activations(rng, (B, S_enc, model.cfg.d_model))
    mem_j = jax.jit(lambda p, f: jmodel.encode(p, f, NULL_RULES))(jparams,
                                                                   jf)
    mem = model.encode(params, tf)
    assert mem.shape == mem_j.shape and str(mem.dtype).removeprefix(
        "torch.") == mem_j.dtype.name
    assert _rel_err(mem, mem_j) <= TOL["bfloat16"]
    if dtype == "float32":
        monkeypatch.setattr(model, "encode", lambda p, f: torch.from_numpy(
            np.array(mem_j)))
    toks = rng.integers(4, model.cfg.vocab, (B, S + EXTRA)).astype(np.int32)
    _prefill_then_decode(
        jmodel, jparams, model, params, dtype,
        {"tokens": jnp.asarray(toks[:, :S]), "frames": jf},
        {"tokens": torch.from_numpy(toks[:, :S]), "frames": tf},
        _token_steps(toks, S), pad_to=S + EXTRA)


def test_encdec_cache_desc_and_training_loss():
    model = build_model(get_config("seamless-m4t-medium", reduced=True))
    cache = init_params(model.cache_desc(3, 10, enc_len=7), torch.Generator(),
                        "cpu")
    L, KV, dh = model.n_dec, model.cfg.n_kv, model.cfg.dh
    assert cache["k"].shape == (L, 3, 10, KV, dh)
    assert cache["cross_k"].shape == (L, 3, 7, KV, dh)
    assert cache["kpos"].tolist() == [-1] * 10 and int(cache["pos"]) == 0
    params = init_params(model.param_desc(), torch.Generator().manual_seed(0),
                         "cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab, (2, 9)).astype(
        np.int32))
    loss = model.loss_fn(params, {
        "frames": torch.from_numpy(rng.normal(0, 1, (
            2, 12, model.cfg.d_model)).astype(np.float32)),
        "tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert loss.shape == () and loss.dtype == torch.float32
    assert torch.isfinite(loss)


def test_batch_desc_matches_jax():
    """The port's input descriptors equal the JAX package's, cell by cell,
    for the three input layouts (tokens; patches and M-RoPE ids; frames)."""
    from repro.models.api import batch_desc as jax_batch_desc
    for arch in ("qwen3-32b", "qwen2-vl-72b", "seamless-m4t-medium"):
        for cell in SHAPES.values():
            want = jax_batch_desc(jax_get_config(arch), cell)
            got = batch_desc(get_config(arch), cell)
            assert sorted(got) == sorted(want), (arch, cell.name)
            for name, d in want.items():
                assert got[name].shape == d.shape, (arch, cell.name, name)
                assert str(got[name].dtype).removeprefix("torch.") == \
                    jnp.dtype(d.dtype).name, (arch, cell.name, name)


def test_param_trees_and_counts_match_jax():
    """Every newly built architecture's parameter tree has JAX's names,
    shapes and dtypes, and JAX's count."""
    from repro.models import param_count as jax_param_count
    for arch in ("mixtral-8x22b", "qwen2-vl-72b", "seamless-m4t-medium"):
        _, jparams, model, params = _both(arch, "bfloat16")
        assert jax.tree.structure(jax.tree.map(lambda _: 0, jparams)) == \
            jax.tree.structure(tree_map(lambda _: 0, init_params(
                model.param_desc(), torch.Generator().manual_seed(0),
                "cpu")))
        assert param_count(params) == jax_param_count(jparams)
