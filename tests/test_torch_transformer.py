"""The port's dense transformer (`repro_torch.models`) against the JAX
package's, on the CPU, with the weights carried across.

`qwen3-32b` REDUCED (2 layers, d_model 128, 4 heads over 2 KV heads,
QK-norm). The JAX package initialises the parameters
(`init_params(..., PRNGKey(1))`) and `params_from_numpy` carries them into
the port; tokens come from a numpy seed. Both run prefill into a padded
cache and then three decode steps; the port runs on the CPU, so its
attention is the plain PyTorch version of the flash kernel.

Tolerances, as a fraction of max(|logits|, 1):
- float32 (parameters cast to float32 on both sides): 1e-3 for prefill.
  Decode steps get 1e-2: the KV cache is bf16 on both sides, and JAX's
  decode attention also rounds its probabilities and its output to bf16
  (`blocks.py:149`) where the port, like the TPU kernel, keeps them in
  float32. That rounding alone measured 2.8e-3 of the scale here; with it
  copied into the port's attention the two agree to 1e-5
  (`test_decode_matches_jax_to_1e5_with_jax_rounding`).
- bfloat16: 3e-2, a few bf16 roundings (2^-8 each) of the activations
  through two layers of products that the two frameworks round at
  different places.
`kpos` and `pos` must be equal.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import NULL_RULES
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.models import param_count as jax_param_count
from repro_torch.configs import get_config
from repro_torch.kernels import attention as ta
from repro_torch.models import (build_model, init_params, param_count,
                                params_from_numpy)
from repro_torch.models.convert import tensor_from_numpy

REPO = Path(__file__).resolve().parents[1]
S, EXTRA, B = 40, 3, 2
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
TOL = {"float32": 1e-3, "bfloat16": 3e-2}
DECODE_TOL = {"float32": 1e-2, "bfloat16": 3e-2}


@pytest.fixture(scope="module")
def jax_side():
    cfg = jax_get_config("qwen3-32b", reduced=True)
    model = jax_build_model(cfg)
    params = jax_init_params(model.param_desc(), jax.random.PRNGKey(1))
    toks = np.random.default_rng(0).integers(4, cfg.vocab, (B, S + EXTRA)
                                             ).astype(np.int32)
    return model, params, toks


def _cast_jax(params, dtype):
    return params if dtype == "bfloat16" else jax.tree.map(
        lambda x: x.astype(jnp.float32), params)


def _run_jax(model, params, toks):
    logits, cache = jax.jit(lambda p, b: model.prefill(
        p, b, NULL_RULES, pad_to=S + EXTRA))(params,
                                              {"tokens": jnp.asarray(toks[:, :S])})
    steps = [(np.asarray(logits), jax.tree.map(np.asarray, cache))]
    dec = jax.jit(lambda p, c, b: model.decode_step(p, c, b, NULL_RULES))
    for t in range(EXTRA):
        logits, cache = dec(params, cache,
                            {"tokens": jnp.asarray(toks[:, S + t:S + t + 1])})
        steps.append((np.asarray(logits), jax.tree.map(np.asarray, cache)))
    return steps


def _run_port(model, params, toks):
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(
        toks[:, :S])}, pad_to=S + EXTRA)
    steps = [(logits, {k: v.clone() for k, v in cache.items()})]
    for t in range(EXTRA):
        logits, cache = model.decode_step(
            params, cache, {"tokens": torch.from_numpy(toks[:, S + t:S + t + 1])})
        steps.append((logits, {k: v.clone() for k, v in cache.items()}))
    return steps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(jax_side, dtype):
    jmodel, jparams, toks = jax_side
    jparams = _cast_jax(jparams, dtype)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    model = build_model(get_config("qwen3-32b", reduced=True))
    ta.reset_launches()
    want, got = _run_jax(jmodel, jparams, toks), _run_port(model, params,
                                                            toks)
    assert ta.LAUNCHES["flash_attention"] == 0      # CPU: the plain version
    for step, ((lj, cj), (lt, ct)) in enumerate(zip(want, got)):
        assert lt.dtype == torch.float32 and lt.shape == lj.shape
        scale = max(float(np.abs(lj).max()), 1.0)
        err = float(np.abs(lt.numpy() - lj).max())
        tol = (DECODE_TOL if step else TOL)[dtype]
        assert err <= tol * scale, (dtype, step, err, scale)
        assert np.array_equal(ct["kpos"].numpy(), cj["kpos"])
        assert int(ct["pos"]) == int(cj["pos"]) == S + step
        for name in ("k", "v"):      # bf16: the step's tolerance plus one
            assert ct[name].dtype == torch.bfloat16       # ulp (<= 2^-7)
            assert ct[name].shape == cj[name].shape
            kj = np.asarray(cj[name], np.float32)
            kscale = float(np.abs(kj).max())
            kerr = float(np.abs(ct[name].float().numpy() - kj).max())
            assert kerr <= (tol + 2**-7) * kscale, (dtype, step, name, kerr)


def _attention_rounded_as_jax_decode(q, k, v, *, q_positions, kv_positions,
                                     **_):
    """Decode attention as JAX's `blockwise_attention` computes it against
    a bf16 cache: float32 scores and softmax, then probabilities and the
    output rounded to bf16."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    s = torch.einsum("bskgd,btkd->bkgst", q.float().reshape(B, S, KV, -1, dh),
                     k.float()) / np.sqrt(dh)
    ok = (kv_positions >= 0)[None] & (q_positions[:, None]
                                      >= kv_positions[None])
    p = torch.softmax(s.masked_fill(~ok, -1e30), dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p.bfloat16().float(),
                       v.bfloat16().float())
    return out.bfloat16().float().reshape(B, S, H, dh)


def test_decode_matches_jax_to_1e5_with_jax_rounding(jax_side, monkeypatch):
    """float32, with the port's decode attention swapped for one that
    rounds where JAX's does: then everything else — embedding, norms,
    RoPE, projections, cache writes and positions — agrees to 1e-5."""
    from repro_torch.models import transformer
    jmodel, jparams, toks = jax_side
    jparams = _cast_jax(jparams, "float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    model = build_model(get_config("qwen3-32b", reduced=True))
    plain = transformer.attention
    monkeypatch.setattr(transformer, "attention", lambda q, k, v, **kw: (
        _attention_rounded_as_jax_decode(q, k, v, **kw) if q.shape[1] == 1
        else plain(q, k, v, **kw)))
    for (lj, _), (lt, _) in zip(_run_jax(jmodel, jparams, toks),
                                _run_port(model, params, toks)):
        scale = max(float(np.abs(lj).max()), 1.0)
        assert float(np.abs(lt.numpy() - lj).max()) <= 1e-5 * scale


def test_prefill_then_decode_matches_a_longer_prefill(jax_side):
    """The port's own consistency, as tests/test_models_smoke.py checks
    the JAX package's: three decode steps after prefill give the logits
    of a prefill over the whole sequence."""
    _, jparams, toks = jax_side
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    model = build_model(get_config("qwen3-32b", reduced=True))
    logits = _run_port(model, params, toks)[-1][0]
    full, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    assert cache["k"].shape[2] == S + EXTRA and int(cache["pos"]) == S + EXTRA
    err = float((logits - full).abs().max())
    scale = float(full.abs().max())
    assert err < 0.25 * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_transformer_matches_jax(dtype):
    """`phi3.5-moe-42b-a6.6b` REDUCED (2 layers, 4 experts, top-2, the MoE
    FFN in every layer), the JAX weights carried across: prefill into a
    padded cache and three decode steps, at the dense model's tolerances.
    Decode steps route B = 2 tokens with capacity 1 per expert, so tokens
    are dropped there as in JAX."""
    cfg = jax_get_config(MOE_ARCH, reduced=True)
    jmodel = jax_build_model(cfg)
    jparams = _cast_jax(jax_init_params(jmodel.param_desc(),
                                        jax.random.PRNGKey(3)), dtype)
    toks = np.random.default_rng(1).integers(4, cfg.vocab, (B, S + EXTRA)
                                             ).astype(np.int32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    model = build_model(get_config(MOE_ARCH, reduced=True))
    assert "moe" in params["layers"] and "ffn" not in params["layers"]
    for step, ((lj, cj), (lt, ct)) in enumerate(zip(
            _run_jax(jmodel, jparams, toks), _run_port(model, params, toks))):
        scale = max(float(np.abs(lj).max()), 1.0)
        tol = (DECODE_TOL if step else TOL)[dtype]
        assert float(np.abs(lt.numpy() - lj).max()) <= tol * scale, step
        assert np.array_equal(ct["kpos"].numpy(), cj["kpos"])
        assert int(ct["pos"]) == int(cj["pos"]) == S + step


def test_params_from_numpy_is_exact_and_counts_match(jax_side):
    jmodel, jparams, _ = jax_side
    arrays = jax.tree.map(np.asarray, jparams)
    params = params_from_numpy(arrays, "cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(arrays)
    assert len(flat_j) == len(jax.tree.leaves(params))
    for path, arr in flat_j:
        t = params
        for key in path:
            t = t[key.key]
        assert t.shape == arr.shape
        assert str(t.dtype).removeprefix("torch.") == arr.dtype.name
        if arr.dtype.name == "bfloat16":
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  arr.view(np.int16))
        else:
            assert np.array_equal(t.numpy(), arr)
    cfg = get_config("qwen3-32b", reduced=True)
    model = build_model(cfg)
    assert param_count(params) == param_count(model.param_desc()) \
        == jax_param_count(jparams) == cfg.param_count()
    ro = np.asarray(jnp.ones(3, jnp.bfloat16))      # read-only JAX buffer
    assert tensor_from_numpy(ro, "cpu").tolist() == [1.0, 1.0, 1.0]


def test_init_params_follows_the_jax_init_rules(jax_side):
    jmodel, jparams, _ = jax_side
    model = build_model(get_config("qwen3-32b", reduced=True))
    params = init_params(model.param_desc(), torch.Generator().manual_seed(0),
                         "cpu")
    assert jax.tree.structure(jax.tree.map(lambda _: 0, jparams)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, params))
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(params)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(b.dtype).removeprefix("torch.") == a.dtype.name
    assert torch.equal(params["ln_f"], torch.ones_like(params["ln_f"]))
    wq = params["layers"]["attn"]["wq"].float()       # fan-in d_model = 128
    assert abs(float(wq.std()) * np.sqrt(128) - 1.0) < 0.05
    cache = init_params(model.cache_desc(2, 9), torch.Generator(), "cpu")
    assert cache["k"].shape == (2, 2, 9, 2, 32) and not cache["k"].any()
    assert cache["kpos"].tolist() == [-1] * 9 and int(cache["pos"]) == 0


def test_every_arch_builds_and_the_int8_kv_cache_too():
    """Every architecture of the registry builds, full size and reduced,
    and so does every transformer with the int8 KV cache; its cache
    holds int8 K/V and bf16 scales of ones, as JAX's `cache_desc`."""
    from repro_torch.configs import ARCHS
    for arch in ARCHS:
        build_model(get_config(arch, reduced=True))
        build_model(get_config(arch))
    model = build_model(get_config("qwen3-32b", reduced=True).with_(
        kv_quant=True))
    jmodel = jax_build_model(jax_get_config("qwen3-32b", reduced=True)
                             .with_(kv_quant=True))
    cache = init_params(model.cache_desc(2, 9), torch.Generator(), "cpu")
    jdesc = jmodel.cache_desc(2, 9)
    assert sorted(cache) == sorted(jdesc)
    for name, t in cache.items():
        assert tuple(t.shape) == tuple(jdesc[name].shape), name
        assert str(t.dtype).removeprefix("torch.") == \
            jnp.dtype(jdesc[name].dtype).name, name
    assert cache["k"].dtype == torch.int8 and not cache["k"].any()
    assert torch.equal(cache["k_scale"], torch.ones(2, 2, 9, 2,
                                                    dtype=torch.bfloat16))


def test_quantize_kv_is_bit_equal_to_jax():
    """`_quantize_kv` on equal inputs: the same int8 values and the same
    bf16 scales, bit for bit, float32 and bf16 inputs, with rows of zeros
    and values on the rounding boundaries."""
    from repro.models.transformer import _quantize_kv as jax_quantize
    from repro_torch.models.transformer import _quantize_kv
    rng = np.random.default_rng(4)
    x = rng.normal(0, 3, (2, 33, 4, 32)).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 1, :, :4] = [127.0, 0.5, -0.5, 1.5]
    for dtype in (np.float32, jnp.bfloat16):
        jx = jnp.asarray(x).astype(dtype)
        j8, js = jax_quantize(jx)
        t8, ts = _quantize_kv(tensor_from_numpy(np.asarray(jx), "cpu"))
        assert t8.dtype == torch.int8 and ts.dtype == torch.bfloat16
        assert np.array_equal(t8.numpy(), np.asarray(j8))
        assert np.array_equal(ts.view(torch.int16).numpy(),
                              np.asarray(js).view(np.int16))


def _vlm_batches(cfg, rng, S_img=12, S_txt=28, extra=EXTRA):
    """A VLM prefill batch (patches, tokens, M-RoPE ids per row) and its
    decode steps' tokens and (B, 1, 3) ids."""
    S_all = S_img + S_txt
    ids = np.zeros((B, S_all, 3), np.int32)
    for b in range(B):
        ids[b, :S_img, 0] = 0
        ids[b, :S_img, 1] = np.arange(S_img) // 4
        ids[b, :S_img, 2] = np.arange(S_img) % 4
        ids[b, S_img:] = (np.arange(S_txt) + 4 + b)[:, None]
    pre = {"patches": rng.normal(0, 1, (B, S_img, cfg.d_model)).astype(
               np.float32),
           "tokens": rng.integers(4, cfg.vocab, (B, S_txt)).astype(np.int32),
           "positions": ids}
    steps = [{"tokens": rng.integers(4, cfg.vocab, (B, 1)).astype(np.int32),
              "positions": np.repeat(ids[:, -1:] + 1 + t, 1, axis=1)}
             for t in range(extra)]
    return S_all, pre, steps


@pytest.mark.parametrize("arch", ["qwen3-32b", "qwen2-vl-72b"])
def test_int8_kv_cache_prefill_and_decode_match_jax(arch):
    """`kv_quant=True` (the opt decode variant) on the reduced dense model
    and the VLM, float32 weights: prefill logits within 1e-3 of the
    scale (prefill attends in float32 on both sides and only stores the
    quantized cache), three decode steps through the int8 attention
    within 1e-2 (a K/V value within an ulp of a rounding boundary may
    quantize to the neighbouring int8, and one p8 step moves the output
    by 1/127 of a row's largest p · v_scale); `kpos`, `pos` equal, the
    int8 cache equal but for at most 1 in 10^3 values one step apart,
    the scales within a bf16 ulp."""
    cfg = jax_get_config(arch, reduced=True).with_(kv_quant=True)
    jmodel = jax_build_model(cfg)
    jparams = _cast_jax(jax_init_params(jmodel.param_desc(),
                                        jax.random.PRNGKey(5)), "float32")
    rng = np.random.default_rng(6)
    if cfg.kind == "vlm":
        S_all, pre, steps = _vlm_batches(cfg, rng)
    else:
        S_all = S
        toks = rng.integers(4, cfg.vocab, (B, S + EXTRA)).astype(np.int32)
        pre = {"tokens": toks[:, :S]}
        steps = [{"tokens": toks[:, S + t:S + t + 1]} for t in range(EXTRA)]
    pad = S_all + EXTRA
    logits, cache = jax.jit(lambda p, b: jmodel.prefill(
        p, b, NULL_RULES, pad_to=pad))(
        jparams, {k: jnp.asarray(v) for k, v in pre.items()})
    want = [(np.asarray(logits), jax.tree.map(np.asarray, cache))]
    dec = jax.jit(lambda p, c, b: jmodel.decode_step(p, c, b, NULL_RULES))
    for b in steps:
        logits, cache = dec(jparams, cache,
                            {k: jnp.asarray(v) for k, v in b.items()})
        want.append((np.asarray(logits), jax.tree.map(np.asarray, cache)))

    model = build_model(get_config(arch, reduced=True).with_(kv_quant=True))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    lt, ct = model.prefill(params, {k: torch.from_numpy(v)
                                    for k, v in pre.items()}, pad_to=pad)
    got = [(lt, {k: v.clone() for k, v in ct.items()})]
    for b in steps:
        lt, ct = model.decode_step(params, ct, {k: torch.from_numpy(v)
                                                for k, v in b.items()})
        got.append((lt, {k: v.clone() for k, v in ct.items()}))

    for step, ((lj, cj), (lt, ct)) in enumerate(zip(want, got)):
        scale = max(float(np.abs(lj).max()), 1.0)
        tol = 1e-2 if step else 1e-3
        assert float(np.abs(lt.numpy() - lj).max()) <= tol * scale, step
        assert sorted(ct) == sorted(cj)
        assert np.array_equal(ct["kpos"].numpy(), cj["kpos"])
        assert int(ct["pos"]) == int(cj["pos"])
        for name in ("k", "v"):
            assert ct[name].dtype == torch.int8
            diff = np.abs(ct[name].numpy().astype(np.int32)
                          - cj[name].astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
        for name in ("k_scale", "v_scale"):
            assert ct[name].dtype == torch.bfloat16
            sj = np.asarray(cj[name], np.float32)
            assert np.allclose(ct[name].float().numpy(), sj, rtol=2**-7,
                               atol=0), name


def test_rwkv_builds_and_its_training_loss_raises():
    """RWKV-6 builds, and its training loss (once a raise) is a finite
    float32 scalar."""
    from repro_torch.models import RWKVModel
    model = build_model(get_config("rwkv6-3b", reduced=True))
    assert isinstance(model, RWKVModel)
    params = init_params(model.param_desc(), torch.Generator().manual_seed(0),
                         "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab, (2, 9)).astype(np.int32))
    loss = model.loss_fn(params, {"tokens": toks[:, :-1],
                                  "labels": toks[:, 1:]})
    assert loss.shape == () and loss.dtype == torch.float32
    assert torch.isfinite(loss)


def test_serve_decode_cli_runs_without_jax():
    """`python -m repro_torch.launch.serve --mode decode --device cpu`
    with JAX, the JAX package and ml_dtypes out of reach."""
    script = ("import sys, runpy\n"
              "for m in ('jax', 'jaxlib', 'repro', 'ml_dtypes'):\n"
              "    sys.modules[m] = None\n"
              "sys.argv = ['serve', '--mode', 'decode', '--device', 'cpu',"
              " '--tokens', '4']\n"
              "runpy.run_module('repro_torch.launch.serve', "
              "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "decoded 4 tokens × batch 4" in proc.stdout
    tokens = ast.literal_eval(
        proc.stdout.split("greedy tokens:")[1].strip())
    assert len(tokens) == 4 and all(len(t) == 4 for t in tokens)
