"""The port's Jamba hybrid (`repro_torch.models.hybrid`, `mamba`) and its
MoE FFN (`blocks.moe_ffn`) against the JAX package's, on the CPU.

The JAX package initialises the parameters and `params_from_numpy`
carries them across; inputs and tokens come from numpy seeds. On the CPU
the port's scan and attention take their plain PyTorch versions; the
kernels are held against those on a card (`tests/test_torch_cuda.py`,
`chip_smoke.py`).

Tolerances, as a fraction of the largest |value| of what is compared:
- float32: 2e-5. Measured at most 9.8e-6 (the prefill's logits and
  states of the 8-layer reduced model): float32 roundings of sums taken
  in another order, grown through the layers.
- bfloat16: 3e-2, for one block or one slot layer given the same input
  on both sides (measured at most 2.0e-2: bf16 roundings of the
  activations, which the two frameworks take at different places). The
  whole 8-layer model is not held to it in bf16: with random weights a
  one-ulp difference grows about 30-fold through the 8 layers (measured
  0.55 of the logits' scale, the same growth as the float32 case's, from
  2^16 finer roundings), so there bf16 cannot tell a right port from a
  wrong one and float32 decides.
- The attention slot's K/V cache is bf16 on both sides: within one bf16
  ulp (2^-7 relative) plus the step's tolerance.

JAX's decode attention rounds its probabilities and output to bf16
against the bf16 cache (`repro/models/blocks.py:149`), where the port,
like the TPU kernel, keeps them in float32 (ROADMAP queue 3, a divergence
by design). So the float32 decode steps run both sides from the same
cache — JAX's prefill cache, carried across, with K/V held in float32 —
which also keeps one-ulp differences of the two prefills' bf16 K/V out of
the comparison of the decode path.
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

from repro.configs import MoEConfig as JaxMoEConfig
from repro.configs import get_config as jax_get_config
from repro.models import NULL_RULES
from repro.models import blocks as jax_blocks
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.models import mamba as jax_mamba
from repro.models import param_count as jax_param_count
from repro.models.hybrid import _conv_tail as jax_conv_tail
from repro_torch.configs import MoEConfig, get_config
from repro_torch.kernels import attention as ta
from repro_torch.kernels import ssm
from repro_torch.models import (HybridModel, build_model, init_params,
                                param_count, params_from_numpy)
from repro_torch.models import blocks, mamba
from repro_torch.models.common import tree_map

REPO = Path(__file__).resolve().parents[1]
ARCH, MOE_ARCH = "jamba-v0.1-52b", "phi3.5-moe-42b-a6.6b"
S, EXTRA, B = 32, 3, 2
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
BF16_ULP = 2.0**-7
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _cast_jax(params, dtype):
    return params if dtype == "bfloat16" else jax.tree.map(
        lambda x: x.astype(jnp.float32), params)


def _rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


def _activations(seed, shape, dtype):
    """The same activations for both sides: JAX's array and the tensor
    of its values."""
    x = jnp.asarray(np.random.default_rng(seed).normal(0, 1, shape),
                    JDTYPE[dtype])
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))


# ---------------------------------------------------------------- moe
@pytest.fixture(scope="module")
def moe_params():
    cfg = jax_get_config(MOE_ARCH, reduced=True)
    params = jax_init_params(jax_build_model(cfg).param_desc(),
                             jax.random.PRNGKey(2))
    return jax.tree.map(lambda a: a[0], params["layers"]["moe"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["global", "grouped"])
@pytest.mark.parametrize("case", ["prefill", "capacity_binds", "decode"])
def test_moe_ffn_matches_jax(moe_params, impl, case, dtype):
    """Reduced phi3.5-moe (4 experts, top-2): a prefill batch, the same
    with capacity factor 0.5 (every expert's capacity, a quarter of the
    tokens, is below the half of them routed to it on average, so tokens
    are dropped), and decode's one token per row."""
    cf = 0.5 if case == "capacity_binds" else 1.25
    jcfg = jax_get_config(MOE_ARCH, reduced=True).with_(
        moe_impl=impl, moe=JaxMoEConfig(n_experts=4, top_k=2, every=1,
                                        capacity_factor=cf))
    cfg = get_config(MOE_ARCH, reduced=True).with_(
        moe_impl=impl, moe=MoEConfig(n_experts=4, top_k=2, every=1,
                                     capacity_factor=cf))
    shape = (B, 1, 128) if case == "decode" else (B, 24, 128)
    x, xt = _activations(len(case), shape, dtype)
    p = _cast_jax(moe_params, dtype)
    want = jax.jit(lambda x, p: jax_blocks.moe_ffn(x, p, jcfg, NULL_RULES))(
        x, p)
    got = blocks.moe_ffn(xt, params_from_numpy(
        jax.tree.map(np.asarray, p), "cpu"), cfg)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    assert _rel_err(got, want) <= TOL[dtype], _rel_err(got, want)
    if case == "capacity_binds":   # some expert has more tokens than C
        groups = 1 if impl == "global" else B       # capacity per group
        logits = xt.float().reshape(groups, -1, 128) \
            @ torch.from_numpy(np.array(p["router"], np.float32))
        chosen = logits.topk(2, dim=-1).indices.reshape(groups, -1)
        C = int(cf * 2 * (B * shape[1] // groups) / 4)
        assert max(int(torch.bincount(g, minlength=4).max())
                   for g in chosen) > C


# -------------------------------------------------------------- mamba
@pytest.fixture(scope="module")
def jax_side():
    cfg = jax_get_config(ARCH, reduced=True)
    model = jax_build_model(cfg)
    params = jax_init_params(model.param_desc(), jax.random.PRNGKey(1))
    toks = np.random.default_rng(0).integers(4, cfg.vocab, (B, S + EXTRA)
                                             ).astype(np.int32)
    return model, params, toks


def _mamba_params(params, dtype):
    p = jax.tree.map(lambda a: a[0], params["periods"]["slot0"]["mamba"])
    p = _cast_jax(p, dtype)
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_forward_matches_jax(jax_side, dtype, with_h0):
    """Output and final state, from zeros and from a given state; the
    conv tail against JAX's `_conv_tail`."""
    _, params, _ = jax_side
    jcfg, cfg = jax_get_config(ARCH, reduced=True), get_config(ARCH,
                                                               reduced=True)
    jp, p = _mamba_params(params, dtype)
    x, xt = _activations(3, (B, 20, 128), dtype)
    h0 = np.random.default_rng(4).normal(0, 0.1, (B, 256, 8)).astype(
        np.float32) if with_h0 else None
    out_j, h_j = jax.jit(lambda x, p: jax_mamba.mamba_forward(
        x, p, jcfg, NULL_RULES, None if h0 is None else jnp.asarray(h0)))(
            x, jp)
    ssm.reset_launches()
    out, h_fin, tail = mamba.mamba_forward(
        xt, p, cfg, None if h0 is None else torch.from_numpy(h0))
    assert ssm.LAUNCHES["selective_scan"] == 0      # CPU: the plain version
    assert out.dtype == xt.dtype and h_fin.dtype == torch.float32
    assert _rel_err(out, out_j) <= TOL[dtype]
    assert _rel_err(h_fin, h_j) <= TOL[dtype]
    want_tail = jax_conv_tail(x, {"mamba": jp}, jcfg)
    assert tail.shape == want_tail.shape
    assert _rel_err(tail, want_tail) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_step_matches_jax(jax_side, dtype):
    _, params, _ = jax_side
    jcfg, cfg = jax_get_config(ARCH, reduced=True), get_config(ARCH,
                                                               reduced=True)
    jp, p = _mamba_params(params, dtype)
    x, xt = _activations(5, (B, 1, 128), dtype)
    conv, convt = _activations(6, (B, 3, 256), dtype)
    h = np.random.default_rng(7).normal(0, 0.5, (B, 256, 8)).astype(
        np.float32)
    out_j, st_j = jax.jit(lambda x, p, s: jax_mamba.mamba_decode_step(
        x, p, jcfg, NULL_RULES, s))(x, jp, {"conv": conv,
                                            "h": jnp.asarray(h)})
    state = {"conv": convt, "h": torch.from_numpy(h)}
    before = {k: v.clone() for k, v in state.items()}
    out, st = mamba.mamba_decode_step(xt, p, cfg, state)
    assert out.shape == (B, 1, 128) and out.dtype == xt.dtype
    assert _rel_err(out, out_j) <= TOL[dtype]
    for name in ("conv", "h"):
        assert st[name].shape == st_j[name].shape
        assert _rel_err(st[name], st_j[name]) <= TOL[dtype], name
        assert torch.equal(state[name], before[name])     # left as it was


# ------------------------------------------------------------ the model
def _jax_slot_chain(jmodel, params, toks, dtype):
    """JAX's slot layers of every period one by one: prefill of the
    prompt, then one decode step (K/V in float32: see the module's
    docstring). Returns, per (period, slot), the inputs, outputs and new
    caches of both."""
    cfg = jmodel.cfg
    params = _cast_jax(params, dtype)
    pos = jnp.arange(S, dtype=jnp.int32)
    cos, sin = jax_blocks.rope_cos_sin(pos, cfg.dh, cfg.rope_theta)
    dpos = jnp.asarray([S], jnp.int32)
    dcos, dsin = jax_blocks.rope_cos_sin(dpos, cfg.dh, cfg.rope_theta)
    kpos = jnp.concatenate([pos, jnp.asarray([S], jnp.int32)])
    x = jnp.take(params["embed"], jnp.asarray(toks[:, :S]), axis=0)
    xd = jnp.take(params["embed"], jnp.asarray(toks[:, S:S + 1]), axis=0)
    out = []
    for n in range(jmodel.n_periods):
        for i in range(jmodel.period):
            sp = jax.tree.map(lambda a: a[n], params["periods"][f"slot{i}"])
            y, cache = jax.jit(lambda x, sp: jmodel._slot_forward(
                x, i, sp, cos, sin, pos, NULL_RULES))(x, sp)
            if "k" in cache:            # room for the decode token, f32
                cache = {k: jnp.pad(v.astype(jnp.float32),
                                    ((0, 0), (0, 1), (0, 0), (0, 0)))
                         for k, v in cache.items()}
            yd, dcache = jax.jit(lambda x, sp, c: jmodel._slot_forward(
                x, i, sp, dcos, dsin, dpos, NULL_RULES, cache_in=c,
                slot_ctx=(jnp.int32(S), kpos)))(xd, sp, cache)
            out.append(((n, i), x, y, cache, xd, yd, dcache))
            x, xd = y, yd
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_each_slot_layer_matches_jax(jax_side, dtype):
    """Every slot layer of both periods (Mamba + SwiGLU, Mamba + MoE,
    attention + MoE) given JAX's own input, at prefill and at one decode
    step from JAX's cache: the layer's output and its new cache."""
    jmodel, params, toks = jax_side
    model = HybridModel(get_config(ARCH, reduced=True))
    tparams = params_from_numpy(jax.tree.map(np.asarray,
                                             _cast_jax(params, dtype)), "cpu")
    tdtype = getattr(torch, dtype)
    cfg = model.cfg
    pos = torch.arange(S + 1, dtype=torch.int32)
    cos, sin = blocks.rope_cos_sin(pos[:S], cfg.dh, cfg.rope_theta)
    dcos, dsin = blocks.rope_cos_sin(pos[S:], cfg.dh, cfg.rope_theta)

    def t(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdtype)

    for (n, i), x, y, cache, xd, yd, dcache in _jax_slot_chain(
            jmodel, params, toks, dtype):
        lp = tree_map(lambda w: w[n], tparams["periods"][f"slot{i}"])
        got, st = model._slot(t(x), lp, cos, sin,
                              lambda k, v: (k, v, pos[:S], pos[:S]), None)
        assert _rel_err(got, y) <= TOL[dtype], ((n, i), "prefill")
        tcache = params_from_numpy(jax.tree.map(np.asarray, cache), "cpu")

        def kv_fn(k, v):
            tcache["k"][:, S] = k[:, 0].to(tcache["k"].dtype)
            tcache["v"][:, S] = v[:, 0].to(tcache["v"].dtype)
            return tcache["k"], tcache["v"], pos[S:], pos
        got_d, st_d = model._slot(t(xd), lp, dcos, dsin, kv_fn,
                                  None if "k" in cache else tcache)
        assert _rel_err(got_d, yd) <= TOL[dtype], ((n, i), "decode")
        for name, want in (cache.items() if st is not None else ()):
            assert _rel_err(st[name], want) <= TOL[dtype], ((n, i), name)
        for name, want in dcache.items():
            have = st_d[name] if st_d is not None else tcache[name]
            assert _rel_err(have, want) <= TOL[dtype], ((n, i), name)


def _run_jax(model, params, toks):
    logits, cache = jax.jit(lambda p, b: model.prefill(
        p, b, NULL_RULES, pad_to=S + EXTRA))(
            params, {"tokens": jnp.asarray(toks[:, :S])})
    steps = [(np.asarray(logits), jax.tree.map(np.asarray, cache))]
    attn = cache["slots"][f"slot{model.period - 1}"]
    for key in ("k", "v"):
        attn[key] = attn[key].astype(jnp.float32)
    dec = jax.jit(lambda p, c, b: model.decode_step(p, c, b, NULL_RULES))
    for t in range(EXTRA):
        logits, cache = dec(params, cache,
                            {"tokens": jnp.asarray(toks[:, S + t:S + t + 1])})
        steps.append((np.asarray(logits), jax.tree.map(np.asarray, cache)))
    return steps


def _port_decode(model, params, cache, toks):
    steps = []
    for t in range(EXTRA):
        logits, cache = model.decode_step(
            params, cache,
            {"tokens": torch.from_numpy(toks[:, S + t:S + t + 1])})
        steps.append((logits, tree_map(torch.clone, cache)))
    return steps


def _check_cache(got, want, tol, what):
    assert np.array_equal(got["kpos"].numpy(), want["kpos"]), what
    assert int(got["pos"]) == int(want["pos"]), what
    assert sorted(got["slots"]) == sorted(want["slots"]), what
    for slot, entries in want["slots"].items():
        assert sorted(got["slots"][slot]) == sorted(entries), (what, slot)
        for name, w in entries.items():
            g = got["slots"][slot][name]
            assert g.shape == w.shape, (what, slot, name)
            assert str(g.dtype).removeprefix("torch.") == w.dtype.name, \
                (what, slot, name)
            bound = tol + (BF16_ULP if w.dtype.name == "bfloat16" else 0)
            assert _rel_err(g, w) <= bound, (what, slot, name)


def test_prefill_and_decode_match_jax(jax_side):
    """float32, the reduced model's 8 layers: prefill's logits and every
    cached state; then three decode steps from JAX's prefill cache, on
    both sides, with every cached state after each."""
    jmodel, jparams, toks = jax_side
    jparams = _cast_jax(jparams, "float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    model = build_model(get_config(ARCH, reduced=True))
    assert isinstance(model, HybridModel)
    want = _run_jax(jmodel, jparams, toks)
    ssm.reset_launches()
    ta.reset_launches()
    logits, cache = model.prefill(
        params, {"tokens": torch.from_numpy(toks[:, :S])}, pad_to=S + EXTRA)
    tol = TOL["float32"]
    lj, cj = want[0]
    assert logits.dtype == torch.float32 and logits.shape == lj.shape
    assert _rel_err(logits, lj) <= tol
    _check_cache(cache, cj, tol, "prefill")
    carried = params_from_numpy(cj, "cpu")
    carried["pos"] = torch.tensor(int(cj["pos"]), dtype=torch.int32)
    attn = carried["slots"][f"slot{model.period - 1}"]
    for key in ("k", "v"):
        attn[key] = attn[key].float()
    for step, ((lt, ct), (lj, cj)) in enumerate(
            zip(_port_decode(model, params, carried, toks), want[1:]), 1):
        assert _rel_err(lt, lj) <= tol, step
        _check_cache(ct, cj, tol, f"decode {step}")
    assert ssm.LAUNCHES["selective_scan"] == 0      # CPU: the plain version
    assert ta.LAUNCHES["flash_attention"] == 0


def test_prefill_then_decode_matches_a_longer_prefill(jax_side):
    """The port's own consistency, float32, as tests/test_models_smoke.py
    checks the JAX package's: three decode steps after prefill give the
    logits and Mamba states of one prefill over the whole sequence. As
    there, the MoE runs drop-free (capacity factor E / top_k): with the
    published 1.25 a decode step of B tokens has capacity 1 per expert and
    drops tokens that a long prefill keeps. The prompt's K/V pass through
    the bf16 cache at decode but not within the long prefill, hence 2e-3
    of the scale for the logits and the Mamba states (measured at most
    6.3e-4)."""
    _, jparams, toks = jax_side
    params = params_from_numpy(
        jax.tree.map(np.asarray, _cast_jax(jparams, "float32")), "cpu")
    cfg = get_config(ARCH, reduced=True)
    moe = cfg.moe
    model = build_model(cfg.with_(moe=MoEConfig(
        moe.n_experts, moe.top_k, moe.every,
        capacity_factor=moe.n_experts / moe.top_k)))
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :S])},
                             pad_to=S + EXTRA)
    logits, cache = _port_decode(model, params, cache, toks)[-1]
    full, full_cache = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    assert int(full_cache["pos"]) == int(cache["pos"]) == S + EXTRA
    assert torch.equal(full_cache["kpos"], cache["kpos"])
    errs = {"logits": float((logits - full).abs().max())
            / float(full.abs().max())}
    for slot, entries in full_cache["slots"].items():
        for name, want in entries.items():
            if name in ("conv", "h"):
                errs[slot, name] = float(
                    (cache["slots"][slot][name] - want).abs().max()) \
                    / float(want.abs().max())
    assert max(errs.values()) <= 2e-3, errs


def test_decode_writes_kv_in_place_and_keeps_the_mamba_states(jax_side):
    _, jparams, toks = jax_side
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    model = build_model(get_config(ARCH, reduced=True))
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :S])},
                             pad_to=S + 1)
    before = tree_map(torch.clone, cache)
    _, new = model.decode_step(params, cache,
                               {"tokens": torch.from_numpy(toks[:, S:S + 1])})
    attn = "slot3"
    assert new["slots"][attn]["k"] is cache["slots"][attn]["k"]
    assert cache["slots"][attn]["k"][:, :, S].any()        # written in place
    assert not before["slots"][attn]["k"][:, :, S].any()
    for slot in ("slot0", "slot1", "slot2"):
        for name in ("conv", "h"):
            assert torch.equal(cache["slots"][slot][name],
                               before["slots"][slot][name])
            assert not torch.equal(new["slots"][slot][name],
                                   before["slots"][slot][name])
    assert int(cache["pos"]) == S and int(new["pos"]) == S + 1
    assert new["kpos"].tolist() == list(range(S + 1))


def test_params_from_numpy_carries_the_hybrid_tree_exactly(jax_side):
    """The stacked `periods/slot{i}` tree, bf16 leaves and the float32
    ones (A_log, D, the router, and a float32 cast of the whole tree)
    carried bit for bit; the counts agree. The configuration's own
    `param_count()` leaves out each Mamba layer's conv bias (d_inner), as
    the JAX package's does (ROADMAP queue 3)."""
    _, jparams, _ = jax_side
    for tree in (jparams, _cast_jax(jparams, "float32")):
        arrays = jax.tree.map(np.asarray, tree)
        params = params_from_numpy(arrays, "cpu")
        flat_j = jax.tree_util.tree_leaves_with_path(arrays)
        assert len(flat_j) == len(jax.tree.leaves(params))
        for path, arr in flat_j:
            t = params
            for key in path:
                t = t[key.key]
            assert t.shape == arr.shape
            assert str(t.dtype).removeprefix("torch.") == arr.dtype.name
            bits = np.int16 if arr.dtype.name == "bfloat16" else np.int32
            assert np.array_equal(
                t.view(torch.int16 if bits is np.int16 else torch.int32)
                .numpy(), arr.view(bits))
    cfg = get_config(ARCH, reduced=True)
    model = build_model(cfg)
    slot1 = params["periods"]["slot1"]
    assert slot1["moe"]["w_in"].shape == (2, 4, 128, 256)
    assert slot1["mamba"]["A_log"].dtype == torch.float32
    assert param_count(params) == param_count(model.param_desc()) \
        == jax_param_count(jparams)
    n_mamba = cfg.n_layers - cfg.n_layers // cfg.attn_every
    assert cfg.param_count() == param_count(params) \
        - n_mamba * cfg.mamba.d_inner(cfg.d_model)


def test_init_params_and_cache_follow_the_jax_desc(jax_side):
    _, jparams, _ = jax_side
    model = build_model(get_config(ARCH, reduced=True))
    params = init_params(model.param_desc(), torch.Generator().manual_seed(0),
                         "cpu")
    assert jax.tree.structure(jax.tree.map(lambda _: 0, jparams)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, params))
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(params)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(b.dtype).removeprefix("torch.") == a.dtype.name
    jcache = jax_build_model(jax_get_config(ARCH, reduced=True)).cache_desc(
        3, 9)
    cache = init_params(model.cache_desc(3, 9), torch.Generator(), "cpu")
    for a, b in zip(jax.tree.leaves(jcache), jax.tree.leaves(cache)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(b.dtype).removeprefix("torch.") == np.dtype(a.dtype).name
    assert cache["kpos"].tolist() == [-1] * 9


def test_hybrid_builds_and_its_training_loss_raises():
    model = build_model(get_config(ARCH, reduced=True))
    assert isinstance(model, HybridModel)
    params = init_params(model.param_desc(), torch.Generator().manual_seed(0),
                         "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab, (2, 9)).astype(np.int32))
    loss = model.loss_fn(params, {"tokens": toks[:, :-1],
                                  "labels": toks[:, 1:]})
    assert loss.shape == () and loss.dtype == torch.float32
    assert torch.isfinite(loss)
    with pytest.raises(ValueError, match="multiple of the period"):
        HybridModel(get_config(ARCH, reduced=True).with_(n_layers=6))


def test_serve_decode_cli_runs_jamba_without_jax():
    """`python -m repro_torch.launch.serve --mode decode --arch
    jamba-v0.1-52b --device cpu` with JAX, the JAX package and ml_dtypes
    out of reach."""
    script = ("import sys, runpy\n"
              "for m in ('jax', 'jaxlib', 'repro', 'ml_dtypes'):\n"
              "    sys.modules[m] = None\n"
              "sys.argv = ['serve', '--mode', 'decode', '--arch', "
              "'jamba-v0.1-52b', '--device', 'cpu', '--tokens', '4']\n"
              "runpy.run_module('repro_torch.launch.serve', "
              "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "jamba-v0.1-52b (reduced) on cpu" in proc.stdout
    tokens = ast.literal_eval(
        proc.stdout.split("greedy tokens:")[1].strip())
    assert len(tokens) == 4 and all(len(t) == 4 for t in tokens)
