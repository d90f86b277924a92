"""The port's RWKV-6 (`repro_torch.kernels.rwkv`, `repro_torch.models.
rwkv6`, `rwkv_model`) against the JAX package's, on the CPU.

Inputs come from a numpy seed and go through both packages in one
process. On the CPU the port's `ops.wkv` takes the plain PyTorch version
(`wkv_ref`) of the CUDA kernel; the kernel itself is held against that
on a card (`tests/test_torch_cuda.py`, `chip_smoke.py`).

Tolerances:
- wkv against JAX's `wkv_ref` and against `wkv_pallas` (interpret mode):
  rtol = atol = 1e-4, the JAX package's own for its kernel
  (`tests/test_kernels.py`); against JAX's `wkv_chunked` 2e-4, the JAX
  package's own for the chunked form.
- `rwkv6-3b` REDUCED (2 layers, d_model 128, 4 heads of 32) with the JAX
  weights carried across by `params_from_numpy`, prefill then three
  decode steps, as a fraction of the largest |value|:
  - float32: 2e-5 for logits and every cached state. Measured here: at
    most 1.4e-6 (logits) and 1.2e-6 (states), float32 roundings of sums
    taken in another order (JAX's model sums the recurrence in chunks).
  - bfloat16: 3e-2. Measured: up to 1.9e-2 for logits and 1.6e-2 for
    states; a few bf16 roundings (2^-8 each) of the activations, which the
    two frameworks take at different places, through two layers.
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
from repro.kernels.rwkv import wkv_pallas
from repro.kernels.rwkv import wkv_ref as jax_wkv_ref
from repro.models import NULL_RULES
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.models import param_count as jax_param_count
from repro.models.rwkv6 import wkv_chunked
from repro_torch.configs import get_config
from repro_torch.kernels import rwkv as tr
from repro_torch.kernels.rwkv import cases as bwd
from repro_torch.kernels.rwkv import ops as wkv_ops
from repro_torch.models import (RWKVModel, build_model, init_params,
                                param_count, params_from_numpy)

REPO = Path(__file__).resolve().parents[1]
ARCH = "rwkv6-3b"
S, EXTRA, B = 32, 3, 2
MODEL_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
STATES = ("shift_t", "shift_c", "S")


def _wkv_inputs(seed, B_, S_, H, dh, w_hi=0.999):
    """r, k, v, w, u, s0 as float32 numpy, the JAX tests' distributions."""
    rng = np.random.default_rng(seed)
    return tuple(a.astype(np.float32) for a in (
        rng.normal(0, 1, (B_, S_, H, dh)),
        rng.normal(0, 0.3, (B_, S_, H, dh)),
        rng.normal(0, 1, (B_, S_, H, dh)),
        rng.uniform(0.5, w_hi, (B_, S_, H, dh)),
        rng.normal(0, 0.3, (H, dh)),
        rng.normal(0, 0.1, (B_, H, dh, dh))))


def _model_decays(inputs, seed):
    """The same inputs with the model's kind of decay, exp(-exp(N(0, 1))),
    key 0 held at exactly 1 and key 1 at exactly 0 on every step."""
    r, k, v, w, u, s0 = inputs
    w = np.exp(-np.exp(np.random.default_rng(seed).normal(0, 1, w.shape))
               ).astype(np.float32)
    w[..., 0], w[..., 1] = 1.0, 0.0
    return r, k, v, w, u, s0


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# ---------------------------------------------------------------- wkv
@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("B_,S_,H,dh", [(1, 128, 2, 32), (2, 37, 3, 64),
                                        (1, 64, 1, 128), (2, 1, 2, 32)])
def test_wkv_matches_jax_wkv_ref(B_, S_, H, dh, with_s0):
    r, k, v, w, u, s0 = _wkv_inputs(B_ + S_ + dh, B_, S_, H, dh)
    s0 = s0 if with_s0 else None
    want_out, want_s = jax_wkv_ref(*map(jnp.asarray, (r, k, v, w, u)),
                                   None if s0 is None else jnp.asarray(s0))
    tr.reset_launches()
    for out, s_fin in (tr.wkv_ref(*_t(r, k, v, w, u),
                                  None if s0 is None else _t(s0)[0]),
                       tr.wkv(r, k, v, w, u, s0, device="cpu")):
        assert out.dtype == s_fin.dtype == torch.float32
        assert out.shape == (B_, S_, H, dh) and s_fin.shape == (B_, H, dh, dh)
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(s_fin.numpy(), np.asarray(want_s),
                                   rtol=1e-4, atol=1e-4)
    assert tr.LAUNCHES["wkv"] == 0                  # CPU: the plain version


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("S_,dh", [(1, 64), (1, 128), (15, 32), (16, 64),
                                   (17, 128), (33, 64)])
def test_wkv_matches_jax_at_model_decays(S_, dh, with_s0):
    """The model's decays, with keys held at w = 0 and w = 1, at S = 1 and
    on either side of the prefill kernel's chunk (15, 16, 17, 33): the
    cases `chip_smoke.py`'s `wkv_edge` holds the kernels to on the card."""
    assert tr.kernel.CHUNK == 16
    r, k, v, w, u, s0 = _model_decays(
        _wkv_inputs(S_ + dh, 2, S_, 3, dh), S_ * dh)
    s0 = s0 if with_s0 else None
    want_out, want_s = jax_wkv_ref(*map(jnp.asarray, (r, k, v, w, u)),
                                   None if s0 is None else jnp.asarray(s0))
    out, s_fin = tr.wkv(r, k, v, w, u, s0, device="cpu")
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(want_s), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("BH", [1, 160, 2**20])
@pytest.mark.parametrize("S_", [1, 2, 37, 2000])
@pytest.mark.parametrize("dh", tr.HEAD_DIMS)
def test_plan_fits_the_card(dh, S_, BH):
    """`plan` (which decides every launch; the library refuses any other)
    gives a launch the card takes: a 1D grid in range, at most 1024
    threads and 232,448 bytes of shared memory a block, column tiles that
    divide dh, and the decode kernel exactly at S = 1."""
    for B_, H in ((1, BH), (BH, 1)):
        for dtype in (torch.bfloat16, torch.float32):
            p = tr.plan(B_, S_, H, dh, dtype)
            assert p.kernel == ("decode" if S_ == 1 else "prefill")
            assert p.blocks == B_ * H * (dh // p.cols)
            assert 1 <= p.blocks <= 2**31 - 1
            assert 32 <= p.threads <= 1024 and p.threads % 32 == 0
            assert 0 < p.smem_bytes <= 232_448      # a block's most
            assert dh % p.cols == 0
            assert p.chunk == (1 if S_ == 1 else tr.kernel.CHUNK)
    with pytest.raises(ValueError, match="head size 16 not built"):
        tr.plan(1, S_, BH, 16)


@pytest.mark.parametrize("B_,S_,H,dh", [(1, 128, 2, 32), (2, 256, 3, 64),
                                        (1, 64, 1, 128)])
def test_wkv_matches_pallas_interpret(B_, S_, H, dh):
    """The cases of the JAX package's `test_wkv_vs_ref`; the Pallas
    kernel starts from zeros and returns no state."""
    r, k, v, w, u, _ = _wkv_inputs(B_ + S_, B_, S_, H, dh)
    want = wkv_pallas(*map(jnp.asarray, (r, k, v, w, u)), interpret=True)
    out, _ = tr.wkv(r, k, v, w, u, device="cpu")
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("B_,S_,H,dh,chunk", [(2, 96, 2, 16, 32),
                                              (1, 64, 2, 32, 16)])
def test_wkv_matches_jax_wkv_chunked(B_, S_, H, dh, chunk):
    r, k, v, w, u, s0 = _wkv_inputs(7 + S_, B_, S_, H, dh, w_hi=0.99)
    want_out, want_s = wkv_chunked(*map(jnp.asarray, (r, k, v)),
                                   jnp.log(jnp.asarray(w)), jnp.asarray(u),
                                   jnp.asarray(s0), chunk=chunk)
    out, s_fin = tr.wkv(r, k, v, w, u, s0, device="cpu")
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(want_s), rtol=2e-4,
                               atol=2e-4)


def test_wkv_bf16_rkv_computes_in_float32():
    """bf16 r/k/v are read as their float32 values, as JAX's ref does."""
    r, k, v, w, u, s0 = _wkv_inputs(3, 2, 20, 2, 32)
    rb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (r, k, v))
    want_out, want_s = jax_wkv_ref(
        *(jnp.asarray(x.float().numpy()) for x in (rb, kb, vb)),
        jnp.asarray(w), jnp.asarray(u), jnp.asarray(s0))
    out, s_fin = tr.wkv(rb, kb, vb, w, u, s0, device="cpu")
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(want_s), rtol=1e-4,
                               atol=1e-4)


def test_wkv_refuses_what_the_kernel_refuses():
    r, k, v, w, u, s0 = _t(*_wkv_inputs(0, 1, 4, 2, 32))
    with pytest.raises(TypeError, match="w must be float32"):
        tr.wkv(r, k, v, w.bfloat16(), u, device="cpu")
    with pytest.raises(TypeError, match="s0 must be float32"):
        tr.wkv(r, k, v, w, u, s0.double(), device="cpu")
    with pytest.raises(ValueError, match="impl"):
        tr.wkv(r, k, v, w, u, impl="pallas", device="cpu")


def test_wkv_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r, k, v, w, u, _ = _wkv_inputs(0, 1, 4, 2, 32)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tr.wkv(r, k, v, w, u)


# -------------------------------------------------------------- model
@pytest.fixture(scope="module")
def jax_side():
    cfg = jax_get_config(ARCH, reduced=True)
    model = jax_build_model(cfg)
    params = jax_init_params(model.param_desc(), jax.random.PRNGKey(1))
    toks = np.random.default_rng(0).integers(4, cfg.vocab, (B, S + EXTRA)
                                             ).astype(np.int32)
    return model, params, toks


def _cast_jax(params, dtype):
    return params if dtype == "bfloat16" else jax.tree.map(
        lambda x: x.astype(jnp.float32), params)


def _run_jax(model, params, toks):
    logits, cache = jax.jit(lambda p, b: model.prefill(p, b, NULL_RULES))(
        params, {"tokens": jnp.asarray(toks[:, :S])})
    steps = [(np.asarray(logits), jax.tree.map(np.asarray, cache))]
    dec = jax.jit(lambda p, c, b: model.decode_step(p, c, b, NULL_RULES))
    for t in range(EXTRA):
        logits, cache = dec(params, cache,
                            {"tokens": jnp.asarray(toks[:, S + t:S + t + 1])})
        steps.append((np.asarray(logits), jax.tree.map(np.asarray, cache)))
    return steps


def _run_port(model, params, toks):
    logits, cache = model.prefill(params,
                                  {"tokens": torch.from_numpy(toks[:, :S])})
    steps = [(logits, cache)]
    for t in range(EXTRA):
        logits, cache = model.decode_step(
            params, cache, {"tokens": torch.from_numpy(toks[:, S + t:S + t + 1])})
        steps.append((logits, cache))
    return steps


def _rel_err(got: torch.Tensor, want: np.ndarray) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(jax_side, dtype):
    """Logits and every cached state (shift_t, shift_c, S) after prefill
    and after each of three decode steps."""
    jmodel, jparams, toks = jax_side
    jparams = _cast_jax(jparams, dtype)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    model = build_model(get_config(ARCH, reduced=True))
    assert isinstance(model, RWKVModel)
    tr.reset_launches()
    want, got = _run_jax(jmodel, jparams, toks), _run_port(model, params,
                                                            toks)
    assert tr.LAUNCHES["wkv"] == 0                  # CPU: the plain version
    tol = MODEL_TOL[dtype]
    for step, ((lj, cj), (lt, ct)) in enumerate(zip(want, got)):
        assert lt.dtype == torch.float32 and lt.shape == lj.shape
        err = float(np.abs(lt.numpy() - lj).max())
        assert err <= tol * max(float(np.abs(lj).max()), 1.0), (step, err)
        assert int(ct["pos"]) == int(cj["pos"]) == S + step
        for name in STATES:
            got_s, want_s = ct["states"][name], cj["states"][name]
            assert got_s.shape == want_s.shape, name
            assert str(got_s.dtype).removeprefix("torch.") \
                == want_s.dtype.name, name
            assert _rel_err(got_s, want_s) <= tol, (dtype, step, name)


def test_prefill_then_decode_matches_a_longer_prefill(jax_side):
    """The port's own consistency, as tests/test_models_smoke.py checks
    the JAX package's: three decode steps after prefill give the logits
    of a prefill over the whole sequence."""
    _, jparams, toks = jax_side
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    model = build_model(get_config(ARCH, reduced=True))
    logits, cache = _run_port(model, params, toks)[-1]
    full, full_cache = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    assert int(full_cache["pos"]) == int(cache["pos"]) == S + EXTRA
    err = float((logits - full).abs().max())
    scale = float(full.abs().max())
    assert err < 0.25 * max(scale, 1.0), (err, scale)


def test_prefill_then_decode_matches_a_longer_prefill_in_float32(jax_side):
    """In float32 the recurrent state carries over exactly enough that
    decode after prefill and one long prefill agree to float32 roundings,
    logits and state alike."""
    _, jparams, toks = jax_side
    params = params_from_numpy(
        jax.tree.map(np.asarray, _cast_jax(jparams, "float32")), "cpu")
    model = build_model(get_config(ARCH, reduced=True))
    logits, cache = _run_port(model, params, toks)[-1]
    full, full_cache = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    assert float((logits - full).abs().max()) <= 1e-5 * float(
        full.abs().max())
    for name in STATES:
        want = full_cache["states"][name]
        assert float((cache["states"][name] - want).abs().max()) <= \
            1e-5 * float(want.abs().max()), name


def test_decode_leaves_the_given_cache_unchanged(jax_side):
    _, jparams, toks = jax_side
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    model = build_model(get_config(ARCH, reduced=True))
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :S])})
    before = {k: v.clone() for k, v in cache["states"].items()}
    _, new = model.decode_step(params, cache,
                               {"tokens": torch.from_numpy(toks[:, S:S + 1])})
    for name in STATES:
        assert torch.equal(cache["states"][name], before[name])
        assert not torch.equal(new["states"][name], before[name])
    assert int(cache["pos"]) == S and int(new["pos"]) == S + 1


def test_params_from_numpy_carries_the_rwkv_tree_exactly(jax_side):
    """Stacked `layers`, bf16 leaves and the float32 ones (a float32
    cast of the same tree) carried bit for bit; the counts agree."""
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
    model = build_model(get_config(ARCH, reduced=True))
    assert params["layers"]["wr"].shape == (2, 128, 128)
    assert param_count(params) == param_count(model.param_desc()) \
        == jax_param_count(jparams)


def test_init_params_follows_the_jax_init_rules(jax_side):
    """Tree, shapes and dtypes equal the JAX package's; "scaled" draws
    normal × scale (w0 and u: 0.5), "normal" normal / sqrt(fan-in)."""
    _, jparams, _ = jax_side
    model = build_model(get_config(ARCH, reduced=True))
    params = init_params(model.param_desc(), torch.Generator().manual_seed(0),
                         "cpu")
    assert jax.tree.structure(jax.tree.map(lambda _: 0, jparams)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, params))
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(params)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(b.dtype).removeprefix("torch.") == a.dtype.name
    layers = params["layers"]
    for name in ("w0", "u"):       # 256 draws each: the std's own spread
        for std in (float(layers[name].float().std()),     # is about 0.022
                    float(np.asarray(jparams["layers"][name], np.float32)
                          .std())):
            assert abs(std - 0.5) < 0.1, (name, std)
    wr = layers["wr"].float()                         # fan-in d_model = 128
    assert abs(float(wr.std()) * np.sqrt(128) - 1.0) < 0.05
    assert torch.equal(layers["ln1_w"], torch.ones_like(layers["ln1_w"]))
    assert not layers["mu_rkvgw"].any()
    cache = init_params(model.cache_desc(3, 999), torch.Generator(), "cpu")
    assert cache["states"]["S"].shape == (2, 3, 4, 32, 32)
    assert cache["states"]["S"].dtype == torch.float32
    assert cache["states"]["shift_t"].shape == (2, 3, 128)
    assert not cache["states"]["S"].any() and int(cache["pos"]) == 0


def test_init_refuses_an_unknown_rule():
    from repro_torch.models import Desc
    with pytest.raises(ValueError, match="unknown init"):
        init_params({"x": Desc((2,), init="uniform")}, torch.Generator(),
                    "cpu")


def test_serve_decode_cli_runs_rwkv_without_jax():
    """`python -m repro_torch.launch.serve --mode decode --arch rwkv6-3b
    --device cpu` with JAX, the JAX package and ml_dtypes out of reach."""
    script = ("import sys, runpy\n"
              "for m in ('jax', 'jaxlib', 'repro', 'ml_dtypes'):\n"
              "    sys.modules[m] = None\n"
              "sys.argv = ['serve', '--mode', 'decode', '--arch', 'rwkv6-3b',"
              " '--device', 'cpu', '--tokens', '4']\n"
              "runpy.run_module('repro_torch.launch.serve', "
              "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "rwkv6-3b (reduced) on cpu" in proc.stdout
    assert "decoded 4 tokens × batch 4" in proc.stdout
    tokens = ast.literal_eval(
        proc.stdout.split("greedy tokens:")[1].strip())
    assert len(tokens) == 4 and all(len(t) == 4 for t in tokens)


# ------------------------------------------------------- the backward
BWD_CASES = bwd.bwd_cases()


def _bwd_tol(g: torch.Tensor) -> float:
    return bwd.BWD_TOL["bfloat16" if g.dtype == torch.bfloat16
                       else "float32"]


def _jax(x):
    if x is None:
        return None
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_wkv_bwd_ref_matches_jax_vjp(case):
    """`wkv_bwd_ref` against `jax.vjp` of the JAX package's sequential
    `wkv_ref` (`repro/kernels/rwkv/ref.py`) on every backward edge case:
    each gradient within 1e-4 of its scale (float32 sums in other
    orders), a bf16 gradient (dr, dk, dv of bf16 r, k, v) one rounding
    more."""
    r, k, v, w, u, s0, dout, ds_fin = bwd.bwd_inputs(case, 3, "cpu")
    args = [_jax(x) for x in (r, k, v, w, u, s0)]
    n = 6 if s0 is not None else 5
    (out, s_fin), vjp = jax.vjp(lambda *a: jax_wkv_ref(*a), *args[:n])
    want = vjp((_jax(dout), jnp.zeros_like(s_fin) if ds_fin is None
                else _jax(ds_fin)))
    got = tr.wkv_bwd_ref(r, k, v, w, u, s0, dout, ds_fin)
    assert (got[5] is None) == (s0 is None)
    for name, g, jw in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert g.dtype == (r.dtype if name in ("dr", "dk", "dv")
                           else torch.float32), name
        assert _rel_err(g, np.asarray(jw, np.float32)) <= _bwd_tol(g), name


@pytest.mark.parametrize("case", BWD_CASES[:16] + BWD_CASES[24:28],
                         ids=[c[0] for c in BWD_CASES[:16] + BWD_CASES[24:28]])
def test_wkv_bwd_ref_matches_autograd_of_the_plain_forward(case):
    """The explicit reverse loop against autograd through `wkv_ref` (the
    CPU path of `ops.wkv`), within the same tolerances."""
    r, k, v, w, u, s0, dout, ds_fin = bwd.bwd_inputs(case, 4, "cpu")
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u)
              ] + ([] if s0 is None else [s0.clone().requires_grad_()])
    out, s_fin = wkv_ops.wkv(*leaves, device="cpu") if s0 is not None \
        else wkv_ops.wkv(*leaves, None, device="cpu")
    loss = (out * dout).sum() + (0 if ds_fin is None
                                 else (s_fin * ds_fin).sum())
    want = torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)   # S = 1: w unused
    got = tr.wkv_bwd_ref(r, k, v, w, u, s0, dout, ds_fin)
    for name, g, a in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert g.dtype == a.dtype and g.shape == a.shape, name
        assert _rel_err(g, a.float().numpy()) <= _bwd_tol(g), name


@pytest.mark.parametrize("outputs", ["both", "out", "state"])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv_function_with_the_plain_halves_equals_autograd(
        monkeypatch, with_s0, outputs):
    """`ops._WKV` run on the CPU with the plain forward and backward
    swapped in for the kernels: its gradients (saved tensors, the
    backward's inputs, None for an unused output and for a missing s0)
    equal autograd through `wkv_ref` within 1e-5 of their scale."""
    monkeypatch.setattr(wkv_ops, "wkv_cuda", tr.wkv_ref)
    monkeypatch.setattr(wkv_ops, "wkv_bwd_cuda", tr.wkv_bwd_ref)
    case = ("fn", (2, 19, 2, 32), "float32", with_s0, "model")
    r, k, v, w, u, s0, dout, ds_fin = bwd.bwd_inputs(case, 5, "cpu")
    ds_fin = torch.randn(2, 2, 32, 32, generator=torch.Generator()
                         .manual_seed(6))

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u)]
        init = None if s0 is None else s0.clone().requires_grad_()
        out, s_fin = fn(*leaves, init)
        loss = 0
        if outputs in ("both", "out"):
            loss = loss + (out * dout).sum()
        if outputs in ("both", "state"):
            loss = loss + (s_fin * ds_fin).sum()
        return torch.autograd.grad(loss, leaves + ([] if init is None
                                                   else [init]),
                                   allow_unused=True, materialize_grads=True)

    got = grads(wkv_ops._WKV.apply)
    want = grads(tr.wkv_ref)
    assert len(got) == len(want) == 5 + with_s0
    for g, a in zip(got, want):
        assert _rel_err(g, a.numpy()) <= 1e-5


def _step_matrices(r, k, v, w, s0, dout, ds_fin, chunk):
    """The state before each chunk and the gradient after each chunk's
    last step, (B, H, C, dh, dh), by the step-by-step recurrences of
    `wkv_bwd_ref`."""
    B, S, H, dh = r.shape
    rf, kf, vf, wf, df = (x.float() for x in (r, k, v, w, dout))
    zeros = torch.zeros((B, H, dh, dh))
    s = zeros if s0 is None else s0.float()
    g = zeros if ds_fin is None else ds_fin.float()
    states, grads = [], [None] * (-(-S // chunk))
    for t in range(S):
        if t % chunk == 0:
            states.append(s)
        s = wf[:, t, ..., None] * s + kf[:, t, ..., None] * vf[:, t, :,
                                                                None, :]
    for t in reversed(range(S)):
        if t % chunk == chunk - 1 or t == S - 1:
            grads[t // chunk] = g
        g = wf[:, t, ..., None] * g + rf[:, t, ..., None] * df[:, t, :,
                                                                None, :]
    return torch.stack(states, 2), torch.stack(grads, 2), g


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_wkv_chunk_matrices_ref_match_the_step_recurrences(case):
    """The backward's states pass in plain PyTorch (`wkv_chunk_matrices_
    ref`: chunked products of w, as the kernel's TF32 passes form them)
    against the step-by-step recurrences on every backward edge case:
    S_c, G_c and ds0 within 1e-4 of their scale (float32 sums in another
    order)."""
    r, k, v, w, u, s0, dout, ds_fin = bwd.bwd_inputs(case, 7, "cpu")
    got = tr.wkv_chunk_matrices_ref(r, k, v, w, s0, dout, ds_fin,
                                    bwd.BWD_CHUNK)
    want = _step_matrices(r, k, v, w, s0, dout, ds_fin, bwd.BWD_CHUNK)
    for name, g, a in zip(("S_c", "G_c", "ds0"), got, want):
        assert g.shape == a.shape, name
        assert _rel_err(g, a.numpy()) <= bwd.BWD_TOL["float32"], name


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_wkv_bwd_chunks_ref_matches_the_step_backward(case):
    """The backward's chunk pass in plain PyTorch (`wkv_bwd_chunks_ref`:
    every chunk at once from S_c and G_c) against the step-by-step
    `wkv_bwd_ref` on every backward edge case, within the same
    tolerances; ds0 is the states pass's last gradient."""
    r, k, v, w, u, s0, dout, ds_fin = bwd.bwd_inputs(case, 8, "cpu")
    smat, gmat, ds0 = tr.wkv_chunk_matrices_ref(r, k, v, w, s0, dout,
                                                ds_fin, bwd.BWD_CHUNK)
    got = tr.wkv_bwd_chunks_ref(r, k, v, w, u, dout, smat, gmat,
                                bwd.BWD_CHUNK) + (
        None if s0 is None else ds0,)
    want = tr.wkv_bwd_ref(r, k, v, w, u, s0, dout, ds_fin)
    for name, g, a in zip(bwd.GRADS, got, want):
        assert (g is None) == (a is None), name
        if g is None:
            continue
        assert g.dtype == a.dtype and g.shape == a.shape, name
        assert _rel_err(g, a.float().numpy()) <= _bwd_tol(g), name


def test_wkv_bwd_plan_and_refusals():
    """`plan_bwd`: the states pass a block a (direction, b, h, 32
    columns), a warp per 16 columns and half the keys; the chunk pass a
    block of 256 threads a (b, h, chunk, tile of 64 keys), two an SM; the
    shared memory
    and scratch the library checks; the wrapper refuses CPU tensors and
    a dout of the wrong shape, before any library is loaded."""
    from repro_torch.kernels.rwkv import kernel as rk
    p = rk.plan_bwd(2, 4096, 40, 64)
    assert (p.state_cols, p.state_blocks, p.state_threads) == (32, 320, 128)
    assert (p.key_tiles, p.blocks, p.threads) == (1, 80 * 256, 256)
    assert p.chunks == 256 and p.smem_bytes <= 113 * 1024   # two an SM
    assert p.state_smem <= 227 * 1024
    assert p.scratch_floats == 2 * 80 * 256 * 64 * 64 + 80 * 256 * 64
    p = rk.plan_bwd(1, 1, 1, 128)
    assert (p.state_blocks, p.state_threads, p.key_tiles, p.blocks,
            p.threads) == (8, 128, 2, 2, 256)
    big = rk.plan_bwd(1, 1, 1, 128, torch.float32)
    assert big.smem_bytes <= 227 * 1024 and big.state_smem <= 227 * 1024
    assert big.scratch_floats == 2 * 128 * 128 + 128 + 2 * 128
    assert rk.plan_bwd(1, 17, 1, 32)[4:7] == (1, 2, 256)
    assert rk.plan_bwd(1, 17, 1, 32).chunks == 2
    r, k, v, w, u, s0, dout, _ = bwd.bwd_inputs(BWD_CASES[0], 0, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        rk.wkv_bwd_cuda(r, k, v, w, u, s0, dout)
    rk.reset_launches()
    assert rk.LAUNCHES == {"wkv": 0, "wkv_bwd": 0}
