"""The port's selective scan (`repro_torch.kernels.ssm`) against the JAX
package's, on the CPU.

Inputs come from a numpy seed and go through both packages in one
process. On the CPU the port's `ops.selective_scan` takes the plain
PyTorch version (`selective_scan_ref`) of the CUDA kernel; the kernel
itself is held against that on a card (`tests/test_torch_cuda.py`,
`chip_smoke.py`). Tolerance: rtol = atol = 1e-4, the JAX package's own
for its scan kernel (`tests/test_kernels.py`).

The fused entry (`ops.selective_scan_fused`, plain version
`selective_scan_fused_ref`) is held to JAX's composition — the model's
`_ssm_inputs`, `selective_scan_ref`, the D skip — from the same x_act and
parameters, at 2e-5 of the scale in float32 and 3e-2 in bfloat16, the
Mamba layer's tolerances (`tests/test_torch_hybrid.py`); and to the
unfused plain scan on a and b built by the same expressions, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.ssm import selective_scan_pallas
from repro.kernels.ssm import selective_scan_ref as jax_scan_ref
from repro.models import mamba as jax_mamba
from repro_torch.configs import get_config
from repro_torch.kernels import ssm
from repro_torch.kernels.ssm import cases as scan_cases
from repro_torch.kernels.ssm import ops as ssm_ops
from repro_torch.models import mamba, params_from_numpy


def _inputs(seed, B, S, D, N):
    """a, b, c, h0 as float32 numpy, the JAX tests' distributions."""
    rng = np.random.default_rng(seed)
    return tuple(x.astype(np.float32) for x in (
        rng.uniform(0.4, 0.99, (B, S, D, N)),
        rng.normal(0, 0.3, (B, S, D, N)),
        rng.normal(0, 1, (B, S, N)),
        rng.normal(0, 0.1, (B, D, N))))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,D,N", [(1, 64, 128, 8), (2, 37, 96, 16),
                                     (2, 1, 24, 4), (1, 20, 5, 3)])
def test_selective_scan_matches_jax_ref(B, S, D, N, with_h0):
    a, b, c, h0 = _inputs(B + S + D + N, B, S, D, N)
    h0 = h0 if with_h0 else None
    want_y, want_h = jax_scan_ref(*map(jnp.asarray, (a, b, c)),
                                  None if h0 is None else jnp.asarray(h0))
    ssm.reset_launches()
    t = [torch.from_numpy(x) for x in (a, b, c)]
    for y, h_fin in (ssm.selective_scan_ref(
            *t, None if h0 is None else torch.from_numpy(h0)),
            ssm.selective_scan(a, b, c, h0, device="cpu")):
        assert y.dtype == h_fin.dtype == torch.float32
        assert y.shape == (B, S, D) and h_fin.shape == (B, D, N)
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(h_fin.numpy(), np.asarray(want_h),
                                   rtol=1e-4, atol=1e-4)
    assert ssm.LAUNCHES["selective_scan"] == 0      # CPU: the plain version


@pytest.mark.parametrize("B,S,D,N", [(1, 64, 128, 8), (2, 128, 256, 16),
                                     (1, 192, 384, 4)])
def test_selective_scan_matches_pallas_interpret(B, S, D, N):
    """The cases of the JAX package's `test_selective_scan_vs_ref`; the
    Pallas kernel starts from zeros and returns only y."""
    a, b, c, _ = _inputs(B * S, B, S, D, N)
    want = selective_scan_pallas(*map(jnp.asarray, (a, b, c)),
                                 interpret=True)
    y, _ = ssm.selective_scan(a, b, c, device="cpu")
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_split_scan_carries_the_state_exactly():
    """Prefill then decode: the scan over S steps equals the scan over
    the first S - 1 steps followed by one step from its final state, bit
    for bit (the same roundings in the same order)."""
    a, b, c, h0 = (torch.from_numpy(x) for x in _inputs(5, 2, 12, 16, 16))
    y, h = ssm.selective_scan(a, b, c, h0, device="cpu")
    y1, h1 = ssm.selective_scan(a[:, :-1], b[:, :-1], c[:, :-1], h0,
                                device="cpu")
    y2, h2 = ssm.selective_scan(a[:, -1:], b[:, -1:], c[:, -1:], h1,
                                device="cpu")
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)


def test_selective_scan_refuses_what_the_kernel_refuses():
    a, b, c, h0 = (torch.from_numpy(x) for x in _inputs(0, 1, 4, 8, 4))
    for bad in ({"a": a.bfloat16()}, {"b": b.double()}, {"c": c.half()},
                {"h0": h0.bfloat16()}):
        args = {"a": a, "b": b, "c": c, "h0": h0, **bad}
        name = next(iter(bad))
        with pytest.raises(TypeError, match=f"{name} must be float32"):
            ssm.selective_scan(**args, device="cpu")
    for bad, what in (({"b": b[:, :3]}, "a and b"), ({"a": a[0]}, "a and b"),
                      ({"c": c[:, :, :3]}, "c must be"),
                      ({"h0": h0[:, :5]}, "h0 must be"),
                      ({"a": a[:, :0], "b": b[:, :0], "c": c[:, :0]},
                       "at least 1")):
        with pytest.raises(ValueError, match=what):
            ssm.selective_scan(**{"a": a, "b": b, "c": c, "h0": h0, **bad},
                               device="cpu")
    with pytest.raises(ValueError, match="impl"):
        ssm.selective_scan(a, b, c, impl="pallas", device="cpu")


def test_selective_scan_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b, c, _ = _inputs(0, 1, 4, 8, 4)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ssm.selective_scan(a, b, c)


# ------------------------------------------------------------ fused scan
ARCH = "jamba-v0.1-52b"
FUSED_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _scaled_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


def _mamba_inputs(seed, dtype, B=2, S=9):
    """x_act and the SSM parameters of the reduced jamba's Mamba layer
    (di 256, ds 8, dt_rank 8), made with numpy: JAX's arrays in `dtype`
    (A_log and D float32, as the model keeps them) and the port's tensors
    of the same values."""
    cfg = jax_get_config(ARCH, reduced=True)
    di, ds = cfg.mamba.d_inner(cfg.d_model), cfg.mamba.d_state
    r = max(cfg.d_model // 16, 1)
    rng = np.random.default_rng(seed)
    jd = JDTYPE[dtype]
    jp = {"x_proj": jnp.asarray(rng.normal(0, di**-0.5, (di, r + 2 * ds)), jd),
          "dt_w": jnp.asarray(rng.normal(0, r**-0.5, (r, di)), jd),
          "dt_b": jnp.asarray(np.ones(di), jd),
          "A_log": jnp.asarray(rng.normal(0, 0.5, (di, ds)), jnp.float32),
          "D": jnp.asarray(rng.normal(1, 0.1, di), jnp.float32)}
    x = jnp.asarray(rng.normal(0, 1, (B, S, di)), jd)
    h0 = rng.normal(0, 0.1, (B, di, ds)).astype(np.float32)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return cfg, jp, x, p, xt, h0


@pytest.mark.parametrize("with_D", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_scan_fused_matches_jax(dtype, with_h0, with_D):
    """The port's `_ssm_inputs` and fused scan against JAX's `_ssm_inputs`,
    `selective_scan_ref` and D skip on the same x_act and parameters."""
    jcfg, jp, x, p, xt, h0 = _mamba_inputs(11, dtype)
    a, b, c = jax_mamba._ssm_inputs(x, jp, jcfg)
    want_y, want_h = jax_scan_ref(a, b, c,
                                  jnp.asarray(h0) if with_h0 else None)
    if with_D:
        want_y = want_y + jp["D"] * x.astype(jnp.float32)
    dt, A, B_, C_ = mamba._ssm_inputs(xt, p, get_config(ARCH, reduced=True))
    assert dt.dtype == A.dtype == torch.float32
    assert B_.dtype == C_.dtype == xt.dtype and B_.stride(1) == 8 + 2 * 8
    args = (dt, A, B_, C_, xt, p["D"] if with_D else None,
            torch.from_numpy(h0) if with_h0 else None)
    ssm.reset_launches()
    for y, h_fin in (ssm.selective_scan_fused_ref(*args),
                     ssm.selective_scan_fused(*args, device="cpu")):
        assert y.dtype == h_fin.dtype == torch.float32
        assert y.shape == tuple(want_y.shape)
        assert h_fin.shape == tuple(want_h.shape)
        assert _scaled_err(y, want_y) <= FUSED_TOL[dtype]
        assert _scaled_err(h_fin, want_h) <= FUSED_TOL[dtype]
    assert ssm.LAUNCHES == {"selective_scan": 0, "selective_scan_fused": 0,
                            "selective_scan_fused_bwd": 0}


@pytest.mark.parametrize("with_D", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_plain_equals_the_unfused_scan_on_old_inputs(dtype, with_h0,
                                                           with_D):
    """The fused plain version is the unfused scan on a and b built by the
    model's former expressions, then y + D·x: bit for bit."""
    _, _, _, p, xt, h0 = _mamba_inputs(12, dtype, S=13)
    dt, A, B_, C_ = mamba._ssm_inputs(xt, p, get_config(ARCH, reduced=True))
    h0 = torch.from_numpy(h0) if with_h0 else None
    D = p["D"] if with_D else None
    a = torch.mul(dt[..., None], A).exp_()
    b = torch.mul(dt[..., None], B_[:, :, None, :].float()).mul_(
        xt[..., None].float())
    want_y, want_h = ssm.selective_scan(a, b, C_.float(), h0, device="cpu")
    if with_D:
        want_y = want_y + D * xt.float()
    y, h = ssm.selective_scan_fused(dt, A, B_, C_, xt, D, h0, device="cpu")
    assert torch.equal(y, want_y) and torch.equal(h, want_h)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_fused_scan_carries_the_state_exactly(dtype):
    """Prefill then decode through the fused entry: S steps equal S - 1
    steps followed by one step from their final state, bit for bit."""
    _, _, _, p, xt, h0 = _mamba_inputs(13, dtype, S=12)
    dt, A, B_, C_ = mamba._ssm_inputs(xt, p, get_config(ARCH, reduced=True))
    h0, D = torch.from_numpy(h0), p["D"]
    y, h = ssm.selective_scan_fused(dt, A, B_, C_, xt, D, h0, device="cpu")
    y1, h1 = ssm.selective_scan_fused(dt[:, :-1], A, B_[:, :-1], C_[:, :-1],
                                      xt[:, :-1], D, h0, device="cpu")
    y2, h2 = ssm.selective_scan_fused(dt[:, -1:], A, B_[:, -1:], C_[:, -1:],
                                      xt[:, -1:], D, h1, device="cpu")
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)


def test_selective_scan_fused_refuses_what_the_kernel_refuses():
    rng = np.random.default_rng(0)
    Bz, S, Di, N = 2, 5, 12, 4
    dt, x = (torch.from_numpy(rng.random((Bz, S, Di), np.float32))
             for _ in range(2))
    A = torch.from_numpy(-rng.random((Di, N), np.float32))
    B_, C_ = (torch.from_numpy(rng.normal(size=(Bz, S, N)).astype(np.float32))
              for _ in range(2))
    D = torch.ones(Di)
    h0 = torch.zeros((Bz, Di, N))
    ok = {"dt": dt, "A": A, "B_": B_, "C_": C_, "x": x, "D": D, "h0": h0}
    for bad, err, what in (
            ({"dt": dt.bfloat16()}, TypeError, "dt must be float32"),
            ({"A": A.double()}, TypeError, "A must be float32"),
            ({"D": D.bfloat16()}, TypeError, "D must be float32"),
            ({"h0": h0.half()}, TypeError, "h0 must be float32"),
            ({"x": x.bfloat16()}, TypeError, "all bfloat16 or all float32"),
            ({"x": x.half(), "B_": B_.half(), "C_": C_.half()}, TypeError,
             "all bfloat16 or all float32"),
            ({"C_": C_.bfloat16()}, TypeError, "all bfloat16"),
            ({"x": x[:, :3]}, ValueError, "dt and x"),
            ({"dt": dt[0], "x": x[0]}, ValueError, "dt and x"),
            ({"A": A[:5]}, ValueError, "A must be"),
            ({"B_": B_[:, :, :3]}, ValueError, "B_ must be"),
            ({"C_": C_[:, :2]}, ValueError, "C_ must be"),
            ({"D": D[:5]}, ValueError, "D must be"),
            ({"h0": h0[:, :, :2]}, ValueError, "h0 must be"),
            ({"dt": dt[:, :0], "x": x[:, :0], "B_": B_[:, :0],
              "C_": C_[:, :0]}, ValueError, "at least 1")):
        with pytest.raises(err, match=what):
            ssm.selective_scan_fused(**{**ok, **bad}, device="cpu")
    with pytest.raises(ValueError, match="impl"):
        ssm.selective_scan_fused(**ok, impl="triton", device="cpu")


def test_selective_scan_fused_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, _, p, xt, _ = _mamba_inputs(0, "float32", S=3)
    dt, A, B_, C_ = mamba._ssm_inputs(xt, p, get_config(ARCH, reduced=True))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ssm.selective_scan_fused(dt, A, B_, C_, xt)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ssm.selective_scan_fused(dt, A, B_, C_, xt, impl="ref")


def test_row_stride_reads_the_models_slices():
    """The kernel reads B_ and C_ as B·S rows at one stride: the model's
    slices of its projection qualify, a transposed view does not."""
    proj = torch.zeros((3, 7, 40))
    assert ssm.kernel.row_stride(proj[..., 8:24]) == 40
    assert ssm.kernel.row_stride(proj[:, :1, 8:24]) == 280
    assert ssm.kernel.row_stride(proj[:1, :, 24:]) == 40
    assert ssm.kernel.row_stride(proj.transpose(0, 1)[..., :16]) is None
    assert ssm.kernel.row_stride(proj[..., ::2]) is None


# ------------------------------------------------------- the backward
BWD_CASES = scan_cases.bwd_cases()


def _j(x):
    if x is None:
        return None
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.contiguous().numpy())


def _jax_fused(dt, A, B_, C_, x, D=None, h0=None):
    """JAX's `_ssm_inputs` expressions for a and b from dt, A, B_ and x,
    its `selective_scan_ref`, then the D skip, as its Mamba layer
    composes them (`repro/models/mamba.py`)."""
    f32 = jnp.float32
    a = jnp.exp(dt[..., None] * A)
    b = (dt[..., None] * B_[:, :, None, :].astype(f32)
         * x[..., None].astype(f32))
    y, h = jax_scan_ref(a, b, C_.astype(f32), h0)
    if D is not None:
        y = y + x.astype(f32) * D
    return y, h


def _bwd_tol(g: torch.Tensor) -> float:
    """Of a gradient's scale: 1e-4 in float32; a bf16 gradient against
    JAX's or autograd's, which add dx's two bf16 terms (the scan's and
    the D skip's) and round again, three roundings."""
    return 3 * 2.0**-8 if g.dtype == torch.bfloat16 else 1e-4


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_scan_fused_bwd_ref_matches_jax_vjp(case):
    """`selective_scan_fused_bwd_ref` against `jax.vjp` of JAX's
    composition (`_ssm_inputs`' a and b, `selective_scan_ref`, the D
    skip) on every backward edge case — h0 and dh_fin, S = 1 and S off
    the chunk, bf16 and float32, strided B_ and C_, D omitted, exp's
    denormal range: each gradient within 1e-4 of its scale, a bf16 one
    (dB_, dC_, dx) within three roundings (`_bwd_tol`)."""
    dt, A, B_, C_, x, D, h0, dy, dh_fin = scan_cases.bwd_inputs(case, 3,
                                                                "cpu")
    given = [t for t in (D, h0) if t is not None]
    names = [n for n, t in (("D", D), ("h0", h0)) if t is not None]

    def fn(dt_, A_, B__, C__, x_, *rest):
        kw = dict(zip(names, rest))
        return _jax_fused(dt_, A_, B__, C__, x_, kw.get("D"), kw.get("h0"))
    (y, h), vjp = jax.vjp(fn, *(_j(t) for t in (dt, A, B_, C_, x, *given)))
    want = list(vjp((_j(dy), jnp.zeros_like(h) if dh_fin is None
                     else _j(dh_fin))))
    got = ssm.selective_scan_fused_bwd_ref(dt, A, B_, C_, x, D, h0, dy,
                                           dh_fin)
    want = want[:5] + [want.pop(5) if D is not None else None] + [
        want[-1] if h0 is not None else None]
    for name, g, w in zip(scan_cases.GRADS, got, want):
        assert (g is None) == (w is None), name
        if g is None:
            continue
        assert g.dtype == (x.dtype if name in ("dB_", "dC_", "dx")
                           else torch.float32), name
        assert _scaled_err(g, np.asarray(w, np.float32)) <= _bwd_tol(g), name


@pytest.mark.parametrize("with_D", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_fused_bwd_ref_through_ssm_inputs_matches_jax(with_h0, with_D):
    """The reduced Jamba's Mamba inputs in float32: the gradients of x_act,
    x_proj, dt_w, dt_b, A_log, D and h0 from `jax.vjp` of JAX's own
    `_ssm_inputs` + `selective_scan_ref` + D skip, against the port's
    `_ssm_inputs` under autograd fed `selective_scan_fused_bwd_ref`'s
    d(dt), dA, dB_ and dC_ (dx added to x_act's), within 1e-4 of each
    gradient's scale."""
    jcfg, jp, x, p, xt, h0 = _mamba_inputs(12, "float32")
    h0 = h0 if with_h0 else None
    rng = np.random.default_rng(13)
    dy = rng.normal(0, 1, (2, 9, x.shape[-1])).astype(np.float32)
    keys = ("x_proj", "dt_w", "dt_b", "A_log")

    def jfn(x_, sub, D_, h0_):
        a, b, c = jax_mamba._ssm_inputs(x_, dict(sub), jcfg)
        y, _ = jax_scan_ref(a, b, c, h0_)
        return y + x_.astype(jnp.float32) * D_ if with_D else y
    sub = {k: jp[k] for k in keys}
    _, vjp = jax.vjp(jfn, x, sub, jp["D"], None if h0 is None
                     else jnp.asarray(h0))
    jx, jsub, jD, jh0 = vjp(jnp.asarray(dy))
    leaves = [xt.clone().requires_grad_()] + [
        p[k].clone().requires_grad_() for k in keys]
    cfg = get_config(ARCH, reduced=True)
    dt, A, B_, C_ = mamba._ssm_inputs(leaves[0], dict(zip(keys, leaves[1:])),
                                      cfg)
    D = p["D"] if with_D else None
    h0t = None if h0 is None else torch.from_numpy(h0)
    ddt, dA, dB, dC, dx, dD, dh0 = ssm.selective_scan_fused_bwd_ref(
        dt.detach(), A.detach(), B_.detach(), C_.detach(), xt, D, h0t,
        torch.from_numpy(dy))
    got = list(torch.autograd.grad((dt, A, B_, C_), leaves,
                                   (ddt, dA, dB, dC)))
    got[0] = got[0] + dx
    for g, w in zip(got, [jx] + [jsub[k] for k in keys]):
        assert _scaled_err(g, w) <= 1e-4
    if with_D:
        assert _scaled_err(dD, jD) <= 1e-4
    if with_h0:
        assert _scaled_err(dh0, jh0) <= 1e-4


@pytest.mark.parametrize("case", BWD_CASES[:16], ids=[c[0] for c in
                                                       BWD_CASES[:16]])
def test_scan_fused_bwd_ref_matches_autograd_of_the_plain_forward(case):
    """The explicit reverse loop against autograd through
    `selective_scan_fused_ref` (the CPU path of `ops.selective_scan_fused`),
    within the same tolerances."""
    dt, A, B_, C_, x, D, h0, dy, dh_fin = scan_cases.bwd_inputs(case, 4,
                                                                "cpu")
    leaves = [t.clone().requires_grad_() for t in (dt, A, B_, C_, x)]
    extra = [None if t is None else t.clone().requires_grad_()
             for t in (D, h0)]
    y, h = ssm.selective_scan_fused(*leaves, *extra, device="cpu")
    loss = (y * dy).sum() + (0 if dh_fin is None else (h * dh_fin).sum())
    want = torch.autograd.grad(loss, leaves + [t for t in extra
                                               if t is not None])
    got = [g for g in ssm.selective_scan_fused_bwd_ref(
        dt, A, B_, C_, x, D, h0, dy, dh_fin) if g is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _scaled_err(g, w.float().numpy()) <= _bwd_tol(g)


@pytest.mark.parametrize("outputs", ["both", "y", "state"])
@pytest.mark.parametrize("full", [False, True])
def test_scan_fused_function_with_the_plain_halves_equals_autograd(
        monkeypatch, full, outputs):
    """`ops._ScanFused` run on the CPU with the plain forward and backward
    swapped in for the kernels: its gradients (saved tensors and strided
    views, the backward's inputs, None for an unused output, a missing D
    or h0) equal autograd through `selective_scan_fused_ref` within 1e-5
    of their scale."""
    monkeypatch.setattr(ssm_ops, "selective_scan_fused_cuda",
                        ssm.selective_scan_fused_ref)
    monkeypatch.setattr(ssm_ops, "selective_scan_fused_bwd_cuda",
                        ssm.selective_scan_fused_bwd_ref)
    case = ("fn", (2, 21, 12, 8), "float32", full, full, False)
    dt, A, B_, C_, x, D, h0, dy, _ = scan_cases.bwd_inputs(case, 5, "cpu")
    dh_fin = torch.randn(2, 12, 8, generator=torch.Generator().manual_seed(6))

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (dt, A, x)]
        proj = torch.cat([B_, C_], -1).clone().requires_grad_()
        extra = [None if t is None else t.clone().requires_grad_()
                 for t in (D, h0)]
        y, h = fn(leaves[0], leaves[1], proj[..., :8], proj[..., 8:],
                  leaves[2], *extra)
        loss = 0
        if outputs in ("both", "y"):
            loss = loss + (y * dy).sum()
        if outputs in ("both", "state"):
            loss = loss + (h * dh_fin).sum()
        return torch.autograd.grad(
            loss, leaves + [proj] + [t for t in extra if t is not None],
            allow_unused=True, materialize_grads=True)

    got = grads(ssm_ops._ScanFused.apply)
    want = grads(ssm.selective_scan_fused_ref)
    assert len(got) == len(want) == 4 + 2 * full
    for g, w in zip(got, want):
        assert _scaled_err(g, w.numpy()) <= 1e-5


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_fused_ref_saves_the_prefix_states(case):
    """The forward that writes states, in plain PyTorch
    (`selective_scan_fused_ref(..., states=True)`): y and the final state
    equal the plain forward's bit for bit, and the state before every
    `BWD_CHUNK`-th step equals the final state of that prefix (h0 or
    zeros first), bit for bit, on every backward edge case."""
    dt, A, B_, C_, x, D, h0, _, _ = scan_cases.bwd_inputs(case, 9, "cpu")
    T = scan_cases.BWD_CHUNK
    y, h, states = ssm.selective_scan_fused_ref(dt, A, B_, C_, x, D, h0,
                                                states=True, chunk=T)
    y1, h1 = ssm.selective_scan_fused_ref(dt, A, B_, C_, x, D, h0)
    assert torch.equal(y, y1) and torch.equal(h, h1)
    Bsz, S, Di = dt.shape
    assert states.shape == ssm.states_shape(Bsz, S, Di, A.shape[1])
    for c in range(states.shape[1]):
        want = (h0 if h0 is not None else torch.zeros_like(h)) if c == 0 \
            else ssm.selective_scan_fused_ref(
                dt[:, :c * T], A, B_[:, :c * T], C_[:, :c * T],
                x[:, :c * T], None, h0)[1]
        assert torch.equal(states[:, c], want), c


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_scan_fused_bwd_ref_from_saved_states_equals_the_step_backward(case):
    """The backward recomputing each chunk from the forward's saved
    states (`selective_scan_fused_bwd_ref(..., states)`, the kernel's
    route) against the same backward walking from h0, on every backward
    edge case: the recomputed states carry the forward's roundings, so
    every gradient is equal bit for bit."""
    args = scan_cases.bwd_inputs(case, 10, "cpu")
    _, _, states = ssm.selective_scan_fused_ref(*args[:7], states=True)
    got = ssm.selective_scan_fused_bwd_ref(*args, states)
    want = ssm.selective_scan_fused_bwd_ref(*args)
    for name, g, w in zip(scan_cases.GRADS, got, want):
        assert (g is None) == (w is None), name
        assert g is None or torch.equal(g, w), name


def test_scan_fused_bwd_plan_and_refusals():
    """`plan_fused_bwd`: 4 states a thread, 64 columns a block at N = 16,
    a saved state every 8 steps, the scratch the library checks (the
    blocks' dB_ and dC_ partials, dA's and dD's per b); the wrapper
    refuses CPU tensors, a dy and saved states of the wrong shape before
    any library is loaded."""
    from repro_torch.kernels.ssm import kernel as sk
    plan = sk.plan_fused_bwd(2, 4096, 8192, 16)
    assert (plan["columns"], plan["blocks_per_b"], plan["chunks"]) == (
        64, 128, 512)
    assert plan["scratch_floats"] == 128 * 2 * 4096 * 32 + 2 * 8192 * 17
    assert sk.states_shape(2, 4096, 8192, 16) == (2, 512, 8192, 16)
    assert sk.states_shape(1, 17, 5, 3) == (1, 3, 5, 3)
    assert sk.plan_fused_bwd(1, 1, 5, 3)["columns"] == 256
    args = scan_cases.bwd_inputs(BWD_CASES[0], 0, "cpu")
    states = ssm.selective_scan_fused_ref(*args[:7], states=True)[2]
    with pytest.raises(ValueError, match="CUDA"):
        sk.selective_scan_fused_bwd_cuda(*args, states)
    sk.reset_launches()
    assert sk.LAUNCHES["selective_scan_fused_bwd"] == 0
