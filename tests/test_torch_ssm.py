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
    assert ssm.LAUNCHES == {"selective_scan": 0, "selective_scan_fused": 0}


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
