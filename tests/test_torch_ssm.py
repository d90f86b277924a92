"""The port's selective scan (`repro_torch.kernels.ssm`) against the JAX
package's, on the CPU.

Inputs come from a numpy seed and go through both packages in one
process. On the CPU the port's `ops.selective_scan` takes the plain
PyTorch version (`selective_scan_ref`) of the CUDA kernel; the kernel
itself is held against that on a card (`tests/test_torch_cuda.py`,
`chip_smoke.py`). Tolerance: rtol = atol = 1e-4, the JAX package's own
for its scan kernel (`tests/test_kernels.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm import selective_scan_pallas
from repro.kernels.ssm import selective_scan_ref as jax_scan_ref
from repro_torch.kernels import ssm


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
