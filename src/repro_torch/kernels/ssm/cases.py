"""The fused scan backward's edge cases and their inputs, shared by the
CPU tests (`tests/test_torch_ssm.py`: the plain version against JAX's
autodiff), the card tests (`tests/test_torch_cuda.py`: the kernel
against the plain version) and `chip_smoke.py`'s `scan_bwd_edge` phase.

Each case is (name, (B, S, D, N), dtype name, state, with_D, edge):
`state` gives h0 and the final state's gradient dh_fin (else neither);
`with_D` the D skip; `edge` sends three columns into exp's denormal
range (see `bwd_inputs`). B_ and C_ are always strided slices of one
projection, as the model passes them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import BWD_CHUNK

GRADS = ("ddt", "dA", "dB_", "dC_", "dx", "dD", "dh0")

# of each output's scale: float32 sums in other orders; a bf16 output
# (dB_, dC_, dx in x's dtype) one rounding more
BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0**-8 + 1e-4}
PROJ_HEAD = 5                 # the projection's columns before B_ (dt's)


def bwd_cases() -> list[tuple]:
    """S = 1 and 37 (not a multiple of the chunk of `BWD_CHUNK`) × N 4
    and 16 × bf16/float32 × (h0, dh_fin, D) all given or none; then N =
    8 at S 16 and 17 (2T, 2T + 1 for the chunk T) and exp's denormal
    range; then Jamba's 8192 channels; then N = 8 at the chunk's own
    edges (T, T + 1)."""
    T = BWD_CHUNK
    cases = [(f"S{S}_N{N}_{dt}_{'full' if full else 'bare'}",
              (2, S, 96, N), dt, full, full, False)
             for S in (1, 37) for N in (4, 16)
             for dt in ("float32", "bfloat16") for full in (True, False)]
    cases += [(f"N8_S{S}_{dt}", (2, S, 40, 8), dt, True, True, False)
              for S in (2 * T, 2 * T + 1) for dt in ("float32", "bfloat16")]
    cases += [(f"underflow_{dt}", (2, 40, 24, 16), dt, True, True, True)
              for dt in ("float32", "bfloat16")]
    cases.append(("jamba_width", (2, 20, 8192, 16), "bfloat16", False, True,
                  False))
    cases += [(f"N8_S{S}_{dt}", (2, S, 40, 8), dt, True, True, False)
              for S in (T, T + 1) for dt in ("float32", "bfloat16")]
    return cases


def bwd_inputs(case: tuple, seed: int, device) -> tuple:
    """(dt, A, B_, C_, x, D or None, h0 or None, dy, dh_fin or None) as
    the model draws them: dt = softplus(N(0, 1)), A = -exp(A_log) with
    A_log ~ 0.5·N(0, 1), B_ and C_ strided slices of one (B, S, 5 + 2N)
    projection and x in the case's dtype, D about 1, h0 ~ 0.1·N(0, 1);
    dy and dh_fin ~ N(0, 1). With `edge`, column 1 has dt·A = -95 (a
    denormal) and x = 0, column 2 dt·A = -110 (a = 0), column 3 sweeps
    dt·A from -80 over n. Drawn on the CPU from `seed`, moved to
    `device`."""
    _, (B, S, D, N), dtype, state, with_D, edge = case
    gen = torch.Generator().manual_seed(seed)

    def normal(shape):
        return torch.randn(shape, generator=gen)
    dt = F.softplus(normal((B, S, D)))
    A = -torch.exp(0.5 * normal((D, N)))
    x = normal((B, S, D))
    if edge:
        A[1:4] = -1.0
        A[3] = -(1.0 + torch.arange(N) / 8.0)
        dt[..., 1], dt[..., 2], dt[..., 3] = 95.0, 110.0, 80.0
        x[..., 1] = 0.0
        x[..., 2:4] /= dt[..., 2:4]
    dtype = getattr(torch, dtype)
    proj = normal((B, S, PROJ_HEAD + 2 * N)).to(dtype)
    Dv, h0 = 1.0 + 0.1 * normal((D,)), 0.1 * normal((B, D, N))
    dy, dh_fin = normal((B, S, D)), normal((B, D, N))
    proj, dt, A, x = (t.to(device) for t in (proj, dt, A, x.to(dtype)))
    B_, C_ = proj[..., PROJ_HEAD:PROJ_HEAD + N], proj[..., PROJ_HEAD + N:]
    return (dt, A, B_, C_, x, Dv.to(device) if with_D else None,
            h0.to(device) if state else None, dy.to(device),
            dh_fin.to(device) if state else None)
