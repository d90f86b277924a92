"""The wkv backward's edge cases and their inputs, shared by the CPU
tests (`tests/test_torch_rwkv.py`: the plain version against JAX's
autodiff), the card tests (`tests/test_torch_cuda.py`: the kernel
against the plain version) and `chip_smoke.py`'s `wkv_bwd_edge` phase.

Each case is (name, (B, S, H, dh), dtype name, state, decay): `state`
gives s0 and the final state's gradient ds_fin (else neither); `decay`
"uniform" draws w in (0.5, 0.999), "model" the model's exp(-exp(N(0,
1))) with key 0 held at exactly 1 and key 1 at exactly 0 on every step
(a decay near 1 keeps the whole history, near 0 none of it).
"""

from __future__ import annotations

import torch

from .kernel import BWD_CHUNK, HEAD_DIMS

# the backward's outputs, in the order wkv_bwd_ref returns them
GRADS = ("dr", "dk", "dv", "dw", "du", "ds0")
# of each output's scale: float32 sums in other orders; a bf16 output
# (dr, dk, dv in r's dtype) one rounding more
BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0**-8 + 1e-4}


def bwd_cases() -> list[tuple]:
    """S = 1 and S = 37 (not a multiple of the chunk of `BWD_CHUNK`) ×
    dh 32, 64, 128 × bf16/float32 × with and without s0 and ds_fin;
    then the model's decays around the chunk (T - 1, T, T + 1, 2T + 1,
    float32 and bf16, with the state); then the train path's 40 heads
    of 64 at a shorter length."""
    T = BWD_CHUNK
    cases = [(f"S{S}_dh{dh}_{dt}_{'state' if st else 'bare'}",
              (2, S, 3, dh), dt, st, "uniform")
             for S in (1, 37) for dh in HEAD_DIMS
             for dt in ("float32", "bfloat16") for st in (True, False)]
    cases += [(f"model_S{S}_{dt}", (2, S, 2, 64), dt, True, "model")
              for S in (T - 1, T, T + 1, 2 * T + 1)
              for dt in ("float32", "bfloat16")]
    cases.append(("heads40", (2, 70, 40, 64), "bfloat16", False, "model"))
    return cases


def bwd_inputs(case: tuple, seed: int, device) -> tuple:
    """(r, k, v in the case's dtype, w, u, s0 or None, dout, ds_fin or
    None float32), drawn on the CPU from `seed` and moved to `device`."""
    _, (B, S, H, dh), dtype, state, decay = case
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, std=1.0):
        return std * torch.randn(shape, generator=gen)
    r, k, v = (normal((B, S, H, dh), std).to(getattr(torch, dtype))
               for std in (1.0, 0.3, 1.0))
    if decay == "uniform":
        w = 0.5 + 0.499 * torch.rand((B, S, H, dh), generator=gen)
    else:
        w = torch.exp(-torch.exp(normal((B, S, H, dh))))
        w[..., 0], w[..., 1] = 1.0, 0.0
    u = normal((H, dh), 0.3)
    s0, ds_fin = normal((B, H, dh, dh), 0.1), normal((B, H, dh, dh))
    dout = normal((B, S, H, dh))
    out = (r, k, v, w, u, s0 if state else None, dout,
           ds_fin if state else None)
    return tuple(None if x is None else x.to(device) for x in out)

