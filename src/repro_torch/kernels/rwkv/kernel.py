"""The hand-written CUDA wkv kernel (`csrc/wkv.cu`): ctypes binding,
argument checks and a launch counter.

`wkv_cuda` takes CUDA tensors in the model's layout — r, k, v (B, S, H,
dh), one dtype (bfloat16 or float32), w (B, S, H, dh) and u (H, dh)
float32, optional s0 (B, H, dh, dh) float32 — and returns (out (B, S, H,
dh) float32, s_fin (B, H, dh, dh) float32). It refuses a bfloat16 w: a
decay of 0.999 rounds to 0.99609 there. `LAUNCHES["wkv"]` counts launches
and `LAUNCH_SHAPES` counts them by (B, S, H, dh, dtype, s0 given).
`launch` is the bare call beneath, for timing: it checks nothing and
counts nothing. The library is built by nvcc on first launch, never at
import.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from pathlib import Path

import torch

from .._build import Library

_MAX_INT = 2**31 - 1          # the kernel's grid is B·H blocks


def _declare(handle: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    handle.wkv_launch.argtypes = [vp] * 8 + [i] * 5 + [vp]
    handle.wkv_launch.restype = i


LIBRARY = Library("rwkv", Path(__file__).resolve().parent / "csrc", _declare)
HEAD_DIMS = (32, 64, 128)     # the head sizes the kernel is built for

LAUNCHES: dict[str, int] = {"wkv": 0}
LAUNCH_SHAPES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES["wkv"] = 0
    LAUNCH_SHAPES.clear()


def _check(r, k, v, w, u, s0) -> None:
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError(f"r, k, v, w must all be (B, S, H, dh); got "
                         f"{[tuple(x.shape) for x in (r, k, v, w)]}")
    B, S, H, dh = r.shape
    if min(B, S, H) < 1:
        raise ValueError("B, S and H must be at least 1")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head size {dh} not built; the kernel takes "
                         f"{HEAD_DIMS}")
    if B * H > _MAX_INT:
        raise ValueError(f"B·H = {B * H} exceeds the kernel's grid")
    if r.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must all be bfloat16 or all float32; got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, not {w.dtype}: in bfloat16 a "
                        "decay of 0.999 rounds to 0.99609")
    if u.shape != (H, dh) or u.dtype != torch.float32:
        raise ValueError(f"u must be float32 ({H}, {dh}); got "
                         f"{u.dtype} {tuple(u.shape)}")
    if s0 is not None and (s0.shape != (B, H, dh, dh)
                           or s0.dtype != torch.float32):
        raise ValueError(f"s0 must be float32 ({B}, {H}, {dh}, {dh}); got "
                         f"{s0.dtype} {tuple(s0.shape)}")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0)):
        if x is not None and (x.device.type != "cuda" or x.device != r.device
                              or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             "tensor on r's CUDA device")


def wkv_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             s0: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The wkv recurrence on the card. Raises on what the kernel does not
    take and when the launch fails; there is no other path."""
    _check(r, k, v, w, u, s0)
    B, S, H, dh = r.shape
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    s_fin = torch.empty((B, H, dh, dh), dtype=torch.float32,
                        device=r.device)
    with torch.cuda.device(r.device):
        launch(r, k, v, w, u, s0, out, s_fin)
    LAUNCHES["wkv"] += 1
    LAUNCH_SHAPES[(B, S, H, dh, str(r.dtype).removeprefix("torch."),
                   s0 is not None)] += 1
    return out, s_fin


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor | None,
           out: torch.Tensor, s_fin: torch.Tensor) -> None:
    """Bare launch on the current stream into preallocated `out` and
    `s_fin`. Raises if the launch itself fails."""
    lib = LIBRARY.lib()
    B, S, H, dh = r.shape
    rc = lib.wkv_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if s0 is None else s0.data_ptr(), out.data_ptr(),
        s_fin.data_ptr(), B, S, H, dh, int(r.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"wkv: CUDA kernel launch failed with cudaError "
                           f"{rc}")
