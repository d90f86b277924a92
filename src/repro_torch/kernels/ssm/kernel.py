"""The hand-written CUDA selective-scan kernel (`csrc/selective_scan.cu`):
ctypes binding, argument checks and a launch counter.

`selective_scan_cuda` takes float32 CUDA tensors in the model's layout —
a, b (B, S, D, N), c (B, S, N), optional h0 (B, D, N) — and returns (y
(B, S, D) float32, h_fin (B, D, N) float32). N may be 1 to 32 (Mamba's
d_state is 16). `LAUNCHES["selective_scan"]` counts launches and
`LAUNCH_SHAPES` counts them by (B, S, D, N, h0 given). `launch` is the
bare call beneath, for timing: it checks nothing and counts nothing. The
library is built by nvcc on first launch, never at import.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from pathlib import Path

import torch

from .._build import Library

MAX_N = 32                    # a state row is one group of lanes in a warp
_MAX_INT = 2**31 - 1          # the kernel's grid and its int indices


def _declare(handle: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    handle.selective_scan_launch.argtypes = [vp] * 6 + [i] * 4 + [vp]
    handle.selective_scan_launch.restype = i


LIBRARY = Library("ssm", Path(__file__).resolve().parent / "csrc", _declare)

LAUNCHES: dict[str, int] = {"selective_scan": 0}
LAUNCH_SHAPES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES["selective_scan"] = 0
    LAUNCH_SHAPES.clear()


def check_inputs(a, b, c, h0) -> None:
    """Shapes and dtypes, on any device: raise on what the kernel does
    not take (the plain version is held to the same rules)."""
    if a.dim() != 4 or b.shape != a.shape:
        raise ValueError(f"a and b must both be (B, S, D, N); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    B, S, D, N = a.shape
    if min(B, S, D, N) < 1:
        raise ValueError("B, S, D and N must be at least 1")
    if c.shape != (B, S, N):
        raise ValueError(f"c must be ({B}, {S}, {N}); got {tuple(c.shape)}")
    if h0 is not None and h0.shape != (B, D, N):
        raise ValueError(f"h0 must be ({B}, {D}, {N}); got "
                         f"{tuple(h0.shape)}")
    for name, x in (("a", a), ("b", b), ("c", c), ("h0", h0)):
        if x is not None and x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {x.dtype}: the "
                            "scan's inputs and state are float32")


def _check(a, b, c, h0) -> None:
    check_inputs(a, b, c, h0)
    B, S, D, N = a.shape
    if N > MAX_N:
        raise ValueError(f"N = {N} exceeds the kernel's {MAX_N}")
    lanes = D << (N - 1).bit_length()       # D · N rounded up to 2^k
    if lanes > _MAX_INT or B * -(-lanes // 256) > _MAX_INT:
        raise ValueError(f"shape {(B, S, D, N)} exceeds the kernel's grid")
    for name, x in (("a", a), ("b", b), ("c", c), ("h0", h0)):
        if x is not None and (x.device.type != "cuda" or x.device != a.device
                              or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             "tensor on a's CUDA device")


def selective_scan_cuda(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                        h0: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan on the card. Raises on what the kernel does not
    take and when the launch fails; there is no other path."""
    _check(a, b, c, h0)
    B, S, D, N = a.shape
    y = torch.empty((B, S, D), dtype=torch.float32, device=a.device)
    h_fin = torch.empty((B, D, N), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        launch(a, b, c, h0, y, h_fin)
    LAUNCHES["selective_scan"] += 1
    LAUNCH_SHAPES[(B, S, D, N, h0 is not None)] += 1
    return y, h_fin


def launch(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
           h0: torch.Tensor | None, y: torch.Tensor,
           h_fin: torch.Tensor) -> None:
    """Bare launch on the current stream into preallocated `y` and
    `h_fin`. Raises if the launch itself fails."""
    lib = LIBRARY.lib()
    B, S, D, N = a.shape
    rc = lib.selective_scan_launch(
        a.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_fin.data_ptr(), B, S, D, N,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"selective_scan: CUDA kernel launch failed with "
                           f"cudaError {rc}")
