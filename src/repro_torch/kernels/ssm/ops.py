"""Selective-scan entry points in the model's layout.

`selective_scan(a, b, c, h0)`: a, b (B, S, D, N); c (B, S, N); optional
h0 (B, D, N); all float32. `selective_scan_fused(dt, A, B_, C_, x, D,
h0)`: the Mamba layer's own inputs (see `kernel.py`), a and b built
inside the kernel. A CUDA tensor goes to the hand-written kernel — or,
with `impl="ref"`, to the plain PyTorch version on the card, for
comparison; a CPU tensor takes the plain version. Nothing falls back:
without a card `device="cuda"` raises. An input of a dtype the kernel
does not take raises on either device, as the kernel would.
"""

from __future__ import annotations

import torch

from ..intersect.ops import resolve_device
from .kernel import (check_fused_inputs, check_inputs, row_stride,
                     selective_scan_cuda, selective_scan_fused_cuda)
from .ref import selective_scan_fused_ref, selective_scan_ref


def _impl(impl: str) -> str:
    if impl not in ("cuda", "ref"):
        raise ValueError(f"impl must be 'cuda' or 'ref', not {impl!r}")
    return impl


def selective_scan(a, b, c, h0=None, *, impl: str = "cuda", device="cuda"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan on `device`; returns (y (B, S, D) float32, final state (B,
    D, N) float32)."""
    _impl(impl)
    dev = resolve_device(device)
    a, b, c = (torch.as_tensor(x).to(dev) for x in (a, b, c))
    h0 = None if h0 is None else torch.as_tensor(h0).to(dev)
    if impl == "ref" or dev.type != "cuda":
        check_inputs(a, b, c, h0)       # the kernel's wrapper checks its own
        return selective_scan_ref(a, b, c, h0)
    return selective_scan_cuda(a.contiguous(), b.contiguous(), c.contiguous(),
                               None if h0 is None else h0.contiguous())


def selective_scan_fused(dt, A, B_, C_, x, D=None, h0=None, *,
                         impl: str = "cuda", device="cuda"
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan from dt, A, B_, C_ and x on `device`, with the D skip when
    D is given; returns (y (B, S, D) float32, final state (B, D, N)
    float32). B_ and C_ may be strided rows, as the model's slices of its
    projection are; other layouts are copied."""
    _impl(impl)
    dev = resolve_device(device)
    dt, A, B_, C_, x = (torch.as_tensor(t).to(dev) for t in (dt, A, B_, C_,
                                                              x))
    D, h0 = (None if t is None else torch.as_tensor(t).to(dev)
             for t in (D, h0))
    if impl == "ref" or dev.type != "cuda":
        check_fused_inputs(dt, A, B_, C_, x, D, h0)
        return selective_scan_fused_ref(dt, A, B_, C_, x, D, h0)
    B_, C_ = (t if t.dim() == 3 and row_stride(t) is not None
              else t.contiguous() for t in (B_, C_))
    return selective_scan_fused_cuda(
        dt.contiguous(), A.contiguous(), B_, C_, x.contiguous(),
        *(None if t is None else t.contiguous() for t in (D, h0)))
