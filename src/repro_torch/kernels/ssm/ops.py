"""Selective-scan entry points in the model's layout.

`selective_scan(a, b, c, h0)`: a, b (B, S, D, N); c (B, S, N); optional
h0 (B, D, N); all float32. `selective_scan_fused(dt, A, B_, C_, x, D,
h0)`: the Mamba layer's own inputs (see `kernel.py`), a and b built
inside the kernel. A CUDA tensor goes to the hand-written kernel — or,
with `impl="ref"`, to the plain PyTorch version on the card, for
comparison; a CPU tensor takes the plain version. Nothing falls back:
without a card `device="cuda"` raises. An input of a dtype the kernel
does not take raises on either device, as the kernel would.

A meta tensor takes the plain version too, unless a cost counter is
active (`kernels/_cost.py`): then it goes where a CUDA tensor goes, and
the kernel's wrapper records the call and only makes its outputs.

On the card `selective_scan_fused` is differentiable through
`_ScanFused`, a `torch.autograd.Function` whose forward is the fused
scan kernel and whose backward is the `selective_scan_fused_bwd` kernel;
on the CPU autograd differentiates `selective_scan_fused_ref`.
"""

from __future__ import annotations

import torch

from .._cost import counts_meta
from ..intersect.ops import resolve_device
from .kernel import (check_fused_inputs, check_inputs, row_stride,
                     selective_scan_cuda, selective_scan_fused_bwd_cuda,
                     selective_scan_fused_cuda)
from .ref import selective_scan_fused_ref, selective_scan_ref


class _ScanFused(torch.autograd.Function):
    """The fused scan kernel forward, its backward kernel backward:
    gradients for dt, A, B_, C_, x, D and h0 from y's and the final
    state's. The forward saves the state before every `BWD_CHUNK`-th step
    for the backward."""

    @staticmethod
    def forward(ctx, dt, A, B_, C_, x, D, h0):
        ctx.set_materialize_grads(False)
        y, h_fin, states = selective_scan_fused_cuda(dt, A, B_, C_, x, D, h0,
                                                     states=True)
        ctx.save_for_backward(dt, A, B_, C_, x, D, h0, states)
        return y, h_fin

    @staticmethod
    def backward(ctx, dy, dh_fin):
        dt, A, B_, C_, x, D, h0, states = ctx.saved_tensors
        dy = (torch.zeros(dt.shape, dtype=torch.float32, device=dt.device)
              if dy is None else dy.contiguous())
        return selective_scan_fused_bwd_cuda(
            dt, A, B_, C_, x, D, h0, dy,
            None if dh_fin is None else dh_fin.contiguous(), states)


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
    if impl == "ref" or dev.type != "cuda" and not counts_meta(dev):
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
    projection are; other layouts are copied. On the card, gradients
    reach every input through the backward kernel."""
    _impl(impl)
    dev = resolve_device(device)
    dt, A, B_, C_, x = (torch.as_tensor(t).to(dev) for t in (dt, A, B_, C_,
                                                              x))
    D, h0 = (None if t is None else torch.as_tensor(t).to(dev)
             for t in (D, h0))
    if impl == "ref" or dev.type != "cuda" and not counts_meta(dev):
        check_fused_inputs(dt, A, B_, C_, x, D, h0)
        return selective_scan_fused_ref(dt, A, B_, C_, x, D, h0)
    B_, C_ = (t if t.dim() == 3 and row_stride(t) is not None
              else t.contiguous() for t in (B_, C_))
    args = (dt.contiguous(), A.contiguous(), B_, C_, x.contiguous(),
            *(None if t is None else t.contiguous() for t in (D, h0)))
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in args):
        return _ScanFused.apply(*args)
    return selective_scan_fused_cuda(*args)
