"""RWKV-6 wkv entry point in the model's layout.

r, k, v, w (B, S, H, dh); u (H, dh); optional s0 (B, H, dh, dh). A CUDA
tensor goes to the hand-written kernel (`kernel.wkv_cuda`) — or, with
`impl="ref"`, to the plain PyTorch version on the card, for comparison; a
CPU tensor takes the plain version. Nothing falls back: without a card
`device="cuda"` raises. w, u and s0 must be float32 on either device, as
the kernel takes them.

On the card `wkv` is differentiable through `_WKV`, a
`torch.autograd.Function` whose forward is the wkv kernel and whose
backward is the `wkv_bwd` kernel; on the CPU autograd differentiates
`wkv_ref`.
"""

from __future__ import annotations

import torch

from ..intersect.ops import resolve_device
from .kernel import wkv_bwd_cuda, wkv_cuda
from .ref import wkv_ref


class _WKV(torch.autograd.Function):
    """The wkv kernel forward, `wkv_bwd` backward: gradients for r, k, v,
    w, u and s0 from the output's and the final state's."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.set_materialize_grads(False)
        out, s_fin = wkv_cuda(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0)
        return out, s_fin

    @staticmethod
    def backward(ctx, dout, ds_fin):
        r, k, v, w, u, s0 = ctx.saved_tensors
        dout = (torch.zeros(r.shape, dtype=torch.float32, device=r.device)
                if dout is None else dout.contiguous())
        return wkv_bwd_cuda(
            r, k, v, w, u, s0, dout,
            None if ds_fin is None else ds_fin.contiguous())


def wkv(r, k, v, w, u, s0=None, *, impl: str = "cuda", device="cuda"
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The wkv recurrence on `device`; returns (out (B, S, H, dh) float32,
    final state (B, H, dh, dh) float32). r, k, v are cast to r's dtype.
    On the card, gradients reach every input through the `wkv_bwd`
    kernel."""
    if impl not in ("cuda", "ref"):
        raise ValueError(f"impl must be 'cuda' or 'ref', not {impl!r}")
    dev = resolve_device(device)
    r = torch.as_tensor(r).to(dev)
    k, v = (torch.as_tensor(x).to(dev, r.dtype) for x in (k, v))
    w, u = (torch.as_tensor(x).to(dev) for x in (w, u))
    s0 = None if s0 is None else torch.as_tensor(s0).to(dev)
    for name, x in (("w", w), ("u", u), ("s0", s0)):
        if x is not None and x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {x.dtype}")
    if impl == "ref" or dev.type != "cuda":
        return wkv_ref(r, k, v, w, u, s0)
    args = (r.contiguous(), k.contiguous(), v.contiguous(), w.contiguous(),
            u.contiguous(), None if s0 is None else s0.contiguous())
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad
                                       for x in args):
        return _WKV.apply(*args)
    return wkv_cuda(*args)
