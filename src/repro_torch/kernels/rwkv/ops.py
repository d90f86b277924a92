"""RWKV-6 wkv entry point in the model's layout.

r, k, v, w (B, S, H, dh); u (H, dh); optional s0 (B, H, dh, dh). A CUDA
tensor goes to the hand-written kernel (`kernel.wkv_cuda`) — or, with
`impl="ref"`, to the plain PyTorch version on the card, for comparison; a
CPU tensor takes the plain version. Nothing falls back: without a card
`device="cuda"` raises. w, u and s0 must be float32 on either device, as
the kernel takes them.
"""

from __future__ import annotations

import torch

from ..intersect.ops import resolve_device
from .kernel import wkv_cuda
from .ref import wkv_ref


def wkv(r, k, v, w, u, s0=None, *, impl: str = "cuda", device="cuda"
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The wkv recurrence on `device`; returns (out (B, S, H, dh) float32,
    final state (B, H, dh, dh) float32). r, k, v are cast to r's dtype."""
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
    return wkv_cuda(r.contiguous(), k.contiguous(), v.contiguous(),
                    w.contiguous(), u.contiguous(),
                    None if s0 is None else s0.contiguous())
