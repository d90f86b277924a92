"""Selective-scan entry point in the model's layout.

a, b (B, S, D, N); c (B, S, N); optional h0 (B, D, N); all float32. A
CUDA tensor goes to the hand-written kernel (`kernel.selective_scan_cuda`)
— or, with `impl="ref"`, to the plain PyTorch version on the card, for
comparison; a CPU tensor takes the plain version. Nothing falls back:
without a card `device="cuda"` raises. A non-float32 input raises on
either device, as the kernel would.
"""

from __future__ import annotations

import torch

from ..intersect.ops import resolve_device
from .kernel import check_inputs, selective_scan_cuda
from .ref import selective_scan_ref


def selective_scan(a, b, c, h0=None, *, impl: str = "cuda", device="cuda"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan on `device`; returns (y (B, S, D) float32, final state (B,
    D, N) float32)."""
    if impl not in ("cuda", "ref"):
        raise ValueError(f"impl must be 'cuda' or 'ref', not {impl!r}")
    dev = resolve_device(device)
    a, b, c = (torch.as_tensor(x).to(dev) for x in (a, b, c))
    h0 = None if h0 is None else torch.as_tensor(h0).to(dev)
    if impl == "ref" or dev.type != "cuda":
        check_inputs(a, b, c, h0)       # the kernel's wrapper checks its own
        return selective_scan_ref(a, b, c, h0)
    return selective_scan_cuda(a.contiguous(), b.contiguous(), c.contiguous(),
                               None if h0 is None else h0.contiguous())
