"""GQA-aware attention entry points in the model's layout.

q (B, S, H, dh); k, v (B, T, KV, dh) with H a multiple of KV. A CUDA
tensor goes to the hand-written kernels — or, with `impl="ref"`, to the
plain PyTorch versions on the card, for comparison; a CPU tensor takes
the plain version. Nothing falls back: without a card `device="cuda"`
raises. Unlike the JAX wrapper this one never repeats K/V: the kernels
map query head h to KV head h // (H // KV) by index.

A meta tensor takes the plain version too, unless a cost counter is
active (`kernels/_cost.py`): then it goes where a CUDA tensor goes, and
the kernel's wrapper records the call and only makes its outputs.

On the card `attention` is differentiable through `_FlashAttention`, a
`torch.autograd.Function` whose forward is the flash kernel and whose
backward is the `flash_bwd` kernel; on the CPU autograd differentiates
`attention_ref`. With `k_scale`/`v_scale` it is the int8 KV cache's
attention (`attention_int8`), forward only, as the JAX package uses it
(decode).
"""

from __future__ import annotations

import torch

from .._cost import counts_meta
from ..intersect.ops import resolve_device
from .kernel import (flash_attention, flash_bwd, flash_decode_int8,
                     forward_lse)
from .ref import attention_bwd_ref, attention_int8_ref, attention_ref


def _positions(dev, *positions):
    return tuple(None if p is None else torch.as_tensor(p).to(dev, torch.int32)
                 for p in positions)


def _contig(p):
    return None if p is None else p.contiguous()


class _FlashAttention(torch.autograd.Function):
    """The flash kernel forward, `flash_bwd` backward; positions and masks
    are not differentiated. Where the forward runs the prefill kernel
    (`forward_lse`) it also writes the rows' log-sum-exp, which the
    backward takes instead of recomputing it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_positions, kv_positions):
        lse = torch.empty(q.shape[:3], dtype=torch.float32,
                          device=q.device) if forward_lse(q, k) else None
        out = flash_attention(q, k, v, causal=causal, window=window,
                              q_positions=q_positions,
                              kv_positions=kv_positions, lse=lse)
        ctx.save_for_backward(q, k, v, out, q_positions, kv_positions, lse)
        ctx.masks = (causal, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, q_positions, kv_positions, lse = ctx.saved_tensors
        causal, window = ctx.masks
        dq, dk, dv = flash_bwd(q, k, v, out, dout.contiguous(),
                               causal=causal, window=window,
                               q_positions=q_positions,
                               kv_positions=kv_positions, lse=lse)
        return dq, dk, dv, None, None, None, None


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              q_positions=None, kv_positions=None, k_scale=None,
              v_scale=None, impl: str = "cuda", device="cuda"
              ) -> torch.Tensor:
    """Attention on `device`; returns (B, S, H, dh) in q's dtype.

    `q_positions` (S,) or (B, S) and `kv_positions` (T,) or (B, T) are
    absolute token positions (negative = empty cache slot), one row
    shared by the batch or one a batch row; without them the ends of the
    query and key ranges are aligned. K/V are cast to q's dtype first (a
    bf16 cache against float32 queries) — unless `k_scale`/`v_scale` (B,
    T, KV) are given: then k, v are the int8 cache and `attention_int8`
    computes the result. On the card, gradients reach q, k and v through
    the `flash_bwd` kernel."""
    if k_scale is not None or v_scale is not None:
        return attention_int8(q, k, v, k_scale, v_scale, causal=causal,
                              window=window, q_positions=q_positions,
                              kv_positions=kv_positions, impl=impl,
                              device=device)
    if impl not in ("cuda", "ref"):
        raise ValueError(f"impl must be 'cuda' or 'ref', not {impl!r}")
    dev = resolve_device(device)
    q = torch.as_tensor(q).to(dev)
    k, v = (torch.as_tensor(x).to(dev, q.dtype) for x in (k, v))
    q_positions, kv_positions = _positions(dev, q_positions, kv_positions)
    if impl == "ref" or dev.type != "cuda" and not counts_meta(dev):
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_positions=q_positions,
                             kv_positions=kv_positions)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    q_positions, kv_positions = _contig(q_positions), _contig(kv_positions)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, q_positions,
                                     kv_positions)
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_positions=q_positions,
                           kv_positions=kv_positions)


def attention_int8(q, k, v, k_scale, v_scale, *, causal: bool = True,
                   window: int | None = None, q_positions=None,
                   kv_positions=None, impl: str = "cuda", device="cuda"
                   ) -> torch.Tensor:
    """Attention of q (B, S, H, dh) against the int8 KV cache k, v (B, T,
    KV, dh) with bf16 scales (B, T, KV), as the JAX package's
    `blockwise_attention` computes it with `k_scale`/`v_scale`; returns
    (B, S, H, dh) in q's dtype. On a card the `flash_decode_int8` kernel
    (S·H/KV <= 64 rows per KV head: decode), else `attention_int8_ref`."""
    if impl not in ("cuda", "ref"):
        raise ValueError(f"impl must be 'cuda' or 'ref', not {impl!r}")
    dev = resolve_device(device)
    q = torch.as_tensor(q).to(dev)
    k, v = (torch.as_tensor(x).to(dev, torch.int8) for x in (k, v))
    k_scale, v_scale = (torch.as_tensor(x).to(dev, torch.bfloat16)
                        for x in (k_scale, v_scale))
    q_positions, kv_positions = _positions(dev, q_positions, kv_positions)
    if impl == "ref" or dev.type != "cuda" and not counts_meta(dev):
        return attention_int8_ref(q, k, v, k_scale, v_scale, causal=causal,
                                  window=window, q_positions=q_positions,
                                  kv_positions=kv_positions)
    return flash_decode_int8(
        q.contiguous(), k.contiguous(), v.contiguous(),
        k_scale.contiguous(), v_scale.contiguous(), causal=causal,
        window=window, q_positions=_contig(q_positions),
        kv_positions=_contig(kv_positions))


def attention_bwd(q, k, v, out, dout, *, causal: bool = True,
                  window: int | None = None, q_positions=None,
                  kv_positions=None, impl: str = "cuda", device="cuda"
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of `attention(q, k, v, ...)` at output
    `out` for the output's gradient `dout`, in the inputs' dtype: the
    `flash_bwd` kernel on a card, else `attention_bwd_ref`. All five
    tensors share one dtype (bfloat16 or float32)."""
    if impl not in ("cuda", "ref"):
        raise ValueError(f"impl must be 'cuda' or 'ref', not {impl!r}")
    dev = resolve_device(device)
    q, k, v, out, dout = (torch.as_tensor(x).to(dev)
                          for x in (q, k, v, out, dout))
    q_positions, kv_positions = _positions(dev, q_positions, kv_positions)
    if impl == "ref" or dev.type != "cuda" and not counts_meta(dev):
        return attention_bwd_ref(q, k, v, out, dout, causal=causal,
                                 window=window, q_positions=q_positions,
                                 kv_positions=kv_positions)
    return flash_bwd(*(x.contiguous() for x in (q, k, v, out, dout)),
                     causal=causal, window=window,
                     q_positions=_contig(q_positions),
                     kv_positions=_contig(kv_positions))
