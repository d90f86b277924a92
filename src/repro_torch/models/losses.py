"""The language-model loss: next-token cross-entropy from the final
hidden states, blockwise over the sequence (`repro/models/losses.py`).

Full (B, S, V) logits are never materialised: each chunk of `chunk`
positions projects onto the vocabulary, takes its log-sum-exp and its
label logits, and only the sums leave it. With gradients on, each chunk
runs under `torch.utils.checkpoint`, so its (B, chunk, V) float32 logits
are recomputed in backward instead of kept for every chunk (at V =
151,936, B = 2, S = 4096 that would be 5 GB). The products stay
`torch.matmul`, as the JAX package leaves them to XLA outside any Pallas
kernel. The logits are the JAX package's `preferred_element_type=float32`
product: on a card, bf16 operands go to the tensor cores with a float32
output (`torch.mm(..., out_dtype=torch.float32)`), and so do meta
tensors, so that the dry-run counts the card's ops; elsewhere both are
cast to float32 first, which gives the same products. Their gradients
are float32 products, as autograd of the float32 cast computes them.

Under a mesh (`rules`) the projection runs on each rank's local shards
(`rules.local`): the chunk's rows over "dp", the vocabulary over "tp",
so each rank projects onto its slice of `lm_head` and the logits come
out vocab-sharded, as the JAX package constrains them. The hidden
states' gradient is then a partial sum over the "tp" ranks and
`lm_head`'s over the "dp" ranks. The log-sum-exp over the sharded
vocabulary reduces across ranks, and the label logit is the JAX
package's iota compare (a sharded sum) instead of a gather.

`set_bf16_grad_barrier(True)` routes the projection through
`_CEMatmulBF16Grad`, the counterpart of the JAX `custom_vjp`: float32
logits forward, but the logits' gradient is cast to bfloat16 before the
products of the backward, so the rest of the backward runs in bf16.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .common import NULL_RULES, AxisRules, replicating


def _logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, c, D) · w (V, D)^T → float32 (B, c, V)."""
    if x.device.type in ("cuda", "meta") \
            and x.dtype == w.dtype == torch.bfloat16:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w.T,
                       out_dtype=torch.float32)
        return out.view(*x.shape[:-1], w.shape[0])
    return x.float() @ w.float().T


class _Logits(torch.autograd.Function):
    """`_logits` with float32 gradients cast back to the operands'
    dtypes."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _logits(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = g @ w.float()
        dw = g.reshape(-1, g.shape[-1]).T \
            @ x.reshape(-1, x.shape[-1]).float()
        return dx.to(x.dtype), dw.to(w.dtype)


class _CEMatmulBF16Grad(torch.autograd.Function):
    """x (B, c, D) · w (V, D)^T with float32 logits and bf16 gradients."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _logits(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gb = g.to(torch.bfloat16)
        dx = gb @ w.to(torch.bfloat16)
        dw = torch.einsum("bcd,bcv->vd", x.to(torch.bfloat16), gb)
        return dx.to(x.dtype), dw.to(w.dtype)


_BF16_GRAD = [False]


def set_bf16_grad_barrier(enabled: bool) -> None:
    _BF16_GRAD[0] = bool(enabled)


def _ce_block(x_c: torch.Tensor, labels_c: torch.Tensor,
              lm_head: torch.Tensor, rules: AxisRules = NULL_RULES
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x_c (B, c, D); labels_c (B, c), -1 = ignore; lm_head (V, D) →
    (the chunk's summed CE over its valid labels, their count), float32."""
    fn = (_CEMatmulBF16Grad if _BF16_GRAD[0] else _Logits).apply
    if rules.mesh is not None:
        xpl = rules.placements(("dp", None, None), tuple(x_c.shape))
        wpl = rules.placements(("tp", None), tuple(lm_head.shape))
        lpl = rules.placements(("dp", None, "tp"), tuple(x_c.shape[:2])
                               + (lm_head.shape[0],))
        vocab = rules.split_by(("tp", None), lm_head.shape, 0)
        batch = rules.split_by(("dp", None, None), x_c.shape, 0)
        fn = rules.local(fn, ins=(xpl, wpl), outs=(lpl,),
                         grads=(rules.partial(xpl, vocab),
                                rules.partial(wpl, batch)))
    logits = fn(x_c, lm_head)
    m = logits.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    if rules.mesh is None:
        valid = labels_c >= 0
        ll = logits.gather(-1, labels_c.clamp(min=0).long()[..., None])[
            ..., 0]
    else:                    # label logit by iota compare: a sharded sum
        labels_c = rules.constrain(labels_c.long(), "dp", None)
        valid = labels_c >= 0
        iota = rules.replicated(torch.arange(
            logits.shape[-1], device=logits.device))
        ll = torch.where(iota == labels_c[..., None], logits,
                         torch.zeros_like(logits)).sum(-1)
    total = torch.where(valid, lse - ll, torch.zeros_like(lse)).sum()
    return total, valid.sum().float()


def chunked_cross_entropy(x: torch.Tensor, labels: torch.Tensor,
                          lm_head: torch.Tensor,
                          rules: AxisRules = NULL_RULES, chunk: int = 512
                          ) -> torch.Tensor:
    """Mean next-token CE from final hidden states, blockwise over S.

    x (B, S, D); labels (B, S) with -1 = ignore; lm_head (V, D). S must
    be at most `chunk` or a multiple of it, as in the JAX package."""
    B, S, D = x.shape
    labels = torch.as_tensor(labels, device=x.device)
    grad = torch.is_grad_enabled() and (x.requires_grad
                                        or lm_head.requires_grad)

    def block(x_c, l_c):
        if grad:
            return checkpoint(replicating(_ce_block), x_c, l_c, lm_head,
                              rules, use_reentrant=False)
        return _ce_block(x_c, l_c, lm_head, rules)

    if S <= chunk:
        total, count = block(x, labels)
        return total / count.clamp(min=1)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"CE chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        t, c = block(x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
        total, count = total + t, count + c
    return total / count.clamp(min=1)
