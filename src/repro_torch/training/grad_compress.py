"""Gradient compression for the data-parallel reduction
(`repro/training/grad_compress.py`): gradients cast to bf16 before the
reduction, and per-tensor int8 with error feedback (the quantization
error is added back the next step instead of accumulating). Over trees
of tensors; one card has no reduction yet (sharding is ROADMAP queue 1,
item 7), so these change what a step's gradients are, as in the JAX
package's single-device runs.
"""

from __future__ import annotations

from typing import Any

import torch

from ..models.common import tree_leaves, tree_map, tree_unflatten


def bf16_compress(grads: Any) -> Any:
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def int8_compress(grads: Any) -> tuple[Any, Any]:
    """Per-tensor symmetric int8: (quantized, float32 0-dim scales)."""
    def q(g):
        g32 = g.float()
        scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
        return torch.clamp(torch.round(g32 / scale), -127, 127).to(
            torch.int8), scale

    pairs = [q(g) for g in tree_leaves(grads)]
    return (tree_unflatten(grads, [p[0] for p in pairs]),
            tree_unflatten(grads, [p[1] for p in pairs]))


def int8_decompress(quant: Any, scales: Any) -> Any:
    return tree_unflatten(quant, [q.float() * s for q, s in
                              zip(tree_leaves(quant), tree_leaves(scales))])


def ef_compress_step(grads: Any, residual: Any) -> tuple[Any, Any]:
    """Error-feedback int8: compress (grad + residual), keep the error.
    Returns (the decompressed gradients for the optimizer, the new
    residual)."""
    with_res = tree_unflatten(grads, [g.float() + r for g, r in
                                  zip(tree_leaves(grads),
                                      tree_leaves(residual))])
    quant, scales = int8_compress(with_res)
    decomp = int8_decompress(quant, scales)
    new_residual = tree_unflatten(grads, [w - d for w, d in
                                      zip(tree_leaves(with_res),
                                          tree_leaves(decomp))])
    return decomp, new_residual


def init_residual(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
