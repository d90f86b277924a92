"""Shared model machinery: parameter descriptors and initialisation, and
the training losses' per-layer rematerialisation (`remat`).

Parameters are described once as a tree (nested dicts) of `Desc` (shape,
dtype, initializer), as in the JAX package; `init_params` draws real
tensors from a `torch.Generator` under the same rules. The JAX package's
logical sharding (`AxisRules`, `NamedSharding`) has no counterpart yet:
this port runs on one card, and sharding over a DeviceMesh is ROADMAP
queue 1, item 7.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint


@dataclass(frozen=True)
class Desc:
    """One parameter: shape + dtype + init."""

    shape: tuple[int, ...]
    init: str = "normal"           # normal | scaled | zeros | ones | full
    dtype: torch.dtype = torch.bfloat16
    # std for normal and scaled (normal's default is 1/sqrt(fan_in)),
    # value for full
    scale: float | None = None

    def fan_in(self) -> int:
        return self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]


def stacked(desc: Desc, n: int) -> Desc:
    """Add a leading layer axis (parameters stacked over layers)."""
    return replace(desc, shape=(n,) + desc.shape)


def tree_map(fn, tree):
    """Apply `fn` to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order, the order `jax.tree` flattens dicts."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves: list):
    """A tree shaped as `tree` whose leaves, in `tree_leaves` order, are
    `leaves`."""
    it = iter(leaves)

    def take(node):
        if isinstance(node, dict):
            taken = {k: take(node[k]) for k in sorted(node)}
            return {k: taken[k] for k in node}
        return next(it)
    return take(tree)


def stack_tree(tree, n: int):
    return tree_map(lambda d: stacked(d, n), tree)


def _init_leaf(desc: Desc, generator: torch.Generator, device) -> torch.Tensor:
    if desc.init == "zeros":
        return torch.zeros(desc.shape, dtype=desc.dtype, device=device)
    if desc.init == "ones":
        return torch.ones(desc.shape, dtype=desc.dtype, device=device)
    if desc.init == "full":
        return torch.full(desc.shape, desc.scale, dtype=desc.dtype,
                          device=device)
    if desc.init not in ("normal", "scaled"):
        raise ValueError(f"unknown init {desc.init!r}")
    scale = desc.scale if desc.scale is not None else \
        1.0 / math.sqrt(max(desc.fan_in(), 1))
    x = torch.randn(desc.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(desc.dtype)


def init_params(tree, generator: torch.Generator, device="cuda") -> Any:
    """Tensors for a `Desc` tree on `device`, drawn from `generator` (which
    must live on that device) leaf by leaf in sorted-key order."""
    return tree_map(lambda d: _init_leaf(d, generator, device), tree)


def param_count(tree) -> int:
    """Exact count from a `Desc` or tensor tree."""
    return sum(math.prod(leaf.shape) for leaf in tree_leaves(tree))


def remat(cfg, fn, *args):
    """fn(*args), its activations recomputed in backward (JAX's
    `maybe_remat`) when `cfg.remat` is not "none" and a gradient can reach
    a tensor of `args` (trees included); otherwise a plain call, so that a
    serving path, whose weights need no gradient, never checkpoints."""
    if cfg.remat != "none" and torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for a in args for t in tree_leaves(a)):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)
