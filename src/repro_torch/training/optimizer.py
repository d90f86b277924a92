"""AdamW, learning-rate schedules and global-norm clipping over a tree
of tensors (`repro/training/optimizer.py`).

This is the JAX package's update, not `torch.optim.AdamW`: moments are
float32 whatever the weights' dtype (bf16 weights stay bf16), gradients
are clipped by the global norm of the whole tree, a leaf with ndim < 2
(norms, biases) is never decayed, and the decay is applied as
p32 - lr·(m̂ / (√v̂ + eps) + wd·p32). JAX returns new arrays and donates
the old ones; here `adamw_update` updates the moments and the weights in
place (the weights keep their dtype) and returns the same tensors, so a
step holds one float32 temporary a leaf at a time. The same code runs on
DTensor parameters and moments (a sharded step): each rank updates its
shards, and the global norm's sum is reduced across ranks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..models.common import whole, tree_leaves, tree_map


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"           # cosine | linear | constant
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    min_lr_frac: float = 0.1


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def schedule_lr(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at `step` (float32 0-dim tensor): linear warmup,
    then cosine or linear decay to `min_lr_frac`, or constant."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_frac) * frac
    else:
        decay = _f32(1.0)
    return cfg.lr * warm * decay


def init_opt_state(params: Any) -> dict:
    """float32 zero moments shaped as `params`, and step 0 (int32)."""
    def zeros32(p):
        return torch.zeros_like(p, dtype=torch.float32)
    leaf = next(iter(tree_leaves(params)), None)
    return {"m": tree_map(zeros32, params), "v": tree_map(zeros32, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=None if leaf is None else leaf.device)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    leaves = tree_leaves(tree)
    if not leaves:
        return _f32(0.0)
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in leaves))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, opt_state: dict,
                 cfg: OptimizerConfig) -> tuple[Any, dict, dict]:
    """One AdamW step, in place; returns (params, opt_state, metrics)
    with metrics {"grad_norm", "lr"} as float32 0-dim tensors."""
    step = whole(opt_state["step"]) + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0) \
        if cfg.clip_norm else _f32(1.0).to(gnorm.device)
    lr = schedule_lr(cfg, step.cpu()).to(gnorm.device)
    stepf = step.float()
    b1c = 1 - torch.pow(_f32(cfg.b1).to(stepf.device), stepf)
    b2c = 1 - torch.pow(_f32(cfg.b2).to(stepf.device), stepf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        g32 = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
        del g32
        upd = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        p32 = p.float()
        if p.dim() >= 2 and cfg.weight_decay:       # no decay on norms
            upd.add_(cfg.weight_decay * p32)
        p.copy_(p32.sub_(lr * upd))
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
