"""Fault-tolerant training loop: data pipeline → train step → checkpoints
(`repro/training/train_loop.py`).

Deterministic `IndexedCorpusLoader` batches, an eager train step (the
loss's gradients by autograd — on a card the attention's by the
`flash_bwd` kernel — then AdamW in place), periodic checkpoints to the
blob store (async by default), and auto-resume from the latest complete
checkpoint: `run` survives kill-and-restart at a checkpointed step and
continues from the same state with the same batches. An eager step
replaces `jax.jit`, and AdamW's update in place replaces the donation of
the old state, so `run` updates the `params` it is given.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from ..models.common import tree_leaves, tree_unflatten
from .checkpoint import CheckpointManager
from .grad_compress import bf16_compress
from .optimizer import OptimizerConfig, adamw_update, init_opt_state


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    log_every: int = 10
    async_checkpoint: bool = True


@dataclass
class TrainLog:
    steps: list = field(default_factory=list)
    losses: list = field(default_factory=list)
    grad_norms: list = field(default_factory=list)
    resumed_from: int | None = None
    # host seconds from the end of one logged step to the end of the next
    # (a logged step reads its loss back, so on a card it has finished)
    seconds: list = field(default_factory=list)


def make_train_step(model, opt_cfg: OptimizerConfig,
                    grad_dtype: str = "fp32") -> Callable:
    """(state, batch) -> (state, metrics), state = {"params", "opt"}: the
    loss and its gradients, optionally cast to bf16 (`grad_dtype`
    "bf16", the JAX package's compressed reduction), then AdamW in
    place. metrics: "loss", "grad_norm", "lr" (0-dim tensors)."""
    def train_step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        try:
            loss = model.loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for leaf in leaves:
                leaf.requires_grad_(False)
        grads = tree_unflatten(params, list(grads))
        if grad_dtype == "bf16":
            grads = bf16_compress(grads)
        params, opt, metrics = adamw_update(params, grads, state["opt"],
                                            opt_cfg)
        metrics["loss"] = loss.detach()
        return {"params": params, "opt": opt}, metrics

    return train_step


def _device(params):
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def run(model, params, loader, ckpt: CheckpointManager | None,
        loop_cfg: TrainLoopConfig, opt_cfg: OptimizerConfig,
        ) -> tuple[dict, TrainLog]:
    """Train; resumes from the latest checkpoint if one exists. Batches go
    to the parameters' device."""
    state = {"params": params, "opt": init_opt_state(params)}
    log = TrainLog()
    start = 0
    if ckpt is not None:
        latest = ckpt.latest_step()
        if latest is not None:
            state, _manifest = ckpt.restore(state, step=latest)
            start = latest
            log.resumed_from = latest

    dev = _device(state["params"])
    step_fn = make_train_step(model, opt_cfg)
    t_last = time.perf_counter()
    for step, batch in loader.batches(start, loop_cfg.total_steps - start):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        state, metrics = step_fn(state, batch)
        if (step + 1) % loop_cfg.log_every == 0 or step == start:
            log.steps.append(step + 1)
            log.losses.append(float(metrics["loss"]))
            log.grad_norms.append(float(metrics["grad_norm"]))
            now = time.perf_counter()
            log.seconds.append(now - t_last)
            t_last = now
        if ckpt is not None and (step + 1) % loop_cfg.checkpoint_every == 0:
            ckpt.save(step + 1, state,
                      blocking=not loop_cfg.async_checkpoint)
    if ckpt is not None:
        ckpt.wait()
    return state, log
