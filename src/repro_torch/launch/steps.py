"""Train, prefill and decode steps for any (arch × shape) cell
(`repro/launch/steps.py`), as eager callables.

`apply_variant` is the JAX package's pure config function. The step
makers return a `StepBundle` whose `fn` runs for real on the parameters'
device; the JAX package's abstract arguments, axis rules and donation
belong to its dry-run and to sharding (ROADMAP queue 1, items 7 and 9),
which the port does not have yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from ..configs import SHAPES, ModelConfig
from ..models import build_model
from ..training.optimizer import OptimizerConfig
from ..training.train_loop import make_train_step as _train_step


@dataclass
class StepBundle:
    fn: Callable
    model: Any


def apply_variant(cfg: ModelConfig, cell_name: str, variant: str
                  ) -> tuple[ModelConfig, str, str]:
    """Resolve a variant to (cfg, sharding profile, grad dtype), as the
    JAX package does: "baseline" keeps the config; "opt" gives dense and
    VLM decode the int8 KV cache (profile "decode_tp"), MoE prefill and
    training the grouped dispatch when the experts do not divide 16,
    training the full-sequence CE and bf16 gradients, and dense training
    the "fsdp_only" profile."""
    if variant != "opt":
        return cfg, "baseline", "fp32"
    step = SHAPES[cell_name].step
    grouped_moe = cfg.moe is not None and cfg.moe.n_experts % 16 != 0
    if step == "decode":
        if cfg.kind in ("dense", "vlm"):
            return cfg.with_(kv_quant=True), "decode_tp", "fp32"
        return cfg, "baseline", "fp32"
    if step == "prefill":
        if grouped_moe:
            cfg = cfg.with_(moe_impl="grouped")
        return cfg, "baseline", "fp32"
    cfg = cfg.with_(ce_chunk=1 << 20)
    if cfg.moe is not None:
        if grouped_moe:
            cfg = cfg.with_(moe_impl="grouped")
        return cfg, "baseline", "bf16"
    return cfg, "fsdp_only", "bf16"


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig | None = None,
                    grad_dtype: str = "fp32") -> StepBundle:
    """(state, batch) -> (state, metrics), state = {"params", "opt"}."""
    model = build_model(cfg)
    return StepBundle(fn=_train_step(model, opt_cfg or OptimizerConfig(),
                                     grad_dtype), model=model)


def make_prefill_step(cfg: ModelConfig) -> StepBundle:
    """(params, batch) -> (last-position logits, cache)."""
    model = build_model(cfg)
    return StepBundle(fn=model.prefill, model=model)


def make_decode_step(cfg: ModelConfig) -> StepBundle:
    """(params, cache, batch) -> (logits, cache)."""
    model = build_model(cfg)
    return StepBundle(fn=model.decode_step, model=model)


def make_step(cfg: ModelConfig, cell_name: str,
              variant: str = "baseline") -> StepBundle:
    cfg, _profile, grad_dtype = apply_variant(cfg, cell_name, variant)
    step = SHAPES[cell_name].step
    if step == "train":
        return make_train_step(cfg, grad_dtype=grad_dtype)
    if step == "prefill":
        return make_prefill_step(cfg)
    return make_decode_step(cfg)
