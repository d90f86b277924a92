"""Train, prefill and decode steps for any (arch × shape) cell
(`repro/launch/steps.py`), as eager callables.

`apply_variant` is the JAX package's pure config function. The step
makers return a `StepBundle` whose `fn` runs for real on the parameters'
device, and the axis rules it runs under: with `mesh` (a `DeviceMesh`,
`launch.mesh`) the rules of the variant's sharding profile, and the
caller places the parameters with `bundle.distribute(params)`; without
one, `NULL_RULES` and one card, as before. `bundle.abstract_args` are
the step's arguments at its shape cell as meta tensors (DTensors under a
mesh), which the dry-run (`launch/dryrun.py`) calls `fn` with. Eager
code has no donation: AdamW updates the train state in place, and an
unsharded decode step writes its cache in place, which the dry-run
reports as aliased bytes.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import cached_property, partial
from typing import Any, Callable

import torch

from ..configs import SHAPES, ModelConfig
from ..models import build_model, input_specs
from ..models.common import NULL_RULES, AxisRules, abstract_params, \
    distribute_params, rules_for, tree_map
from ..training.optimizer import OptimizerConfig
from ..training.train_loop import make_train_step as _train_step


@dataclass
class StepBundle:
    fn: Callable
    model: Any
    rules: AxisRules = NULL_RULES
    cell: str = "train_4k"         # the shape cell of `abstract_args`

    def distribute(self, params):
        """`params` (whole on every rank) placed by the bundle's rules."""
        return distribute_params(params, self.model.param_desc(), self.rules)

    @cached_property
    def abstract_args(self) -> tuple:
        """`fn`'s arguments at the bundle's cell, in its order, as meta
        tensors (DTensors placed by the rules under a mesh): ({"params",
        "opt"}, batch) for a train step, (params, batch) for prefill,
        (params, cache, batch) for decode. The scalars an eager step reads
        on the host, AdamW's step count and the cache's position, are CPU
        tensors."""
        desc = self.model.param_desc()
        params = abstract_params(desc, self.rules)
        specs = input_specs(self.model.cfg, self.cell, self.rules)
        step = SHAPES[self.cell].step
        if step == "train":
            moments = tree_map(lambda d: replace(d, dtype=torch.float32),
                               desc)
            opt = {"m": abstract_params(moments, self.rules),
                   "v": abstract_params(moments, self.rules),
                   "step": torch.zeros((), dtype=torch.int32)}
            return {"params": params, "opt": opt}, specs["batch"]
        if step == "prefill":
            return params, specs["batch"]
        cache = dict(specs["cache"], pos=torch.zeros((), dtype=torch.int32))
        return params, cache, specs["batch"]


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
                    grad_dtype: str = "fp32", *, mesh=None,
                    profile: str = "baseline") -> StepBundle:
    """(state, batch) -> (state, metrics), state = {"params", "opt"}. The
    gradients are pinned to the parameters' placements under a mesh, and
    rounded to bf16 with `grad_dtype` "bf16"."""
    rules = rules_for(mesh, profile)
    model = build_model(cfg)
    return StepBundle(fn=_train_step(model, opt_cfg or OptimizerConfig(),
                                     grad_dtype, rules), model=model,
                      rules=rules, cell="train_4k")


def make_prefill_step(cfg: ModelConfig, *, mesh=None,
                      profile: str = "baseline",
                      cell_name: str = "prefill_32k") -> StepBundle:
    """(params, batch) -> (last-position logits, cache)."""
    rules = rules_for(mesh, profile)
    model = build_model(cfg)
    fn = model.prefill if mesh is None else partial(model.prefill,
                                                    rules=rules)
    return StepBundle(fn=fn, model=model, rules=rules, cell=cell_name)


def make_decode_step(cfg: ModelConfig, *, mesh=None,
                     profile: str = "baseline",
                     cell_name: str = "decode_32k") -> StepBundle:
    """(params, cache, batch) -> (logits, cache)."""
    rules = rules_for(mesh, profile)
    model = build_model(cfg)
    fn = model.decode_step if mesh is None else partial(model.decode_step,
                                                        rules=rules)
    return StepBundle(fn=fn, model=model, rules=rules, cell=cell_name)


def make_step(cfg: ModelConfig, cell_name: str,
              variant: str = "baseline", *, mesh=None) -> StepBundle:
    cfg, profile, grad_dtype = apply_variant(cfg, cell_name, variant)
    step = SHAPES[cell_name].step
    if step == "train":
        return make_train_step(cfg, grad_dtype=grad_dtype, mesh=mesh,
                               profile=profile)
    if step == "prefill":
        return make_prefill_step(cfg, mesh=mesh, profile=profile,
                                 cell_name=cell_name)
    return make_decode_step(cfg, mesh=mesh, profile=profile,
                            cell_name=cell_name)
