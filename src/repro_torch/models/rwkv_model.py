"""RWKV-6 language model: embedding + stacked rwkv layers + head.

Mirrors `repro/models/rwkv_model.py` (prefill, decode step, cache
layout). The JAX `scan` over the stacked layers becomes a Python loop
over their leading axis, as in `transformer.py`. The recurrent state has
a fixed size, whatever the prompt's length: the cache is {"states":
{"shift_t", "shift_c": (L, B, D) in the activations' dtype, "S": (L, B,
H, dh, dh) float32}, "pos": () int32 on the host}, and `prefill` takes
no `pad_to`. `decode_step` returns new state tensors and leaves the
cache it was given as it was.

`loss_fn` is the training forward: embeddings, the layers from a zero
state (each under `torch.utils.checkpoint` unless `cfg.remat` is
"none", as JAX's `maybe_remat` scan body), the final layer norm and the
chunked cross-entropy. On a card its wkv is differentiated by the
`wkv_bwd` kernel.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .blocks import embed
from .common import NULL_RULES, AxisRules, Desc, remat, stack_tree, tree_map
from .losses import chunked_cross_entropy
from .rwkv6 import layer_norm, rwkv_layer, rwkv_layer_desc, rwkv_state_desc


class RWKVModel:
    def __init__(self, cfg: ModelConfig, wkv_impl: str = "cuda"):
        if cfg.kind != "rwkv":
            raise ValueError(f"{cfg.name} is kind {cfg.kind!r}, not 'rwkv'")
        self.cfg = cfg
        self.wkv_impl = wkv_impl

    def param_desc(self) -> dict:
        cfg = self.cfg
        return {
            "embed": Desc((cfg.vocab, cfg.d_model), ("tp", "fsdp")),
            "lm_head": Desc((cfg.vocab, cfg.d_model), ("tp", "fsdp")),
            "ln0_w": Desc((cfg.d_model,), (None,), init="ones"),
            "ln0_b": Desc((cfg.d_model,), (None,), init="zeros"),
            "lnf_w": Desc((cfg.d_model,), (None,), init="ones"),
            "lnf_b": Desc((cfg.d_model,), (None,), init="zeros"),
            "layers": stack_tree(rwkv_layer_desc(cfg), cfg.n_layers),
        }

    def cache_desc(self, batch: int, cache_len: int) -> dict:
        del cache_len                    # constant-size state (the point)
        return {
            "states": stack_tree(rwkv_state_desc(self.cfg, batch),
                                 self.cfg.n_layers),
            "pos": Desc((), (), init="zeros", dtype=torch.int32),
        }

    def _embed(self, params, tokens, rules=NULL_RULES):
        table = params["embed"]
        x = embed(torch.as_tensor(tokens, device=table.device), table, rules)
        x = layer_norm(x, params["ln0_w"], params["ln0_b"], self.cfg.norm_eps)
        return rules.constrain(x, "dp", None, None)

    def _logits(self, params, x):
        x = layer_norm(x, params["lnf_w"], params["lnf_b"], self.cfg.norm_eps)
        return (x[:, -1] @ params["lm_head"].T).float()

    def _layers(self, params, x, states=None, rules=NULL_RULES):
        """Every layer in turn; returns x and the stacked new states."""
        new = []
        for i in range(self.cfg.n_layers):
            lp = tree_map(lambda a: a[i], params["layers"])
            state = None if states is None else {k: v[i]
                                                 for k, v in states.items()}
            x, st = rwkv_layer(x, lp, self.cfg, state, self.wkv_impl, rules)
            new.append(st)
        return x, {k: torch.stack([st[k] for st in new]) for k in new[0]}

    def loss_fn(self, params, batch, rules: AxisRules = NULL_RULES
                ) -> torch.Tensor:
        """Mean next-token cross-entropy of `batch` ({"tokens", "labels"
        (B, S), -1 = ignore}), float32 scalar (replicated under a
        mesh)."""
        cfg = self.cfg

        def layer(x, lp):
            return rwkv_layer(x, lp, cfg, None, self.wkv_impl, rules)[0]

        with rules.scope():
            x = self._embed(params, batch["tokens"], rules)
            for i in range(cfg.n_layers):
                lp = tree_map(lambda a: a[i], params["layers"])
                x = remat(cfg, layer, x, lp)
            x = layer_norm(x, params["lnf_w"], params["lnf_b"], cfg.norm_eps)
            return chunked_cross_entropy(x, batch["labels"],
                                         params["lm_head"], rules,
                                         chunk=cfg.ce_chunk)

    def prefill(self, params, batch, rules: AxisRules = NULL_RULES):
        """Full-prompt forward from a zero state; returns (last-position
        logits (B, vocab) float32, cache)."""
        tokens = batch["tokens"]
        with rules.scope():
            x, states = self._layers(params,
                                     self._embed(params, tokens, rules),
                                     rules=rules)
            cache = {"states": states,
                     "pos": torch.tensor(tokens.shape[1], dtype=torch.int32)}
            return self._logits(params, x), cache

    def decode_step(self, params, cache, batch,
                    rules: AxisRules = NULL_RULES):
        """One token for every sequence in the batch from the cached
        state; returns (logits (B, vocab) float32, the new cache)."""
        with rules.scope():
            x = self._embed(params, batch["tokens"], rules)   # (B, 1, D)
            x, states = self._layers(params, x, cache["states"], rules)
            return self._logits(params, x), {
                "states": states,
                "pos": torch.tensor(int(cache["pos"]) + 1,
                                    dtype=torch.int32)}
