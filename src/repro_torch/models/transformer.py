"""Decoder-only transformer LM: the dense and MoE architectures.

Mirrors `repro/models/transformer.py` (prefill, decode step, cache
layout) over a tree of tensors. Parameters keep the JAX package's layout:
each layer parameter carries a leading `n_layers` axis, and the JAX
`scan` over layers becomes a Python loop over that axis. Attention goes
through `kernels.attention.ops.attention` with explicit positions: on a
card, the hand-written flash kernel (or, with `attn_impl="ref"`, its
plain PyTorch version, for comparison).

The KV cache is {"k", "v": (L, B, T, KV, dh) bf16, "kpos": (T,) int32
absolute position per slot, -1 for empty, "pos": () int32 on the host,
the next position}. Unlike the JAX model, `decode_step` writes the new
token's K/V into the cache's tensors in place rather than copying the
whole cache each step. A layer takes the MoE FFN where the JAX model
does (`moe.every == 1`). Not ported yet (ROADMAP queue 1, item 7): the
int8 KV cache, VLM inputs with M-RoPE, sliding-window rolling caches
(so `mixtral-8x22b` raises), and the training loss.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels.attention.ops import attention
from . import blocks
from .common import Desc, stack_tree, tree_map

_LATER = "not ported yet (ROADMAP queue 1, item 7)"


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the parts of the JAX transformer this port lacks."""
    if cfg.kv_quant:
        raise NotImplementedError(f"{cfg.name}: the int8 KV cache is {_LATER}")
    if cfg.kind == "vlm" or cfg.rope == "mrope":
        raise NotImplementedError(f"{cfg.name}: VLM inputs and M-RoPE are "
                                  f"{_LATER}")
    if cfg.swa:
        raise NotImplementedError(f"{cfg.name}: sliding-window attention and "
                                  f"its rolling cache are {_LATER}")
    if cfg.kind not in ("dense", "moe"):
        raise NotImplementedError(f"{cfg.name}: kind {cfg.kind!r} is {_LATER}")


def _layer_desc(cfg: ModelConfig) -> dict:
    d = {
        "attn": blocks.attention_desc(cfg),
        "ln1": Desc((cfg.d_model,), init="ones"),
        "ln2": Desc((cfg.d_model,), init="ones"),
    }
    if cfg.moe is not None and cfg.moe.every == 1:
        d["moe"] = blocks.moe_desc(cfg)
    else:
        d["ffn"] = blocks.ffn_desc(cfg)
    return d


class TransformerModel:
    def __init__(self, cfg: ModelConfig, attn_impl: str = "cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.attn_impl = attn_impl

    # ------------------------------------------------------------ parameters
    def param_desc(self) -> dict:
        cfg = self.cfg
        return {
            "embed": Desc((cfg.vocab, cfg.d_model)),
            "lm_head": Desc((cfg.vocab, cfg.d_model)),
            "ln_f": Desc((cfg.d_model,), init="ones"),
            "layers": stack_tree(_layer_desc(cfg), cfg.n_layers),
        }

    def cache_desc(self, batch: int, cache_len: int) -> dict:
        cfg = self.cfg
        kv_shape = (cfg.n_layers, batch, cache_len, cfg.n_kv, cfg.dh)
        return {
            "k": Desc(kv_shape, init="zeros"),
            "v": Desc(kv_shape, init="zeros"),
            # -1 marks an empty slot (masked out by the attention)
            "kpos": Desc((cache_len,), init="full", scale=-1,
                         dtype=torch.int32),
            "pos": Desc((), init="zeros", dtype=torch.int32),
        }

    # ---------------------------------------------------------------- layers
    def _layer(self, x, lp, cos, sin, kv_fn):
        """One pre-norm block. `kv_fn(k, v)` returns the keys/values to
        attend to and their positions, and the query positions."""
        cfg = self.cfg
        h = blocks.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = blocks.qkv_project(h, lp["attn"], cfg)
        q = blocks.apply_rope(q, cos, sin)
        k = blocks.apply_rope(k, cos, sin)
        k_all, v_all, q_pos, kv_pos = kv_fn(k, v)
        attn = attention(q, k_all, v_all, causal=True, window=cfg.swa,
                         q_positions=q_pos, kv_positions=kv_pos,
                         impl=self.attn_impl, device=q.device)
        x = x + blocks.attn_out(attn, lp["attn"])
        h = blocks.rms_norm(x, lp["ln2"], cfg.norm_eps)
        if "moe" in lp:
            return x + blocks.moe_ffn(h, lp["moe"], cfg)
        return x + blocks.swiglu_ffn(h, lp["ffn"])

    def _logits(self, params, x):
        x = blocks.rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        return (x[:, -1] @ params["lm_head"].T).float()

    # --------------------------------------------------------------- prefill
    def prefill(self, params, batch, pad_to: int | None = None):
        """Full-prompt forward; returns (last-position logits (B, vocab)
        float32, KV cache). `pad_to` grows the cache beyond the prompt so
        decode_step has room (empty slots carry kpos = -1)."""
        cfg = self.cfg
        embed = params["embed"]
        tokens = torch.as_tensor(batch["tokens"], device=embed.device)
        B, S = tokens.shape
        T = max(S, pad_to or 0)
        x = embed[tokens]
        positions = torch.arange(S, dtype=torch.int32, device=embed.device)
        cos, sin = blocks.rope_cos_sin(positions, cfg.dh, cfg.rope_theta)
        shape = (cfg.n_layers, B, T, cfg.n_kv, cfg.dh)
        ks = torch.zeros(shape, dtype=torch.bfloat16, device=embed.device)
        vs = torch.zeros_like(ks)

        for i in range(cfg.n_layers):
            def kv_fn(k, v, i=i):
                ks[i, :, :S] = k.to(torch.bfloat16)
                vs[i, :, :S] = v.to(torch.bfloat16)
                return k, v, positions, positions
            lp = tree_map(lambda w: w[i], params["layers"])
            x = self._layer(x, lp, cos, sin, kv_fn)

        kpos = torch.full((T,), -1, dtype=torch.int32, device=embed.device)
        kpos[:S] = positions
        cache = {"k": ks, "v": vs, "kpos": kpos,
                 "pos": torch.tensor(S, dtype=torch.int32)}
        return self._logits(params, x), cache

    # ---------------------------------------------------------------- decode
    def decode_step(self, params, cache, batch):
        """One token for every sequence in the batch against the cache;
        returns (logits (B, vocab) float32, the updated cache)."""
        cfg = self.cfg
        embed = params["embed"]
        pos = int(cache["pos"])
        tokens = torch.as_tensor(batch["tokens"], device=embed.device)
        x = embed[tokens]                                  # (B, 1, D)
        ks, vs = cache["k"], cache["v"]
        T = ks.shape[2]
        slot = min(pos, T - 1)
        kpos = cache["kpos"].clone()
        kpos[slot] = pos
        q_pos = kpos[slot:slot + 1]                        # (1,) == pos
        cos, sin = blocks.rope_cos_sin(q_pos, cfg.dh, cfg.rope_theta)

        for i in range(cfg.n_layers):
            def kv_fn(k, v, i=i):
                ks[i, :, slot] = k[:, 0].to(ks.dtype)
                vs[i, :, slot] = v[:, 0].to(vs.dtype)
                return ks[i], vs[i], q_pos, kpos
            lp = tree_map(lambda w: w[i], params["layers"])
            x = self._layer(x, lp, cos, sin, kv_fn)

        new_cache = {"k": ks, "v": vs, "kpos": kpos,
                     "pos": torch.tensor(pos + 1, dtype=torch.int32)}
        return self._logits(params, x), new_cache
