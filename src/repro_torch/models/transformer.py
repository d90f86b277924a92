"""Decoder-only transformer LM: the dense, MoE and VLM architectures.

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
does (`moe.every == 1`).

With a sliding window (`cfg.swa`, Mixtral) `cache_desc` gives a rolling
cache of min(cache_len, swa) slots and `decode_step` writes position
pos to slot pos % T, so the slots' positions are not sorted; without
one it writes to min(pos, T - 1). Prefill fills a cache of S + pad
slots and never wraps, as the JAX model's does.

A VLM (Qwen2-VL) takes `batch["patches"]` (B, S_img, D), put in front of
the token embeddings, and M-RoPE ids `batch["positions"]` (B, S, 3) at
prefill, (B, 1, 3) at decode; queries sit at the temporal ids
(positions[..., 0], one row of positions a batch row). As in the JAX
model, the prefill cache's `kpos` is batch row 0's temporal ids and a
decode step writes the scalar `pos`, not the token's M-RoPE id, into
`kpos` (ROADMAP §3). Not ported yet: the int8 KV cache (ROADMAP queue
1, item 7) and the training loss (item 9).
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
    if cfg.kind not in ("dense", "moe", "vlm"):
        raise ValueError(f"{cfg.name} is kind {cfg.kind!r}, not a "
                         "decoder-only transformer")
    if cfg.kv_quant:
        raise NotImplementedError(f"{cfg.name}: the int8 KV cache is {_LATER}")


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
        """An empty cache; a rolling one of min(cache_len, swa) slots
        under a sliding window."""
        cfg = self.cfg
        T = min(cache_len, cfg.swa) if cfg.swa else cache_len
        kv_shape = (cfg.n_layers, batch, T, cfg.n_kv, cfg.dh)
        return {
            "k": Desc(kv_shape, init="zeros"),
            "v": Desc(kv_shape, init="zeros"),
            # -1 marks an empty slot (masked out by the attention)
            "kpos": Desc((T,), init="full", scale=-1, dtype=torch.int32),
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

    def _embed(self, params, batch):
        """Embeddings (B, S, D) and positions: a VLM's patches go in front
        of its tokens, its M-RoPE ids (B, S, 3) come from the batch; else
        arange(S)."""
        embed = params["embed"]
        x = embed[torch.as_tensor(batch["tokens"], device=embed.device)]
        if self.cfg.kind == "vlm":
            patches = torch.as_tensor(batch["patches"], device=embed.device)
            x = torch.cat([patches.to(x.dtype), x], dim=1)
            positions = torch.as_tensor(batch["positions"],
                                        device=embed.device)
        else:
            positions = torch.arange(x.shape[1], dtype=torch.int32,
                                     device=embed.device)
        return x, positions

    def _cos_sin(self, positions):
        cfg = self.cfg
        sections = cfg.mrope_sections if cfg.rope == "mrope" else None
        return blocks.rope_cos_sin(positions, cfg.dh, cfg.rope_theta,
                                   sections)

    def _q_pos(self, positions):
        """Query positions: M-RoPE's temporal ids (B, S), else positions."""
        return (positions[..., 0] if self.cfg.rope == "mrope"
                else positions).to(torch.int32)

    def _logits(self, params, x):
        x = blocks.rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        return (x[:, -1] @ params["lm_head"].T).float()

    # --------------------------------------------------------------- prefill
    def prefill(self, params, batch, pad_to: int | None = None):
        """Full-prompt forward; returns (last-position logits (B, vocab)
        float32, KV cache). `pad_to` grows the cache beyond the prompt so
        decode_step has room (empty slots carry kpos = -1)."""
        cfg = self.cfg
        x, positions = self._embed(params, batch)
        B, S = x.shape[:2]
        T = max(S, pad_to or 0)
        cos, sin = self._cos_sin(positions)
        q_pos = self._q_pos(positions)
        shape = (cfg.n_layers, B, T, cfg.n_kv, cfg.dh)
        ks = torch.zeros(shape, dtype=torch.bfloat16, device=x.device)
        vs = torch.zeros_like(ks)

        for i in range(cfg.n_layers):
            def kv_fn(k, v, i=i):
                ks[i, :, :S] = k.to(torch.bfloat16)
                vs[i, :, :S] = v.to(torch.bfloat16)
                return k, v, q_pos, q_pos
            lp = tree_map(lambda w: w[i], params["layers"])
            x = self._layer(x, lp, cos, sin, kv_fn)

        kpos = torch.full((T,), -1, dtype=torch.int32, device=x.device)
        # a VLM's cache keeps batch row 0's temporal ids, as JAX's does
        kpos[:S] = q_pos[0] if q_pos.dim() == 2 else q_pos
        cache = {"k": ks, "v": vs, "kpos": kpos,
                 "pos": torch.tensor(S, dtype=torch.int32)}
        return self._logits(params, x), cache

    # ---------------------------------------------------------------- decode
    def decode_step(self, params, cache, batch):
        """One token for every sequence in the batch against the cache
        (a VLM's batch also carries its M-RoPE ids (B, 1, 3)); returns
        (logits (B, vocab) float32, the updated cache)."""
        cfg = self.cfg
        embed = params["embed"]
        pos = int(cache["pos"])
        tokens = torch.as_tensor(batch["tokens"], device=embed.device)
        x = embed[tokens]                                  # (B, 1, D)
        ks, vs = cache["k"], cache["v"]
        T = ks.shape[2]
        slot = pos % T if cfg.swa else min(pos, T - 1)   # rolling: pos % T
        kpos = cache["kpos"].clone()
        kpos[slot] = pos
        if cfg.kind == "vlm":
            positions = torch.as_tensor(batch["positions"],
                                        device=embed.device)
            q_pos = self._q_pos(positions)                 # (B, 1)
        else:
            positions = q_pos = kpos[slot:slot + 1]        # (1,) == pos
        cos, sin = self._cos_sin(positions)

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
