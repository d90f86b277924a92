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
`kpos` (ROADMAP §3).

With `cfg.kv_quant` (the opt decode variant) the cache holds int8 K/V
and per-(b, t, kv head) bf16 scales {"k_scale", "v_scale": (L, B, T,
KV)}, quantized by `_quantize_kv` as the JAX model does: prefill attends
in the model's dtype and only stores the quantized cache; `decode_step`
quantizes the new token's K/V into its slot and attends with the int8
attention (`flash_decode_int8` on a card).

`loss_fn` is the training forward: embeddings, the layers (each under
`torch.utils.checkpoint` unless `cfg.remat` is "none", as JAX's
`maybe_remat`), the final norm and the chunked cross-entropy. On a card
its attention is differentiated by the `flash_bwd` kernel.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels.attention.ops import attention
from . import blocks
from .common import Desc, remat, stack_tree, tree_map
from .losses import chunked_cross_entropy


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config this model does not run."""
    if cfg.kind not in ("dense", "moe", "vlm"):
        raise ValueError(f"{cfg.name} is kind {cfg.kind!r}, not a "
                         "decoder-only transformer")


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, KV, dh) → (int8 values, per-(b, t, kv) bf16 scales): the
    scale is computed and divided by in float32, and stored as bf16."""
    x32 = x.float()
    scale = x32.abs().amax(-1) / 127.0 + 1e-9
    x8 = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return x8.to(torch.int8), scale.to(torch.bfloat16)


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
        kv_dtype = torch.int8 if cfg.kv_quant else torch.bfloat16
        out = {
            "k": Desc(kv_shape, init="zeros", dtype=kv_dtype),
            "v": Desc(kv_shape, init="zeros", dtype=kv_dtype),
            # -1 marks an empty slot (masked out by the attention)
            "kpos": Desc((T,), init="full", scale=-1, dtype=torch.int32),
            "pos": Desc((), init="zeros", dtype=torch.int32),
        }
        if cfg.kv_quant:
            out["k_scale"] = Desc(kv_shape[:4], init="ones")
            out["v_scale"] = Desc(kv_shape[:4], init="ones")
        return out

    # ---------------------------------------------------------------- layers
    def _layer(self, x, lp, cos, sin, kv_fn):
        """One pre-norm block. `kv_fn(k, v)` returns the keys/values to
        attend to, the query and key positions, and, for the int8 cache,
        the keys' and values' scales."""
        cfg = self.cfg
        h = blocks.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = blocks.qkv_project(h, lp["attn"], cfg)
        q = blocks.apply_rope(q, cos, sin)
        k = blocks.apply_rope(k, cos, sin)
        k_all, v_all, q_pos, kv_pos, *scales = kv_fn(k, v)
        k_scale, v_scale = scales or (None, None)
        attn = attention(q, k_all, v_all, causal=True, window=cfg.swa,
                         q_positions=q_pos, kv_positions=kv_pos,
                         k_scale=k_scale, v_scale=v_scale,
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
        x = torch.nn.functional.embedding(
            torch.as_tensor(batch["tokens"], device=embed.device), embed)
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

    # ------------------------------------------------------------ training
    def _backbone(self, params, x, positions):
        """The layers over the whole sequence, then the final norm; each
        layer is recomputed in backward unless `cfg.remat` is "none"."""
        cfg = self.cfg
        cos, sin = self._cos_sin(positions)
        q_pos = self._q_pos(positions)

        def kv_fn(k, v):
            return k, v, q_pos, q_pos

        def layer(x, lp):
            return self._layer(x, lp, cos, sin, kv_fn)

        for i in range(cfg.n_layers):
            lp = tree_map(lambda w: w[i], params["layers"])
            x = remat(cfg, layer, x, lp)
        return blocks.rms_norm(x, params["ln_f"], cfg.norm_eps)

    def loss_fn(self, params, batch) -> torch.Tensor:
        """Mean next-token cross-entropy of `batch` ({"tokens", "labels"
        (B, S), -1 = ignore; a VLM's "patches" and "positions"}), float32
        scalar."""
        x, positions = self._embed(params, batch)
        x = self._backbone(params, x, positions)
        return chunked_cross_entropy(x, batch["labels"], params["lm_head"],
                                     chunk=self.cfg.ce_chunk)

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
        ks = torch.zeros(shape, device=x.device,
                         dtype=torch.int8 if cfg.kv_quant else torch.bfloat16)
        vs = torch.zeros_like(ks)
        if cfg.kv_quant:             # padded slots keep scale 0, as JAX's
            kscs = torch.zeros(shape[:4], dtype=torch.bfloat16,
                               device=x.device)
            vscs = torch.zeros_like(kscs)

        for i in range(cfg.n_layers):
            def kv_fn(k, v, i=i):
                if cfg.kv_quant:     # attention stays in k's dtype
                    ks[i, :, :S], kscs[i, :, :S] = _quantize_kv(k)
                    vs[i, :, :S], vscs[i, :, :S] = _quantize_kv(v)
                else:
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
        if cfg.kv_quant:
            cache["k_scale"], cache["v_scale"] = kscs, vscs
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
        if cfg.kv_quant:
            kscs, vscs = cache["k_scale"], cache["v_scale"]
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
                if cfg.kv_quant:
                    k8, ksc = _quantize_kv(k)
                    v8, vsc = _quantize_kv(v)
                    ks[i, :, slot], vs[i, :, slot] = k8[:, 0], v8[:, 0]
                    kscs[i, :, slot], vscs[i, :, slot] = ksc[:, 0], vsc[:, 0]
                    return ks[i], vs[i], q_pos, kpos, kscs[i], vscs[i]
                ks[i, :, slot] = k[:, 0].to(ks.dtype)
                vs[i, :, slot] = v[:, 0].to(vs.dtype)
                return ks[i], vs[i], q_pos, kpos
            lp = tree_map(lambda w: w[i], params["layers"])
            x = self._layer(x, lp, cos, sin, kv_fn)

        new_cache = {"k": ks, "v": vs, "kpos": kpos,
                     "pos": torch.tensor(pos + 1, dtype=torch.int32)}
        if cfg.kv_quant:
            new_cache["k_scale"], new_cache["v_scale"] = kscs, vscs
        return self._logits(params, x), new_cache
