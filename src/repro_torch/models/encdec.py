"""Encoder-decoder LM (the SeamlessM4T-medium backbone).

Mirrors `repro/models/encdec.py` (encode, prefill, decode step,
parameter and cache layout) over a tree of tensors; the JAX `scan` over
layers becomes a Python loop over each layer parameter's leading axis.
The audio frontend is a stub: the encoder takes precomputed frame
embeddings `batch["frames"]` (B, S_enc, d_model), cast to bf16. The
encoder's self-attention is bidirectional; each decoder layer has causal
self-attention and then cross-attention into the encoder's output, with
RoPE on self-attention only. Every attention goes through
`kernels.attention.ops.attention` with explicit positions (the memory
at arange(S_enc)): on a card the hand-written kernel (or, with
`attn_impl="ref"`, its plain PyTorch version), on the CPU the plain one.

The cache is {"k", "v": (L_dec, B, T, KV, dh) bf16 decoder self-K/V,
"cross_k", "cross_v": (L_dec, B, S_enc, KV, dh) bf16, projected once
from the encoder's output at prefill, "kpos": (T,) int32 absolute
position per slot, -1 for empty, "pos": () int32 on the host}.
`decode_step` writes the new token's K/V into the cache's tensors in
place.

`loss_fn` is the training forward: `encode`, then the decoder layers
over the tokens with causal self-attention and cross-attention into the
memory, the final norm and the chunked cross-entropy. Each encoder and
decoder layer runs under `torch.utils.checkpoint` unless `cfg.remat` is
"none", as JAX's `maybe_remat` scan bodies. On a card every attention
is differentiated by `flash_bwd`.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels.attention.ops import attention
from . import blocks
from .common import NULL_RULES, AxisRules, Desc, remat, stack_tree, tree_map, \
    whole
from .losses import chunked_cross_entropy


def _enc_layer_desc(cfg: ModelConfig) -> dict:
    return {
        "attn": blocks.attention_desc(cfg),
        "ffn": blocks.ffn_desc(cfg),
        "ln1": Desc((cfg.d_model,), (None,), init="ones"),
        "ln2": Desc((cfg.d_model,), (None,), init="ones"),
    }


def _dec_layer_desc(cfg: ModelConfig) -> dict:
    return {
        "self": blocks.attention_desc(cfg),
        "cross": blocks.attention_desc(cfg, cross=True),
        "ffn": blocks.ffn_desc(cfg),
        "ln1": Desc((cfg.d_model,), (None,), init="ones"),
        "ln2": Desc((cfg.d_model,), (None,), init="ones"),
        "ln3": Desc((cfg.d_model,), (None,), init="ones"),
    }


class EncDecModel:
    def __init__(self, cfg: ModelConfig, attn_impl: str = "cuda"):
        if cfg.kind != "encdec":
            raise ValueError(f"{cfg.name} is kind {cfg.kind!r}, not 'encdec'")
        self.cfg = cfg
        self.n_dec = cfg.n_dec_layers or cfg.n_layers
        self.attn_impl = attn_impl

    # ------------------------------------------------------------ parameters
    def param_desc(self) -> dict:
        cfg = self.cfg
        return {
            "embed": Desc((cfg.vocab, cfg.d_model), ("tp", "fsdp")),
            "lm_head": Desc((cfg.vocab, cfg.d_model), ("tp", "fsdp")),
            "ln_enc": Desc((cfg.d_model,), (None,), init="ones"),
            "ln_dec": Desc((cfg.d_model,), (None,), init="ones"),
            "enc_layers": stack_tree(_enc_layer_desc(cfg), cfg.n_layers),
            "dec_layers": stack_tree(_dec_layer_desc(cfg), self.n_dec),
        }

    def cache_desc(self, batch: int, cache_len: int,
                   enc_len: int = 4096) -> dict:
        cfg = self.cfg
        kv = (self.n_dec, batch, cache_len, cfg.n_kv, cfg.dh)
        ckv = (self.n_dec, batch, enc_len, cfg.n_kv, cfg.dh)
        axes = (None, "dp", "sp", None, None)
        return {
            "k": Desc(kv, axes, init="zeros"),
            "v": Desc(kv, axes, init="zeros"),
            "cross_k": Desc(ckv, axes, init="zeros"),
            "cross_v": Desc(ckv, axes, init="zeros"),
            # -1 marks an empty slot (masked out by the attention)
            "kpos": Desc((cache_len,), (None,), init="full", scale=-1,
                         dtype=torch.int32),
            "pos": Desc((), (), init="zeros", dtype=torch.int32),
        }

    def _attend(self, q, k, v, q_pos, kv_pos, causal: bool, rules):
        return blocks.attend(attention, q, k, v, rules=rules,
                             causal=causal, window=None, q_positions=q_pos,
                             kv_positions=kv_pos, impl=self.attn_impl,
                             device=q.device)

    def _embed(self, params, tokens, rules):
        table = params["embed"]
        x = blocks.embed(torch.as_tensor(tokens, device=table.device), table,
                         rules)
        return rules.constrain(x, "dp", None, None)

    def _cos_sin(self, positions, rules):
        cfg = self.cfg
        return tuple(map(rules.replicated, blocks.rope_cos_sin(
            positions, cfg.dh, cfg.rope_theta)))

    def _logits(self, params, x):
        x = blocks.rms_norm(x, params["ln_dec"], self.cfg.norm_eps)
        return (x[:, -1] @ params["lm_head"].T).float()

    def loss_fn(self, params, batch, rules: AxisRules = NULL_RULES
                ) -> torch.Tensor:
        """Mean next-token cross-entropy of `batch` ({"frames" (B, S_enc,
        D), "tokens", "labels" (B, S), -1 = ignore}), float32 scalar."""
        return self.decoder_loss(params, self._encode(params, batch, rules),
                                 batch, rules)

    def _encode(self, params, batch, rules):
        """`encode` of the batch's frames; without a mesh called as
        `encode(params, frames)`, the one-card signature."""
        if rules.mesh is None:
            return self.encode(params, batch["frames"])
        return self.encode(params, batch["frames"], rules)

    def decoder_loss(self, params, memory, batch,
                     rules: AxisRules = NULL_RULES) -> torch.Tensor:
        """The loss's decoder half: the decoder layers over
        `batch["tokens"]` against the encoder's `memory` (B, S_enc, D),
        the final norm and the chunked cross-entropy."""
        with rules.scope():
            return self._decoder_loss(params, memory, batch, rules)

    def _decoder_loss(self, params, memory, batch, rules):
        cfg = self.cfg
        x = self._embed(params, batch["tokens"], rules)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        cos, sin = self._cos_sin(positions, rules)
        mem_pos = torch.arange(memory.shape[1], dtype=torch.int32,
                               device=x.device)

        def layer(x, lp, memory):
            lp = rules.gathered(lp)

            def self_fn(k, v):
                return k, v, positions, positions

            def cross_fn(h):
                qc, kc, vc = blocks.qkv_project(h, lp["cross"], cfg,
                                                kv_x=memory, rules=rules)
                return qc, kc, vc, positions, mem_pos
            return self._dec_layer(x, lp, cos, sin, self_fn, cross_fn, rules)

        for i in range(self.n_dec):
            lp = tree_map(lambda w: w[i], params["dec_layers"])
            x = remat(cfg, layer, x, lp, memory)
        x = blocks.rms_norm(x, params["ln_dec"], cfg.norm_eps)
        return chunked_cross_entropy(x, batch["labels"], params["lm_head"],
                                     rules, chunk=cfg.ce_chunk)

    # ---------------------------------------------------------------- encode
    def _enc_layer(self, x, lp, cos, sin, positions, rules=NULL_RULES):
        cfg = self.cfg
        lp = rules.gathered(lp)
        h = blocks.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = blocks.qkv_project(h, lp["attn"], cfg, rules=rules)
        q = blocks.apply_rope(q, cos, sin)
        k = blocks.apply_rope(k, cos, sin)
        attn = self._attend(q, k, v, positions, positions, False, rules)
        x = x + blocks.attn_out(attn, lp["attn"], rules)
        h = blocks.rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + blocks.swiglu_ffn(h, lp["ffn"], rules)

    def encode(self, params, frames, rules: AxisRules = NULL_RULES):
        """Encoder frames (B, S_enc, D) → memory (B, S_enc, D) bf16; each
        layer is recomputed in backward unless `cfg.remat` is "none"."""
        cfg = self.cfg
        dev = params["embed"].device
        with rules.scope():
            x = rules.constrain(torch.as_tensor(frames, device=dev).to(
                torch.bfloat16), "dp", None, None)
            positions = torch.arange(x.shape[1], dtype=torch.int32,
                                     device=dev)
            cos, sin = self._cos_sin(positions, rules)

            def layer(x, lp):
                return self._enc_layer(x, lp, cos, sin, positions, rules)

            for i in range(cfg.n_layers):
                lp = tree_map(lambda w: w[i], params["enc_layers"])
                x = remat(cfg, layer, x, lp)
            return blocks.rms_norm(x, params["ln_enc"], cfg.norm_eps)

    # --------------------------------------------------------------- decoder
    def _dec_layer(self, x, lp, cos, sin, self_fn, cross_fn,
                   rules=NULL_RULES):
        """One decoder layer. `self_fn(k, v)` returns the keys/values to
        attend to with their positions and the query positions;
        `cross_fn(h)` the cross-attention's queries, keys, values and
        their positions."""
        cfg = self.cfg
        lp = rules.gathered(lp)
        h = blocks.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = blocks.qkv_project(h, lp["self"], cfg, rules=rules)
        q = blocks.apply_rope(q, cos, sin)
        k = blocks.apply_rope(k, cos, sin)
        k_all, v_all, q_pos, kv_pos = self_fn(k, v)
        attn = self._attend(q, k_all, v_all, q_pos, kv_pos, True, rules)
        x = x + blocks.attn_out(attn, lp["self"], rules)
        h = blocks.rms_norm(x, lp["ln2"], cfg.norm_eps)
        qc, kc, vc, q_pos, mem_pos = cross_fn(h)
        cross = self._attend(qc, kc, vc, q_pos, mem_pos, False, rules)
        x = x + blocks.attn_out(cross, lp["cross"], rules)
        h = blocks.rms_norm(x, lp["ln3"], cfg.norm_eps)
        return x + blocks.swiglu_ffn(h, lp["ffn"], rules)

    # --------------------------------------------------------------- prefill
    def prefill(self, params, batch, pad_to: int | None = None,
                rules: AxisRules = NULL_RULES):
        """Encode `batch["frames"]`, then run the decoder over
        `batch["tokens"]`; returns (last-position logits (B, vocab)
        float32, cache). `pad_to` grows the self-attention cache beyond
        the prompt so decode_step has room (empty slots carry kpos = -1).
        Under a mesh the caches are written whole on every rank and then
        placed as `cache_desc`'s axes say."""
        memory = self._encode(params, batch, rules)
        with rules.scope():
            return self._prefill(params, memory, batch, pad_to, rules)

    def _place_cache(self, cache, rules):
        return {k: rules.distribute(v, None, "dp", "sp", None, None)
                if k in ("k", "v", "cross_k", "cross_v") else v
                for k, v in cache.items()}

    def _prefill(self, params, memory, batch, pad_to, rules):
        cfg = self.cfg
        embed = params["embed"]
        tokens = torch.as_tensor(batch["tokens"], device=embed.device)
        B, S = tokens.shape
        T = max(S, pad_to or 0)
        x = self._embed(params, tokens, rules)
        positions = torch.arange(S, dtype=torch.int32, device=embed.device)
        cos, sin = self._cos_sin(positions, rules)
        mem_pos = torch.arange(memory.shape[1], dtype=torch.int32,
                               device=embed.device)
        shape = (self.n_dec, B, T, cfg.n_kv, cfg.dh)
        ks = torch.zeros(shape, dtype=torch.bfloat16, device=embed.device)
        vs = torch.zeros_like(ks)
        kcs, vcs = [], []

        for i in range(self.n_dec):
            lp = rules.gathered(tree_map(lambda w: w[i],
                                         params["dec_layers"]))

            def self_fn(k, v, i=i):
                ks[i, :, :S] = whole(k).to(torch.bfloat16)
                vs[i, :, :S] = whole(v).to(torch.bfloat16)
                return k, v, positions, positions

            def cross_fn(h, lp=lp):
                qc, kc, vc = blocks.qkv_project(h, lp["cross"], cfg,
                                                kv_x=memory, rules=rules)
                kcs.append(whole(kc).to(torch.bfloat16))
                vcs.append(whole(vc).to(torch.bfloat16))
                return qc, kc, vc, positions, mem_pos
            x = self._dec_layer(x, lp, cos, sin, self_fn, cross_fn, rules)

        kpos = torch.full((T,), -1, dtype=torch.int32, device=embed.device)
        kpos[:S] = positions
        cache = {"k": ks, "v": vs, "cross_k": torch.stack(kcs),
                 "cross_v": torch.stack(vcs), "kpos": kpos,
                 "pos": torch.tensor(S, dtype=torch.int32)}
        return self._logits(params, x), self._place_cache(cache, rules)

    # ---------------------------------------------------------------- decode
    def decode_step(self, params, cache, batch,
                    rules: AxisRules = NULL_RULES):
        """One token for every sequence in the batch against the cache;
        returns (logits (B, vocab) float32, the updated cache). Under a
        mesh the caches are gathered whole and placed back."""
        with rules.scope():
            return self._decode_step(params, cache, batch, rules)

    def _decode_step(self, params, cache, batch, rules):
        cfg = self.cfg
        embed = params["embed"]
        pos = int(cache["pos"])
        x = self._embed(params, batch["tokens"], rules)
        ks, vs = whole(cache["k"]), whole(cache["v"])
        cks, cvs = whole(cache["cross_k"]), whole(cache["cross_v"])
        T = ks.shape[2]
        slot = min(pos, T - 1)
        kpos = cache["kpos"].clone()
        kpos[slot] = pos
        q_pos = kpos[slot:slot + 1]                        # (1,) == pos
        cos, sin = self._cos_sin(q_pos, rules)
        mem_pos = torch.arange(cks.shape[2], dtype=torch.int32,
                               device=embed.device)

        for i in range(self.n_dec):
            lp = rules.gathered(tree_map(lambda w: w[i],
                                         params["dec_layers"]))

            def self_fn(k, v, i=i):
                ks[i, :, slot] = whole(k)[:, 0].to(ks.dtype)
                vs[i, :, slot] = whole(v)[:, 0].to(vs.dtype)
                return ks[i], vs[i], q_pos, kpos

            def cross_fn(h, lp=lp, i=i):       # K/V from the cache
                qc = rules.constrain(blocks.split_heads(
                    h @ lp["cross"]["wq"], cfg.n_heads, rules),
                    "dp", None, "tp", None)
                return qc, cks[i], cvs[i], q_pos, mem_pos
            x = self._dec_layer(x, lp, cos, sin, self_fn, cross_fn, rules)

        new_cache = dict(cache, k=ks, v=vs, cross_k=cks, cross_v=cvs,
                         kpos=kpos,
                         pos=torch.tensor(pos + 1, dtype=torch.int32))
        return self._logits(params, x), self._place_cache(new_cache, rules)
