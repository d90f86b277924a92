"""Jamba-style hybrid LM: attention : Mamba = 1 : (P - 1) interleave with
the MoE FFN on every second layer [arXiv:2403.19887].

Mirrors `repro/models/hybrid.py` (prefill, decode step, parameter and
cache layout) over a tree of tensors. The layer pattern repeats with
period P = cfg.attn_every: slot P - 1 is the attention layer, the others
Mamba; slot i takes the MoE FFN when i % moe.every == moe.every - 1, the
SwiGLU FFN otherwise. Each slot's parameters are stacked over the
n_layers / P periods, and the JAX `scan` over periods becomes a Python
loop over that leading axis.

Attention goes through `kernels.attention.ops.attention` with explicit
positions, and the Mamba layers' scans through `kernels.ssm.ops.
selective_scan_fused`: on a card the hand-written kernels (or, with
`attn_impl="ref"` / `scan_impl="ref"`, their plain PyTorch versions, for
comparison), on the CPU the plain versions.

The cache is {"slots": {"slot{i}": the attention slot's "k", "v" (n, B,
T, KV, dh) bf16, a Mamba slot's "conv" (n, B, d_conv - 1, d_inner) in
the activations' dtype and "h" (n, B, d_inner, d_state) float32}, "kpos":
(T,) int32 absolute position per slot, -1 for empty, "pos": () int32 on
the host}. `decode_step` writes the new token's K/V into the cache's
tensors in place, as `transformer.py` does, and returns new Mamba states.
Prefill takes each Mamba layer's conv tail from `mamba_forward`'s own
`in_proj` product, where JAX's `_conv_tail` repeats that product on the
same inputs. The training loss is not ported yet.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels.attention.ops import attention
from . import blocks, mamba
from .common import Desc, stack_tree, tree_map


class HybridModel:
    def __init__(self, cfg: ModelConfig, scan_impl: str = "cuda",
                 attn_impl: str = "cuda"):
        if cfg.kind != "hybrid":
            raise ValueError(f"{cfg.name} is kind {cfg.kind!r}, not 'hybrid'")
        if cfg.swa:
            raise NotImplementedError(
                f"{cfg.name}: sliding-window attention and its rolling cache"
                " are not ported yet (ROADMAP queue 1, item 7)")
        self.cfg = cfg
        self.period = cfg.attn_every
        if cfg.n_layers % self.period:
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                             f"multiple of the period {self.period}")
        self.n_periods = cfg.n_layers // self.period
        self.scan_impl, self.attn_impl = scan_impl, attn_impl

    def _slot_is_attn(self, slot: int) -> bool:
        return slot == self.period - 1

    def _slot_is_moe(self, slot: int) -> bool:
        moe = self.cfg.moe
        return moe is not None and slot % moe.every == moe.every - 1

    # ------------------------------------------------------------ parameters
    def _slot_desc(self, slot: int) -> dict:
        cfg = self.cfg
        d: dict = {"ln1": Desc((cfg.d_model,), init="ones"),
                   "ln2": Desc((cfg.d_model,), init="ones")}
        if self._slot_is_attn(slot):
            d["attn"] = blocks.attention_desc(cfg)
        else:
            d["mamba"] = mamba.mamba_desc(cfg)
        if self._slot_is_moe(slot):
            d["moe"] = blocks.moe_desc(cfg)
        else:
            d["ffn"] = blocks.ffn_desc(cfg)
        return d

    def param_desc(self) -> dict:
        cfg = self.cfg
        return {
            "embed": Desc((cfg.vocab, cfg.d_model)),
            "lm_head": Desc((cfg.vocab, cfg.d_model)),
            "ln_f": Desc((cfg.d_model,), init="ones"),
            "periods": {
                f"slot{i}": stack_tree(self._slot_desc(i), self.n_periods)
                for i in range(self.period)},
        }

    def cache_desc(self, batch: int, cache_len: int) -> dict:
        cfg = self.cfg
        n = self.n_periods
        slots = {}
        for i in range(self.period):
            if self._slot_is_attn(i):
                kv = (n, batch, cache_len, cfg.n_kv, cfg.dh)
                slots[f"slot{i}"] = {"k": Desc(kv, init="zeros"),
                                     "v": Desc(kv, init="zeros")}
            else:
                slots[f"slot{i}"] = stack_tree(
                    mamba.mamba_state_desc(cfg, batch), n)
        return {
            "slots": slots,
            "kpos": Desc((cache_len,), init="full", scale=-1,
                         dtype=torch.int32),
            "pos": Desc((), init="zeros", dtype=torch.int32),
        }

    # ---------------------------------------------------------------- layers
    def _slot(self, x, lp, cos, sin, kv_fn, state):
        """One pre-norm slot layer. Attention: `kv_fn(k, v)` returns the
        keys/values to attend to, the query and the key positions. Mamba:
        `state` is None at prefill, the slot's cached state at decode.
        Returns (x, the slot's new Mamba state or None)."""
        cfg = self.cfg
        h = blocks.rms_norm(x, lp["ln1"], cfg.norm_eps)
        new = None
        if "attn" in lp:
            q, k, v = blocks.qkv_project(h, lp["attn"], cfg)
            q = blocks.apply_rope(q, cos, sin)
            k = blocks.apply_rope(k, cos, sin)
            k_all, v_all, q_pos, kv_pos = kv_fn(k, v)
            attn = attention(q, k_all, v_all, causal=True, window=cfg.swa,
                             q_positions=q_pos, kv_positions=kv_pos,
                             impl=self.attn_impl, device=q.device)
            x = x + blocks.attn_out(attn, lp["attn"])
        elif state is None:
            out, h_fin, tail = mamba.mamba_forward(h, lp["mamba"], cfg,
                                                   scan_impl=self.scan_impl)
            new = {"conv": tail, "h": h_fin}
            x = x + out
        else:
            out, new = mamba.mamba_decode_step(h, lp["mamba"], cfg, state,
                                               scan_impl=self.scan_impl)
            x = x + out
        h2 = blocks.rms_norm(x, lp["ln2"], cfg.norm_eps)
        if "moe" in lp:
            return x + blocks.moe_ffn(h2, lp["moe"], cfg), new
        return x + blocks.swiglu_ffn(h2, lp["ffn"]), new

    def _layers(self, params, x, cos, sin, kv_fn, slots=None):
        """Every period's slots in turn; returns x and the new Mamba
        states stacked over periods, by slot."""
        new: dict[str, list] = {}
        for n in range(self.n_periods):
            for i in range(self.period):
                name = f"slot{i}"
                lp = tree_map(lambda w: w[n], params["periods"][name])
                state = None if slots is None or self._slot_is_attn(i) else \
                    {k: v[n] for k, v in slots[name].items()}
                x, st = self._slot(x, lp, cos, sin,
                                   lambda k, v, n=n: kv_fn(n, k, v), state)
                if st is not None:
                    new.setdefault(name, []).append(st)
        return x, {name: {k: torch.stack([st[k] for st in sts])
                          for k in sts[0]} for name, sts in new.items()}

    def _with_kv(self, mamba_slots: dict, ks, vs) -> dict:
        """The cache's slots in slot order, the attention slot's K/V
        beside the Mamba slots' states."""
        return {f"slot{i}": {"k": ks, "v": vs} if self._slot_is_attn(i)
                else mamba_slots[f"slot{i}"] for i in range(self.period)}

    def _logits(self, params, x):
        x = blocks.rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        return (x[:, -1] @ params["lm_head"].T).float()

    def loss_fn(self, params, batch):
        raise NotImplementedError(
            f"{self.cfg.name}: the training loss is not ported yet (ROADMAP "
            "queue 1, item 9)")

    # --------------------------------------------------------------- prefill
    def prefill(self, params, batch, pad_to: int | None = None):
        """Full-prompt forward; returns (last-position logits (B, vocab)
        float32, cache). `pad_to` grows the attention cache beyond the
        prompt so decode_step has room (empty slots carry kpos = -1)."""
        cfg = self.cfg
        embed = params["embed"]
        tokens = torch.as_tensor(batch["tokens"], device=embed.device)
        B, S = tokens.shape
        T = max(S, pad_to or 0)
        x = embed[tokens]
        positions = torch.arange(S, dtype=torch.int32, device=embed.device)
        cos, sin = blocks.rope_cos_sin(positions, cfg.dh, cfg.rope_theta)
        shape = (self.n_periods, B, T, cfg.n_kv, cfg.dh)
        ks = torch.zeros(shape, dtype=torch.bfloat16, device=embed.device)
        vs = torch.zeros_like(ks)

        def kv_fn(n, k, v):
            ks[n, :, :S] = k.to(torch.bfloat16)
            vs[n, :, :S] = v.to(torch.bfloat16)
            return k, v, positions, positions

        x, slots = self._layers(params, x, cos, sin, kv_fn)
        kpos = torch.full((T,), -1, dtype=torch.int32, device=embed.device)
        kpos[:S] = positions
        cache = {"slots": self._with_kv(slots, ks, vs), "kpos": kpos,
                 "pos": torch.tensor(S, dtype=torch.int32)}
        return self._logits(params, x), cache

    # ---------------------------------------------------------------- decode
    def decode_step(self, params, cache, batch):
        """One token for every sequence in the batch against the cache;
        returns (logits (B, vocab) float32, the updated cache)."""
        cfg = self.cfg
        embed = params["embed"]
        pos = int(cache["pos"])
        x = embed[torch.as_tensor(batch["tokens"], device=embed.device)]
        attn_slot = cache["slots"][f"slot{self.period - 1}"]
        ks, vs = attn_slot["k"], attn_slot["v"]
        T = ks.shape[2]
        slot = min(pos, T - 1)
        kpos = cache["kpos"].clone()
        kpos[slot] = pos
        q_pos = kpos[slot:slot + 1]                        # (1,) == pos
        cos, sin = blocks.rope_cos_sin(q_pos, cfg.dh, cfg.rope_theta)

        def kv_fn(n, k, v):
            ks[n, :, slot] = k[:, 0].to(ks.dtype)
            vs[n, :, slot] = v[:, 0].to(vs.dtype)
            return ks[n], vs[n], q_pos, kpos

        x, slots = self._layers(params, x, cos, sin, kv_fn, cache["slots"])
        new_cache = {"slots": self._with_kv(slots, ks, vs), "kpos": kpos,
                     "pos": torch.tensor(pos + 1, dtype=torch.int32)}
        return self._logits(params, x), new_cache

