"""Transformer building blocks: RMSNorm, RoPE and M-RoPE, GQA attention
projections (self and cross), the SwiGLU FFN and the top-k MoE FFN.

Each keeps the JAX package's dtype steps (`repro/models/blocks.py`): norms
and RoPE compute in float32 and cast back, matrix products run in the
parameters' dtype, the MoE router in float32. Attention itself is not
written here: the model calls `kernels.attention.ops.attention` with
explicit positions, which runs the hand-written flash kernel on a card.
The MoE FFN is plain PyTorch (top-k, gathers, batched products over the
experts, `index_add_`), as JAX computes it outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import NULL_RULES, AxisRules, Desc


# ---------------------------------------------------------------------- norm
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    x32 = x.float()
    var = x32.pow(2).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


# ---------------------------------------------------------------------- rope
def rope_cos_sin(positions: torch.Tensor, dh: int, theta: float,
                 sections: tuple[int, int, int] | None = None):
    """cos/sin tables (…, S, dh // 2) in float32.

    positions: (…, S) for 1-D RoPE, or (…, S, 3) for M-RoPE (Qwen2-VL:
    the temporal, height and width ids each turn their own `sections`
    of the frequency bands). The inverse frequencies are computed in
    float32 on the positions' device, as the JAX package computes them
    with numpy (equal to an ulp): a host-to-device copy here would make
    every decode step wait for the card to finish the step before it."""
    half = dh // 2
    inv = 1.0 / theta ** (torch.arange(0, half, dtype=torch.float32,
                                       device=positions.device) / half)
    if sections is None:
        freqs = positions[..., None].float() * inv
    else:
        if sum(sections) != half:
            raise ValueError(f"M-RoPE sections {sections} must sum to "
                             f"dh // 2 = {half}")
        pos = positions.float()                          # (…, S, 3)
        bounds = [0, sections[0], sections[0] + sections[1], half]
        freqs = torch.cat([pos[..., i:i + 1] * inv[bounds[i]:bounds[i + 1]]
                           for i in range(3)], dim=-1)   # (…, S, half)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (B, S, H, dh); cos/sin: (S, half) or (B, S, half)."""
    half = x.shape[-1] // 2
    cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- embed
def embed(tokens: torch.Tensor, table: torch.Tensor,
          rules: AxisRules = NULL_RULES) -> torch.Tensor:
    """table[tokens] (…, D). Under a mesh each rank looks up the tokens in
    its slice of the vocabulary (sharded over "tp"), zeros elsewhere, and
    the slices' sum (one nonzero term a token) is the lookup, as a
    vocab-parallel embedding; the table's gradient is then a partial sum
    over the "dp" ranks."""
    if rules.mesh is None:
        return F.embedding(tokens, table)
    tpl = rules.placements(("dp",) + (None,) * (tokens.dim() - 1),
                           tuple(tokens.shape))
    wpl = rules.placements(("tp", None), tuple(table.shape))
    out_axes = ("dp",) + (None,) * tokens.dim()
    vocab = rules.split_by(("tp", None), table.shape, 0)
    batch = rules.split_by(("dp",), tokens.shape[:1], 0)
    opl = rules.partial(rules.placements(
        out_axes, tuple(tokens.shape) + (table.shape[1],)), vocab)
    r, _ = rules.coord(vocab)

    def local(tok, w):
        ids = tok.long() - r * w.shape[0]
        hit = (ids >= 0) & (ids < w.shape[0])
        out = F.embedding(ids.clamp(0, w.shape[0] - 1), w)
        return torch.where(hit[..., None], out, torch.zeros_like(out))

    out = rules.local(local, ins=(tpl, wpl), outs=(opl,),
                      grads=(tpl, rules.partial(wpl, batch)))(tokens, table)
    return rules.constrain(out, *out_axes)


# ----------------------------------------------------------------- attention
def attention_desc(cfg: ModelConfig, cross: bool = False) -> dict:
    """Q/K/V/O projections; a cross-attention block (`cross`) has neither
    bias nor QK-norm, as in the JAX package."""
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.dh
    p = {
        "wq": Desc((D, H * dh), ("fsdp", "tp")),
        "wk": Desc((D, KV * dh), ("fsdp", "tp" if KV % 8 == 0 else None)),
        "wv": Desc((D, KV * dh), ("fsdp", "tp" if KV % 8 == 0 else None)),
        "wo": Desc((H * dh, D), ("tp", "fsdp")),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = Desc((H * dh,), ("tp",), init="zeros")
        p["bk"] = Desc((KV * dh,), (None,), init="zeros")
        p["bv"] = Desc((KV * dh,), (None,), init="zeros")
    if cfg.qk_norm and not cross:
        p["q_norm"] = Desc((dh,), (None,), init="ones")
        p["k_norm"] = Desc((dh,), (None,), init="ones")
    return p


def split_heads(x: torch.Tensor, n: int,
                rules: AxisRules = NULL_RULES) -> torch.Tensor:
    """(B, S, n·dh) → (B, S, n, dh). Under a mesh, where the n heads do
    not divide the "tp" ranks (which `physical` then leaves unsplit) but
    n·dh does, the last dim is gathered first: DTensor cannot unflatten
    an uneven split (JAX's partitioner reshards inside the reshape)."""
    B, S, F = x.shape
    if rules.mesh is not None and rules.split_by(
            ("dp", None, "tp", None), (B, S, n, F // n), 2) is None:
        x = rules.constrain(x, "dp", None, None)
    return x.reshape(B, S, n, F // n)


def qkv_project(x: torch.Tensor, p: dict, cfg: ModelConfig,
                kv_x: torch.Tensor | None = None,
                rules: AxisRules = NULL_RULES):
    """(B, S, D) → q (B, S, H, dh), k and v (B, Tk, KV, dh), with optional
    bias and per-head QK-norm (after the reshape, before RoPE). K and V
    project `kv_x` (B, Tk, D) for cross-attention, else x itself."""
    B, S, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv, cfg.dh
    src = x if kv_x is None else kv_x
    Tk = src.shape[1]
    q, k, v = x @ p["wq"], src @ p["wk"], src @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_heads(q, H, rules)
    k = split_heads(k, KV, rules)
    v = split_heads(v, KV, rules)
    if "q_norm" in p:                      # qwen3: per-head RMS on q, k
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rules.constrain(q, "dp", None, "tp", None)
    return q, k, v


def attend(attention, q, k, v, *, rules: AxisRules = NULL_RULES,
           **kw) -> torch.Tensor:
    """`attention(q, k, v, **kw)` (the model module's
    `kernels.attention.ops.attention`, looked up where it is called so a
    test may swap it); under a mesh on each rank's local heads
    (`rules.local`): q sharded over "tp" by heads, K/V by heads too
    where their count divides the "tp" ranks, else replicated and cut
    down to the KV heads of the rank's query heads, so the kernel's local
    head h still maps to KV head h // (H / KV). Then the gradients of
    replicated K/V are partial sums over the "tp" ranks. The int8 scales
    (B, T, KV) follow K/V's heads; positions of one row a batch row (B,
    S) follow the batch over "dp", shared ones stay replicated."""
    if rules.mesh is None:
        return attention(q, k, v, **kw)
    H, KV = q.shape[2], k.shape[2]
    q_axes = ("dp", None, "tp", None)
    heads = rules.split_by(q_axes, q.shape, 2)
    r, tp = rules.coord(heads)
    kv_split = tp > 1 and KV % tp == 0
    kv_axes = q_axes if kv_split else ("dp", None, None, None)
    cut = None
    if tp > 1 and not kv_split:
        Hl, g = H // tp, H // KV
        if Hl % g and g % Hl:
            raise ValueError(f"{H} query heads over {tp} ranks do not "
                             f"map onto whole groups of {KV} KV heads")
        cut = ((r * Hl) // g, ((r + 1) * Hl - 1) // g + 1)
    extra = [n for n in ("q_positions", "kv_positions", "k_scale",
                         "v_scale") if kw.get(n) is not None]
    opts = {n: v for n, v in kw.items() if n not in extra}

    def local(q, k, v, *rest):
        if cut is not None:
            k, v = k[:, :, cut[0]:cut[1]], v[:, :, cut[0]:cut[1]]
            rest = [x[..., cut[0]:cut[1]] if n.endswith("scale") else x
                    for n, x in zip(extra, rest)]
        return attention(q, k, v, **opts, **dict(zip(extra, rest)))

    rest = [torch.as_tensor(kw[n]) for n in extra]
    qpl = rules.placements(q_axes, tuple(q.shape))
    kvpl = rules.placements(kv_axes, tuple(k.shape))
    scale_axes = ("dp", None, "tp") if kv_split else ("dp", None, None)
    rpl = tuple(rules.placements(
        scale_axes if n.endswith("scale") else ("dp", None)
        if x.dim() == 2 else (None,) * x.dim(), tuple(x.shape))
        for n, x in zip(extra, rest))
    kv_grad = kvpl if cut is None else rules.partial(kvpl, heads)
    fn = rules.local(local, ins=(qpl, kvpl, kvpl) + rpl, outs=(qpl,),
                     grads=(qpl, kv_grad, kv_grad) + rpl)
    out = fn(q, k, v, *rest)
    return rules.constrain(out, "dp", None, "tp", None)


def attn_out(attn: torch.Tensor, p: dict,
             rules: AxisRules = NULL_RULES) -> torch.Tensor:
    B, S, H, dh = attn.shape
    out = attn.reshape(B, S, H * dh) @ p["wo"]
    return rules.constrain(out, "dp", None, None)


# ---------------------------------------------------------------------- ffn
def ffn_desc(cfg: ModelConfig) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return {"w_in": Desc((D, Fd), ("fsdp", "tp")),
            "w_gate": Desc((D, Fd), ("fsdp", "tp")),
            "w_out": Desc((Fd, D), ("tp", "fsdp"))}


def swiglu_ffn(x: torch.Tensor, p: dict,
               rules: AxisRules = NULL_RULES) -> torch.Tensor:
    h = rules.constrain(F.silu(x @ p["w_gate"]) * (x @ p["w_in"]),
                        "dp", None, "tp")
    return rules.constrain(h @ p["w_out"], "dp", None, None)


# ---------------------------------------------------------------------- moe
def moe_desc(cfg: ModelConfig) -> dict:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return {
        "router": Desc((D, E), (None, None), dtype=torch.float32),
        "w_in": Desc((E, D, Fd), ("exp", "fsdp", "tp")),
        "w_gate": Desc((E, D, Fd), ("exp", "fsdp", "tp")),
        "w_out": Desc((E, Fd, D), ("exp", "tp", "fsdp")),
    }


def moe_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig,
            rules: AxisRules = NULL_RULES) -> torch.Tensor:
    if cfg.moe_impl == "grouped":
        return moe_ffn_grouped(x, p, cfg, rules)
    return moe_ffn_global(x, p, cfg, rules)


def _route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """float32 router → `keep` (…, E): each token's renormalised top-k
    router probabilities on its chosen experts, zeros elsewhere."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    top_vals, top_idx = torch.topk(probs, top_k, dim=-1)
    top_vals = top_vals / top_vals.sum(-1, keepdim=True)
    # one nonzero term per (token, expert): JAX's one-hot sum, exactly
    return torch.zeros_like(probs).scatter_(-1, top_idx, top_vals)


def _experts(xg: torch.Tensor, p: dict, gate: torch.Tensor,
             rules: AxisRules = NULL_RULES, h_axes: tuple = ()
             ) -> torch.Tensor:
    """SwiGLU of every expert over its gathered tokens xg (…, E, C, D),
    weighted by `gate` (…, E, C); a slot whose gate is 0 contributes 0.
    Under a mesh the hidden activations are constrained to `h_axes`."""
    h = F.silu(torch.einsum("...ecd,edf->...ecf", xg, p["w_gate"])) \
        * torch.einsum("...ecd,edf->...ecf", xg, p["w_in"])
    h = rules.constrain(h, *h_axes)
    y = torch.einsum("...ecf,efd->...ecd", h, p["w_out"])
    return y * (gate * (gate > 0.0))[..., None].to(y.dtype)


def moe_ffn_global(x: torch.Tensor, p: dict, cfg: ModelConfig,
                   rules: AxisRules = NULL_RULES) -> torch.Tensor:
    """Token-choice top-k MoE with per-expert capacity over the whole
    token pool (GShard-style dropping, highest router probability first):
    gather → batched product over the experts → scatter-add, as JAX's
    `moe_ffn_global`. Each expert takes its C highest-`keep` tokens; with
    fewer than C routed to it, `topk` fills the rest from tokens of
    `keep` 0, whose order among themselves may differ from `lax.top_k`'s
    — they carry gate 0 and add 0, so the result does not depend on it.
    A token gets at most top_k contributions onto zeros, and a sum of two
    terms does not depend on their order, so `index_add_` (atomics on a
    card) gives JAX's `.at[].add` bit for bit."""
    moe = cfg.moe
    B, S, D = x.shape
    N = B * S
    E, K = moe.n_experts, moe.top_k
    C = min(max(int(moe.capacity_factor * K * N / E), 1), N)

    def dispatch(xf, router):
        keep = _route(xf, router, K)                       # (N, E)
        gate_t, tok_idx = torch.topk(keep.T, C, dim=-1)    # (E, C)
        return gate_t, tok_idx, xf[tok_idx.reshape(-1)].reshape(E, C, D)

    def combine(y, tok_idx):
        out = torch.zeros((N, D), dtype=y.dtype, device=y.device)
        return out.index_add_(0, tok_idx.reshape(-1), y.reshape(E * C, D))

    gate_t, tok_idx, xg = _replicated_local(
        rules, dispatch, (2, 2), (2, 2, 3))(x.reshape(N, D), p["router"])
    xg = rules.constrain(xg, "exp", None, None)
    y = _experts(xg, p, gate_t, rules, ("exp", None, "tp"))
    out = _replicated_local(rules, combine, (3, 2), (2,))(y, tok_idx)
    return rules.constrain(out.reshape(B, S, D), "dp", None, None)


def _replicated_local(rules: AxisRules, fn, in_dims: tuple,
                      out_dims: tuple):
    """`fn` under a mesh on whole tensors, every argument and output
    replicated (in_dims/out_dims: their ranks): the MoE's routing, top-C,
    gather and scatter-add see the whole token pool on every rank, as
    the global capacity needs; only the experts' products run sharded."""
    def rep(n):
        return rules.placements((None,) * n)
    if rules.mesh is None:
        return fn
    return rules.local(fn, ins=tuple(map(rep, in_dims)),
                       outs=tuple(map(rep, out_dims)),
                       grads=tuple(map(rep, in_dims)))


def moe_ffn_grouped(x: torch.Tensor, p: dict, cfg: ModelConfig,
                    rules: AxisRules = NULL_RULES) -> torch.Tensor:
    """The same MoE with capacity per batch row, as JAX's
    `moe_ffn_grouped`: routing, top-C, gather and scatter-add stay within
    each row."""
    moe = cfg.moe
    B, S, D = x.shape
    E, K = moe.n_experts, moe.top_k
    C = max(min(int(moe.capacity_factor * K * S / E), S), 1)

    def dispatch(x, router):
        keep = _route(x, router, K)                        # (B, S, E)
        gate_t, tok_idx = torch.topk(keep.transpose(1, 2), C,
                                     dim=-1)               # (B, E, C)
        rows = torch.arange(B, device=x.device)[:, None, None]
        return gate_t, tok_idx, x[rows, tok_idx]           # (B, E, C, D)

    def combine(y, tok_idx):
        rows = torch.arange(B, device=y.device)[:, None, None]
        out = torch.zeros((B * S, D), dtype=y.dtype, device=y.device)
        return out.index_add_(0, (rows * S + tok_idx).reshape(-1),
                              y.reshape(-1, D))

    gate_t, tok_idx, xg = _replicated_local(
        rules, dispatch, (3, 2), (3, 3, 4))(x, p["router"])
    xg = rules.constrain(xg, "dp", "exp", None, None)
    y = _experts(xg, p, gate_t, rules, ("dp", "exp", None, "tp"))
    y = rules.constrain(y, "dp", None, None, None)         # (B, E, C, D)
    out = _replicated_local(rules, combine, (4, 3), (2,))(y, tok_idx)
    return rules.constrain(out.reshape(B, S, D), "dp", None, None)
