"""Roofline terms of a counted step (`repro/launch/roofline.py`), against
one NVIDIA H100, and the work of each model kernel.

Three terms per (arch × shape × mesh), all in seconds:

  compute    = FLOPs per device / PEAK_FLOPS (the bf16 tensor-core rate)
  memory     = bytes per device / HBM_BW
  collective = wire bytes per device / the bandwidth of the slowest link
               its group spans (NVLink inside a node of 8, the network
               between nodes)

The counts come from `launch.hlo_cost.analyze_step`, which counts what
one rank dispatches in an eager step; `analyze` turns its `CostSummary`
into a `Roofline`. Wire bytes follow the ring model per collective of
group size g (`wire_bytes`):

  all-gather          (g-1)/g × output bytes
  reduce-scatter      (g-1)   × output bytes (input = g × output)
  all-reduce          2(g-1)/g × bytes
  all-to-all          (g-1)/g × bytes
  collective-permute  1 × bytes

The production meshes are row-major (16, 16) and (2, 16, 16): a "model"
group of 16 consecutive ranks spans two nodes of 8, so its collectives
run at the network's rate, not NVLink's. Every counted FLOP is divided
by the bf16 rate, as the JAX package divides by its one peak; the
kernels' own bounds (`*_cost` below, `chip_smoke.py`'s kernels line)
take the rate of their type.

The `*_cost` functions give the least work of one call of each model
kernel from its shapes, dtypes and static arguments: (flops, bytes),
each input read once and each output written once. The kernels' cost
hook (`kernels/_cost.py`) records them, and `chip_smoke.py` turns them
into its bounds.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# ------------------------------------------------------------------ hardware
# NVIDIA H100 SXM5 80 GB at 700 W (NVIDIA H100 Tensor Core GPU data
# sheet: dense rates, without sparsity).
BF16_FLOPS_PER_S = 989e12       # bf16 tensor cores
F32_FLOPS_PER_S = 67e12         # float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12        # int8 tensor cores
HBM_BYTES_PER_S = 3.35e12       # HBM3
# The float32 rate counts an FMA as two operations on 128 FP32 lanes per
# SM; an SM has 64 INT32 lanes, so 32-bit integer instructions (LOP3,
# popc) issue at most a quarter of that.
INT32_OPS_PER_S = F32_FLOPS_PER_S / 4
# special-function units (MUFU: one ex2 a lane): 16 an SM a clock, 132
# SMs at the 1.98 GHz boost clock (NVIDIA Hopper architecture white paper)
SFU_OPS_PER_S = 132 * 16 * 1.98e9
# NVLink 4: 900 GB/s per GPU both ways, 450 GB/s each way, inside a node
# of 8 GPUs (NVIDIA H100 data sheet; DGX H100 user guide)
NVLINK_BW = 450e9
# between nodes: one 400 Gb/s NDR InfiniBand port per GPU, as in a DGX
# H100 (DGX H100 user guide)
NETWORK_BW = 50e9
GPUS_PER_NODE = 8

PEAK_FLOPS = BF16_FLOPS_PER_S
HBM_BW = HBM_BYTES_PER_S


def link_bandwidth(link: str) -> float:
    """Bytes/s per direction of a link class: "nvlink" or "network"."""
    return NVLINK_BW if link == "nvlink" else NETWORK_BW


def link_of(ranks) -> str:
    """The slowest link class a group of global ranks spans: "nvlink" if
    all sit in one node of `GPUS_PER_NODE`, else "network"."""
    nodes = {r // GPUS_PER_NODE for r in ranks}
    return "nvlink" if len(nodes) <= 1 else "network"


def wire_bytes(kind: str, nbytes: float, g: int) -> float:
    """Ring-model bytes one device sends for a collective of `kind` whose
    result is `nbytes`, over a group of `g`."""
    g = max(g, 1)
    if kind == "all-gather":
        return nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return float(nbytes) * (g - 1)
    if kind == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    if kind == "all-to-all":
        return nbytes * (g - 1) / g
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective {kind!r}")


@dataclass
class CollectiveStats:
    # per-kind: (count, result bytes, wire bytes per device)
    per_kind: dict = field(default_factory=dict)
    wire_bytes: float = 0.0           # total per device

    def add(self, kind: str, nbytes: int, wire: float) -> None:
        c, b, w = self.per_kind.get(kind, (0, 0, 0.0))
        self.per_kind[kind] = (c + 1, b + nbytes, w + wire)
        self.wire_bytes += wire


@dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    n_devices: int
    collectives: dict
    model_flops_global: float = 0.0      # 6·N·D or decode equivalent
    model_bytes_global: float = 0.0      # decode: active params + cache
    step_kind: str = "train"             # train | prefill | decode
    # wire bytes per device by link class ("nvlink", "network"); None:
    # all of them on the slowest
    wire_bytes_by_link: dict | None = None

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        by_link = self.wire_bytes_by_link
        if by_link is None:
            by_link = {"network": self.wire_bytes_per_device}
        return sum(w / link_bandwidth(link) for link, w in by_link.items())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline-optimal step time = max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs — remat/redundancy waste detector."""
        counted_global = self.flops_per_device * self.n_devices
        return self.model_flops_global / counted_global \
            if counted_global else 0.0

    @property
    def t_ideal(self) -> float:
        """The unavoidable floor for this step: useful-compute time for
        train/prefill; minimal HBM traffic (active params + cache, read
        once) for decode, which is bandwidth-bound by construction."""
        if self.step_kind == "decode" and self.model_bytes_global:
            return (self.model_bytes_global / self.n_devices) / HBM_BW
        return (self.model_flops_global / self.n_devices) / PEAK_FLOPS

    @property
    def roofline_fraction(self) -> float:
        """Fraction of roofline achieved: t_ideal / t_bound."""
        if self.t_bound <= 0:
            return 0.0
        return self.t_ideal / self.t_bound

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "n_devices": self.n_devices,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "t_bound_s": self.t_bound,
            "model_flops_global": self.model_flops_global,
            "model_bytes_global": self.model_bytes_global,
            "step_kind": self.step_kind,
            "t_ideal_s": self.t_ideal,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "collectives": {k: {"count": c, "result_bytes": b,
                                "wire_bytes": w}
                            for k, (c, b, w) in self.collectives.items()},
            "wire_bytes_by_link": dict(self.wire_bytes_by_link or {}),
        }


def model_flops(cfg, cell, param_count: int, active_param_count: int) -> float:
    """Useful model flops per step: 6·N_active·tokens for training,
    2·N_active·tokens for inference (fwd only)."""
    tokens = cell.global_batch * (cell.seq_len if cell.step != "decode" else 1)
    n = active_param_count
    return (6.0 if cell.step == "train" else 2.0) * n * tokens


def model_bytes(cfg, cell, active_param_count: int,
                cache_bytes: float = 0.0) -> float:
    """Minimal HBM traffic of one decode step: every active parameter and
    the whole KV/state cache are read once (bf16)."""
    return 2.0 * active_param_count + cache_bytes


def analyze(summary, n_devices: int, model_flops_global: float,
            model_bytes_global: float = 0.0,
            step_kind: str = "train") -> Roofline:
    """Roofline terms from one rank's counted step (`hlo_cost.CostSummary`:
    the per-device view)."""
    return Roofline(
        flops_per_device=summary.flops,
        bytes_per_device=summary.bytes_accessed,
        wire_bytes_per_device=summary.wire_bytes,
        n_devices=n_devices,
        collectives=summary.collectives,
        model_flops_global=model_flops_global,
        model_bytes_global=model_bytes_global,
        step_kind=step_kind,
        wire_bytes_by_link=dict(summary.wire_bytes_by_link),
    )


# -------------------------------------------------- the model kernels' work
def attn_pairs(B: int, S: int, T: int, causal: bool = True,
               window: int | None = None) -> int:
    """Allowed (query, key) pairs of one attention call with the ends of
    the query and key ranges aligned (query i at position T - S + i, key
    j at j): the shape-only count. A decode step is counted against a
    full cache."""
    p = np.arange(T - S, T, dtype=np.int64)
    hi = np.minimum(p, T - 1) if causal else np.full_like(p, T - 1)
    lo = np.maximum(p - window + 1, 0) if window is not None \
        else np.zeros_like(p)
    return B * int(np.maximum(hi - lo + 1, 0).sum())


def attn_cost(B: int, S: int, T: int, H: int, KV: int, dh: int,
              nbytes_el: int, causal: bool = True, window: int | None = None,
              pairs: int | None = None, pos_elems: int = 0) -> tuple:
    """One attention forward: 4·dh flops per allowed (query, key) pair and
    head (`pairs`; the shape-only `attn_pairs` when None), against q, k,
    v, o and `pos_elems` int32 positions moved once."""
    if pairs is None:
        pairs = attn_pairs(B, S, T, causal, window)
    flops = 4 * H * pairs * dh
    nbytes = nbytes_el * dh * (2 * B * S * H + 2 * B * T * KV) \
        + 4 * pos_elems
    return flops, nbytes


def bwd_cost(B: int, S: int, T: int, H: int, KV: int, dh: int,
             nbytes_el: int, causal: bool = True, window: int | None = None,
             pairs: int | None = None) -> tuple:
    """The attention backward: 5 products of 2·dh flops per allowed
    (query, key) pair and head (the scores again, dP, dV, dK, dQ),
    against q, o, dO, k, v read and dq, dk, dv written once."""
    if pairs is None:
        pairs = attn_pairs(B, S, T, causal, window)
    flops = 10 * dh * H * pairs
    nbytes = nbytes_el * dh * (4 * B * S * H + 4 * B * T * KV)
    return flops, nbytes


def int8_cost(B: int, S: int, T: int, H: int, KV: int, dh: int,
              q_bytes: int) -> tuple:
    """Int8 decode attention: 4·dh int8 operations a (row, key) against K
    and V int8 and their bf16 scales read once, q read and o written
    once."""
    ops = 4 * dh * B * S * H * T
    nbytes = 2 * B * T * KV * (dh + 2) + 2 * q_bytes * B * S * H * dh
    return ops, nbytes


def wkv_cost(B: int, S: int, H: int, dh: int, nbytes_el: int,
             with_s0: bool) -> tuple:
    """One wkv call: 2·dh² FMAs per (b, t, h), against r, k, v read once at
    their width, w read and out written in float32, u, s0 (when given)
    and s_fin in float32."""
    elems = B * S * H * dh
    nbytes = (3 * nbytes_el + 4 + 4) * elems + 4 * H * dh \
        + 4 * B * H * dh * dh * (2 if with_s0 else 1)
    flops = 4 * dh * dh * B * S * H
    return flops, nbytes


def wkv_bwd_cost(B: int, S: int, H: int, dh: int, nbytes_el: int) -> tuple:
    """The wkv backward: 14 flops per (b, t, h) and state entry (i, j)
    (the state once, k·v and an FMA; G's update, r·dout and an FMA; one
    FMA each of dr, dk, dv and dw's sums), against r, k, v at their
    width, w and dout float32 read once, dr, dk, dv at r's width and dw
    float32 written once, u and du."""
    elems = B * S * H * dh
    nbytes = (6 * nbytes_el + 12) * elems + 8 * H * dh
    flops = 14 * elems * dh
    return flops, nbytes


def scan_cost(B: int, S: int, D: int, N: int, with_h0: bool) -> tuple:
    """The unfused scan: 4 flops per (b, t, d, n) (a multiply and an add
    of the update, a multiply and an add of y's sum), against a, b, c
    read, y written, h0 (when given) read and h_fin written once, all
    float32."""
    nbytes = 4 * (2 * B * S * D * N + B * S * N + B * S * D
                  + B * D * N * (2 if with_h0 else 1))
    flops = 4 * B * S * D * N
    return flops, nbytes


def scan_fused_cost(B: int, S: int, D: int, N: int, nbytes_el: int,
                    with_h0: bool, with_D: bool) -> tuple:
    """The fused scan: 7 float32 operations per (b, t, d, n) (dt·A, the two
    products of b, the update's two, y's product and sum) and the D skip's
    2 per (b, t, d), against dt and y float32, x at its width, read or
    written once per (b, t, d); the B_ and C_ values once per (b, t); A,
    D, h0 and h_fin once. Its one ex2 per (b, t, d, n) is not a flop."""
    nbytes = (8 + nbytes_el) * B * S * D + 2 * nbytes_el * B * S * N \
        + 4 * D * N + (4 * D if with_D else 0) \
        + 4 * B * D * N * (2 if with_h0 else 1)
    flops = 7 * B * S * D * N + (2 * B * S * D if with_D else 0)
    return flops, nbytes


def scan_bwd_cost(B: int, S: int, D: int, N: int, nbytes_el: int) -> tuple:
    """The fused scan's backward with the D skip: 19 float32 operations per
    (b, t, d, n) (the state h_{t-1} again: dt·A, (dt·x)·B_ and the
    update's FMA, 4; G's FMA, 2; da = G·h·a, 2; dA's FMA, 2; d(dt)'s sum
    of da·A, 2; the sum of G·B_ that d(dt) and dx share, 2; dB_'s sum
    over d of G·(dt·x), 2; dC_'s of dy·h, 2; the carry a·G, 1) and 8 per
    (b, t, d) (dt·x, 1; d(dt)'s FMA of that shared sum with x, 2; dx =
    sum·dt + D·dy, 3; dD's FMA, 2), against dt, dy and d(dt) float32, x
    and dx at x's width per (b, t, d); B_, C_, dB_, dC_ per (b, t, n); A,
    dA, D, dD. Its one ex2 per (b, t, d, n) is not a flop."""
    nbytes = (12 + 2 * nbytes_el) * B * S * D + 4 * nbytes_el * B * S * N \
        + 8 * D * N + 8 * D
    flops = 19 * B * S * D * N + 8 * B * S * D
    return flops, nbytes
