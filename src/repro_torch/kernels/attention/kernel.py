"""The hand-written CUDA attention kernels (`csrc/attention.cu`, and
`csrc/decode_int8.cu`, `csrc/attention_bwd.cu` and
`csrc/attention_bwd_tc.cu` in the same library): ctypes bindings,
argument checks and launch counters.

`flash_attention` takes CUDA tensors in the model's layout — q (B, S, H,
dh), k and v (B, T, KV, dh), one dtype (bfloat16 or float32) — and
returns (B, S, H, dh) in q's dtype. Optional int32 `q_positions` (S,) or
(B, S) and `kv_positions` (T,) or (B, T) replace the end-aligned default
(one row of positions shared by the batch, or one a batch row, as
M-RoPE's temporal ids are); a negative key position is an empty slot. `LAUNCHES["flash_attention"]` counts launches
and `LAUNCH_SHAPES` counts them by (B, S, T, H, KV, dh, dtype). `launch`
is the bare call beneath, for timing: it checks nothing, counts nothing
and allocates nothing once its stream's workspace exists. The library is
built by nvcc on first launch, never at import.

In bfloat16 the shape alone picks one of two kernels (`plan`): up to
`DECODE_ROWS` rows (query position, head of a KV group) per (batch, KV
head) go to the split-KV decode kernel, over `n_split` ranges of keys;
more go to the TMA + wgmma prefill kernel. float32 has one kernel. The
decode kernel's partial results go to a float32 workspace and its
per-(batch, KV head) tickets to an int32 array that each launch leaves
at zero; both are held per (device, stream) and grown as shapes need, so
launches on one stream share them in order.

Given a float32 (B, S, H) `lse`, the prefill kernel also writes each
row's log-sum-exp there (`forward_lse` says when that kernel runs), which
spares the backward its recomputation.

`flash_decode_int8` is decode attention against an int8 KV cache with
bf16 per-(b, t, kv head) scales, by one of two routes (`plan_int8`):
"cluster", one launch of a thread-block cluster per (batch, KV head)
that reads K and V once, where the cluster's shared memory holds the
rows' scores; else "split" (three launches: per-split softmax stats,
then p8·v8 per split, then the sum of the splits), counted by route in
`INT8_ROUTES`;
`flash_bwd` the backward of the forward kernels' function (three
launches: Δ, and the log-sum-exp unless the forward's is given; dK/dV;
dQ), by one of two routes (`plan_bwd`): bf16 at dh 64 and 128 on the
tensor cores (`attention_bwd_tc.cu`), float32 and dh 32 on plain FMAs
(`attention_bwd.cu`). Each kernel counts its calls in `LAUNCHES` under
its own name, and `BWD_ROUTES` counts the backward's calls by route.

Under a cost counter (`kernels/_cost.py`) each of the three wrappers
records its call with `launch.roofline`'s `attn_cost`, `int8_cost` or
`bwd_cost` (the shape-only count of allowed pairs), and on meta tensors
only makes its outputs.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from pathlib import Path

import torch

from ...launch.roofline import attn_cost, bwd_cost, int8_cost
from .. import _cost
from .._build import Library

_MAX_GRID_YZ = 65535          # CUDA's limit on gridDim.y (KV) and .z (B)
_MAX_INT = 2**31 - 1          # the kernel indexes rows with int


def _declare(handle: ctypes.CDLL) -> None:
    """flash_attention_launch(q, k, v, o, q_pos, kv_pos, q_pos batch
    stride, kv_pos batch stride, B, S, T, H, KV, dh, causal, window, bf16,
    split_keys, workspace, tickets, lse, stream)."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    handle.flash_attention_launch.argtypes = [vp] * 6 + [i] * 12 + [vp] * 4
    handle.flash_attention_launch.restype = i
    # flash_decode_int8_launch(q, k, v, k_scale, v_scale, o, q_pos, kv_pos,
    # q_pos batch stride, kv_pos batch stride, B, S, T, H, KV, dh, causal,
    # window, q bf16, split_keys, stats, part, rowps, stream)
    handle.flash_decode_int8_launch.argtypes = [vp] * 8 + [i] * 12 + [vp] * 4
    handle.flash_decode_int8_launch.restype = i
    # flash_decode_int8_cluster_launch(the same up to q bf16, cluster,
    # keys a block, stream)
    handle.flash_decode_int8_cluster_launch.argtypes = [vp] * 8 + [i] * 13 \
        + [vp]
    handle.flash_decode_int8_cluster_launch.restype = i
    # flash_bwd_launch(q, k, v, o, dout, dq, dk, dv, lse, delta, q_pos,
    # kv_pos, q_pos batch stride, kv_pos batch stride, B, S, T, H, KV, dh,
    # causal, window, bf16, lse_ready, stream); flash_bwd_tc_launch the
    # same without bf16
    handle.flash_bwd_launch.argtypes = [vp] * 12 + [i] * 12 + [vp]
    handle.flash_bwd_launch.restype = i
    handle.flash_bwd_tc_launch.argtypes = [vp] * 12 + [i] * 11 + [vp]
    handle.flash_bwd_tc_launch.restype = i


LIBRARY = Library("attention", Path(__file__).resolve().parent / "csrc",
                  _declare)
HEAD_DIMS = (32, 64, 128)     # the head sizes the kernel is built for

# The decode kernel's limits (attention.cu: D_ROWS, D_BN, D_MAX_SPLITS)
# and the card it fills: SMS is an H100's count of SMs.
DECODE_ROWS = 64              # rows per (batch, KV head)
DECODE_TILE = 64              # keys per tile: no more splits than tiles
DECODE_MAX_SPLITS = 64
# 2.5 blocks per SM where T allows: 11 splits of 185 keys (352 blocks) at
# the LM path's decode shape measured faster than 9 (288) or 16 (512), and
# a split count under two waves (8, 256 blocks) is not taken (PERF.md)
SMS, DECODE_WAVES = 132, 2.5

# int8 decode: rows (query position, head of a KV group) per (b, kvh)
# (decode_int8.cu: I_ROWS), keys per tile (I_BN, C_BN) and at most this
# many splits of the keys on the split route
INT8_ROWS, INT8_TILE, INT8_MAX_SPLITS = 64, 64, 64
# the cluster route (decode_int8.cu: C_STAGES, sizeof(CSmall)): its
# cluster sizes, and a block's shared memory: at most INT8_SMEM_PAIR
# bytes lets two blocks share an SM (228 KB, 1 KB of it each block's
# own), INT8_SMEM_MAX is a block's most
INT8_CLUSTERS = (1, 2, 4, 8, 16)
INT8_STAGES, INT8_SMALL = 5, 3632
INT8_SMEM_PAIR, INT8_SMEM_MAX = 115_712, 232_448

# the backward's routes: bf16 at these head sizes on the tensor cores
BWD_TC_HEAD_DIMS = (64, 128)

LAUNCHES: dict[str, int] = {"flash_attention": 0, "flash_decode_int8": 0,
                            "flash_bwd": 0}
LAUNCH_SHAPES: Counter = Counter()
BWD_ROUTES: Counter = Counter()     # flash_bwd calls by plan_bwd's route
INT8_ROUTES: Counter = Counter()    # flash_decode_int8 calls by route


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCH_SHAPES.clear()
    BWD_ROUTES.clear()
    INT8_ROUTES.clear()


def _check(q, k, v, q_positions, kv_positions, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, S, H, dh) and k, v (B, T, KV, dh);"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, dh = q.shape
    _, T, KV, dh_k = k.shape
    if k.shape[0] != B or dh_k != dh or KV < 1 or H % KV:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")
    if min(B, S, T) < 1:
        raise ValueError("B, S and T must be at least 1")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head size {dh} not built; the kernel takes "
                         f"{HEAD_DIMS}")
    if B > _MAX_GRID_YZ or KV > _MAX_GRID_YZ or S * H > _MAX_INT \
            or B * max(S * H, T * KV) * dh > 2**62:
        raise ValueError(f"shapes {tuple(q.shape)}/{tuple(k.shape)} "
                         "exceed the kernel's grid")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be bfloat16 or all float32; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    _check_positions(q, k, q_positions, kv_positions)
    if window is not None and not 1 <= window <= _MAX_INT:
        raise ValueError(f"window must be in [1, 2**31), not {window}")
    _check_cuda({"q": q, "k": k, "v": v})


def plan(B: int, S: int, T: int, H: int, KV: int) -> tuple[str, int, int]:
    """The bf16 kernel for this shape: ("decode", n_split, keys per split)
    or ("prefill", 1, T).

    Decode takes S·H/KV <= DECODE_ROWS rows per (b, kvh) and cuts the T
    keys into n_split equal ranges: enough for DECODE_WAVES blocks per SM,
    no more than T has tiles, none empty."""
    if S * (H // KV) > DECODE_ROWS:
        return "prefill", 1, T
    want = math.ceil(DECODE_WAVES * SMS / (B * KV))
    n = max(1, min(want, math.ceil(T / DECODE_TILE), DECODE_MAX_SPLITS))
    keys = math.ceil(T / n)
    return "decode", math.ceil(T / keys), keys


# (device index, stream) -> (float32 workspace, int32 tickets)
_WORKSPACE: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, stream: int, floats: int,
               tickets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The decode kernel's scratch for this stream, grown if too small."""
    key = (device.index, stream)
    ws, tk = _WORKSPACE.get(key, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=torch.float32, device=device)
    if tk is None or tk.numel() < tickets:
        tk = torch.zeros(tickets, dtype=torch.int32, device=device)
    _WORKSPACE[key] = ws, tk
    return ws, tk


def forward_lse(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Does the forward kernel for these shapes (the bf16 prefill kernel)
    write the rows' log-sum-exp when given an `lse`?"""
    B, S, H, _ = q.shape
    return q.dtype == torch.bfloat16 and \
        plan(B, S, k.shape[1], H, k.shape[2])[0] == "prefill"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_positions: torch.Tensor | None = None,
                    kv_positions: torch.Tensor | None = None,
                    lse: torch.Tensor | None = None) -> torch.Tensor:
    """Forward attention on the card; with `lse`, a float32 (B, S, H)
    tensor, the prefill kernel also writes each row's natural
    log-sum-exp of its scaled scores there (+inf for a row with no allowed
    key). Raises on what the kernel does not take (an `lse` where
    `forward_lse` is false among it) and when the launch fails; there is
    no other path."""
    if _cost.ACTIVE:
        B, S, H, dh = q.shape
        return _cost.record(
            "flash_attention",
            attn_cost(B, S, k.shape[1], H, k.shape[2], dh, q.element_size(),
                      causal, window,
                      pos_elems=_numel(q_positions) + _numel(kv_positions)),
            q, lambda: torch.empty_like(q),
            lambda: _flash_attention(q, k, v, causal, window, q_positions,
                                     kv_positions, lse))
    return _flash_attention(q, k, v, causal, window, q_positions,
                            kv_positions, lse)


def _numel(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.numel()


def _flash_attention(q, k, v, causal, window, q_positions, kv_positions,
                     lse) -> torch.Tensor:
    _check(q, k, v, q_positions, kv_positions, window)
    if lse is not None:
        if not forward_lse(q, k):
            raise ValueError("only the bf16 prefill kernel writes the "
                             "log-sum-exp (kernel.forward_lse)")
        _check_lse(q, lse)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        launch(q, k, v, out, causal, window, q_positions, kv_positions, lse)
    LAUNCHES["flash_attention"] += 1
    B, S, H, dh = q.shape
    LAUNCH_SHAPES[(B, S, k.shape[1], H, k.shape[2], dh,
                   str(q.dtype).removeprefix("torch."))] += 1
    return out


def _batch_stride(positions: torch.Tensor | None) -> int:
    """Elements from one batch row's positions to the next: 0 for one
    row shared by the batch."""
    return 0 if positions is None or positions.dim() == 1 \
        else positions.shape[1]


def _check_lse(q: torch.Tensor, lse: torch.Tensor) -> None:
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 "
                         f"{tuple(q.shape[:3])} on q's device")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool, window: int | None,
           q_positions: torch.Tensor | None,
           kv_positions: torch.Tensor | None,
           lse: torch.Tensor | None = None) -> None:
    """Bare launch on the current stream into preallocated `out` (and
    `lse`, by the prefill kernel only). Raises if the launch itself
    fails."""
    lib = LIBRARY.lib()
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    split_keys, ws, tickets = 0, None, None
    if q.dtype == torch.bfloat16:
        kind, n_split, keys = plan(B, S, T, H, KV)
        if kind == "decode":
            split_keys = keys
            ws, tickets = _workspace(q.device, stream,
                                     B * KV * n_split * S * (H // KV)
                                     * (dh + 2), B * KV)
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if q_positions is None else q_positions.data_ptr(),
        None if kv_positions is None else kv_positions.data_ptr(),
        _batch_stride(q_positions), _batch_stride(kv_positions),
        B, S, T, H, KV, dh, int(causal), window or 0,
        int(q.dtype == torch.bfloat16), split_keys,
        None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        None if lse is None else lse.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"flash_attention: CUDA kernel launch failed with "
                           f"cudaError {rc}")


def _check_positions(q, k, q_positions, kv_positions) -> None:
    B, S = q.shape[:2]
    T = k.shape[1]
    for name, p, n in (("q_positions", q_positions, S),
                       ("kv_positions", kv_positions, T)):
        if p is not None and (p.shape not in ((n,), (B, n))
                              or p.dtype != torch.int32
                              or p.device != q.device
                              or not p.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 ({n},) or "
                             f"({B}, {n}) on q's device")


def _check_cuda(tensors: dict, align: int = 16) -> None:
    """Each tensor contiguous, `align`-byte aligned, on the first one's
    CUDA device."""
    dev = next(iter(tensors.values())).device
    for name, x in tensors.items():
        if x.device.type != "cuda" or x.device != dev \
                or not x.is_contiguous() or x.data_ptr() % align:
            raise ValueError(f"{name} must be a contiguous, {align}-byte "
                             "aligned tensor on q's CUDA device")


def int8_cluster_smem(R: int, keys: int, dh: int) -> int:
    """Shared memory (bytes) of a cluster-route block of R rows and `keys`
    keys (decode_int8.cu: `cluster_layout`): up to 1 KB to reach a
    1024-byte boundary, the ring of K/V tiles, the scores (rows of P
    float32, P = 4 mod 32 and at least dh), the keys' bf16 v_scale and
    the per-row state."""
    p = -(-max(keys, dh) // 4) * 4
    p += (4 - p % 32) % 32
    return (1024 + INT8_STAGES * INT8_TILE * dh + R * p * 4
            + -(-keys * 2 // 16) * 16 + INT8_SMALL)


def plan_int8(B: int, T: int, KV: int, R: int, dh: int
              ) -> tuple[str, int, int]:
    """flash_decode_int8's route for R rows per (b, kv head): ("cluster",
    C, keys a block) or ("split", n_split, keys a split).

    C is the smallest cluster size with B·KV·C blocks for the SMS SMs
    (no more than T has tiles of keys) whose blocks' shared memory —
    mostly the rows' scores, R·keys·4 bytes — fits INT8_SMEM_PAIR (two
    blocks an SM), else INT8_SMEM_MAX; a shape no cluster of 16 holds
    takes the split route."""
    if R > INT8_ROWS:
        raise ValueError(f"{R} rows per KV head; the int8 decode kernel "
                         f"takes at most {INT8_ROWS}")
    fill = next((c for c in INT8_CLUSTERS if B * KV * c >= SMS),
                INT8_CLUSTERS[-1])
    tiles = max(c for c in INT8_CLUSTERS if c == 1 or c * INT8_TILE <= T)
    for budget in (INT8_SMEM_PAIR, INT8_SMEM_MAX):
        for c in INT8_CLUSTERS:
            keys = math.ceil(T / c)
            if c >= min(fill, tiles) and \
                    int8_cluster_smem(R, keys, dh) <= budget:
                return "cluster", c, keys
    return ("split", *plan_int8_split(B, T, KV))


def plan_int8_split(B: int, T: int, KV: int) -> tuple[int, int]:
    """The split route's (n_split, keys per split): enough splits for
    DECODE_WAVES blocks per SM, no more than T has tiles or
    INT8_MAX_SPLITS, none empty."""
    want = math.ceil(DECODE_WAVES * SMS / (B * KV))
    n = max(1, min(want, math.ceil(T / INT8_TILE), INT8_MAX_SPLITS))
    keys = math.ceil(T / n)
    return math.ceil(T / keys), keys


def flash_decode_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      k_scale: torch.Tensor, v_scale: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      q_positions: torch.Tensor | None = None,
                      kv_positions: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Attention of q (B, S, H, dh), bf16 or float32, with S·H/KV <= 64,
    against int8 k, v (B, T, KV, dh) and their bf16 scales (B, T, KV), on
    the card, by `plan_int8`'s route; returns (B, S, H, dh) in q's dtype.
    Raises on what the kernel does not take and when a launch fails (a
    cluster the card cannot place among them)."""
    if _cost.ACTIVE:
        B, S, H, dh = q.shape
        return _cost.record(
            "flash_decode_int8",
            int8_cost(B, S, k.shape[1], H, k.shape[2], dh, q.element_size()),
            q, lambda: torch.empty_like(q),
            lambda: _flash_decode_int8(q, k, v, k_scale, v_scale, causal,
                                       window, q_positions, kv_positions))
    return _flash_decode_int8(q, k, v, k_scale, v_scale, causal, window,
                              q_positions, kv_positions)


def _flash_decode_int8(q, k, v, k_scale, v_scale, causal, window,
                       q_positions, kv_positions) -> torch.Tensor:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k_scale.shape != k.shape[:3] or v_scale.shape != k.shape[:3]:
        raise ValueError(f"q must be (B, S, H, dh), k and v (B, T, KV, dh) "
                         f"and the scales (B, T, KV); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(k_scale.shape)}")
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != dh or H % KV or min(B, S, T) < 1:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if S * (H // KV) > INT8_ROWS:
        raise ValueError(f"{S * (H // KV)} rows per KV head; the int8 decode "
                         f"kernel takes at most {INT8_ROWS}")
    if dh not in HEAD_DIMS or B > _MAX_GRID_YZ or KV > _MAX_GRID_YZ \
            or B * T * KV * dh > 2**62:
        raise ValueError(f"shapes {tuple(q.shape)}/{tuple(k.shape)} are not "
                         "ones the int8 decode kernel takes")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != torch.int8 or v.dtype != torch.int8 \
            or k_scale.dtype != torch.bfloat16 \
            or v_scale.dtype != torch.bfloat16:
        raise TypeError("q must be bfloat16 or float32, k and v int8 and "
                        f"the scales bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}, {k_scale.dtype}, {v_scale.dtype}")
    if window is not None and not 1 <= window <= _MAX_INT:
        raise ValueError(f"window must be in [1, 2**31), not {window}")
    _check_cuda({"q": q, "k": k, "v": v})          # 16-byte loads of k
    _check_cuda({"q": q, "k_scale": k_scale, "v_scale": v_scale}, align=2)
    _check_positions(q, k, q_positions, kv_positions)
    out = torch.empty_like(q)
    route = plan_int8(B, T, KV, S * (H // KV), dh)[0]
    with torch.cuda.device(q.device):
        launch_int8(q, k, v, k_scale, v_scale, out, causal, window,
                    q_positions, kv_positions, route=route)
    LAUNCHES["flash_decode_int8"] += 1
    INT8_ROUTES[route] += 1
    return out


def launch_int8(q, k, v, k_scale, v_scale, out, causal, window,
                q_positions, kv_positions, scratch=None, route=None) -> None:
    """Bare int8 decode launch on the current stream into `out` by
    `route` ("cluster" or "split"; `plan_int8`'s when None; "cluster"
    raises where `plan_int8` gives the shape no cluster). The split
    route's scratch (stats, part, rowps) is allocated unless given, as
    `int8_scratch` makes it."""
    lib = LIBRARY.lib()
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    planned, n, keys = plan_int8(B, T, KV, S * (H // KV), dh)
    route = route or planned
    if route not in ("cluster", "split") or (route == "cluster"
                                             and planned != "cluster"):
        raise ValueError(f"route {route!r} does not take rows "
                         f"{S * (H // KV)} at T {T}, dh {dh}")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), out.data_ptr(),
            None if q_positions is None else q_positions.data_ptr(),
            None if kv_positions is None else kv_positions.data_ptr(),
            _batch_stride(q_positions), _batch_stride(kv_positions),
            B, S, T, H, KV, dh, int(causal), window or 0,
            int(q.dtype == torch.bfloat16))
    stream = torch.cuda.current_stream().cuda_stream
    if route == "cluster":
        rc = lib.flash_decode_int8_cluster_launch(*args, n, keys, stream)
    else:
        stats, part, rowps = scratch or int8_scratch(q, k)
        rc = lib.flash_decode_int8_launch(
            *args, plan_int8_split(B, T, KV)[1], stats.data_ptr(),
            part.data_ptr(), rowps.data_ptr(), stream)
    if rc:
        raise RuntimeError(
            f"flash_decode_int8 ({route}): CUDA kernel launch failed with "
            f"cudaError {rc}" + (" (9: no cluster of this size and shared "
                                 "memory fits on the card)" if rc == 9
                                 else ""))


def int8_scratch(q, k) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The split route's scratch for these shapes: per-split softmax
    stats (float32), per-split int32 partial outputs and the rows' (max,
    sum, ps)."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    n_split, _ = plan_int8_split(B, T, KV)
    R = S * (H // KV)
    return (torch.empty(B * KV * n_split * R * 3, dtype=torch.float32,
                        device=q.device),
            torch.empty(B * KV * n_split * R * dh, dtype=torch.int32,
                        device=q.device),
            torch.empty(B * KV * R * 3, dtype=torch.float32, device=q.device))


def plan_bwd(dtype: torch.dtype, dh: int) -> str:
    """The backward's route: "tc", the tensor-core kernels
    (`attention_bwd_tc.cu`), for bf16 at dh 64 and 128; "fma", the plain
    FMA kernels (`attention_bwd.cu`), for float32 (TF32 would not meet
    its 1e-4) and dh 32."""
    if dtype == torch.bfloat16 and dh in BWD_TC_HEAD_DIMS:
        return "tc"
    return "fma"


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
              window: int | None = None,
              q_positions: torch.Tensor | None = None,
              kv_positions: torch.Tensor | None = None,
              lse: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of `flash_attention(q, k, v, ...)` at
    output `out` for the output's gradient `dout`, on the card, in the
    inputs' dtype, by `plan_bwd`'s route; `lse` is the forward's
    log-sum-exp (float32 (B, S, H), as `flash_attention(..., lse=)`
    wrote it) or None, and then the pre-pass computes it. Raises on what
    the kernels do not take and when a launch fails."""
    if _cost.ACTIVE:
        B, S, H, dh = q.shape
        return _cost.record(
            "flash_bwd",
            bwd_cost(B, S, k.shape[1], H, k.shape[2], dh, q.element_size(),
                     causal, window),
            q, lambda: tuple(torch.empty_like(x) for x in (q, k, v)),
            lambda: _flash_bwd(q, k, v, out, dout, causal, window,
                               q_positions, kv_positions, lse))
    return _flash_bwd(q, k, v, out, dout, causal, window, q_positions,
                      kv_positions, lse)


def _flash_bwd(q, k, v, out, dout, causal, window, q_positions,
               kv_positions, lse) -> tuple:
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out and dout must be {tuple(q.shape)} {q.dtype}; "
                         f"got {tuple(out.shape)} {out.dtype}, "
                         f"{tuple(dout.shape)} {dout.dtype}")
    _check(q, k, v, q_positions, kv_positions, window)
    _check_cuda({"q": q, "out": out, "dout": dout})
    if lse is not None:
        _check_lse(q, lse)
    route = plan_bwd(q.dtype, q.shape[3])
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    with torch.cuda.device(q.device):
        launch_bwd(q, k, v, out, dout, dq, dk, dv, causal, window,
                   q_positions, kv_positions, lse=lse, route=route)
    LAUNCHES["flash_bwd"] += 1
    BWD_ROUTES[route] += 1
    return dq, dk, dv


def launch_bwd(q, k, v, out, dout, dq, dk, dv, causal, window, q_positions,
               kv_positions, scratch=None, lse=None, route=None) -> None:
    """Bare backward launch on the current stream into dq, dk, dv by
    `route` ("tc" or "fma"; `plan_bwd`'s when None, and "tc" raises
    where that route does not take the dtype or dh). The float32 scratch
    (2, B·S·H) holds the log-sum-exp and Δ and is allocated unless
    given; a given `lse` (the forward's) takes the first's place and is
    not recomputed."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    route = route or plan_bwd(q.dtype, dh)
    if route not in ("tc", "fma") or (route == "tc"
                                      and plan_bwd(q.dtype, dh) != "tc"):
        raise ValueError(f"route {route!r} does not take {q.dtype} at dh "
                         f"{dh}")
    lib = LIBRARY.lib()
    if scratch is None:
        scratch = torch.empty(2, B * S * H, dtype=torch.float32,
                              device=q.device)
    lse_ptr = scratch[0].data_ptr() if lse is None else lse.data_ptr()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse_ptr, scratch[1].data_ptr(),
            None if q_positions is None else q_positions.data_ptr(),
            None if kv_positions is None else kv_positions.data_ptr(),
            _batch_stride(q_positions), _batch_stride(kv_positions),
            B, S, T, H, KV, dh, int(causal), window or 0)
    stream = torch.cuda.current_stream().cuda_stream
    if route == "tc":
        rc = lib.flash_bwd_tc_launch(*args, int(lse is not None), stream)
    else:
        rc = lib.flash_bwd_launch(*args, int(q.dtype == torch.bfloat16),
                                  int(lse is not None), stream)
    if rc:
        raise RuntimeError(f"flash_bwd ({route}): CUDA kernel launch failed "
                           f"with cudaError {rc}")
