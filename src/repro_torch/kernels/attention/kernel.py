"""The hand-written CUDA attention kernels (`csrc/attention.cu`, and
`csrc/decode_int8.cu` and `csrc/attention_bwd.cu` in the same library):
ctypes bindings, argument checks and launch counters.

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

`flash_decode_int8` is decode attention against an int8 KV cache with
bf16 per-(b, t, kv head) scales (three launches: per-split softmax
stats, then p8·v8 per split, then the sum of the splits);
`flash_bwd` the backward of the forward kernels' function (three
launches: Δ and the log-sum-exp, dK/dV, dQ). Each counts its calls in
`LAUNCHES` under its own name.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from pathlib import Path

import torch

from .._build import Library

_MAX_GRID_YZ = 65535          # CUDA's limit on gridDim.y (KV) and .z (B)
_MAX_INT = 2**31 - 1          # the kernel indexes rows with int


def _declare(handle: ctypes.CDLL) -> None:
    """flash_attention_launch(q, k, v, o, q_pos, kv_pos, q_pos batch
    stride, kv_pos batch stride, B, S, T, H, KV, dh, causal, window, bf16,
    split_keys, workspace, tickets, stream)."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    handle.flash_attention_launch.argtypes = [vp] * 6 + [i] * 12 + [vp] * 3
    handle.flash_attention_launch.restype = i
    # flash_decode_int8_launch(q, k, v, k_scale, v_scale, o, q_pos, kv_pos,
    # q_pos batch stride, kv_pos batch stride, B, S, T, H, KV, dh, causal,
    # window, q bf16, split_keys, stats, part, rowps, stream)
    handle.flash_decode_int8_launch.argtypes = [vp] * 8 + [i] * 12 + [vp] * 4
    handle.flash_decode_int8_launch.restype = i
    # flash_bwd_launch(q, k, v, o, dout, dq, dk, dv, lse, delta, q_pos,
    # kv_pos, q_pos batch stride, kv_pos batch stride, B, S, T, H, KV, dh,
    # causal, window, bf16, stream)
    handle.flash_bwd_launch.argtypes = [vp] * 12 + [i] * 11 + [vp]
    handle.flash_bwd_launch.restype = i


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
# (decode_int8.cu: I_ROWS), keys per tile (I_BN) and at most this many
# splits of the keys
INT8_ROWS, INT8_TILE, INT8_MAX_SPLITS = 64, 64, 64

LAUNCHES: dict[str, int] = {"flash_attention": 0, "flash_decode_int8": 0,
                            "flash_bwd": 0}
LAUNCH_SHAPES: Counter = Counter()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCH_SHAPES.clear()


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_positions: torch.Tensor | None = None,
                    kv_positions: torch.Tensor | None = None) -> torch.Tensor:
    """Forward attention on the card. Raises on what the kernel does not
    take and when the launch fails; there is no other path."""
    _check(q, k, v, q_positions, kv_positions, window)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        launch(q, k, v, out, causal, window, q_positions, kv_positions)
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


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool, window: int | None,
           q_positions: torch.Tensor | None,
           kv_positions: torch.Tensor | None) -> None:
    """Bare launch on the current stream into preallocated `out`. Raises
    if the launch itself fails."""
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
        None if tickets is None else tickets.data_ptr(), stream)
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


def plan_int8(B: int, T: int, KV: int) -> tuple[int, int]:
    """flash_decode_int8's (n_split, keys per split): enough splits for
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
    the card; returns (B, S, H, dh) in q's dtype. Raises on what the
    kernel does not take and when a launch fails."""
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
    with torch.cuda.device(q.device):
        launch_int8(q, k, v, k_scale, v_scale, out, causal, window,
                    q_positions, kv_positions)
    LAUNCHES["flash_decode_int8"] += 1
    return out


def launch_int8(q, k, v, k_scale, v_scale, out, causal, window,
                q_positions, kv_positions, scratch=None) -> None:
    """Bare int8 decode launch on the current stream into `out`; the
    scratch (stats, part, rowps) is allocated unless given, as
    `int8_scratch` makes it."""
    lib = LIBRARY.lib()
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    _, keys = plan_int8(B, T, KV)
    stats, part, rowps = scratch or int8_scratch(q, k)
    rc = lib.flash_decode_int8_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), out.data_ptr(),
        None if q_positions is None else q_positions.data_ptr(),
        None if kv_positions is None else kv_positions.data_ptr(),
        _batch_stride(q_positions), _batch_stride(kv_positions),
        B, S, T, H, KV, dh, int(causal), window or 0,
        int(q.dtype == torch.bfloat16), keys, stats.data_ptr(),
        part.data_ptr(), rowps.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_decode_int8: CUDA kernel launch failed "
                           f"with cudaError {rc}")


def int8_scratch(q, k) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The int8 decode kernel's scratch for these shapes: per-split
    softmax stats (float32), per-split int32 partial outputs and the
    rows' (max, sum, ps)."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    n_split, _ = plan_int8(B, T, KV)
    R = S * (H // KV)
    return (torch.empty(B * KV * n_split * R * 3, dtype=torch.float32,
                        device=q.device),
            torch.empty(B * KV * n_split * R * dh, dtype=torch.int32,
                        device=q.device),
            torch.empty(B * KV * R * 3, dtype=torch.float32, device=q.device))


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
              window: int | None = None,
              q_positions: torch.Tensor | None = None,
              kv_positions: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of `flash_attention(q, k, v, ...)` at
    output `out` for the output's gradient `dout`, on the card, in the
    inputs' dtype. Raises on what the kernel does not take and when a
    launch fails."""
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out and dout must be {tuple(q.shape)} {q.dtype}; "
                         f"got {tuple(out.shape)} {out.dtype}, "
                         f"{tuple(dout.shape)} {dout.dtype}")
    _check(q, k, v, q_positions, kv_positions, window)
    _check_cuda({"q": q, "out": out, "dout": dout})
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    with torch.cuda.device(q.device):
        launch_bwd(q, k, v, out, dout, dq, dk, dv, causal, window,
                   q_positions, kv_positions)
    LAUNCHES["flash_bwd"] += 1
    return dq, dk, dv


def launch_bwd(q, k, v, out, dout, dq, dk, dv, causal, window, q_positions,
               kv_positions, scratch=None) -> None:
    """Bare backward launch on the current stream into dq, dk, dv; the
    float32 log-sum-exp and Δ scratch (B·S·H each) is allocated unless
    given."""
    lib = LIBRARY.lib()
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    if scratch is None:
        scratch = torch.empty(2, B * S * H, dtype=torch.float32,
                              device=q.device)
    rc = lib.flash_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        scratch[0].data_ptr(), scratch[1].data_ptr(),
        None if q_positions is None else q_positions.data_ptr(),
        None if kv_positions is None else kv_positions.data_ptr(),
        _batch_stride(q_positions), _batch_stride(kv_positions),
        B, S, T, H, KV, dh, int(causal), window or 0,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_bwd: CUDA kernel launch failed with "
                           f"cudaError {rc}")
