"""The hand-written CUDA flash-attention kernel (`csrc/attention.cu`):
ctypes binding, argument checks and a launch counter.

`flash_attention` takes CUDA tensors in the model's layout — q (B, S, H,
dh), k and v (B, T, KV, dh), one dtype (bfloat16 or float32) — and
returns (B, S, H, dh) in q's dtype. Optional int32 `q_positions` (S,) and
`kv_positions` (T,) replace the end-aligned default; a negative key
position is an empty slot. `LAUNCHES["flash_attention"]` counts launches
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
    """flash_attention_launch(q, k, v, o, q_pos, kv_pos, B, S, T, H, KV,
    dh, causal, window, bf16, split_keys, workspace, tickets, stream)."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    handle.flash_attention_launch.argtypes = [vp] * 6 + [i] * 10 + [vp] * 3
    handle.flash_attention_launch.restype = i


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

LAUNCHES: dict[str, int] = {"flash_attention": 0}
LAUNCH_SHAPES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0
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
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device \
                or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             "tensor on q's CUDA device")
    for name, p, n in (("q_positions", q_positions, S),
                       ("kv_positions", kv_positions, T)):
        if p is not None and (p.shape != (n,) or p.dtype != torch.int32
                              or p.device != q.device
                              or not p.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 ({n},) on "
                             "q's device")
    if window is not None and not 1 <= window <= _MAX_INT:
        raise ValueError(f"window must be in [1, 2**31), not {window}")


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
        B, S, T, H, KV, dh, int(causal), window or 0,
        int(q.dtype == torch.bfloat16), split_keys,
        None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"flash_attention: CUDA kernel launch failed with "
                           f"cudaError {rc}")
