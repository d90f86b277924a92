"""The hand-written CUDA wkv kernels (`csrc/wkv.cu`): ctypes binding,
argument checks, the plan of a launch and a launch counter.

`wkv_cuda` takes CUDA tensors in the model's layout — r, k, v (B, S, H,
dh), one dtype (bfloat16 or float32), w (B, S, H, dh) and u (H, dh)
float32, optional s0 (B, H, dh, dh) float32 — and returns (out (B, S, H,
dh) float32, s_fin (B, H, dh, dh) float32). It refuses a bfloat16 w: a
decay of 0.999 rounds to 0.99609 there. One call is one launch, of one
of the two kernels that `plan` names from the shape:

- `wkv_prefill` (S > 1): the chunked form on tensor cores. A block per
  64 value columns of a (b, h) (32 at dh = 32): 4 producer warps prepare
  each chunk of 16 steps (the decays' products and the chunk's 16 × 16
  step matrix, every entry an exact product of decays, split into TF32
  hi and lo parts) in shared memory while 4
  consumer warps (2 at dh = 32) run the previous chunk's three products
  as TF32 mma, each holding its 16 columns of the state in registers
  across the chunks.
- `wkv_decode` (S = 1): a block per 32 value columns of a (b, h), one
  thread per key and 4 columns, out summed over the keys in the block.

`plan` decides every launch (grid, threads, shared memory) and the
library refuses a plan it was not built for. `LAUNCHES["wkv"]` counts
launches and `LAUNCH_SHAPES` counts them by (B, S, H, dh, dtype, s0
given). `launch` is the bare call beneath, for timing: it checks nothing
and counts nothing. The library is built by nvcc on first launch, never
at import.

`wkv_bwd_cuda` is the backward (`csrc/wkv_bwd.cu`, port only): given the
forward's inputs, the output's gradient dout (B, S, H, dh) float32 and
optionally the final state's ds_fin, it returns (dr, dk, dv in r's
dtype, dw (B, S, H, dh) float32, du (H, dh) float32, ds0 or None when s0
is None). One launch call runs three kernels: the states pass (the state
before each chunk of `BWD_CHUNK` steps and the gradient after it, each a
serial walk over chunks in the chunked TF32 form of `wkv_prefill`, into
a scratch buffer), the chunk pass (a block per (b, h, chunk) and tile of
keys, parallel over chunks: each gradient as chunk products of those
two matrices and the chunk's inputs, `ref.wkv_bwd_chunks_ref`'s
formulas) and a finish that adds du over (b, chunk) in one order.
`plan_bwd` decides it, `LAUNCHES["wkv_bwd"]` counts it and `launch_bwd`
is its bare call.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import torch

from .._build import Library

_MAX_INT = 2**31 - 1          # the most blocks a 1D grid takes


def _declare(handle: ctypes.CDLL) -> None:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    handle.wkv_launch.argtypes = [vp] * 8 + [i] * 5 + [ll, i, ll, vp]
    handle.wkv_launch.restype = i
    handle.wkv_bwd_launch.argtypes = [vp] * 15 + [i] * 5 + [ll, i, ll,
                                                            ll, i, ll, ll, vp]
    handle.wkv_bwd_launch.restype = i


LIBRARY = Library("rwkv", Path(__file__).resolve().parent / "csrc", _declare)
HEAD_DIMS = (32, 64, 128)     # the head sizes the kernel is built for

# The tiling `csrc/wkv.cu` is built for (its P_T, P_NP, D_JT, PrefillCfg
# and PrefillSmem).
CHUNK = 16                    # prefill: steps per chunk
PRODUCER_WARPS = 4            # prefill: warps that prepare the chunks
RAW_STAGES = 3                # prefill: stages of raw input
DECODE_COLS = 32              # decode: value columns per block


class Plan(NamedTuple):
    """One launch of `wkv_launch`."""
    kernel: str               # "prefill" (S > 1) or "decode" (S = 1)
    cols: int                 # value columns per block
    chunk: int                # steps per chunk (1 for decode)
    blocks: int               # 1D grid, the column tile fastest
    threads: int              # per block
    smem_bytes: int           # shared memory per block


@functools.lru_cache(maxsize=256)
def plan(B: int, S: int, H: int, dh: int,
         dtype: torch.dtype = torch.bfloat16) -> Plan:
    """The kernel and tiling for r, k, v of `dtype` at (B, S, H, dh); the
    library launches exactly this or refuses it."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"head size {dh} not built; the kernel takes "
                         f"{HEAD_DIMS}")
    if S == 1:
        # a thread per (key, 4 columns); out is summed over the warps
        threads = dh * DECODE_COLS // 4
        return Plan("decode", DECODE_COLS, 1, B * H * (dh // DECODE_COLS),
                    threads, threads // 32 * (DECODE_COLS // 4) * 16)
    es = 2 if dtype == torch.bfloat16 else 4
    cols = 64 if dh >= 64 else 32
    consumers = cols // 16                  # warps of 16 value columns
    # RAW_STAGES stages of raw r, k, w, v; two prepared chunks: r~ and k~ as
    # TF32 hi/lo in rows of 2 dh + 16 floats, A as hi/lo in rows of 2
    # (CHUNK + 4), the chunk's decay; the producers' level vectors (4
    # levels × 8 rows each side, rows of dh + 4)
    stage = CHUNK * (2 * dh * es + 4 * dh + cols * es)
    prepared = (2 * CHUNK * (2 * dh + 16) * 4 + CHUNK * 2 * (CHUNK + 4) * 4
                + dh * 4)
    levels = 2 * 32 * (dh + 4) * 4
    return Plan("prefill", cols, CHUNK, B * H * (dh // cols),
                32 * (consumers + PRODUCER_WARPS),
                RAW_STAGES * stage + 2 * prepared + levels)


# The backward's tiling (`csrc/wkv_bwd.cu`'s BC, StatesCfg and ChunkCfg).
BWD_CHUNK = 16                # steps between the saved chunk matrices
BWD_STATE_COLS = 32           # states pass: value columns a block
BWD_STATE_KSPLIT = 2          # states pass: warps sharing 16 columns' keys
BWD_KEYS = 64                 # chunk pass: keys a block (of dh)
BWD_THREADS = 256             # chunk pass: threads a block


class BwdPlan(NamedTuple):
    """One call of `wkv_bwd_launch`: its three kernels."""
    state_cols: int           # states pass: value columns a block
    state_blocks: int         # both directions, column tiles fastest
    state_threads: int        # a warp per 16 columns and half the keys
    state_smem: int
    key_tiles: int            # chunk pass: blocks a (b, h, chunk)
    blocks: int               # chunk pass
    threads: int
    smem_bytes: int
    chunks: int               # chunk matrices a (b, h)
    scratch_floats: int       # S_c and G_c, du's and dv's partials


@functools.lru_cache(maxsize=256)
def plan_bwd(B: int, S: int, H: int, dh: int,
             dtype: torch.dtype = torch.bfloat16) -> BwdPlan:
    """The backward's tiling at (B, S, H, dh) for r, k, v of `dtype`;
    the library launches exactly this or refuses it."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"head size {dh} not built; the kernel takes "
                         f"{HEAD_DIMS}")
    T, es = BWD_CHUNK, 2 if dtype == torch.bfloat16 else 4
    # states pass: three stages of raw r or k, w, and v or dout (rows of
    # cols + 8 at 4 bytes at most); the prepared chunk ({hi, lo} rows of
    # 2 dh + 8 floats) and its decay
    cols = min(dh, BWD_STATE_COLS)
    stage = T * dh * es + T * dh * 4 + T * (cols + 8) * 4
    state_smem = 3 * stage + T * (2 * dh + 8) * 4 + dh * 4
    # chunk pass (floats): S_c's and G_c's rows of the keys, later each
    # key's Cw and the staged dr, dk, dw; r, k, w, P, Q, J; v, dout and Z
    # in rows of dh + 4; k~ {hi, lo}; X, Y, B and A in rows of T + 1; g
    # and du's part from each of the threads a key
    keys = min(dh, BWD_KEYS)
    rs, ts, cws = dh + 4, T + 1, T * (T - 1) // 2 + 1
    union = max(2 * keys * rs, keys * cws + 3 * T * keys)
    smem = 4 * (union + 6 * T * keys + 3 * T * rs + T * (2 * keys + 8)
                + 2 * keys * ts + 2 * T * ts + keys + BWD_THREADS)
    key_tiles, chunks = dh // keys, -(-S // T)
    scratch = (2 * B * H * chunks * dh * dh + B * H * chunks * dh
               + (key_tiles * B * S * H * dh if key_tiles > 1 else 0))
    return BwdPlan(cols, 2 * B * H * (dh // cols),
                   BWD_STATE_KSPLIT * 32 * (cols // 16),
                   state_smem, key_tiles, B * H * chunks * key_tiles,
                   BWD_THREADS, smem, chunks, scratch)


LAUNCHES: dict[str, int] = {"wkv": 0, "wkv_bwd": 0}
LAUNCH_SHAPES: Counter = Counter()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCH_SHAPES.clear()


def _check(r, k, v, w, u, s0) -> None:
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError(f"r, k, v, w must all be (B, S, H, dh); got "
                         f"{[tuple(x.shape) for x in (r, k, v, w)]}")
    B, S, H, dh = r.shape
    if min(B, S, H) < 1:
        raise ValueError("B, S and H must be at least 1")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head size {dh} not built; the kernel takes "
                         f"{HEAD_DIMS}")
    if plan(B, S, H, dh, r.dtype).blocks > _MAX_INT:
        raise ValueError(f"B·H = {B * H} exceeds the kernel's grid")
    if r.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must all be bfloat16 or all float32; got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, not {w.dtype}: in bfloat16 a "
                        "decay of 0.999 rounds to 0.99609")
    if u.shape != (H, dh) or u.dtype != torch.float32:
        raise ValueError(f"u must be float32 ({H}, {dh}); got "
                         f"{u.dtype} {tuple(u.shape)}")
    if s0 is not None and (s0.shape != (B, H, dh, dh)
                           or s0.dtype != torch.float32):
        raise ValueError(f"s0 must be float32 ({B}, {H}, {dh}, {dh}); got "
                         f"{s0.dtype} {tuple(s0.shape)}")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0)):
        if x is not None and (x.device.type != "cuda" or x.device != r.device
                              or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             "tensor on r's CUDA device")


def wkv_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             s0: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The wkv recurrence on the card. Raises on what the kernel does not
    take and when the launch fails; there is no other path."""
    _check(r, k, v, w, u, s0)
    B, S, H, dh = r.shape
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    s_fin = torch.empty((B, H, dh, dh), dtype=torch.float32,
                        device=r.device)
    with torch.cuda.device(r.device):
        launch(r, k, v, w, u, s0, out, s_fin)
    LAUNCHES["wkv"] += 1
    LAUNCH_SHAPES[(B, S, H, dh, str(r.dtype).removeprefix("torch."),
                   s0 is not None)] += 1
    return out, s_fin


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor | None,
           out: torch.Tensor, s_fin: torch.Tensor) -> None:
    """Bare launch of `plan`'s kernel on the current stream into
    preallocated `out` and `s_fin`. Raises if the launch itself fails."""
    lib = LIBRARY.lib()
    B, S, H, dh = r.shape
    p = plan(B, S, H, dh, r.dtype)
    rc = lib.wkv_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if s0 is None else s0.data_ptr(), out.data_ptr(),
        s_fin.data_ptr(), B, S, H, dh, int(r.dtype == torch.bfloat16),
        p.blocks, p.threads, p.smem_bytes,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"wkv: CUDA kernel launch failed with cudaError "
                           f"{rc}")


def _check_bwd(r, s0, dout, ds_fin) -> None:
    B, S, H, dh = r.shape
    if plan_bwd(B, S, H, dh, r.dtype).blocks > _MAX_INT:
        raise ValueError(f"B·S·H = {B * S * H} exceeds the backward's grid")
    for name, x, shape in (("dout", dout, r.shape),
                           ("ds_fin", ds_fin, (B, H, dh, dh))):
        if x is None:
            continue
        if x.shape != shape or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {tuple(shape)}; got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != r.device or not x.is_contiguous() \
                or x.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             "tensor on r's CUDA device")


def wkv_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor | None,
                 dout: torch.Tensor, ds_fin: torch.Tensor | None = None
                 ) -> tuple:
    """The gradients of `wkv_cuda(r, k, v, w, u, s0)` on the card, as
    `ref.wkv_bwd_ref` gives them. Raises on what the kernel does not take
    and when the launch fails; there is no other path."""
    _check(r, k, v, w, u, s0)
    _check_bwd(r, s0, dout, ds_fin)
    B, S, H, dh = r.shape
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    du = torch.empty((H, dh), dtype=torch.float32, device=r.device)
    ds0 = None if s0 is None else torch.empty_like(s0)
    scratch = torch.empty(plan_bwd(B, S, H, dh, r.dtype).scratch_floats,
                          dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        launch_bwd(r, k, v, w, u, s0, dout, ds_fin, dr, dk, dv, dw, du, ds0,
                   scratch)
    LAUNCHES["wkv_bwd"] += 1
    return dr, dk, dv, dw, du, ds0


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def launch_bwd(r, k, v, w, u, s0, dout, ds_fin, dr, dk, dv, dw, du, ds0,
               scratch) -> None:
    """Bare launch of the backward on the current stream into
    preallocated gradients and `plan_bwd`'s scratch. Raises if the launch
    itself fails."""
    lib = LIBRARY.lib()
    B, S, H, dh = r.shape
    p = plan_bwd(B, S, H, dh, r.dtype)
    rc = lib.wkv_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        _ptr(s0), dout.data_ptr(), _ptr(ds_fin), dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
        _ptr(ds0), scratch.data_ptr(), B, S, H, dh,
        int(r.dtype == torch.bfloat16), p.state_blocks, p.state_threads,
        p.state_smem, p.blocks, p.threads, p.smem_bytes, scratch.numel(),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"wkv_bwd: CUDA kernel launch failed with "
                           f"cudaError {rc}")
