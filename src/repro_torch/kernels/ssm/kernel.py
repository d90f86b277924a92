"""The hand-written CUDA selective-scan kernels (`csrc/selective_scan.cu`):
ctypes binding, argument checks and launch counters.

`selective_scan_cuda` takes float32 CUDA tensors in the model's layout —
a, b (B, S, D, N), c (B, S, N), optional h0 (B, D, N) — and returns (y
(B, S, D) float32, h_fin (B, D, N) float32). N may be 1 to 32 (Mamba's
d_state is 16).

`selective_scan_fused_cuda` takes the Mamba layer's own inputs — dt (B,
S, D) float32, A (D, N) float32, B_ and C_ (B, S, N), x (B, S, D), with
x, B_ and C_ all bfloat16 or all float32, optional D (D,) and h0 (B, D,
N) float32 — builds a = exp(dt·A) and b = dt·B_·x in registers and
returns (y + D·x (B, S, D) float32, h_fin (B, D, N) float32), and with
`states=True` also the state before every `BWD_CHUNK`-th step (B,
ceil(S / BWD_CHUNK), D, N) float32, which the backward recomputes its
chunks from. B_ and C_ may be strided views, such as the model's slices
of its x projection: each is read as rows of N at one row stride.

`selective_scan_fused_bwd_cuda` is the fused scan's backward
(`csrc/selective_scan_bwd.cu`, port only): given the forward's inputs,
y's gradient dy (B, S, D) float32 and optionally the final state's
dh_fin, it returns (d(dt) (B, S, D) float32, dA (D, N) float32, dB_ and
dC_ (B, S, N) and dx (B, S, D) in x's dtype, dD (D,) float32 or None,
dh0 (B, D, N) float32 or None). It recomputes each chunk of `BWD_CHUNK`
steps from the forward's saved state before it, one exponential an
element, from the states a `states=True` forward wrote (`ops._ScanFused`
saves them); dB_, dC_, dA and dD are added across blocks in one order by
a second kernel of the same launch call. `plan_fused_bwd` sizes the
scratch.

`LAUNCHES[name]` counts each kernel's launches and `LAUNCH_SHAPES[name]`
counts them by shape: (B, S, D, N, h0 given) for "selective_scan", (B,
S, D, N, dtype of x, h0 given, D given) for "selective_scan_fused".
`launch`, `launch_fused` and `launch_bwd`
are the bare calls beneath, for timing: they check nothing and count
nothing. The library is built by nvcc on first launch, never at import.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from pathlib import Path

import torch

from .._build import Library

MAX_N = 32                    # a state row is one group of lanes in a warp
_MAX_INT = 2**31 - 1          # the kernel's grid and its int indices
FUSED_DTYPES = (torch.bfloat16, torch.float32)   # of x, B_ and C_


def _declare(handle: ctypes.CDLL) -> None:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    handle.selective_scan_launch.argtypes = [vp] * 6 + [i] * 4 + [vp]
    handle.selective_scan_launch.restype = i
    handle.selective_scan_fused_launch.argtypes = \
        [vp] * 10 + [i] * 4 + [ll, ll, i, vp]
    handle.selective_scan_fused_launch.restype = i
    handle.selective_scan_fused_bwd_launch.argtypes = \
        [vp] * 18 + [i] * 4 + [ll, ll, i, ll, vp]
    handle.selective_scan_fused_bwd_launch.restype = i


LIBRARY = Library("ssm", Path(__file__).resolve().parent / "csrc", _declare)

# The backward's tiling (`csrc/selective_scan_bwd.cu`'s BT and ScanBwdCfg;
# `csrc/scan_states.cuh`'s SCAN_STATE_STEPS).
BWD_THREADS = 256             # threads a block
BWD_CHUNK = 8                 # steps between the states the forward saves
BWD_STATES = 4                # states a thread (all of them when N <= 4)

LAUNCHES: dict[str, int] = {"selective_scan": 0, "selective_scan_fused": 0,
                            "selective_scan_fused_bwd": 0}
LAUNCH_SHAPES: dict[str, Counter] = {name: Counter() for name in LAUNCHES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        LAUNCH_SHAPES[name].clear()


def check_inputs(a, b, c, h0) -> None:
    """Shapes and dtypes, on any device: raise on what the kernel does
    not take (the plain version is held to the same rules)."""
    if a.dim() != 4 or b.shape != a.shape:
        raise ValueError(f"a and b must both be (B, S, D, N); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    B, S, D, N = a.shape
    if min(B, S, D, N) < 1:
        raise ValueError("B, S, D and N must be at least 1")
    if c.shape != (B, S, N):
        raise ValueError(f"c must be ({B}, {S}, {N}); got {tuple(c.shape)}")
    if h0 is not None and h0.shape != (B, D, N):
        raise ValueError(f"h0 must be ({B}, {D}, {N}); got "
                         f"{tuple(h0.shape)}")
    for name, x in (("a", a), ("b", b), ("c", c), ("h0", h0)):
        if x is not None and x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {x.dtype}: the "
                            "scan's inputs and state are float32")


def check_fused_inputs(dt, A, B_, C_, x, D, h0) -> None:
    """The fused scan's shapes and dtypes, on any device: raise on what
    the kernel does not take (the plain version is held to the same
    rules)."""
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"dt and x must both be (B, S, D); got "
                         f"{tuple(dt.shape)}, {tuple(x.shape)}")
    Bsz, S, Di = dt.shape
    if A.dim() != 2 or A.shape[0] != Di:
        raise ValueError(f"A must be ({Di}, N); got {tuple(A.shape)}")
    N = A.shape[1]
    if min(Bsz, S, Di, N) < 1:
        raise ValueError("B, S, D and N must be at least 1")
    for name, t, want in (("B_", B_, (Bsz, S, N)), ("C_", C_, (Bsz, S, N)),
                          ("D", D, (Di,)), ("h0", h0, (Bsz, Di, N))):
        if t is not None and t.shape != want:
            raise ValueError(f"{name} must be {want}; got {tuple(t.shape)}")
    for name, t in (("dt", dt), ("A", A), ("D", D), ("h0", h0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
    if x.dtype not in FUSED_DTYPES or B_.dtype != x.dtype \
            or C_.dtype != x.dtype:
        raise TypeError(f"x, B_ and C_ must be all bfloat16 or all float32; "
                        f"got {x.dtype}, {B_.dtype}, {C_.dtype}")


def row_stride(t: torch.Tensor) -> int | None:
    """The stride between the rows (b, t) of a (B, S, N) tensor read as
    B·S rows of N unit-stride values, or None when it is not one stride."""
    Bsz, S, N = t.shape
    if N > 1 and t.stride(2) != 1:
        return None
    if S == 1:
        return t.stride(0)
    if Bsz == 1 or t.stride(0) == S * t.stride(1):
        return t.stride(1)
    return None


def _check(a, b, c, h0) -> None:
    check_inputs(a, b, c, h0)
    B, S, D, N = a.shape
    if N > MAX_N:
        raise ValueError(f"N = {N} exceeds the kernel's {MAX_N}")
    lanes = D << (N - 1).bit_length()       # D · N rounded up to 2^k
    if lanes > _MAX_INT or B * -(-lanes // 256) > _MAX_INT:
        raise ValueError(f"shape {(B, S, D, N)} exceeds the kernel's grid")
    for name, x in (("a", a), ("b", b), ("c", c), ("h0", h0)):
        if x is not None and (x.device.type != "cuda" or x.device != a.device
                              or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             "tensor on a's CUDA device")


def _check_fused(dt, A, B_, C_, x, D, h0) -> None:
    check_fused_inputs(dt, A, B_, C_, x, D, h0)
    Bsz, S, Di = dt.shape
    N = A.shape[1]
    if N > MAX_N:
        raise ValueError(f"N = {N} exceeds the kernel's {MAX_N}")
    if max(S, Bsz * Di) > _MAX_INT:         # int sizes and grid
        raise ValueError(f"shape {(Bsz, S, Di, N)} exceeds the kernel's grid")
    for name, t in (("dt", dt), ("A", A), ("B_", B_), ("C_", C_), ("x", x),
                    ("D", D), ("h0", h0)):
        if t is not None and (t.device.type != "cuda"
                              or t.device != dt.device):
            raise ValueError(f"{name} must be on dt's CUDA device")
    for name, t in (("dt", dt), ("A", A), ("x", x), ("D", D), ("h0", h0)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("B_", B_), ("C_", C_)):
        if row_stride(t) is None:
            raise ValueError(f"{name} must be rows (b, t) of N unit-stride "
                             "values at one row stride")


def selective_scan_cuda(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                        h0: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan on the card. Raises on what the kernel does not
    take and when the launch fails; there is no other path."""
    _check(a, b, c, h0)
    B, S, D, N = a.shape
    y = torch.empty((B, S, D), dtype=torch.float32, device=a.device)
    h_fin = torch.empty((B, D, N), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        launch(a, b, c, h0, y, h_fin)
    LAUNCHES["selective_scan"] += 1
    LAUNCH_SHAPES["selective_scan"][(B, S, D, N, h0 is not None)] += 1
    return y, h_fin


def states_shape(Bsz: int, S: int, Di: int, N: int) -> tuple:
    """The forward's saved states: the state before every `BWD_CHUNK`-th
    step."""
    return (Bsz, -(-S // BWD_CHUNK), Di, N)


def selective_scan_fused_cuda(dt: torch.Tensor, A: torch.Tensor,
                              B_: torch.Tensor, C_: torch.Tensor,
                              x: torch.Tensor, D: torch.Tensor | None = None,
                              h0: torch.Tensor | None = None, *,
                              states: bool = False) -> tuple:
    """The fused scan on the card: (y, h_fin), and with `states` the
    state before every `BWD_CHUNK`-th step as a third output. Raises on
    what the kernel does not take and when the launch fails; there is no
    other path."""
    _check_fused(dt, A, B_, C_, x, D, h0)
    Bsz, S, Di = dt.shape
    N = A.shape[1]
    y = torch.empty((Bsz, S, Di), dtype=torch.float32, device=dt.device)
    h_fin = torch.empty((Bsz, Di, N), dtype=torch.float32, device=dt.device)
    saved = (torch.empty(states_shape(Bsz, S, Di, N), dtype=torch.float32,
                         device=dt.device) if states else None)
    with torch.cuda.device(dt.device):
        launch_fused(dt, A, B_, C_, x, D, h0, y, h_fin, saved)
    LAUNCHES["selective_scan_fused"] += 1
    LAUNCH_SHAPES["selective_scan_fused"][
        (Bsz, S, Di, N, str(x.dtype).removeprefix("torch."), h0 is not None,
         D is not None)] += 1
    return (y, h_fin, saved) if states else (y, h_fin)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def launch(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
           h0: torch.Tensor | None, y: torch.Tensor,
           h_fin: torch.Tensor) -> None:
    """Bare launch on the current stream into preallocated `y` and
    `h_fin`. Raises if the launch itself fails."""
    lib = LIBRARY.lib()
    B, S, D, N = a.shape
    rc = lib.selective_scan_launch(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), _ptr(h0), y.data_ptr(),
        h_fin.data_ptr(), B, S, D, N,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"selective_scan: CUDA kernel launch failed with "
                           f"cudaError {rc}")


def launch_fused(dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor,
                 C_: torch.Tensor, x: torch.Tensor, D: torch.Tensor | None,
                 h0: torch.Tensor | None, y: torch.Tensor,
                 h_fin: torch.Tensor,
                 states: torch.Tensor | None = None) -> None:
    """Bare launch of the fused scan on the current stream into
    preallocated `y`, `h_fin` and, when given, `states` (`states_shape`).
    Raises if the launch itself fails."""
    lib = LIBRARY.lib()
    Bsz, S, Di = dt.shape
    rc = lib.selective_scan_fused_launch(
        dt.data_ptr(), A.data_ptr(), B_.data_ptr(), C_.data_ptr(),
        x.data_ptr(), _ptr(D), _ptr(h0), y.data_ptr(), h_fin.data_ptr(),
        _ptr(states), Bsz, S, Di, A.shape[1], row_stride(B_),
        row_stride(C_),
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"selective_scan_fused: CUDA kernel launch failed "
                           f"with cudaError {rc}")


def plan_fused_bwd(B: int, S: int, D: int, N: int) -> dict:
    """The backward's blocks a batch row, chunks (saved states a row)
    and scratch floats (the blocks' partial dB_ and dC_, the per-b dA and
    dD); the library refuses another scratch size."""
    npow = 1 << (N - 1).bit_length()
    dpb = BWD_THREADS // (npow // min(npow, BWD_STATES))
    per_b = -(-D // dpb)
    chunks = -(-S // BWD_CHUNK)
    scratch = per_b * B * S * 2 * N + B * D * N + B * D
    return {"columns": dpb, "blocks_per_b": per_b, "blocks": B * per_b,
            "chunks": chunks, "scratch_floats": scratch}


def selective_scan_fused_bwd_cuda(dt, A, B_, C_, x, D, h0, dy, dh_fin,
                                  states) -> tuple:
    """The gradients of `selective_scan_fused_cuda(dt, A, B_, C_, x, D,
    h0)` on the card, as `ref.selective_scan_fused_bwd_ref` gives them,
    from the `states` that forward wrote with `states=True`. Raises on
    what the kernel does not take and when the launch fails; there is no
    other path."""
    _check_fused(dt, A, B_, C_, x, D, h0)
    Bsz, S, Di = dt.shape
    N = A.shape[1]
    if states is None:
        raise ValueError("states must be the forward's (selective_scan_"
                         "fused_cuda(..., states=True))")
    for name, t, want in (("dy", dy, (Bsz, S, Di)),
                          ("dh_fin", dh_fin, (Bsz, Di, N)),
                          ("states", states, states_shape(Bsz, S, Di, N))):
        if t is None:
            continue
        if t.shape != want or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {want}; got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != dt.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on dt's CUDA device")
    plan = plan_fused_bwd(Bsz, S, Di, N)
    if plan["blocks"] > _MAX_INT:
        raise ValueError(f"shape {(Bsz, S, Di, N)} exceeds the backward's "
                         "grid")
    f32 = dict(dtype=torch.float32, device=dt.device)
    ddt = torch.empty((Bsz, S, Di), **f32)
    dA = torch.empty((Di, N), **f32)
    dB, dC = (torch.empty((Bsz, S, N), dtype=x.dtype, device=dt.device)
              for _ in range(2))
    dx = torch.empty_like(x)
    dD = None if D is None else torch.empty((Di,), **f32)
    dh0 = None if h0 is None else torch.empty((Bsz, Di, N), **f32)
    scratch = torch.empty(plan["scratch_floats"], **f32)
    with torch.cuda.device(dt.device):
        launch_bwd(dt, A, B_, C_, x, D, h0, dy, dh_fin, states, ddt, dA, dB,
                   dC, dx, dD, dh0, scratch)
    LAUNCHES["selective_scan_fused_bwd"] += 1
    return ddt, dA, dB, dC, dx, dD, dh0


def launch_bwd(dt, A, B_, C_, x, D, h0, dy, dh_fin, states, ddt, dA, dB, dC,
               dx, dD, dh0, scratch) -> None:
    """Bare launch of the fused scan's backward on the current stream
    from the forward's `states` into preallocated gradients and
    `plan_fused_bwd`'s scratch. Raises if the launch itself fails."""
    lib = LIBRARY.lib()
    Bsz, S, Di = dt.shape
    rc = lib.selective_scan_fused_bwd_launch(
        dt.data_ptr(), A.data_ptr(), B_.data_ptr(), C_.data_ptr(),
        x.data_ptr(), _ptr(D), _ptr(h0), dy.data_ptr(), _ptr(dh_fin),
        states.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
        dC.data_ptr(), dx.data_ptr(), _ptr(dD), _ptr(dh0),
        scratch.data_ptr(), Bsz, S, Di,
        A.shape[1], row_stride(B_), row_stride(C_),
        int(x.dtype == torch.bfloat16), scratch.numel(),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"selective_scan_fused_bwd: CUDA kernel launch "
                           f"failed with cudaError {rc}")
