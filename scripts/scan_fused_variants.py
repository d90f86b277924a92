#!/usr/bin/env python3
"""Time the fused selective-scan kernel under other tuning constants.

    python3 scripts/scan_fused_variants.py [--variants 16:16:128 16:16:256
                                            16:16:128+fast_exp ...]
                                           [--no-edge]

Builds `src/repro_torch/kernels/ssm/csrc/selective_scan.cu` once per
variant NPT:STEPS:THREADS (`-DSCAN_FUSED_NPT=NPT -DSCAN_FUSED_STEPS=STEPS
-DSCAN_FUSED_THREADS=THREADS`: the states a thread holds, the steps of a
shared-memory chunk and the threads of a block), one nvcc each, all
started together. A variant may add `+EDIT`s from `EDITS`, diagnostic
changes of the source made in a copy under `build/scan_variants/`:
`fast_exp` (__expf, which the port must not use: it shows what the
accurate expf costs), `y_fma` (y's sum as FMAs), `unroll1` and `unroll2`
(the step loop unrolled 1 or 2 times, not 4). For each build it runs
`chip_smoke.py`'s `scan_edge` grid (unless `--no-edge`; a variant with
`fast_exp` is not held to it), holds the fused kernel against its plain
version at the Jamba path's shapes, and times it there by CUDA events
and by the profiler's device time: prefill (4, 2000, 8192, 16) bf16
without h0 and decode (4, 1, 8192, 16) bf16 from h0, both with the D
skip, inputs as the model draws them; and reads the card's SM clock and
power draw from nvidia-smi while the prefill launches run back to back.
Prints one JSON line per variant and the card's name and power limit.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

SHAPES = {"prefill": (4, 2000, 8192, 16, False),
          "decode": (4, 1, 8192, 16, True)}
_LOOP = "#pragma unroll 4\n        for (int u = 0; u < steps"
EDITS = {
    "fast_exp": [("const float a = expf(", "const float a = __expf(")],
    "y_fma": [("q[j] = __fmul_rn(h[k], cv[k]);", "q[j] = h[k] * cv[k];"),
              ("float ys = tree_sum<NPT>(q);",
               "float ys = 0.f;\n#pragma unroll\n"
               "for (int k = 0; k < NPT; ++k) ys = fmaf(h[k], cv[k], ys);")],
    "unroll1": [(_LOOP, _LOOP.replace("unroll 4", "unroll 1"))],
    "unroll2": [(_LOOP, _LOOP.replace("unroll 4", "unroll 2"))],
}


def edited_csrc(src_dir: Path, name: str, edits: list[str]) -> Path:
    """A copy of the kernel's source with `edits` applied, under build/."""
    text = (src_dir / "selective_scan.cu").read_text()
    for edit in edits:
        for old, new in EDITS[edit]:
            if text.count(old) != 1:
                raise SystemExit(f"edit {edit}: {old!r} is not in the source "
                                 "exactly once")
            text = text.replace(old, new)
    out = ROOT / "build" / "scan_variants" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "selective_scan.cu").write_text(text)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+",
                    default=["16:16:128", "16:16:256", "16:32:256",
                             "8:16:128"])
    ap.add_argument("--no-edge", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("scan_fused_variants: no CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels import ssm as ts
    from repro_torch.kernels._build import Library

    device = torch.device("cuda", 0)
    libs = {}
    for v in args.variants:
        consts, *edits = v.split("+")
        npt, steps, threads = (int(p) for p in consts.split(":"))
        name = f"ssm_v{npt}_{steps}_{threads}" + "".join(f"_{e}" for e in edits)
        csrc = edited_csrc(ts.LIBRARY.csrc, name, edits) if edits \
            else ts.LIBRARY.csrc
        libs[v] = Library(name, csrc, ts.kernel._declare,
                          (f"-DSCAN_FUSED_NPT={npt}",
                           f"-DSCAN_FUSED_STEPS={steps}",
                           f"-DSCAN_FUSED_THREADS={threads}"))
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.lib(), libs.values()))

    flush = torch.empty(128 << 20, dtype=torch.int8, device=device)
    for v, lib in libs.items():
        ts.kernel.LIBRARY = lib
        out = {"variant": v, "ptxas": [
            ln.strip() for ln in lib.build_info["ptxas"].splitlines()
            if ("registers" in ln or "spill" in ln) and ln.strip()][:80]}
        exact = "fast_exp" not in v
        if exact and not args.no_edge:
            out["edge"] = cs.scan_edge_phase(ts, device, 0)
        gen = torch.Generator(device=device).manual_seed(5)
        for kind, (B, S, D, N, with_h0) in SHAPES.items():
            dt, A, B_, C_, x, Dv, h0 = cs.scan_fused_inputs(
                gen, B, S, D, N, torch.bfloat16, device)
            h0 = h0 if with_h0 else None
            try:
                err, rel, same, y_same = cs.scan_fused_compare(
                    ts, f"variant {v} {kind}", dt, A, B_, C_, x, Dv, h0)
            except AssertionError:
                if exact:
                    raise
                rel, same, y_same = None, False, False
            y = torch.empty((B, S, D), dtype=torch.float32, device=device)
            h_fin = torch.empty((B, D, N), dtype=torch.float32, device=device)

            def fused():
                ts.launch_fused(dt, A, B_, C_, x, Dv, h0, y, h_fin)
            bound = cs.scan_fused_bound(B, S, D, N, 2, with_h0, True)
            ms = cs.cuda_ms(fused, flush)
            if kind == "prefill":
                for _ in range(400):                 # about 0.35 s of work
                    fused()
                out["clock_under_load"] = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                     "power.draw", "--format=csv,noheader"],
                    capture_output=True, text=True, timeout=60).stdout.strip()
                torch.cuda.synchronize()
            out[kind] = {"ms": ms,
                         "device_ms": cs.device_ms(fused, flush,
                                                   "scan_fused"),
                         "bound_ms": bound["bound_ms"],
                         "share_of_bound": bound["bound_ms"] / ms,
                         "max_scaled_err": rel, "h_fin_bit_exact": same,
                         "y_bit_exact": y_same}
            del dt, A, B_, C_, x, Dv, h0, y, h_fin
        print(json.dumps(out), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
