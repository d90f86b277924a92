#!/usr/bin/env python3
"""Time diagnostic variants of the wkv backward kernel.

    python3 scripts/wkv_bwd_variants.py [--variants base no_products
                                         no_keys+no_A ...]

Builds `src/repro_torch/kernels/rwkv/csrc/` once per variant, one nvcc
each, all started together. A variant other than `base` is `+`-joined
EDITS, diagnostic changes of the chunk pass made in a copy under
`build/wkv_bwd_variants/` (wrong results; they show what a stage costs):
`no_products` (the mma products X, Y, B and Z skipped), `no_keys` (the
per-key sums skipped), `no_A` (the sum over the keys for dv skipped),
`no_dv` (dv's sum skipped). It holds `base`
against `wkv_bwd_ref` on the `heads40` edge case and times each at the
RWKV train path's shape (2, 4096, 40, 64) bf16 from the model's decays:
median of 10 CUDA-event timings, L2 flushed, and the profiler's device
ms of each of its three kernels (`chip_smoke.py`'s helpers). Prints one
JSON line per variant and the card's name and power limit. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

EDITS = {
    "no_products": [
        ("for (int task = warp; task < KT / 4 + 2; task += NW) {",
         "for (int task = warp; task < 0; task += NW) {"),
        ("for (int n0 = 8 * warp; n0 < DH; n0 += 8 * NW) {",
         "for (int n0 = 8 * warp; n0 < 0; n0 += 8 * NW) {")],
    "no_keys": [("    switch (part) {", "    switch (part + 16) {")],
    "no_A": [("        if (e < CWS - 1)\n", "        if (false)\n")],
    "no_dv": [("            for (int s2 = t; s2 < BC; ++s2)\n"
               "                acc = fmaf(sA[s2 * TS + t], sd[s2 * RS + j], "
               "acc);\n", "")],
}


def edited_csrc(src_dir: Path, name: str, edits: list[str]) -> Path:
    """A copy of the kernels' sources with `edits` applied, under build/."""
    out = ROOT / "build" / "wkv_bwd_variants" / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(src_dir, out)
    path = out / "wkv_bwd.cu"
    text = path.read_text()
    for edit in edits:
        for old, new in EDITS[edit]:
            if old not in text:
                raise SystemExit(f"edit {edit}: {old!r} is not in the source")
            text = text.replace(old, new)
    path.write_text(text)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+",
                    default=["base", "no_products", "no_keys", "base"])
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("wkv_bwd_variants: no CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv import cases
    from repro_torch.kernels.rwkv import kernel as rk
    from repro_torch.kernels.rwkv.ref import wkv_bwd_ref

    libs = {}
    for name in dict.fromkeys(args.variants):
        csrc = (rk.LIBRARY.csrc if name == "base" else
                edited_csrc(rk.LIBRARY.csrc, name, name.split("+")))
        libs[name] = _build.Library("rwkv", csrc, rk._declare)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))

    flush = torch.empty(128 << 20, dtype=torch.int8, device="cuda")
    edge = [c for c in cases.bwd_cases() if c[0] == "heads40"][0]
    B, S, H, dh = 2, 4096, 40, 64
    train = ("train", (B, S, H, dh), "bfloat16", False, "model")
    for name in args.variants:
        rk.LIBRARY = libs[name]
        small = cases.bwd_inputs(edge, 3, "cuda")
        errs = None if name != "base" else cs.bwd_kernel_check(
            f"wkv_bwd {name}", rk.wkv_bwd_cuda(*small), wkv_bwd_ref(*small),
            cases.GRADS, cases.BWD_TOL)
        r, k, v, w, u, _, dout, _ = cases.bwd_inputs(train, 11, "cuda")
        f32 = dict(dtype=torch.float32, device="cuda")
        grads = [torch.empty_like(r) for _ in range(3)] + [
            torch.empty(r.shape, **f32), torch.empty((H, dh), **f32)]
        plan = rk.plan_bwd(B, S, H, dh)
        scratch = torch.empty(plan.scratch_floats, **f32)

        def launch():
            rk.launch_bwd(r, k, v, w, u, None, dout, None, *grads, None,
                          scratch)
        ms = cs.cuda_ms(launch, flush, iters=10, warmup=2)
        parts = cs.device_ms_parts(launch, flush, (
            "wkv_bwd_states", "wkv_bwd_chunk", "wkv_bwd_finish"))
        print(json.dumps({"variant": name, "ms": ms,
                          "device_ms_by_kernel": parts,
                          "edge_errs": errs, "plan": plan._asdict(),
                          "shape": [B, S, H, dh]}), flush=True)
        del r, k, v, w, u, dout, grads, scratch
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
