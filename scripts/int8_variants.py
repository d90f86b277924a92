#!/usr/bin/env python3
"""Time the int8 decode kernel's cluster route under diagnostic edits.

    python3 scripts/int8_variants.py [--variants base no_pv no_stats ...]

Builds `src/repro_torch/kernels/attention/csrc/decode_int8.cu` alone,
once per variant, from a copy under `build/int8_variants/` with the
variant's `EDITS` applied (one nvcc each, all started together). An edit
skips a part of the cluster kernel at run time behind a test the
compiler cannot fold (`a.window == -7`, never true here), so what the
variant saves over `base` is that part's cost (edits joined by `+` are
applied together): `no_k_mma` the scores' products and their epilogue,
`no_stats` the two passes over the kept scores (exp, then p and p8)
between the cluster barriers, `no_pv` the V tile's fragments and products;
`stages10` and `stages18` make the ring 10 or 18 tiles deep (one block
an SM). Each
variant is timed by CUDA events (L2 flushed) at decode_32k's shape (B
128, T 32768, 64/8 heads of 128) on the route and plan
`kernels.attention.plan_int8` gives, and `base` is held to
`attention_int8_ref` there. Prints one JSON line per variant and the
card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

_SKIP = "if (a.window == -7) "
EDITS = {
    "base": [],
    "no_k_mma": [("            const int lkey = warp * 16",
                  "            " + _SKIP + "{\n            const int lkey ="
                  " warp * 16"),
                 ("                        mx[n][j] = fmaxf(mx[n][j], sv);"
                  "\n                    }\n            }\n",
                  "                        mx[n][j] = fmaxf(mx[n][j], sv);"
                  "\n                    }\n            }\n            }\n")],
    "no_stats": [("    // e = exp(s - M) in place; this block's sums",
                  "    " + _SKIP + "{\n    // e = exp(s - M) in place;"),
                 ("            sm.w.part.e[item] = ev;\n        }\n    }\n",
                  "            sm.w.part.e[item] = ev;\n        }\n    }\n"
                  "    }\n"),
                 ("    // p8 in place: p = e / L · v_scale, the word",
                  "    " + _SKIP + "\n    // p8 in place: p = e / L · "
                  "v_scale, the word")],
    # deeper rings, one block an SM (C and keys a block as planned)
    "stages10": [("constexpr int C_STAGES = 5;", "constexpr int C_STAGES = 10;"),
                 ("NT <= 2 ? 2 : 1)", "1)")],
    "stages18": [("constexpr int C_STAGES = 5;", "constexpr int C_STAGES = 18;"),
                 ("NT <= 2 ? 2 : 1)", "1)")],
    "no_pv": [("        for (int ks = slice; ks < C_BN / 32; ks += NSL) {",
               "        " + _SKIP + "\n        for (int ks = slice; "
               "ks < C_BN / 32; ks += NSL) {")],
}


def edited_csrc(src_dir: Path, name: str) -> Path:
    """A copy of decode_int8.cu with the variant's edits, and the headers
    it includes, under build/."""
    text = (src_dir / "decode_int8.cu").read_text()
    for part in name.split("+"):
        for old, new in EDITS[part]:
            if text.count(old) != 1:
                raise SystemExit(f"edit {part}: {old!r} is not in the "
                                 "source once")
            text = text.replace(old, new)
    out = ROOT / "build" / "int8_variants" / name.replace("+", "_")
    out.mkdir(parents=True, exist_ok=True)
    (out / "decode_int8.cu").write_text(text)
    for header in src_dir.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    return out


def declare(handle: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    handle.flash_decode_int8_cluster_launch.argtypes = [vp] * 8 + [i] * 13 \
        + [vp]
    handle.flash_decode_int8_cluster_launch.restype = i


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=list(EDITS),
                    help="names of EDITS, or several joined by '+'")
    ap.add_argument("--T", type=int, default=32768, help="keys")
    ap.add_argument("--cluster", type=int, default=None,
                    help="cluster size in place of the plan's")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.kernels._build import Library
    from repro_torch.kernels import attention as ta
    from repro_torch.kernels.attention import kernel as tk

    if not torch.cuda.is_available():
        raise SystemExit("int8_variants: no CUDA card")
    libs = {name: Library(f"int8_{name.replace('+', '_')}",
                          edited_csrc(tk.LIBRARY.csrc, name), declare)
            for name in args.variants}
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.lib(), libs.values()))
    dev = torch.device("cuda", 0)
    B, T, H, KV, dh = 128, args.T, 64, 8, 128
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k8, v8, ks, vs, kw = cs.int8_inputs_random(B, T, H, KV, dh, gen, dev)
    route, c, keys = tk.plan_int8(B, T, KV, H // KV, dh)
    if args.cluster:
        c, keys = args.cluster, -(-T // args.cluster)
    flush = torch.empty(128 << 20, dtype=torch.int8, device=dev)
    want = None
    for name, lib in libs.items():
        out = torch.empty_like(q)

        def run():
            rc = lib.lib().flash_decode_int8_cluster_launch(
                q.data_ptr(), k8.data_ptr(), v8.data_ptr(), ks.data_ptr(),
                vs.data_ptr(), out.data_ptr(), kw["q_positions"].data_ptr(),
                kw["kv_positions"].data_ptr(), 0, 0, B, 1, T, H, KV, dh, 1,
                0, 1, c, keys, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: cudaError {rc}")
        ms = cs.cuda_ms(run, flush, iters=10, warmup=2)
        line = {"variant": name, "route": route, "cluster": c,
                "keys_per_block": keys, "ms": ms,
                "ptxas": [ln.strip() for ln in
                          lib.build_info["ptxas"].splitlines()
                          if "int8_cluster" in ln or "registers" in ln][:6]}
        if name == "base":
            if want is None:
                want = ta.attention_int8_ref(q, k8, v8, ks, vs, **kw)
            line["max_err_over_scale"] = float(
                (out.float() - want.float()).abs().max()) / float(
                want.float().abs().max())
        print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
