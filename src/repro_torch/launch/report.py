"""The dry-run and roofline tables from the port's dry-run records
(`repro/launch/report.py`), with "GPUs" for the JAX package's "chips".

    PYTHONPATH=src python -m repro_torch.launch.report \
        [--outdir experiments/dryrun_torch]
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load(outdir: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(outdir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}PB"


def dryrun_table(recs: list[dict], variant: str = "baseline") -> str:
    lines = [
        "| arch | cell | mesh | status | compile_s | params | mem/dev "
        "(args+temp) | dominant collective |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("variant", "baseline") != variant:
            continue
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['cell']} | {r['mesh']} | SKIP "
                f"(unbounded 500k state) | — | — | — | — |")
            continue
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['cell']} | {r['mesh']} | ERROR "
                f"{r.get('error', '')[:60]} | — | — | — | — |")
            continue
        mem = r["memory"]
        coll = r["roofline"]["collectives"]
        dom = max(coll, key=lambda k: coll[k]["wire_bytes"]) if coll else "—"
        lines.append(
            f"| {r['arch']} | {r['cell']} | {r['mesh']} | ok "
            f"| {r['compile_s']} | {r['params_total'] / 1e9:.1f}B "
            f"| {fmt_bytes(mem['argument_bytes'])}+"
            f"{fmt_bytes(mem['temp_bytes'])} | {dom} |")
    return "\n".join(lines)


def roofline_table(recs: list[dict], variant: str = "baseline",
                   mesh: str = "single") -> str:
    lines = [
        "| arch | cell | t_compute | t_memory | t_collective | bottleneck "
        "| t_ideal | roofline frac | useful flops |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("variant", "baseline") != variant or r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['cell']} | — | — | — | "
                         f"skip | — | — | — |")
            continue
        if r["status"] != "ok":
            continue
        rl = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['cell']} | {rl['t_compute_s']:.3f}s "
            f"| {rl['t_memory_s']:.3f}s | {rl['t_collective_s']:.3f}s "
            f"| {rl['bottleneck']} | {rl['t_ideal_s']:.3f}s "
            f"| {rl['roofline_fraction']:.1%} "
            f"| {rl['useful_flops_fraction']:.2f} |")
    return "\n".join(lines)


def compare_table(recs: list[dict], cells: list[tuple[str, str]]) -> str:
    by_key = {}
    for r in recs:
        if r["status"] != "ok" or r["mesh"] != "single":
            continue
        by_key[(r["arch"], r["cell"], r.get("variant", "baseline"))] = r
    lines = [
        "| arch × cell | baseline t_bound | opt t_bound | speedup "
        "| baseline frac | opt frac |",
        "|---|---|---|---|---|---|",
    ]
    for arch, cell in cells:
        b = by_key.get((arch, cell, "baseline"))
        o = by_key.get((arch, cell, "opt"))
        if not b or not o:
            continue
        rb, ro = b["roofline"], o["roofline"]
        lines.append(
            f"| {arch} × {cell} | {rb['t_bound_s']:.3f}s "
            f"| {ro['t_bound_s']:.3f}s "
            f"| **{rb['t_bound_s'] / ro['t_bound_s']:.1f}x** "
            f"| {rb['roofline_fraction']:.1%} "
            f"| {ro['roofline_fraction']:.1%} |")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="experiments/dryrun_torch")
    ap.add_argument("--section", default="all",
                    choices=["all", "dryrun", "roofline", "compare"])
    args = ap.parse_args()
    recs = load(args.outdir)
    if args.section in ("all", "dryrun"):
        print("## Dry-run (single-pod 16x16 = 256 GPUs)\n")
        print(dryrun_table([r for r in recs if r["mesh"] == "single"]))
        print("\n## Dry-run (multi-pod 2x16x16 = 512 GPUs)\n")
        print(dryrun_table([r for r in recs if r["mesh"] == "multi"]))
    if args.section in ("all", "roofline"):
        print("\n## Roofline (single-pod, baseline)\n")
        print(roofline_table(recs, "baseline"))
        print("\n## Roofline (single-pod, optimized)\n")
        print(roofline_table(recs, "opt"))
    if args.section in ("all", "compare"):
        print("\n## Baseline vs optimized\n")
        from ..configs import ARCHS, cells_for
        cells = [(a, c) for a in ARCHS for c in cells_for(a)]
        print(compare_table(recs, cells))


if __name__ == "__main__":
    main()
