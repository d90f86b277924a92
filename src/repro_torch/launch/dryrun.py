"""Multi-node dry-run: count every (arch × shape × mesh) step
(`repro/launch/dryrun.py`).

The JAX package lowers and compiles each cell's jitted step over 256 or
512 placeholder host devices. The port runs each cell's eager step once
on the `meta` device, as rank 0 of a fake process group of 512 ranks:
its parameters, optimizer state, cache and batch are meta DTensors
placed by the step's `AxisRules` (`StepBundle.abstract_args`), so the
sharding propagates and every collective is issued, but nothing is
allocated and nothing runs. `launch.hlo_cost.analyze_step` counts what
the rank dispatches (FLOPs, bytes, collectives, kernels, memory) and
`launch.roofline` turns the counts into times on an H100 fleet. This
proves that each sharding holds together without hardware: the step
runs to its end on its placements. Records land in
experiments/dryrun_torch/<arch>__<cell>__<mesh>.json, in the JAX
package's schema; `lower_s` is the seconds spent making the meta
arguments and `compile_s` those of the meta run.

The meshes are `launch.mesh.make_production_mesh` with device type
"cuda": the fleet the dry-run models runs NCCL. (Over a "cpu" mesh
DTensor replaces each all-to-all by an all-gather and a chunk, as gloo
has no all-to-all.) The process group is process-global: the CLI makes
it once (`fake_world`), and tests run the dry-run in a subprocess.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, get_config, skipped_cells_for
from ..models import build_model
from ..models.common import tree_leaves
from ..models.losses import set_bf16_grad_barrier
from . import hlo_cost
from . import roofline as rl
from .mesh import make_production_mesh
from .steps import make_step

WORLD = 512                   # ranks of the fake group: both meshes fit


def count_params(cfg) -> tuple[int, int]:
    """(total, active) parameter counts from the descriptor tree: an
    expert's weights count top_k / n_experts of themselves as active."""
    total = active = 0

    def walk(tree, keys):
        nonlocal total, active
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], keys + (k,))
            return
        n = math.prod(tree.shape)
        total += n
        if "moe" in keys and keys[-1] in ("w_in", "w_gate", "w_out"):
            active += n * cfg.moe.top_k // cfg.moe.n_experts
        else:
            active += n
    walk(build_model(cfg).param_desc(), ())
    return total, active


def fake_world() -> None:
    """This process as rank 0 of a fake group of `WORLD` ranks, unless a
    group exists already. `FakeStore` and the "fake" backend come from
    `torch.testing._internal.distributed.fake_pg`, a private module of
    PyTorch's own tests: a backend whose collectives move nothing."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() < WORLD:
            raise RuntimeError(f"the dry-run needs a group of {WORLD} ranks,"
                               f" not {dist.get_world_size()}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)


@functools.lru_cache(maxsize=None)
def production_mesh(multi_pod: bool):
    """The (16, 16) or (2, 16, 16) mesh over the fake group (made once a
    process, as the group is)."""
    fake_world()
    return make_production_mesh(multi_pod=multi_pod, device_type="cuda")


def _nbytes(tree) -> int:
    """Global bytes of a tree's tensors."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def run_cell(arch: str, cell_name: str, multi_pod: bool, outdir: str,
             variant: str = "baseline") -> dict:
    mesh_name = "multi" if multi_pod else "single"
    record = {"arch": arch, "cell": cell_name, "mesh": mesh_name,
              "variant": variant, "status": "pending",
              "variant_toggles": {
                  "set_bf16_grad_barrier": variant == "opt",
                  "set_attn_triangular": "none in the port"}}
    cfg = get_config(arch)
    if cell_name in skipped_cells_for(arch):
        record.update(status="skipped",
                      reason="unbounded decode state at 500k context "
                             "(pure full-attention arch; see DESIGN.md)")
        _write(record, outdir)
        return record
    try:
        set_bf16_grad_barrier(variant == "opt")
        mesh = production_mesh(multi_pod)
        n_dev = mesh.size()
        bundle = make_step(cfg, cell_name, variant=variant, mesh=mesh)
        cell = SHAPES[cell_name]
        t0 = time.time()
        args = bundle.abstract_args
        t1 = time.time()
        with torch.set_grad_enabled(cell.step == "train"):
            summary = hlo_cost.analyze_step(bundle.fn, *args)
        t2 = time.time()
        total_p, active_p = count_params(cfg)
        mflops = rl.model_flops(cfg, cell, total_p, active_p)
        mbytes = 0.0
        if cell.step == "decode":
            # minimal decode traffic: active params + cache, read once
            mbytes = rl.model_bytes(cfg, cell, active_p, _nbytes(args[1]))
        roof = rl.analyze(summary, n_dev, mflops, mbytes, cell.step)
        record.update(
            status="ok", n_devices=n_dev,
            lower_s=round(t1 - t0, 2), compile_s=round(t2 - t1, 2),
            memory={
                "argument_bytes": summary.argument_bytes,
                "output_bytes": summary.output_bytes,
                "temp_bytes": summary.temp_bytes,
                "alias_bytes": summary.alias_bytes,
                "peak_est_bytes": (summary.argument_bytes
                                   + summary.output_bytes
                                   + summary.temp_bytes
                                   - summary.alias_bytes),
            },
            params_total=total_p, params_active=active_p,
            roofline=roof.to_dict(),
            kernels={name: {"launches": n, "flops": f, "bytes": b}
                     for name, (n, f, b) in sorted(summary.kernels.items())},
        )
    except Exception as exc:  # noqa: BLE001 — record and keep sweeping
        record.update(status="error", error=f"{type(exc).__name__}: {exc}",
                      traceback=traceback.format_exc()[-2000:])
    finally:
        set_bf16_grad_barrier(False)
    _write(record, outdir)
    return record


def _write(record: dict, outdir: str) -> None:
    os.makedirs(outdir, exist_ok=True)
    suffix = "" if record.get("variant", "baseline") == "baseline" else \
        f"__{record['variant']}"
    name = (f"{record['arch']}__{record['cell']}__{record['mesh']}"
            f"{suffix}.json")
    with open(os.path.join(outdir, name), "w") as f:
        json.dump(record, f, indent=1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape cell or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--outdir", default="experiments/dryrun_torch")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "opt"],
                    help="opt = launch.steps.apply_variant's configuration")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose record already says ok/skipped")
    args = ap.parse_args()

    archs = ARCHS if args.arch == "all" or args.all else [args.arch]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    n_ok = n_skip = n_err = 0
    t_start = time.time()
    for arch in archs:
        shapes = list(SHAPES) if args.shape == "all" or args.all \
            else [args.shape]
        for cell in shapes:
            for mp in meshes:
                mesh_name = "multi" if mp else "single"
                suffix = "" if args.variant == "baseline" else \
                    f"__{args.variant}"
                path = os.path.join(
                    args.outdir,
                    f"{arch}__{cell}__{mesh_name}{suffix}.json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[cached ] {arch} × {cell} × {mesh_name}")
                        continue
                t0 = time.time()
                rec = run_cell(arch, cell, mp, args.outdir,
                               variant=args.variant)
                dt = time.time() - t0
                status = rec["status"]
                n_ok += status == "ok"
                n_skip += status == "skipped"
                n_err += status == "error"
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f"bottleneck={r['bottleneck']} "
                             f"t_bound={r['t_bound_s']:.4f}s "
                             f"roofline={r['roofline_fraction']:.2%}")
                elif status == "error":
                    extra = rec["error"][:120]
                print(f"[{status:7s}] {arch} × {cell} × {mesh_name} "
                      f"({dt:.0f}s) {extra}", flush=True)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"in {time.time() - t_start:.0f}s")
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
