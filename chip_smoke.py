#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's query path on one NVIDIA card.

    python3 chip_smoke.py [--docs 1000000] [--B 200000] [--seed 0]
                          [--profile]

Builds the CUDA kernels from `src/repro_torch/kernels/intersect/csrc`,
holds each against its plain PyTorch version on the card, then runs the
port's main path at a real size: an HDFS-shaped log corpus (`--docs`
lines) → `Builder` → `Searcher` on the card → `query_batch` of 256
queries, top 10 (half multi-term ANDs, half planner trees with
NOT/phrases) under `impl="bitmap"`, checked against `impl="sorted"`;
`IoUSketch.query(impl="bitmap")` on sampled words; and
`combine_cluster_planned` over 16 groups. The kernels' launch counts are
zeroed just before that run and read just after it. Last, each kernel
is timed at the shape the main path gave it (median of CUDA-event
timings, L2 flushed before each) beside the plain version, the host↔
device copies, and the least time the card needs for the same work.

Every phase prints one JSON line; any failure raises and the script
exits nonzero. The last lines are the kernels line, the card's name and
power limit from nvidia-smi, and `{"ok": true, "device": {...}}`.
Without a CUDA card, or without the repo's `src/` beside it, it exits
nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, 700 W). The 67 TFLOP/s
# float32 rate counts an FMA as two operations on 128 FP32 lanes per SM;
# an SM has 64 INT32 lanes, so 32-bit integer instructions (AND/OR/
# ANDNOT, one LOP3 each, and popc) issue at most a quarter of that.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

# The main path's traffic: QUERIES queries with top TOP_K, half of them
# planner trees, of which GROUPS groups of PER go to combine_cluster.
QUERIES, TOP_K = 256, 10
GROUPS, PER = 16, 8
assert QUERIES // 2 == GROUPS * PER

REPLACES = {
    "intersect": "src/repro/kernels/intersect/kernel.py:65",
    "intersect_batch": "src/repro/kernels/intersect/kernel.py:220",
    "combine_batch": "src/repro/kernels/intersect/kernel.py:127",
    "combine_cluster": "src/repro/kernels/intersect/kernel.py:184",
}
SOURCE = "src/repro_torch/kernels/intersect/csrc/intersect.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    """`name, power.limit` of card 0, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


# ------------------------------------------------------------ inputs
def random_bitmaps(rng, shape) -> "np.ndarray":
    import numpy as np
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


def random_programs(rng, rows: int, L: int, S: int,
                    n_real: int | None = None) -> list[list[tuple]]:
    """Well-formed programs of up to S steps (ANDNOT-rich); `n_real`
    caps the real steps so `pack_programs` pads the rest with the
    chained identity."""
    progs = []
    for _ in range(rows):
        n = S if n_real is None else min(S, int(rng.integers(0, n_real + 1)))
        steps = []
        for s in range(n):
            op = int(rng.integers(0, 3))
            a = L + s - 1 if s else int(rng.integers(0, L))
            steps.append((op, a, int(rng.integers(0, L + s))))
        progs.append(steps)
    return progs


# --------------------------------------------------------- comparisons
def compare(name: str, got, want) -> int:
    """Kernel vs plain (bitmaps, counts) on the card: bit-exact or raise.
    Returns the largest absolute difference (0)."""
    import torch
    (out_k, cnt_k), (out_p, cnt_p) = got, want
    torch.cuda.synchronize()
    if out_k.shape != out_p.shape or cnt_k.shape != cnt_p.shape:
        raise AssertionError(f"{name}: shapes {tuple(out_k.shape)}/"
                             f"{tuple(cnt_k.shape)} vs {tuple(out_p.shape)}/"
                             f"{tuple(cnt_p.shape)}")
    words = (out_k.to(torch.int64) & 0xFFFFFFFF) \
        - (out_p.to(torch.int64) & 0xFFFFFFFF)
    err = max(int(words.abs().max()) if words.numel() else 0,
              int((cnt_k - cnt_p).abs().max()) if cnt_k.numel() else 0)
    if err:
        raise AssertionError(f"{name}: kernel disagrees with the plain "
                             f"version (max abs err {err})")
    return err


def call_pair(tx, name: str, inputs: tuple, device):
    fn = getattr(tx, name)
    return fn(*inputs, device=device), fn(*inputs, impl="ref", device=device)


def edge_phase(tx, device, rng) -> dict[str, int]:
    """Small ragged shapes: W=1, W not a multiple of 32 or of the block,
    one layer, ANDNOT programs and chained-identity padding."""
    errs = dict.fromkeys(REPLACES, 0)
    cases = 0
    for L, W in ((1, 1), (2, 1), (3, 7), (1, 33), (4, 255), (2, 257),
                 (5, 1000)):
        bm = random_bitmaps(rng, (4, 3, L, W))
        bm[0, 0, -1] = 0xFFFFFFFF              # an all-ones padding layer
        prog = tx.pack_cluster_programs(
            [random_programs(rng, 3, L, 4, n_real=3) for _ in range(4)], L)
        for name, inputs in (("intersect", (bm[0, 0],)),
                             ("intersect_batch", (bm[0],)),
                             ("combine_batch", (bm[0], prog[0])),
                             ("combine_cluster", (bm, prog))):
            got, want = call_pair(tx, name, inputs, device)
            errs[name] = max(errs[name], compare(name, got, want))
            cases += 1
    # a one-step ANDNOT program and the empty program (identity padding)
    bm = random_bitmaps(rng, (2, 2, 40))
    prog = tx.pack_programs([[(tx.OP_ANDNOT, 0, 1)], []], 2)
    got, want = call_pair(tx, "combine_batch", (bm, prog), device)
    errs["combine_batch"] = max(errs["combine_batch"],
                                compare("combine_batch", got, want))
    expect = (bm[0, 0] & ~bm[0, 1], bm[1, 0])
    for q in range(2):
        if not (tx.to_numpy(got[0][q]) == expect[q]).all():
            raise AssertionError("combine_batch: ANDNOT/identity program "
                                 "differs from NumPy")
    emit({"phase": "edge", "cases": cases + 1, "bit_exact": True})
    return errs


# ----------------------------------------------------------- main path
def make_queries(docs: list[str], n: int, seed: int, parse_words):
    """n/2 multi-term ANDs (→ intersect_batch) and n/2 planner trees
    with NOT / phrases (→ combine_batch), words drawn from the corpus."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ands: list[str] = []
    planned: list[str] = []
    while len(ands) < n // 2 or len(planned) < n - n // 2:
        toks = parse_words(docs[int(rng.integers(len(docs)))])
        words = list(dict.fromkeys(toks))
        other = parse_words(docs[int(rng.integers(len(docs)))])
        if len(words) < 4:
            continue
        a, b, c = (words[int(i)] for i in
                   rng.choice(len(words), 3, replace=False))
        x = other[int(rng.integers(len(other)))]
        i = int(rng.integers(len(toks) - 1))
        if toks[i] == toks[i + 1]:
            continue
        if len(ands) < n // 2:
            ands.append(f"{a} AND {b}" if len(ands) % 2 else
                        f"{a} AND {b} AND {c}")
        if len(planned) < n - n // 2 and x not in (a, b, c):
            shape = len(planned) % 4
            planned.append([
                f'"{toks[i]} {toks[i + 1]}"',
                f"{a} AND {b} AND NOT {x}",
                f"({a} OR {x}) AND NOT {c}",
                f'"{toks[i]} {toks[i + 1]}" OR ({a} AND {x})',
            ][shape])
    return ands, planned


def main_phase(args, device) -> dict:
    import numpy as np
    import torch
    from collections import Counter

    from repro_torch.core.optimizer import InfeasibleSketchError
    from repro_torch.core.sketch import IoUSketch, SketchSpec
    from repro_torch.core.hashing import word_fingerprint
    from repro_torch.data import make_logs_like, parse_words, write_corpus
    from repro_torch.index import Builder, BuilderConfig, Searcher, parse
    from repro_torch.index import planner as tp
    from repro_torch.index.searcher import lookup_units
    from repro_torch.kernels import intersect as tx
    from repro_torch.storage import (InMemoryBlobStore, SimCloudStore,
                                     SimCloudTransport)

    t0 = time.perf_counter()
    docs = make_logs_like(args.docs, seed=args.seed)
    store = InMemoryBlobStore()
    corpus = write_corpus(store, "corpus/hdfs", docs, n_blobs=16)
    gen_s = time.perf_counter() - t0

    B = args.B
    t0 = time.perf_counter()
    while True:
        try:
            report = Builder(BuilderConfig(B=B, F0=1.0)).build(
                corpus, store, "index/hdfs")
            break
        except InfeasibleSketchError:
            B *= 2
    build_s = time.perf_counter() - t0
    emit({"phase": "build_index", "docs": args.docs, "B": B,
          "B_raised": B != args.B, "L": report.L,
          "index_bytes": report.index_bytes, "generate_s": gen_s,
          "build_s": build_s})

    # in-memory sketch of the same corpus for IoUSketch.query
    t0 = time.perf_counter()
    _profile, postings = Builder().profile(corpus)
    n_common = int(0.01 * B)
    common = [w for w, _ in Counter(
        {w: len(d) for w, d in postings.items()}).most_common(n_common)]
    sketch = IoUSketch.build(postings, SketchSpec(
        B=B, L=report.L, n_common=len(common), seed=args.seed),
        common_words=common)
    rng = np.random.default_rng(args.seed)
    hashed = [w for w in postings if not sketch.is_common(w)]
    sample = [hashed[int(i)] for i in rng.choice(len(hashed), 32,
                                                 replace=False)]
    sketch_s = time.perf_counter() - t0
    del postings

    ands, planned = make_queries(docs, QUERIES, args.seed, parse_words)
    queries = [parse(t) for t in ands + planned]

    def searcher():
        return Searcher(SimCloudTransport(SimCloudStore(store,
                                                        seed=args.seed)),
                        "index/hdfs", device=device)

    s_bitmap, s_sorted, s_plan = searcher(), searcher(), searcher()
    jobs = [j for j in tp.plan_batch([parse(t) for t in planned],
                                     units=(s_plan,)) if j.plan is not None]
    G, per = GROUPS, PER
    if len(jobs) < G * per:
        raise AssertionError(f"only {len(jobs)} planner jobs")
    jobs = jobs[:G * per]
    outs, _ = lookup_units([s_plan], [j.lookup_q for j in jobs],
                           s_plan._fetcher)
    plans = [[j.plan for j in jobs[g * per:(g + 1) * per]]
             for g in range(G)]
    words = [outs[0][g * per:(g + 1) * per] for g in range(G)]

    def is_common(w):
        return word_fingerprint(w) in s_plan.common

    # ---- the main path: counts zeroed before, read after -------------
    tx.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res_bitmap = s_bitmap.query_batch(queries, top_k=TOP_K)
    torch.cuda.synchronize()
    bitmap_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sketch_bitmap = [sketch.query(w, impl="bitmap", n_docs=args.docs,
                                  device=device) for w in sample]
    torch.cuda.synchronize()
    sketch_bitmap_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cluster, counts = tp.combine_cluster_planned(
        plans, words, [is_common] * G, device=device)
    torch.cuda.synchronize()
    cluster_s = time.perf_counter() - t0
    launches = dict(tx.LAUNCHES)
    shapes = dict(tx.LAST_SHAPE)
    peak_bytes = torch.cuda.max_memory_allocated()
    # -------------------------------------------------------------------

    idle = [k for k, v in launches.items() if not v]
    if idle:
        raise AssertionError(f"main path never launched {idle}")

    t0 = time.perf_counter()
    res_sorted = s_sorted.query_batch(queries, top_k=TOP_K, impl="sorted")
    sorted_s = time.perf_counter() - t0
    for q, (a, b) in enumerate(zip(res_bitmap, res_sorted)):
        if a.refs != b.refs or a.texts != b.texts or a.stats != b.stats:
            raise AssertionError(f"query {q} ({(ands + planned)[q]!r}): "
                                 "bitmap on the card != sorted")
    if sum(bool(r.refs) for r in res_bitmap) < len(queries) // 2:
        raise AssertionError("fewer than half the queries found documents")

    for w, got in zip(sample, sketch_bitmap):
        if not np.array_equal(got, sketch.query(w, impl="sorted")):
            raise AssertionError(f"IoUSketch.query({w!r}) bitmap != sorted")

    cpu, cpu_counts = tp.combine_cluster_planned(
        plans, words, [is_common] * G, device="cpu")
    if not np.array_equal(counts, cpu_counts):
        raise AssertionError("combine_cluster_planned counts: card != cpu")
    for g in range(G):
        plain = tp.combine_planned(plans[g], words[g], is_common,
                                   impl="sorted")
        for q in range(per):
            for got, c, p in zip(cluster[g][q], cpu[g][q], plain[q]):
                if not (np.array_equal(got, c) and np.array_equal(got, p)):
                    raise AssertionError(f"combine_cluster_planned group "
                                         f"{g} query {q} differs")

    if args.profile:
        for impl in ("bitmap", "sorted"):
            host_profile(searcher(), queries, TOP_K, impl)

    emit({"phase": "main", "queries": len(queries), "ands": len(ands),
          "planned": len(planned), "top_k": TOP_K,
          "with_results": sum(bool(r.refs) for r in res_bitmap),
          "identical_to_sorted": True,
          "batch_wall_s": {"bitmap_cuda": bitmap_s, "sorted": sorted_s},
          "sketch_words": len(sample), "sketch_build_s": sketch_s,
          "sketch_bitmap_s": sketch_bitmap_s,
          "cluster": {"G": G, "Q": per, "wall_s": cluster_s,
                      "candidates": int(counts.sum())},
          "launches": launches, "shapes": shapes,
          "peak_device_bytes": peak_bytes})
    return {"launches": launches, "shapes": shapes}


def host_profile(searcher, queries, top_k: int, impl: str,
                 n: int = 15) -> None:
    """cProfile one `query_batch`: the functions with the most own time
    (host clock; profiling adds its own overhead)."""
    import cProfile
    import pstats
    import torch
    prof = cProfile.Profile()
    prof.enable()
    searcher.query_batch(queries, top_k=top_k, impl=impl)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:n]
    emit({"phase": "host_profile", "impl": impl,
          "total_s": sum(v[2] for v in stats.values()),
          "top_own_s": [[f"{Path(f).name}:{line}({fn})", own, cum]
                        for (f, line, fn), (_cc, _nc, own, cum, _) in rows]})


# --------------------------------------------------------------- timing
def cuda_ms(fn, flush, iters: int = 30, warmup: int = 5) -> float:
    """Median CUDA-event time of `fn`, L2 flushed before each run."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(host, prog=None) -> tuple[float, str]:
    """Least card time (ms) for the work on these inputs: each input read
    once and each output written once over HBM bandwidth, against the
    32-bit integer ops over the INT32 rate; the larger, and which it is.

    `host` is the (…, L, W) bitmaps. An L-way AND reads every layer. A
    combine program reads only the layers its steps name (the planner
    pads ragged L with layers no step names), so its rows are counted
    one by one; `prog` is the (…, S, 3) programs."""
    import numpy as np
    L, W = host.shape[-2:]
    rows = host.size // (L * W)
    if prog is None:
        layers_read = rows * L
        ops = rows * W * L                      # L-1 ANDs + popc per word
        prog_bytes = 0
    else:
        prog = prog.reshape(rows, -1, 3)
        S = prog.shape[1]
        named = np.zeros((rows, L), dtype=bool)
        for col in (1, 2):
            slots = prog[:, :, col]
            r, s = np.nonzero(slots < L)
            named[r, slots[r, s]] = True
        layers_read = int(named.sum())
        ops = rows * W * (S + 1)                # one LOP3 per step + popc
        prog_bytes = prog.nbytes
    nbytes = 4 * W * (layers_read + rows) + prog_bytes + 8 * rows
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                      else "operations")


def timing_phase(tx, device, rng, shapes: dict, errs: dict) -> list[dict]:
    import numpy as np
    import torch

    flush = torch.empty(128 << 20, dtype=torch.int8, device=device)
    rows_of = {"intersect": lambda s: (1,) + s,
               "intersect_batch": lambda s: s,
               "combine_batch": lambda s: s,
               "combine_cluster": lambda s: (s[0] * s[1],) + s[2:]}
    plain_of = {"intersect": tx.intersect_ref,
                "intersect_batch": tx.intersect_batch_ref,
                "combine_batch": tx.combine_batch_ref,
                "combine_cluster": tx.combine_cluster_ref}
    kernels = []
    for name, shape in shapes.items():
        bm_shape = tuple(shape[0])
        host = random_bitmaps(rng, bm_shape)
        rows, L, W = rows_of[name](bm_shape)
        host_prog = None
        if len(shape) == 2:
            S = shape[1][-2]
            progs = tx.pack_programs(random_programs(rng, rows, L, S), L)
            host_prog = progs.reshape(*bm_shape[:-2], S, 3)
        inputs = (host,) if host_prog is None else (host, host_prog)
        got, want = call_pair(tx, name, inputs, device)
        errs[name] = max(errs[name], compare(name, got, want))

        bm = torch.from_numpy(host.view(np.int32)).to(device)
        prog = None if host_prog is None else \
            torch.from_numpy(np.ascontiguousarray(host_prog)).to(device)
        out = torch.empty((rows, W), dtype=torch.int32, device=device)
        cnt = torch.zeros(rows, dtype=torch.int64, device=device)
        bm3 = bm.view(rows, L, W)
        prog3 = None if prog is None else prog.view(rows, -1, 3)

        def kernel():
            tx.launch(name, bm3, prog3, out, cnt)

        def plain():
            return plain_of[name](*((bm,) if prog is None else (bm, prog)))
        kernel_ms = cuda_ms(kernel, flush)
        plain_ms = cuda_ms(plain, flush)
        h2d_ms = cuda_ms(lambda: torch.from_numpy(host.view(np.int32))
                         .to(device), flush)
        d2h_ms = cuda_ms(lambda: out.cpu(), flush)
        bound_ms, bound_by = bound(host, host_prog)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "shape": [list(s) for s in shape],
            "max_abs_err": errs[name], "bit_exact": errs[name] == 0,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "kernel_us": 1e3 * kernel_ms, "plain_us": 1e3 * plain_ms,
            "bound_us": 1e3 * bound_ms, "h2d_ms": h2d_ms, "d2h_ms": d2h_ms})
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--B", type=int, default=200_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also cProfile one bitmap and one sorted batch")
    args = ap.parse_args()

    if not (SRC / "repro_torch" / "kernels").is_dir():
        raise SystemExit(f"chip_smoke: the port's sources are not at {SRC}")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available()"
                         " is false)")
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch.kernels import intersect as tx
    from repro_torch.kernels.intersect import _build

    device = torch.device("cuda", 0)
    card = card_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "numpy": np.__version__})

    t0 = time.perf_counter()
    _build.lib()
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "nvcc_s": _build.build_info["seconds"],
          "library": _build.build_info["path"],
          "ptxas": [ln for ln in _build.build_info["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln]})

    rng = np.random.default_rng(args.seed)
    errs = edge_phase(tx, device, rng)
    main = main_phase(args, device)
    kernels = timing_phase(tx, device, rng, main["shapes"], errs)
    for k in kernels:
        k["launches"] = main["launches"][k["name"]]
    emit({"kernels": kernels})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
