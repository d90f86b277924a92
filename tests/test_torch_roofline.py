"""The port's roofline model, step counter and kernel cost hook
(`repro_torch.launch.roofline`, `launch.hlo_cost`, `launch.report`,
`kernels/_cost.py`) against the JAX package's and against analytic
counts, on the CPU.

- `Roofline.to_dict()`, `model_flops` and `model_bytes` equal JAX's
  exactly once the port's peaks are set to the reference's (TPU v5e:
  197e12 FLOP/s, 819e9 B/s, 50e9 B/s on every link), and the report's
  tables equal JAX's on the same records but for "GPUs" in place of
  "chips".
- The counter mirrors `tests/test_hlo_cost.py`: an L-layer loop of
  tanh(c @ w) counts 2·L·B·D² FLOPs within 2% and JAX `analyze_hlo`'s
  count of the same function within 2% (JAX in a subprocess with
  `JAX_PLATFORMS=cpu`); the gradient of nested loops is 2.8–3.2× the
  forward; over a fake 8-rank (4, 2) mesh (a subprocess, as the process
  group is process-global) the per-device FLOPs are the global count / 8
  within 5% (the DTensor op itself is not counted, only the rank's local
  one), an all-gather is counted at least once a layer, and each
  collective's wire bytes are the ring formula's exactly; a write into a
  slice counts the slice.
- Each model kernel under the counter on meta tensors records one launch
  whose flops and bytes are its `roofline.*_cost` exactly, and the plain
  version adds no op.
- `chip_smoke.py`'s bounds, computed with the moved formulas, give the
  kernel table's numbers to 3 digits.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import report as jax_report
from repro.launch import roofline as jax_rl
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.kernels import _cost
from repro_torch.kernels.attention import attention, attention_int8
from repro_torch.kernels.rwkv.ops import wkv
from repro_torch.kernels.ssm.ops import selective_scan, selective_scan_fused
from repro_torch.launch import report, roofline
from repro_torch.launch.hlo_cost import analyze_step

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")
SRC = os.path.join(ROOT, "src")


def _run(code: str, **env) -> dict:
    """Run `code` in a fresh interpreter on the CPU; its last stdout line
    is JSON."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC, **env)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture
def reference_peaks(monkeypatch):
    """The port's peaks set to the JAX package's (one link class)."""
    monkeypatch.setattr(roofline, "PEAK_FLOPS", jax_rl.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", jax_rl.HBM_BW)
    monkeypatch.setattr(roofline, "NVLINK_BW", jax_rl.ICI_BW)
    monkeypatch.setattr(roofline, "NETWORK_BW", jax_rl.ICI_BW)


ROOF_CASES = [
    dict(flops_per_device=3.1e15, bytes_per_device=2.2e13,
         wire_bytes_per_device=7.0e11, n_devices=256,
         collectives={"all-gather": (12, 3.0e11, 2.9e11),
                      "reduce-scatter": (3, 1.0e9, 1.5e10)},
         model_flops_global=2.0e17, step_kind="train"),
    dict(flops_per_device=4.0e14, bytes_per_device=5.0e12,
         wire_bytes_per_device=0.0, n_devices=512, collectives={},
         model_flops_global=6.8e16, step_kind="prefill"),
    dict(flops_per_device=6.6e10, bytes_per_device=6.2e12,
         wire_bytes_per_device=1.1e12, n_devices=256,
         collectives={"all-reduce": (129, 1.0e7, 1.9e7)},
         model_flops_global=8.4e12, model_bytes_global=4.4e12,
         step_kind="decode"),
    dict(flops_per_device=0.0, bytes_per_device=0.0,
         wire_bytes_per_device=0.0, n_devices=1, collectives={}),
]


@pytest.mark.parametrize("case", range(len(ROOF_CASES)))
def test_roofline_to_dict_equals_the_reference(reference_peaks, case):
    kw = ROOF_CASES[case]
    port = roofline.Roofline(**kw).to_dict()
    ref = jax_rl.Roofline(**kw).to_dict()
    assert port.pop("wire_bytes_by_link") == {}
    assert port == ref                      # exact: the same arithmetic


def test_collective_time_takes_each_link_class(reference_peaks,
                                               monkeypatch):
    """With link classes, each link's wire bytes go at its own rate; the
    total wire bytes are the reference's field."""
    monkeypatch.setattr(roofline, "NVLINK_BW", 450e9)
    r = roofline.Roofline(1.0, 1.0, 3.0e11, 256, {},
                          wire_bytes_by_link={"nvlink": 1.0e11,
                                              "network": 2.0e11})
    assert r.t_collective == pytest.approx(1.0e11 / 450e9
                                           + 2.0e11 / jax_rl.ICI_BW,
                                           rel=1e-12)
    assert r.bottleneck == "collective"


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_bytes_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in SHAPES:
        total, active = 10_000_000_007, 3_000_000_001
        assert roofline.model_flops(cfg, SHAPES[name], total, active) == \
            jax_rl.model_flops(jcfg, JAX_SHAPES[name], total, active)
        assert roofline.model_bytes(cfg, SHAPES[name], active, 12345.0) == \
            jax_rl.model_bytes(jcfg, JAX_SHAPES[name], active, 12345.0)


def test_wire_bytes_ring_formulas():
    assert roofline.wire_bytes("all-gather", 1600, 16) == 1500
    assert roofline.wire_bytes("reduce-scatter", 100, 16) == 1500
    assert roofline.wire_bytes("all-reduce", 1600, 16) == 3000
    assert roofline.wire_bytes("all-to-all", 1600, 16) == 1500
    assert roofline.wire_bytes("collective-permute", 1600, 16) == 1600
    assert roofline.link_of(range(8)) == "nvlink"
    assert roofline.link_of(range(16)) == "network"   # two nodes of 8
    assert roofline.link_of(range(0, 256, 16)) == "network"


def _records() -> list[dict]:
    recs = []
    for i, (arch, cell, mesh, variant, status) in enumerate([
            ("qwen3-32b", "train_4k", "single", "baseline", "ok"),
            ("qwen3-32b", "train_4k", "single", "opt", "ok"),
            ("qwen3-32b", "prefill_32k", "multi", "baseline", "ok"),
            ("qwen3-32b", "long_500k", "single", "baseline", "skipped"),
            ("rwkv6-3b", "decode_32k", "single", "baseline", "error"),
            ("jamba-v0.1-52b", "decode_32k", "multi", "baseline", "ok")]):
        rec = {"arch": arch, "cell": cell, "mesh": mesh, "variant": variant,
               "status": status}
        if status == "error":
            rec["error"] = "RuntimeError: a sharding that does not hold"
        if status == "ok":
            kw = dict(ROOF_CASES[i % 3])
            kw["flops_per_device"] *= 1 + 0.5 * (variant == "opt")
            rec.update(n_devices=kw["n_devices"], lower_s=1.5 + i,
                       compile_s=2.25 * i, params_total=32.8e9 + i,
                       params_active=32.8e9,
                       memory={"argument_bytes": 2**30 * (i + 1),
                               "output_bytes": 2**20, "alias_bytes": 0,
                               "temp_bytes": 3 * 2**30,
                               "peak_est_bytes": 2**32},
                       roofline=jax_rl.Roofline(**kw).to_dict())
        recs.append(rec)
    return recs


def test_report_tables_equal_the_reference(tmp_path, capsys):
    recs = _records()
    for rec in recs:
        name = f"{rec['arch']}__{rec['cell']}__{rec['mesh']}__" \
               f"{rec['variant']}.json"
        (tmp_path / name).write_text(json.dumps(rec))
    assert report.load(str(tmp_path)) == jax_report.load(str(tmp_path))
    for variant in ("baseline", "opt"):
        assert report.dryrun_table(recs, variant) == \
            jax_report.dryrun_table(recs, variant)
        for mesh in ("single", "multi"):
            assert report.roofline_table(recs, variant, mesh) == \
                jax_report.roofline_table(recs, variant, mesh)
    cells = [("qwen3-32b", "train_4k"), ("qwen3-32b", "prefill_32k")]
    assert report.compare_table(recs, cells) == \
        jax_report.compare_table(recs, cells)
    argv = sys.argv
    try:
        sys.argv = ["report", "--outdir", str(tmp_path)]
        jax_report.main()
        want = capsys.readouterr().out
        report.main()
        got = capsys.readouterr().out
    finally:
        sys.argv = argv
    assert "chips" in want and "chips" not in got
    assert got == want.replace("chips", "GPUs")


# --------------------------------------------------------------- counter
def _loop(L):
    def f(c, w):
        for layer in range(L):
            c = torch.tanh(c @ w[layer])
        return c.sum()
    return f


@pytest.fixture(scope="module")
def jax_loop_flops():
    """JAX `analyze_hlo` of the L-layer scan of tanh(c @ w), L = 2 and 8."""
    return _run("""
        import json, jax, jax.numpy as jnp
        from repro.launch.hlo_cost import analyze_hlo
        D, B = 128, 64
        out = {}
        for L in (2, 8):
            def f(w, x):
                def body(c, wl): return jnp.tanh(c @ wl), None
                y, _ = jax.lax.scan(body, x, w)
                return y.sum()
            c = jax.jit(f).lower(
                jax.ShapeDtypeStruct((L, D, D), jnp.float32),
                jax.ShapeDtypeStruct((B, D), jnp.float32)).compile()
            out[str(L)] = analyze_hlo(c.as_text()).flops
        print(json.dumps(out))
    """)


@pytest.mark.parametrize("L", [2, 8])
def test_loop_flops_analytic_and_equal_to_jax(L, jax_loop_flops):
    D, B = 128, 64
    w = torch.empty(L, D, D, device="meta")
    c = torch.empty(B, D, device="meta")
    s = analyze_step(_loop(L), c, w)
    analytic = 2.0 * L * B * D * D
    assert abs(s.flops / analytic - 1) < 0.02            # 2%, as JAX's test
    assert abs(s.flops / jax_loop_flops[str(L)] - 1) < 0.02


def test_loop_counts_the_same_on_the_cpu_and_on_meta():
    """Meta counts what a real run counts: FLOPs, bytes and memory."""
    L, D, B = 3, 32, 8
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(L, D, D, generator=gen)
    c = torch.randn(B, D, generator=gen)
    cpu = analyze_step(_loop(L), c, w)
    meta = analyze_step(_loop(L), c.to("meta"), w.to("meta"))
    assert (cpu.flops, cpu.bytes_accessed, cpu.temp_bytes,
            cpu.argument_bytes, cpu.output_bytes) == \
        (meta.flops, meta.bytes_accessed, meta.temp_bytes,
         meta.argument_bytes, meta.output_bytes)


def test_grad_of_nested_loops_is_about_three_forwards():
    D, B, L, M = 64, 32, 4, 3

    def f(w, x):
        w = w.requires_grad_(True)
        c = x
        for layer in range(L):
            for _ in range(M):
                c = torch.tanh(c @ w[layer])
        return torch.autograd.grad(c.sum(), w)[0]
    s = analyze_step(f, torch.empty(L, D, D, device="meta"),
                     torch.empty(B, D, device="meta"))
    ratio = s.flops / (2.0 * L * M * B * D * D)
    assert 2.8 < ratio < 3.2, ratio          # fwd + bwd ≈ 3x fwd


def test_slice_writes_count_the_slice():
    """A loop writing one slice a step counts the slices, not L whole
    buffers (the reference's dynamic-update-slice rule)."""
    L, N = 16, 4096

    def f(x, buf):
        for i in range(L):
            buf[i] = torch.tanh(x)
        return buf
    s = analyze_step(f, torch.empty(N, device="meta"),
                     torch.empty(L, N, device="meta"))
    # per step: tanh reads and writes N floats, the copy reads them and
    # writes one row
    assert s.bytes_accessed == L * 4 * N * 4
    assert s.bytes_accessed < 0.5 * L * N * 4 * L
    assert s.alias_bytes == L * N * 4            # the buffer, in place


def test_sharded_counts_on_a_fake_8_rank_mesh():
    """(4, 2) ("data", "model") over a fake group of 8: per-device FLOPs
    of an L-layer loop are the global count / 8 within 5%, an all-gather
    at least once a layer; each redistribution's wire bytes are its ring
    formula's exactly, on NVLink (8 ranks, one node); over a "cpu" mesh
    DTensor would count an all-to-all as an all-gather."""
    res = _run("""
        import json, torch
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (Partial, Replicate, Shard,
                                              distribute_tensor)
        from repro_torch.launch.hlo_cost import analyze_step
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=8)
        mesh = init_device_mesh("cuda", (4, 2),
                                mesh_dim_names=("data", "model"))
        D, B, L = 128, 64, 4
        def dt(shape, pl):
            return distribute_tensor(torch.empty(shape, device="meta"),
                                     mesh, pl, src_data_rank=None)
        w = dt((L, D, D), [Shard(1), Shard(2)])
        x = dt((B, D), [Shard(0), Replicate()])
        def f(w, x):
            c = x
            for layer in range(L):
                c = torch.tanh(c @ w[layer])
            return c.sum()
        s = analyze_step(f, w, x)
        out = {"flops": s.flops, "per_dev": 2.0 * L * B * D * D / 8,
               "colls": {k: v[0] for k, v in s.collectives.items()}}
        cases = {
            "all-gather": (dt((64, 32), [Shard(0), Replicate()]),
                           [Replicate(), Replicate()]),
            "reduce-scatter": (dt((64, 32), [Partial(), Replicate()]),
                               [Shard(0), Replicate()]),
            "all-reduce": (dt((64, 32), [Replicate(), Partial()]),
                           [Replicate(), Replicate()]),
            "all-to-all": (dt((64, 32), [Shard(0), Replicate()]),
                           [Shard(1), Replicate()]),
        }
        for kind, (t, pl) in cases.items():
            s = analyze_step(lambda t: t.redistribute(mesh, pl), t)
            out[kind] = {k: list(v) for k, v in s.collectives.items()}
            out[kind + "_links"] = s.wire_bytes_by_link
        print(json.dumps(out))
    """)
    assert abs(res["flops"] / res["per_dev"] - 1) < 0.05
    assert res["colls"].get("all-gather", 0) >= 4
    full = 64 * 32 * 4
    want = {"all-gather": (full, roofline.wire_bytes("all-gather", full, 4)),
            "reduce-scatter": (full // 4, roofline.wire_bytes(
                "reduce-scatter", full // 4, 4)),
            "all-reduce": (full, roofline.wire_bytes("all-reduce", full, 2)),
            "all-to-all": (full // 4, roofline.wire_bytes(
                "all-to-all", full // 4, 4))}
    for kind, (nbytes, wire) in want.items():
        assert res[kind] == {kind: [1, nbytes, wire]}, (kind, res[kind])
        assert res[kind + "_links"] == {"nvlink": wire}


# --------------------------------------------------- the kernels' hook
B, S, T, H, KV, DH = 2, 64, 80, 4, 2, 32


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _kernel_cases():
    bf = torch.bfloat16
    q, k = _meta(B, S, H, DH, dtype=bf), _meta(B, T, KV, DH, dtype=bf)
    pos_q = torch.arange(T - S, T, dtype=torch.int32).to("meta")
    pos_k = torch.arange(T, dtype=torch.int32).to("meta")
    k8 = _meta(B, T, KV, DH, dtype=torch.int8)
    sc = _meta(B, T, KV, dtype=bf)
    q1 = _meta(B, 1, H, DH, dtype=bf)
    r, w, u = _meta(B, S, 3, DH, dtype=bf), _meta(B, S, 3, DH), _meta(3, DH)
    s0 = _meta(B, 3, DH, DH)
    D_, N = 16, 8
    dt, A, x = _meta(B, S, D_), _meta(D_, N), _meta(B, S, D_, dtype=bf)
    Bm, Dv, h0 = _meta(B, S, N, dtype=bf), _meta(D_), _meta(B, D_, N)
    a, c = _meta(B, S, D_, N), _meta(B, S, N)

    def grad(fn, *leaves):
        def run(*args):
            args = [t.requires_grad_(True) if i in leaves else t
                    for i, t in enumerate(args)]
            out = fn(*args)
            out = out[0] if isinstance(out, tuple) else out
            return torch.autograd.grad(out.sum(), [args[i] for i in leaves])
        return run
    return {
        "flash_attention": (
            lambda q, k, pq, pk: attention(q, k, k, window=48, q_positions=pq,
                                           kv_positions=pk, device="meta"),
            (q, k, pos_q, pos_k),
            {"flash_attention": roofline.attn_cost(
                B, S, T, H, KV, DH, 2, True, 48, pos_elems=S + T)}),
        "flash_bwd": (
            grad(lambda q, k: attention(q, k, k, device="meta"), 0, 1),
            (q, k),
            {"flash_attention": roofline.attn_cost(B, S, T, H, KV, DH, 2),
             "flash_bwd": roofline.bwd_cost(B, S, T, H, KV, DH, 2)}),
        "flash_decode_int8": (
            lambda q, k, s: attention_int8(q, k, k, s, s, device="meta"),
            (q1, k8, sc),
            {"flash_decode_int8": roofline.int8_cost(B, 1, T, H, KV, DH,
                                                     2)}),
        "wkv": (lambda r, w, u, s0: wkv(r, r, r, w, u, s0, device="meta"),
                (r, w, u, s0),
                {"wkv": roofline.wkv_cost(B, S, 3, DH, 2, True)}),
        "wkv_bwd": (grad(lambda r, w, u: wkv(r, r, r, w, u, device="meta"),
                         0, 1),
                    (r, w, u),
                    {"wkv": roofline.wkv_cost(B, S, 3, DH, 2, False),
                     "wkv_bwd": roofline.wkv_bwd_cost(B, S, 3, DH, 2)}),
        "selective_scan": (
            lambda a, c, h0: selective_scan(a, a, c, h0, device="meta"),
            (a, c, h0),
            {"selective_scan": roofline.scan_cost(B, S, D_, N, True)}),
        "selective_scan_fused": (
            lambda dt, A, Bm, x, Dv: selective_scan_fused(
                dt, A, Bm, Bm, x, Dv, device="meta"),
            (dt, A, Bm, x, Dv),
            {"selective_scan_fused": roofline.scan_fused_cost(
                B, S, D_, N, 2, False, True)}),
        "selective_scan_fused_bwd": (
            grad(lambda dt, A, Bm, x, Dv: selective_scan_fused(
                dt, A, Bm, Bm, x, Dv, device="meta"), 0, 3),
            (dt, A, Bm, x, Dv),
            {"selective_scan_fused": roofline.scan_fused_cost(
                B, S, D_, N, 2, False, True),
             "selective_scan_fused_bwd": roofline.scan_bwd_cost(
                 B, S, D_, N, 2)}),
    }


@pytest.mark.parametrize("name", list(_kernel_cases()))
def test_each_kernel_records_its_formula_on_meta(name):
    fn, args, want = _kernel_cases()[name]
    s = analyze_step(fn, *args)
    assert s.kernels == {k: (1, *cost) for k, cost in want.items()}
    # no plain version ran: every flop is a kernel's, and a forward
    # alone moves no byte but its kernel's
    assert s.flops == sum(f for f, _ in want.values())
    if len(want) == 1:
        assert s.bytes_accessed == sum(b for _, b in want.values())
    assert not _cost.ACTIVE


def test_without_a_counter_meta_and_cpu_take_the_plain_versions():
    """No counter: meta tensors run the plain version as before; under a
    counter a CPU tensor still takes the plain version (no kernel)."""
    q = torch.randn(1, 8, 2, 32)
    out = attention(q.to("meta"), q.to("meta"), q.to("meta"), device="meta")
    assert out.shape == q.shape and out.is_meta
    s = analyze_step(lambda q: attention(q, q, q, device="cpu"), q)
    assert s.kernels == {} and s.flops > 0


def test_attn_pairs_shape_only_count():
    assert roofline.attn_pairs(3, 5, 5) == 3 * 15
    assert roofline.attn_pairs(1, 1, 100) == 100            # decode
    assert roofline.attn_pairs(1, 4, 4, causal=False) == 16
    assert roofline.attn_pairs(1, 6, 6, window=2) == 1 + 2 * 5
    assert roofline.attn_pairs(2, 3, 10, window=4) == 2 * 12


def test_chip_smoke_bounds_from_the_moved_formulas():
    """The kernel table's bounds (`PERF.md` §6), recomputed by
    `chip_smoke.py`'s wrappers over `launch.roofline`, to 3 digits."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    assert round(cs.bwd_bound(2, 4096, 64, 8, 128, 2)[0], 3) == 1.390
    assert round(cs.wkv_bwd_bound(2, 4096, 40, 64, 2)["bound_ms"], 3) == \
        0.280
    assert round(cs.scan_bwd_bound(2, 4096, 8192, 16, 2)["bound_ms"],
                 3) == 0.321
    assert round(cs.int8_bound(128, 1, 32768, 64, 8, 128, 2)[0], 3) == 2.605
    assert round(cs.wkv_bound(4, 2000, 40, 64, 2, False)[0], 4) == 0.0864
