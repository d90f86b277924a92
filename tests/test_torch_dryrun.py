"""The port's dry-run (`repro_torch.launch.dryrun`), its inputs
(`models.input_specs`, `StepBundle.abstract_args`) and its counts
against the JAX package, on the CPU.

- `input_specs` gives meta tensors of JAX's `input_specs` shapes and
  dtypes for every arch × cell; with rules over the (16, 16), (2, 16, 16)
  and (4, 2) meshes (a fake process group of 512 ranks, in a subprocess),
  every leaf's DTensor placements are those of JAX's `AxisRules.physical`
  spec for it, as JAX's `input_specs` resolves them (the stand-in meshes
  of `tests/test_torch_sharding.py`), under each profile.
- `count_params` equals JAX's (total, active) for all 10 archs exactly:
  the JAX half is `repro/launch/dryrun.py`'s walk over
  `build_model(cfg).param_desc()`, reproduced here, since importing that
  module sets `XLA_FLAGS` for the whole process.
- The reduced `qwen3-32b` (remat "full" on both sides, B 2, S 128): the
  prefill, decode and train steps' FLOPs are within 10% of JAX
  `analyze_hlo` of the same config and batch (JAX in a subprocess) once
  each side's attention is taken out. JAX's blockwise attention computes
  all S·T pairs, 4·dh·H flops a pair and head forward and 16 with the
  full remat's recompute and the backward's four products; the port's
  kernels count the causal pairs only (`roofline.attn_pairs`), and their
  FLOPs are the kernels' records, held to `roofline.attn_cost` and
  `bwd_cost` here.
- `run_cell` over the fake production meshes (a subprocess) for a
  reduced arch of each kind and each step kind writes records that pass
  `test_integration_extras.py::test_dryrun_artifact_schema`'s checks, and
  a pure-attention arch's long_500k cell is `skipped`.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs.seamless_m4t_medium import ENC_FRAMES as JAX_ENC_FRAMES
from repro.models import Desc as JaxDesc
from repro.models import batch_desc as jax_batch_desc
from repro.models import build_model as jax_build_model
from repro.models import input_specs as jax_input_specs
from repro.models import rules_for as jax_rules_for
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import count_params
from repro_torch.launch.hlo_cost import analyze_step
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_step, make_train_step)
from repro_torch.models import input_specs
from repro_torch.models.common import abstract_params, placements_of

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

PROFILES = ["baseline", "fsdp_only", "decode_tp"]
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "4x2": (("data", "model"), (4, 2))}


def _run(code: str) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _flat(tree[k], path + (k,))]
    return [("/".join(path), tree)]


class StandInMesh:
    """Axis names and sizes only, in both packages' spellings."""

    def __init__(self, names, shape):
        self.axis_names = self.mesh_dim_names = names
        self.devices = np.empty(shape)
        self.shape = shape


# ------------------------------------------------------------ input_specs
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_shapes_and_dtypes_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for cell in SHAPES:
        got = _flat(input_specs(cfg, cell))
        want = _flat(jax_input_specs(jcfg, cell))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, t), (_, s) in zip(got, want):
            assert t.is_meta, path
            assert tuple(t.shape) == tuple(s.shape), (cell, path)
            assert str(t.dtype).removeprefix("torch.") == str(s.dtype), \
                (cell, path)


@pytest.fixture(scope="module")
def placed_specs():
    """{mesh: {profile: {arch: {cell: {path: placements}}}}} of the port's
    `input_specs` with rules over real meshes of a fake 512-rank group."""
    return _run(f"""
        import json
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import ARCHS, SHAPES, get_config
        from repro_torch.launch.dryrun import fake_world
        from repro_torch.models import input_specs
        from repro_torch.models.common import rules_for
        fake_world()
        out = {{}}
        for name, (axes, shape) in {MESHES!r}.items():
            mesh = init_device_mesh("cuda", shape, mesh_dim_names=axes)
            for profile in {PROFILES!r}:
                rules = rules_for(mesh, profile)
                for arch in ARCHS:
                    for cell in SHAPES:
                        specs = input_specs(get_config(arch), cell, rules)
                        def walk(tree, path=()):
                            if isinstance(tree, dict):
                                for k in sorted(tree):
                                    walk(tree[k], path + (k,))
                                return
                            leaves = out.setdefault(name, {{}}).setdefault(
                                profile, {{}}).setdefault(arch, {{}})
                            leaves.setdefault(cell, {{}})["/".join(path)] = [
                                str(p) for p in tree.placements]
                        walk(specs)
        print(json.dumps(out))
    """)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_placements_equal_jax(placed_specs, mesh_name, arch):
    axes, shape = MESHES[mesh_name]
    mesh = StandInMesh(axes, shape)
    jcfg = jax_get_config(arch)
    model = jax_build_model(jcfg)
    for profile in PROFILES:
        rules = jax_rules_for(mesh, profile)
        for cell in SHAPES:
            c = JAX_SHAPES[cell]
            descs = {"batch": jax_batch_desc(jcfg, c)}
            if c.step == "decode":
                extra = {"enc_len": JAX_ENC_FRAMES} \
                    if jcfg.kind == "encdec" else {}
                descs["cache"] = model.cache_desc(c.global_batch, c.seq_len,
                                                  **extra)
            want = {path: [str(p) for p in placements_of(
                        rules.physical(d.axes, d.shape), mesh)]
                    for path, d in _flat(descs)
                    if isinstance(d, JaxDesc)}
            assert placed_specs[mesh_name][profile][arch][cell] == want, \
                (profile, cell)


def test_abstract_args_in_the_steps_order():
    """Train: ({"params", "opt"}, batch), float32 moments and a CPU step;
    prefill: (params, batch); decode: (params, cache, batch) with the
    cache's position a CPU scalar."""
    cfg = get_config("qwen3-32b", reduced=True)
    state, batch = make_train_step(cfg).abstract_args
    assert set(state) == {"params", "opt"} and set(batch) == \
        {"tokens", "labels"}
    assert state["opt"]["m"]["embed"].dtype == torch.float32
    assert state["opt"]["m"]["embed"].is_meta
    assert state["opt"]["step"].device.type == "cpu"
    assert tuple(batch["tokens"].shape) == (256, 4096)
    params, batch = make_prefill_step(cfg).abstract_args
    assert tuple(batch["tokens"].shape) == (32, 32768)
    params, cache, batch = make_decode_step(cfg).abstract_args
    assert cache["pos"].device.type == "cpu" and cache["k"].is_meta
    assert tuple(cache["k"].shape)[1:3] == (128, 32768)
    assert make_step(cfg, "long_500k").cell == "long_500k"


# ------------------------------------------------------------ count_params
def _jax_count_params(cfg) -> tuple[int, int]:
    """`repro/launch/dryrun.py`'s `count_params`, reproduced."""
    tree = jax_build_model(cfg).param_desc()
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JaxDesc))
    total = active = 0
    for path, leaf in flat:
        keys = [str(getattr(k, "key", "")) for k in path]
        n = 1
        for d in leaf.shape:
            n *= d
        total += n
        if "moe" in keys and keys[-1] in ("w_in", "w_gate", "w_out"):
            active += n * cfg.moe.top_k // cfg.moe.n_experts
        else:
            active += n
    return total, active


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_equals_jax(arch):
    assert count_params(get_config(arch)) == \
        _jax_count_params(jax_get_config(arch))


# ------------------------------------------ reduced qwen3: FLOPs vs JAX
B, S = 2, 128


@pytest.fixture(scope="module")
def jax_step_flops():
    return _run(f"""
        import json, jax, jax.numpy as jnp
        from repro.configs import get_config
        from repro.launch.hlo_cost import analyze_hlo
        from repro.models import build_model, NULL_RULES
        from repro.models.common import abstract_params
        from repro.training.optimizer import (OptimizerConfig, adamw_update,
                                              init_opt_state)
        B, S = {B}, {S}
        cfg = get_config("qwen3-32b", reduced=True).with_(remat="full")
        model = build_model(cfg)
        p = abstract_params(model.param_desc())
        def i32(*s):
            return jax.ShapeDtypeStruct(s, jnp.int32)
        def flops(fn, *args):
            text = jax.jit(fn).lower(*args).compile().as_text()
            return analyze_hlo(text).flops
        out = {{}}
        out["prefill"] = flops(lambda p, b: model.prefill(p, b, NULL_RULES),
                               p, {{"tokens": i32(B, S)}})
        cache = abstract_params(model.cache_desc(B, S))
        out["decode"] = flops(
            lambda p, c, b: model.decode_step(p, c, b, NULL_RULES), p,
            cache, {{"tokens": i32(B, 1)}})
        def train(state, batch):
            loss, grads = jax.value_and_grad(
                lambda q: model.loss_fn(q, batch, NULL_RULES))(
                    state["params"])
            params, opt, _ = adamw_update(state["params"], grads,
                                          state["opt"], OptimizerConfig())
            return loss, params, opt
        opt = jax.eval_shape(init_opt_state, p)
        out["train"] = flops(train, {{"params": p, "opt": opt}},
                             {{"tokens": i32(B, S), "labels": i32(B, S)}})
        print(json.dumps(out))
    """)


def _port_step(step: str):
    cfg = get_config("qwen3-32b", reduced=True).with_(remat="full")

    def ids(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")
    if step == "prefill":
        bundle = make_prefill_step(cfg)
        args = (abstract_params(bundle.model.param_desc()),
                {"tokens": ids(B, S)})
    elif step == "decode":
        bundle = make_decode_step(cfg)
        cache = dict(abstract_params(bundle.model.cache_desc(B, S)),
                     pos=torch.zeros((), dtype=torch.int32))
        args = (abstract_params(bundle.model.param_desc()), cache,
                {"tokens": ids(B, 1)})
    else:
        bundle = make_train_step(cfg)
        state, _ = bundle.abstract_args
        args = (state, {"tokens": ids(B, S), "labels": ids(B, S)})
    with torch.set_grad_enabled(step == "train"):
        return cfg, analyze_step(bundle.fn, *args)


@pytest.mark.parametrize("step", ["prefill", "decode", "train"])
def test_reduced_qwen3_flops_within_10pct_of_jax(step, jax_step_flops):
    cfg, s = _port_step(step)
    L, H, KV, dh = cfg.n_layers, cfg.n_heads, cfg.n_kv, cfg.dh
    Sq = 1 if step == "decode" else S
    # JAX's attention: every (query, key) pair; forward 4·dh flops a pair
    # and head, and 16 in training (forward, the remat's recompute, the
    # backward's four products)
    per_pair = {"prefill": 4, "decode": 4, "train": 16}[step]
    jax_attn = per_pair * dh * H * B * Sq * S * L
    # the port's kernels: the causal pairs, by their formulas (the model
    # passes the query and key positions, int32)
    fwd = roofline.attn_cost(B, Sq, S, H, KV, dh, 2, pos_elems=Sq + S)
    want = {"flash_attention": (L * (2 if step == "train" else 1),
                                L * (2 if step == "train" else 1) * fwd[0],
                                L * (2 if step == "train" else 1) * fwd[1])}
    if step == "train":
        bwd = roofline.bwd_cost(B, S, S, H, KV, dh, 2)
        want["flash_bwd"] = (L, L * bwd[0], L * bwd[1])
    assert s.kernels == want
    port_rest = s.flops - sum(f for _, f, _ in s.kernels.values())
    jax_rest = jax_step_flops[step] - jax_attn
    assert abs(port_rest / jax_rest - 1) < 0.10, (port_rest, jax_rest)


# ---------------------------------------------------------------- run_cell
KINDS = {"qwen3-32b": "dense", "phi3.5-moe-42b-a6.6b": "moe",
         "qwen2-vl-72b": "vlm", "seamless-m4t-medium": "encdec",
         "rwkv6-3b": "rwkv", "jamba-v0.1-52b": "hybrid"}


@pytest.fixture(scope="module")
def dryrun_records(tmp_path_factory):
    """`run_cell` on the reduced config of one arch of each kind, each step
    kind, over the fake (16, 16) production mesh; qwen3's long_500k too,
    and one cell over (2, 16, 16)."""
    outdir = tmp_path_factory.mktemp("dryrun_torch")
    cells = [(arch, cell, False) for arch in KINDS
             for cell in ("train_4k", "prefill_32k", "decode_32k")]
    cells += [("qwen3-32b", "long_500k", False),
              ("jamba-v0.1-52b", "decode_32k", True)]
    _run(f"""
        import json
        from repro_torch.configs import get_config
        from repro_torch.launch import dryrun
        dryrun.get_config = lambda arch: get_config(arch, reduced=True)
        for arch, cell, multi in {cells!r}:
            dryrun.run_cell(arch, cell, multi, {str(outdir)!r})
        print(json.dumps({{}}))
    """)
    recs = [json.loads(p.read_text()) for p in sorted(outdir.iterdir())]
    assert len(recs) == len(cells)
    return recs


def test_run_cell_records_obey_the_dryrun_schema(dryrun_records):
    """The checks of `test_dryrun_artifact_schema`, on these records."""
    ok = 0
    for rec in dryrun_records:
        assert rec["status"] in ("ok", "skipped"), \
            (rec["arch"], rec["cell"], rec.get("traceback"))
        assert {"arch", "cell", "mesh"} <= set(rec)
        if rec["status"] == "ok":
            ok += 1
            rl = rec["roofline"]
            for key in ("t_compute_s", "t_memory_s", "t_collective_s",
                        "bottleneck", "roofline_fraction"):
                assert key in rl, (rec["arch"], key)
            assert rl["t_bound_s"] >= max(
                rl["t_compute_s"], rl["t_memory_s"],
                rl["t_collective_s"]) * 0.999
            assert rec["memory"]["temp_bytes"] >= 0
        else:
            assert rec["cell"] == "long_500k"
    assert ok == len(dryrun_records) - 1


@pytest.mark.parametrize("arch", list(KINDS))
def test_run_cell_counts_each_kind(dryrun_records, arch):
    """Each kind's steps: counted FLOPs and bytes, 256 devices, a kernel
    of the kind launched in every step, collectives over the mesh, and
    the train step updating its state in place (aliased bytes)."""
    kernel = {"rwkv": "wkv", "hybrid": "selective_scan_fused"}.get(
        KINDS[arch], "flash_attention")
    recs = {r["cell"]: r for r in dryrun_records
            if r["arch"] == arch and r["mesh"] == "single"}
    for cell in ("train_4k", "prefill_32k", "decode_32k"):
        rec = recs[cell]
        assert rec["n_devices"] == 256
        assert rec["roofline"]["flops_per_device"] > 0
        assert rec["roofline"]["bytes_per_device"] > 0
        assert rec["roofline"]["wire_bytes_per_device"] > 0
        assert rec["kernels"][kernel]["launches"] > 0, cell
        assert rec["params_total"] >= rec["params_active"] > 0
    assert "flash_bwd" in recs["train_4k"]["kernels"] or \
        "wkv_bwd" in recs["train_4k"]["kernels"]
    assert recs["train_4k"]["memory"]["alias_bytes"] > 0


def test_long_500k_of_a_pure_attention_arch_is_skipped(dryrun_records):
    rec = next(r for r in dryrun_records if r["cell"] == "long_500k")
    assert rec["status"] == "skipped" and "unbounded" in rec["reason"]


def test_multi_mesh_cell(dryrun_records):
    rec = next(r for r in dryrun_records if r["mesh"] == "multi")
    assert rec["status"] == "ok" and rec["n_devices"] == 512
