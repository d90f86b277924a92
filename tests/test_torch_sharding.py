"""The port's logical sharding (`repro_torch.models.common.AxisRules`
over a `DeviceMesh`) and its launch modules (`launch/mesh.py`,
`elastic.py`, `pipeline.py`) against the JAX package, on the CPU.

- Spec parity, no processes: for every arch of the registry at its
  published size, every profile and the meshes (16, 16), (2, 16, 16) and
  (4, 2), the port's `spec_tree` of `param_desc`, `cache_desc` and
  `batch_desc` equals JAX's `AxisRules.physical` on the same descriptor.
  Both sides get a stand-in mesh carrying only its axis names and sizes
  (JAX's `physical` reads only `mesh.axis_names` and
  `mesh.devices.shape`, the port's `mesh_dim_names` and `shape`).
- Every port `Desc` carries JAX's axes.
- Multi-process checks: `tests/torch_sharding_worker.py` in groups of 4
  gloo ranks (a file rendezvous under `tmp_path`, so concurrent groups
  share no port; each group's collectives time out after 240 s and the
  group is killed after 300 s). The groups start together when the first
  of these tests asks for them and run side by side. Weights are JAX's
  (`init_params(..., PRNGKey(n))`) in float32, carried over by
  `params_from_numpy`. Tolerances: the sharded loss within 1e-5 of the
  single-device port's and of JAX's `NULL_RULES` loss (relative); every
  gradient leaf within 1e-4 of its scale of the single-device port's
  (sums in another order across ranks; measured at most 4e-5, Jamba);
  checkpoints and a resumed step bit for bit; the pipeline within 1e-4 of
  JAX's `reference_mlp`.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch.pipeline import reference_mlp as jax_reference_mlp
from repro.models import NULL_RULES as JAX_NULL_RULES
from repro.models import batch_desc as jax_batch_desc
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.models import rules_for as jax_rules_for
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch.elastic import mesh_shape
from repro_torch.models import batch_desc, build_model
from repro_torch.models.common import NULL_RULES, Desc, placements_of, \
    rules_for

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

PROFILES = ["baseline", "fsdp_only", "decode_tp"]
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "4x2": (("data", "model"), (4, 2))}


class StandInMesh:
    """Axis names and sizes only, in both packages' spellings."""

    def __init__(self, names, shape):
        self.axis_names = self.mesh_dim_names = names
        self.devices = np.empty(shape)
        self.shape = shape


def _flat(tree, path=()):
    """(path, leaf) of a nested dict of descriptors, sorted by key."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _flat(tree[k], path + (k,))]
    return [("/".join(path), tree)]


def _cache_desc(model, cfg):
    if cfg.kind == "encdec":
        return model.cache_desc(32, 4096, enc_len=1024)
    return model.cache_desc(32, 4096)


def _desc_pairs(arch):
    """(name, JAX descriptor tree, port descriptor tree) for the params,
    the cache and every cell's batch of `arch` at its published size."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    out = [("params", jm.param_desc(), tm.param_desc()),
           ("cache", _cache_desc(jm, jcfg), _cache_desc(tm, tcfg))]
    out += [(f"batch/{c}", jax_batch_desc(jcfg, JAX_SHAPES[c]),
             batch_desc(tcfg, SHAPES[c])) for c in SHAPES]
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tree_matches_jax_physical(arch, profile, mesh):
    """The port's resolved spec of every parameter, cache and batch leaf
    equals JAX's, and each converts to one placement per mesh dim."""
    stand_in = StandInMesh(*MESHES[mesh])
    jrules = jax_rules_for(stand_in, profile)
    trules = rules_for(stand_in, profile)
    assert trules.mapping == jrules.mapping
    for name, jtree, ttree in _desc_pairs(arch):
        jspecs = _flat(jrules.spec_tree(jtree))
        tspecs = _flat(trules.spec_tree(ttree))
        assert [p for p, _ in jspecs] == [p for p, _ in tspecs], name
        for (path, js), (_, ts) in zip(jspecs, tspecs):
            assert tuple(js) == ts, (name, path, js, ts)
            placements = placements_of(ts, stand_in)
            assert len(placements) == len(stand_in.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_desc_carries_the_jax_axes(arch):
    """Shape, logical axes, init, dtype name and scale of every leaf."""
    for name, jtree, ttree in _desc_pairs(arch):
        jleaves, tleaves = _flat(jtree), _flat(ttree)
        assert [p for p, _ in jleaves] == [p for p, _ in tleaves], name
        for (path, j), (_, t) in zip(jleaves, tleaves):
            assert isinstance(t, Desc)
            assert tuple(j.shape) == t.shape, (name, path)
            assert tuple(j.axes) == t.axes, (name, path, j.axes, t.axes)
            assert j.init == t.init and j.scale == t.scale, (name, path)
            assert jnp.dtype(j.dtype).name == str(t.dtype).split(".")[-1]


def test_null_rules_and_rules_for_without_a_mesh():
    """No mesh: every constraint off, `rules_for(None)` is `NULL_RULES`."""
    import torch
    x = torch.ones(2, 3)
    assert rules_for(None) is NULL_RULES
    assert NULL_RULES.constrain(x, "dp", None) is x
    fn = len
    assert NULL_RULES.local(fn, (), ()) is fn
    assert NULL_RULES.physical(("dp", "tp")) == (None, None)


def test_placements_refuse_what_dtensor_cannot_express():
    from torch.distributed.tensor import Replicate, Shard
    mesh = StandInMesh(("pod", "data", "model"), (2, 16, 16))
    assert placements_of((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert placements_of((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):          # not in the mesh's order
        placements_of((("data", "pod"),), mesh)
    with pytest.raises(ValueError):          # one mesh dim, two tensor dims
        placements_of(("model", "model"), mesh)


@pytest.mark.parametrize("n,prefer,expected", [
    (8, 4, {"data": 2, "model": 4}),          # JAX's test_integration_extras
    (6, 4, {"data": 3, "model": 2}),          # 6 % 4 != 0 -> degrade
    (4, 4, {"data": 1, "model": 4}),
    (256, 16, {"data": 16, "model": 16}),
    (3, 16, {"data": 3, "model": 1})])
def test_choose_mesh_shape_matches_jax(n, prefer, expected):
    assert mesh_shape(n, prefer) == expected


# ------------------------------------------------------ multi-process checks
LOSS_ARCHS = ["qwen3-32b", "granite-20b", "phi3.5-moe-42b-a6.6b",
              "rwkv6-3b", "jamba-v0.1-52b"]
GROUPS = {
    "dense": "loss:qwen3-32b,loss:granite-20b",
    "moe": "loss:phi3.5-moe-42b-a6.6b,serve:phi3.5-moe-42b-a6.6b",
    "rwkv": "loss:rwkv6-3b,pipe",
    "jamba": "loss:jamba-v0.1-52b",
    "ckpt": "ckpt:granite-20b,odd:qwen3-32b",
}
WORLD = 4
TIMEOUT = 300
PIPE = {"n_stages": 4, "n_micro": 8, "d": 32}


def _inputs():
    """float32 JAX weights, batches and the pipeline's inputs, flat by
    path for the workers; and JAX's NULL_RULES loss of each arch."""
    data, jax_loss = {}, {}
    rng = np.random.default_rng(5)
    for i, arch in enumerate(LOSS_ARCHS):
        cfg = jax_get_config(arch, reduced=True)
        model = jax_build_model(cfg)
        params = jax.tree.map(lambda x: x.astype(jnp.float32),
                              jax_init_params(model.param_desc(),
                                              jax.random.PRNGKey(i)))
        for path, leaf in _flat(params):
            data[f"{arch}/params/{path}"] = np.asarray(leaf)
        tokens = rng.integers(4, cfg.vocab, (4, 32)).astype(np.int32)
        labels = rng.integers(4, cfg.vocab, (4, 32)).astype(np.int32)
        labels[0, :5] = -1
        data[f"{arch}/batch/tokens"] = tokens
        data[f"{arch}/batch/labels"] = labels
        jax_loss[arch] = float(model.loss_fn(
            params, {"tokens": jnp.asarray(tokens),
                     "labels": jnp.asarray(labels)}, JAX_NULL_RULES))
    data["phi3.5-moe-42b-a6.6b/serve_tokens"] = rng.integers(
        4, 512, (8, 16)).astype(np.int32)
    s, d = PIPE["n_stages"], PIPE["d"]
    data["pipe/ws"] = rng.normal(0, 0.3, (s, d, d)).astype(np.float32)
    data["pipe/x"] = rng.normal(0, 1, (PIPE["n_micro"] * 4, d)).astype(
        np.float32)
    data["pipe/n_micro"] = np.asarray(PIPE["n_micro"])
    return data, jax_loss


class _Groups:
    """Every group of worker ranks, started together; `result(name)`
    waits for one group (killed past its deadline) and returns rank 0's
    results after checking every rank finished."""

    def __init__(self, root):
        data, self.jax_loss = _inputs()
        self.data = data
        path = os.path.join(root, "inputs.npz")
        np.savez(path, **data)
        env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
        self.procs, self.out = {}, {}
        self.deadline = time.monotonic() + TIMEOUT
        for name, jobs in GROUPS.items():
            out = os.path.join(root, name)
            os.makedirs(out)
            self.out[name] = out
            worker = os.path.join(HERE, "torch_sharding_worker.py")
            self.procs[name] = [subprocess.Popen(
                [sys.executable, worker, str(r), str(WORLD),
                 os.path.join(root, f"{name}.init"), path, out, jobs],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True) for r in range(WORLD)]

    def result(self, name) -> dict:
        errs = []
        for p in self.procs[name]:
            try:
                _, err = p.communicate(
                    timeout=max(self.deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                self.kill()
                pytest.fail(f"group {name!r} ran past {TIMEOUT} s")
            if p.returncode:
                errs.append(err[-3000:])
        assert not errs, errs[0]
        ranks = []
        for r in range(WORLD):
            with open(os.path.join(self.out[name], f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        return ranks[0]

    def kill(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    g = _Groups(str(tmp_path_factory.mktemp("sharding")))
    yield g
    g.kill()


def _group_of(job):
    return next(n for n, jobs in GROUPS.items() if job in jobs.split(","))


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_sharded_loss_and_gradients_match_one_device_and_jax(groups, arch):
    """On a (2, 2) mesh ("data", "model"), the `baseline` rules: the loss
    equals the single-device port's and JAX's NULL_RULES loss, every
    gradient leaf the single-device port's; granite's one KV head and
    the reduced configs' two (under 2 query heads a rank) run through
    `blocks.attend`'s cut of K/V, phi's experts shard over "model"."""
    res = groups.result(_group_of(f"loss:{arch}"))[f"loss:{arch}"]
    assert res["loss_sharded"] == pytest.approx(res["loss_single"], rel=1e-5)
    assert res["loss_sharded"] == pytest.approx(groups.jax_loss[arch],
                                                rel=1e-5)
    assert res["grad_err"] <= 1e-4, res["grad_err"]
    assert res["norms_sharded"] == pytest.approx(res["norms_single"],
                                                 rel=1e-4)
    assert "Shard" in res["placements"]


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_sharded_train_step_matches_one_device(groups, arch):
    """One AdamW step through `launch.steps.make_train_step(cfg, mesh=)`:
    the loss and the global gradient norm as unsharded, both moments
    placed as their parameters and within 1e-4 of each leaf's scale of
    the unsharded step's. (The weights themselves are not compared: the
    first update is about g / |g|, so an element whose gradient sits
    near 0 may move by lr either way under another order of sums.)"""
    res = groups.result(_group_of(f"loss:{arch}"))[f"loss:{arch}"]
    one, two = res["step_loss"]
    assert two == pytest.approx(one, rel=1e-5)
    one, two = res["step_grad_norm"]
    assert two == pytest.approx(one, rel=1e-5)
    assert res["step_pinned"]
    assert res["step_moment_err"] <= 1e-4, res["step_moment_err"]


@pytest.mark.parametrize("case", ["batch3", "heads6"])
def test_sharded_loss_where_the_mesh_does_not_divide(groups, case):
    """A batch of 3 rows on (2, 2) and 6 query heads on (1, 4): the
    resolved spec drops the mesh axis (as JAX's does), nothing is split
    there, and no gradient is taken for a partial sum it is not; the
    loss within 1e-5 and every gradient leaf within 1e-4 of its scale of
    one device's."""
    res = groups.result("ckpt")["odd:qwen3-32b"][case]
    one, two = res["loss"]
    assert two == pytest.approx(one, rel=1e-5)
    assert res["grad_err"] <= 1e-4, res["grad_err"]


def test_sharded_moe_prefill_and_decode(groups):
    """phi3.5-moe reduced on (2, 2): prefill with pad_to 24, one decode
    step; finite logits of shape (8, 512), as JAX's sharded test asks;
    prefill within 1e-5 of their scale of the single-device port's, the
    decode step within 1e-4 (it attends to the cache's bf16 K/V, where a
    float32 difference of an ulp flips a rounding; measured 2.4e-5); the
    cache stays placed as `cache_desc` says (B over "dp", T over
    "sp")."""
    res = groups.result("moe")["serve:phi3.5-moe-42b-a6.6b"]
    assert res["finite"] and res["shape"] == [8, 512]
    assert res["prefill_err"] <= 1e-5 and res["decode_err"] <= 1e-4, res
    assert res["cache_placements"] == "(Shard(dim=1), Shard(dim=2))"


def test_elastic_restore_from_2x2_onto_1x4_is_bit_equal(groups):
    """A bf16 state saved on (2, 2) holds the same blobs as its unsharded
    save; `reshard_restore` onto `choose_mesh(4, prefer_model=4)` = (1,
    4) gives every leaf back bit for bit, `lm_head` sharded 4-way over
    the vocabulary (its d_model over the "data" axis of 1, as JAX's spec
    keeps it); and a sharded step from a restored checkpoint repeats
    the loss bit for bit."""
    res = groups.result("ckpt")["ckpt:granite-20b"]
    assert res["same_blobs"]
    assert res["bits"] and res["step"] == 11
    assert res["mesh_b"] == [1, 4]
    assert res["head_placements"] == "(Shard(dim=1), Shard(dim=0))"
    assert res["head_local_rows"] == 512 // 4
    a, b = res["resume"]
    assert a == b


def test_pipelined_mlp_matches_jax_reference(groups):
    """GPipe over a 4-stage "pipe" mesh, 8 microbatches, d 32, against
    JAX's `reference_mlp` to 1e-4."""
    y = np.asarray(groups.result("rwkv")["pipe"]["y"], np.float32)
    ref = np.asarray(jax_reference_mlp(jnp.asarray(groups.data["pipe/ws"]),
                                       jnp.asarray(groups.data["pipe/x"])))
    assert y.shape == ref.shape
    assert float(np.abs(y - ref).max()) < 1e-4
