"""The port's launch layer (`repro_torch.launch.steps`,
`repro_torch.launch.train`) against the JAX package's, on the CPU.

`apply_variant` must give the JAX package's config, profile and gradient
dtype for every arch × cell × variant; the step makers' eager callables
run the reduced configs (a train step, a prefill, an int8 decode step);
the train CLI runs end to end on the CPU and resumes from its own
checkpoints.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch.steps import apply_variant as jax_apply_variant
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import steps
from repro_torch.models import init_params
from repro_torch.models.common import tree_leaves

REPO = Path(__file__).resolve().parents[1]
CELLS = [(arch, cell, variant) for arch in JAX_ARCHS for cell in JAX_SHAPES
         for variant in ("baseline", "opt")]


@pytest.mark.parametrize("arch,cell,variant", CELLS,
                         ids=[f"{a}-{c}-{v}" for a, c, v in CELLS])
def test_apply_variant_matches_jax(arch, cell, variant):
    jcfg, jprofile, jgrad = jax_apply_variant(jax_get_config(arch), cell,
                                              variant)
    tcfg, tprofile, tgrad = steps.apply_variant(get_config(arch), cell,
                                                variant)
    assert (tprofile, tgrad) == (jprofile, jgrad)
    jfields = dataclasses.asdict(jcfg)
    tfields = dataclasses.asdict(tcfg)
    assert sorted(tfields) == sorted(jfields)
    assert tfields == jfields


def test_the_registries_agree():
    assert ARCHS == JAX_ARCHS and sorted(SHAPES) == sorted(JAX_SHAPES)


def _params(model, seed=0):
    return init_params(model.param_desc(),
                       torch.Generator().manual_seed(seed), "cpu")


def test_make_step_runs_every_kind_of_step_on_the_cpu():
    cfg = get_config("qwen3-32b", reduced=True)
    train = steps.make_step(cfg, "train_4k", "opt")
    assert train.model.cfg.ce_chunk == 1 << 20
    state = {"params": _params(train.model)}
    from repro_torch.training import init_opt_state
    state["opt"] = init_opt_state(state["params"])
    before = [t.clone() for t in tree_leaves(state["params"])]
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 33)).astype(
        np.int32))
    state, metrics = train.fn(state, {"tokens": toks[:, :-1],
                                      "labels": toks[:, 1:]})
    assert int(state["opt"]["step"]) == 1
    assert torch.isfinite(metrics["loss"]) and float(metrics["loss"]) > 0
    assert any(not torch.equal(a, b) for a, b in
               zip(before, tree_leaves(state["params"])))
    prefill = steps.make_step(cfg, "prefill_32k", "opt")
    decode = steps.make_step(cfg, "decode_32k", "opt")
    assert decode.model.cfg.kv_quant and not prefill.model.cfg.kv_quant
    params = _params(decode.model)
    logits, cache = decode.model.prefill(params, {"tokens": toks[:, :8]},
                                         pad_to=12)
    assert cache["k"].dtype == torch.int8
    logits2, cache = decode.fn(params, cache, {"tokens": toks[:, 8:9]})
    assert logits2.shape == logits.shape and torch.isfinite(logits2).all()
    assert int(cache["pos"]) == 9
    logits3, _ = prefill.fn(_params(prefill.model), {"tokens": toks[:, :8]})
    assert torch.isfinite(logits3).all()


def test_train_cli_runs_and_resumes_on_the_cpu(tmp_path):
    """`python -m repro_torch.launch.train --device cpu --reduced --steps
    4` builds the logs index, trains from the indexed loader with a
    keyword query, checkpoints, and a second run resumes from its last
    checkpoint."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    args = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--reduced", "--steps", "4", "--batch", "2", "--seq",
            "32", "--ckpt-every", "2", "--query", "block",
            "--workdir", str(tmp_path / "run")]
    first = subprocess.run(args, env=env, capture_output=True, text=True,
                           timeout=600)
    assert first.returncode == 0, first.stderr
    assert "losses:" in first.stdout and "resumed" not in first.stdout
    args[args.index("4")] = "6"
    second = subprocess.run(args, env=env, capture_output=True, text=True,
                            timeout=600)
    assert second.returncode == 0, second.stderr
    assert "resumed from step 4" in second.stdout
    from repro_torch.storage import LocalBlobStore
    from repro_torch.training import CheckpointManager
    assert CheckpointManager(LocalBlobStore(str(tmp_path / "run"))
                             ).all_steps() == [2, 4, 6]


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_train_cli_trains_rwkv_and_jamba_on_the_cpu(tmp_path, arch):
    """`python -m repro_torch.launch.train --arch <arch> --reduced
    --device cpu --steps 2`: RWKV-6 and Jamba train through the same
    `train()` as the transformer (their losses, the plain wkv and fused
    scan under autograd on the CPU): a finite logged loss and the
    checkpoint of step 2."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
         "--seq", "32", "--ckpt-every", "2", "--workdir",
         str(tmp_path / "run")], env=env, capture_output=True, text=True,
        timeout=600)
    assert run.returncode == 0, run.stderr
    line = next(ln for ln in run.stdout.splitlines()
                if ln.startswith("losses:"))
    losses = [float(x) for x in line.split("[")[1].rstrip("]").split(",")]
    assert losses and all(np.isfinite(losses))      # logged: step 1
    from repro_torch.storage import LocalBlobStore
    from repro_torch.training import CheckpointManager
    assert CheckpointManager(LocalBlobStore(str(tmp_path / "run"))
                             ).all_steps() == [2]
