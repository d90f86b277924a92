"""One rank of the multi-process checks of `tests/test_torch_sharding.py`.

Run as `python tests/torch_sharding_worker.py RANK WORLD INIT_FILE DATA
OUT JOBS`: joins a gloo group of WORLD ranks through the file rendezvous
INIT_FILE (no port, so concurrent groups never collide), runs the jobs
named in JOBS (comma-separated) on CPU `DeviceMesh`es, reading inputs
from the `.npz` file DATA, and writes its results to OUT/rank<RANK>.json.
Every collective has the group's timeout, so a broken job fails instead
of hanging.
"""

import json
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch.elastic import choose_mesh, reshard_restore
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.pipeline import pipelined_mlp
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.common import (distribute_params, init_params,
                                       rules_for, whole, tree_leaves,
                                       tree_map)
from repro_torch.storage import InMemoryBlobStore
from repro_torch.training import CheckpointManager, OptimizerConfig
from repro_torch.training.optimizer import init_opt_state


def _tree(data, prefix: str) -> dict:
    """The nested dict stored flat under "<prefix>/<path>" keys."""
    out: dict = {}
    for key in data.files:
        if key.startswith(prefix + "/"):
            node = out
            *path, leaf = key[len(prefix) + 1:].split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = data[key]
    return out


def _leaf_err(a, b) -> float:
    """max |a - b| over a's scale."""
    a, b = whole(a).float(), whole(b).float()
    return float((a - b).abs().max()) / max(float(a.abs().max()), 1e-12)


def _grads(model, params, batch, rules=None):
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = (model.loss_fn(params, batch) if rules is None
            else model.loss_fn(params, batch, rules))
    grads = torch.autograd.grad(loss, leaves)
    for leaf in leaves:
        leaf.requires_grad_(False)
    return float(whole(loss.detach())), grads


def job_loss(arch, data):
    """The loss and every gradient leaf of the reduced `arch` in float32
    on a (2, 2) mesh, then one train step; rank 0 alone also runs both
    on one device (the other ranks would repeat it) and compares."""
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    tree = _tree(data, f"{arch}/params")
    batch = {k: torch.from_numpy(v) for k, v in
             _tree(data, f"{arch}/batch").items()}
    mesh = make_smoke_mesh(4, model=2, device_type="cpu")
    rules = rules_for(mesh)
    sharded = distribute_params(params_from_numpy(tree, "cpu"),
                                model.param_desc(), rules)
    placements = str(tree_leaves(sharded)[0].placements)
    loss2, g2 = _grads(model, sharded, batch, rules)
    g2 = [whole(g) for g in g2]
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1)
    two = make_train_step(cfg, opt, mesh=mesh)
    s2, m2 = two.fn({"params": sharded, "opt": init_opt_state(sharded)},
                    batch)
    pinned = all(m.placements == p.placements for m, p in
                 zip(tree_leaves(s2["opt"]["m"]), tree_leaves(s2["params"])))
    moments2 = [whole(t) for k in ("m", "v")
                for t in tree_leaves(s2["opt"][k])]
    if dist.get_rank():
        return {}
    params = params_from_numpy(tree, "cpu")
    loss1, g1 = _grads(model, params, batch)
    one = make_train_step(cfg, opt)
    s1, m1 = one.fn({"params": params, "opt": init_opt_state(params)}, batch)
    moments1 = [t for k in ("m", "v") for t in tree_leaves(s1["opt"][k])]
    return {"loss_single": loss1, "loss_sharded": loss2,
            "grad_err": max(_leaf_err(a, b) for a, b in zip(g1, g2)),
            "norms_single": [float(g.float().norm()) for g in g1],
            "norms_sharded": [float(g.float().norm()) for g in g2],
            "placements": placements,
            "step_loss": [float(m1["loss"]), float(m2["loss"])],
            "step_grad_norm": [float(m1["grad_norm"]),
                               float(m2["grad_norm"])],
            "step_moment_err": max(_leaf_err(a, b)
                                   for a, b in zip(moments1, moments2)),
            "step_pinned": pinned}


def job_odd(arch, data):
    """Shapes the mesh does not divide, where `physical` drops a mesh
    axis: a batch of 3 rows on (2, 2) (not split over "data"), and 6
    query heads on (1, 4) (not split over "model", so K/V are not cut);
    the loss and every gradient leaf against one device (rank 0)."""
    from torch.distributed.device_mesh import init_device_mesh
    out = {}
    for name, mesh_shape, cfg_kw, rows in (
            ("batch3", (2, 2), {}, 3), ("heads6", (1, 4), {"n_heads": 6}, 4)):
        cfg = get_config(arch, reduced=True).with_(**cfg_kw)
        model = build_model(cfg)
        params = tree_map(lambda t: t.float(), init_params(
            model.param_desc(), torch.Generator().manual_seed(7), "cpu"))
        batch = {k: torch.from_numpy(v)[:rows] for k, v in
                 _tree(data, f"{arch}/batch").items()}
        rules = rules_for(init_device_mesh("cpu", mesh_shape,
                                           mesh_dim_names=("data", "model")))
        sharded = distribute_params(tree_map(torch.clone, params),
                                    model.param_desc(), rules)
        loss2, g2 = _grads(model, sharded, batch, rules)
        g2 = [whole(g) for g in g2]
        if dist.get_rank() == 0:
            loss1, g1 = _grads(model, params, batch)
            out[name] = {"loss": [loss1, loss2], "grad_err": max(
                _leaf_err(a, b) for a, b in zip(g1, g2))}
    return out


def job_serve(arch, data):
    """Sharded prefill (pad_to 24) and one decode step of the reduced
    `arch`, beside the same on one device."""
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    tree = _tree(data, f"{arch}/params")
    toks = torch.from_numpy(data[f"{arch}/serve_tokens"])
    params = params_from_numpy(tree, "cpu")
    l1, c1 = model.prefill(params, {"tokens": toks}, pad_to=24)
    d1, _ = model.decode_step(params, c1, {"tokens": toks[:, :1]})
    rules = rules_for(make_smoke_mesh(4, model=2, device_type="cpu"))
    sharded = distribute_params(params_from_numpy(tree, "cpu"),
                                model.param_desc(), rules)
    l2, c2 = model.prefill(sharded, {"tokens": toks}, pad_to=24,
                           rules=rules)
    d2, c3 = model.decode_step(sharded, c2, {"tokens": toks[:, :1]},
                               rules=rules)
    d2 = whole(d2)
    return {"shape": list(d2.shape), "finite": bool(torch.isfinite(d2).all()),
            "prefill_err": _leaf_err(l1, l2), "decode_err": _leaf_err(d1, d2),
            "cache_placements": str(c3["k"].placements)}


def job_ckpt(arch, data):
    """A state saved on (2, 2) restored onto (1, 4) by `reshard_restore`,
    bit for bit; the sharded save's blobs against an unsharded save's;
    and a sharded step repeated from a restored checkpoint bit for bit."""
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    desc = model.param_desc()
    params = init_params(desc, torch.Generator().manual_seed(3), "cpu")
    rules_a = rules_for(make_smoke_mesh(4, model=2, device_type="cpu"))
    state = {"params": distribute_params(tree_map(torch.clone, params), desc,
                                         rules_a)}
    state["opt"] = init_opt_state(state["params"])
    store, plain = InMemoryBlobStore(), InMemoryBlobStore()
    CheckpointManager(store).save(11, state)
    CheckpointManager(plain).save(11, {"params": params,
                                       "opt": init_opt_state(params)})
    same_blobs = all(store.get(n) == plain.get(n) for n in plain.list(""))
    same_blobs &= sorted(store.list("")) == sorted(plain.list(""))
    mesh_b = choose_mesh(4, prefer_model=4, device_type="cpu")
    restored, manifest = reshard_restore(CheckpointManager(store), model,
                                         mesh_b)
    bits = all(torch.equal(whole(a).view(torch.uint8) if a.dtype ==
                           torch.bfloat16 else whole(a),
                           whole(b).view(torch.uint8) if b.dtype ==
                           torch.bfloat16 else whole(b))
               for a, b in zip(tree_leaves(state), tree_leaves(restored)))
    head = restored["params"]["lm_head"]
    # a resume on the (2, 2) mesh repeats the second step's loss bit for bit
    batch = {k: torch.from_numpy(v) for k, v in
             _tree(data, f"{arch}/batch").items()}
    step = make_train_step(cfg, OptimizerConfig(lr=1e-3, warmup_steps=1),
                           mesh=rules_a.mesh)
    fresh = {"params": distribute_params(
        tree_map(lambda t: t.float(), params), desc, rules_a)}
    fresh["opt"] = init_opt_state(fresh["params"])
    ckpt = CheckpointManager(InMemoryBlobStore())
    fresh, _ = step.fn(fresh, batch)
    ckpt.save(1, fresh)
    _, m_a = step.fn(fresh, batch)
    again, _ = ckpt.restore(fresh, step=1)
    _, m_b = step.fn(again, batch)
    return {"bits": bits, "same_blobs": bool(same_blobs),
            "step": manifest["step"],
            "mesh_b": list(mesh_b.shape),
            "head_placements": str(head.placements),
            "head_local_rows": head.to_local().shape[0],
            "resume": [float(m_a["loss"]), float(m_b["loss"])]}


def job_pipe(_arg, data):
    """`pipelined_mlp` on a 4-stage "pipe" mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("pipe",))
    y = pipelined_mlp(mesh, torch.from_numpy(data["pipe/ws"]),
                      torch.from_numpy(data["pipe/x"]),
                      n_micro=int(data["pipe/n_micro"]))
    return {"y": y.tolist()}


JOBS = {"loss": job_loss, "odd": job_odd, "serve": job_serve,
        "ckpt": job_ckpt, "pipe": job_pipe}


def main(argv) -> None:
    rank, world = int(argv[1]), int(argv[2])
    init, data_path, out, jobs = argv[3], argv[4], argv[5], argv[6]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=240))
    data = np.load(data_path)
    results = {}
    for job in jobs.split(","):
        kind, _, arg = job.partition(":")
        results[job] = JOBS[kind](arg, data)
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
