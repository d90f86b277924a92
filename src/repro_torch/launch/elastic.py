"""Elastic scaling (`repro/launch/elastic.py`): pick a mesh for the
devices that are alive and restore a checkpoint onto it.

`mesh_shape` factorises a device count into (data, model) as the JAX
package's `choose_mesh` does, preferring a model-parallel width; it is a
pure function. `choose_mesh` makes that mesh, and `reshard_restore`
loads any checkpoint (leaves are stored whole, whatever mesh saved
them) onto the mesh's placements.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate

from ..models.common import rules_for, tree_map
from ..training.checkpoint import CheckpointManager


def mesh_shape(n_devices: int, prefer_model: int = 16) -> dict[str, int]:
    """{"data", "model"}: the largest model width that divides
    `prefer_model` (halving it) and the device count."""
    model = prefer_model
    while model > 1 and (n_devices % model or model > n_devices):
        model //= 2
    return {"data": n_devices // model, "model": model}


def choose_mesh(n_devices: int | None = None, prefer_model: int = 16,
                device_type: str = "cuda"):
    """A ("data", "model") `DeviceMesh` of `mesh_shape`'s shape over
    `n_devices` ranks (the process group's size by default)."""
    shape = mesh_shape(n_devices or dist.get_world_size(), prefer_model)
    return init_device_mesh(device_type, (shape["data"], shape["model"]),
                            mesh_dim_names=("data", "model"))


def reshard_restore(ckpt: CheckpointManager, model, mesh, step=None,
                    with_opt: bool = True):
    """Restore the latest (or given) checkpoint onto `mesh`: every
    parameter (and, `with_opt`, both moments) as a DTensor placed by the
    `baseline` rules, the optimizer step replicated. Returns (state,
    manifest)."""
    rules = rules_for(mesh)
    desc = model.param_desc()
    placements = rules.sharding_tree(desc)
    like = tree_map(lambda d: torch.empty(0, dtype=d.dtype), desc)
    state_like, state_pl = {"params": like}, {"params": placements}
    if with_opt:
        state_like["opt"] = {"m": like, "v": like,
                             "step": torch.empty(0, dtype=torch.int32)}
        state_pl["opt"] = {"m": placements, "v": placements,
                           "step": (Replicate(),) * mesh.ndim}
    return ckpt.restore(state_like, step=step, placements=state_pl,
                        mesh=mesh)
