"""Production and smoke meshes (`repro/launch/mesh.py`), as
`torch.distributed.device_mesh.DeviceMesh`es made by `init_device_mesh`.

Functions, so importing this module touches no process group. Each needs
`torch.distributed` initialised with as many ranks as the mesh has
devices; the meshes are on CUDA unless the caller names another device
type (the CPU tests pass "cpu" over gloo).
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16×16 ("data", "model"), or 2×16×16 with "pod" in front."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_smoke_mesh(n_devices: int | None = None, model: int = 2,
                    device_type: str = "cuda"):
    """(n // model, model) as ("data", "model") over `n_devices` ranks
    (the process group's size by default)."""
    n = n_devices or dist.get_world_size()
    model = min(model, n)
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))
