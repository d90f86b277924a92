"""Carry the JAX package's parameters into the port.

`params_from_numpy` takes a parameter tree whose leaves are numpy arrays
(e.g. `jax.tree.map(np.asarray, params)` over the JAX package's tree) and
returns the same tree of tensors, dtype for dtype. bfloat16 arrays (whose
numpy dtype comes from `ml_dtypes`, which `torch.from_numpy` refuses) are
carried bit for bit through a uint16 view, so this module needs neither
JAX nor `ml_dtypes`.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import tree_map


def tensor_from_numpy(arr, device="cuda") -> torch.Tensor:
    """One array as a tensor of the same dtype and bits on `device`."""
    arr = np.array(arr, copy=True)     # np.asarray of a JAX array is read-only
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree, device="cuda"):
    """A nested-dict tree of numpy arrays → the same tree of tensors."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)
