"""Shared model machinery: parameter descriptors and initialisation,
logical axis sharding over a `DeviceMesh`, and the training losses'
per-layer rematerialisation (`remat`).

Parameters are described once as a tree (nested dicts) of `Desc` (shape,
logical axes, dtype, initializer), as in the JAX package; `init_params`
draws real tensors from a `torch.Generator` under the same rules.
Logical axis names, as in `repro/models/common.py`:

  fsdp — parameter shards over the data(+pod) axes (ZeRO-3 style)
  tp   — tensor-parallel over the model axis (Megatron column/row)
  exp  — expert-parallel over the model axis
  dp   — activation batch axis over (pod, data)
  sp   — long sequences / KV cache over the model axis

`AxisRules` resolves them to mesh axes exactly as the JAX package does
(`physical`, one spec entry per tensor dim: None, a mesh axis name or a
tuple of them) and turns a spec into one DTensor placement per mesh dim
(`placements`). With a `torch.distributed.device_mesh.DeviceMesh` the
parameters are DTensors (`distribute_params`), `constrain` redistributes
an activation to its resolved placements, and `local` runs a hand-written
kernel's wrapper on each rank's local shards (`local_map`): a kernel only
ever sees plain tensors. `NULL_RULES` (no mesh) leaves everything as it
was on one card: `constrain` returns its argument and `local` its
function.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field, replace
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint


@dataclass(frozen=True)
class Desc:
    """One parameter: shape + logical axes + dtype + init."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...] = ()    # logical names per dim
    init: str = "normal"           # normal | scaled | zeros | ones | full
    dtype: torch.dtype = torch.bfloat16
    # std for normal and scaled (normal's default is 1/sqrt(fan_in)),
    # value for full
    scale: float | None = None

    def fan_in(self) -> int:
        return self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]


def stacked(desc: Desc, n: int) -> Desc:
    """Add a leading layer axis (parameters stacked over layers)."""
    return replace(desc, shape=(n,) + desc.shape, axes=(None,) + desc.axes)


def tree_map(fn, tree):
    """Apply `fn` to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order, the order `jax.tree` flattens dicts."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves: list):
    """A tree shaped as `tree` whose leaves, in `tree_leaves` order, are
    `leaves`."""
    it = iter(leaves)

    def take(node):
        if isinstance(node, dict):
            taken = {k: take(node[k]) for k in sorted(node)}
            return {k: taken[k] for k in node}
        return next(it)
    return take(tree)


def stack_tree(tree, n: int):
    return tree_map(lambda d: stacked(d, n), tree)


def _init_leaf(desc: Desc, generator: torch.Generator, device) -> torch.Tensor:
    if desc.init == "zeros":
        return torch.zeros(desc.shape, dtype=desc.dtype, device=device)
    if desc.init == "ones":
        return torch.ones(desc.shape, dtype=desc.dtype, device=device)
    if desc.init == "full":
        return torch.full(desc.shape, desc.scale, dtype=desc.dtype,
                          device=device)
    if desc.init not in ("normal", "scaled"):
        raise ValueError(f"unknown init {desc.init!r}")
    scale = desc.scale if desc.scale is not None else \
        1.0 / math.sqrt(max(desc.fan_in(), 1))
    x = torch.randn(desc.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(desc.dtype)


def init_params(tree, generator: torch.Generator, device="cuda") -> Any:
    """Tensors for a `Desc` tree on `device`, drawn from `generator` (which
    must live on that device) leaf by leaf in sorted-key order."""
    return tree_map(lambda d: _init_leaf(d, generator, device), tree)


def param_count(tree) -> int:
    """Exact count from a `Desc` or tensor tree."""
    return sum(math.prod(leaf.shape) for leaf in tree_leaves(tree))


# ------------------------------------------------------------------ sharding
def _mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh` (or of any object with
    `mesh_dim_names` and `shape`, such as a stand-in for a mesh that is
    not there)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def placements_of(spec: tuple, mesh) -> tuple:
    """A JAX-shaped spec (one entry per tensor dim: None, a mesh axis name
    or a tuple of names) as one `Shard(d)`/`Replicate()` per mesh dim. A
    tuple shards its dim over several mesh dims, the first one outermost,
    as JAX's does; its names must come in the mesh's order, and a mesh
    dim may shard one tensor dim only."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two "
                                 f"tensor dims of {spec}")
            out[i] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class AxisRules:
    """Logical → physical axis mapping, and the `DeviceMesh` it maps onto
    (None: one device, every constraint off)."""

    mapping: dict[str, Any] = field(default_factory=dict)
    mesh: Any = None

    def physical(self, axes: tuple[str | None, ...],
                 shape: tuple[int, ...] | None = None) -> tuple:
        """Resolve logical axes as the JAX package does: each mesh axis
        at most once in a spec, and with `shape` the trailing mesh axes of
        an entry dropped until the dimension divides evenly (8 experts on
        a 16-way model axis stay replicated)."""
        sizes = _mesh_sizes(self.mesh) if self.mesh is not None else {}
        resolved: list = []
        used: set[str] = set()
        for i, a in enumerate(axes):
            phys = None if a is None else self.mapping.get(a)
            if phys is None:
                resolved.append(None)
                continue
            phys_t = (phys,) if isinstance(phys, str) else tuple(phys)
            phys_t = tuple(p for p in phys_t if p not in used)
            if shape is not None and sizes:
                while phys_t and shape[i] % math.prod(
                        sizes.get(p, 1) for p in phys_t):
                    phys_t = phys_t[:-1]
            used.update(phys_t)
            resolved.append(None if not phys_t else phys_t[0]
                            if len(phys_t) == 1 else phys_t)
        return tuple(resolved)

    def placements(self, axes: tuple[str | None, ...],
                   shape: tuple[int, ...] | None = None) -> tuple:
        """One DTensor placement per mesh dim for a tensor of `axes`."""
        return placements_of(self.physical(axes, shape), self.mesh)

    def spec_tree(self, tree) -> Any:
        return tree_map(lambda d: self.physical(d.axes, d.shape), tree)

    def sharding_tree(self, tree) -> Any:
        """Placements per leaf of a `Desc` tree."""
        if self.mesh is None:
            raise ValueError("sharding_tree needs a mesh")
        return tree_map(lambda d: self.placements(d.axes, d.shape), tree)

    def constrain(self, x: torch.Tensor, *axes: str | None) -> torch.Tensor:
        """`x` redistributed to the placements its axes resolve to (a
        plain tensor is taken as replicated); no-op without a mesh."""
        if self.mesh is None:
            return x
        return to_dtensor(x, self.mesh).redistribute(
            self.mesh, self.placements(tuple(axes), tuple(x.shape)))

    def coord(self, entry) -> tuple[int, int]:
        """This rank's index along the mesh axes of one spec entry (None,
        a name or a tuple of names, the first outermost), and their
        size: which of the `size` shards of that dim the rank holds."""
        index, size = 0, 1
        for name in _phys_names(entry):
            n = self.mesh.size(list(self.mesh.mesh_dim_names).index(name))
            index, size = index * n + self.mesh.get_local_rank(name), size * n
        return index, size

    def replicated(self, x: torch.Tensor) -> torch.Tensor:
        """A plain tensor that meets DTensors in a differentiated product
        (RoPE tables, label masks) as a replicated DTensor, so that its
        backward mixes no plain tensor in either; `x` without a mesh."""
        return x if self.mesh is None else to_dtensor(x, self.mesh)

    def partial(self, placements: tuple, entry) -> tuple:
        """`placements` with the mesh dims of `entry` (one resolved spec
        entry: None, a name or a tuple of names) made `Partial()`: a
        gradient summed over a dim that those ranks split, such as a
        weight's over the batch or a replicated input's over the heads,
        comes out as a partial sum over them."""
        from torch.distributed.tensor import Partial
        names = list(self.mesh.mesh_dim_names)
        out = list(placements)
        for name in _phys_names(entry):
            out[names.index(name)] = Partial()
        return tuple(out)

    def gathered(self, tree):
        """A layer's weights before its products (the FSDP all-gather):
        each DTensor leaf's shards over the "fsdp" mesh axes gathered,
        those mesh dims replicated, the rest kept; the backward
        reduce-scatters the gradients back onto the parameters' shards.
        So every product's placements follow the activations', never a
        sharding DTensor would pick from the weights. Without a mesh (or
        without "fsdp" axes), `tree` itself."""
        if self.mesh is None:
            return tree
        from torch.distributed.tensor import DTensor, Replicate
        names = list(self.mesh.mesh_dim_names)
        dims = {names.index(n) for n in _phys_names(self.mapping.get("fsdp"))
                if n in names}

        def gather(t):
            if not isinstance(t, DTensor) or not dims:
                return t
            pl = tuple(Replicate() if i in dims else p
                       for i, p in enumerate(t.placements))
            return t if pl == tuple(t.placements) else t.redistribute(
                self.mesh, pl)
        return tree_map(gather, tree)

    def split_by(self, axes: tuple, shape: tuple, dim: int):
        """The resolved spec entry of dim `dim` of a tensor of `axes` and
        `shape`: the mesh axes that split it (None if none do)."""
        return self.physical(tuple(axes), tuple(shape))[dim]

    def local(self, fn: Callable, ins: tuple, outs, grads=None) -> Callable:
        """`fn` run on each rank's local shards (`local_map`): each tensor
        argument is redistributed to its placements in `ins` (None for a
        non-tensor argument; a plain tensor is taken as replicated), the
        outputs are read as placed by `outs` (one entry an output), and
        `grads`, where given, are the placements of the inputs' gradients
        (a replicated input's gradient may be a partial sum, `partial`).
        Without a mesh, `fn` itself."""
        if self.mesh is None:
            return fn
        from torch.distributed.tensor.experimental import local_map
        mesh = self.mesh
        mapped = local_map(fn, out_placements=outs, in_placements=ins,
                           in_grad_placements=grads, device_mesh=mesh,
                           redistribute_inputs=True)

        def wrapped(*args):
            return mapped(*(a if pl is None or not isinstance(
                a, torch.Tensor) else to_dtensor(a, mesh)
                for a, pl in zip(args, ins)))
        return wrapped

    def distribute(self, x: torch.Tensor, *axes: str | None
                   ) -> torch.Tensor:
        """A tensor that every rank holds whole (a cache built from
        gathered values) as a DTensor placed by its axes, each rank
        keeping its own slice; without a mesh, `x` itself."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(x, self.mesh,
                                 self.placements(tuple(axes), tuple(x.shape)),
                                 src_data_rank=None)

    def scope(self):
        """Where the model mixes its DTensor parameters with plain tensors
        (positions, masks, token ids), the plain ones are taken as
        replicated; without a mesh, nothing."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()


def _phys_names(phys) -> tuple:
    if phys is None:
        return ()
    return (phys,) if isinstance(phys, str) else tuple(phys)


def to_dtensor(x: torch.Tensor, mesh) -> torch.Tensor:
    """`x` as a DTensor on `mesh`: a DTensor as it is, a plain tensor (the
    same on every rank) replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def whole(x):
    """The full tensor of a DTensor (gathered on every rank); a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


# single-device runs: everything replicated, constraints off
NULL_RULES = AxisRules(mapping={}, mesh=None)

# Sharding profiles, as the JAX package's:
#   baseline   — FSDP over data(+pod) × Megatron-TP over model
#   fsdp_only  — parameters fully sharded over every axis, no TP
#   decode_tp  — weights TP-sharded over model only; batch over data;
#                the cache's sequence over whatever remains
_PROFILES = {
    "baseline": {
        "dp": ("data",), "fsdp": ("data",), "tp": ("model",),
        "exp": ("model",), "sp": ("model",),
    },
    "fsdp_only": {
        "dp": ("data", "model"), "fsdp": ("data", "model"), "tp": (),
        "exp": ("model",), "sp": (),
    },
    "decode_tp": {
        "dp": ("data",), "fsdp": (), "tp": ("model",),
        "exp": ("model",), "sp": ("data", "model"),
    },
}
_PROFILES_MULTI = {
    "baseline": {
        "dp": ("pod", "data"), "fsdp": ("pod", "data"), "tp": ("model",),
        "exp": ("model",), "sp": ("model",),
    },
    "fsdp_only": {
        "dp": ("pod", "data", "model"), "fsdp": ("pod", "data", "model"),
        "tp": (), "exp": ("model",), "sp": (),
    },
    "decode_tp": {
        "dp": ("pod", "data"), "fsdp": (), "tp": ("model",),
        "exp": ("model",), "sp": ("data", "model"),
    },
}


def rules_for(mesh, profile: str = "baseline") -> AxisRules:
    if mesh is None:
        return NULL_RULES
    table = _PROFILES_MULTI if "pod" in mesh.mesh_dim_names else _PROFILES
    return AxisRules(mapping=dict(table[profile]), mesh=mesh)


def distribute_params(params, desc, rules: AxisRules):
    """Each tensor of `params` (the same full tensor on every rank) as a
    DTensor with the placements its `Desc` resolves to; without a mesh,
    `params` as they are."""
    if rules.mesh is None:
        return params
    from torch.distributed.tensor import distribute_tensor
    flat = [distribute_tensor(t, rules.mesh,
                              rules.placements(d.axes, d.shape),
                              src_data_rank=None)
            for t, d in zip(tree_leaves(params), tree_leaves(desc))]
    return tree_unflatten(params, flat)


def abstract_params(tree, rules: AxisRules = NULL_RULES) -> Any:
    """Meta tensors of a `Desc` tree's shapes and dtypes (the dry-run's
    arguments: no memory is ever allocated); with a mesh in `rules`,
    meta DTensors placed by the leaves' resolved axes."""
    def leaf(d: Desc) -> torch.Tensor:
        t = torch.empty(d.shape, dtype=d.dtype, device="meta")
        if rules.mesh is None:
            return t
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, rules.mesh,
                                 rules.placements(d.axes, d.shape),
                                 src_data_rank=None)
    return tree_map(leaf, tree)


def remat(cfg, fn, *args):
    """fn(*args), its activations recomputed in backward (JAX's
    `maybe_remat`) when `cfg.remat` is not "none" and a gradient can reach
    a tensor of `args` (trees included); otherwise a plain call, so that a
    serving path, whose weights need no gradient, never checkpoints."""
    if cfg.remat != "none" and torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for a in args for t in tree_leaves(a)):
        return checkpoint(replicating(fn), *args, use_reentrant=False)
    return fn(*args)


def replicating(fn: Callable) -> Callable:
    """`fn` run with plain tensors taken as replicated wherever it meets a
    DTensor: a checkpointed function is run again in backward, outside
    the caller's `AxisRules.scope`."""
    def run(*args):
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            return fn(*args)
    return run
