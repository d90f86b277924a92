"""Per-device cost of one eager step (`repro/launch/hlo_cost.py`).

The JAX package re-derives its counts from the compiled HLO text. The
port has no HLO: `analyze_step(fn, *args)` runs the step itself, on the
`meta` device for the dry-run or on the card, under a
`TorchDispatchMode` that sees what one rank dispatches, and counts:

  flops       — `torch.utils.flop_counter`'s formulas (products,
                convolutions, attention) over the rank's local ops, plus
                each model kernel's own (`roofline.*_cost`, recorded by
                the kernels' cost hook, `kernels/_cost.py`)
  bytes       — each local aten op's inputs read and outputs written,
                since the eager port runs them unfused: views, `detach`,
                `expand` and metadata ops move nothing, a write into a
                slice (`copy_` into a view, `index_put_`, `index_copy_`,
                `scatter`) moves the slice, not the buffer, and an input
                expanded over a dim is read once; plus each kernel's own
  collectives — the `_c10d_functional` ops (and DTensor's all-to-all):
                per kind, count, result bytes and ring-model wire bytes
                (`roofline.wire_bytes`, g from the op's group), and the
                wire bytes by the slowest link class the group spans
  memory      — the arguments', the outputs' and the aliased (updated in
                place) bytes, and `temp_bytes`: the peak of live local
                bytes beyond the arguments, less the outputs' new bytes

A DTensor op is not counted itself: the mode hands it back to DTensor,
whose dispatch then issues the rank's redistributions and local op, which
the mode counts. Counting the DTensor op as well would add the global
product to the local one. The sharding propagation's fake-tensor ops are
not counted, nor the plain-tensor ops inside a kernel's wrapper (the
hook pauses the counter while the kernel runs).

An eager step unrolls every loop, so the reference's `loops` (body, trip
count) has no counterpart: a loop over layers is counted once a layer,
as it runs.
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import _cost
from . import roofline

aten = torch.ops.aten

# ops that move no bytes of their own
_FREE = {
    aten.empty.memory_format, aten.empty_strided.default,
    aten.empty_like.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten._unsafe_view.default,
    aten.set_.source_Storage_storage_offset, aten.resize_.default,
    aten._local_scalar_dense.default, aten.lift_fresh.default,
    aten.detach.default, aten.alias.default,
}
# writes into a slice: (the operand written from, index operands)
_SLICE_WRITES = {
    aten.index_put_.default: (2, (1,)),
    aten._index_put_impl_.default: (2, (1,)),
    aten.index_copy_.default: (3, (2,)),
    aten.index_copy.default: (3, (2,)),
    aten.index_add_.default: (3, (2,)),
    aten.scatter_.src: (3, (2,)),
    aten.scatter_add_.default: (3, (2,)),
}
_FILLS = {aten.fill_.Scalar, aten.fill_.Tensor, aten.zero_.default}


def _collective_ops() -> dict:
    """{op overload: (kind, index of the group-name argument)}"""
    import torch.distributed._functional_collectives  # noqa: F401
    import torch.distributed.tensor  # noqa: F401  (registers _dtensor ops)
    c = torch.ops._c10d_functional
    return {
        c.all_gather_into_tensor.default: ("all-gather", 2),
        c.all_gather_into_tensor_out.default: ("all-gather", 2),
        c.all_gather_into_tensor_coalesced.default: ("all-gather", 2),
        c.reduce_scatter_tensor.default: ("reduce-scatter", 3),
        c.reduce_scatter_tensor_coalesced.default: ("reduce-scatter", 3),
        c.all_reduce.default: ("all-reduce", 2),
        c.all_reduce_.default: ("all-reduce", 2),
        c.all_reduce_coalesced.default: ("all-reduce", 2),
        c.all_to_all_single.default: ("all-to-all", 3),
        torch.ops._dtensor.shard_dim_alltoall.default: ("all-to-all", 3),
    }


@dataclass
class CostSummary:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    wire_bytes: float = 0.0
    # kind -> (count, result bytes, wire bytes)
    collectives: dict = field(default_factory=dict)
    # link class ("nvlink", "network") -> wire bytes
    wire_bytes_by_link: dict = field(default_factory=dict)
    # kernel name -> (launches, flops, bytes)
    kernels: dict = field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    temp_bytes: int = 0

    def add_collective(self, kind, count, nbytes, wire):
        c, b, w = self.collectives.get(kind, (0, 0.0, 0.0))
        self.collectives[kind] = (c + count, b + nbytes, w + wire)

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        n, f, b = self.kernels.get(name, (0, 0, 0))
        self.kernels[name] = (n + 1, f + flops, b + nbytes)
        self.flops += flops
        self.bytes_accessed += nbytes


def _bytes_read(t: torch.Tensor) -> int:
    """Bytes of the distinct elements of `t`: a dim of stride 0 (an
    expanded one) is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


class _Counter(TorchDispatchMode):
    """Counts one rank's local ops into a `CostSummary`; see the module's
    docstring."""

    def __init__(self, summary: CostSummary, arg_keys: set):
        super().__init__()
        self.summary = summary
        self._paused = 0
        self._args = arg_keys
        self._live: dict[int, list] = {}       # storage -> [bytes, refs]
        self.live_bytes = self.peak_bytes = 0
        self._collectives = _collective_ops()
        self._links: dict = {}

    # -------------------------------------------------- the kernels' hook
    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        self.summary.add_kernel(name, flops, nbytes)

    @contextlib.contextmanager
    def paused(self):
        """Ops run inside count no flops, bytes or collectives (their
        allocations still count toward the live bytes)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if types:
            from torch.distributed.tensor import DTensor
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented        # DTensor issues local ops
            return func(*args, **kwargs)     # sharding propagation's fakes
        out = func(*args, **kwargs)
        for t in _tensors(out):
            self._track(t)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        s = self.summary
        coll = self._collectives.get(func)
        outs = _tensors(out)
        if coll is not None:
            kind, group_at = coll
            nbytes = sum(t.numel() * t.element_size() for t in outs)
            group = args[group_at] if len(args) > group_at \
                else kwargs["group_name"]
            g, link = self._group(group)
            wire = roofline.wire_bytes(kind, nbytes, g)
            s.add_collective(kind, 1, nbytes, wire)
            s.wire_bytes += wire
            s.wire_bytes_by_link[link] = \
                s.wire_bytes_by_link.get(link, 0.0) + wire
        packet = func._overloadpacket
        if packet in flop_registry:
            s.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        s.bytes_accessed += self._bytes(func, args, kwargs, outs)

    @staticmethod
    def _bytes(func, args, kwargs, outs) -> int:
        if func.is_view or func in _FREE \
                or torch.Tag.inplace_view in func.tags:
            return 0
        if func in _FILLS:
            return sum(t.numel() * t.element_size() for t in outs)
        if func is aten.copy_.default:        # read src, write dst
            return _bytes_read(args[1]) + \
                args[0].numel() * args[0].element_size()
        if func in _SLICE_WRITES:
            src_at, index_at = _SLICE_WRITES[func]
            src = args[src_at] if len(args) > src_at else None
            index = [t for i in index_at if i < len(args)
                     for t in _tensors(args[i])]
            return (2 * _bytes_read(src) if isinstance(src, torch.Tensor)
                    else 0) + sum(_bytes_read(t) for t in index)
        read = sum(_bytes_read(t) for t in _tensors((args, kwargs)))
        return read + sum(t.numel() * t.element_size() for t in outs)

    def _group(self, group) -> tuple[int, str]:
        """(size, link class) of a process group given by name or object."""
        key = group if isinstance(group, str) else id(group)
        if key not in self._links:
            import torch.distributed as dist
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            pg = _resolve_process_group(group) if isinstance(group, str) \
                else group
            ranks = dist.get_process_group_ranks(pg)
            self._links[key] = (len(ranks), roofline.link_of(ranks))
        return self._links[key]

    # ------------------------------------------------------------ memory
    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):   # no storage
            return
        key = st._cdata
        if key in self._args:
            return
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [st.nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            del self._live[key]
            self.live_bytes -= entry[0]


def _storages(tree) -> dict[int, int]:
    """{storage key: bytes} of the local tensors of a tree (DTensors'
    local shards)."""
    out = {}
    for t in _tensors(tree):
        st = _local(t).untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def analyze_step(fn, *args, **kwargs) -> CostSummary:
    """Run `fn(*args, **kwargs)` once under the counter and return what
    one rank did: flops, bytes, collectives, kernels and memory. With
    meta tensors (or DTensors over meta shards) nothing runs but the
    counting. The arguments' storages are not temporary; an output that
    shares one with an argument (a state updated in place) is aliased."""
    arg_storages = _storages((args, kwargs))
    summary = CostSummary(argument_bytes=sum(arg_storages.values()))
    counter = _Counter(summary, set(arg_storages))
    _cost.ACTIVE.append(counter)
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        _cost.ACTIVE.remove(counter)
    out_storages = _storages(out)
    summary.output_bytes = sum(out_storages.values())
    summary.alias_bytes = sum(n for k, n in out_storages.items()
                              if k in arg_storages)
    summary.temp_bytes = max(0, counter.peak_bytes - (
        summary.output_bytes - summary.alias_bytes))
    return summary
