"""GPipe pipeline parallelism over a "pipe" mesh dim
(`repro/launch/pipeline.py`).

Each stage owns one block of layers (here one MLP layer, `_stage_fn`);
microbatches stream through the stages, each tick every stage applies
its block and hands the result to the next stage with `torch.distributed`
point-to-point ops (`batch_isend_irecv`, a ring, as JAX's `ppermute`:
the last stage's send lands on stage 0, which ignores it). The schedule
runs n_micro + n_stages - 1 ticks, bubbles included. The last stage's
block of outputs is the result, broadcast to every stage.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _stage_fn(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One pipeline stage: the layer block owned by this rank."""
    return torch.tanh(x @ w)


def reference_mlp(ws: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Unpipelined oracle: every stage in turn."""
    for i in range(ws.shape[0]):
        x = _stage_fn(ws[i], x)
    return x


def pipelined_mlp(mesh, ws: torch.Tensor, x: torch.Tensor,
                  n_micro: int) -> torch.Tensor:
    """GPipe over `mesh`'s "pipe" dim. ws (n_stages, d, d): stage i uses
    ws[i]; x (batch, d), split into `n_micro` microbatches; every rank
    passes the same ws and x and gets the whole result."""
    dim = list(mesh.mesh_dim_names).index("pipe")
    n_stages = mesh.size(dim)
    group = mesh.get_group("pipe")
    stage = mesh.get_local_rank("pipe")
    peer = [dist.get_global_rank(group, i) for i in range(n_stages)]
    batch, d = x.shape
    if batch % n_micro:
        raise ValueError(f"batch {batch} is not a multiple of {n_micro}")
    micro = batch // n_micro
    xs = x.reshape(n_micro, micro, d)
    w = ws[stage]
    buf = torch.zeros((micro, d), dtype=x.dtype, device=x.device)
    outs = torch.zeros((n_micro, micro, d), dtype=x.dtype, device=x.device)
    for t in range(n_micro + n_stages - 1):
        y = _stage_fn(w, xs[t if t < n_micro else 0] if stage == 0 else buf)
        done = t - (n_stages - 1)
        if stage == n_stages - 1 and done >= 0:
            outs[done] = y
        buf = torch.empty_like(y)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y.contiguous(),
                           peer[(stage + 1) % n_stages], group),
                dist.P2POp(dist.irecv, buf,
                           peer[(stage - 1) % n_stages], group)]):
            req.wait()
    dist.broadcast(outs, src=peer[-1], group=group)
    return outs.reshape(batch, d)
