"""The model kernels' cost hook.

While a counter (`launch.hlo_cost.analyze_step`) is active it sits in
`ACTIVE`, and each model kernel's wrapper records its call there: one
launch under the kernel's name with the flops and bytes of its formula
(`launch.roofline.*_cost`), on any device, so a card run and a meta run
of one step count the same. On meta tensors the wrapper then only makes
its outputs: nothing runs, neither the kernel nor its plain version.
With no counter active the hook costs the wrapper one check of `ACTIVE`.
"""

from __future__ import annotations

from typing import Callable

ACTIVE: list = []      # the active counters, innermost last


def record(name: str, cost: tuple, probe, shaped: Callable,
           run: Callable):
    """Record one launch of `name` with `cost` (flops, bytes) in the
    innermost counter, then return `shaped()` (the outputs, made without
    running anything) if `probe` is a meta tensor, else `run()` (the
    kernel), with the counter paused: the kernel's own allocations and
    checks are not counted again."""
    counter = ACTIVE[-1]
    counter.add_kernel(name, *cost)
    with counter.paused():
        return shaped() if probe.is_meta else run()


def counts_meta(dev) -> bool:
    """Do meta tensors on `dev` go to the kernels' wrappers (a counter is
    active) rather than to the plain versions?"""
    return dev.type == "meta" and bool(ACTIVE)
