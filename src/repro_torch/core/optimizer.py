"""Algorithm 1: Number-of-Layers Minimization (paper §IV-A).

Given a bin budget B and an accuracy constraint F0 (expected false positives
per query), find the smallest integer L such that F(L; B) <= F0 — or reject
if infeasible. Fewer layers means fewer parallel fetches per query and less
posting replication, so smaller is strictly better once the constraint holds.

Structure follows the paper exactly:
  1. cheap feasibility check via the Lemma 1 lower bound Σ c_i 2^{-L_i*};
  2. if F(L_min) <= F0 (L_min = min_i L_i*): F̂ is strictly decreasing on
     [1, L_min] (Lemma 2) → binary search the smallest feasible L there;
  3. otherwise iterate L upward through [L_min, L_max] (no monotonicity
     guarantee there — Lemma 3 only says F̂ increases beyond L_max);
  4. reject if the iterative search exhausts the interval.

Region endpoints come from the approximation F̂ (that is what the lemmas
govern); the constraint itself is always checked against the exact F.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .analysis import (CorpusProfile, F_exact, fast_region_bound,
                       feasibility_lower_bound)


class InfeasibleSketchError(ValueError):
    """No L in [1, B] meets the accuracy constraint — Algorithm 1 `reject`."""


@dataclass(frozen=True)
class LayerChoice:
    L: int
    expected_fp: float      # F(L*; B), the certified accuracy
    region: str             # "fast" (binary search) or "slow" (iterative)
    evaluations: int        # number of F evaluations spent


def minimize_layers(profile: CorpusProfile, B: int, F0: float,
                    L_cap: int | None = None) -> LayerChoice:
    """Algorithm 1. Raises InfeasibleSketchError on rejection."""
    if B < 1:
        raise ValueError("need at least one bin")
    L_cap = int(L_cap if L_cap is not None else B)
    evals = 0

    # Step 1 — Lemma 1 lower bound: F(L) > Σ c_i 2^{-L_i*} for every L.
    if feasibility_lower_bound(profile, B) > F0:
        raise InfeasibleSketchError(
            f"F0={F0} below the Lemma-1 lower bound for B={B}; "
            "increase B or relax F0")

    L_min_f, L_max_f = fast_region_bound(profile, B)
    L_min = max(1, min(int(math.floor(L_min_f)), L_cap))
    L_max = max(L_min, min(int(math.ceil(L_max_f)), L_cap))

    def F(L: int) -> float:
        nonlocal evals
        evals += 1
        return F_exact(profile, L, B)

    # Step 2 — fast region: F̂ strictly decreasing on [1, L_min] (Lemma 2),
    # so the smallest feasible L is found by binary search.
    if F(L_min) <= F0:
        lo, hi = 1, L_min           # invariant: F(hi) <= F0
        while lo < hi:
            mid = (lo + hi) // 2
            if F(mid) <= F0:
                hi = mid
            else:
                lo = mid + 1
        return LayerChoice(L=hi, expected_fp=F(hi), region="fast",
                           evaluations=evals)

    # Step 3 — slow region: scan [L_min, L_max] upward. F may wiggle here
    # (multiple local minima), so we take the first feasible L.
    for L in range(L_min + 1, L_max + 1):
        f = F(L)
        if f <= F0:
            return LayerChoice(L=L, expected_fp=f, region="slow",
                               evaluations=evals)

    # Step 4 — reject (Lemma 3: beyond L_max it only gets worse).
    raise InfeasibleSketchError(
        f"no L in [1, {L_max}] reaches F0={F0} with B={B}")
