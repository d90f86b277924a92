"""Top-K query sampling (paper §IV-D, Eq. 6).

Instead of fetching every candidate document, sample R_K of the R candidate
postings such that, with probability >= 1-δ, at least K of them are truly
relevant. Each candidate is relevant with probability p = 1 - F0/R (the
sketch's accuracy guarantee says only F0 candidates are false positives in
expectation); Hoeffding over the sample plus a quadratic inequality yields
Eq. 6. The paper's default (K=10, F0=1, δ=1e-6) selects ~23 samples.
"""

from __future__ import annotations

import math


def sample_size(R: int, K: int, F0: float, delta: float = 1e-6) -> int:
    """Eq. 6: number of candidate postings to fetch for a top-K query.

    Returns R (fetch everything) when K >= R - F0 — there aren't enough
    candidates to be choosy.
    """
    if R <= 0:
        return 0
    if K >= R - F0:
        return R
    p = 1.0 - F0 / R
    if p <= 0.0:
        return R
    ln_term = 0.5 * math.log(1.0 / delta)
    a = 2.0 * p * K + ln_term
    disc = a * a - 4.0 * p * p * K * K
    # disc = ln_term² + 4 p K ln_term >= 0 always
    rk = (a + math.sqrt(max(disc, 0.0))) / (2.0 * p * p)
    return min(int(math.ceil(rk)), R)
