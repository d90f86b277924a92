"""Accuracy analysis of IoU Sketch (paper §IV-A, Eq. 1-5).

Implements the exact false-positive probability q_i(L), its exponential
approximation q̂_i(L), the expected-false-positive objective F(L) and F̂(L),
the per-document minimizer L_i* (Lemma 1), and the Hoeffding concentration
coefficient σ_X (Eq. 5, Table II).

Everything is vectorized over documents. Since q_i depends on the document
only through |W_i| (its distinct-word count) and c_i, we aggregate documents
with equal (|W_i|, c_i) — under the default uniform query-word prior c_i is
itself a function of |W_i|, so F(L) costs O(#distinct doc sizes) per
evaluation instead of O(n).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CorpusProfile:
    """Output of the Builder's single profiling pass (paper §IV-B).

    doc_sizes: (n,) int — |W_i|, number of DISTINCT words per document.
    n_terms:   |W|, number of distinct words in the corpus.
    n_words:   total word count across documents (Table II `#words`).
    ci:        (n,) float — c_i = sum_{w not in W_i} p_w. Under the default
               uniform prior p_w = 1/|W| this is 1 - |W_i|/|W|.
    """

    doc_sizes: np.ndarray
    n_terms: int
    n_words: int
    ci: np.ndarray

    @property
    def n_docs(self) -> int:
        return len(self.doc_sizes)

    @classmethod
    def from_doc_sizes(cls, doc_sizes: np.ndarray, n_terms: int,
                       n_words: int | None = None,
                       ci: np.ndarray | None = None) -> "CorpusProfile":
        doc_sizes = np.asarray(doc_sizes, dtype=np.int64)
        if ci is None:  # uniform query-word prior (paper default, §IV-B)
            ci = 1.0 - doc_sizes / float(n_terms)
        return cls(doc_sizes=doc_sizes, n_terms=int(n_terms),
                   n_words=int(n_words if n_words is not None
                               else doc_sizes.sum()), ci=np.asarray(ci))


def q_exact(doc_sizes: np.ndarray, L: float, B: int) -> np.ndarray:
    """Eq. 1 exact: q_i(L) = [1 - (1 - 1/(B/L))^{|W_i|}]^L.

    Valid for integer L with B/L >= 1 bins per layer.
    """
    m = max(float(B) / float(L), 1.0)               # bins per layer
    inner = 1.0 - np.power(1.0 - 1.0 / m, doc_sizes)
    return np.power(inner, float(L))


def q_approx(doc_sizes: np.ndarray, L: float, B: int) -> np.ndarray:
    """Eq. 1 approximation: q̂_i(L) = [1 - e^{-|W_i| L / B}]^L.

    Defined for continuous L — this is what the optimizer's region analysis
    (Lemmas 1-3) reasons about.
    """
    z = 1.0 - np.exp(-doc_sizes * float(L) / float(B))
    return np.power(z, float(L))


def F_exact(profile: CorpusProfile, L: int, B: int) -> float:
    """Eq. 2: expected number of false positives per query (count/query)."""
    return float(np.dot(profile.ci, q_exact(profile.doc_sizes, L, B)))


def F_approx(profile: CorpusProfile, L: float, B: int) -> float:
    return float(np.dot(profile.ci, q_approx(profile.doc_sizes, L, B)))


def L_star_per_doc(doc_sizes: np.ndarray, B: int) -> np.ndarray:
    """Lemma 1: the per-document minimizer L_i* = (B / |W_i|) ln 2."""
    return (float(B) / np.asarray(doc_sizes, dtype=np.float64)) * np.log(2.0)


def feasibility_lower_bound(profile: CorpusProfile, B: int) -> float:
    """Lemma 1's remark: F(L) > sum_i c_i 2^{-L_i*} for all L.

    The cheap feasibility check at the top of Algorithm 1: if this bound
    already exceeds F0, no L can satisfy the constraint.
    """
    li = L_star_per_doc(profile.doc_sizes, B)
    return float(np.dot(profile.ci, np.power(2.0, -li)))


def fast_region_bound(profile: CorpusProfile, B: int) -> tuple[float, float]:
    """Lemmas 2-3 region endpoints: (L_min, L_max) = (min_i, max_i) L_i*.

    F̂ is strictly decreasing on [1, L_min] and strictly increasing beyond
    L_max; between them it may have multiple local minima.
    """
    li = L_star_per_doc(profile.doc_sizes, B)
    return float(li.min()), float(li.max())


def sigma_x(profile: CorpusProfile, pw: np.ndarray | None = None) -> float:
    """Eq. 5 coefficient: σ_X² = Σ_i Σ_{w∉W_i} p_w².

    Under the uniform prior p_w = 1/|W| this collapses to
    Σ_i (|W| - |W_i|) / |W|² — the numbers in Table II.
    With an explicit prior we use the same uniform-mass approximation over
    the complement (exact per-document word sets are not retained after
    profiling; the builder only keeps |W_i|).
    """
    W = float(profile.n_terms)
    if pw is None:
        return float(np.sqrt(np.sum((W - profile.doc_sizes) / (W * W))))
    pw2_total = float(np.sum(np.asarray(pw) ** 2))
    frac_missing = (W - profile.doc_sizes) / W
    return float(np.sqrt(np.sum(frac_missing * pw2_total)))


def hoeffding_epsilon(profile: CorpusProfile, delta: float) -> float:
    """Eq. 5 deviation bound: with prob >= 1-δ the observed FP count is
    within ε = sqrt(σ_X² ln(1/δ) / 2) of F(L)."""
    s2 = sigma_x(profile) ** 2
    return float(np.sqrt(0.5 * s2 * np.log(1.0 / delta)))
