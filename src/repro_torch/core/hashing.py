"""Pairwise-independent hash family for IoU Sketch (paper §IV-A).

The accuracy analysis (Eq. 1-2) requires the per-layer hash functions to be
drawn from a pairwise-independent family, so that whether a word collides
with a document's words is independent of the queried word. We use the
classic Carter-Wegman construction h(x) = ((a*x + b) mod p) mod m over the
Mersenne prime p = 2^31 - 1, applied to a stable 64-bit fingerprint of the
word (FNV-1a). Everything is vectorized numpy: the builder hashes millions
of words in bulk, and the searcher hashes a handful per query.

Only the seeds (a_l, b_l) persist in the index header — the paper's point
that the MHT `concisely represents IoU Sketch mapping` via hash seeds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MERSENNE_P = np.uint64((1 << 31) - 1)
_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


def word_fingerprint(word: str) -> int:
    """Stable 64-bit FNV-1a fingerprint of a word (python-int output)."""
    h = int(_FNV_OFFSET)
    for byte in word.encode("utf-8"):
        h ^= byte
        h = (h * int(_FNV_PRIME)) & 0xFFFFFFFFFFFFFFFF
    return h


def fingerprints(words: list[str]) -> np.ndarray:
    return np.array([word_fingerprint(w) for w in words], dtype=np.uint64)


@dataclass(frozen=True)
class HashFamily:
    """L independent Carter-Wegman hash functions h_l: u64 -> [0, m_l).

    `a`, `b` are (L,) uint64 seed arrays with 1 <= a < p, 0 <= b < p.
    `n_bins` is the per-layer bin count m_l (B // L in the paper's notation).
    """

    a: np.ndarray
    b: np.ndarray
    n_bins: int

    @property
    def n_layers(self) -> int:
        return len(self.a)

    @classmethod
    def make(cls, n_layers: int, n_bins: int, seed: int) -> "HashFamily":
        rng = np.random.default_rng(seed)
        p = int(MERSENNE_P)
        a = rng.integers(1, p, size=n_layers, dtype=np.uint64)
        b = rng.integers(0, p, size=n_layers, dtype=np.uint64)
        return cls(a=a, b=b, n_bins=int(n_bins))

    def bins(self, keys: np.ndarray) -> np.ndarray:
        """Map word fingerprints (n,) u64 -> bin ids (L, n) int64.

        Products fit in uint64: keys are first reduced mod p < 2^31 and
        a < 2^31, so a*x < 2^62.
        """
        keys = np.asarray(keys, dtype=np.uint64) % MERSENNE_P
        ax = self.a[:, None] * keys[None, :]          # (L, n) < 2^62
        h = (ax + self.b[:, None]) % MERSENNE_P
        return (h % np.uint64(self.n_bins)).astype(np.int64)

    def bins_for_word(self, word: str) -> np.ndarray:
        """Bin id per layer (L,) for one word — the query-time path."""
        return self.bins(np.array([word_fingerprint(word)], dtype=np.uint64))[:, 0]

    def to_dict(self) -> dict:
        return {"a": self.a.tolist(), "b": self.b.tolist(),
                "n_bins": int(self.n_bins)}

    @classmethod
    def from_dict(cls, d: dict) -> "HashFamily":
        return cls(a=np.array(d["a"], dtype=np.uint64),
                   b=np.array(d["b"], dtype=np.uint64),
                   n_bins=int(d["n_bins"]))
