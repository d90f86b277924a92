"""IoU Sketch — the paper's core data structure (§II-C, §IV-A).

An L-layer hash table. `insert(word, postings)` unions the word's postings
list into one bin per layer; `query(word)` intersects the L superposts.
Guarantees: no false negatives ever; expected false positives F(L) per
query, tunable via (B, L) by `optimizer.minimize_layers`.

This module is the in-memory reference implementation used by unit tests,
the builder (which then compacts it onto cloud storage via `index.codec`),
and the bitmap kernels' callers. Postings are sorted unique uint32 document
ids; the mapping doc-id -> (blob, offset, length) lives in `index.layout`.

The 1%-of-bins common-word side table (§IV-E) is part of the sketch: the
most document-frequent words bypass hashing entirely and keep their exact
postings lists, because unioning a huge postings list into bins would
poison every word sharing those bins.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .hashing import HashFamily, fingerprints, word_fingerprint


def intersect_sorted(lists: list[np.ndarray]) -> np.ndarray:
    """Intersection of sorted unique integer arrays, smallest-first.

    k-way merge by binary search: the running result (never larger than
    the smallest list) is probed into each remaining list with
    `np.searchsorted`, O(n log m) per round with no temporaries — unlike
    `np.isin`, which concatenates and re-sorts both operands each time.
    """
    if not lists:
        return np.empty(0, dtype=np.uint32)
    lists = sorted(lists, key=len)
    out = lists[0]
    for other in lists[1:]:
        if len(out) == 0:
            break
        idx = np.searchsorted(other, out)
        # idx == len(other) means out[i] > other[-1]: clamp — the clamped
        # element compares unequal, so membership stays correct
        np.minimum(idx, len(other) - 1, out=idx)
        out = out[other[idx] == out]
    return out


def union_sorted(lists: list[np.ndarray]) -> np.ndarray:
    if not lists:
        return np.empty(0, dtype=np.uint32)
    return np.unique(np.concatenate(lists))


@dataclass
class SketchSpec:
    """Raw structure parameters (paper §IV-A `raw parameters`)."""

    B: int                      # total bin budget across all layers
    L: int                      # number of layers
    n_common: int = 0           # bins reserved for exact common-word lists
    seed: int = 0

    @property
    def bins_per_layer(self) -> int:
        usable = self.B - self.n_common
        return max(1, usable // self.L)

    def hash_family(self) -> HashFamily:
        return HashFamily.make(self.L, self.bins_per_layer, self.seed)


@dataclass
class IoUSketch:
    """In-memory IoU Sketch: (L, bins_per_layer) grid of superposts."""

    spec: SketchSpec
    hashes: HashFamily
    # superposts[l][b] -> sorted unique uint32 doc ids
    superposts: list[list[np.ndarray]]
    # exact postings for the n_common most frequent words (fingerprint-keyed)
    common: dict[int, np.ndarray] = field(default_factory=dict)

    # ------------------------------------------------------------------ build
    @classmethod
    def build(cls, postings: dict[str, np.ndarray], spec: SketchSpec,
              common_words: list[str] | None = None) -> "IoUSketch":
        """Bulk insert: one pass grouping postings by (layer, bin).

        `common_words` (paper §IV-E) are stored exactly and NOT inserted
        into the hashed layers.
        """
        hashes = spec.hash_family()
        common_set = set(common_words or [])
        common = {word_fingerprint(w): np.asarray(postings[w], dtype=np.uint32)
                  for w in common_set if w in postings}

        words = [w for w in postings if w not in common_set]
        superposts: list[list[np.ndarray]] = [
            [np.empty(0, dtype=np.uint32) for _ in range(spec.bins_per_layer)]
            for _ in range(spec.L)]
        if words:
            # Bulk union: flatten every posting once, then per layer group
            # doc ids by bin with one lexsort and dedupe adjacent runs —
            # no per-word Python loop over L × n_words cells.
            bins = hashes.bins(fingerprints(words))      # (L, n_words)
            plists = [np.asarray(postings[w], dtype=np.uint32) for w in words]
            lengths = np.array([len(p) for p in plists], dtype=np.int64)
            all_docs = np.concatenate(plists) if plists else \
                np.empty(0, dtype=np.uint32)
            word_ids = np.repeat(np.arange(len(words)), lengths)
            for l in range(spec.L):
                bin_ids = bins[l][word_ids]
                order = np.lexsort((all_docs, bin_ids))
                b_s, d_s = bin_ids[order], all_docs[order]
                keep = np.ones(len(d_s), dtype=bool)
                keep[1:] = (b_s[1:] != b_s[:-1]) | (d_s[1:] != d_s[:-1])
                b_u, d_u = b_s[keep], d_s[keep]
                if not len(b_u):
                    continue
                cuts = np.flatnonzero(b_u[1:] != b_u[:-1]) + 1
                group_bins = b_u[np.concatenate(([0], cuts))]
                for bin_id, chunk in zip(group_bins, np.split(d_u, cuts)):
                    superposts[l][int(bin_id)] = chunk
        return cls(spec=spec, hashes=hashes, superposts=superposts,
                   common=common)

    # ------------------------------------------------------------------ query
    def bins_for(self, word: str) -> np.ndarray:
        return self.hashes.bins_for_word(word)

    def is_common(self, word: str) -> bool:
        return word_fingerprint(word) in self.common

    def layer_superposts(self, word: str) -> list[np.ndarray]:
        """The L superposts a query for `word` would fetch (pre-intersection)."""
        bins = self.bins_for(word)
        return [self.superposts[l][int(bins[l])] for l in range(self.spec.L)]

    def query(self, word: str, wait_for: int | None = None,
              impl: str = "sorted", n_docs: int | None = None,
              device="cuda") -> np.ndarray:
        """Candidate postings: exact for common words, else ∩ of superposts.

        `wait_for=k < L` models §IV-G hedging: intersect only the first k
        superposts (still a superset — correctness is preserved, accuracy
        degrades gracefully).

        `impl="bitmap"` combines through `intersect_keys` on `device`
        (`kernels/intersect`): the superposts' doc ids are their own
        ranks in a universe of `n_docs`, and the kernels set their bits,
        AND the L layers and read back the matching ids on the card.
        """
        fp = word_fingerprint(word)
        if fp in self.common:
            return self.common[fp]
        posts = self.layer_superposts(word)
        if wait_for is not None:
            posts = posts[:max(1, min(wait_for, len(posts)))]
        if impl == "bitmap":
            from ..kernels.intersect import intersect_keys
            if n_docs is None:
                n_docs = 1 + max((int(p[-1]) for p in posts if len(p)),
                                 default=0)
            keys, _count = intersect_keys([posts], n_docs=n_docs,
                                          device=device)
            return keys.cpu().numpy().astype(np.uint32)
        return intersect_sorted(posts)

    # ----------------------------------------------------------------- sizing
    def storage_postings(self) -> int:
        """Total postings stored (drives the Fig. 16d storage-usage curve)."""
        hashed = sum(len(c) for layer in self.superposts for c in layer)
        return hashed + sum(len(v) for v in self.common.values())

    def mht_size_entries(self) -> int:
        """In-memory MHT footprint: O(B) bin pointers + O(L) seeds."""
        return self.spec.L * self.spec.bins_per_layer + 2 * self.spec.L
