"""Airphant Builder (paper §III-C): profile → optimize → compact → persist.

One pass over the corpus collects the statistics Algorithm 1 needs
(per-document distinct-word counts, document frequencies, totals); the
structure optimizer picks L; superposts are compacted into block blobs and
the header (MHT seeds + bin pointers + common-word table + string table)
into a single header blob. After `build`, a Searcher can boot anywhere with
one header read.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

import numpy as np

from ..core.analysis import CorpusProfile, F_exact
from ..core.hashing import HashFamily, fingerprints, word_fingerprint
from ..core.optimizer import minimize_layers
from ..core.sketch import SketchSpec
from ..data.corpus import Corpus
from ..data.tokenizer import distinct_words
from ..storage.blobstore import BlobStore
from . import codec


NGRAM_PREFIX = "\x00ng:"          # reserved namespace for n-gram terms


@dataclass(frozen=True)
class BuilderConfig:
    """User-facing knobs (paper §III-C0b `Configuring Builder`)."""

    B: int = 100_000              # total bin budget (MHT memory limit proxy)
    F0: float = 1.0               # accuracy: expected false positives/query
    L: int | None = None          # manual override — skips optimization
    common_frac: float = 0.01     # fraction of B reserved for common words
    hedge_layers: int = 0         # build L+ = L + hedge_layers for §IV-G
    seed: int = 0
    block_bytes: int = 8 << 20    # superpost block target size
    query_word_dist: str = "uniform"   # p_w prior (paper default §IV-B)
    index_ngrams: int = 0         # also index character n-grams (§IV-F:
    #   RegEx engines use the inverted index as a prefilter; n=3 typical)


@dataclass
class BuildReport:
    n_docs: int = 0
    n_terms: int = 0
    n_words: int = 0
    L: int = 0
    L_total: int = 0              # L + hedge layers actually built
    expected_fp: float = 0.0
    n_common: int = 0
    index_bytes: int = 0
    header_bytes: int = 0
    postings_stored: int = 0
    optimizer_region: str = "manual"
    sigma_x: float = 0.0
    common_words: list[str] = field(default_factory=list)


class Builder:
    def __init__(self, config: BuilderConfig | None = None) -> None:
        self.config = config or BuilderConfig()

    # ---------------------------------------------------------------- profile
    def profile(self, corpus: Corpus) -> tuple[CorpusProfile, dict[str, np.ndarray]]:
        """Single profiling pass (§IV-B): statistics + in-memory postings.

        Returns the CorpusProfile and word -> sorted array of doc indices.
        """
        doc_sizes = np.zeros(corpus.n_docs, dtype=np.int64)
        word_docs: dict[str, list[int]] = {}
        n_words = 0
        for i, (_ref, text) in enumerate(corpus):
            words = distinct_words(text)
            n_words += len(text.split())
            doc_sizes[i] = len(words)
            for w in words:
                word_docs.setdefault(w, []).append(i)
        postings = {w: np.asarray(d, dtype=np.uint32)
                    for w, d in word_docs.items()}
        if self.config.index_ngrams:
            n = self.config.index_ngrams
            gram_docs: dict[str, set[int]] = {}
            doc_grams: dict[int, set[str]] = {}
            for w, docs in word_docs.items():
                grams = {w[i:i + n] for i in range(len(w) - n + 1)}
                for g in grams:
                    gram_docs.setdefault(g, set()).update(docs)
                for d in docs:
                    doc_grams.setdefault(d, set()).update(grams)
            for g, docs in gram_docs.items():
                postings[NGRAM_PREFIX + g] = np.asarray(
                    sorted(docs), dtype=np.uint32)
            # the accuracy model's |W_i| must count every inserted term
            for d, grams in doc_grams.items():
                doc_sizes[d] += len(grams)
        if self.config.query_word_dist == "df":
            # p_w ∝ document frequency (paper §IV-B alternative (a))
            df = np.array([len(postings[w]) for w in postings], dtype=np.float64)
            pw = df / df.sum()
            order = {w: k for k, w in enumerate(postings)}
            n_terms = len(postings)
            ci = np.ones(corpus.n_docs)
            for w, docs in postings.items():
                ci[docs] -= pw[order[w]]
            profile = CorpusProfile(doc_sizes=doc_sizes, n_terms=n_terms,
                                    n_words=n_words, ci=ci)
        else:
            profile = CorpusProfile.from_doc_sizes(
                doc_sizes, n_terms=len(postings), n_words=n_words)
        return profile, postings

    # ------------------------------------------------------------------ build
    def build(self, corpus: Corpus, store: BlobStore, prefix: str) -> BuildReport:
        cfg = self.config
        profile, postings = self.profile(corpus)
        report = BuildReport(n_docs=profile.n_docs, n_terms=profile.n_terms,
                             n_words=profile.n_words)

        # --- common words (§IV-E): top df words get exact postings lists
        n_common = int(cfg.common_frac * cfg.B)
        df = Counter({w: len(d) for w, d in postings.items()})
        common_words = [w for w, _c in df.most_common(n_common)] \
            if n_common else []
        report.n_common = len(common_words)
        report.common_words = common_words[:64]   # sample for inspection

        # --- structure optimization (Algorithm 1) on the hashed-bin budget
        B_hashed = cfg.B - len(common_words)
        if cfg.L is not None:
            L = int(cfg.L)
            report.optimizer_region = "manual"
            report.expected_fp = F_exact(profile, L, B_hashed)
        else:
            choice = minimize_layers(profile, B_hashed, cfg.F0)
            L = choice.L
            report.optimizer_region = choice.region
            report.expected_fp = choice.expected_fp
        report.L = L
        L_total = L + max(0, int(cfg.hedge_layers))
        report.L_total = L_total

        from ..core.analysis import sigma_x
        report.sigma_x = sigma_x(profile)

        # --- map doc index -> posting key/length via the string table
        blob_names = sorted({r.blob for r in corpus.refs})
        blob_key = {n: k for k, n in enumerate(blob_names)}
        doc_keys = codec.posting_key(
            np.array([blob_key[r.blob] for r in corpus.refs]),
            np.array([r.offset for r in corpus.refs]))
        doc_lens = np.array([r.length for r in corpus.refs], dtype=np.uint64)

        # --- build the L_total-layer structure and write superpost blocks
        spec = SketchSpec(B=cfg.B, L=L_total,
                          n_common=len(common_words), seed=cfg.seed)
        hashes = spec.hash_family()
        common_set = set(common_words)
        hashed_words = [w for w in postings if w not in common_set]

        writer = _BlockWriter(store, prefix, cfg.block_bytes)
        pointers: list[codec.BinPointer] = []
        n_postings_stored = 0
        if hashed_words:
            bins = hashes.bins(fingerprints(hashed_words))   # (L_total, n)
            for l in range(L_total):
                # group words by bin, then union doc sets per bin
                order = np.argsort(bins[l], kind="stable")
                sorted_bins = bins[l][order]
                boundaries = np.flatnonzero(np.diff(sorted_bins)) + 1
                # positions into `order`, grouped by equal bin id
                group_bin = {
                    int(sorted_bins[pos[0]]): order[pos]
                    for pos in np.split(np.arange(len(order)), boundaries)
                    if len(pos)}
                for b in range(spec.bins_per_layer):
                    g = group_bin.get(b)
                    if g is None:
                        docs = np.empty(0, dtype=np.uint32)
                    else:
                        docs = np.unique(np.concatenate(
                            [postings[hashed_words[int(j)]] for j in g]))
                    keys = doc_keys[docs]
                    ksort = np.argsort(keys)
                    blob = codec.encode_superpost(keys[ksort],
                                                  doc_lens[docs][ksort])
                    pointers.append(writer.append(blob))
                    n_postings_stored += len(docs)
        else:
            pointers = [writer.append(codec.encode_superpost(
                np.empty(0, np.uint64), np.empty(0, np.uint64)))
                for _ in range(L_total * spec.bins_per_layer)]

        # --- common-word postings use the same compaction (§IV-E)
        common_fps: list[int] = []
        common_ptr: list[codec.BinPointer] = []
        for w in common_words:
            docs = postings[w]
            keys = doc_keys[docs]
            ksort = np.argsort(keys)
            blob = codec.encode_superpost(keys[ksort], doc_lens[docs][ksort])
            common_fps.append(word_fingerprint(w))
            common_ptr.append(writer.append(blob))
            n_postings_stored += len(docs)
        writer.flush()
        report.postings_stored = n_postings_stored

        # --- header block: everything the Searcher needs, in one read
        header = {
            "spec": {"B": spec.B, "L": L, "L_total": L_total,
                     "n_common": spec.n_common, "seed": spec.seed,
                     "bins_per_layer": spec.bins_per_layer},
            "hashes": hashes.to_dict(),
            "string_table": blob_names,
            "blocks": writer.block_names,
            "bin_pointers": codec.pack_pointers(pointers),
            "common_fps": common_fps,
            "common_pointers": codec.pack_pointers(common_ptr),
            "profile": {
                "n_docs": profile.n_docs, "n_terms": profile.n_terms,
                "n_words": profile.n_words,
                "doc_size_hist": np.bincount(profile.doc_sizes).tolist(),
                "expected_fp": report.expected_fp, "F0": cfg.F0,
                "sigma_x": report.sigma_x,
                # readers use this to reject gramful regex queries against
                # an index with no n-gram postings (planner.py) instead of
                # silently returning zero candidates
                "index_ngrams": int(cfg.index_ngrams),
            },
        }
        hdr = codec.encode_header(header)
        store.put(f"{prefix}/header.airp", hdr)
        report.header_bytes = len(hdr)
        report.index_bytes = len(hdr) + writer.bytes_written
        return report


class _BlockWriter:
    """Concatenates superposts into ~block_bytes blobs (§IV-C compaction)."""

    def __init__(self, store: BlobStore, prefix: str, block_bytes: int) -> None:
        self.store = store
        self.prefix = prefix
        self.block_bytes = block_bytes
        self.buf = bytearray()
        self.block_names: list[str] = []
        self.bytes_written = 0

    def append(self, data: bytes) -> codec.BinPointer:
        ptr = codec.BinPointer(block=len(self.block_names),
                               offset=len(self.buf), length=len(data))
        self.buf.extend(data)
        if len(self.buf) >= self.block_bytes:
            self.flush()
        return ptr

    def flush(self) -> None:
        if not self.buf and self.block_names:
            return
        name = f"{self.prefix}/superposts-{len(self.block_names):05d}.blk"
        self.store.put(name, bytes(self.buf))
        self.block_names.append(name)
        self.bytes_written += len(self.buf)
        self.buf = bytearray()
