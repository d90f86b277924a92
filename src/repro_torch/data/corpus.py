"""Corpus generation and storage layout (paper §V-A datasets).

Reproduces the paper's synthetic corpus families with the same
(log10 n_docs, log10 n_words, log10 words_per_doc) parameterization:

  * diag(x, y, 0) — document i contains exactly the single word w_i;
  * unif(x, y, z) — each word uniform over an n_w-word dictionary;
  * zipf(x, y, z) — Zipfian with exponent 1.07 (the paper's value);

plus generators shaped like the real datasets: `cranfield` (short abstracts,
small vocabulary) and `logs` (templated system-log lines à la HDFS/Windows/
Spark from Loghub, which is where keyword search over cloud blobs shines).

Documents are persisted newline-delimited into a configurable number of
blobs; a Corpus exposes (doc_ref, text) pairs where doc_ref is the paper's
(blob, offset, length) triple, so the searcher can range-read any document
straight out of cloud storage.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..storage.blobstore import BlobStore, RangeRequest


@dataclass(frozen=True)
class DocRef:
    blob: str
    offset: int
    length: int


@dataclass
class Corpus:
    """Documents laid out in blobs, iterable without loading everything."""

    store: BlobStore
    refs: list[DocRef]
    texts: list[str] | None = None   # kept in memory for small corpora

    @property
    def n_docs(self) -> int:
        return len(self.refs)

    def text(self, i: int) -> str:
        if self.texts is not None:
            return self.texts[i]
        ref = self.refs[i]
        data = self.store.get_range(
            RangeRequest(ref.blob, ref.offset, ref.length))
        return data.decode("utf-8")

    def __iter__(self):
        for i in range(self.n_docs):
            yield self.refs[i], self.text(i)


def write_corpus(store: BlobStore, prefix: str, docs: list[str],
                 n_blobs: int = 4, keep_texts: bool = True) -> Corpus:
    """Persist documents newline-delimited across `n_blobs` blobs."""
    n_blobs = max(1, min(n_blobs, len(docs) or 1))
    refs: list[DocRef] = [None] * len(docs)  # type: ignore[list-item]
    per_blob = (len(docs) + n_blobs - 1) // n_blobs
    for b in range(n_blobs):
        lo, hi = b * per_blob, min((b + 1) * per_blob, len(docs))
        if lo >= hi:
            break
        name = f"{prefix}/docs-{b:05d}.txt"
        parts = []
        offset = 0
        for i in range(lo, hi):
            data = docs[i].encode("utf-8")
            refs[i] = DocRef(name, offset, len(data))
            parts.append(data)
            parts.append(b"\n")
            offset += len(data) + 1
        store.put(name, b"".join(parts))
    return Corpus(store=store, refs=refs, texts=docs if keep_texts else None)


# ------------------------------------------------------------------ synthetic
def _word(j: int) -> str:
    return f"w{j}"


def make_diag(n_docs: int, seed: int = 0) -> list[str]:
    """diag(x, x, 0): doc i contains exactly word w_i."""
    del seed
    return [_word(i) for i in range(n_docs)]


def make_unif(n_docs: int, n_words: int, words_per_doc: int,
              seed: int = 0) -> list[str]:
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_words, size=(n_docs, words_per_doc))
    return [" ".join(_word(int(j)) for j in row) for row in ids]


def make_zipf(n_docs: int, n_words: int, words_per_doc: int,
              seed: int = 0, exponent: float = 1.07) -> list[str]:
    """zipf(x, y, z): P(w_j) ∝ 1/j^1.07 (paper §V-A)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_words + 1, dtype=np.float64)
    p = ranks ** -exponent
    p /= p.sum()
    ids = rng.choice(n_words, size=(n_docs, words_per_doc), p=p)
    return [" ".join(_word(int(j)) for j in row) for row in ids]


_CRANFIELD_STEMS = [
    "boundary", "layer", "flow", "supersonic", "wing", "pressure", "heat",
    "transfer", "mach", "shock", "wave", "lift", "drag", "velocity",
    "turbulent", "laminar", "aerofoil", "compressible", "jet", "nozzle",
    "reynolds", "gradient", "cylinder", "plate", "cone", "hypersonic",
    "viscous", "inviscid", "stagnation", "equilibrium",
]


def make_cranfield_like(n_docs: int = 1398, vocab: int = 5300,
                        seed: int = 0) -> list[str]:
    """Aerodynamics-abstract-shaped corpus: n≈1.4e3 docs, |W|≈5.3e3,
    ~86 words/doc (Table II Cranfield row)."""
    rng = np.random.default_rng(seed)
    # Zipf-ish vocabulary built from domain stems + numeric suffixes
    words = [f"{_CRANFIELD_STEMS[j % len(_CRANFIELD_STEMS)]}{j}"
             for j in range(vocab)]
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -0.9
    p /= p.sum()
    docs = []
    for _ in range(n_docs):
        length = int(rng.integers(40, 130))
        ids = rng.choice(vocab, size=length, p=p)
        docs.append(" ".join(words[int(j)] for j in ids))
    return docs


_LOG_TEMPLATES = [
    "INFO dfs.DataNode$PacketResponder PacketResponder {0} for block blk_{1} terminating",
    "INFO dfs.FSNamesystem BLOCK* NameSystem.addStoredBlock blockMap updated {2}:{3} is added to blk_{1} size {4}",
    "WARN dfs.DataNode$DataXceiver writeBlock blk_{1} received exception java.io.IOException connection reset node{0}",
    "ERROR executor.Executor task {0} in stage {5} failed fetch from node{2} shuffle_{1}",
    "INFO scheduler.TaskSetManager starting task {0} in stage {5} executor node{2} partition {4}",
    "INFO storage.BlockManager block rdd_{1}_{4} stored as values in memory on node{2} port {3}",
    "WARN kernel.Power service pack install failed code 0x{1} on host node{0} retry {4}",
]


def make_logs_like(n_docs: int, n_nodes: int = 200, n_blocks: int | None = None,
                   seed: int = 0) -> list[str]:
    """System-log corpus (HDFS/Spark/Windows-shaped): templated lines with
    high-cardinality ids — many rare terms plus a heavy common-word head,
    exactly the regime where §IV-E common-word bins matter."""
    rng = np.random.default_rng(seed)
    n_blocks = n_blocks or max(n_docs // 2, 16)
    docs = []
    for _ in range(n_docs):
        t = _LOG_TEMPLATES[int(rng.integers(0, len(_LOG_TEMPLATES)))]
        docs.append(t.format(
            int(rng.integers(0, n_nodes)),            # {0} task/node id
            int(rng.integers(0, n_blocks)),            # {1} block id
            int(rng.integers(0, n_nodes)),             # {2} node
            int(rng.integers(1024, 65536)),            # {3} port
            int(rng.integers(0, 1 << 20)),             # {4} size/partition
            int(rng.integers(0, 512)),                 # {5} stage
        ))
    return docs


FAMILIES = {
    "diag": lambda n, seed=0: make_diag(n, seed),
    "unif": lambda n, seed=0: make_unif(n, n, 10, seed),
    "zipf": lambda n, seed=0: make_zipf(n, max(n // 2, 8), 10, seed),
    "cranfield": lambda n, seed=0: make_cranfield_like(n, seed=seed),
    "logs": lambda n, seed=0: make_logs_like(n, seed=seed),
}
