"""Baseline indexes with the access patterns the paper benchmarks against.

Lucene / Elasticsearch / SQLite are JVM/C systems we cannot (and should not)
run offline; what the paper actually analyzes is their *storage access
pattern* (§V-B0c, Appendix A): hierarchical term indexes make dependent
back-to-back reads ("wait-heavy"), and the naive hash table reads enormous
superposts ("download-heavy"). We reproduce those patterns faithfully over
the same simulated cloud and the same compaction codec:

  * BTreeIndex    — SQLite-style B-tree pages, root→leaf chain of
                    sequential range reads, then postings, then documents.
  * SkipListIndex — Lucene-style skip list: expected O(log n) dependent
                    hops across term-dictionary blocks.
  * HashTable     — the paper's own definition: IoU Sketch with L=1 and
                    identical B / common-word configuration (§V-A0b);
                    build it via BuilderConfig(L=1).

All three share Airphant's document-retrieval round, so latency differences
isolate the term-index design, as in the paper.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np

from ..data.corpus import Corpus, DocRef
from ..data.tokenizer import distinct_words
from ..storage.blobstore import BlobStore, RangeRequest
from ..storage.simcloud import FetchStats, SimCloudStore
from . import _msgpack, codec
from .searcher import QueryResult, QueryStats


def _build_postings(corpus: Corpus) -> tuple[dict[str, np.ndarray], np.ndarray, np.ndarray, list[str]]:
    word_docs: dict[str, list[int]] = {}
    for i, (_ref, text) in enumerate(corpus):
        for w in distinct_words(text):
            word_docs.setdefault(w, []).append(i)
    blob_names = sorted({r.blob for r in corpus.refs})
    blob_key = {n: k for k, n in enumerate(blob_names)}
    doc_keys = codec.posting_key(
        np.array([blob_key[r.blob] for r in corpus.refs]),
        np.array([r.offset for r in corpus.refs]))
    doc_lens = np.array([r.length for r in corpus.refs], dtype=np.uint64)
    postings = {w: np.asarray(d, dtype=np.uint32)
                for w, d in word_docs.items()}
    return postings, doc_keys, doc_lens, blob_names


@dataclass
class _Node:
    keys: list[str]
    children: list[int] = field(default_factory=list)   # node ids
    # leaf payload: word -> pointer into the postings block
    values: list[codec.BinPointer] = field(default_factory=list)


class HierarchicalIndex:
    """Shared machinery for B-tree / skip-list style term indexes.

    Nodes are serialized into a single blob; lookup walks node-by-node with
    `fetch_chain` — every hop is a dependent network round trip, exactly
    the pathology of §II-B.
    """

    kind = "btree"

    def __init__(self, store: BlobStore, prefix: str, fanout: int = 64) -> None:
        self.store = store
        self.prefix = prefix
        self.fanout = fanout

    # ------------------------------------------------------------------ build
    def build(self, corpus: Corpus) -> dict:
        postings, doc_keys, doc_lens, blob_names = _build_postings(corpus)
        words = sorted(postings)

        # postings block (same compaction as Airphant)
        buf = bytearray()
        ptrs: dict[str, codec.BinPointer] = {}
        for w in words:
            docs = postings[w]
            keys = doc_keys[docs]
            order = np.argsort(keys)
            data = codec.encode_superpost(keys[order], doc_lens[docs][order])
            ptrs[w] = codec.BinPointer(0, len(buf), len(data))
            buf.extend(data)
        self.store.put(f"{self.prefix}/postings.blk", bytes(buf))

        nodes = self._build_nodes(words, ptrs)
        # serialize nodes back-to-back; node directory goes into the header
        node_blob = bytearray()
        node_spans: list[tuple[int, int]] = []
        for nd in nodes:
            data = _msgpack.packb({
                "keys": nd.keys, "children": nd.children,
                "values": [(p.block, p.offset, p.length) for p in nd.values],
            })
            node_spans.append((len(node_blob), len(data)))
            node_blob.extend(data)
        self.store.put(f"{self.prefix}/nodes.blk", bytes(node_blob))
        header = {"kind": self.kind, "n_nodes": len(nodes),
                  "node_spans": node_spans, "root": len(nodes) - 1,
                  "string_table": blob_names,
                  "height": self._height}
        self.store.put(f"{self.prefix}/header.bt",
                       _msgpack.packb(header))
        return header

    def _build_nodes(self, words: list[str], ptrs: dict[str, codec.BinPointer],
                     ) -> list[_Node]:
        """Bottom-up B-tree: leaves of `fanout` words, then index levels."""
        nodes: list[_Node] = []
        level: list[int] = []
        level_keys: list[str] = []
        for i in range(0, len(words), self.fanout):
            chunk = words[i:i + self.fanout]
            nodes.append(_Node(keys=chunk, values=[ptrs[w] for w in chunk]))
            level.append(len(nodes) - 1)
            level_keys.append(chunk[0])
        height = 1
        while len(level) > 1:
            nxt, nxt_keys = [], []
            for i in range(0, len(level), self.fanout):
                kid_ids = level[i:i + self.fanout]
                kid_keys = level_keys[i:i + self.fanout]
                nodes.append(_Node(keys=kid_keys, children=kid_ids))
                nxt.append(len(nodes) - 1)
                nxt_keys.append(kid_keys[0])
            level, level_keys = nxt, nxt_keys
            height += 1
        self._height = height
        return nodes

    # ----------------------------------------------------------------- search
    def open(self, cloud: SimCloudStore) -> "HierarchicalSearcher":
        return HierarchicalSearcher(cloud, self.prefix)


class BTreeIndex(HierarchicalIndex):
    kind = "btree"


class SkipListIndex(HierarchicalIndex):
    """Skip lists have the same dependent-read chain of expected O(log n)
    hops; with block-aligned tower nodes the simulated access pattern is
    the B-tree's with a smaller effective fanout (Lucene's term dictionary
    blocks hold ~32 entries)."""

    kind = "skiplist"

    def __init__(self, store: BlobStore, prefix: str, fanout: int = 32) -> None:
        super().__init__(store, prefix, fanout)


class HierarchicalSearcher:
    """Query side: root→leaf dependent chain, then postings, then docs."""

    def __init__(self, cloud: SimCloudStore, prefix: str) -> None:
        self.cloud = cloud
        self.prefix = prefix
        data, self.init_stats = cloud.fetch(RangeRequest(f"{prefix}/header.bt"))
        hdr = _msgpack.unpackb(data)
        self.node_spans = hdr["node_spans"]
        self.root = hdr["root"]
        self.string_table = hdr["string_table"]
        self.height = hdr["height"]

    def _fetch_node(self, node_id: int) -> tuple[dict, FetchStats]:
        off, ln = self.node_spans[node_id]
        data, stats = self.cloud.fetch(
            RangeRequest(f"{self.prefix}/nodes.blk", off, ln))
        return _msgpack.unpackb(data), stats

    def lookup(self, word: str) -> tuple[np.ndarray, np.ndarray, QueryStats]:
        """Sequential root→leaf traversal — each hop blocks on the last."""
        stats = QueryStats()
        node_id = self.root
        while True:
            node, fs = self._fetch_node(node_id)
            stats.lookup.add(fs)
            stats.rounds += 1
            if node["children"]:
                i = bisect.bisect_right(node["keys"], word) - 1
                node_id = node["children"][max(i, 0)]
                continue
            try:
                j = node["keys"].index(word)
            except ValueError:
                return (np.empty(0, np.uint64), np.empty(0, np.uint64), stats)
            blk, off, ln = node["values"][j]
            del blk
            data, fs = self.cloud.fetch(
                RangeRequest(f"{self.prefix}/postings.blk", off, ln))
            stats.lookup.add(fs)
            stats.rounds += 1
            keys, lens = codec.decode_superpost(data)
            return keys, lens, stats

    def query(self, word: str, top_k: int | None = None) -> QueryResult:
        keys, lens, stats = self.lookup(word)
        stats.n_candidates = len(keys)
        if top_k is not None:
            keys, lens = keys[:top_k], lens[:top_k]
        blob_keys, offsets = codec.split_posting_key(keys)
        refs = [DocRef(self.string_table[int(b)], int(o), int(n))
                for b, o, n in zip(blob_keys, offsets, lens)]
        if refs:
            payloads, fs = self.cloud.fetch_batch(
                [RangeRequest(r.blob, r.offset, r.length) for r in refs])
            stats.docs.add(fs)
            stats.rounds += 1
            texts = [p.decode("utf-8") for p in payloads if p is not None]
        else:
            texts = []
        stats.n_results = len(texts)
        return QueryResult(refs=refs, texts=texts, stats=stats)
