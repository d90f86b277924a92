"""Training data pipeline over cloud storage, indexed by IoU Sketch.

The paper's deployment story applied to LM training at fleet scale:
tokenizable documents live in blobs; an Airphant index over them lets any
of 1000s of data-loader hosts materialize a *keyword-filtered* training
mixture with exactly two rounds of parallel range reads (superposts →
documents) and zero metadata services. Determinism contract: batch
content is a pure function of (seed, step, host, n_hosts) — a restarted
host replays its shard exactly, which is what makes checkpoint/restart
bitwise reproducible.

Straggler mitigation (§IV-G) applies twice: hedged superpost reads at
lookup, and hedged document fetches (issue the batch, keep the fastest
(1-overcommit) fraction, re-request the stragglers next round).

The keyword filter's combine runs on `device` (the CUDA key-route
kernels on a card, their plain PyTorch versions on "cpu"); batches stay
NumPy, built on the host from the matched texts.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..index.query import Query
from ..index.searcher import Searcher
from ..storage.blobstore import RangeRequest
from ..storage.simcloud import SimCloudStore
from ..storage.transport import as_transport
from .tokenizer import HashTokenizer


@dataclass(frozen=True)
class PipelineConfig:
    seq_len: int = 256
    batch_size: int = 8            # per host
    vocab_size: int = 32_000
    seed: int = 0
    hedge: bool = True
    pack: bool = True              # pack documents into fixed-length rows


class IndexedCorpusLoader:
    """Deterministic, sharded, keyword-filtered batches from cloud storage."""

    def __init__(self, cloud: SimCloudStore, index_prefix: str,
                 config: PipelineConfig, query: Query | str | None = None,
                 host: int = 0, n_hosts: int = 1, device="cuda") -> None:
        self.cloud = cloud
        self.cfg = config
        self.host = host
        self.n_hosts = n_hosts
        self.tokenizer = HashTokenizer(config.vocab_size)
        self.searcher = Searcher(as_transport(cloud), index_prefix,
                                 device=device)
        if query is not None:
            result = self.searcher.query(query, hedge=config.hedge)
            self._texts = result.texts
        else:
            self._texts = self._fetch_all()
        # host shard: stable round-robin split of the matched documents
        self._texts = self._texts[self.host::self.n_hosts]
        if not self._texts:
            raise ValueError("query matched no documents for this shard")

    def _fetch_all(self) -> list[str]:
        """No filter: read every doc the index's doc space covers via the
        common+hashed postings of the empty query — i.e. fetch blobs."""
        names = [n for n in self.cloud.backing.list()
                 if "/docs-" in n]
        texts: list[str] = []
        payloads, _ = self.cloud.fetch_batch(
            [RangeRequest(n) for n in names])
        for p in payloads:
            assert p is not None
            texts.extend(t for t in p.decode("utf-8").split("\n") if t)
        return texts

    # ------------------------------------------------------------- batching
    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Batch for (step, host): tokens + labels (B, S) int32."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + self.host)
        rows = []
        for _ in range(cfg.batch_size):
            if cfg.pack:
                ids: list[int] = []
                while len(ids) < cfg.seq_len + 1:
                    doc = self._texts[int(rng.integers(0, len(self._texts)))]
                    ids.extend(self.tokenizer.encode(doc).tolist())
                    ids.append(HashTokenizer.EOS)
                row = np.array(ids[:cfg.seq_len + 1], dtype=np.int32)
            else:
                doc = self._texts[int(rng.integers(0, len(self._texts)))]
                ids = self.tokenizer.encode(doc)[:cfg.seq_len + 1]
                row = np.full(cfg.seq_len + 1, HashTokenizer.PAD, np.int32)
                row[:len(ids)] = ids
            rows.append(row)
        arr = np.stack(rows)
        labels = arr[:, 1:].copy()
        labels[labels == HashTokenizer.PAD] = -1
        return {"tokens": arr[:, :-1], "labels": labels}

    def batches(self, start_step: int, n_steps: int):
        for step in range(start_step, start_step + n_steps):
            yield step, self.batch(step)
