"""Retrieval-augmented decoding: Airphant feeds document context to an LM.

The searcher resolves a keyword query in two parallel-fetch rounds; the
retrieved documents are tokenized into the prompt; the LM prefills once
and decodes with its KV cache. This is the integration point between the
paper's contribution (storage-side) and the serving substrate (the card:
prefill and decode attention run the flash kernels there).

The model runs eagerly under `torch.inference_mode()` on the card that
holds its parameters. Every model gets `pad_to=` at prefill, as in the
JAX package, so a model whose prefill takes no `pad_to` (RWKV-6) raises
`TypeError` there too.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..data.tokenizer import HashTokenizer
from ..index.query import Query
from .search_service import SearchService


@dataclass
class RAGResult:
    query: str
    retrieved: list[str]
    tokens: np.ndarray
    retrieval_ms: float
    n_decoded: int


class RAGPipeline:
    def __init__(self, service: SearchService, model, params,
                 vocab_size: int, max_context: int = 192) -> None:
        self.service = service
        self.model = model
        self.params = params
        self.tokenizer = HashTokenizer(vocab_size)
        self.max_context = max_context

    def _prefill(self, params, batch, pad_to: int):
        return self.model.prefill(params, batch, pad_to=pad_to)

    def _decode(self, params, cache, batch):
        return self.model.decode_step(params, cache, batch)

    @torch.inference_mode()
    def generate(self, query: Query | str, top_k_docs: int = 3,
                 max_new_tokens: int = 16, greedy: bool = True) -> RAGResult:
        result = self.service.search(query, top_k=top_k_docs)
        context = " ".join(result.texts)[: self.max_context * 8]
        ids = self.tokenizer.encode(context)[: self.max_context - 1]
        ids = np.concatenate([[HashTokenizer.BOS], ids]).astype(np.int32)
        device = self.params["embed"].device
        batch = {"tokens": torch.from_numpy(ids[None, :]).to(device)}
        pad_to = len(ids) + max_new_tokens
        logits, cache = self._prefill(self.params, batch, pad_to)
        out = []
        for _ in range(max_new_tokens):
            tok = logits.argmax(dim=-1).to(torch.int32)
            out.append(int(tok[0]))
            logits, cache = self._decode(self.params, cache,
                                         {"tokens": tok[:, None]})
        return RAGResult(
            query=str(query), retrieved=result.texts,
            tokens=np.asarray(out, dtype=np.int32),
            retrieval_ms=result.stats.total_s * 1e3,
            n_decoded=len(out))
