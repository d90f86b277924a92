"""Document-word parsing (paper §II-A / §III-C `document-word parser`).

The paper parses documents into words with a configurable analyzer (it uses
whitespace analyzers for Lucene/Elasticsearch parity). We provide the same:
a whitespace/punctuation word parser for indexing, plus a hashed subword
tokenizer that turns the same corpora into LM training tokens so the data
pipeline can feed the model zoo from the very blobs the index points at.
"""

from __future__ import annotations

import re

import numpy as np

_WORD_RE = re.compile(r"[A-Za-z0-9_\-./]+")


def parse_words(text: str, lowercase: bool = True) -> list[str]:
    """Whitespace-analyzer equivalent: extract indexable keywords."""
    words = _WORD_RE.findall(text)
    return [w.lower() for w in words] if lowercase else words


def distinct_words(text: str) -> set[str]:
    return set(parse_words(text))


class HashTokenizer:
    """Deterministic hashed tokenizer: word -> id in [n_special, vocab).

    Good enough to train a real LM on synthetic/log corpora without a
    learned BPE (offline container): ids are stable across hosts, padding
    and EOS are reserved, and round-tripping is not required for LM loss.
    """

    PAD, BOS, EOS, UNK = 0, 1, 2, 3
    N_SPECIAL = 4

    def __init__(self, vocab_size: int) -> None:
        assert vocab_size > self.N_SPECIAL
        self.vocab_size = int(vocab_size)

    def encode_words(self, words: list[str]) -> np.ndarray:
        span = self.vocab_size - self.N_SPECIAL
        ids = np.array(
            [self.N_SPECIAL + (hash_word(w) % span) for w in words],
            dtype=np.int32)
        return ids

    def encode(self, text: str) -> np.ndarray:
        return self.encode_words(parse_words(text))


def hash_word(word: str) -> int:
    """FNV-1a 64, kept separate from core.hashing to avoid a cycle."""
    h = 0xCBF29CE484222325
    for b in word.encode("utf-8"):
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h
