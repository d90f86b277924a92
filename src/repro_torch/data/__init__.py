"""Corpora, parsing and tokenization."""

from .corpus import (Corpus, DocRef, FAMILIES, make_cranfield_like, make_diag,
                     make_logs_like, make_unif, make_zipf, write_corpus)
from .tokenizer import HashTokenizer, distinct_words, parse_words

__all__ = ["Corpus", "DocRef", "FAMILIES", "make_cranfield_like", "make_diag",
           "make_logs_like", "make_unif", "make_zipf", "write_corpus",
           "HashTokenizer", "distinct_words", "parse_words"]
