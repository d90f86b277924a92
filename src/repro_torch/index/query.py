"""Composable boolean query language (paper §IV-F and beyond).

The paper's query trees Q(∨_i ∧_j w_ij) = ∪_i ∩_j Q(w_ij) are the
executable core; this module grows them into a small language:

    Term("error")                         a single indexed word
    And / Or                              n-ary boolean connectives
    Not(q)          also  ~q              negation (verified on content)
    Phrase(("disk", "full"), slop=1)      ordered proximity match
    Regex(r"blk_4[0-9]+")                 n-gram-prefiltered RegEx

All nodes are frozen dataclasses: hashable (they key result caches),
comparable, and composable — `Regex` may sit under `And`, `Not` under
anything. Intersection reduces false positives; union adds them; content
filtering at document-fetch time restores perfect precision either way
(negation and phrases are *only* decidable on content — the planner in
`index/planner.py` turns a tree into candidate lookups plus a per-node
verification pass).

`normalize` rewrites a tree to canonical form (flattening, De Morgan
pushdown, double-negation elimination, single-child collapse); `parse`
and `to_string` round-trip the text syntax through that canonical form:

    parse(to_string(q)) == normalize(q)

Text grammar (recursive descent, lowest precedence first):

    query  := and ( OR and )*
    and    := unary ( AND? unary )*          adjacency is AND
    unary  := (NOT | '-') unary | atom
    atom   := '(' query ')'
            | '"' words '"' ( '~' slop )?    quoted phrase
            | 're:/' pattern '/'             regex ('/' → '\\/', '\\' → '\\\\')
            | word                           tokenized like documents

Bare words run through `data.tokenizer.parse_words` — the same analyzer
the Builder indexes documents with — so query-side and index-side
tokenization cannot diverge.
"""

from __future__ import annotations

import re as _re
from dataclasses import dataclass

from ..data.tokenizer import parse_words


class Query:
    """Base of all query nodes. Supports `&`, `|`, and `~` composition."""

    def __and__(self, other: "Query") -> "And":
        return And((self, other))

    def __or__(self, other: "Query") -> "Or":
        return Or((self, other))

    def __invert__(self) -> "Not":
        return Not(self)


@dataclass(frozen=True)
class Term(Query):
    word: str


@dataclass(frozen=True)
class And(Query):
    items: tuple[Query, ...]


@dataclass(frozen=True)
class Or(Query):
    items: tuple[Query, ...]


@dataclass(frozen=True)
class Not(Query):
    """Negation. Executable only where a positive sibling bounds the
    candidate set (an `And` branch) — the planner rejects queries whose
    results would be the complement of an index lookup (`PureNegationError`).
    Verified exactly against fetched document content."""

    item: Query


@dataclass(frozen=True)
class Phrase(Query):
    """Ordered proximity match: the words must occur in order with at
    most `slop` extra tokens interleaved (slop=0 → strictly adjacent).

    Candidates are the AND of the words' postings (a phrase's documents
    contain all its words — no false negatives); word order and adjacency
    are verified against the fetched document's token sequence.
    """

    words: tuple[str, ...]
    slop: int = 0

    def __post_init__(self) -> None:
        # route through the document analyzer, like parse() does: a
        # directly-constructed Phrase(("Failed", "fetch")) must look up
        # and verify the same tokens the Builder indexed ("failed"),
        # never silently miss; multi-token strings split
        object.__setattr__(self, "words", tuple(
            w for word in self.words for w in parse_words(word)))


@dataclass(frozen=True)
class Regex(Query):
    """RegEx search via the n-gram prefilter (paper §IV-F).

    Candidates are the AND of the pattern's guaranteed-literal n-grams;
    fetched documents are matched against the real pattern. Fully
    composable: under `And` the prefilter intersects with the siblings'
    candidates before any document is fetched.
    """

    pattern: str
    ngram: int = 3


_KEYWORDS = {"and", "or", "not"}
_BARE_WORD = _re.compile(r"[a-z0-9_\-./]+\Z")


def _type_error(node: object) -> TypeError:
    return TypeError(
        f"query trees may contain only Query nodes "
        f"(Term/And/Or/Not/Phrase/Regex); got {type(node).__name__}: "
        f"{node!r}")


# ------------------------------------------------------------- normalization
def normalize(q: Query) -> Query:
    """Canonical form: flatten nested And/And and Or/Or, push `Not`
    through De Morgan down to the leaves, eliminate double negation,
    collapse single-child connectives, drop duplicate siblings, and
    rewrite one-word phrases to terms. Idempotent; semantics-preserving.
    """
    if isinstance(q, Term):
        return q
    if isinstance(q, Regex):
        return q
    if isinstance(q, Phrase):
        if not q.words:
            raise ValueError("Phrase needs at least one word")
        if len(q.words) == 1:
            return Term(q.words[0])
        return q
    if isinstance(q, Not):
        sub = q.item
        if isinstance(sub, Not):                 # ¬¬x → x
            return normalize(sub.item)
        if isinstance(sub, And):                 # ¬(a ∧ b) → ¬a ∨ ¬b
            return normalize(Or(tuple(Not(s) for s in sub.items)))
        if isinstance(sub, Or):                  # ¬(a ∨ b) → ¬a ∧ ¬b
            return normalize(And(tuple(Not(s) for s in sub.items)))
        return Not(normalize(sub))
    if isinstance(q, (And, Or)):
        kind = type(q)
        if not q.items:
            raise ValueError(f"{kind.__name__} needs at least one item")
        flat: list[Query] = []
        for sub in q.items:
            sub = normalize(sub)
            if isinstance(sub, kind):            # (a ∧ (b ∧ c)) → a ∧ b ∧ c
                flat.extend(sub.items)
            else:
                flat.append(sub)
        uniq = tuple(dict.fromkeys(flat))        # a ∧ a → a, stable order
        return uniq[0] if len(uniq) == 1 else kind(uniq)
    raise _type_error(q)


# ------------------------------------------------------------------ printing
def _atom_str(q: Query) -> str | None:
    """Render leaf nodes; None for connectives (need precedence logic)."""
    if isinstance(q, Term):
        w = q.word
        if _BARE_WORD.match(w) and w not in _KEYWORDS:
            return w
        if parse_words(w) == [w]:
            return f'"{w}"'                  # keyword collision: quote it
        raise ValueError(
            f"Term({w!r}) has no text form: the analyzer cannot "
            "reproduce that word (it could never match an indexed "
            "document either)")
    if isinstance(q, Phrase):
        body = '"' + " ".join(q.words) + '"'
        return body + (f"~{q.slop}" if q.slop else "")
    if isinstance(q, Regex):
        pat = q.pattern.replace("\\", "\\\\").replace("/", "\\/")
        return "re:/" + pat + "/"
    return None


def to_string(q: Query) -> str:
    """Text form that `parse` maps back to `normalize(q)`."""
    atom = _atom_str(q)
    if atom is not None:
        return atom
    if isinstance(q, Not):
        sub = to_string(q.item)
        if isinstance(q.item, (And, Or)):
            sub = f"({sub})"
        return f"NOT {sub}"
    if isinstance(q, (And, Or)):
        parts = []
        for sub in q.items:
            s = to_string(sub)
            # Or under And needs parens; everything else binds tighter
            if isinstance(q, And) and isinstance(sub, Or):
                s = f"({s})"
            parts.append(s)
        sep = " AND " if isinstance(q, And) else " OR "
        return sep.join(parts)
    raise _type_error(q)


# ------------------------------------------------------------------- parsing
class QuerySyntaxError(ValueError):
    """Raised by `parse` on malformed query text."""


_SLOP_RE = _re.compile(r"~(\d+)")


def _tokenize(text: str) -> list[tuple[str, object]]:
    """Lex into (kind, value): lparen/rparen/or/and/not/phrase/regex/word."""
    toks: list[tuple[str, object]] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
            continue
        if c == "(":
            toks.append(("lparen", None))
            i += 1
        elif c == ")":
            toks.append(("rparen", None))
            i += 1
        elif c == '"':
            j = text.find('"', i + 1)
            if j < 0:
                raise QuerySyntaxError(f"unterminated quote at {i}: {text!r}")
            words = parse_words(text[i + 1:j])
            i = j + 1
            slop = 0
            m = _SLOP_RE.match(text, i)
            if m:
                slop = int(m.group(1))
                i = m.end()
            if not words:
                raise QuerySyntaxError("empty phrase")
            toks.append(("phrase", (tuple(words), slop)))
        elif c == "-":
            toks.append(("not", None))
            i += 1
        elif text.startswith("re:/", i):
            j, pat = i + 4, []
            while j < n and text[j] != "/":
                if text[j] == "\\" and j + 1 < n and text[j + 1] in "\\/":
                    pat.append(text[j + 1])
                    j += 2
                else:
                    pat.append(text[j])
                    j += 1
            if j >= n:
                raise QuerySyntaxError(
                    f"unterminated re:/…/ at {i}: {text!r}")
            toks.append(("regex", "".join(pat)))
            i = j + 1
        else:
            j = i
            while j < n and text[j] not in '()"' and not text[j].isspace():
                j += 1
            chunk = text[i:j]
            i = j
            low = chunk.lower()
            if low in _KEYWORDS:
                toks.append((low, None))
            else:
                for w in parse_words(chunk):
                    toks.append(("word", w))
    return toks


class _Parser:
    def __init__(self, toks: list[tuple[str, object]], text: str) -> None:
        self.toks = toks
        self.pos = 0
        self.text = text

    def peek(self) -> str | None:
        return self.toks[self.pos][0] if self.pos < len(self.toks) else None

    def take(self) -> tuple[str, object]:
        tok = self.toks[self.pos]
        self.pos += 1
        return tok

    def or_expr(self) -> Query:
        items = [self.and_expr()]
        while self.peek() == "or":
            self.take()
            items.append(self.and_expr())
        return items[0] if len(items) == 1 else Or(tuple(items))

    def and_expr(self) -> Query:
        items = [self.unary()]
        while True:
            kind = self.peek()
            if kind == "and":
                self.take()
                kind = self.peek()
            elif kind not in ("not", "word", "phrase", "regex", "lparen"):
                break
            items.append(self.unary())
        return items[0] if len(items) == 1 else And(tuple(items))

    def unary(self) -> Query:
        if self.peek() == "not":
            self.take()
            return Not(self.unary())
        return self.atom()

    def atom(self) -> Query:
        kind = self.peek()
        if kind == "lparen":
            self.take()
            q = self.or_expr()
            if self.peek() != "rparen":
                raise QuerySyntaxError(f"missing ')' in {self.text!r}")
            self.take()
            return q
        if kind == "phrase":
            _k, (words, slop) = self.take()
            return Phrase(words, slop)
        if kind == "regex":
            return Regex(self.take()[1])
        if kind == "word":
            return Term(self.take()[1])
        raise QuerySyntaxError(
            f"expected a term, phrase, regex, or '(' at token "
            f"{self.pos} of {self.text!r}")


def parse(text: str) -> Query:
    """Parse query text into a **normalized** tree.

    `a b` is AND (adjacency), `OR`/`AND`/`NOT` are case-insensitive
    keywords, `-x` negates, `"a b"~slop` is a phrase, `re:/…/` a regex,
    and parentheses group. Bare words are tokenized exactly like indexed
    documents, so `parse("Node-7,x")` is `And((Term("node-7"), Term("x")))`.
    """
    toks = _tokenize(text)
    if not toks:
        raise QuerySyntaxError(f"empty query: {text!r}")
    p = _Parser(toks, text)
    q = p.or_expr()
    if p.peek() is not None:
        raise QuerySyntaxError(
            f"trailing tokens after position {p.pos} in {text!r}")
    return normalize(q)


# ------------------------------------------------------------- word handling
def regex_grams(pattern: str, ngram: int) -> list[str]:
    """Guaranteed-literal n-grams of a pattern (deduplicated, stable
    order): strip character classes, escapes, and quantified atoms, then
    split on the remaining metacharacters (§IV-F prefilter)."""
    stripped = pattern.lower()
    stripped = _re.sub(r"\[[^\]]*\]", " ", stripped)     # [...] classes
    stripped = _re.sub(r"\\.", " ", stripped)            # \d \b escapes
    stripped = _re.sub(r".[*?]", " ", stripped)          # X? X* atoms
    stripped = _re.sub(r".\{[^}]*\}", " ", stripped)     # X{m,n}
    stripped = _re.sub(r"[()|.^$+]", " ", stripped)      # other meta
    literals = _re.findall(r"[a-z0-9_\-./]{%d,}" % ngram, stripped)
    grams: list[str] = []
    for lit in literals:
        grams.extend(lit[i:i + ngram]
                     for i in range(len(lit) - ngram + 1))
    return list(dict.fromkeys(grams))


def query_words(q: Query) -> list[str]:
    """Distinct indexable words a tree mentions, stable DFS order.

    `Phrase` contributes its words, `Not` its item's, and `Regex` the
    (namespaced) n-gram terms of its prefilter — deduplicated across the
    whole tree, including across several Regex nodes sharing n-grams.
    Non-Query nodes raise `TypeError`.
    """
    from .builder import NGRAM_PREFIX

    out: list[str] = []
    seen: set[str] = set()

    def add(w: str) -> None:
        if w not in seen:
            seen.add(w)
            out.append(w)

    def walk(node: Query) -> None:
        if isinstance(node, Term):
            add(node.word)
        elif isinstance(node, Phrase):
            for w in node.words:
                add(w)
        elif isinstance(node, Regex):
            for g in regex_grams(node.pattern, node.ngram):
                add(NGRAM_PREFIX + g)
        elif isinstance(node, Not):
            walk(node.item)
        elif isinstance(node, (And, Or)):
            for sub in node.items:
                walk(sub)
        else:
            raise _type_error(node)

    walk(q)
    return out
