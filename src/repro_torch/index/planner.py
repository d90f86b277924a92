"""Logical → physical query planner (docs/query_language.md).

One pipeline executes every query the language can express — plan,
fetch, verify:

  logical  — `normalize` (query.py) rewrites the tree to canonical form:
             flattened connectives, `Not` pushed to the leaves;
  physical — this module turns the tree into (a) the **lookup set**: the
             distinct words/n-grams whose superposts round 1 must fetch,
             (b) the **candidate algebra**: AND / OR / ANDNOT steps over
             the per-word candidate postings, and (c) the **verifier**:
             a per-document predicate over the fetched content that
             restores exact semantics at round 2.

Soundness is the whole design. Sketch lookups have false positives but
never false negatives, so candidate sets may only be *intersected,
unioned, or subtracted-by-exact-sets* — anything else could drop a true
match before verification can save it:

  * `Term` / `Phrase` / `Regex` — AND of the words' (or literal
    n-grams') candidates: a matching document contains them all.
  * `Or` — union of its branches.
  * `Not` — contributes **no** candidate narrowing in general (its
    item's candidates are a superset, and subtracting a superset drops
    true matches). The one sound exception: a negated **common word**
    (§IV-E) has an *exact* postings list, so `ANDNOT common(w)` prunes
    candidates with zero risk — and negating a common word is precisely
    the case where pruning pays most. Everything else about negation is
    settled by the verifier on fetched text.
  * Subtrees that bound nothing (`Not`, a `Regex` with no literal run,
    an `Or` with such a branch) are "unbounded": inside an `And` with a
    positive sibling they ride that sibling's candidates and verify on
    content; an unbounded *root* has no index-backed candidate set at
    all and is rejected with `PureNegationError`.

The executor (searcher.py `execute_jobs`) is unchanged in shape: one
shared superpost round, the candidate algebra in memory (NumPy set ops,
or the batched CUDA kernels of `combine_keys` under `impl="bitmap"`), one
shared document round, per-node verification. Classic Term/And/Or trees
and standalone Regex queries compile to exactly the jobs the pre-planner
engine built — byte-identical requests, results, and stats.
"""

from __future__ import annotations

import re as _re
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable

import numpy as np

from ..core.hashing import word_fingerprint
from ..core.sketch import intersect_sorted
from ..data.tokenizer import parse_words
from .query import (And, Not, Or, Phrase, Query, Regex, Term, normalize,
                    query_words, regex_grams)


class PureNegationError(ValueError):
    """The query has no positive, index-backed atom to bound its
    candidate set (e.g. `NOT x`, `a OR NOT b`, a lone regex with no
    literal run) — answering it would require scanning the corpus."""


class GramlessIndexError(ValueError):
    """A regex with literal n-gram runs was planned against an index
    unit that holds no matching n-gram postings — either the index was
    built without `BuilderConfig(index_ngrams=...)`, or with a different
    n than the query's `Regex(..., ngram=n)`.

    Without this guard the lookup hashes never-inserted n-gram terms
    into the sketch and (almost always) intersects down to zero
    candidates: the query *silently* misses documents the regex truly
    matches. Units whose header predates the `index_ngrams` field are
    treated as unknown and not rejected."""


def _check_regex_units(tree: Query, units: tuple) -> None:
    """Reject gramful regexes against known-gramless/mismatched units."""
    if not units:
        return

    def walk(node: Query) -> None:
        if isinstance(node, Regex):
            if not regex_grams(node.pattern, node.ngram):
                return               # gramless pattern: handled elsewhere
            for u in units:
                n = getattr(u, "ngram_n", None)
                if n is None:        # legacy header: unknown, stay lax
                    continue
                if n == 0:
                    raise GramlessIndexError(
                        f"regex {node.pattern!r} needs {node.ngram}-gram "
                        f"postings but index unit {u.prefix!r} was built "
                        "without index_ngrams; rebuild with "
                        f"BuilderConfig(index_ngrams={node.ngram})")
                if n != node.ngram:
                    raise GramlessIndexError(
                        f"regex {node.pattern!r} uses ngram={node.ngram} "
                        f"but index unit {u.prefix!r} was built with "
                        f"index_ngrams={n}; query with Regex(pattern, "
                        f"ngram={n})")
        elif isinstance(node, (And, Or)):
            for sub in node.items:
                walk(sub)
        elif isinstance(node, Not):
            walk(node.item)

    walk(tree)


# ------------------------------------------------------------------ document
class DocContent:
    """Lazy per-document views for verification: raw text, the token
    sequence (phrase order/adjacency), and the distinct-word set —
    each computed at most once per unique document per round."""

    __slots__ = ("text", "_tokens", "_words")

    def __init__(self, text: str) -> None:
        self.text = text
        self._tokens: list[str] | None = None
        self._words: set[str] | None = None

    @property
    def tokens(self) -> list[str]:
        if self._tokens is None:
            self._tokens = parse_words(self.text)
        return self._tokens

    @property
    def words(self) -> set[str]:
        if self._words is None:
            self._words = set(self.tokens)
        return self._words


@lru_cache(maxsize=256)
def _compiled(pattern: str) -> "_re.Pattern[str]":
    return _re.compile(pattern)


def _phrase_in(tokens: list[str], words: tuple[str, ...], slop: int) -> bool:
    """True iff `words` occur in order with ≤ `slop` extra tokens
    interleaved (greedy earliest-next scan per start: minimal span)."""
    first = words[0]
    n = len(tokens)
    for s, tok in enumerate(tokens):
        if tok != first:
            continue
        i = s
        for w in words[1:]:
            j = i + 1
            while j < n and tokens[j] != w:
                j += 1
            if j >= n:            # no later occurrence: later starts fail too
                return False
            i = j
        if i - s - (len(words) - 1) <= slop:
            return True
    return False


def matches(q: Query, content: DocContent) -> bool:
    """Exact per-document verification of a full query tree."""
    if isinstance(q, Term):
        return q.word in content.words
    if isinstance(q, And):
        return all(matches(s, content) for s in q.items)
    if isinstance(q, Or):
        return any(matches(s, content) for s in q.items)
    if isinstance(q, Not):
        return not matches(q.item, content)
    if isinstance(q, Phrase):
        return _phrase_in(content.tokens, q.words, q.slop)
    if isinstance(q, Regex):
        return bool(_compiled(q.pattern).search(content.text))
    raise TypeError(f"not a Query node: {type(q).__name__}")


# ------------------------------------------------------------- logical pass
def _bounded(q: Query) -> bool:
    """Does this subtree have an index-backed candidate set?"""
    if isinstance(q, (Term, Phrase)):
        return True
    if isinstance(q, Regex):
        return bool(regex_grams(q.pattern, q.ngram))
    if isinstance(q, Not):
        return False
    if isinstance(q, And):
        return any(_bounded(s) for s in q.items)
    if isinstance(q, Or):
        return all(_bounded(s) for s in q.items)
    raise TypeError(f"not a Query node: {type(q).__name__}")


def _is_classic(q: Query) -> bool:
    """Trees the pre-planner engine already executed: Term/And/Or only."""
    if isinstance(q, Term):
        return True
    if isinstance(q, (And, Or)):
        return all(_is_classic(s) for s in q.items)
    return False


def _classic_matches(q: Query, words: set[str]) -> bool:
    if isinstance(q, Term):
        return q.word in words
    if isinstance(q, And):
        return all(_classic_matches(s, words) for s in q.items)
    assert isinstance(q, Or)
    return any(_classic_matches(s, words) for s in q.items)


def regex_prefilter(pattern: str, ngram: int,
                    ) -> tuple[Query, "_re.Pattern[str]"]:
    """Literal runs (≥ n chars) → AND of indexed n-grams (§IV-F)."""
    from .builder import NGRAM_PREFIX
    grams = regex_grams(pattern, ngram)
    if not grams:
        raise ValueError(
            f"pattern {pattern!r} has no literal run of >= {ngram} "
            "chars to prefilter on (a full corpus scan would be "
            "required — rejected, like the paper's RegEx engines)")
    q = And(tuple(Term(NGRAM_PREFIX + g) for g in grams)) \
        if len(grams) > 1 else Term(NGRAM_PREFIX + grams[0])
    return q, _compiled(pattern)


# ------------------------------------------------------------ physical pass
@dataclass
class PhysicalPlan:
    """Per-query physical plan: normalized tree + round-1 lookup set.

    `subtract_words` are negated terms that are common (exact postings)
    in at least one index unit — their postings join the lookup round so
    the per-unit combine can ANDNOT them; units where the word is hashed
    simply skip the subtraction (their candidates are inexact supersets).
    """

    tree: Query
    lookup_words: list[str]
    subtract_words: frozenset[str]


def _walk_lookup(node: Query, subtract: frozenset[str],
                 add: Callable[[str], None]) -> None:
    """Collect round-1 words from candidate-bearing subtrees, DFS order
    (mirrors `_compile_steps` so every compiled leaf is fetched)."""
    from .builder import NGRAM_PREFIX
    if isinstance(node, Term):
        add(node.word)
    elif isinstance(node, Phrase):
        for w in node.words:
            add(w)
    elif isinstance(node, Regex):
        for g in regex_grams(node.pattern, node.ngram):
            add(NGRAM_PREFIX + g)
    elif isinstance(node, And):
        for sub in node.items:
            if isinstance(sub, Not):
                if isinstance(sub.item, Term) and sub.item.word in subtract:
                    add(sub.item.word)
            elif _bounded(sub):
                _walk_lookup(sub, subtract, add)
    elif isinstance(node, Or):
        if _bounded(node):
            for sub in node.items:
                _walk_lookup(sub, subtract, add)
    # bare Not at this level contributes nothing (verification-only)


def _negated_terms(node: Query, out: list[str]) -> None:
    """Terms negated in subtractable position (direct And children)."""
    if isinstance(node, And):
        for sub in node.items:
            if isinstance(sub, Not) and isinstance(sub.item, Term):
                out.append(sub.item.word)
            else:
                _negated_terms(sub, out)
    elif isinstance(node, (Or, Not)):
        subs = node.items if isinstance(node, Or) else (node.item,)
        for sub in subs:
            _negated_terms(sub, out)


def physical_plan(tree: Query, units: tuple = ()) -> PhysicalPlan:
    """Compile a normalized tree against the opened units' statistics.

    The units (Searchers over a base index and its segments) contribute
    one physical fact: their common-word tables, which decide where an
    exact ANDNOT prune is sound. An empty `units` plans conservatively
    (no subtraction) — still exact, just no pruning.
    """
    if not _bounded(tree):
        raise PureNegationError(
            f"query {tree!r} has no positive index-backed atom to bound "
            "its candidates (pure negation, or a regex with no literal "
            "run); AND it with a positive term, phrase, or regex")
    negated: list[str] = []
    _negated_terms(tree, negated)
    subtract = frozenset(
        w for w in negated
        if any(word_fingerprint(w) in u.common for u in units))
    words: list[str] = []
    seen: set[str] = set()

    def add(w: str) -> None:
        if w not in seen:
            seen.add(w)
            words.append(w)

    _walk_lookup(tree, subtract, add)
    assert words, "bounded tree must yield at least one lookup word"
    return PhysicalPlan(tree=tree, lookup_words=words,
                        subtract_words=subtract)


# ----------------------------------------------------------- physical jobs
@dataclass
class Job:
    """One query of a batch: lookup tree + round-2 acceptance filter.

    Exactly one acceptance predicate is set. Classic tree queries filter
    on the document's word set (computed once per unique document per
    batch), classic regex jobs on the raw text, and planner-compiled
    queries (`plan` set) on a lazy `DocContent` via per-node `matches`.
    """

    lookup_q: Query
    accept_words: Callable[[set[str]], bool] | None = None
    accept_text: Callable[[str], bool] | None = None
    accept_doc: Callable[[DocContent], bool] | None = None
    plan: PhysicalPlan | None = None
    top_k: int | None = None
    delta: float = 1e-6
    fetch_documents: bool = True


def _lookup_tree(words: list[str]) -> Query:
    return Term(words[0]) if len(words) == 1 else \
        And(tuple(Term(w) for w in words))


def make_job(q: Query, top_k: int | None = None,
             delta: float = 1e-6, fetch_documents: bool = True,
             units: tuple = ()) -> Job:
    """Plan one query into a physical job.

    Classic shapes (Term/And/Or trees; a standalone Regex) compile to
    exactly the jobs the pre-planner engine built — same lookups in the
    same order, same acceptance predicate — so existing workloads stay
    byte-identical. Everything else goes through the physical planner.
    """
    if isinstance(q, Regex):
        _check_regex_units(q, units)
        lookup_q, compiled = regex_prefilter(q.pattern, q.ngram)
        return Job(lookup_q=lookup_q,
                   accept_text=lambda t, c=compiled: bool(c.search(t)),
                   top_k=top_k, delta=delta,
                   fetch_documents=fetch_documents)
    tree = normalize(q)
    _check_regex_units(tree, units)
    if _is_classic(tree):
        return Job(lookup_q=tree,
                   accept_words=lambda ws, q=tree: _classic_matches(q, ws),
                   top_k=top_k, delta=delta,
                   fetch_documents=fetch_documents)
    plan = physical_plan(tree, units)
    return Job(lookup_q=_lookup_tree(plan.lookup_words),
               accept_doc=lambda c, q=tree: matches(q, c),
               plan=plan, top_k=top_k, delta=delta,
               fetch_documents=fetch_documents)


def plan_batch(queries: list[Query | str], units: tuple = (),
               top_k: int | None = None, delta: float = 1e-6,
               fetch_documents: bool = True) -> list[Job]:
    """Plan a whole batch (raw strings are single terms, as ever)."""
    return [make_job(Term(q) if isinstance(q, str) else q, top_k=top_k,
                     delta=delta, fetch_documents=fetch_documents,
                     units=units)
            for q in queries]


# -------------------------------------------------------- candidate algebra
# Opcodes shared with the CUDA kernel (kernels/intersect).
OP_AND, OP_OR, OP_ANDNOT = 0, 1, 2


def _compile_steps(plan: PhysicalPlan,
                   per_word: dict[str, tuple[np.ndarray, np.ndarray]],
                   is_common: Callable[[str], bool],
                   ) -> tuple[list[tuple[np.ndarray, np.ndarray]],
                              list[tuple[int, int, int]]]:
    """Lower the tree to (leaves, steps) for one unit.

    Leaves are (keys, lengths) candidate arrays; steps are
    (op, ref_a, ref_b) over slots — leaves first, then one slot per
    step, exactly the layout `kernels.intersect.combine_batch` expects.
    """
    from .builder import NGRAM_PREFIX
    leaves: list[tuple[np.ndarray, np.ndarray]] = []
    steps: list[tuple[int, object, object]] = []

    def leaf(w: str):
        leaves.append(per_word[w])
        return ("l", len(leaves) - 1)

    def emit(op: int, a, b):
        steps.append((op, a, b))
        return ("s", len(steps) - 1)

    def chain(op: int, refs: list):
        acc = refs[0]
        for r in refs[1:]:
            acc = emit(op, acc, r)
        return acc

    def go(node: Query):
        if isinstance(node, Term):
            return leaf(node.word)
        if isinstance(node, Phrase):
            return chain(OP_AND, [leaf(w) for w in node.words])
        if isinstance(node, Regex):
            grams = regex_grams(node.pattern, node.ngram)
            if not grams:
                return None
            return chain(OP_AND, [leaf(NGRAM_PREFIX + g) for g in grams])
        if isinstance(node, Or):
            # only reached under a _bounded guard: every branch is bounded
            # (an Or with an unbounded branch bounds nothing and is
            # skipped by its parent And / rejected at the root)
            refs = [go(s) for s in node.items]
            assert all(r is not None for r in refs)
            return chain(OP_OR, refs)
        if isinstance(node, And):
            pos, neg = [], []
            for sub in node.items:
                if isinstance(sub, Not):
                    w = sub.item.word if isinstance(sub.item, Term) else None
                    if w is not None and w in plan.subtract_words \
                            and w in per_word and is_common(w):
                        neg.append(leaf(w))      # exact list: sound prune
                elif _bounded(sub):
                    r = go(sub)
                    if r is not None:
                        pos.append(r)
            if not pos:
                return None
            acc = chain(OP_AND, pos)
            for n in neg:
                acc = emit(OP_ANDNOT, acc, n)
            return acc
        assert isinstance(node, Not)
        return None

    root = go(plan.tree)
    assert root is not None, "physical_plan guarantees a bounded root"
    # resolve symbolic refs: leaves occupy slots 0..L-1, step i slot L+i
    L = len(leaves)

    def slot(ref) -> int:
        kind, i = ref
        return i if kind == "l" else L + i

    resolved = [(op, slot(a), slot(b)) for op, a, b in steps]
    if root[0] == "l" and not resolved:
        # single-leaf plan: one identity step keeps the program non-empty
        resolved = [(OP_AND, slot(root), slot(root))]
    return leaves, resolved


def _eval_steps(leaves: list[tuple[np.ndarray, np.ndarray]],
                steps: list[tuple[int, int, int]],
                ) -> tuple[np.ndarray, np.ndarray]:
    """NumPy evaluation of a compiled program (the `impl="sorted"` path):
    sorted-unique uint64 key arrays through AND/OR/ANDNOT set ops."""
    slots: list[np.ndarray] = [k for k, _l in leaves]
    for op, a, b in steps:
        va, vb = slots[a], slots[b]
        if op == OP_AND:
            slots.append(intersect_sorted([va, vb]))
        elif op == OP_OR:
            slots.append(np.union1d(va, vb).astype(np.uint64, copy=False))
        else:
            slots.append(np.setdiff1d(va, vb, assume_unique=True))
    keys = slots[-1]
    return keys, _recover_lengths(keys, leaves)


def _recover_lengths(keys: np.ndarray,
                     leaves: list[tuple[np.ndarray, np.ndarray]],
                     ) -> np.ndarray:
    """Document lengths for `keys` from whichever leaf contains each."""
    lengths = np.zeros(len(keys), dtype=np.uint64)
    for k, l in leaves:
        if not len(k):
            continue
        idx = np.searchsorted(k, keys)
        idx = np.clip(idx, 0, len(k) - 1)
        hit = k[idx] == keys
        lengths[hit] = l[idx[hit]]
    return lengths


def combine_planned(plans: list[PhysicalPlan],
                    per_words: list[dict],
                    is_common: Callable[[str], bool],
                    impl: str = "sorted", device="cuda",
                    ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Evaluate several planned queries' candidate algebra for one unit.

    `impl="sorted"` runs NumPy set ops per query; `impl="bitmap"` ranks
    every query's leaf postings into one universe on `device` and
    evaluates every compiled program in ONE `combine_keys` call
    (AND/OR/ANDNOT fused per document word), reading back candidate
    keys.
    """
    compiled = [_compile_steps(p, pw, is_common)
                for p, pw in zip(plans, per_words)]
    if impl != "bitmap":
        return [_eval_steps(leaves, steps) for leaves, steps in compiled]
    return _combine_compiled(compiled, None, device)[0]


def _combine_compiled(compiled: list, groups: int | None, device,
                      ) -> tuple[list[tuple[np.ndarray, np.ndarray]],
                                 "torch.Tensor"]:
    """`combine_keys` over compiled (leaves, steps) rows → each row's
    (keys, lengths) and the counts; the lengths are recovered on the
    device by `_recover_lengths`' rule (`kernels.intersect.ops`'
    `key_lengths`)."""
    from ..kernels.intersect import combine_keys, keys_per_row

    keys, counts, lengths = combine_keys(
        [[k for k, _l in leaves] for leaves, _steps in compiled],
        [steps for _leaves, steps in compiled], groups=groups,
        device=device,
        lengths=[[l for _k, l in leaves] for leaves, _steps in compiled])
    return list(zip(keys_per_row(keys, counts),
                    keys_per_row(lengths, counts))), counts


def combine_cluster_planned(plans_by_group: list[list[PhysicalPlan]],
                            per_words_by_group: list[list[dict]],
                            is_common_by_group: list[Callable[[str], bool]],
                            device="cuda",
                            ) -> tuple[list[list[tuple[np.ndarray,
                                                       np.ndarray]]],
                                       np.ndarray]:
    """Evaluate every (shard unit, query) candidate algebra in ONE fused
    call on `device` (`kernels.intersect.combine_keys` over the
    cluster's (shard, query) rows).

    Group g is one shard unit: `plans_by_group[g][q]`,
    `per_words_by_group[g][q]`, and `is_common_by_group[g]` follow
    `combine_planned`'s bitmap path per group, but instead of one call
    per unit the whole cluster's programs run on a single (shard,
    query, tile) grid. Returns `(results, counts)`: `results[g][q]` is
    the sorted `(keys, lengths)` candidate pair and `counts` a (G, Q)
    int64 array of per-(group, query) candidate totals — exactly the
    round-1 statistics `shard_quotas` consumes.
    """
    G = len(plans_by_group)
    Q = len(plans_by_group[0]) if G else 0
    if not G or not Q:
        return [[] for _ in range(G)], np.zeros((G, Q), dtype=np.int64)
    compiled = [_compile_steps(plans_by_group[g][q],
                               per_words_by_group[g][q],
                               is_common_by_group[g])
                for g in range(G) for q in range(Q)]
    flat, counts = _combine_compiled(compiled, G, device)
    return ([flat[g * Q:(g + 1) * Q] for g in range(G)],
            counts.cpu().numpy().astype(np.int64))


# ----------------------------------------------------- global top-K budget
def shard_quotas(counts: list[int], k: int, F0s: list[float],
                 delta: float = 1e-6) -> list[int]:
    """Global top-K sampling budget (paper Eq. 6, applied cluster-wide).

    `counts[g]` is group g's round-1 candidate total R_g; `F0s[g]` its
    index unit's expected false-positive count. Per-shard sampling
    evaluates Eq. 6 independently per group and fetches ~N·k documents
    across N groups; here Eq. 6 is evaluated ONCE over the pooled
    candidates — R = ΣR_g, F0 = ΣF0_g (each unit contributes ~F0_g of
    the cluster's false positives, so they pool additively) — and the
    global R_K is split into per-group quotas proportional to R_g by
    deterministic largest-remainder rounding, capped at R_g, with a
    minimum of 1 for any group holding candidates (a tiny shard can
    never be starved out of a top-K it actually holds).
    """
    from ..core.topk import sample_size

    counts = [int(c) for c in counts]
    total = sum(counts)
    if total == 0:
        return [0] * len(counts)
    rk = min(sample_size(total, k, float(sum(F0s)), delta), total)
    exact = [rk * c / total for c in counts]
    quotas = [min(int(x), c) for x, c in zip(exact, counts)]
    for g, c in enumerate(counts):
        if c and not quotas[g]:
            quotas[g] = 1
    short = rk - sum(quotas)
    if short > 0:
        order = sorted(range(len(counts)),
                       key=lambda g: (-(exact[g] - int(exact[g])), g))
        while short > 0:
            progressed = False
            for g in order:
                if short > 0 and quotas[g] < counts[g]:
                    quotas[g] += 1
                    short -= 1
                    progressed = True
            if not progressed:
                break
    return quotas


__all__ = ["PureNegationError", "GramlessIndexError", "PhysicalPlan",
           "Job", "DocContent", "make_job", "plan_batch", "physical_plan",
           "matches", "regex_prefilter", "combine_planned",
           "combine_cluster_planned", "shard_quotas"]
