"""Multi-component key selection (paper §6) and subquery expansion (§5).

A *subquery* is a list of lemmas (one lemma per query position).  Key
selection greedily covers the subquery's lemmas with three-component keys:

* first component  — the most frequently occurring (min FL-number) unused lemma;
* second component — an unused lemma occupying a query index different from the
  first's; among acceptable candidates, the *least* frequently occurring
  (max FL-number); if none, the "used" mark is ignored and the component is
  marked ``*`` (duplicate);
* third component  — same rule with the first two indexes excluded.

``*``-marked components do not contribute ``Set`` calls during the search
(paper §10.4); they exist only so the key has full arity.

Keys are stored canonically with components ordered by FL-number
(``f <= s <= t``, paper §3); star marks travel with their component.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Iterable, Sequence

from .lemma import FLList, LemmaType, Lemmatizer

__all__ = [
    "SelectedKey",
    "select_keys",
    "expand_subqueries",
    "Subquery",
    "canonicalize_key",
    "lemma_order_signature",
    "classify_lemmas",
    "key_family",
    "EXECUTABLE_FAMILIES",
]


def canonicalize_key(
    components: Sequence[str], starred: Sequence[bool], fl: FLList
) -> tuple[tuple[str, ...], tuple[bool, ...]]:
    """Canonical §3 component order (``f <= s <= t`` by FL-number, lexeme tie
    break, star marks travel with their component).

    Shared by §6 selection and by the incremental indexer: segment posting
    dicts are keyed by these tuples, so every segment of a multi-segment
    index must canonicalize against the SAME FL-list for query-time key
    lookup to see a single merged posting list per key.
    """
    order = sorted(
        range(len(components)),
        key=lambda i: (fl.number(components[i]), components[i], starred[i]),
    )
    return (
        tuple(components[i] for i in order),
        tuple(starred[i] for i in order),
    )


def lemma_order_signature(
    lemmas: Iterable[str], fl: FLList
) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """The projection of FL-list state that §3 row generation and §6 key
    selection actually depend on, restricted to one document's lemma set:
    the *relative* FL order of the lemmas plus each lemma's type.

    Two FL generations that agree on this signature for a document produce
    byte-identical postings for it (absolute FL-numbers only ever reach disk
    through NSW stop-lemma ids, which the incremental indexer remaps
    separately) — this is the exactness test behind FL-drift re-keying in
    ``index/incremental.py``.
    """
    ordered = sorted(set(lemmas), key=lambda l: (fl.number(l), l))
    return tuple(ordered), tuple(int(fl.lemma_type(l)) for l in ordered)


@dataclass(frozen=True)
class SelectedKey:
    """A canonical multi-component key plus per-component duplicate marks.

    ``components`` are FL-sorted (f <= s <= t).  ``starred[i]`` is True when
    the i-th canonical component was a ``*`` duplicate in §6 selection.
    ``arity`` is 3 for (f,s,t) keys; shorter subqueries degrade to 2- or
    1-component keys (paper §14: "the new algorithm can also be used with any
    multi-component indexes and one-component indexes").
    """

    components: tuple[str, ...]
    starred: tuple[bool, ...]

    @property
    def arity(self) -> int:
        return len(self.components)

    def active_components(self) -> list[tuple[int, str]]:
        """(slot, lemma) pairs that DO produce Set() calls (unstarred)."""
        return [(i, c) for i, (c, s) in enumerate(zip(self.components, self.starred)) if not s]


@dataclass(frozen=True)
class Subquery:
    """A fully lemma-resolved query: one lemma per position."""

    lemmas: tuple[str, ...]

    def __len__(self) -> int:
        return len(self.lemmas)

    def unique_lemmas(self) -> list[str]:
        seen: dict[str, None] = {}
        for l in self.lemmas:
            seen.setdefault(l)
        return list(seen)

    def multiplicity(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for l in self.lemmas:
            out[l] = out.get(l, 0) + 1
        return out


def expand_subqueries(query: str, lemmatizer: Lemmatizer, limit: int = 16) -> list[Subquery]:
    """§5: expand a word query into subqueries over the lemma alternatives.

    "who are you who" -> [who][are][you][who], [who][be][you][who].
    ``limit`` caps the cartesian blow-up for pathological inputs.
    """
    per_position = lemmatizer.lemmatize_text(query)
    if not per_position:
        return []
    combos = itertools.product(*per_position)
    return [Subquery(tuple(c)) for c in itertools.islice(combos, limit)]


# ---------------------------------------------------------------------------
# §5 lemma classification and §3 index-family binding (the planner's inputs)
# ---------------------------------------------------------------------------

# §3 index families that `IndexSet.key_postings` actually serves; keys bound
# to any other family read zero postings in the current engines.
EXECUTABLE_FAMILIES = frozenset({"triple", "stop_pair", "pair", "stop_single"})


def classify_lemmas(lemmas: Iterable[str], fl: FLList) -> dict[str, LemmaType]:
    """§5 query-lemma classification against the corpus FL thresholds.

    Each lemma's class is its position in the FL-list relative to the
    ``SWCount`` / ``SWCount + FUCount`` boundaries: stop, frequently-used, or
    ordinary (unknown lemmas are ordinary).  This classification — not the
    lemma text — decides which §3 index family can answer a subquery, so it
    is the first step of query planning (``search/planner.py``).
    """
    return {l: fl.lemma_type(l) for l in lemmas}


def key_family(key: SelectedKey, fl: FLList) -> str:
    """The §3 index family that answers a canonical §6 key.

    Mirrors ``IndexSet.key_postings`` dispatch exactly for the families the
    engines serve (``EXECUTABLE_FAMILIES``); the remaining labels name the
    paper's index that *would* cover the key but is not wired into query
    execution, so planned cost (and results) for them is zero:

    * arity 3                      -> ``"triple"``      — (f,s,t) stop triples
    * arity 2, both stop           -> ``"stop_pair"``   — degenerate (f,s)
    * arity 2, FU first            -> ``"pair"``        — (w,v) two-component
    * arity 2, stop + non-stop     -> ``"nsw"``         — NSW records (§3)
    * arity 2, both ordinary       -> ``"ordinary"``    — ordinary-index merge
    * arity 1, stop                -> ``"stop_single"`` — degenerate (f)
    * arity 1, non-stop            -> ``"ordinary"``

    The planner prunes subqueries whose lemma event supply is zero (which
    subsumes non-executable bindings) — exact w.r.t. the engines, which read
    the same empty posting lists.
    """
    types = [fl.lemma_type(c) for c in key.components]
    if key.arity == 3:
        return "triple"
    if key.arity == 2:
        if all(t == LemmaType.STOP for t in types):
            return "stop_pair"
        if types[0] == LemmaType.FREQUENTLY_USED:
            return "pair"
        if LemmaType.STOP in types:
            return "nsw"
        return "ordinary"
    return "stop_single" if types[0] == LemmaType.STOP else "ordinary"


# ---------------------------------------------------------------------------
# §6 key selection
# ---------------------------------------------------------------------------


def _positions_of(lemmas: Sequence[str]) -> dict[str, list[int]]:
    pos: dict[str, list[int]] = {}
    for i, l in enumerate(lemmas):
        pos.setdefault(l, []).append(i)
    return pos


def _pick(
    candidates: list[str],
    fl: FLList,
    *,
    most_frequent: bool,
) -> str | None:
    if not candidates:
        return None
    key = lambda l: (fl.number(l), l)
    return min(candidates, key=key) if most_frequent else max(candidates, key=key)


def select_keys(subquery: Subquery, fl: FLList, arity: int = 3) -> list[SelectedKey]:
    """Greedy §6 selection.  Returns canonical keys covering every lemma.

    Fidelity refinement (DESIGN.md §7): a fallback component is ``*``-starred
    only when the lemma already has as many UNSTARRED slots as its query
    multiplicity.  Verbatim §6 stars every fallback, which silently loses the
    second occurrence of a duplicated lemma that never anchors a key (e.g.
    the query [a a b b] selects the single key (a, b, b*) and can then never
    satisfy b's multiplicity).  All §6 paper examples are unaffected.
    """
    lemmas = list(subquery.lemmas)
    if not lemmas:
        return []
    arity = min(arity, max(1, len(lemmas)))
    positions = _positions_of(lemmas)
    mult = subquery.multiplicity()
    unstarred_slots: dict[str, int] = {l: 0 for l in positions}
    used: set[str] = set()
    keys: list[SelectedKey] = []

    def free_index(lemma: str, taken: set[int]) -> int | None:
        for i in positions[lemma]:
            if i not in taken:
                return i
        return None

    while True:
        unused = [l for l in positions if l not in used]
        if not unused:
            break
        # --- first component: most frequent unused lemma -------------------
        first = _pick(unused, fl, most_frequent=True)
        assert first is not None
        comps: list[str] = [first]
        stars: list[bool] = [False]
        used.add(first)
        unstarred_slots[first] += 1
        taken_idx: set[int] = {positions[first][0]}

        # --- remaining components ------------------------------------------
        for _slot in range(1, arity):
            unused_ok = [
                l for l in positions
                if l not in used and free_index(l, taken_idx) is not None
            ]
            if unused_ok:
                pick = _pick(unused_ok, fl, most_frequent=False)
                assert pick is not None
                comps.append(pick)
                stars.append(False)
                used.add(pick)
                unstarred_slots[pick] += 1
                idx = free_index(pick, taken_idx)
                assert idx is not None
                taken_idx.add(idx)
                continue
            # fallback: ignore the "used" mark -> * duplicate, UNLESS the
            # lemma still needs unstarred slots to satisfy its multiplicity
            any_ok = [l for l in positions if free_index(l, taken_idx) is not None]
            if any_ok:
                pick = _pick(any_ok, fl, most_frequent=False)
                assert pick is not None
                star = unstarred_slots[pick] >= mult[pick]
                comps.append(pick)
                stars.append(star)
                if not star:
                    unstarred_slots[pick] += 1
                idx = free_index(pick, taken_idx)
                assert idx is not None
                taken_idx.add(idx)
                continue
            # final fallback (subquery shorter than arity w/ duplicates):
            # relax the index-distinctness requirement as well.
            pick = _pick(list(positions), fl, most_frequent=False)
            assert pick is not None
            comps.append(pick)
            stars.append(True)

        # canonicalize: sort components by FL-number, stars travel along.
        comps_c, stars_c = canonicalize_key(comps, stars, fl)
        keys.append(SelectedKey(components=comps_c, starred=stars_c))
    return keys
