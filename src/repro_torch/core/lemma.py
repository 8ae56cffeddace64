"""Lemmatization and lemma typing (paper §2).

The paper uses a morphological analyzer that maps each word to a list of
*lemmas* (canonical forms); a word may have several lemmas ("are" -> ["are",
"be"] in the paper's dictionary).  All lemmas are then sorted by decreasing
corpus frequency into the *FL-list*; the position of a lemma in that list is
its *FL-number*.  The first ``SWCount`` lemmas are *stop lemmas*, the next
``FUCount`` are *frequently used*, the rest are *ordinary*.

The paper's analyzer is closed-source; we ship a compact rule-based English
lemmatizer (exceptions table + suffix rules) that reproduces every example in
the paper, including the multi-lemma case "are" -> ("are", "be").
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Iterable, Mapping, Sequence

__all__ = [
    "LemmaType",
    "FLList",
    "Lemmatizer",
    "tokenize",
    "DEFAULT_SW_COUNT",
    "DEFAULT_FU_COUNT",
]

# Representative parameter values from the paper (§2, Experiment 1).
DEFAULT_SW_COUNT = 700
DEFAULT_FU_COUNT = 2100

_TOKEN_RE = re.compile(r"[a-z0-9']+")


def tokenize(text: str) -> list[str]:
    """Lowercase word tokenizer; positions are word ordinals (paper §3)."""
    return _TOKEN_RE.findall(text.lower())


class LemmaType(IntEnum):
    STOP = 0          # first SWCount of the FL-list
    FREQUENTLY_USED = 1  # next FUCount
    ORDINARY = 2      # everything else


# ---------------------------------------------------------------------------
# Lemmatizer
# ---------------------------------------------------------------------------

# Irregular forms.  Values are tuples because the paper's dictionary is
# multi-valued: a word form may map to several lemmas and the query is then
# expanded into subqueries (§5: "who are you who" -> [who][are,be][you][who]).
_EXCEPTIONS: dict[str, tuple[str, ...]] = {
    "are": ("are", "be"),  # the paper's own example keeps both lemmas
    "is": ("be",),
    "am": ("be",),
    "was": ("be",),
    "were": ("be",),
    "been": ("be",),
    "being": ("be",),
    "has": ("have",),
    "had": ("have",),
    "having": ("have",),
    "does": ("do",),
    "did": ("do",),
    "done": ("do",),
    "doing": ("do",),
    "said": ("say",),
    "says": ("say",),
    "saying": ("say",),
    "went": ("go",),
    "gone": ("go",),
    "goes": ("go",),
    "found": ("find",),
    "me": ("i", "me"),
    "my": ("i", "my"),
    "you": ("you",),
    "your": ("you", "your"),
    "who": ("who",),
    "whom": ("who", "whom"),
    "what": ("what",),
    "men": ("man",),
    "women": ("woman",),
    "children": ("child",),
    "mice": ("mouse",),
    "feet": ("foot",),
    "teeth": ("tooth",),
    "made": ("make",),
    "making": ("make",),
    "took": ("take",),
    "taken": ("take",),
    "got": ("get",),
    "gotten": ("get",),
    "came": ("come",),
    "knew": ("know",),
    "known": ("know",),
    "thought": ("think",),
    "saw": ("see", "saw"),
    "seen": ("see",),
    "left": ("leave", "left"),
    "better": ("good", "better"),
    "best": ("good", "best"),
    "worse": ("bad", "worse"),
    "worst": ("bad", "worst"),
    "an": ("a",),
    "its": ("it",),
    "their": ("they", "their"),
    "them": ("they", "them"),
    "these": ("this",),
    "those": ("that",),
    "us": ("we", "us"),
    "songs": ("song",),
    "wars": ("war",),
    "times": ("time",),
}

# Suffix rules applied in order; (suffix, replacement, min_stem_len).
_SUFFIX_RULES: tuple[tuple[str, str, int], ...] = (
    ("iest", "y", 2),
    ("ies", "y", 2),
    ("sses", "ss", 2),
    ("shes", "sh", 2),
    ("ches", "ch", 2),
    ("xes", "x", 2),
    ("zes", "z", 2),
    ("ied", "y", 2),
    ("ing", "", 3),
    ("ingly", "", 3),
    ("edly", "", 3),
    ("ed", "", 3),
    ("est", "", 3),
    ("er", "", 3),
    ("ly", "", 3),
    ("s", "", 2),
)

_VOWELS = set("aeiou")


class Lemmatizer:
    """Rule-based lemmatizer with a user-extensible exceptions table."""

    def __init__(self, extra_exceptions: Mapping[str, tuple[str, ...]] | None = None):
        self._exceptions = dict(_EXCEPTIONS)
        if extra_exceptions:
            self._exceptions.update(extra_exceptions)
        # Rules are pure per-word-form, so memoize: corpora repeat word forms
        # heavily (Zipf), and bulk ingest lemmatizes millions of tokens.
        self._memo: dict[str, tuple[str, ...]] = dict(self._exceptions)

    def lemmas(self, word: str) -> tuple[str, ...]:
        """All lemmas of ``word`` (multi-valued, like the paper's dictionary).

        Memoized — the suffix rules run once per distinct word form.
        """
        w = word.lower()
        hit = self._memo.get(w)
        if hit is not None:
            return hit
        out = self._lemmas_uncached(w)
        self._memo[w] = out
        return out

    def _lemmas_uncached(self, w: str) -> tuple[str, ...]:
        if w in self._exceptions:
            return self._exceptions[w]
        if len(w) <= 3 or w.endswith("ss"):
            return (w,)
        for suffix, repl, min_stem in _SUFFIX_RULES:
            if w.endswith(suffix) and len(w) - len(suffix) >= min_stem:
                stem = w[: len(w) - len(suffix)] + repl
                # undouble final consonant: "running" -> "runn" -> "run"
                if (
                    len(stem) >= 3
                    and stem[-1] == stem[-2]
                    and stem[-1] not in _VOWELS
                    and stem[-1] not in ("s", "l", "z")
                ):
                    stem = stem[:-1]
                # restore silent e: "making" handled by exceptions; generic
                # heuristic: consonant-vowel-consonant stems often need 'e'.
                return (stem,)
        return (w,)

    def lemmatize_text(self, text: str) -> list[tuple[str, ...]]:
        """Per-token lemma tuples for a document."""
        memo = self._memo
        uncached = self._lemmas_uncached
        out = []
        for tok in tokenize(text):
            hit = memo.get(tok)
            if hit is None:
                hit = memo[tok] = uncached(tok)
            out.append(hit)
        return out

    def lemmatize_texts(self, texts: Sequence[str]) -> list[list[tuple[str, ...]]]:
        """Batched ingestion path: lemmatize many documents, resolving each
        DISTINCT word form once across the whole batch (the memo makes the
        marginal document a dict-lookup loop, not a suffix-rule loop)."""
        return [self.lemmatize_text(t) for t in texts]

    def first_lemma_text(self, text: str) -> list[str]:
        """Indexing view: the paper indexes every lemma of every occurrence;
        for index building we emit *all* lemmas per position (see builder)."""
        return [self.lemmas(tok)[0] for tok in tokenize(text)]


# ---------------------------------------------------------------------------
# FL-list
# ---------------------------------------------------------------------------


@dataclass
class FLList:
    """Frequency-ordered lemma list (paper §2).

    ``fl_number[lemma]`` is the 0-based rank in decreasing-frequency order.
    Lemma comparisons in the paper ("you" < "who") are FL-number comparisons.
    """

    lemmas: list[str]
    fl_number: dict[str, int]
    frequency: dict[str, int]
    sw_count: int = DEFAULT_SW_COUNT
    fu_count: int = DEFAULT_FU_COUNT

    @classmethod
    def from_frequencies(
        cls,
        freq: Mapping[str, int],
        sw_count: int = DEFAULT_SW_COUNT,
        fu_count: int = DEFAULT_FU_COUNT,
    ) -> "FLList":
        # Sort by decreasing frequency; ties broken lexicographically so the
        # FL-numbering is deterministic across runs/shards.
        ordered = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
        lemmas = [l for l, _ in ordered]
        fl = {l: i for i, l in enumerate(lemmas)}
        # store frequencies in FL order, not the caller's accumulation order:
        # serialized snapshots (DESIGN.md §12.2/§17.4) must be byte-identical
        # no matter how the counts were reduced (corpus scan, per-shard
        # merge, spill-chunk counters)
        return cls(lemmas=lemmas, fl_number=fl,
                   frequency={l: freq[l] for l in lemmas},
                   sw_count=sw_count, fu_count=fu_count)

    def lemma_type(self, lemma: str) -> LemmaType:
        n = self.fl_number.get(lemma)
        if n is None:
            return LemmaType.ORDINARY
        if n < self.sw_count:
            return LemmaType.STOP
        if n < self.sw_count + self.fu_count:
            return LemmaType.FREQUENTLY_USED
        return LemmaType.ORDINARY

    def is_stop(self, lemma: str) -> bool:
        return self.lemma_type(lemma) == LemmaType.STOP

    def number(self, lemma: str) -> int:
        """FL-number; unknown lemmas sort after everything known."""
        return self.fl_number.get(lemma, len(self.lemmas))

    def compare(self, a: str, b: str) -> int:
        """Paper ordering: a < b iff FL-number(a) < FL-number(b)."""
        na, nb = self.number(a), self.number(b)
        return (na > nb) - (na < nb)

    def __len__(self) -> int:
        return len(self.lemmas)
