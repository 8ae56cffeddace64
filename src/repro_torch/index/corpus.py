"""Document store and synthetic Zipf corpus (paper §1, §11).

The paper's experiments use a 71.5 GB fiction collection and GOV2; neither is
shippable, but the paper argues (§11) that "in typical texts the words are
distributed similarly, as Zipf stated" — so a Zipf-synthesized corpus with a
realistic stop-lemma head reproduces the *algorithmic* behaviour (posting-list
sizes, window densities) that the algorithms are sensitive to.

The generator mixes:
  * a high-frequency function-word head (real English stop words, Zipf ranks),
  * a Zipf tail of synthetic content words,
  * injected phrase snippets (the paper's running examples) so that the
    paper's example queries have non-trivial result sets.

Exactness contract: a ``DocumentStore`` is the ground truth the differential
harness rebuilds from — ``lemma_frequencies`` defines the FL-list, and the
per-position ``lemma_stream`` is exactly what §3 row generation consumes, so
any two builds over equal stores are byte-identical.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

from ..core.lemma import Lemmatizer, tokenize

__all__ = ["Document", "DocumentStore", "synthesize_corpus", "PAPER_EXAMPLE_DOCS"]


# The paper's §3 example documents (word positions are 0-based).
PAPER_EXAMPLE_DOCS: tuple[str, ...] = (
    "Who are you is the album by The Who",
    "Who has reality, who is real, who is true",
)

# Head of the English frequency distribution (order ~ real Zipf rank).
_FUNCTION_WORDS: tuple[str, ...] = (
    "the", "be", "to", "of", "and", "a", "in", "that", "have", "i",
    "it", "for", "not", "on", "with", "he", "as", "you", "do", "at",
    "this", "but", "his", "by", "from", "they", "we", "say", "her", "she",
    "or", "an", "will", "my", "one", "all", "would", "there", "their", "what",
    "so", "up", "out", "if", "about", "who", "get", "which", "go", "me",
    "when", "make", "can", "like", "time", "no", "just", "him", "know", "take",
    "people", "into", "year", "your", "good", "some", "could", "them", "see", "other",
    "than", "then", "now", "look", "only", "come", "its", "over", "think", "also",
    "back", "after", "use", "two", "how", "our", "work", "first", "well", "way",
    "even", "new", "want", "because", "any", "these", "give", "day", "most", "us",
    "is", "are", "was", "were", "why", "need", "war", "man", "old", "great",
)

_PHRASES: tuple[str, ...] = (
    "who are you who",
    "to be or not to be",
    "who are you and why did you say what you did",
    "the who are an english rock band",
    "i need you",
    "one at a time",
    "who is who in the world of war",
    "what do you do all day",
    "how to find the mean",
    "time and time again",
)


@dataclass
class Document:
    """One indexed text: word positions are 0-based ordinals (§3), and
    ``lemma_stream`` holds one tuple of lemmas per position (§2 multi-lemma
    words, e.g. "are" -> ("are", "be"))."""

    doc_id: int
    text: str
    # one tuple of lemmas per word position (multi-lemma words possible)
    lemma_stream: list[tuple[str, ...]] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.lemma_stream)


@dataclass
class DocumentStore:
    """The corpus a §3 build (or incremental rebuild oracle) runs over:
    pre-lemmatized documents plus the shared §2 lemmatizer."""

    documents: list[Document]
    lemmatizer: Lemmatizer

    @classmethod
    def from_texts(cls, texts: Sequence[str], lemmatizer: Lemmatizer | None = None) -> "DocumentStore":
        lem = lemmatizer or Lemmatizer()
        docs = [
            Document(doc_id=i, text=t, lemma_stream=lem.lemmatize_text(t))
            for i, t in enumerate(texts)
        ]
        return cls(documents=docs, lemmatizer=lem)

    @classmethod
    def from_documents(
        cls, documents: Iterable[Document], lemmatizer: Lemmatizer | None = None
    ) -> "DocumentStore":
        """Wrap already-lemmatized documents (doc ids preserved) — the
        rebuild corpus of the incremental indexer's differential checks."""
        return cls(documents=list(documents), lemmatizer=lemmatizer or Lemmatizer())

    def subset(self, doc_ids: Iterable[int]) -> "DocumentStore":
        """Store restricted to ``doc_ids`` (original ids and order kept)."""
        keep = set(doc_ids)
        return DocumentStore(
            documents=[d for d in self.documents if d.doc_id in keep],
            lemmatizer=self.lemmatizer,
        )

    def __len__(self) -> int:
        return len(self.documents)

    def lemma_frequencies(self) -> dict[str, int]:
        """Occurrence counts over every lemma of every position (the FL basis)."""
        freq: dict[str, int] = {}
        for d in self.documents:
            for lemmas in d.lemma_stream:
                for l in lemmas:
                    freq[l] = freq.get(l, 0) + 1
        return freq

    def total_positions(self) -> int:
        return sum(len(d) for d in self.documents)


def synthesize_corpus(
    n_docs: int = 200,
    doc_len: int = 250,
    vocab_size: int = 5000,
    zipf_a: float = 1.2,
    seed: int = 0,
    phrase_rate: float = 0.04,
    include_paper_examples: bool = True,
) -> DocumentStore:
    """Zipf-distributed synthetic corpus with injected paper phrases — the
    §11 experimental stand-in (see module docstring for the Zipf argument)."""
    rng = np.random.default_rng(seed)
    n_func = len(_FUNCTION_WORDS)
    tail = [f"w{idx:05d}" for idx in range(vocab_size)]
    vocab = list(_FUNCTION_WORDS) + tail
    # Zipf ranks over the merged vocabulary
    ranks = np.arange(1, len(vocab) + 1, dtype=np.float64)
    probs = ranks ** (-zipf_a)
    probs /= probs.sum()

    texts: list[str] = list(PAPER_EXAMPLE_DOCS) if include_paper_examples else []
    for _ in range(n_docs):
        draws = rng.choice(len(vocab), size=doc_len, p=probs)
        words: list[str] = []
        for tok_idx in draws:
            if rng.random() < phrase_rate:
                words.extend(tokenize(_PHRASES[int(rng.integers(len(_PHRASES)))]))
            words.append(vocab[int(tok_idx)])
        texts.append(" ".join(words))
    return DocumentStore.from_texts(texts)
