"""Relevance calculation (paper §5 stage 4, §14).

The paper adopts the proximity-relevance model of Yan et al. [20]: "the
relevance of the document is inversely proportional to the square of the
distance between searched words".  Each minimal fragment of span ``d``
contributes ``1 / (d + 1)^2``; a document's score is the sum over its
fragments, which rewards many tight co-occurrences.

Exactness contract: every serving path (host SE2.4 loop, fused batch,
planner/frontend) ranks with :func:`rank_documents` over its exact fragment
union, so two paths that agree on fragments agree on ranking bit-for-bit.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable, Sequence

from ..core.postings import SearchResult

__all__ = ["fragment_score", "rank_documents"]


def fragment_score(result: SearchResult) -> float:
    """§14 proximity relevance of one minimal fragment: ``1 / (span + 1)^2``
    (span in word positions; a single-word match scores 1.0)."""
    return 1.0 / float(result.span + 1) ** 2


def rank_documents(
    results: Iterable[SearchResult], top_k: int = 10
) -> list[tuple[int, float, list[SearchResult]]]:
    """Rank documents by §14 proximity relevance, deterministically.

    Ordering specification (total and input-order independent):

    * documents sort by **decreasing score**, ties broken by **ascending
      doc_id** — so the ``top_k`` cut is stable under every permutation of
      ``results`` and across engines/runs;
    * each document's score is the sum of its fragments' §14 contributions,
      accumulated in **sorted fragment order** ``(start, end)`` — float
      addition is order-sensitive in the last ulp, and callers pass sets, so
      an unsorted sum could rank equal-score documents differently between
      otherwise fragment-identical serving paths;
    * the returned ``fragments`` list is sorted by ``(start, end)`` (the
      ``SearchResult`` tuple order restricted to one document).

    Empty or duplicate-free input degrades naturally: no results -> ``[]``;
    ``top_k <= 0`` -> ``[]``.

    >>> from repro_torch.core.postings import SearchResult
    >>> r = rank_documents(
    ...     {SearchResult(7, 4, 5), SearchResult(3, 0, 1), SearchResult(3, 9, 10)},
    ...     top_k=2,
    ... )
    >>> [(doc, round(score, 4)) for doc, score, _ in r]
    [(3, 0.5), (7, 0.25)]
    >>> rank_documents([])
    []
    """
    if top_k <= 0:
        return []
    per_doc: dict[int, list[SearchResult]] = defaultdict(list)
    for r in results:
        per_doc[r.doc_id].append(r)
    scored = []
    for doc, frs in per_doc.items():
        frs = sorted(frs)  # deterministic float-summation order + output order
        scored.append((doc, sum(fragment_score(r) for r in frs), frs))
    scored.sort(key=lambda t: (-t[1], t[0]))
    return scored[:top_k]
