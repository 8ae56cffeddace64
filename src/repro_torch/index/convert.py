"""Carry an index built by the reference package into this one.

An index is this system's "weights": the same corpus gives the same §3
posting arrays in both packages.  :func:`index_set_from_arrays` builds this
package's :class:`IndexSet` from plain dicts of numpy arrays plus the FL-list
fields, so nothing of the reference package is imported.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from ..core.lemma import FLList
from .builder import IndexSet, NSWRecords

__all__ = ["index_set_from_arrays"]


def _rows(family: Mapping | None) -> dict:
    return {k: np.ascontiguousarray(v, dtype=np.int32) for k, v in (family or {}).items()}


def index_set_from_arrays(
    *,
    lemmas: Sequence[str],
    frequency: Mapping[str, int],
    sw_count: int,
    fu_count: int,
    max_distance: int,
    n_docs: int,
    ordinary: Mapping[str, np.ndarray],
    pair: Mapping[tuple, np.ndarray],
    triple: Mapping[tuple, np.ndarray],
    stop_single: Mapping[tuple, np.ndarray] | None = None,
    stop_pair: Mapping[tuple, np.ndarray] | None = None,
    nsw: Mapping[str, tuple[np.ndarray, np.ndarray, np.ndarray]] | None = None,
) -> IndexSet:
    """An :class:`IndexSet` from raw arrays.

    ``lemmas`` is the FL-list in FL order and ``frequency`` its counts;
    every posting family maps a key to its sorted int32 rows; ``nsw`` maps a
    lemma to its ``(offsets, stop_lemma, distance)`` arrays.
    """
    lemmas = list(lemmas)
    fl = FLList(
        lemmas=lemmas,
        fl_number={l: i for i, l in enumerate(lemmas)},
        frequency={l: int(frequency[l]) for l in lemmas},
        sw_count=int(sw_count),
        fu_count=int(fu_count),
    )
    return IndexSet(
        fl=fl,
        max_distance=int(max_distance),
        ordinary=_rows(ordinary),
        nsw={
            l: NSWRecords(
                offsets=np.asarray(off, np.int64),
                stop_lemma=np.asarray(sl, np.int32),
                distance=np.asarray(dist, np.int32),
            )
            for l, (off, sl, dist) in (nsw or {}).items()
        },
        pair=_rows(pair),
        triple=_rows(triple),
        stop_single=_rows(stop_single),
        stop_pair=_rows(stop_pair),
        n_docs=int(n_docs),
    )

