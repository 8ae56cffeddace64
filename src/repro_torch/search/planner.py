"""Query planner (paper §5–§6; companion arXiv 2009.03679 §serving).

The paper's query pipeline is *planned*: every query lemma is classified
against the corpus FL-list thresholds (stop / frequently-used / ordinary,
§5), and the classification decides which §3 multi-component index family —
(f,s,t) triple, (w,v) pair, NSW, or ordinary — answers each subquery.  The
engines in this repo previously hard-coded that choice inside each call
(``select_keys`` ran inline, costs were discovered by reading postings); this
module lifts it into an explicit, inspectable **plan**:

* :class:`QueryPlanner` classifies lemmas (``core.keys.classify_lemmas``),
  selects §6 keys, binds each key to its §3 index family
  (``core.keys.key_family``) and attaches a per-subquery cost estimate —
  real posting-list lengths and byte sizes read from the **live** index view
  (a ``SegmentedIndexSet`` resolves per call, so estimates track commits,
  deletes and compactions).
* Subqueries proved empty at plan time are **pruned exactly**: a subquery
  emits a fragment only if every lemma supplies at least one event, and a
  lemma's events come solely from the posting lists of keys carrying it
  unstarred — zero total supply therefore implies zero fragments, which is
  precisely when the engines would return nothing after doing the work.
* :func:`execute_plans` runs a batch of plans through the fused device
  pipeline (ONE dispatch per batch, ``search/fused.py``) using the plan's
  own key bindings, so execution reads exactly the postings the plan costed.

Exactness contract: planned execution returns byte-identical fragment sets
to the unplanned SE2.4 / fused engines on the same live view — the planner
only *re-orders and prunes provably-empty work*, never changes results
(pinned by ``tests/test_planner.py`` against the §10 oracle).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Sequence

from ..core.keys import (
    EXECUTABLE_FAMILIES,
    SelectedKey,
    Subquery,
    classify_lemmas,
    expand_subqueries,
    key_family,
    select_keys,
)
from ..core.lemma import FLList, Lemmatizer, LemmaType
from ..core.postings import QueryStats
from ..index.builder import IndexSet
from ..index.incremental import IncrementalIndexer, generation_token
from .fused import serve_query_batch
from .relevance import rank_documents

__all__ = [
    "KeyBinding",
    "SubqueryPlan",
    "QueryPlan",
    "QueryPlanner",
    "execute_plans",
    "generation_token",
    "resolve_index_views",
]

_POSTING_BYTES = 4  # int32 fields


@dataclass(frozen=True)
class KeyBinding:
    """One §6 key bound to the §3 index family that serves it (§5 step 3).

    ``est_postings`` / ``est_bytes`` are the *actual* posting rows and bytes
    the key reads from the live view at plan time — not a model estimate, so
    plan cost equals execution cost exactly (the live view caches the merged
    arrays the execution then reuses).  Non-executable families (``"nsw"``,
    ``"ordinary"`` — see ``core.keys.key_family``) always cost zero.
    """

    key: SelectedKey
    family: str
    est_postings: int
    est_bytes: int

    @property
    def executable(self) -> bool:
        return self.family in EXECUTABLE_FAMILIES


@dataclass
class SubqueryPlan:
    """The plan for one §5 subquery: classified lemmas, bound keys, cost.

    ``pruned`` marks subqueries proved empty at plan time (some lemma has
    zero event supply across all bound keys) — exact, the engines would
    return no fragments for them; ``prune_reason`` names the witness.
    """

    subquery: Subquery
    keys: tuple[SelectedKey, ...]
    bindings: tuple[KeyBinding, ...]
    lemma_types: dict[str, LemmaType]
    est_postings: int
    est_bytes: int
    pruned: bool = False
    prune_reason: str = ""


@dataclass
class QueryPlan:
    """An executable plan for one word query (§5 stages 1–3, made explicit).

    ``generation`` snapshots the index source's cache-invalidation token at
    plan time (DESIGN.md §11): a plan is valid exactly while the token
    matches the live source, and frontend caches key on it.
    """

    query: str
    subqueries: list[SubqueryPlan]
    generation: object = 0
    plan_sec: float = 0.0

    def executable(self) -> list[SubqueryPlan]:
        """Subqueries that survive exact pruning, in plan order."""
        return [sp for sp in self.subqueries if not sp.pruned]

    @property
    def est_postings(self) -> int:
        return sum(sp.est_postings for sp in self.executable())

    @property
    def est_bytes(self) -> int:
        return sum(sp.est_bytes for sp in self.executable())

    @property
    def n_pruned(self) -> int:
        return sum(1 for sp in self.subqueries if sp.pruned)

    def explain(self) -> str:
        """Human-readable plan dump (the ``launch/serve.py --explain`` view)."""
        lines = [f"plan {self.query!r}: {len(self.subqueries)} subqueries, "
                 f"~{self.est_postings} postings "
                 f"({self.est_bytes / 1024:.1f} KB), "
                 f"{self.n_pruned} pruned, planned in "
                 f"{self.plan_sec * 1e3:.2f} ms"]
        type_names = {LemmaType.STOP: "stop", LemmaType.FREQUENTLY_USED: "fu",
                      LemmaType.ORDINARY: "ord"}
        for sp in self.subqueries:
            classes = " ".join(
                f"{l}/{type_names[t]}" for l, t in sp.lemma_types.items()
            )
            status = f"PRUNED ({sp.prune_reason})" if sp.pruned else (
                f"{sp.est_postings} postings")
            lines.append(f"  [{' '.join(sp.subquery.lemmas)}]  {classes}  -> {status}")
            for b in sp.bindings:
                star = "".join("*" if s else "." for s in b.key.starred)
                lines.append(
                    f"    {b.family:<11} ({', '.join(b.key.components)}) "
                    f"[{star}] {b.est_postings} rows"
                )
        return "\n".join(lines)


def resolve_index_views(source) -> tuple[list[IndexSet], FLList, int, Lemmatizer | None]:
    """Resolve an index source into ``(live views, fl, max_distance, lemmatizer)``.

    Accepted sources:

    * ``ShardedSearchService`` — every live shard view, the corpus-global
      FL-list, the service's lemmatizer;
    * ``IncrementalIndexer`` — its live multi-segment view;
    * plain ``IndexSet`` (or ``SegmentedIndexSet``) — itself.

    Views are resolved *per call*: planning immediately after a commit or
    compact sees the new generation.
    """
    shards = getattr(source, "shards", None)
    if shards is not None:  # ShardedSearchService
        return (
            list(shards),
            source.fl,
            source.max_distance,
            getattr(source, "lemmatizer", None),
        )
    if isinstance(source, IncrementalIndexer):
        view = source.index
        return [view], view.fl, source.max_distance, source.lemmatizer
    return [source], source.fl, source.max_distance, None


class QueryPlanner:
    """§5 planning front-half: classify, select keys, bind, cost, prune.

    Planning reads posting-list *lengths* from the live view, which on a
    ``SegmentedIndexSet`` forces (and caches) exactly the per-key merges that
    execution will reuse — the probe is a prefetch, not duplicated work.
    Exactness: plans carry the same ``select_keys`` output the unplanned
    engines compute, so executing a plan is fragment-identical to the
    unplanned path (``tests/test_planner.py``).
    """

    def __init__(self, source, lemmatizer: Lemmatizer | None = None):
        self._source = source
        src_lem = resolve_index_views(source)[3]
        self.lemmatizer = lemmatizer or src_lem or Lemmatizer()

    def plan(
        self,
        query: str,
        views: Sequence[IndexSet] | None = None,
        generation: object = None,
    ) -> QueryPlan:
        """Build the executable plan for ``query`` against the live view.

        ``views`` overrides the source-resolved live views (the frontend
        passes its posting-cache-wrapped views here so the cost probe warms
        the cache); ``generation`` stamps the plan's validity token.
        """
        t0 = time.perf_counter()
        if views is None:
            views, fl, _, _ = resolve_index_views(self._source)
        else:
            views = list(views)
            fl = views[0].fl if views else resolve_index_views(self._source)[1]
        if generation is None:
            generation = generation_token(self._source)

        plan = QueryPlan(query=query, subqueries=[], generation=generation)
        for sub in expand_subqueries(query, self.lemmatizer):
            plan.subqueries.append(self._plan_subquery(sub, fl, views))
        plan.plan_sec = time.perf_counter() - t0
        return plan

    def _plan_subquery(
        self, sub: Subquery, fl: FLList, views: Sequence[IndexSet]
    ) -> SubqueryPlan:
        keys = tuple(select_keys(sub, fl))
        lemma_types = classify_lemmas(sub.lemmas, fl)
        bindings: list[KeyBinding] = []
        supply: dict[str, int] = {l: 0 for l in sub.unique_lemmas()}
        for key in keys:
            n_rows = 0
            n_bytes = 0
            for view in views:
                if getattr(view, "n_docs", 0) == 0:
                    continue  # empty shard: engines short-circuit it too
                rows = view.key_postings(key.components)
                n_rows += len(rows)
                n_bytes += int(getattr(rows, "nbytes", len(rows) * _POSTING_BYTES))
            bindings.append(
                KeyBinding(
                    key=key,
                    family=key_family(key, fl),
                    est_postings=n_rows,
                    est_bytes=n_bytes,
                )
            )
            for _slot, lemma in key.active_components():
                supply[lemma] += n_rows
        pruned, reason = False, ""
        if not keys:
            pruned, reason = True, "empty subquery"
        else:
            for lemma, n in supply.items():
                if n == 0:
                    pruned = True
                    reason = f"no postings supply lemma {lemma!r}"
                    break
        return SubqueryPlan(
            subquery=sub,
            keys=keys,
            bindings=tuple(bindings),
            lemma_types=lemma_types,
            est_postings=sum(b.est_postings for b in bindings),
            est_bytes=sum(b.est_bytes for b in bindings),
            pruned=pruned,
            prune_reason=reason,
        )


def execute_plans(
    plans: Sequence[QueryPlan],
    views: Sequence[IndexSet],
    *,
    max_distance: int,
    top_k: int = 10,
    doc_len: int = 512,
    use_kernel: bool = False,
    compute_dtype: str = "uint8",
    admitted: Sequence[Sequence[SubqueryPlan]] | None = None,
    residencies: dict | None = None,
    defer: bool = False,
    device="cuda",
) -> list:
    """Execute a batch of plans as ONE fused device dispatch (§5 stage 3–4).

    ``admitted[qi]`` optionally restricts query ``qi`` to a subquery subset
    (the frontend's deadline admission); default is every executable
    subquery.  Each subquery carries its plan's key bindings into the batch
    packer, so execution reads exactly the costed postings.  ``residencies``
    maps ``id(view)`` to a posting-arena residency (DESIGN.md §13): work
    items of resident views run in the arena program on the arena's
    device, the rest on ``device``.  Returns ``QueryResponse`` objects
    whose fragment sets are byte-identical to the unplanned engines over the
    admitted subqueries (exactness pinned by ``tests/test_planner.py``);
    ranking is ``rank_documents`` over the exact fragment union, identical
    to ``SearchEngine``.

    ``defer=True`` returns a zero-argument *finalize* callable instead: the
    device program is submitted but not awaited, and calling it performs
    the readout and builds the responses — the DESIGN.md §15.2 hook the
    frontend's two-deep pipeline uses to overlap batch N's compute with
    batch N+1's plan/pack/H2D.
    """
    from .engine import QueryResponse, RankedDoc

    t0 = time.perf_counter()
    if admitted is None:
        admitted = [plan.executable() for plan in plans]
    per_stats = [QueryStats() for _ in plans]
    work = [
        [(sp.subquery, view, sp.keys) for sp in subs for view in views]
        for subs in admitted
    ]
    batch_stats = QueryStats()
    pending = serve_query_batch(
        work,
        max_distance=max_distance,
        top_k=top_k,
        doc_len=doc_len,
        use_kernel=use_kernel,
        compute_dtype=compute_dtype,
        stats=per_stats,
        batch_stats=batch_stats,
        residencies=residencies,
        defer=defer,
        device=device,
    )

    def finalize() -> list:
        result = pending.result() if defer else pending
        for st in per_stats:
            # batch-level quantities: one shared dispatch/transfer, assigned
            # (not accumulated) per query so aggregation never over-counts
            st.device_dispatches = batch_stats.device_dispatches
            st.h2d_bytes = batch_stats.h2d_bytes
        elapsed = time.perf_counter() - t0
        responses = []
        for qi, plan in enumerate(plans):
            fragments = result.per_query[qi]
            docs = [
                RankedDoc(doc_id=d, score=s, fragments=f)
                for d, s, f in rank_documents(fragments, top_k=top_k)
            ]
            st = per_stats[qi]
            st.results = len(fragments)
            st.pruned_subqueries = plan.n_pruned
            n_admitted = len(admitted[qi])
            st.skipped_subqueries = len(plan.executable()) - n_admitted
            st.partial = st.skipped_subqueries > 0
            st.elapsed_sec = elapsed  # batch wall time (one shared dispatch)
            responses.append(
                QueryResponse(
                    query=plan.query,
                    docs=docs,
                    stats=st,
                    n_subqueries=len(plan.subqueries),
                )
            )
        return responses

    if defer:
        return finalize
    return finalize()
