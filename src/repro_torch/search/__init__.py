from .distributed import ShardedSearchService, device_topk_merge, shard_documents
from .engine import ALGORITHMS, QueryResponse, RankedDoc, SearchEngine
from .frontend import PostingCache, SearchRequest, ServingFrontend
from .planner import KeyBinding, QueryPlan, QueryPlanner, SubqueryPlan, execute_plans
from .relevance import fragment_score, rank_documents
from .service import (
    ReplicatedServiceDaemon,
    RequestHandle,
    ServiceDaemon,
    Ticket,
    request_over_tcp,
    serve_tcp,
)
from .vectorized import PackedEvents, VectorizedEngine, pack_subquery_events

__all__ = [
    "ALGORITHMS",
    "SearchEngine",
    "RankedDoc",
    "QueryResponse",
    "fragment_score",
    "rank_documents",
    "QueryPlanner",
    "QueryPlan",
    "SubqueryPlan",
    "KeyBinding",
    "execute_plans",
    "ServingFrontend",
    "SearchRequest",
    "PostingCache",
    "ServiceDaemon",
    "ReplicatedServiceDaemon",
    "RequestHandle",
    "Ticket",
    "serve_tcp",
    "request_over_tcp",
    "ShardedSearchService",
    "shard_documents",
    "device_topk_merge",
    "VectorizedEngine",
    "PackedEvents",
    "pack_subquery_events",
]
