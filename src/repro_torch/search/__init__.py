from .engine import QueryResponse, RankedDoc, SearchEngine
from .frontend import PostingCache, SearchRequest, ServingFrontend
from .planner import KeyBinding, QueryPlan, QueryPlanner, SubqueryPlan, execute_plans
from .relevance import fragment_score, rank_documents

__all__ = [
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
]
