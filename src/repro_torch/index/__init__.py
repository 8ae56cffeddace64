from .builder import IndexSet, build_indexes
from .convert import index_set_from_arrays
from .corpus import Document, DocumentStore, PAPER_EXAMPLE_DOCS, synthesize_corpus

__all__ = [
    "Document",
    "DocumentStore",
    "IndexSet",
    "PAPER_EXAMPLE_DOCS",
    "build_indexes",
    "index_set_from_arrays",
    "synthesize_corpus",
]
