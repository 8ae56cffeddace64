from .builder import IndexSet, build_indexes, build_segment
from .convert import index_set_from_arrays
from .corpus import Document, DocumentStore, PAPER_EXAMPLE_DOCS, synthesize_corpus
from .incremental import (
    IncrementalIndexer,
    Segment,
    SegmentedIndexSet,
    as_index_set,
    generation_token,
    index_sets_equal,
)
from .store import (
    StoreError,
    StoredIndexSet,
    latest_snapshot,
    load_snapshot,
    save_snapshot,
)
from .wal import WalError, WalRecord, WriteAheadLog, read_frames, replay

__all__ = [
    "Document",
    "DocumentStore",
    "synthesize_corpus",
    "PAPER_EXAMPLE_DOCS",
    "IndexSet",
    "build_indexes",
    "build_segment",
    "index_set_from_arrays",
    "IncrementalIndexer",
    "Segment",
    "SegmentedIndexSet",
    "as_index_set",
    "generation_token",
    "index_sets_equal",
    "StoreError",
    "StoredIndexSet",
    "latest_snapshot",
    "load_snapshot",
    "save_snapshot",
    "WalError",
    "WalRecord",
    "WriteAheadLog",
    "read_frames",
    "replay",
]
