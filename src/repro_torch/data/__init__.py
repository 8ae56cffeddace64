"""Deterministic, checkpointable data pipelines and the GNN graph utilities
(copies of the reference's numpy-only ``repro/data/pipeline.py`` and
``repro/data/sampler.py``: the same seed gives the same batches, bit for
bit)."""

from .pipeline import LMTokenPipeline, PipelineState, RecsysBatchPipeline
from .sampler import CSRGraph, NeighborSampler, random_graph

__all__ = ["PipelineState", "LMTokenPipeline", "RecsysBatchPipeline", "CSRGraph", "NeighborSampler",
           "random_graph"]
