"""Deterministic, checkpointable data pipelines (a copy of the reference's
numpy-only ``repro/data/pipeline.py``: the same seed gives the same
batches, bit for bit)."""

from .pipeline import LMTokenPipeline, PipelineState, RecsysBatchPipeline

__all__ = ["PipelineState", "LMTokenPipeline", "RecsysBatchPipeline"]
