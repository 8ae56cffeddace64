"""The dense LM family of the reference's ``repro/models``: shared layers,
the decoder-only transformer, and the converter that carries the
reference's parameters and optimizer state across."""

from . import layers, transformer
from .transformer import TransformerConfig

__all__ = ["layers", "transformer", "TransformerConfig"]
