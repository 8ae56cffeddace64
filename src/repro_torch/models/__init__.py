"""The LM and recsys families of the reference's ``repro/models``: shared
layers, the decoder-only transformer with its MoE FFN, the four recsys
models, and the converter that carries the reference's parameters and
optimizer state across."""

from . import layers, moe, recsys, transformer
from .moe import MoEConfig
from .recsys import RecsysConfig
from .transformer import TransformerConfig

__all__ = ["layers", "moe", "recsys", "transformer", "MoEConfig", "RecsysConfig", "TransformerConfig"]
