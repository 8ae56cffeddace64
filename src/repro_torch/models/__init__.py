"""The LM, GNN and recsys families of the reference's ``repro/models``:
shared layers, the decoder-only transformer with its MoE FFN, the graph
attention network, the four recsys models, and the converter that carries
the reference's parameters and optimizer state across."""

from . import gnn, layers, moe, recsys, transformer
from .gnn import GATConfig
from .moe import MoEConfig
from .recsys import RecsysConfig
from .transformer import TransformerConfig

__all__ = ["gnn", "layers", "moe", "recsys", "transformer", "GATConfig", "MoEConfig", "RecsysConfig",
           "TransformerConfig"]
