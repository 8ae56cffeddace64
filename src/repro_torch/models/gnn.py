"""Graph attention network (GAT, Veličković et al. 2018) in PyTorch: the
reference's ``repro/models/gnn.py`` on one device.

Message passing over an edge list, as the reference builds it from segment
ops:

    SDDMM  (edge scores)  -> gather src/dst + add          (attention logits)
    edge-softmax          -> segment max / segment sum     (per destination)
    SpMM   (aggregate)    -> weighted gather + segment sum

The segment max is ``scatter_reduce(..., "amax", include_self=False)`` on a
``-inf``-filled tensor (its index an expanded view of ``dst``): a node with
no incoming edge keeps ``-inf``, which the layer maps to 0, as
``jax.ops.segment_max`` gives it.  The max only shifts the exponent, so it
is taken detached: its gradient is zero.  Segment sums are
``index_add``; they sum in another order than ``segment_sum``, so float32
results agree with the reference's within rounding, not bit for bit.
Padded edges point at node 0 (``src = dst = 0``) with mask 0 and still enter
every scatter, with zeroed values.

The aggregate ``segment_sum(ex[..., None] * h[src], dst)`` runs over chunks
of edges (:func:`aggregate`): each chunk gathers, weights and ``index_add``s
into node space, and the backward recomputes each chunk, so no ``[E, H, D]``
tensor is ever whole.  At ogbn-products' shape (61.9M edges, 8 heads, 47
classes) the reference's form would hold two 93 GB tensors in layer 2.  The
chunk follows from the device's memory (:func:`edge_chunk`); the unchunked
form, :func:`aggregate_plain`, is kept to hold it to.

Node classification (Cora / Reddit-minibatch / ogbn-products) and graph
classification (batched small molecules, mean-pooled over ``graph_ids``)
through ``task``.

In a world of ranks (``shards``, a :class:`GATShards`) each rank holds a
block of the edge list (``src``, ``dst``, ``edge_mask``; the reference's
edges over the flattened ``(data, model)`` axes) and, with ``nodes``, its
data rank's block of ``x``, ``labels`` and ``label_mask``.  Per layer the
rank scores its edges; the segment max is all-reduced (``MAX``) over the
edge axes before the exp, so every rank shifts by the global maximum and
the partial sums combine; ``denom`` and ``msg`` are summed over them
(``reduce_from``).  The replicated ``h``, ``al_src`` and ``al_dst`` enter
the edge work through ``copy_to``, whose backward sums their gradients over
every rank: each rank's gradient of the (replicated) parameters is then the
whole graph's, with no sum over the data axes after it.  Node rows of ``x``
are projected by their data rank and gathered (``gather_from``: the
gradient of ``h`` is whole on every rank already), with the layer's ``w``
behind ``copy_to`` over ``data``; the loss and accuracy over node rows are
sums and counts all-reduced over ``data``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..parallel.collectives import all_reduce, copy_to, gather_from, reduce_from
from .layers import dense_init

__all__ = ["GATConfig", "GATShards", "init_gat_params", "gat_param_shapes", "gat_forward", "gat_loss", "aggregate",
           "aggregate_plain", "edge_chunk"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_feat: int = 1433
    n_classes: int = 7
    task: str = "node"  # "node" | "graph"
    negative_slope: float = 0.2
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def layer_dims(self) -> list[tuple[int, int]]:
        """(fan_in, out_per_head) per layer; last layer maps to classes."""
        dims = []
        fan_in = self.d_feat
        for i in range(self.n_layers - 1):
            dims.append((fan_in, self.d_hidden))
            fan_in = self.d_hidden * self.n_heads
        dims.append((fan_in, self.n_classes))
        return dims

    def param_count(self) -> int:
        total = 0
        for fi, do in self.layer_dims():
            total += fi * self.n_heads * do + 2 * self.n_heads * do
        return total


@dataclasses.dataclass(frozen=True)
class GATShards:
    """What a rank of ``mesh`` holds of a batch: ``edges``, the mesh axes
    its edge list is a block of (``None``: every edge); ``nodes``, whether
    ``x``, ``labels`` and ``label_mask`` are its block of rows over
    ``data`` (a node task's)."""

    mesh: Any
    edges: Any = None
    nodes: bool = False


def _layout(cfg: GATConfig) -> list[dict[str, tuple[int, ...]]]:
    return [{"w": (fi, cfg.n_heads, do), "a_src": (cfg.n_heads, do), "a_dst": (cfg.n_heads, do)}
            for fi, do in cfg.layer_dims()]


def init_gat_params(key: int | torch.Generator, cfg: GATConfig, *, device="cuda") -> list[dict[str, Any]]:
    """Random parameters from ``key`` (a seed, or a ``torch.Generator`` on
    ``device``), each ``dense_init`` (N(0, 1) x ``shape[-2] ** -0.5``, as in
    the reference), in ``cfg.dtype``: a list of ``{w [F, H, D], a_src [H,
    D], a_dst [H, D]}``, one a layer.  The reference draws from
    ``jax.random``: ``models/convert.py`` carries its parameters across."""
    dev = torch.device(device)
    gen = key if isinstance(key, torch.Generator) else torch.Generator(device=dev).manual_seed(key)
    return [{k: dense_init(gen, shape, cfg.torch_dtype) for k, shape in layer.items()} for layer in _layout(cfg)]


def gat_param_shapes(cfg: GATConfig) -> list[dict[str, torch.Tensor]]:
    """``init_gat_params``'s tree as ``device="meta"`` tensors."""
    return [{k: torch.empty(shape, dtype=cfg.torch_dtype, device="meta") for k, shape in layer.items()}
            for layer in _layout(cfg)]


# the bytes one [chunk, H, D] tensor of the aggregate may take: a 64th of
# the card's memory (1.25 GB on an 80 GB card; the forward holds two such
# tensors at a time, the backward four), 256 MiB on the host
_CHUNK_SHARE = 64
_HOST_CHUNK_BYTES = 256 << 20


def edge_chunk(n_edges: int, n_heads: int, width: int, device, itemsize: int = 4) -> int:
    """Edges a chunk of :func:`aggregate` takes on ``device``: as many as
    keep one ``[chunk, n_heads, width]`` tensor within a 64th of the card's
    memory (256 MiB on the host), at least 1 and at most ``n_edges``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        budget = torch.cuda.get_device_properties(dev).total_memory // _CHUNK_SHARE
    else:
        budget = _HOST_CHUNK_BYTES
    return max(1, min(n_edges, budget // (n_heads * width * itemsize)))


class _Aggregate(torch.autograd.Function):
    """``segment_sum(ex[..., None] * h[src], dst, n)`` over chunks of
    ``chunk`` edges; the backward recomputes each chunk's gathers."""

    @staticmethod
    def forward(ctx, ex, h, src, dst, chunk):
        ctx.save_for_backward(ex, h, src, dst)
        ctx.chunk = chunk
        msg = h.new_zeros(h.shape)
        for s in range(0, src.shape[0], chunk):
            msg.index_add_(0, dst[s : s + chunk], h.index_select(0, src[s : s + chunk]) * ex[s : s + chunk, :, None])
        return msg

    @staticmethod
    def backward(ctx, g_msg):
        ex, h, src, dst = ctx.saved_tensors
        chunk = ctx.chunk
        g_ex = torch.empty_like(ex) if ctx.needs_input_grad[0] else None
        g_h = torch.zeros_like(h) if ctx.needs_input_grad[1] else None
        g_msg = g_msg.contiguous()
        for s in range(0, src.shape[0], chunk):
            g = g_msg.index_select(0, dst[s : s + chunk])  # [c, H, D]
            if g_ex is not None:
                g_ex[s : s + chunk] = (g * h.index_select(0, src[s : s + chunk])).sum(-1)
            if g_h is not None:
                g_h.index_add_(0, src[s : s + chunk], g * ex[s : s + chunk, :, None])
        return g_ex, g_h, None, None, None


def aggregate(ex: torch.Tensor, h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              chunk: int | None = None) -> torch.Tensor:
    """``msg[n] = sum over edges e with dst[e] = n of ex[e, :, None] *
    h[src[e]]``: ``[N, H, D]`` from ``ex [E, H]`` and ``h [N, H, D]``, over
    chunks of ``chunk`` edges (default :func:`edge_chunk` on ``h``'s
    device).  Differentiable in ``ex`` and ``h``."""
    if chunk is None:
        chunk = edge_chunk(src.shape[0], h.shape[1], h.shape[2], h.device, h.element_size())
    return _Aggregate.apply(ex, h, src, dst, max(1, int(chunk)))


def aggregate_plain(ex: torch.Tensor, h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """:func:`aggregate` unchunked, as the reference writes it: one ``[E, H,
    D]`` product, scattered in one ``index_add``."""
    return h.new_zeros(h.shape).index_add(0, dst, ex[..., None] * h.index_select(0, src))


def _gat_layer(
    x: torch.Tensor,  # [N, F] (with ``rows``: this data rank's [N / data, F])
    layer: dict[str, Any],
    src: torch.Tensor,  # [E] int64 (padded edges -> 0 with mask 0)
    dst: torch.Tensor,  # [E]
    edge_mask: torch.Tensor,  # [E] 0/1
    n_nodes: int,
    *,
    negative_slope: float,
    final: bool,
    edge_chunk: int | None,
    shards: GATShards | None = None,
    rows: bool = False,
) -> torch.Tensor:
    w, a_src, a_dst = layer["w"], layer["a_src"], layer["a_dst"]
    fi, nh, d = w.shape
    mesh = None if shards is None else shards.mesh
    if rows:
        # each data rank projects its rows (a partial over data of w's
        # gradient, summed by copy_to); h is gathered whole
        w = copy_to(w, mesh, "data")
        h = gather_from((x @ w.reshape(fi, nh * d)).view(-1, nh, d), mesh, "data", 0)
    else:
        h = (x @ w.reshape(fi, nh * d)).view(n_nodes, nh, d)  # [N, H, D]
    al_src = (h * a_src[None]).sum(-1)  # [N, H]
    al_dst = (h * a_dst[None]).sum(-1)
    edges = None if shards is None else shards.edges
    if edges is not None:
        h, al_src, al_dst = (copy_to(t, mesh, edges) for t in (h, al_src, al_dst))
    e = al_src.index_select(0, src) + al_dst.index_select(0, dst)  # SDDMM: [E, H]
    e = F.leaky_relu(e, negative_slope)
    e = torch.where(edge_mask[:, None] > 0, e, torch.tensor(-1e9, dtype=e.dtype, device=e.device))
    # segment softmax over incoming edges of each destination
    m = e.new_full((n_nodes, nh), float("-inf")).scatter_reduce(
        0, dst[:, None].expand(-1, nh), e.detach(), "amax", include_self=False)
    if edges is not None:
        # every rank shifts by the global maximum, so the partial sums combine
        m = all_reduce(m, mesh, edges, dist.ReduceOp.MAX)
    m = torch.where(torch.isfinite(m), m, 0.0)
    ex = torch.exp(e - m.index_select(0, dst)) * edge_mask[:, None].to(e.dtype)
    denom = reduce_from(ex.new_zeros((n_nodes, nh)).index_add(0, dst, ex), mesh, edges)  # [N, H]
    msg = reduce_from(aggregate(ex, h, src, dst, edge_chunk), mesh, edges)
    out = msg / denom.clamp_min(1e-9)[..., None]  # [N, H, D]
    if final:
        return out.mean(dim=1)  # average heads -> [N, n_classes]
    return F.elu(out.reshape(n_nodes, -1))  # concat heads


def _rows_split(shards: GATShards | None) -> bool:
    return shards is not None and shards.nodes and shards.mesh.axis_size("data") > 1


def gat_forward(params, batch: dict[str, torch.Tensor], cfg: GATConfig, n_graphs: int = 1, *,
                edge_chunk: int | None = None, shards: GATShards | None = None) -> torch.Tensor:
    """batch: {x [N,F], src [E], dst [E], edge_mask [E], (graph_ids [N])};
    ``edge_chunk`` edges a chunk of the aggregate (default: from the
    device's memory); ``shards``: this rank's blocks of the batch.  Every
    rank returns the whole graph's logits."""
    x = batch["x"].to(cfg.torch_dtype)
    rows = _rows_split(shards)
    n_nodes = x.shape[0] * (shards.mesh.axis_size("data") if rows else 1)
    src, dst = batch["src"].long(), batch["dst"].long()
    for i, layer in enumerate(params):
        x = _gat_layer(
            x, layer, src, dst, batch["edge_mask"], n_nodes,
            negative_slope=cfg.negative_slope,
            final=(i == len(params) - 1),
            edge_chunk=edge_chunk,
            shards=shards,
            rows=rows and i == 0,
        )
    if cfg.task == "graph":
        # mean-pool node logits per graph (batched small molecules)
        gid = batch["graph_ids"].long()  # [N]
        num = x.new_zeros((n_graphs, x.shape[1])).index_add(0, gid, x)
        cnt = x.new_zeros((n_graphs, 1)).index_add(0, gid, x.new_ones((n_nodes, 1)))
        return num / cnt.clamp_min(1.0)
    return x  # [N, n_classes]


def gat_loss(params, batch: dict[str, torch.Tensor], cfg: GATConfig, n_graphs: int = 1, *,
             edge_chunk: int | None = None, shards: GATShards | None = None) -> tuple[torch.Tensor, dict]:
    """The masked mean NLL and accuracy; with ``shards.nodes`` (a node
    task), over every data rank's block of the labels."""
    logits = gat_forward(params, batch, cfg, n_graphs=n_graphs, edge_chunk=edge_chunk, shards=shards).float()
    labels = batch["labels"].long()
    mask = batch["label_mask"].float()
    split = _rows_split(shards)
    if split:
        # this data rank's rows of the (replicated) logits: their gradients
        # from every data rank are summed by copy_to
        mesh = shards.mesh
        logits = copy_to(logits, mesh, "data").narrow(0, mesh.coord("data") * labels.shape[0], labels.shape[0])
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    nll = (logz - gold) * mask
    acc = ((logits.argmax(dim=-1) == labels).float() * mask).sum()
    total, count = nll.sum(), mask.sum()
    if split:
        total = reduce_from(total, mesh, "data")
        acc, count = (all_reduce(t, mesh, "data") for t in (acc, count))
    denom = count.clamp_min(1.0)
    return total / denom, {"acc": acc / denom}
