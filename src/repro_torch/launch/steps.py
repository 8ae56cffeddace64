"""Cell builder: (architecture, shape) -> step function + abstract inputs.

The search half of the reference's ``launch/steps.py``: the ``paper_search``
cells.  The abstract inputs are ``device="meta"`` tensors, which carry the
reference's shapes and dtypes and allocate nothing (the counterpart of
``jax.ShapeDtypeStruct``).  The reference also gives each cell partition
specs over its device mesh; on one card there is no mesh, and the layout's
size only sets the number of cluster shards a serve cell folds into one
program (``search/serving_step.serve_step_sharded``).  The lm, gnn and recsys
families are seed scaffolding off the search path and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.common import ArchSpec, ShapeCell
from ..search.serving_step import build_step, serve_step_sharded
from .mesh import MeshLayout

__all__ = ["Cell", "build_cell", "input_specs"]


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    step: str
    fn: Callable  # positional args match `abstract_args`
    abstract_args: tuple
    model_flops_fn: Callable[[], float]  # useful-work model
    notes: str = ""


def _search_cell(spec: ArchSpec, cell: ShapeCell, mesh: MeshLayout) -> Cell:
    cfg = spec.model_cfg
    if cell.step == "serve":
        b = cell.kwargs["batch"]
        p = cell.kwargs["postings"]
        c = cell.kwargs["clusters"]
        l, n, d = cfg.n_lemmas, cfg.window_len, cfg.max_distance
        # document/cluster-sharded layout (§Perf-3): every shard owns one
        # cluster shard's postings end-to-end
        ns = mesh.size
        c_loc = max(1, -(-max(c, ns) // ns))
        p_loc = max(1, -(-p // ns))
        args = (
            _meta((ns, b, p_loc, 3), torch.int32),
            _meta((ns, b, c_loc), torch.int32),
            _meta((b, l), torch.int32),
        )

        def fn(postings, cluster_doc, mult):
            return serve_step_sharded(
                postings, cluster_doc, mult,
                max_distance=d, n_clusters=c_loc, window_len=n, top_k=cfg.top_k,
            )

        # useful work: the window cover — (2D+1) window steps x L lemmas x N
        flops = float(b) * ns * c_loc * (2 * d + 1) * l * n * 4.0
        return Cell(
            arch_id=spec.arch_id, shape_name=cell.name, step="serve",
            fn=fn, abstract_args=args, model_flops_fn=lambda: flops,
        )

    docs, doc_len = cell.kwargs["docs"], cell.kwargs["doc_len"]
    d = cfg.max_distance
    args = (_meta((docs, doc_len), torch.int32), _meta((docs, doc_len), torch.bool))

    def fn(tokens, is_stop):
        return build_step(tokens, is_stop, max_distance=d, n_buckets=cfg.build_buckets)

    n_off = d * (2 * d - 1)
    flops = float(docs) * doc_len * n_off * 6.0
    return Cell(
        arch_id=spec.arch_id, shape_name=cell.name, step="build",
        fn=fn, abstract_args=args, model_flops_fn=lambda: flops,
    )


def build_cell(spec: ArchSpec, shape_name: str, mesh: MeshLayout) -> Cell:
    cell = spec.shapes[shape_name]
    if spec.family == "search":
        return _search_cell(spec, cell, mesh)
    if spec.family in ("lm", "gnn", "recsys"):
        raise NotImplementedError(
            f"{spec.family} cells are seed scaffolding off the search path: not ported to repro_torch"
        )
    raise ValueError(spec.family)


def input_specs(arch_id: str, shape_name: str, mesh: MeshLayout | None = None) -> tuple[Any, ...]:
    """Public helper (dry-run contract): ``device="meta"`` stand-ins for every
    input of the (architecture x shape) cell — the reference's shapes and
    dtypes, no allocation."""
    from ..configs import get_spec
    from .mesh import make_production_mesh

    if mesh is None:
        mesh = make_production_mesh()
    return build_cell(get_spec(arch_id), shape_name, mesh).abstract_args
