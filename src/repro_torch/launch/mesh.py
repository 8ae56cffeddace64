"""Production layouts, and the device mesh a world of ranks runs under.

The reference builds ``jax.make_mesh`` meshes over 256 or 512 TPU chips and
shards the ``paper_search`` serve cells' cluster axis over every device.  A
layout here is a mesh's shape, axis names and size: ``launch/steps.py``
reads the size as the number of cluster shards (NS), which the serve cells
keep whatever the world's size.

Single pod: (data=16, model=16) — 256 shards.
Multi-pod:  (pod=2, data=16, model=16) — 512 shards.

:func:`make_device_mesh` is the mesh a world of ranks runs on: a
``torch.distributed`` ``DeviceMesh`` with the reference's axis names over an
initialised process group, each axis's group, size and this rank's
coordinate.  The reference reads its mesh from
``jax.sharding.get_abstract_mesh()``; the port passes a mesh explicitly or
sets it for a block with ``with use_mesh(mesh):``, which the model code
reads through :func:`current_mesh`.  With no mesh set (or a mesh of one
rank) every model runs as on one card.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import math
import os
from typing import Any, Iterator

import torch

__all__ = [
    "MeshLayout",
    "DeviceMesh",
    "make_production_mesh",
    "make_smoke_mesh",
    "make_device_mesh",
    "parse_mesh",
    "use_mesh",
    "current_mesh",
    "MESH_AXES",
]

MESH_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's shape and axis names; ``size`` is its number of shards."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    if multi_pod:
        return MeshLayout((2, 16, 16), ("pod", "data", "model"))
    return MeshLayout((16, 16), ("data", "model"))


def make_smoke_mesh() -> MeshLayout:
    """One-shard layout with the production axis names (CPU tests)."""
    return MeshLayout((1, 1), ("data", "model"))


@dataclasses.dataclass(eq=False)
class DeviceMesh:
    """A mesh of the world's ranks, row-major over ``axis_names`` (rank r's
    coordinates are ``numpy.unravel_index(r, shape)``).  ``group(axes)`` is
    the process group of the ranks that differ from this one only along
    ``axes`` (a name or a tuple of names), its ranks in coordinate order."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    backend: str
    device: torch.device
    rank: int
    torch_mesh: Any
    _groups: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def coords(self) -> dict[str, int]:
        out, r = {}, self.rank
        for name, n in zip(reversed(self.axis_names), reversed(self.shape)):
            out[name] = r % n
            r //= n
        return {a: out[a] for a in self.axis_names}

    @staticmethod
    def _names(axes) -> tuple[str, ...]:
        if axes is None:
            return ()
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def axis_size(self, axes) -> int:
        sizes = dict(zip(self.axis_names, self.shape))
        return math.prod(sizes[a] for a in self._names(axes))

    def coord(self, axes) -> int:
        """This rank's index along ``axes`` (row-major over them)."""
        c, sizes = 0, dict(zip(self.axis_names, self.shape))
        for a in self._names(axes):
            c = c * sizes[a] + self.coords[a]
        return c

    def group(self, axes):
        return self._groups[tuple(a for a in self.axis_names if a in self._names(axes))]

    def __str__(self) -> str:
        return "x".join(str(s) for s in self.shape)


def _subgroups(shape: tuple[int, ...], keep: tuple[int, ...]) -> list[list[int]]:
    """Rank lists of the groups along the dims ``keep``: one list for each
    point of the other dims, ranks in row-major order."""
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    other = [d for d in range(len(shape)) if d not in keep]
    perm = ranks.permute(*other, *keep).reshape(-1, math.prod(shape[d] for d in keep))
    return [row.tolist() for row in perm]


def make_device_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...], *, backend: str,
                     device="cuda", init_method: str | None = None) -> DeviceMesh:
    """The mesh of ``shape`` over the world's ranks: initialises the default
    process group with ``backend`` (``"nccl"`` or ``"gloo"``) from
    ``init_method`` (default ``env://``, as ``torch.distributed.run``
    sets it) unless one is up, in which case it must run ``backend``; then
    the ``DeviceMesh`` and one group for every non-empty set of axes.
    Every rank of the world must call it, in the same order."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh as TorchDeviceMesh

    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axes {axis_names} differ in length")
    dev = torch.device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend=backend, init_method=init_method or "env://")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} has {math.prod(shape)} ranks; the world has {world}")
    if dev.type == "cuda":
        # several ranks may share one card (the world's ranks modulo the cards)
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    torch_mesh = TorchDeviceMesh(dev.type, torch.arange(world).reshape(shape), mesh_dim_names=axis_names)
    groups = {}
    for n in range(1, len(shape) + 1):
        for keep in itertools.combinations(range(len(shape)), n):
            lists = _subgroups(shape, keep)
            mine = None
            for ranks in lists:  # every rank creates every group, in order
                # a group of the whole world is the default group, whichever
                # mesh and axes name it: one NCCL communicator (and its
                # buffers on the card) instead of one for each
                g = dist.group.WORLD if ranks == list(range(world)) else dist.new_group(ranks)
                if dist.get_rank() in ranks:
                    mine = g
            groups[tuple(axis_names[d] for d in keep)] = mine
    return DeviceMesh(shape, axis_names, backend, dev, dist.get_rank(), torch_mesh, groups)


def parse_mesh(text: str | None, world: int) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``--mesh DATAxMODEL`` (or ``PODxDATAxMODEL``) as (shape, axis names);
    ``None`` puts the whole world on ``data``."""
    if text is None:
        return (world, 1), ("data", "model")
    shape = tuple(int(x) for x in text.lower().split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(shape))
    if names is None:
        raise ValueError(f"--mesh {text!r}: DATAxMODEL or PODxDATAxMODEL")
    return shape, names


def world_from_env() -> int:
    """The world size ``torch.distributed.run`` gives this process (1 when
    it was not started by it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


_CURRENT: contextvars.ContextVar[DeviceMesh | None] = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh | None) -> Iterator[DeviceMesh | None]:
    """Run the block under ``mesh`` (what the reference's abstract mesh
    is); the previous mesh is back after it."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def current_mesh() -> DeviceMesh | None:
    """The mesh of the innermost ``use_mesh`` block, or ``None``."""
    return _CURRENT.get()
