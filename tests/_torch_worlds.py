"""Run a function in every rank of a gloo world of CPU processes.

``run_world(n, "module:function", payload, tmp_path)`` starts ``n``
processes (``python tests/_torch_worlds.py``), each of which joins one
process group (``file://`` rendezvous under ``tmp_path``, so concurrent
worlds never share a port), calls ``function(payload)`` from the tests'
directory and saves what it returns; the list of the ranks' results comes
back.  A rank's failure fails the call with its error output.  ``backend``
is the process group's (gloo by default; a world on the card may run
NCCL).  The ranks, and ``run_reference``'s subprocess, run at a lower CPU
priority (nice 10): the test workers beside them run timing-sensitive
tests (hypothesis deadlines), which a world's busy ranks must not starve.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
NICE = 10


def run_world(n: int, target: str, payload, tmp_path: Path, timeout: float = 600, backend: str = "gloo") -> list:
    tmp_path = Path(tmp_path)
    tmp_path.mkdir(parents=True, exist_ok=True)
    torch.save(payload, tmp_path / "payload.pt")
    init = tmp_path / "rendezvous"
    path = [str(SRC), str(HERE), os.getcwd(), *filter(None, os.environ.get("PYTHONPATH", "").split(os.pathsep))]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(path), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(Path(__file__)), target, str(init), str(r), str(n), str(tmp_path),
                               backend],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    errors = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode != 0:
            errors.append(f"rank {r} exited {p.returncode}:\n{err[-4000:]}")
    if errors:
        raise AssertionError("\n".join(errors))
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(n)]


def _main(target: str, init: str, rank: int, world: int, tmp: str, backend: str) -> None:
    import torch.distributed as dist

    os.nice(NICE)
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init}", rank=rank, world_size=world)
    try:
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        out = fn(torch.load(Path(tmp) / "payload.pt", weights_only=False))
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    finally:
        if dist.is_initialized():  # a launcher under test may have torn it down
            dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])


def run_reference(code: str, n_devices: int, tmp_path: Path, timeout: float = 600, inputs: dict | None = None) -> dict:
    """Run ``code`` (the reference, in jax) in a subprocess on a forced host
    mesh of ``n_devices`` CPU devices; the code saves its results with
    ``numpy.savez(OUT, ...)`` (``OUT`` is defined for it, and ``INPUTS``,
    the path of ``inputs`` saved with ``numpy.savez``).  Returns them."""
    import numpy as np

    tmp_path = Path(tmp_path)
    tmp_path.mkdir(parents=True, exist_ok=True)
    out = tmp_path / "reference.npz"
    script = tmp_path / "reference.py"
    np.savez(tmp_path / "inputs.npz", **(inputs or {}))
    script.write_text(f"import os\nos.nice({NICE})\nOUT = {str(out)!r}\nINPUTS = {str(tmp_path / 'inputs.npz')!r}\n"
                      + code)
    # one compute thread, as each world rank has: the subprocess beside the
    # test workers must not take every core
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={n_devices} --xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1"}
    r = subprocess.run([sys.executable, str(script)], env=env, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    with np.load(out, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


_IN_SPECS = r"""
import dataclasses
import json
import numpy as np, jax
from jax.sharding import PartitionSpec as P
from repro.configs import get_reduced_spec
from repro.launch.steps import build_cell
from repro.parallel.sharding import _path_str
res = {}
for mesh_shape, arch, cell, changes in json.loads(%r):
    key = json.dumps([mesh_shape, arch, cell, changes])
    n = int(np.prod(mesh_shape))
    mesh = jax.make_mesh(tuple(mesh_shape), ("data", "model"), devices=jax.devices()[:n])
    spec = get_reduced_spec(arch)
    cfg = spec.model_cfg
    if "moe" in changes:
        changes["moe"] = dataclasses.replace(cfg.moe, **changes["moe"])
    spec = dataclasses.replace(spec, model_cfg=dataclasses.replace(cfg, **changes))
    flat = []
    for tree in build_cell(spec, cell, mesh).in_specs:
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P) or x is None)
        flat.append({_path_str(p): list(s) for p, s in leaves})
    res[key] = flat
np.savez(OUT, specs=np.array(json.dumps(res)))
"""


def reference_in_specs(cells: list, n_devices: int, tmp_path: Path) -> dict:
    """The reference's ``in_specs`` of each ``(mesh shape, arch, cell,
    config changes)`` of its reduced specs, built on a forced host mesh of
    that shape (the first devices of ``n_devices``): per argument, a dict
    of path -> spec entries (lists), keyed by ``spec_key``."""
    import json

    cells = [[list(m), a, c, ch] for m, a, c, ch in cells]
    out = run_reference(_IN_SPECS % (json.dumps(cells),), n_devices, tmp_path)
    return json.loads(str(out["specs"]))


def spec_key(mesh, arch: str, cell: str, changes: dict) -> str:
    import json

    return json.dumps([list(mesh), arch, cell, json.loads(json.dumps(changes, default=str))])
