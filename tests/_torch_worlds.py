"""Run a function in every rank of a gloo world of CPU processes.

``run_world(n, "module:function", payload, tmp_path)`` starts ``n``
processes (``python tests/_torch_worlds.py``), each of which joins one
process group (``file://`` rendezvous under ``tmp_path``, so concurrent
worlds never share a port), calls ``function(payload)`` from the tests'
directory and saves what it returns; the list of the ranks' results comes
back.  A rank's failure fails the call with its error output.  ``backend``
is the process group's (gloo by default; a world on the card may run
NCCL).
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
    script.write_text(f"OUT = {str(out)!r}\nINPUTS = {str(tmp_path / 'inputs.npz')!r}\n" + code)
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={n_devices}"}
    r = subprocess.run([sys.executable, str(script)], env=env, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    with np.load(out, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
