"""``runtime/elastic.py`` against the reference, and elastic checkpoints:
a train state saved by a world of ranks is the file a one-rank save writes,
byte for byte, and resumes in a world of another size.

Worlds of four and two gloo CPU ranks hold the reduced tinyllama's params
and AdamW state sharded under FSDP (``2x2``, then ``1x2``); the state was
trained one step by the reference's own train cell and carried across.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

from _lm_compare import ref_cfg, ref_params
from _torch_worlds import run_world
from repro.configs import get_reduced_spec as ref_get_reduced_spec
from repro.launch.steps import build_cell as ref_build_cell
from repro.optim import adamw_init as ref_adamw_init
from repro.runtime.elastic import ElasticTopology as RefElasticTopology
from repro_torch.checkpoint import latest_step, save_checkpoint
from repro_torch.models.convert import from_reference
from repro_torch.runtime import ElasticTopology
from _lm_compare import lm_batch


@pytest.mark.parametrize("cfg", [{}, {"chips_per_pod": 64, "model_parallel": 8, "global_batch": 96},
                                 {"chips_per_pod": 256, "model_parallel": 16, "global_batch": 200},
                                 {"chips_per_pod": 8, "model_parallel": 2, "global_batch": 7}])
def test_elastic_plan_equals_the_reference(cfg):
    for pods in range(1, 5):
        assert ElasticTopology(**cfg).plan(pods) == RefElasticTopology(**cfg).plan(pods)
    for topo in (ElasticTopology(**cfg), RefElasticTopology(**cfg)):
        with pytest.raises(RuntimeError, match="no healthy pods"):
            topo.plan(0)


@pytest.fixture(scope="module")
def state():
    """The reduced tinyllama after one step of the reference's train cell."""
    rcfg = dataclasses.replace(ref_cfg("tinyllama-1.1b", "bfloat16"), fsdp=True)
    spec = dataclasses.replace(ref_get_reduced_spec("tinyllama-1.1b"), model_cfg=rcfg)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with mesh:
        step = jax.jit(ref_build_cell(spec, "train_4k", mesh).fn)
        params = ref_params(rcfg)
        params, opt, _ = step(params, ref_adamw_init(params), lm_batch(256, 4, 32))
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt)


@pytest.fixture(scope="module")
def worlds(state, tmp_path_factory):
    params, opt = state
    root = tmp_path_factory.mktemp("ckpt")
    one = root / "world1"
    save_checkpoint(one, 1, {"params": from_reference(params, device="cpu"), "opt": from_reference(opt, device="cpu")})
    base = {"params": params, "opt": opt}
    four = run_world(4, "_torch_world_cases:checkpoint_case",
                     {**base, "mesh": (2, 2), "save": str(root / "world4"), "restore": str(one)},
                     tmp_path_factory.mktemp("w4"))
    two = run_world(2, "_torch_world_cases:checkpoint_case",
                    {**base, "mesh": (1, 2), "save": str(root / "world2"), "restore": str(root / "world4")},
                    tmp_path_factory.mktemp("w2"))
    return root, four, two


@pytest.mark.parametrize("world", ["world4", "world2"])
def test_a_world_save_is_the_one_rank_save_byte_for_byte(worlds, world):
    root = worlds[0]
    assert latest_step(root / world) == 1
    a, b = root / world / "step_1", root / "world1" / "step_1"
    assert (a / "arrays.npz").read_bytes() == (b / "arrays.npz").read_bytes()
    ma, mb = json.loads((a / "manifest.json").read_text()), json.loads((b / "manifest.json").read_text())
    ma.pop("time"), mb.pop("time")
    assert ma == mb
    assert sorted(p.name for p in (root / world).iterdir()) == ["step_1"]


def test_a_checkpoint_resumes_at_another_world_size(worlds):
    """world 1 -> world 4, world 4 -> world 2: every rank's slices equal."""
    _, four, two = worlds
    for res in four + two:
        assert res["restored_step"] == 1 and res["restored_equal"]
