"""``repro_torch`` stands alone: it imports neither jax nor the reference
package ``repro``, and serves a batch on the CPU with both blocked, over
the host route, the posting arena and a sharded service, runs the scalar
Combiner, builds, logs, snapshots, mutates and warm-starts an incremental
sharded service, serves it under a seeded fault schedule, runs the daemon
behind its TCP transport, bulk-builds with two spawn workers, runs the
launcher, runs reduced ``paper_search`` dry-run cells, trains the reduced
tinyllama, olmoe and llama4-maverick (MoE), fm and mind (recsys) and
gat-cora (GNN) for two steps through the training launcher, runs a reduced
recsys cell, a reduced GNN cell and a MoE FFN, samples a subgraph, counts a
program's cost and the search lowerings', resolves every architecture
id, and, on a one-rank gloo mesh, runs a sharded serve step and a reduced
LM train step and plans an ``ElasticTopology``; in a gloo world of two
ranks (each with both blocked) it runs the context-parallel decode cell,
the sharded recsys (row-sharded tables, column-split MLP) and GNN (edge
blocks) cells and the trainer with ``--mesh 1x2`` for fm and gat-cora, and
reads ``launch.mesh.MESH_AXES``."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"

_RANK = """
import os, sys
os.nice(10)
sys.modules["jax"] = None
sys.modules["repro"] = None
import torch.distributed as dist
from repro_torch.configs import get_reduced_spec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MESH_AXES, make_device_mesh
assert MESH_AXES == ("pod", "data", "model")
dist.init_process_group("gloo", init_method="file://" + sys.argv[1], rank=int(sys.argv[2]), world_size=2)
mesh = make_device_mesh((1, 2), ("data", "model"), backend="gloo", device="cpu")
dryrun.get_spec = get_reduced_spec
rec = dryrun.run_cell("tinyllama-1.1b", "decode_32k", verbose=False, dmesh=mesh, repeats=1)
assert rec["status"] == "ok", rec
# the row-sharded recsys tables and the GNN's edge blocks under the mesh
for arch, shape in (("fm", "train_batch"), ("dcn-v2", "serve_p99"), ("gat-cora", "full_graph_sm")):
    other = dryrun.run_cell(arch, shape, verbose=False, dmesh=mesh, repeats=1)
    assert other["status"] == "ok" and other["collective_total_per_device"] > 0, other
# the trainer's --mesh for fm, then (a fresh process group: the trainer
# tears its own down) for gat-cora
from repro_torch.launch import train
argv = ["--steps", "2", "--device", "cpu", "--mesh", "1x2", "--backend", "gloo"]
train.main(["--arch", "fm", *argv])
dist.init_process_group("gloo", init_method="file://" + sys.argv[1] + "-gnn", rank=int(sys.argv[2]), world_size=2)
train.main(["--arch", "gat-cora", *argv])
assert not any(m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro"
               for m, mod in sys.modules.items() if mod is not None)
print("decode", rec["device_mesh"], rec["status"], rec["input_shapes"][1]["k"][2])
"""

# the subprocess runs at a lower CPU priority (nice 10), as the gloo worlds
# of ``tests/_torch_worlds.py`` do: the test workers beside it run
# timing-sensitive tests (hypothesis deadlines)
_SERVE = """
import os, sys
os.nice(10)
sys.modules["jax"] = None
sys.modules["repro"] = None
_RANK = %r
from repro_torch.index import build_indexes, synthesize_corpus
from repro_torch.search import SearchEngine, ServingFrontend
store = synthesize_corpus(n_docs=20, doc_len=80, vocab_size=300, seed=5)
index = build_indexes(store, sw_count=40, fu_count=80, max_distance=5)
queries = ["who are you who", "to be or not to be"]
for use_kernel in (False, True):
    fe = ServingFrontend(index, lemmatizer=store.lemmatizer, use_kernel=use_kernel, device="cpu")
    resps = fe.search_many(queries)
    assert all(r.docs for r in resps), [r.query for r in resps if not r.docs]
engine = SearchEngine(index, lemmatizer=store.lemmatizer, algorithm="fused", device="cpu")
assert [len(r.docs) for r in engine.search_batch(queries)] == [len(r.docs) for r in resps]
from repro_torch.kernels.gather import gather_blocks
from repro_torch.search.arena import PostingArena
for use_kernel in (False, True):
    fe = ServingFrontend(index, lemmatizer=store.lemmatizer, use_kernel=use_kernel,
                         arena=PostingArena(device="cpu"), device="cpu")
    arena_resps = fe.search_many(queries)
    assert [len(r.docs) for r in arena_resps] == [len(r.docs) for r in resps]
    assert sum(r.stats.arena_hits for r in arena_resps) > 0
from repro_torch.core.combiner import se24_combiner
from repro_torch.core.keys import expand_subqueries
from repro_torch.search import ShardedSearchService, device_topk_merge
svc = ShardedSearchService(store, n_shards=2, sw_count=40, fu_count=80, device="cpu")
sharded = ServingFrontend(svc, device="cpu").search_many(queries)
host = svc.search_batch(queries)
assert [[d.doc_id for d in r.docs] for r in sharded] == [[d.doc_id for d in r.docs] for r in host]
frags = set()
for shard in svc.shards:
    for sub in expand_subqueries(queries[0], store.lemmatizer):
        frags.update(se24_combiner(sub, shard)[0])
assert {(d.doc_id, f.start, f.end) for d in host[0].docs for f in d.fragments} <= frags
import torch
assert device_topk_merge(torch.ones(2, 3), torch.arange(6).reshape(2, 3), 4)[1].tolist() == [0, 1, 2, 3]
import tempfile
from repro_torch.index import index_sets_equal
inc = ShardedSearchService(store, n_shards=2, sw_count=40, fu_count=80, incremental=True, device="cpu")
lineage = tempfile.mkdtemp()
inc.enable_wal(lineage)
inc.snapshot(lineage)
inc.add_documents(["who are you who said the caterpillar", "to be or not to be again"])
inc.delete_document(3)
inc.commit()
warm = ServingFrontend.from_snapshot(lineage, device="cpu")
assert sum(ix.last_wal_replay["records"] for ix in warm._source.indexers) > 0
for a, b in zip(warm._source.shards, inc.shards):
    assert index_sets_equal(a.to_index_set(), b.to_index_set())[0]
live = ServingFrontend(inc, arena_budget_mb=64, device="cpu").search_many(queries)
assert [[d.doc_id for d in r.docs] for r in warm.search_many(queries)] == [[d.doc_id for d in r.docs] for r in live]
from repro_torch.search.resilience import FaultInjector, ResiliencePolicy
inc.enable_resilience(policy=ResiliencePolicy(snapshot_dir=lineage),
                      injector=FaultInjector.from_seed(101, n_shards=2))
for _ in range(10):
    chaos = ServingFrontend(inc, device="cpu").search_many(queries)
assert inc.injector.log and inc.resilience_metrics()["recoveries"] >= 1
from repro_torch.search import ServiceDaemon, request_over_tcp, serve_tcp
server = serve_tcp(ServiceDaemon(ServingFrontend(index, lemmatizer=store.lemmatizer, device="cpu")))
reply = request_over_tcp(server.address, {"query": queries[0], "top_k": 10})
assert [d["doc_id"] for d in reply["docs"]] == [d.doc_id for d in resps[0].docs]
server.shutdown()
server.server_close()
server.search_daemon.stop()
from pathlib import Path
from repro_torch.index.ingest import bulk_build
bulk = Path(tempfile.mkdtemp())
stats = bulk_build([d.text for d in store.documents], out_dir=bulk, sw_count=40, fu_count=80,
                   docs_per_spill=5, workers=2)
assert stats.workers == 2 and stats.n_chunks == -(-len(store) // 5) > 2
assert (bulk / "snap_0" / "manifest.json").exists()
from repro_torch.launch.serve import main
main(["--device", "cpu", "--n-docs", "30", "--arena-budget-mb", "0", "--queries", "who are you who"])
from repro_torch.configs import get_reduced_spec
from repro_torch.search.serving_step import build_step, serve_step, serve_step_sharded
from repro_torch.launch.steps import build_cell, input_specs
from repro_torch.launch import dryrun
assert input_specs("paper_search", "serve_bulk")[0].shape == (256, 4096, 32, 3)
dryrun.get_spec = get_reduced_spec
for shape in ("serve_online", "build_chunk"):
    rec = dryrun.run_cell("paper_search", shape, verbose=False, device="cpu")
    assert rec["status"] == "ok", rec
import repro_torch.models, repro_torch.optim, repro_torch.data
from repro_torch.launch import train
train.main(["--arch", "tinyllama-1.1b", "--steps", "2", "--device", "cpu"])
for arch in ("olmoe-1b-7b", "llama4-maverick-400b-a17b", "fm", "mind", "gat-cora"):
    train.main(["--arch", arch, "--steps", "2", "--device", "cpu"])
from repro_torch.configs import ARCH_IDS, get_spec
from repro_torch.configs import autoint, dcn_v2, fm, gat_cora, llama4_maverick, mind, olmoe_1b_7b, recsys_common
from repro_torch.kernels.ref import embedding_bag_ref
from repro_torch.models import gnn, moe, recsys
assert [get_spec(arch).arch_id for arch in ARCH_IDS] == list(ARCH_IDS)
rec = dryrun.run_cell("dcn-v2", "retrieval_cand", verbose=False, device="cpu", repeats=1)
assert rec["status"] == "ok", rec
for shape in ("full_graph_sm", "molecule"):
    rec = dryrun.run_cell("gat-cora", shape, verbose=False, device="cpu", repeats=1)
    assert rec["status"] == "ok" and rec["flops_per_device"] > 0, rec
from repro_torch.data.sampler import NeighborSampler, random_graph
sample = NeighborSampler(random_graph(200, 4, 24, 5, seed=1), batch_nodes=8, fanout=(3, 2), seed=2).sample()
gcfg = get_reduced_spec("gat-cora").cfg_for("full_graph_sm")
logits = gnn.gat_forward(gnn.init_gat_params(0, gcfg, device="cpu"),
                         {k: torch.as_tensor(v) for k, v in sample.items()}, gcfg, edge_chunk=5)
assert logits.shape == (sample["x"].shape[0], gcfg.n_classes)
from repro_torch.launch.cost_analysis import ProgramCost, count_cost
assert count_cost(torch.mm, torch.ones(4, 3), torch.ones(3, 2))[1].flops == 2 * 4 * 3 * 2
from repro_torch.search import fused
from repro_torch.search.arena import lower_arena_batch
from repro_torch.search.distributed import ShardStats
plan = fused.plan_query_batch([[(s, index) for s in expand_subqueries(q, store.lemmatizer)] for q in queries],
                              device="cpu")
assert isinstance(fused.lower_query_batch(plan, max_distance=5, device="cpu"), ProgramCost)
import torch
cfg = moe.MoEConfig(n_experts=4, top_k=2, d_ff=8, dispatch="sort")
p = moe.init_moe_params(torch.Generator().manual_seed(0), 8, cfg, torch.float32)
y, aux = moe.moe_ffn(torch.randn(1, 6, 8), p, cfg)
assert y.shape == (1, 6, 8) and embedding_bag_ref(torch.ones(3, 2), torch.tensor([[0, -1]])).tolist() == [[1.0, 1.0]]
import torch.distributed as dist
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.optim import compressed_grad_allreduce, init_error_feedback
from repro_torch.parallel import lm_param_specs, shard_tree
from repro_torch.runtime import ElasticTopology
dist.init_process_group("gloo", init_method="file://" + tempfile.mkdtemp() + "/rendezvous", rank=0, world_size=1)
mesh = make_device_mesh((1, 1), ("data", "model"), backend="gloo", device="cpu")
for arch, shape in (("paper_search", "serve_online"), ("tinyllama-1.1b", "train_4k")):
    rec = dryrun.run_cell(arch, shape, verbose=False, dmesh=mesh, repeats=1)
    assert rec["status"] == "ok" and rec["device_mesh"] == "1x1" and rec["backend"] == "gloo", rec
g = {"w": torch.ones(3)}
assert torch.equal(compressed_grad_allreduce(g, init_error_feedback(g), mesh, "data")[0]["w"], g["w"])
dist.destroy_process_group()
assert ElasticTopology().plan(2)["mesh_shape"] == (2, 16, 16)
# a world of two ranks, each with jax and the reference blocked: the
# context-parallel decode cell under --mesh 1x2
import subprocess
rendezvous = tempfile.mkdtemp() + "/rendezvous"
ranks = [subprocess.Popen([sys.executable, "-c", _RANK, rendezvous, str(r)], stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True) for r in range(2)]
outs = [p.communicate(timeout=180) for p in ranks]
assert all(p.returncode == 0 for p in ranks), [err[-2000:] for _, err in outs]
lines = outs[0][0].splitlines()
assert lines[-1].split() == ["decode", "1x2", "ok", "128"], outs[0][0]
# rank 0 prints each trainer's lines, rank 1 nothing
assert [ln.split()[:2] for ln in lines[:-1]] == [["step", "0"], ["step", "1"], ["done:", "2"]] * 2, lines
assert outs[1][0].split() == ["decode", "1x2", "ok", "128"], outs[1][0]
assert not any(m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro"
               for m, mod in sys.modules.items() if mod is not None)
print("served", sum(r.stats.results for r in resps))
""" % (_RANK,)


def test_serves_with_jax_and_reference_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _SERVE],
        cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "frontend: served 1 requests" in proc.stdout
    assert proc.stdout.splitlines()[-1].startswith("served ")
    # tinyllama, olmoe, llama4-maverick, fm, mind, gat-cora: two steps each
    assert [ln.split()[:2] for ln in proc.stdout.splitlines() if ln.startswith(("step ", "done: "))] == [
        ["step", "0"], ["step", "1"], ["done:", "2"]] * 6


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|repro)(?:[.\s,]|$)", re.MULTILINE)


def test_source_imports_neither_jax_nor_reference():
    sources = sorted(PACKAGE.rglob("*.py"))
    assert len(sources) > 15
    names = {str(p.relative_to(PACKAGE)) for p in sources}
    assert {"checkpoint/__init__.py", "checkpoint/checkpoint.py", "index/fastbuild.py",
            "index/incremental.py", "index/store.py", "index/wal.py", "index/ingest.py",
            "runtime/fault_tolerance.py", "search/resilience.py", "search/service.py",
            "launch/__init__.py", "launch/serve.py", "configs/__init__.py", "configs/common.py",
            "configs/paper_search.py", "search/serving_step.py", "launch/mesh.py",
            "launch/steps.py", "launch/dryrun.py", "tree.py", "models/__init__.py", "models/layers.py",
            "models/transformer.py", "models/convert.py", "optim/__init__.py", "optim/optimizer.py",
            "data/__init__.py", "data/pipeline.py", "configs/lm_common.py", "configs/tinyllama_1_1b.py",
            "configs/stablelm_3b.py", "configs/mistral_large_123b.py", "launch/train.py", "models/moe.py",
            "models/recsys.py", "configs/olmoe_1b_7b.py", "configs/llama4_maverick.py", "configs/recsys_common.py",
            "configs/fm.py", "configs/autoint.py", "configs/dcn_v2.py", "configs/mind.py",
            "models/gnn.py", "data/sampler.py", "configs/gat_cora.py", "launch/cost_analysis.py",
            "parallel/__init__.py", "parallel/sharding.py", "parallel/collectives.py",
            "optim/grad_compression.py", "runtime/elastic.py", "runtime/__init__.py"} <= names
    offenders = [
        f"{path.relative_to(ROOT)}: {m.group(0).strip()}"
        for path in sources
        for m in _IMPORT.finditer(path.read_text())
    ]
    assert offenders == []
    assert _IMPORT.search("import jax.numpy as jnp") and _IMPORT.search("from repro.core import x")
    assert not _IMPORT.search("from repro_torch.core import x")
