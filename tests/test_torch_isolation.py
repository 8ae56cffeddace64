"""``repro_torch`` stands alone: it imports neither jax nor the reference
package ``repro``, and serves a batch on the CPU with both blocked."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"

_SERVE = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.index import build_indexes, synthesize_corpus
from repro_torch.search import SearchEngine, ServingFrontend
store = synthesize_corpus(n_docs=20, doc_len=80, vocab_size=300, seed=5)
index = build_indexes(store, sw_count=40, fu_count=80, max_distance=5)
queries = ["who are you who", "to be or not to be"]
for use_kernel in (False, True):
    fe = ServingFrontend(index, lemmatizer=store.lemmatizer, use_kernel=use_kernel, device="cpu")
    resps = fe.search_many(queries)
    assert all(r.docs for r in resps), [r.query for r in resps if not r.docs]
engine = SearchEngine(index, lemmatizer=store.lemmatizer, device="cpu")
assert [len(r.docs) for r in engine.search_batch(queries)] == [len(r.docs) for r in resps]
assert not any(m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro"
               for m, mod in sys.modules.items() if mod is not None)
print("served", sum(r.stats.results for r in resps))
"""


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
    assert proc.stdout.startswith("served ")


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|repro)(?:[.\s,]|$)", re.MULTILINE)


def test_source_imports_neither_jax_nor_reference():
    sources = sorted(PACKAGE.rglob("*.py"))
    assert len(sources) > 15
    offenders = [
        f"{path.relative_to(ROOT)}: {m.group(0).strip()}"
        for path in sources
        for m in _IMPORT.finditer(path.read_text())
    ]
    assert offenders == []
    assert _IMPORT.search("import jax.numpy as jnp") and _IMPORT.search("from repro.core import x")
    assert not _IMPORT.search("from repro_torch.core import x")
