"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the serving path's shapes, and the port's serving path on the card
against the same path on the CPU.

Every test here needs a CUDA device: each is marked ``gpu`` and skips (in a
fixture, at run time) where there is none.  This file imports neither jax
nor the reference package, so it runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.index import build_indexes, synthesize_corpus
from repro_torch.kernels import (
    intersect_sorted,
    intersect_sorted_plain,
    proximity_window,
    proximity_window_plain,
)
from repro_torch.search import SearchRequest, ServingFrontend
from repro_torch.search.fused import intersect_inputs

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["uint8", "int32"])
def test_proximity_kernel_equals_plain_at_serving_shape(cuda, dtype):
    rng = np.random.default_rng(0)
    occ = torch.from_numpy((rng.random((32768, 8, 512)) < 0.1).astype(np.uint8)).to(cuda)
    mult = torch.from_numpy(rng.integers(0, 3, (32768, 8)).astype(np.int32)).to(cuda)
    launches = proximity_window.launches
    emit, start = proximity_window(occ, mult, 5, compute_dtype=dtype)
    assert proximity_window.launches == launches + 1
    p_emit, p_start = proximity_window_plain(occ, mult, 5, compute_dtype=dtype)
    assert torch.equal(emit, p_emit)
    assert torch.equal(torch.where(p_emit, start, 0), torch.where(p_emit, p_start, 0))


@pytest.mark.parametrize("n_chunks", [1, 2, 32])
def test_intersect_kernel_equals_plain_at_serving_shape(cuda, n_chunks):
    rng = np.random.default_rng(1)
    a_docs = np.sort(rng.choice(8192, 5500, replace=False)).astype(np.int32)
    b_docs = np.sort(rng.choice(8192, 5600, replace=False)).astype(np.int32)
    a_p, b_p, off_p, _ = intersect_inputs(a_docs, b_docs)
    a, b, off = (torch.from_numpy(x).to(cuda) for x in (a_p, b_p, off_p))
    launches = intersect_sorted.launches
    got = intersect_sorted(a, b, off, n_chunks=n_chunks)
    assert intersect_sorted.launches == launches + 1
    assert torch.equal(got, intersect_sorted_plain(a, b, off, n_chunks=n_chunks))


def test_frontend_on_card_equals_cpu(cuda):
    store = synthesize_corpus(n_docs=120, doc_len=150, vocab_size=600, seed=3)
    index = build_indexes(store, sw_count=60, fu_count=150, max_distance=5)
    requests = [SearchRequest(q, top_k=1000) for q in
                ("who are you who", "to be or not to be", "time and time again")]

    def run(**kw):
        resps = ServingFrontend(index, lemmatizer=store.lemmatizer, **kw).search_many(requests)
        return [[(d.doc_id, d.score, [(f.start, f.end) for f in d.fragments]) for d in r.docs]
                for r in resps]

    want = run(device="cpu")
    for use_kernel in (False, True):
        got = run(device="cuda", use_kernel=use_kernel)
        assert [[(d, f) for d, _, f in r] for r in got] == [[(d, f) for d, _, f in r] for r in want]
        for g, w in zip(got, want):
            # float32 row sums never reach the ranking: rank_documents sums
            # the same fragments in the same order on both devices
            assert [s for _, s, _ in g] == [s for _, s, _ in w]
