"""The port's data pipelines (``repro_torch.data.pipeline``, a copy of the
reference's numpy-only module) give the reference's batches bit for bit, and
resume from a saved state at the same batch."""

import numpy as np
import pytest

from repro.data import pipeline as ref
from repro_torch.data import pipeline as port


@pytest.mark.parametrize("vocab,seq,batch,seed", [(256, 128, 4, 0), (32000, 64, 3, 7), (50304, 16, 2, 11)])
def test_lm_token_batches_equal_the_reference(vocab, seq, batch, seed):
    a = port.LMTokenPipeline(vocab, seq, batch, seed=seed)
    b = ref.LMTokenPipeline(vocab, seq, batch, seed=seed)
    for _ in range(3):
        x, y = a.next_batch(), b.next_batch()
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
        assert np.array_equal(x["tokens"][:, 1:], x["targets"][:, :-1])
    assert a.state.as_tree() == b.state.as_tree()


def test_lm_pipeline_resumes_from_its_state():
    a = port.LMTokenPipeline(512, 32, 2, seed=3)
    a.next_batch()
    state = a.state.as_tree()
    want = a.next_batch()
    b = port.LMTokenPipeline(512, 32, 2, seed=99)
    b.state = port.PipelineState.from_tree(state)
    got = b.next_batch()
    assert all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("hist_len,n_dense", [(0, 0), (0, 13), (20, 0)])
def test_recsys_batches_equal_the_reference(hist_len, n_dense):
    vocab = (1000, 50, 7)
    a = port.RecsysBatchPipeline(vocab, 16, n_dense=n_dense, hist_len=hist_len, seed=2)
    b = ref.RecsysBatchPipeline(vocab, 16, n_dense=n_dense, hist_len=hist_len, seed=2)
    for _ in range(2):
        x, y = a.next_batch(), b.next_batch()
        assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
