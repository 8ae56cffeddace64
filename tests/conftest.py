import numpy as np
import pytest

from repro.core.lemma import Lemmatizer
from repro.index import build_indexes, synthesize_corpus


@pytest.fixture(scope="session")
def small_corpus():
    return synthesize_corpus(n_docs=50, doc_len=100, vocab_size=600, seed=11)


@pytest.fixture(scope="session")
def small_index(small_corpus):
    return build_indexes(small_corpus, sw_count=60, fu_count=150, max_distance=5)


@pytest.fixture(scope="session")
def lemmatizer():
    return Lemmatizer()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none"
    )
