"""The port's copies of the numpy data layer give the JAX package's arrays
for the same seed."""

import numpy as np
import pytest

from gfedntm_tpu.data import datasets as jdata
from gfedntm_tpu.data import synthetic as jsyn
from gfedntm_tpu.train.steps import full_batch_indices as j_full_batch_indices
from gfedntm_tpu_torch.data import datasets as tdata
from gfedntm_tpu_torch.data import synthetic as tsyn


@pytest.mark.parametrize("n_docs,batch", [(100, 32), (64, 64), (7, 16), (257, 256)])
@pytest.mark.parametrize("seed", [0, 3])
def test_epoch_schedule_matches(n_docs, batch, seed):
    a = jdata.make_epoch_schedule(n_docs, batch, np.random.default_rng(seed))
    b = tdata.make_epoch_schedule(n_docs, batch, np.random.default_rng(seed))
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.mask, b.mask)
    assert a.steps_per_epoch == b.steps_per_epoch


@pytest.mark.parametrize("n_docs,batch,steps", [(100, 32, 9), (1024, 256, 8), (50, 64, 5)])
@pytest.mark.parametrize("seed", [0, 1001])
def test_run_schedule_matches(n_docs, batch, steps, seed):
    a = jdata.make_run_schedule(n_docs, batch, steps, seed=seed)
    b = tdata.make_run_schedule(n_docs, batch, steps, seed=seed)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.mask, b.mask)
    assert b.indices.shape == (steps, batch)


def test_unshuffled_schedule_and_inference_indices_match():
    a = jdata.make_epoch_schedule(70, 32, np.random.default_rng(0), shuffle=False)
    b = tdata.make_epoch_schedule(70, 32, np.random.default_rng(0), shuffle=False)
    np.testing.assert_array_equal(a.indices, b.indices)
    for x, y in zip(j_full_batch_indices(70, 32), tdata.full_batch_indices(70, 32)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("materialize", [True, False])
def test_synthetic_corpus_matches(materialize):
    kw = dict(vocab_size=200, n_topics=6, n_docs=30, n_nodes=3, seed=5,
              materialize_docs=materialize)
    a = jsyn.generate_synthetic_corpus(**kw)
    b = tsyn.generate_synthetic_corpus(**kw)
    np.testing.assert_array_equal(a.topic_vectors, b.topic_vectors)
    assert a.vocab_tokens == b.vocab_tokens and b.n_nodes == 3
    for na, nb in zip(a.nodes, b.nodes):
        np.testing.assert_array_equal(na.bow, nb.bow)
        np.testing.assert_array_equal(na.doc_topics, nb.doc_topics)
        assert na.documents == nb.documents


def test_bow_dataset_matches():
    x = np.arange(12).reshape(3, 4)
    a = jdata.BowDataset(X=x, idx2token={0: "a"})
    b = tdata.BowDataset(X=x, idx2token={0: "a"})
    assert b.X.dtype == np.float32 and len(b) == len(a) == 3
    assert b.vocab_size == a.vocab_size == 4
    np.testing.assert_array_equal(a.X, b.X)
