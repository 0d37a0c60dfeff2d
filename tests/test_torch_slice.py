"""The whole slice on the CPU: the port's ``FederatedTrainer.fit`` against
the JAX package's, from the same bridged initial weights and the same numpy
schedules, both with the fused decode + loss (the port's kernels' plain
versions; JAX's Pallas kernels in interpret mode).

The reparameterization noise and dropout differ (threefry vs Philox never
agree), so the runs are compared by outcome: the final-epoch mean loss must
lie within 5% of JAX's. Measured on this configuration: 0.55% apart
(0.4% to 1.5% over nearby batch sizes, corpus sizes and epoch counts).
"""

import jax
import numpy as np
import pytest
import torch

from gfedntm_tpu.federated.trainer import FederatedTrainer as JFederatedTrainer
from gfedntm_tpu.models.avitm import AVITM as JAVITM
from gfedntm_tpu_torch import interop
from gfedntm_tpu_torch.data.datasets import BowDataset
from gfedntm_tpu_torch.data.synthetic import generate_synthetic_corpus
from gfedntm_tpu_torch.federated.trainer import FederatedTrainer
from gfedntm_tpu_torch.models.avitm import AVITM
from gfedntm_tpu_torch.ops import fused_decoder as fd

V, K, H, B, C, EPOCHS, DOCS = 300, 6, (17, 13), 16, 2, 2, 128
ENVELOPE = 0.05


@pytest.fixture(scope="module")
def runs():
    corpus = generate_synthetic_corpus(vocab_size=V, n_topics=K, n_docs=DOCS, n_nodes=C,
                                       nwords=(30, 60), seed=3, materialize_docs=False)
    idx2token = {i: f"wd{i}" for i in range(V)}
    datasets = [BowDataset(X=n.bow, idx2token=idx2token) for n in corpus.nodes]
    kw = dict(input_size=V, n_components=K, hidden_sizes=H, batch_size=B,
              num_epochs=EPOCHS, fused_decoder=True, lr=1e-2)
    j_template = JAVITM(**kw)
    j_trainer = JFederatedTrainer(j_template, n_clients=C)
    j_result = j_trainer.fit(datasets)

    template = AVITM(device="cpu", **kw)
    template.model.load_state_dict(interop.state_dict_from_flax(
        jax.tree.map(np.asarray, j_template.params),
        jax.tree.map(np.asarray, j_template.batch_stats),
    ))
    trainer = FederatedTrainer(template, n_clients=C, device="cpu")
    before = dict(fd.LAUNCHES)
    result = trainer.fit(datasets)
    assert fd.LAUNCHES == before  # CPU tensors take the plain versions
    return datasets, j_result, trainer, result


def test_losses_shape_finite_and_falling(runs):
    _, j_result, _, result = runs
    assert result.losses.shape == j_result.losses.shape == (DOCS // B * EPOCHS, C)
    assert np.isfinite(result.losses).all()
    for c in range(C):
        first, last = result.epoch_losses[c][0], result.epoch_losses[c][-1]
        assert last < first, (c, result.epoch_losses[c])


def test_final_epoch_loss_within_envelope_of_jax(runs):
    _, j_result, _, result = runs
    port = np.mean([e[-1] for e in result.epoch_losses])
    jax_ = np.mean([e[-1] for e in j_result.epoch_losses])
    assert abs(port - jax_) / jax_ < ENVELOPE, (port, jax_)


def test_shared_state_identical_across_clients(runs):
    _, _, _, result = runs
    for tree in (result.client_params, result.client_batch_stats):
        for key, value in tree[0].items():
            assert torch.equal(value, tree[1][key]), key
    for key, value in result.global_params.items():
        assert torch.equal(value, result.client_params[0][key])


def test_global_and_client_models(runs):
    datasets, _, trainer, result = runs
    model = trainer.make_global_model(result, datasets[0])
    topics = model.get_topics(10)
    assert len(topics) == K and all(len(t) == 10 for t in topics)
    assert all(w.startswith("wd") for t in topics for w in t)
    theta = model.get_doc_topic_distribution(datasets[1], n_samples=3)
    assert theta.shape == (DOCS, K) and np.allclose(theta.sum(1), 1.0, atol=1e-5)
    client = trainer.make_client_model(result, 1)
    assert np.array_equal(client.get_topic_word_matrix(), model.get_topic_word_matrix())
    assert model.get_topic_word_distribution().shape == (K, V)
    # The global model is a copy: the template's weights did not move.
    assert not torch.equal(trainer.template.model.beta, model.model.beta)


def test_local_steps_and_max_iters():
    corpus = generate_synthetic_corpus(vocab_size=60, n_topics=4, n_docs=20, n_nodes=2,
                                       nwords=(10, 20), seed=0, materialize_docs=False)
    datasets = [BowDataset(X=n.bow) for n in corpus.nodes]
    template = AVITM(input_size=60, n_components=4, hidden_sizes=(8, 8), batch_size=8,
                     num_epochs=3, device="cpu")
    with pytest.raises(ValueError):
        FederatedTrainer(template, n_clients=2, local_steps=0, device="cpu")
    trainer = FederatedTrainer(template, n_clients=2, local_steps=2, max_iters=5,
                               device="cpu")
    result = trainer.fit(datasets)
    assert result.losses.shape == (5, 2)  # min(3 steps x 3 epochs, 5)
    # Step 5 exchanges (the last step always does), so clients agree.
    for key, value in result.client_params[0].items():
        assert torch.equal(value, result.client_params[1][key]), key
    with pytest.raises(ValueError):
        trainer.fit(datasets[:1])


def test_avitm_fit_centralized():
    corpus = generate_synthetic_corpus(vocab_size=80, n_topics=4, n_docs=40, n_nodes=1,
                                       nwords=(20, 40), seed=0, materialize_docs=False)
    data = BowDataset(X=corpus.nodes[0].bow)
    model = AVITM(input_size=80, n_components=4, hidden_sizes=(8, 8), batch_size=16,
                  num_epochs=4, reduce_on_plateau=True, device="cpu")
    model.fit(data, n_samples=2)
    assert len(model.epoch_losses) == 4 and np.isfinite(model.epoch_losses).all()
    assert model.training_doc_topic_distributions.shape == (40, 4)
    assert model.best_components.shape == (4, 80)
    lda = AVITM(input_size=80, n_components=4, hidden_sizes=(8, 8), batch_size=16,
                num_epochs=1, model_type="LDA", device="cpu")
    assert not lda.fused_decoder
    lda.fit(data, n_samples=2)
    dist = lda.get_topic_word_distribution()
    assert np.allclose(dist.sum(1), 1.0, atol=1e-5)
