"""A federated run over the port: 3 clients, vocabulary consensus,
per-minibatch weighted FedAvg, per-client and global artifacts.

The twin of ``examples/federated_simulation.py`` (the reference's
docker-compose federation, which the JAX package runs as one SPMD
program): :func:`run_vocab_consensus` over three clients' raw text, then
``FederatedTrainer.fit``, ``make_global_model``, ``get_topics`` and
``topic_diversity``. The port steps its clients one after another in one
process; ``FederatedResult.client_params`` is a list with one state per
client where the JAX result stacks them on a leading axis, so the check
that the shared beta is equal across clients is made on that list. On the
GPU each client step runs the fused decoder's kernels K1-K3.

Run: python -m gfedntm_tpu_torch.examples.federated_simulation [--device cpu|cuda]
"""

from __future__ import annotations

import sys

import numpy as np

from gfedntm_tpu_torch.device import device_parser, resolve_device
from gfedntm_tpu_torch.examples import report


def run(vocab_size: int = 400, n_topics: int = 6, n_docs: int = 150,
        nwords: tuple[int, int] = (25, 45), n_clients: int = 3, frozen_topics: int = 2,
        seed: int = 0, hidden_sizes: tuple[int, ...] = (32, 32), batch_size: int = 16,
        num_epochs: int = 10, device=None) -> dict:
    """The script's flow; returns its printed values and the global model
    (``models["global"]``, its ``train_data`` client 0's dataset)."""
    from gfedntm_tpu_torch.data.loaders import RawCorpus
    from gfedntm_tpu_torch.data.synthetic import generate_synthetic_corpus
    from gfedntm_tpu_torch.eval.metrics import topic_diversity
    from gfedntm_tpu_torch.federated.consensus import run_vocab_consensus
    from gfedntm_tpu_torch.federated.trainer import FederatedTrainer
    from gfedntm_tpu_torch.models.avitm import AVITM

    device = resolve_device(device)
    corpus = generate_synthetic_corpus(
        vocab_size=vocab_size, n_topics=n_topics, n_docs=n_docs, nwords=nwords,
        n_nodes=n_clients, frozen_topics=frozen_topics, seed=seed,
    )

    # Phase 1: vocabulary consensus (sorted union of per-client vocabularies).
    consensus = run_vocab_consensus(
        [RawCorpus(documents=list(n.documents)) for n in corpus.nodes]
    )

    # Phase 2: federated training.
    template = AVITM(
        input_size=len(consensus.global_vocab), n_components=n_topics,
        hidden_sizes=hidden_sizes, batch_size=batch_size, num_epochs=num_epochs,
        device=device,
    )
    trainer = FederatedTrainer(template, n_clients=n_clients, device=device)
    result = trainer.fit(consensus.datasets)

    # Shared parameters are identical across clients after the final exchange.
    beta = [p["beta"].detach().cpu().numpy() for p in result.client_params]
    assert all(np.allclose(beta[0], b) for b in beta[1:])

    global_model = trainer.make_global_model(result)
    global_model.train_data = consensus.datasets[0]
    topics = global_model.get_topics(8)
    return {
        "device": str(device),
        "vocab_size": len(consensus.global_vocab),
        "n_clients": len(consensus.datasets),
        "global_steps": int(result.losses.shape[0]),
        "client_steps": int(result.losses.size),
        "final_mean_loss": float(result.losses[-1].mean()),
        "losses": result.losses,
        "beta_bitwise_equal": all(np.array_equal(beta[0], b) for b in beta[1:]),
        "topic_diversity": topic_diversity(topics),
        "topics": topics[:3],
        "global_vocab": list(consensus.global_vocab.tokens),
        "models": {"global": global_model},
    }


def lines(out: dict) -> list[str]:
    """The JAX script's printed lines."""
    return [
        f"global vocabulary: {out['vocab_size']} terms from {out['n_clients']} clients",
        f"{out['global_steps']} global steps; final mean loss {out['final_mean_loss']:.1f}",
        f"topic diversity: {out['topic_diversity']:.2f}",
    ] + [f"topic {i}: {' '.join(topic)}" for i, topic in enumerate(out["topics"])]


def main(argv: list[str] | None = None) -> int:
    return report(run, lines, device_parser(__doc__).parse_args(argv).device)


if __name__ == "__main__":
    sys.exit(main())
