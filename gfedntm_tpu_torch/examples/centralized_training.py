"""Centralized ProdLDA on a synthetic corpus with ground-truth recovery
scoring, over the port.

The twin of ``examples/centralized_training.py`` (the reference's
centralized-baseline workflow, ``experiments/dss_tss/run_simulation.py``'s
single-iteration slice): ``AVITM.fit`` with validation at V=500, K=8,
H=(64, 64), B=32, 15 epochs, then the topic similarity score (TSS) of the
learnt topics against the generator's, beside a random baseline, through
:mod:`gfedntm_tpu_torch.eval.metrics`. On the GPU each training step runs
the fused decoder's kernels K1-K3.

Run: python -m gfedntm_tpu_torch.examples.centralized_training [--device cpu|cuda]
"""

from __future__ import annotations

import sys

from gfedntm_tpu_torch.device import device_parser, resolve_device
from gfedntm_tpu_torch.examples import report


def run(vocab_size: int = 500, n_topics: int = 8, n_docs: int = 400,
        nwords: tuple[int, int] = (30, 60), frozen_topics: int = 3, seed: int = 0,
        hidden_sizes: tuple[int, ...] = (64, 64), batch_size: int = 32, num_epochs: int = 15,
        device=None) -> dict:
    """The script's flow; returns its printed values and the trained model
    (``models["centralized"]``)."""
    from gfedntm_tpu_torch.data.preparation import prepare_dataset
    from gfedntm_tpu_torch.data.synthetic import generate_synthetic_corpus
    from gfedntm_tpu_torch.eval.metrics import (
        convert_topic_word_to_init_size,
        random_baseline_tss,
        topic_similarity_score,
    )
    from gfedntm_tpu_torch.models.avitm import AVITM

    device = resolve_device(device)
    V, K = vocab_size, n_topics
    corpus = generate_synthetic_corpus(
        vocab_size=V, n_topics=K, n_docs=n_docs, nwords=nwords, n_nodes=1,
        frozen_topics=frozen_topics, seed=seed,
    )
    docs = corpus.nodes[0].documents
    train_data, val_data, input_size, id2token, _docs, _vocab = prepare_dataset(docs)
    model = AVITM(
        input_size=input_size, n_components=K, hidden_sizes=hidden_sizes,
        batch_size=batch_size, num_epochs=num_epochs, verbose=True, device=device,
    )
    model.fit(train_data, val_data)

    betas = model.get_topic_word_distribution()
    betas_full = convert_topic_word_to_init_size(V, betas, id2token)
    return {
        "device": str(device),
        "n_topics": K,
        "vocab_size": input_size,
        "train_shape": tuple(train_data.X.shape),
        "val_shape": tuple(val_data.X.shape),
        "epochs": len(model.epoch_losses),
        "steps": len(model.step_losses),
        "final_loss": model.epoch_losses[-1],
        "losses": list(model.step_losses),
        "tss": topic_similarity_score(betas_full, corpus.topic_vectors),
        "random_baseline_tss": random_baseline_tss(corpus.topic_vectors),
        "topics": model.get_topics(8)[:3],
        "models": {"centralized": model},
    }


def lines(out: dict) -> list[str]:
    """The JAX script's printed lines (the model's epoch log goes to
    ``logging``, which the script leaves unconfigured)."""
    return [f"TSS: {out['tss']:.3f} (max {out['n_topics']}; random baseline "
            f"{out['random_baseline_tss']:.3f})"] + [
        f"topic {i}: {' '.join(topic)}" for i, topic in enumerate(out["topics"])]


def main(argv: list[str] | None = None) -> int:
    return report(run, lines, device_parser(__doc__).parse_args(argv).device)


if __name__ == "__main__":
    sys.exit(main())
