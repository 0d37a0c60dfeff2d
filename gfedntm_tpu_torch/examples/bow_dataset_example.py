"""BoW data-prep walkthrough over the port: build a vocabulary, vectorize,
split, and inspect a BowDataset.

The twin of ``examples/bow_dataset_example.py`` (the script form of the
reference's ``notebooks/tests/BoW dataset example.ipynb``), over
:func:`gfedntm_tpu_torch.data.preparation.prepare_dataset` and
:func:`gfedntm_tpu_torch.data.synthetic.generate_synthetic_corpus`. It trains
nothing and launches no kernel.

Run: python -m gfedntm_tpu_torch.examples.bow_dataset_example [--device cpu|cuda]
"""

from __future__ import annotations

import sys

from gfedntm_tpu_torch.device import device_parser, resolve_device
from gfedntm_tpu_torch.examples import report


def run(vocab_size: int = 300, n_topics: int = 5, n_docs: int = 100,
        nwords: tuple[int, int] = (20, 40), frozen_topics: int = 2, seed: int = 0,
        device=None) -> dict:
    """The script's flow; returns its printed values. ``device`` is
    resolved as every entry point's is, though nothing runs on it."""
    from gfedntm_tpu_torch.data.preparation import prepare_dataset
    from gfedntm_tpu_torch.data.synthetic import generate_synthetic_corpus

    device = resolve_device(device)
    corpus = generate_synthetic_corpus(
        vocab_size=vocab_size, n_topics=n_topics, n_docs=n_docs, nwords=nwords, n_nodes=1,
        frozen_topics=frozen_topics, seed=seed,
    )
    docs = corpus.nodes[0].documents
    train_data, val_data, input_size, id2token, docs_train, vocab = prepare_dataset(docs)
    return {
        "device": str(device),
        "n_documents": len(docs),
        "first_doc": docs[0],
        "vocab_size": input_size,
        "train_shape": tuple(train_data.X.shape),
        "val_shape": tuple(val_data.X.shape),
        "first_terms": [id2token[i] for i in range(10)],
        "doc0_active_terms": int((train_data.X[0] > 0).sum()),
    }


def lines(out: dict) -> list[str]:
    """The JAX script's printed lines."""
    return [
        f"{out['n_documents']} documents; first doc: {out['first_doc'][:70]}...",
        f"vocabulary: {out['vocab_size']} terms (25% validation split, seed 42)",
        f"train matrix: {out['train_shape']}, val matrix: {out['val_shape']}",
        f"first 10 terms: {out['first_terms']}",
        f"doc 0 active terms: {out['doc0_active_terms']}",
    ]


def main(argv: list[str] | None = None) -> int:
    return report(run, lines, device_parser(__doc__).parse_args(argv).device)


if __name__ == "__main__":
    sys.exit(main())
