"""Phase 1: vocabulary consensus (host-side, one-shot).

A copy of ``gfedntm_tpu/federated/consensus.py``, kept here so the port never
imports the JAX package; it returns the port's
:class:`~gfedntm_tpu_torch.data.datasets.BowDataset` (or ``CTMDataset``),
which :meth:`~gfedntm_tpu_torch.federated.trainer.FederatedTrainer.fit`
takes as they are.

Reference flow (``server.py:175-331``, ``client.py:358-507``): each client
builds a local vocabulary, the server unions them (sorted set-union), and
every client re-vectorizes its corpus against the *global* vocabulary. This
is host work before training: the global vocabulary fixes the model's input
size, mirroring the reference's strict two-phase structure (consensus, then
training).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gfedntm_tpu_torch.data.datasets import BowDataset, CTMDataset
from gfedntm_tpu_torch.data.loaders import RawCorpus
from gfedntm_tpu_torch.data.vocab import (
    Vocabulary,
    build_vocabulary,
    union_vocabularies,
    vectorize,
)


@dataclass
class ConsensusResult:
    global_vocab: Vocabulary
    datasets: list[BowDataset]
    local_vocabs: list[Vocabulary]


def run_vocab_consensus(
    corpora: list[RawCorpus],
    max_features: int | None = 2000,
    stop_words: str | None = None,
    lowercase: bool = True,
    contextual: bool = False,
    label_size: int = 0,
) -> ConsensusResult:
    """Union client vocabularies and vectorize every client against the
    global vocabulary (``server.py:270-288`` + ``client.py:460-493``).

    ``max_features`` bounds each *local* vocabulary (as each reference client
    does with its own CountVectorizer, ``client.py:358-376``); the global
    vocabulary is the sorted union of the locals.
    """
    local_vocabs = [
        build_vocabulary(
            c.documents, max_features=max_features, stop_words=stop_words,
            lowercase=lowercase,
        )
        for c in corpora
    ]
    global_vocab = union_vocabularies(local_vocabs)
    id2token = global_vocab.id2token

    datasets: list[BowDataset] = []
    for c in corpora:
        X = vectorize(c.documents, global_vocab, lowercase=lowercase)
        if contextual:
            if c.embeddings is None:
                raise ValueError("contextual consensus requires embeddings")
            labels = None
            if label_size > 0 and c.labels is not None:
                lab = np.asarray(c.labels)
                labels = (
                    lab
                    if lab.ndim == 2
                    else np.eye(label_size, dtype=np.float32)[lab]
                )
            datasets.append(
                CTMDataset(X=X, idx2token=id2token, X_ctx=c.embeddings,
                           labels=labels)
            )
        else:
            datasets.append(BowDataset(X=X, idx2token=id2token))
    return ConsensusResult(
        global_vocab=global_vocab, datasets=datasets, local_vocabs=local_vocabs
    )
