"""Synthetic LDA corpus generator (vectorized, seedable).

A copy of ``gfedntm_tpu/data/synthetic.py`` (``SyntheticNode``,
``SyntheticCorpus``, ``generate_synthetic_corpus``, and
``load_reference_npz`` with its ``_bow_from_wd_docs``, the reader of a
reference-format archive that the quality monitor's ``quality_ref``
takes), kept here so the port never imports the JAX package; for the same
seed it draws the same corpus.

Documents are drawn from a known LDA generative model so ground-truth
topic-word (``topic_vectors``) and doc-topic (``doc_topics``) distributions
are available. Node priors: ``frozen_topics`` shared topics get alpha each;
each node additionally owns ``(K - frozen)/n_nodes`` topics at alpha with the
rest suppressed at alpha/10000, rotating per node
(reference ``generate_synthetic.py:42-60``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SyntheticNode:
    """One client's corpus with its ground truth."""

    bow: np.ndarray  # [n_docs, V] counts
    documents: list[str]  # whitespace-joined token strings ('wd17 wd5 ...')
    doc_topics: np.ndarray  # [n_docs, K] ground-truth theta


@dataclass
class SyntheticCorpus:
    topic_vectors: np.ndarray  # [K, V] ground-truth beta
    nodes: list[SyntheticNode]
    vocab_tokens: tuple[str, ...] = field(default_factory=tuple)

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)


def _rotate(arr: list[float], d: int) -> list[float]:
    """Left-rotate by d (generate_synthetic.py:3-31)."""
    d = d % max(len(arr), 1)
    return arr[d:] + arr[:d]


def generate_synthetic_corpus(
    vocab_size: int = 5000,
    n_topics: int = 50,
    beta: float = 1e-2,
    alpha: float | None = None,
    n_docs: int = 1000,
    nwords: tuple[int, int] = (150, 250),
    n_nodes: int = 5,
    frozen_topics: int = 5,
    seed: int = 0,
    materialize_docs: bool = True,
) -> SyntheticCorpus:
    """Generate per-node corpora from the LDA generative model.

    Defaults mirror ``generate_synthetic.py:33-46``. ``alpha`` defaults to
    1/n_topics. ``materialize_docs=False`` skips building the token-string
    documents (BoW only — much faster for large corpora).
    """
    rng = np.random.default_rng(seed)
    alpha = 1.0 / n_topics if alpha is None else alpha

    # Step 1: topic-word distributions ~ Dirichlet(beta).
    topic_vectors = rng.dirichlet(np.full(vocab_size, beta), n_topics)

    prior_frozen = [alpha] * frozen_topics
    own = (n_topics - frozen_topics) // max(n_nodes, 1)
    prior_nofrozen = [alpha] * own + [alpha / 10000.0] * (
        n_topics - frozen_topics - own
    )

    nodes = []
    for _node in range(n_nodes):
        # Step 2: per-node doc-topic proportions.
        doc_topics = rng.dirichlet(np.array(prior_frozen + prior_nofrozen), n_docs)
        prior_nofrozen = _rotate(prior_nofrozen, own)

        # Step 3: per-doc topic counts in one batched multinomial, then per
        # topic the words of all docs at once by inverse-CDF sampling.
        doc_lens = rng.integers(nwords[0], nwords[1], size=n_docs)
        topic_counts = rng.multinomial(doc_lens, doc_topics)  # [n_docs, K]
        bow = np.zeros((n_docs, vocab_size), dtype=np.float32)
        doc_ids_all = np.arange(n_docs)
        for k in range(n_topics):
            c_k = topic_counts[:, k]
            total = int(c_k.sum())
            if total == 0:
                continue
            cdf = np.cumsum(topic_vectors[k])
            words = np.searchsorted(cdf, rng.random(total), side="right")
            words = np.minimum(words, vocab_size - 1)  # float-rounding guard
            np.add.at(bow, (np.repeat(doc_ids_all, c_k), words), 1.0)
        docs = []
        if materialize_docs:
            word_range = np.arange(vocab_size)
            for d in range(n_docs):
                word_ids = np.repeat(word_range, bow[d].astype(np.int64))
                docs.append(" ".join(f"wd{w}" for w in word_ids))
        nodes.append(SyntheticNode(bow=bow, documents=docs, doc_topics=doc_topics))

    vocab_tokens = tuple(f"wd{i}" for i in range(vocab_size))
    return SyntheticCorpus(
        topic_vectors=topic_vectors, nodes=nodes, vocab_tokens=vocab_tokens
    )


def load_reference_npz(path: str) -> SyntheticCorpus:
    """Load a reference-format synthetic archive (single- or multi-node):
    keys ``topic_vectors``, ``doc_topics``, ``documents``
    (``main.py:138-146`` reads the same keys)."""
    with np.load(path, allow_pickle=True) as z:
        topic_vectors = z["topic_vectors"]
        docs = z["documents"]
        doc_topics = z["doc_topics"]
        vocab_size = int(z["vocab_size"]) if "vocab_size" in z else topic_vectors.shape[1]
    if docs.ndim == 1 and isinstance(docs[0], str):  # single node
        docs = docs[None, :]
        doc_topics = doc_topics[None, ...]
    nodes = []
    for i in range(len(docs)):
        node_docs = [
            d if isinstance(d, str) else " ".join(d) for d in list(docs[i])
        ]
        nodes.append(
            SyntheticNode(
                bow=_bow_from_wd_docs(node_docs, vocab_size),
                documents=node_docs,
                doc_topics=np.asarray(doc_topics[i]),
            )
        )
    return SyntheticCorpus(
        topic_vectors=topic_vectors,
        nodes=nodes,
        vocab_tokens=tuple(f"wd{i}" for i in range(vocab_size)),
    )


def _bow_from_wd_docs(docs: list[str], vocab_size: int) -> np.ndarray:
    bow = np.zeros((len(docs), vocab_size), dtype=np.float32)
    for i, doc in enumerate(docs):
        for tok in doc.split():
            bow[i, int(tok[2:])] += 1
    return bow
