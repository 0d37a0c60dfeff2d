"""Word-mover's-distance evaluation between topic sets.

A copy of ``gfedntm_tpu/experiments/wmd.py`` (numpy only), kept here so the
port never imports the JAX package. It rebuilds
`aux_scripts/evaluation/wmd.py:13-110`: for every topic of a node
model, the WMD to each topic of a centralized model, summarized as the mean of
per-topic minima. The reference computes WMD with gensim's
``KeyedVectors.wmdistance`` over ``word2vec-google-news-300``; this rebuild
computes the same relaxed word-mover's distance natively from any
``{word: vector}`` mapping (numpy), and only *loading* pretrained gensim
vectors is gated on gensim being installed (it is not part of the baked
environment — SURVEY.md §2.4 treats this evaluation as an optional external
baseline).
"""

from __future__ import annotations

import logging
from typing import Mapping, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def _topic_vectors(
    topic: Sequence[str], embeddings: Mapping[str, np.ndarray]
) -> np.ndarray | None:
    vecs = [np.asarray(embeddings[w]) for w in topic if w in embeddings]
    if not vecs:
        return None
    return np.stack(vecs)


def relaxed_wmd(
    words1: Sequence[str],
    words2: Sequence[str],
    embeddings: Mapping[str, np.ndarray],
) -> float:
    """Relaxed WMD (Kusner et al. 2015's RWMD lower bound, symmetrized):
    each word travels to its nearest counterpart; the distance is the max of
    the two directed means. Out-of-vocabulary words are skipped, matching
    gensim's handling; returns inf when either side is fully OOV."""
    v1 = _topic_vectors(words1, embeddings)
    v2 = _topic_vectors(words2, embeddings)
    if v1 is None or v2 is None:
        return float("inf")
    # pairwise euclidean distances [n1, n2]
    d = np.sqrt(
        np.maximum(
            (v1 * v1).sum(1)[:, None]
            - 2.0 * (v1 @ v2.T)
            + (v2 * v2).sum(1)[None, :],
            0.0,
        )
    )
    return float(max(d.min(axis=1).mean(), d.min(axis=0).mean()))


def topic_set_wmd_matrix(
    topics_a: Sequence[Sequence[str]],
    topics_b: Sequence[Sequence[str]],
    embeddings: Mapping[str, np.ndarray],
) -> np.ndarray:
    """[len(topics_a), len(topics_b)] matrix of pairwise topic WMDs
    (`wmd.py:36-57`)."""
    out = np.zeros((len(topics_a), len(topics_b)))
    for i, ta in enumerate(topics_a):
        for j, tb in enumerate(topics_b):
            out[i, j] = relaxed_wmd(ta, tb, embeddings)
    return out


def wmd_centralized_vs_nodes(
    centralized_topics: Sequence[Sequence[str]],
    node_topics: Mapping[str, Sequence[Sequence[str]]],
    embeddings: Mapping[str, np.ndarray],
) -> dict[str, float]:
    """Per node model: mean over its topics of the minimum WMD to any
    centralized topic (`wmd.py:59-80` mean-min summary). Lower = the node's
    topics are better covered by the centralized model."""
    results: dict[str, float] = {}
    for node, topics in node_topics.items():
        mat = topic_set_wmd_matrix(topics, centralized_topics, embeddings)
        mins = mat.min(axis=1)
        finite = mins[np.isfinite(mins)]
        results[node] = float(finite.mean()) if finite.size else float("inf")
    return results


def load_gensim_embeddings(
    name: str = "word2vec-google-news-300",
) -> Mapping[str, np.ndarray]:
    """Load pretrained vectors via gensim's downloader (`wmd.py:13-20`).
    Gated: raises ImportError with guidance when gensim is unavailable."""
    try:
        import gensim.downloader  # type: ignore[import-not-found]
    except ImportError as e:  # pragma: no cover - env without gensim
        raise ImportError(
            "gensim is not installed in this environment; pass any "
            "{word: vector} mapping to the WMD functions instead"
        ) from e
    return gensim.downloader.load(name)  # pragma: no cover
