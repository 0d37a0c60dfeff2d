"""Topic-model quality metrics (numpy only — no Mallet/topicmodeler).

A copy of ``gfedntm_tpu/eval/metrics.py``, kept here so the port never
imports the JAX package. It rebuilds the reference's evaluation stack:
- TSS / DSS ground-truth recovery scores
  (``experiments/dss_tss/run_simulation.py:321-355``),
- beta re-projection onto the full synthetic vocabulary
  (``src/utils/auxiliary_functions.py:441-483``),
- NPMI topic coherence, topic diversity, inverted RBO
  (the reference delegates these to the external topicmodeler submodule,
  ``src/aux_modules/tmWrapper/tm_wrapper.py:358-400``).
"""

from __future__ import annotations

import numpy as np


def topic_similarity_score(beta_pred: np.ndarray, beta_gt: np.ndarray) -> float:
    """TSS: for each ground-truth topic, the best Bhattacharyya-style match
    among predicted topics, summed (``run_simulation.py:321-334``).
    Max value = number of ground-truth topics."""
    sim = np.sqrt(np.clip(beta_pred, 0, None)) @ np.sqrt(
        np.clip(beta_gt, 0, None)
    ).T  # [K_pred, K_gt]
    return float(sim.max(axis=0).sum())


def document_similarity_score(
    thetas_pred: np.ndarray, thetas_gt: np.ndarray
) -> float:
    """DSS: total absolute difference of the doc-doc similarity matrices
    built from sqrt-thetas, normalized by document count
    (``run_simulation.py:337-355``); lower is better."""
    s_gt = np.sqrt(thetas_gt) @ np.sqrt(thetas_gt).T
    s_pred = np.sqrt(thetas_pred) @ np.sqrt(thetas_pred).T
    return float(np.abs(s_gt - s_pred).sum() / thetas_gt.shape[0])


def convert_topic_word_to_init_size(
    vocab_size: int,
    beta: np.ndarray,
    id2token: dict[int, str],
) -> np.ndarray:
    """Re-project trained betas (model vocabulary) onto the full synthetic
    vocabulary of ``wdN`` tokens for ground-truth comparison
    (``auxiliary_functions.py:441-483``)."""
    out = np.zeros((beta.shape[0], vocab_size), dtype=beta.dtype)
    for j in range(beta.shape[1]):
        token = id2token[j]
        out[:, int(token[2:])] = beta[:, j]
    return out


def npmi_coherence(
    topics: list[list[str]],
    corpus_tokens: list[list[str]],
    topn: int = 10,
    eps: float = 1e-12,
) -> float:
    """Mean pairwise NPMI of each topic's top words over a reference corpus
    (document-level co-occurrence, the standard c_npmi regime).

    One corpus pass builds doc-id sets for the topic words only; each word
    pair is then a set intersection — O(n_docs) total scans instead of one
    scan per pair (which crawls at 10k+ docs × K·topn² pairs)."""
    n_docs = len(corpus_tokens)
    if n_docs == 0:
        return 0.0

    needed = {w for topic in topics for w in topic[:topn]}
    doc_ids: dict[str, set[int]] = {w: set() for w in needed}
    for d, doc in enumerate(corpus_tokens):
        for w in needed.intersection(doc):
            doc_ids[w].add(d)

    scores = []
    for topic in topics:
        words = topic[:topn]
        for i in range(len(words)):
            for j in range(i + 1, len(words)):
                ids_i = doc_ids[words[i]]
                ids_j = doc_ids[words[j]]
                co = len(ids_i & ids_j) / n_docs
                if not ids_i or not ids_j or co == 0:
                    scores.append(-1.0)
                    continue
                p_i = len(ids_i) / n_docs
                p_j = len(ids_j) / n_docs
                pmi = np.log(co / (p_i * p_j))
                scores.append(float(pmi / (-np.log(co + eps))))
    return float(np.mean(scores)) if scores else 0.0


def topic_diversity(topics: list[list[str]], topn: int = 25) -> float:
    """Fraction of unique words among all topics' top-n words."""
    words = [w for t in topics for w in t[:topn]]
    if not words:
        return 0.0
    return len(set(words)) / len(words)


def rbo(list1: list[str], list2: list[str], p: float = 0.9) -> float:
    """Rank-biased overlap of two ranked lists (extrapolated RBO_ext,
    Webber et al. 2010)."""
    if not list1 or not list2:
        return 0.0
    s, l = (list1, list2) if len(list1) <= len(list2) else (list2, list1)
    s_len, l_len = len(s), len(l)
    x_l = len(set(s) & set(l))
    x_s = len(set(s) & set(l[:s_len]))

    # agreement at each depth
    a = []
    for d in range(1, l_len + 1):
        x_d = len(set(s[: min(d, s_len)]) & set(l[:d]))
        a.append(x_d / d)

    sum1 = sum(p ** (d + 1) * a[d] for d in range(l_len))
    sum2 = sum(
        p ** (d + 1) * x_s * (d + 1 - s_len) / (s_len * (d + 1))
        for d in range(s_len, l_len)
    )
    ext = ((x_l - x_s) / l_len + x_s / s_len) * p ** l_len
    return float((1 - p) / p * (sum1 + sum2) + ext)


def inverted_rbo(topics: list[list[str]], topn: int = 10, p: float = 0.9) -> float:
    """1 - mean pairwise RBO over topic pairs: a redundancy-aware diversity
    score (higher = more diverse topics)."""
    if len(topics) < 2:
        return 0.0
    vals = []
    for i in range(len(topics)):
        for j in range(i + 1, len(topics)):
            vals.append(rbo(topics[i][:topn], topics[j][:topn], p))
    return float(1.0 - np.mean(vals))


def random_baseline_tss(
    beta_gt: np.ndarray, seed: int = 0, n_topics: int | None = None
) -> float:
    """TSS of Dirichlet-random betas — the reference's 'baseline' arm
    (``run_simulation.py``'s random model)."""
    rng = np.random.default_rng(seed)
    k = n_topics or beta_gt.shape[0]
    random_betas = rng.dirichlet(np.ones(beta_gt.shape[1]), k)
    return topic_similarity_score(random_betas, beta_gt)
