"""Corpus loaders: reference npz/parquet formats + 20Newsgroups.

A copy of ``gfedntm_tpu/data/loaders.py``, kept here so the port never
imports the JAX package: :class:`RawCorpus`, the parquet loaders (``pandas``
imported when called), :func:`load_20newsgroups` (scikit-learn imported when
called; it reads a local cache and never downloads), and the client
partitioners :func:`partition_corpus`, :func:`heterogeneous_partition` and
:func:`imbalance_weights`. For the same seed they give the same shards.

Mirrors the reference entry point's data paths (``main.py:138-152``):
- real ``.parquet`` corpora with a text column, optional ``fos``
  category filter, and optional precomputed SBERT ``embeddings`` column
  (``client.py:321-356`` pulls the embeddings column for CTM).
- 20Newsgroups (the BASELINE.json config-3 corpus) from a local scikit-learn
  cache or an explicit path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class RawCorpus:
    """Host-side corpus: raw text plus optional per-doc extras."""

    documents: list[str]
    embeddings: np.ndarray | None = None  # [n_docs, contextual_size]
    labels: np.ndarray | None = None  # [n_docs] int or [n_docs, L] one-hot

    def __len__(self) -> int:
        return len(self.documents)


def load_parquet_corpus(
    path: str,
    text_column: str = "all_rawtext",
    fos: str | None = None,
    fos_column: str = "fos",
    embeddings_column: str = "embeddings",
    max_docs: int | None = None,
) -> RawCorpus:
    """Read a reference-format parquet corpus, optionally filtered to one
    ``fos`` category (``main.py:147-152``)."""
    import pandas as pd

    df = pd.read_parquet(path)
    if fos is not None:
        df = df[df[fos_column] == fos]
    if max_docs is not None:
        df = df.head(max_docs)
    if text_column not in df.columns:
        # fall back to the first string-typed column
        candidates = [c for c in df.columns if df[c].dtype == object]
        if not candidates:
            raise ValueError(f"no text column found in {path}")
        text_column = candidates[0]
    docs = df[text_column].astype(str).tolist()
    embeddings = None
    if embeddings_column in df.columns:
        embeddings = np.stack(
            [np.asarray(e, dtype=np.float32) for e in df[embeddings_column]]
        )
    return RawCorpus(documents=docs, embeddings=embeddings)


def load_parquet_partitions(
    path: str,
    categories: list[str],
    text_column: str = "all_rawtext",
    fos_column: str = "fos",
    embeddings_column: str = "embeddings",
) -> list[RawCorpus]:
    """One read of the parquet, partitioned into one :class:`RawCorpus` per
    FOS category — avoids re-reading a multi-GB file once per client the
    way per-category :func:`load_parquet_corpus` calls would."""
    import pandas as pd

    df = pd.read_parquet(path)
    if text_column not in df.columns:
        candidates = [c for c in df.columns if df[c].dtype == object]
        if not candidates:
            raise ValueError(f"no text column found in {path}")
        text_column = candidates[0]
    out = []
    for category in categories:
        part = df[df[fos_column] == category]
        embeddings = None
        if embeddings_column in part.columns:
            embeddings = np.stack(
                [
                    np.asarray(e, dtype=np.float32)
                    for e in part[embeddings_column]
                ]
            ) if len(part) else None
        out.append(
            RawCorpus(
                documents=part[text_column].astype(str).tolist(),
                embeddings=embeddings,
            )
        )
    return out


def load_20newsgroups(
    data_home: str | None = None, subset: str = "train"
) -> RawCorpus:
    """Load 20Newsgroups from a local sklearn cache (no download)."""
    from sklearn.datasets import fetch_20newsgroups

    bunch = fetch_20newsgroups(
        subset=subset,
        data_home=data_home,
        remove=("headers", "footers", "quotes"),
        download_if_missing=False,
    )
    return RawCorpus(
        documents=list(bunch.data), labels=np.asarray(bunch.target)
    )


def _subset(corpus: RawCorpus, idx: np.ndarray) -> RawCorpus:
    """One client shard of ``corpus`` at the given doc indices."""
    return RawCorpus(
        documents=[corpus.documents[i] for i in idx],
        embeddings=None
        if corpus.embeddings is None
        else corpus.embeddings[idx],
        labels=None
        if corpus.labels is None
        else np.asarray(corpus.labels)[idx],
    )


def imbalance_weights(n_clients: int, size_ratio: float) -> np.ndarray:
    """Geometric client-size weights whose largest/smallest ratio is
    ``size_ratio`` (1 = balanced) — the 10-100x client-size imbalance
    persona that stresses Horvitz-Thompson reweighting and sample
    weighting together (README "Scenario matrix")."""
    if size_ratio < 1.0:
        raise ValueError(f"size_ratio must be >= 1, got {size_ratio}")
    if n_clients == 1 or size_ratio == 1.0:
        return np.full(n_clients, 1.0 / n_clients)
    w = size_ratio ** (np.arange(n_clients) / (n_clients - 1))
    return w / w.sum()


def heterogeneous_partition(
    labels: "np.ndarray | None",
    n_docs: int,
    n_clients: int,
    alpha: float | None = None,
    size_ratio: float | None = None,
    seed: int = 0,
    min_docs: int = 1,
) -> list[np.ndarray]:
    """EXACT non-IID partition of ``n_docs`` docs into ``n_clients``
    index shards: every doc lands on exactly one client and the shard
    sizes sum to the corpus (multinomial splits, never rounding).

    Two orthogonal, composable axes:

    - ``alpha`` — Dirichlet-α label skew: per label class, client
      proportions are drawn from Dirichlet(α·1) and the class's docs
      split by an exact multinomial. α→∞ recovers ~IID mixtures; small α
      concentrates each class on few clients (the FL heterogeneity
      benchmark regime, arXiv:2309.13102). Requires ``labels``.
    - ``size_ratio`` — geometric client-size imbalance with
      largest/smallest = ratio (:func:`imbalance_weights`).

    When both are set, each class's Dirichlet proportions are tilted by
    the size weights (renormalized per class), so label skew and size
    skew compose. ``min_docs`` rebalances deterministically afterwards:
    starved shards take docs from the largest shard, preserving
    exactness. Fully seeded — the same inputs give the same partition.
    """
    if n_clients < 1:
        raise ValueError(f"n_clients must be >= 1, got {n_clients}")
    if alpha is not None and alpha <= 0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    if alpha is not None and labels is None:
        raise ValueError("Dirichlet-alpha partitioning needs labels")
    if min_docs * n_clients > n_docs:
        raise ValueError(
            f"min_docs={min_docs} x {n_clients} clients exceeds "
            f"{n_docs} docs"
        )
    rng = np.random.default_rng(seed)
    size_w = (
        imbalance_weights(n_clients, size_ratio)
        if size_ratio is not None
        else np.full(n_clients, 1.0 / n_clients)
    )
    if labels is None:
        labels = np.zeros(n_docs, dtype=np.int64)
    labels = np.asarray(labels)
    if len(labels) != n_docs:
        raise ValueError(
            f"labels length {len(labels)} != n_docs {n_docs}"
        )
    assign = np.full(n_docs, -1, dtype=np.int64)
    for cls in np.unique(labels):
        idx = np.flatnonzero(labels == cls)
        rng.shuffle(idx)
        p = (
            rng.dirichlet(np.full(n_clients, float(alpha)))
            if alpha is not None
            else np.ones(n_clients)
        )
        p = p * size_w
        p = p / p.sum()
        counts = rng.multinomial(len(idx), p)
        for c, part in enumerate(np.split(idx, np.cumsum(counts)[:-1])):
            assign[part] = c
    shards = [list(np.flatnonzero(assign == c)) for c in range(n_clients)]
    # Deterministic min_docs rebalance: starved shards draw from the
    # current largest shard (its tail docs), so totals stay exact.
    for c in range(n_clients):
        while len(shards[c]) < min_docs:
            donor = max(
                (k for k in range(n_clients) if k != c),
                key=lambda k: (len(shards[k]), -k),
            )
            if len(shards[donor]) <= min_docs:
                break  # nothing left to give without starving the donor
            shards[c].append(shards[donor].pop())
    return [np.asarray(sorted(s), dtype=np.int64) for s in shards]


def partition_corpus(
    corpus: RawCorpus,
    n_clients: int,
    seed: int = 0,
    iid: bool = True,
    alpha: float | None = None,
    size_ratio: float | None = None,
    min_docs: int = 1,
) -> list[RawCorpus]:
    """Split one corpus into per-client shards.

    Default modes (unchanged): ``iid=True`` shuffles then chunks evenly;
    ``iid=False`` sorts by label first (label-skewed non-IID, the
    collab_vs_non_collab regime of fos-partitioned corpora).

    Heterogeneity personas (README "Scenario matrix"): ``alpha`` and/or
    ``size_ratio`` route through :func:`heterogeneous_partition` —
    exact Dirichlet-α label skew and geometric client-size imbalance,
    composable and seeded.
    """
    n = len(corpus)
    if alpha is not None or size_ratio is not None:
        shards = heterogeneous_partition(
            None if corpus.labels is None else np.asarray(corpus.labels),
            n, n_clients, alpha=alpha, size_ratio=size_ratio, seed=seed,
            min_docs=min_docs,
        )
        return [_subset(corpus, shard) for shard in shards]
    rng = np.random.default_rng(seed)
    if iid or corpus.labels is None:
        order = rng.permutation(n)
    else:
        order = np.argsort(np.asarray(corpus.labels), kind="stable")
    return [
        _subset(corpus, shard) for shard in np.array_split(order, n_clients)
    ]
