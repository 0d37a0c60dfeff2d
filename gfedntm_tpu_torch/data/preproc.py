"""Topic-model corpus preprocessing pipeline (native, no Spark/Dask/Java).

A copy of ``gfedntm_tpu/data/preproc.py``, kept here so the port never
imports the JAX package. It rebuilds the reference's preprocessing stage,
which ``aux_scripts/preprocessing/text_preproc.py:44-136`` configures and
delegates to the external ``topicmodeler`` submodule: stop-word and
equivalence wordlists, then dictionary filtering with ``no_below`` /
``no_above`` / ``keep_n`` (gensim ``Dictionary.filter_extremes`` semantics)
and a ``min_lemas`` document floor. Wordlist JSON files use the reference
schema (``{"wordlist": [...]}``, the repository's ``wordlists/*.json``);
equivalence entries are ``"original:replacement"`` strings.
"""

from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass, field


def load_wordlist(path: str) -> list[str]:
    """Read a reference-format wordlist JSON (key ``wordlist``)."""
    with open(path) as f:
        payload = json.load(f)
    return list(payload.get("wordlist", []))


def parse_equivalences(entries: list[str]) -> dict[str, str]:
    """``"original:replacement"`` pairs → mapping (malformed entries skipped)."""
    out: dict[str, str] = {}
    for entry in entries:
        if ":" in entry:
            src, dst = entry.split(":", 1)
            src, dst = src.strip(), dst.strip()
            if src:
                out[src] = dst
    return out


@dataclass
class PreprocConfig:
    """Defaults mirror ``text_preproc.py:44-52``."""

    min_lemas: int = 15
    no_below: int = 15
    no_above: float = 0.4
    keep_n: int = 100_000
    stopwords: list[str] = field(default_factory=list)
    equivalences: list[str] = field(default_factory=list)


@dataclass
class PreprocResult:
    docs: list[list[str]]  # filtered token lists (surviving docs)
    kept_indices: list[int]  # positions of surviving docs in the input
    vocabulary: list[str]  # final filtered vocabulary (alphabetical)


def preprocess_corpus(
    docs: list[list[str]] | list[str], config: PreprocConfig | None = None
) -> PreprocResult:
    """Apply stopwords → equivalences → filter_extremes(no_below, no_above,
    keep_n) → min_lemas doc filter.

    ``filter_extremes`` semantics (gensim): drop tokens in fewer than
    ``no_below`` docs or more than ``no_above`` fraction of docs, then keep
    the ``keep_n`` most frequent survivors (by document frequency).
    """
    config = config or PreprocConfig()
    stop = set(config.stopwords)
    equiv = parse_equivalences(config.equivalences)

    token_docs: list[list[str]] = []
    for doc in docs:
        tokens = doc.split() if isinstance(doc, str) else list(doc)
        cleaned = []
        for tok in tokens:
            if tok in stop:
                continue
            tok = equiv.get(tok, tok)
            if tok and tok not in stop:
                cleaned.append(tok)
        token_docs.append(cleaned)

    n_docs = len(token_docs)
    df = Counter()
    for tokens in token_docs:
        df.update(set(tokens))

    max_df = config.no_above * n_docs
    survivors = [
        t for t, c in df.items() if c >= config.no_below and c <= max_df
    ]
    if len(survivors) > config.keep_n:
        # keep_n most document-frequent, ties broken alphabetically
        survivors.sort(key=lambda t: (-df[t], t))
        survivors = survivors[: config.keep_n]
    keep = set(survivors)

    out_docs, kept = [], []
    for i, tokens in enumerate(token_docs):
        filtered = [t for t in tokens if t in keep]
        if len(filtered) >= config.min_lemas:
            out_docs.append(filtered)
            kept.append(i)
    return PreprocResult(
        docs=out_docs, kept_indices=kept, vocabulary=sorted(keep)
    )
