"""Vocabulary building and BoW vectorization (CountVectorizer semantics).

A copy of ``gfedntm_tpu/data/vocab.py``, kept here so the port never imports
the JAX package. It uses the port's native library
(:mod:`gfedntm_tpu_torch.native`) and carries its own literal copy of
scikit-learn's 318-word ``ENGLISH_STOP_WORDS`` (:data:`ENGLISH_STOP_WORDS`),
so ``stop_words="english"`` filters the same words where scikit-learn is not
installed (the original takes the list from scikit-learn and has an empty
one without it).

The reference builds client vocabularies and vectorizes corpora with
sklearn's ``CountVectorizer`` (``client.py:358-376``, ``server.py:282-288``,
``pytorchavitm/utils/data_preparation.py:30-40``). This module reimplements
the exact semantics needed — lowercase, ``\\b\\w\\w+\\b`` token pattern,
optional english stop words, ``max_features`` by corpus frequency with
alphabetical tie-ordering — plus the C++ fast path for tokenizing, counting
and vectorizing large corpora on the host.

Vocabulary-consensus helpers mirror ``server.py:270-288``: the global
vocabulary is the sorted set-union of client vocabularies.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

from gfedntm_tpu_torch import native as _native

_TOKEN_RE = re.compile(r"(?u)\b\w\w+\b")

#: scikit-learn's ``sklearn.feature_extraction.text.ENGLISH_STOP_WORDS``
#: (the Glasgow Information Retrieval Group's list), word for word.
ENGLISH_STOP_WORDS = frozenset((
    "a", "about", "above", "across", "after", "afterwards", "again", "against", "all",
    "almost", "alone", "along", "already", "also", "although", "always", "am", "among",
    "amongst", "amoungst", "amount", "an", "and", "another", "any", "anyhow", "anyone",
    "anything", "anyway", "anywhere", "are", "around", "as", "at", "back", "be", "became",
    "because", "become", "becomes", "becoming", "been", "before", "beforehand", "behind",
    "being", "below", "beside", "besides", "between", "beyond", "bill", "both", "bottom",
    "but", "by", "call", "can", "cannot", "cant", "co", "con", "could", "couldnt", "cry",
    "de", "describe", "detail", "do", "done", "down", "due", "during", "each", "eg",
    "eight", "either", "eleven", "else", "elsewhere", "empty", "enough", "etc", "even",
    "ever", "every", "everyone", "everything", "everywhere", "except", "few", "fifteen",
    "fifty", "fill", "find", "fire", "first", "five", "for", "former", "formerly", "forty",
    "found", "four", "from", "front", "full", "further", "get", "give", "go", "had", "has",
    "hasnt", "have", "he", "hence", "her", "here", "hereafter", "hereby", "herein",
    "hereupon", "hers", "herself", "him", "himself", "his", "how", "however", "hundred",
    "i", "ie", "if", "in", "inc", "indeed", "interest", "into", "is", "it", "its",
    "itself", "keep", "last", "latter", "latterly", "least", "less", "ltd", "made", "many",
    "may", "me", "meanwhile", "might", "mill", "mine", "more", "moreover", "most",
    "mostly", "move", "much", "must", "my", "myself", "name", "namely", "neither", "never",
    "nevertheless", "next", "nine", "no", "nobody", "none", "noone", "nor", "not",
    "nothing", "now", "nowhere", "of", "off", "often", "on", "once", "one", "only", "onto",
    "or", "other", "others", "otherwise", "our", "ours", "ourselves", "out", "over", "own",
    "part", "per", "perhaps", "please", "put", "rather", "re", "same", "see", "seem",
    "seemed", "seeming", "seems", "serious", "several", "she", "should", "show", "side",
    "since", "sincere", "six", "sixty", "so", "some", "somehow", "someone", "something",
    "sometime", "sometimes", "somewhere", "still", "such", "system", "take", "ten", "than",
    "that", "the", "their", "them", "themselves", "then", "thence", "there", "thereafter",
    "thereby", "therefore", "therein", "thereupon", "these", "they", "thick", "thin",
    "third", "this", "those", "though", "three", "through", "throughout", "thru", "thus",
    "to", "together", "too", "top", "toward", "towards", "twelve", "twenty", "two", "un",
    "under", "until", "up", "upon", "us", "very", "via", "was", "we", "well", "were",
    "what", "whatever", "when", "whence", "whenever", "where", "whereafter", "whereas",
    "whereby", "wherein", "whereupon", "wherever", "whether", "which", "while", "whither",
    "who", "whoever", "whole", "whom", "whose", "why", "will", "with", "within", "without",
    "would", "yet", "you", "your", "yours", "yourself", "yourselves",
))


def get_stop_words(name: str | None) -> frozenset[str]:
    if name is None:
        return frozenset()
    if name == "english":
        return ENGLISH_STOP_WORDS
    raise ValueError(f"unknown stop_words {name!r}")


def tokenize(
    doc: str, lowercase: bool = True, token_pattern: str | None = None
) -> list[str]:
    """sklearn default analyzer: lowercase + ``(?u)\\b\\w\\w+\\b`` (or a
    custom ``token_pattern``, e.g. the ``[a-zA-Z]{2,}`` of
    ``preprocessing.py:47``)."""
    if lowercase:
        doc = doc.lower()
    pattern = _TOKEN_RE if token_pattern is None else re.compile(token_pattern)
    return pattern.findall(doc)


@dataclass
class Vocabulary:
    """An ordered token->id map plus its inverse. ``token_pattern`` records
    the analyzer the vocabulary was built with so ``vectorize`` tokenizes
    consistently (None = sklearn default ``\\b\\w\\w+\\b``)."""

    tokens: tuple[str, ...]
    token_pattern: str | None = None

    def __post_init__(self):
        self.token2id = {t: i for i, t in enumerate(self.tokens)}

    def __len__(self) -> int:
        return len(self.tokens)

    @property
    def id2token(self) -> dict[int, str]:
        return dict(enumerate(self.tokens))

    def __contains__(self, token: str) -> bool:
        return token in self.token2id


def _count_terms(
    corpus: Iterable[str], lowercase: bool, token_pattern: str | None
) -> dict[str, int]:
    """Corpus-wide token occurrence counts, via the C++ fast path
    (:mod:`gfedntm_tpu_torch.native`) when it can guarantee exact parity
    (default token pattern, ASCII text), else pure Python."""
    docs = corpus if isinstance(corpus, (list, tuple)) else list(corpus)
    if token_pattern is None:
        try:
            return _native.count_terms(docs, lowercase)
        except _native.NativeUnavailable:
            pass
    counts: dict[str, int] = {}
    for doc in docs:
        for tok in tokenize(doc, lowercase, token_pattern):
            counts[tok] = counts.get(tok, 0) + 1
    return counts


def build_vocabulary(
    corpus: Iterable[str],
    max_features: int | None = None,
    stop_words: str | None = None,
    lowercase: bool = True,
    token_pattern: str | None = None,
) -> Vocabulary:
    """Fit a vocabulary with CountVectorizer semantics.

    With ``max_features``, keep the most frequent terms (ties broken
    alphabetically, as sklearn's stable sort over the alphabetical vocab
    does), then order the kept terms alphabetically.
    """
    stops = get_stop_words(stop_words)
    counts = _count_terms(corpus, lowercase, token_pattern)
    if stops:
        counts = {t: c for t, c in counts.items() if t not in stops}
    terms = sorted(counts)
    if max_features is not None and len(terms) > max_features:
        # sklearn's _limit_features: keep argsort(-term_freqs)[:k] over the
        # alphabetical vocabulary (numpy's default introsort — ties resolve
        # exactly as sklearn's do), then features stay in alphabetical order.
        tfs = np.array([counts[t] for t in terms])
        keep = np.sort(np.argsort(-tfs, kind="quicksort")[:max_features])
        terms = [terms[i] for i in keep]
    return Vocabulary(tuple(terms), token_pattern=token_pattern)


def vectorize(
    corpus: Sequence[str],
    vocab: Vocabulary,
    lowercase: bool = True,
    dtype=np.float32,
) -> np.ndarray:
    """Dense document-term count matrix [n_docs, len(vocab)] against a FIXED
    vocabulary (``client.py:460-468``: local docs x global vocab)."""
    if vocab.token_pattern is None and dtype == np.float32:
        try:
            return _native.vectorize(
                corpus if isinstance(corpus, (list, tuple)) else list(corpus),
                vocab.tokens, lowercase,
            )
        except _native.NativeUnavailable:
            pass
    token2id = vocab.token2id
    n_docs, n_terms = len(corpus), len(vocab)
    X = np.zeros((n_docs, n_terms), dtype=dtype)
    for i, doc in enumerate(corpus):
        for tok in tokenize(doc, lowercase, vocab.token_pattern):
            j = token2id.get(tok)
            if j is not None:
                X[i, j] += 1
    return X


def union_vocabularies(vocabs: Sequence[Vocabulary]) -> Vocabulary:
    """Vocabulary consensus: sorted set-union (``server.py:270-279``)."""
    merged: set[str] = set()
    for v in vocabs:
        merged.update(v.tokens)
    return Vocabulary(tuple(sorted(merged)))
