"""Dataset preparation with the reference's public API.

A copy of ``gfedntm_tpu/data/preparation.py``, kept here so the port never
imports the JAX package, with one function rewritten: the train/validation
split (:func:`_train_test_split`) is scikit-learn's ``train_test_split``
with ``random_state=42`` re-implemented in numpy (the same permutation, so
the same split), since scikit-learn is not a dependency of the port. The
stop words are the port's vendored scikit-learn English list
(:data:`gfedntm_tpu_torch.data.vocab.ENGLISH_STOP_WORDS`), and
:class:`WhiteSpacePreprocessing` takes NLTK's list where the NLTK corpus is
installed and falls back to the English one as the original does.

Rebuilds (behavioral parity):
- ``prepare_dataset`` — ``src/models/base/pytorchavitm/utils/data_preparation.py:11-64``:
  75/25 train/val split (seed 42), CountVectorizer(lowercase, english
  stop-words) fit on the TRAIN portion only, val vectorized against the
  train vocabulary.
- ``prepare_ctm_dataset`` / ``prepare_hold_out_dataset`` /
  ``TopicModelDataPreparation`` —
  ``src/models/base/contextualized_topic_models/utils/data_preparation.py:65-328``.
  SBERT embedding generation is pluggable (``embedder`` callable); this
  environment precomputes embeddings (the reference likewise expects them
  precomputed in the parquet — its sentence-transformers import is commented
  out, ``data_preparation.py:5``).
- ``WhiteSpacePreprocessing`` —
  ``src/models/base/contextualized_topic_models/utils/preprocessing.py:6-60``:
  lowercase → punctuation→space → stop-word removal → top-N ``[a-zA-Z]{2,}``
  vocabulary → restrict docs to vocabulary → drop emptied docs.
"""

from __future__ import annotations

import string
from math import ceil
from typing import Callable, Sequence

import numpy as np

from gfedntm_tpu_torch.data.datasets import BowDataset, CTMDataset
from gfedntm_tpu_torch.data.vocab import (
    Vocabulary,
    build_vocabulary,
    get_stop_words,
    vectorize,
)


def _join_if_tokens(corpus: Sequence) -> list[str]:
    """The reference's corpora are lists of token-lists which it joins with
    spaces before vectorizing (``data_preparation.py:43``); accept both."""
    return [
        " ".join(doc) if not isinstance(doc, str) else doc for doc in corpus
    ]


def _train_test_split(items, *arrays, test_size: float = 0.25, seed: int = 42):
    """scikit-learn's ``train_test_split(items, *arrays, test_size=test_size,
    random_state=seed)`` (the reference's exact regime,
    ``data_preparation.py:35``) in numpy: ``ShuffleSplit``'s one
    permutation of ``np.random.RandomState(seed)``, its first
    ``ceil(test_size * n)`` positions the test rows (``test_size`` a
    fraction; an int is a count) and the rest the training rows, in that
    order. Returns ``[train, test]`` per input: lists for lists, arrays for
    arrays."""
    inputs = (items, *arrays)
    lengths = [len(a) for a in inputs]
    if len(set(lengths)) > 1:
        raise ValueError(
            f"Found input variables with inconsistent numbers of samples: {lengths}"
        )
    n = lengths[0]
    if isinstance(test_size, (int, np.integer)) and not isinstance(test_size, bool):
        if not 0 < test_size < n:
            raise ValueError(f"test_size={test_size} should be positive and smaller "
                             f"than the number of samples {n}")
        n_test = int(test_size)
    else:
        if not 0 < test_size < 1:
            raise ValueError(f"test_size={test_size} should be a float in the (0, 1) range")
        n_test = ceil(test_size * n)
    n_train = n - n_test
    if n_train <= 0:
        raise ValueError(f"With n_samples={n} and test_size={test_size} the training "
                         "set would be empty")
    order = np.random.RandomState(seed).permutation(n)
    test, train = order[:n_test], order[n_test:]
    out = []
    for a in inputs:
        for idx in (train, test):
            out.append(a[idx] if isinstance(a, np.ndarray) else [a[i] for i in idx])
    return out


def prepare_dataset(corpus, val_size: float = 0.25, seed: int = 42):
    """Returns ``(train_data, val_data, input_size, id2token, docs_train,
    vocab)`` — the reference's tuple with the fitted CountVectorizer replaced
    by the fitted :class:`Vocabulary` (same role: vectorize new text)."""
    docs_train, docs_val = _train_test_split(
        list(corpus), test_size=val_size, seed=seed
    )
    train_texts = _join_if_tokens(docs_train)
    vocab = build_vocabulary(train_texts, stop_words="english")
    id2token = vocab.id2token
    train_data = BowDataset(X=vectorize(train_texts, vocab), idx2token=id2token)
    val_data = BowDataset(
        X=vectorize(_join_if_tokens(docs_val), vocab), idx2token=id2token
    )
    return train_data, val_data, len(vocab), id2token, docs_train, vocab


class TopicModelDataPreparation:
    """Fit/transform/load around a vocabulary + a pluggable document embedder
    (``data_preparation.py:195-328``).

    ``embedder(list[str]) -> np.ndarray`` replaces the reference's SBERT
    model name; pass precomputed embeddings to skip it entirely.
    """

    def __init__(
        self,
        contextualized_model: str | None = None,
        embedder: Callable[[list[str]], np.ndarray] | None = None,
    ):
        self.contextualized_model = contextualized_model
        self.embedder = embedder
        self.vocab: tuple[str, ...] = ()
        self.id2token: dict[int, str] = {}
        self.vectorizer: Vocabulary | None = None
        self.label_index: dict | None = None

    def _embed(self, texts: list[str], custom: np.ndarray | None) -> np.ndarray:
        if custom is not None:
            return np.asarray(custom, dtype=np.float32)
        if self.embedder is None:
            raise ValueError(
                "no embedder configured and no custom_embeddings provided "
                "(this environment has no network egress for SBERT downloads; "
                "precompute embeddings as the reference's parquet does)"
            )
        return np.asarray(self.embedder(texts), dtype=np.float32)

    def _one_hot_labels(self, labels) -> np.ndarray | None:
        if labels is None:
            return None
        if self.label_index is None:
            classes = sorted(set(labels))
            self.label_index = {c: i for i, c in enumerate(classes)}
        n = len(self.label_index)
        out = np.zeros((len(labels), n), dtype=np.float32)
        for i, lab in enumerate(labels):
            out[i, self.label_index[lab]] = 1.0
        return out

    def fit(
        self,
        text_for_contextual: list[str],
        text_for_bow: list[str],
        labels=None,
        custom_embeddings: np.ndarray | None = None,
    ) -> CTMDataset:
        """Learn the BoW vocabulary and build the training CTMDataset
        (``data_preparation.py:232-274``)."""
        self.vectorizer = build_vocabulary(text_for_bow)
        self.vocab = self.vectorizer.tokens
        self.id2token = self.vectorizer.id2token
        X = vectorize(text_for_bow, self.vectorizer)
        X_ctx = self._embed(text_for_contextual, custom_embeddings)
        return CTMDataset(
            X=X, idx2token=self.id2token, X_ctx=X_ctx,
            labels=self._one_hot_labels(labels),
        )

    def transform(
        self,
        text_for_contextual: list[str],
        text_for_bow: list[str] | None = None,
        labels=None,
        custom_embeddings: np.ndarray | None = None,
    ) -> CTMDataset:
        """Vectorize new text against the FITTED vocabulary
        (``data_preparation.py:276-311``); without ``text_for_bow`` the BoW
        block is zeros (zero-shot inference regime)."""
        if self.vectorizer is None:
            raise RuntimeError("fit (or load) must be called before transform")
        if text_for_bow is not None:
            X = vectorize(text_for_bow, self.vectorizer)
        else:
            X = np.zeros(
                (len(text_for_contextual), len(self.vocab)), dtype=np.float32
            )
        X_ctx = self._embed(text_for_contextual, custom_embeddings)
        return CTMDataset(
            X=X, idx2token=self.id2token, X_ctx=X_ctx,
            labels=self._one_hot_labels(labels),
        )

    def load(
        self, contextualized_embeddings: np.ndarray, bow_embeddings: np.ndarray,
        id2token: dict[int, str], labels=None,
    ) -> CTMDataset:
        """Assemble a CTMDataset from precomputed pieces
        (``data_preparation.py:313-328``)."""
        X = np.asarray(
            bow_embeddings.toarray()
            if hasattr(bow_embeddings, "toarray")
            else bow_embeddings,
            dtype=np.float32,
        )
        return CTMDataset(
            X=X, idx2token=dict(id2token),
            X_ctx=np.asarray(contextualized_embeddings, dtype=np.float32),
            labels=self._one_hot_labels(labels),
        )


def prepare_ctm_dataset(
    corpus,
    unpreprocessed_corpus=None,
    custom_embeddings: np.ndarray | None = None,
    embedder: Callable[[list[str]], np.ndarray] | None = None,
    val_size: float = 0.25,
    seed: int = 42,
):
    """Returns ``(training_dataset, validation_dataset, input_size, id2token,
    qt, embeddings_train, custom_embeddings, docs_train)`` —
    ``data_preparation.py:65-161`` with a pluggable embedder."""
    if custom_embeddings is None and unpreprocessed_corpus is None:
        raise TypeError(
            "Custom embeddings or an unpreprocessed corpus to generate the "
            "embeddings from must be provided"
        )
    qt = TopicModelDataPreparation(embedder=embedder)
    if custom_embeddings is None:
        custom_embeddings = qt._embed(
            _join_if_tokens(unpreprocessed_corpus), None
        )
    custom_embeddings = np.asarray(custom_embeddings, dtype=np.float32)

    docs_train, docs_val, emb_train, emb_val = _train_test_split(
        list(corpus), custom_embeddings, test_size=val_size, seed=seed
    )
    train_texts = _join_if_tokens(docs_train)
    val_texts = _join_if_tokens(docs_val)

    qt.vectorizer = build_vocabulary(train_texts, stop_words="english")
    qt.vocab = qt.vectorizer.tokens
    qt.id2token = qt.vectorizer.id2token

    training_dataset = qt.load(
        emb_train, vectorize(train_texts, qt.vectorizer), qt.id2token
    )
    validation_dataset = qt.transform(
        text_for_contextual=val_texts, text_for_bow=val_texts,
        custom_embeddings=emb_val,
    )
    return (
        training_dataset, validation_dataset, len(qt.vocab), qt.id2token, qt,
        np.asarray(emb_train), custom_embeddings, docs_train,
    )


def prepare_hold_out_dataset(
    hold_out_corpus,
    qt: TopicModelDataPreparation,
    unpreprocessed_ho_corpus=None,
    embeddings_ho: np.ndarray | None = None,
):
    """Vectorize a hold-out corpus with a fitted preparation object
    (``data_preparation.py:163-192``)."""
    if embeddings_ho is None and unpreprocessed_ho_corpus is None:
        raise TypeError(
            "Custom embeddings or an unpreprocessed corpus to generate the "
            "embeddings from must be provided"
        )
    texts = _join_if_tokens(hold_out_corpus)
    if embeddings_ho is None:
        embeddings_ho = qt._embed(_join_if_tokens(unpreprocessed_ho_corpus), None)
    return qt.transform(
        text_for_contextual=texts, text_for_bow=texts,
        custom_embeddings=embeddings_ho,
    )


def _nltk_stopwords(language: str) -> set[str]:
    """The reference uses NLTK stop-word lists (``preprocessing.py:24``);
    prefer them when the NLTK corpus is installed locally, else fall back to
    the vendored scikit-learn English list (documented divergence: 318 vs
    179 words)."""
    try:  # pragma: no cover - depends on local nltk data
        from nltk.corpus import stopwords as nltk_stop

        return set(nltk_stop.words(language))
    except Exception:
        if language == "english":
            return set(get_stop_words("english"))
        raise ValueError(
            f"stop words for {language!r} need the NLTK stopwords corpus, "
            "which is not installed in this environment"
        ) from None


class WhiteSpacePreprocessing:
    """Minimal corpus preprocessing (``preprocessing.py:6-60``): lowercase,
    punctuation→spaces, stop-word removal, restrict to the
    ``vocabulary_size`` most frequent ``[a-zA-Z]{2,}`` tokens, drop emptied
    docs (returning the surviving raw docs alongside)."""

    def __init__(
        self,
        documents: list[str],
        stopwords_language: str = "english",
        vocabulary_size: int = 2000,
    ):
        self.documents = documents
        self.stopwords = _nltk_stopwords(stopwords_language)
        self.vocabulary_size = vocabulary_size

    def preprocess(self) -> tuple[list[str], list[str], list[str]]:
        table = str.maketrans(string.punctuation, " " * len(string.punctuation))
        cleaned = []
        for doc in self.documents:
            words = doc.lower().translate(table).split()
            cleaned.append(" ".join(w for w in words if w not in self.stopwords))

        vocab = build_vocabulary(
            cleaned, max_features=self.vocabulary_size,
            token_pattern=r"\b[a-zA-Z]{2,}\b",
        )
        keep = set(vocab.tokens)
        preprocessed_docs, unpreprocessed_docs = [], []
        for raw, doc in zip(self.documents, cleaned):
            filtered = " ".join(w for w in doc.split() if w in keep)
            if filtered:
                preprocessed_docs.append(filtered)
                unpreprocessed_docs.append(raw)
        return preprocessed_docs, unpreprocessed_docs, list(vocab.tokens)
