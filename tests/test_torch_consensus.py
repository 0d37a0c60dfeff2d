"""The raw-text flow in the port on the CPU, against the JAX package on the
same inputs: vocabulary building and consensus, the native BoW library,
data preparation, preprocessing, the corpus loaders and partitioners, and
the topic metrics.

- ``build_vocabulary``, ``union_vocabularies``, ``vectorize`` and
  ``run_vocab_consensus`` give equal token tuples and bitwise-equal BoW
  matrices on corpora with stop words, ``max_features`` ties, non-ASCII
  documents, a custom token pattern and synthetic ``wd*`` text.
- The port's native ``vectorize`` and ``count_terms`` are bitwise equal to
  the JAX package's native library's, raise ``NativeUnavailable`` where it
  does (non-ASCII text), and load a library built under the repository's
  ``build/gfedntm_tpu_torch/``, not the JAX package's.
- The vendored English stop words are scikit-learn's; the numpy
  train/validation split is ``train_test_split(random_state=42)``.
- ``preprocess_corpus``, ``prepare_dataset``, ``prepare_ctm_dataset``,
  ``prepare_hold_out_dataset``, ``WhiteSpacePreprocessing``, the parquet
  loaders and the partitioners give equal results.
- Every function of ``eval/metrics.py`` is bitwise equal to the JAX one.
- A small end-to-end flow (consensus -> ``FederatedTrainer.fit`` ->
  ``make_global_model`` -> ``get_topics`` -> metrics) ends with finite
  metrics in range.
"""

import numpy as np
import pytest
import torch

from gfedntm_tpu import native as j_native
from gfedntm_tpu.data import loaders as j_loaders
from gfedntm_tpu.data import preparation as j_prep
from gfedntm_tpu.data import preproc as j_preproc
from gfedntm_tpu.data import vocab as j_vocab
from gfedntm_tpu.data.datasets import CTMDataset as JCTMDataset
from gfedntm_tpu.eval import metrics as j_metrics
from gfedntm_tpu.federated.consensus import run_vocab_consensus as j_consensus
from gfedntm_tpu_torch import AVITM, FederatedTrainer, native
from gfedntm_tpu_torch.data import loaders, preparation, preproc, vocab
from gfedntm_tpu_torch.data.datasets import CTMDataset
from gfedntm_tpu_torch.data.synthetic import generate_synthetic_corpus
from gfedntm_tpu_torch.eval import metrics
from gfedntm_tpu_torch.federated.consensus import run_vocab_consensus

WORDS = ("topic model federated client server vocabulary the a of and is in to "
         "neural network gradient average beta theta word document corpus").split()


def _text_corpus(seed, n_docs=30, words=WORDS, lengths=(4, 30)):
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        n = int(rng.integers(*lengths))
        toks = [words[i] for i in rng.integers(0, len(words), size=n)]
        # Case and punctuation the analyzer must fold or split on.
        toks = [t.upper() if rng.random() < 0.1 else t for t in toks]
        docs.append(" ".join(toks) + rng.choice([".", "!", ", x y", " 42 a1_b"]))
    return docs


def _ties_corpus():
    """Every term appears exactly twice except two that appear three times:
    ``max_features`` cuts through a block of equal counts."""
    terms = [f"t{c}{d}" for c in "abcdefgh" for d in "xyz"]
    docs = [" ".join(terms[i::4]) for i in range(4)] * 2
    docs.append("tcz tgx")
    return docs


def _non_ascii_corpus():
    return ["café crème brûlée naïve", "Über straße zoë", "plain ascii words here",
            "déjà vu café", "naïve words café"]


def _wd_corpus(seed=3, nodes=2):
    corpus = generate_synthetic_corpus(vocab_size=300, n_topics=5, n_docs=40, n_nodes=nodes,
                                       seed=seed)
    return corpus, [node.documents for node in corpus.nodes]


CORPORA = {
    "stop_words": _text_corpus(0),
    "ties": _ties_corpus(),
    "non_ascii": _non_ascii_corpus(),
    "wd": sum(_wd_corpus()[1], []),
}
PATTERNS = {"default": None, "letters": r"\b[a-zA-Z]{2,}\b"}


def _same_vocab(got, want):
    assert isinstance(got, vocab.Vocabulary)
    assert got.tokens == want.tokens
    assert got.token_pattern == want.token_pattern
    assert got.token2id == want.token2id
    assert got.id2token == want.id2token


def _same_array(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Vocabulary and vectorization
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("max_features", [None, 3, 7, 50])
@pytest.mark.parametrize("stop_words", [None, "english"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_build_vocabulary_and_vectorize_match_jax(corpus, max_features, stop_words, pattern):
    docs = CORPORA[corpus]
    kw = dict(max_features=max_features, stop_words=stop_words,
              token_pattern=PATTERNS[pattern])
    got, want = vocab.build_vocabulary(docs, **kw), j_vocab.build_vocabulary(docs, **kw)
    _same_vocab(got, want)
    _same_array(vocab.vectorize(docs, got), j_vocab.vectorize(docs, want))


@pytest.mark.parametrize("lowercase", [True, False])
def test_vectorize_lowercase_and_dtype_match_jax(lowercase):
    docs = CORPORA["stop_words"] + CORPORA["non_ascii"]
    v = vocab.build_vocabulary(docs, lowercase=lowercase)
    jv = j_vocab.build_vocabulary(docs, lowercase=lowercase)
    _same_vocab(v, jv)
    for dtype in (np.float32, np.float64, np.int32):
        _same_array(vocab.vectorize(docs, v, lowercase=lowercase, dtype=dtype),
                    j_vocab.vectorize(docs, jv, lowercase=lowercase, dtype=dtype))


def test_tokenize_and_stop_words_match_jax():
    for doc in CORPORA["stop_words"][:5] + CORPORA["non_ascii"]:
        for pattern in PATTERNS.values():
            for lowercase in (True, False):
                assert (vocab.tokenize(doc, lowercase, pattern)
                        == j_vocab.tokenize(doc, lowercase, pattern))
    assert vocab.get_stop_words(None) == j_vocab.get_stop_words(None) == frozenset()
    assert vocab.get_stop_words("english") == j_vocab.get_stop_words("english")
    with pytest.raises(ValueError, match="unknown stop_words"):
        vocab.get_stop_words("klingon")


def test_vendored_stop_words_are_scikit_learns():
    from sklearn.feature_extraction.text import ENGLISH_STOP_WORDS

    assert vocab.ENGLISH_STOP_WORDS == frozenset(ENGLISH_STOP_WORDS)
    assert len(vocab.ENGLISH_STOP_WORDS) == 318


def test_union_vocabularies_matches_jax():
    parts = [CORPORA["stop_words"], CORPORA["ties"], CORPORA["wd"][:20]]
    got = vocab.union_vocabularies([vocab.build_vocabulary(p) for p in parts])
    want = j_vocab.union_vocabularies([j_vocab.build_vocabulary(p) for p in parts])
    _same_vocab(got, want)


# ---------------------------------------------------------------------------
# The native library
# ---------------------------------------------------------------------------
def test_native_builds_into_the_repository_build_directory():
    assert native.available() and j_native.available()
    lib = native._get_lib()
    assert lib is not j_native._get_lib()
    assert native.BUILD_DIR.parts[-2:] == ("build", "gfedntm_tpu_torch")
    assert any(native.BUILD_DIR.glob("bow_*.so"))
    assert (native._SRC.read_bytes() == j_native._SRC.read_bytes())


@pytest.mark.parametrize("corpus", ["stop_words", "ties", "wd"])
@pytest.mark.parametrize("lowercase", [True, False])
def test_native_vectorize_and_count_terms_match_jax_library(corpus, lowercase):
    docs = CORPORA[corpus]
    counts = native.count_terms(docs, lowercase)
    assert counts == j_native.count_terms(docs, lowercase)
    tokens = tuple(sorted(counts)) + ("absent",)
    _same_array(native.vectorize(docs, tokens, lowercase),
                j_native.vectorize(docs, tokens, lowercase))


def test_native_refuses_non_ascii_where_jax_library_does():
    docs = CORPORA["non_ascii"]
    for mod in (native, j_native):
        with pytest.raises(mod.NativeUnavailable, match="non-ASCII document"):
            mod.count_terms(docs)
        with pytest.raises(mod.NativeUnavailable, match="non-ASCII document"):
            mod.vectorize(docs, ("cafe",))
        with pytest.raises(mod.NativeUnavailable, match="non-ASCII vocabulary token"):
            mod.vectorize(["plain"], ("café",))
    # The dispatch counts the same in Python.
    v = vocab.build_vocabulary(docs)
    assert "café" in v and v.tokens == j_vocab.build_vocabulary(docs).tokens


def test_native_counts_equal_the_python_path():
    docs = CORPORA["stop_words"] + CORPORA["wd"][:10]
    python = {}
    for doc in docs:
        for tok in vocab.tokenize(doc):
            python[tok] = python.get(tok, 0) + 1
    assert native.count_terms(docs) == python


# ---------------------------------------------------------------------------
# Consensus
# ---------------------------------------------------------------------------
def _raw_clients(kind):
    if kind == "wd":
        return [loaders.RawCorpus(d) for d in _wd_corpus()[1]], [
            j_loaders.RawCorpus(d) for d in _wd_corpus()[1]]
    docs = {"text": (_text_corpus(1), _text_corpus(2), _ties_corpus()),
            "non_ascii": (_non_ascii_corpus(), _text_corpus(4))}[kind]
    return [loaders.RawCorpus(list(d)) for d in docs], [j_loaders.RawCorpus(list(d))
                                                        for d in docs]


@pytest.mark.parametrize("kind", ["text", "non_ascii", "wd"])
@pytest.mark.parametrize("max_features", [None, 5, 2000])
@pytest.mark.parametrize("stop_words", [None, "english"])
def test_run_vocab_consensus_matches_jax(kind, max_features, stop_words):
    mine, theirs = _raw_clients(kind)
    got = run_vocab_consensus(mine, max_features=max_features, stop_words=stop_words)
    want = j_consensus(theirs, max_features=max_features, stop_words=stop_words)
    _same_vocab(got.global_vocab, want.global_vocab)
    assert len(got.local_vocabs) == len(want.local_vocabs)
    for g, w in zip(got.local_vocabs, want.local_vocabs):
        _same_vocab(g, w)
    for g, w in zip(got.datasets, want.datasets):
        assert type(g).__name__ == "BowDataset"
        _same_array(g.X, w.X)
        assert g.idx2token == w.idx2token


def test_contextual_consensus_matches_jax():
    rng = np.random.default_rng(0)
    mine, theirs = [], []
    for i, docs in enumerate((_text_corpus(5, 12), _text_corpus(6, 9))):
        emb = rng.normal(size=(len(docs), 4)).astype(np.float32)
        labels = rng.integers(0, 3, size=len(docs))
        mine.append(loaders.RawCorpus(docs, embeddings=emb, labels=labels))
        theirs.append(j_loaders.RawCorpus(docs, embeddings=emb, labels=labels))
    got = run_vocab_consensus(mine, contextual=True, label_size=3)
    want = j_consensus(theirs, contextual=True, label_size=3)
    for g, w in zip(got.datasets, want.datasets):
        assert isinstance(g, CTMDataset)
        for name in ("X", "X_ctx", "labels"):
            _same_array(getattr(g, name), getattr(w, name))
        assert g.contextual_size == w.contextual_size == 4
    with pytest.raises(ValueError, match="requires embeddings"):
        run_vocab_consensus([loaders.RawCorpus(["a b"])], contextual=True)


def test_ctm_dataset_validates_as_jax():
    X = np.ones((3, 4))
    for cls in (CTMDataset, JCTMDataset):
        with pytest.raises(ValueError, match="requires contextual"):
            cls(X=X)
        with pytest.raises(ValueError, match="length mismatch"):
            cls(X=X, X_ctx=np.ones((2, 2)))
        with pytest.raises(ValueError, match="labels"):
            cls(X=X, X_ctx=np.ones((3, 2)), labels=np.ones((2, 2)))


def test_synthetic_wd_consensus_recovers_the_synthetic_bow():
    """Each client's BoW against the global vocabulary is the synthetic
    BoW's columns taken in the vocabulary's order."""
    corpus, docs = _wd_corpus()
    res = run_vocab_consensus([loaders.RawCorpus(d) for d in docs], max_features=None)
    cols = [int(t[2:]) for t in res.global_vocab.tokens]
    for node, ds in zip(corpus.nodes, res.datasets):
        _same_array(ds.X, node.bow[:, cols])
        assert node.bow[:, np.setdiff1d(np.arange(300), cols)].sum() == 0


# ---------------------------------------------------------------------------
# Data preparation and preprocessing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 3, 4, 7, 10, 33, 101])
@pytest.mark.parametrize("test_size", [0.25, 0.1, 0.5, 0.9, 1, 3])
def test_numpy_split_is_scikit_learns_train_test_split(n, test_size):
    from sklearn.model_selection import train_test_split

    items = [f"doc{i}" for i in range(n)]
    arr = np.arange(2 * n, dtype=np.float32).reshape(n, 2)
    try:
        want = train_test_split(items, arr, test_size=test_size, random_state=42)
    except ValueError:
        with pytest.raises(ValueError):
            preparation._train_test_split(items, arr, test_size=test_size)
        return
    got = preparation._train_test_split(items, arr, test_size=test_size)
    assert got[0] == want[0] and got[1] == want[1]
    _same_array(got[2], want[2])
    _same_array(got[3], want[3])


def test_numpy_split_refuses_inconsistent_lengths():
    with pytest.raises(ValueError, match="inconsistent numbers of samples"):
        preparation._train_test_split([1, 2, 3], np.zeros(2))


@pytest.mark.parametrize("as_tokens", [False, True])
def test_prepare_dataset_matches_jax(as_tokens):
    docs = _text_corpus(7, 40)
    corpus = [d.split() for d in docs] if as_tokens else docs
    got, want = preparation.prepare_dataset(corpus), j_prep.prepare_dataset(corpus)
    for g, w in zip(got[:2], want[:2]):
        _same_array(g.X, w.X)
        assert g.idx2token == w.idx2token
    assert got[2:4] == want[2:4]
    assert got[4] == want[4]
    _same_vocab(got[5], want[5])


def test_prepare_ctm_and_hold_out_datasets_match_jax():
    docs = _text_corpus(8, 24)
    emb = np.random.default_rng(1).normal(size=(24, 5)).astype(np.float32)
    got = preparation.prepare_ctm_dataset(docs, custom_embeddings=emb)
    want = j_prep.prepare_ctm_dataset(docs, custom_embeddings=emb)
    for g, w in zip(got[:2], want[:2]):
        for name in ("X", "X_ctx"):
            _same_array(getattr(g, name), getattr(w, name))
    assert got[2:4] == want[2:4]
    _same_array(got[5], want[5])
    _same_array(got[6], want[6])
    assert got[7] == want[7]
    ho_docs = _text_corpus(9, 6)
    ho_emb = np.ones((6, 5), np.float32)
    got_ho = preparation.prepare_hold_out_dataset(ho_docs, got[4], embeddings_ho=ho_emb)
    want_ho = j_prep.prepare_hold_out_dataset(ho_docs, want[4], embeddings_ho=ho_emb)
    _same_array(got_ho.X, want_ho.X)
    with pytest.raises(TypeError, match="Custom embeddings"):
        preparation.prepare_ctm_dataset(docs)


def test_topic_model_data_preparation_matches_jax():
    docs = _text_corpus(10, 10)
    labels = ["x", "y", "x", "z", "y", "x", "x", "z", "y", "y"]

    def embed(texts):
        return np.array([[len(t), t.count(" ")] for t in texts], np.float32)

    got = preparation.TopicModelDataPreparation(embedder=embed)
    want = j_prep.TopicModelDataPreparation(embedder=embed)
    a, b = got.fit(docs, docs, labels=labels), want.fit(docs, docs, labels=labels)
    for name in ("X", "X_ctx", "labels"):
        _same_array(getattr(a, name), getattr(b, name))
    assert got.vocab == want.vocab and got.id2token == want.id2token
    a, b = got.transform(docs[:3]), want.transform(docs[:3])
    _same_array(a.X, b.X)
    with pytest.raises(RuntimeError, match="fit"):
        preparation.TopicModelDataPreparation().transform(docs)


@pytest.mark.parametrize("size", [5, 2000])
def test_whitespace_preprocessing_matches_jax(size):
    docs = _text_corpus(11, 20) + ["", "the and of"]
    got = preparation.WhiteSpacePreprocessing(docs, vocabulary_size=size).preprocess()
    want = j_prep.WhiteSpacePreprocessing(docs, vocabulary_size=size).preprocess()
    assert got == want


@pytest.mark.parametrize("config", [
    {},
    dict(min_lemas=2, no_below=2, no_above=0.9, keep_n=8),
    dict(min_lemas=1, no_below=1, no_above=1.0, keep_n=3,
         stopwords=["the", "a"], equivalences=["neural:nn", "network:nn", "bad", ":x"]),
])
def test_preprocess_corpus_matches_jax(config):
    docs = _text_corpus(12, 40, lengths=(10, 40))
    docs = docs[:20] + [d.lower().split() for d in docs[20:]]
    got = preproc.preprocess_corpus(docs, preproc.PreprocConfig(**config))
    want = j_preproc.preprocess_corpus(docs, j_preproc.PreprocConfig(**config))
    assert (got.docs, got.kept_indices, got.vocabulary) == (
        want.docs, want.kept_indices, want.vocabulary)


def test_wordlists_load_as_jax(tmp_path):
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "wordlists"
    paths = sorted(root.glob("*.json"))
    assert paths
    for path in paths:
        assert preproc.load_wordlist(str(path)) == j_preproc.load_wordlist(str(path))
    entries = ["a:b", "c : d", "nocolon", ":e", "f:g:h"]
    assert preproc.parse_equivalences(entries) == j_preproc.parse_equivalences(entries)


# ---------------------------------------------------------------------------
# Loaders and partitioners
# ---------------------------------------------------------------------------
def _labelled(n=60):
    rng = np.random.default_rng(2)
    return (loaders.RawCorpus(_text_corpus(13, n), embeddings=rng.normal(size=(n, 3)),
                              labels=rng.integers(0, 4, size=n)),
            j_loaders.RawCorpus(_text_corpus(13, n), embeddings=rng.normal(size=(n, 3)),
                                labels=rng.integers(0, 4, size=n)))


@pytest.mark.parametrize("kw", [
    dict(), dict(iid=False), dict(alpha=0.1), dict(alpha=10.0, size_ratio=5.0),
    dict(size_ratio=3.0, min_docs=4), dict(seed=7),
])
def test_partition_corpus_matches_jax(kw):
    mine, theirs = _labelled()
    theirs.embeddings, theirs.labels = mine.embeddings, mine.labels
    got = loaders.partition_corpus(mine, 4, **kw)
    want = j_loaders.partition_corpus(theirs, 4, **kw)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.documents == w.documents and len(g) == len(w)
        _same_array(g.embeddings, w.embeddings)
        _same_array(np.asarray(g.labels), np.asarray(w.labels))


@pytest.mark.parametrize("n_clients, ratio", [(1, 3.0), (4, 1.0), (5, 100.0)])
def test_imbalance_weights_match_jax(n_clients, ratio):
    _same_array(loaders.imbalance_weights(n_clients, ratio),
                j_loaders.imbalance_weights(n_clients, ratio))


def test_partitioner_refusals_match_jax():
    for mod in (loaders, j_loaders):
        with pytest.raises(ValueError, match="size_ratio"):
            mod.imbalance_weights(3, 0.5)
        with pytest.raises(ValueError, match="needs labels"):
            mod.heterogeneous_partition(None, 10, 2, alpha=1.0)
        with pytest.raises(ValueError, match="exceeds"):
            mod.heterogeneous_partition(None, 3, 2, min_docs=2)
        with pytest.raises(ValueError, match="n_clients"):
            mod.heterogeneous_partition(None, 3, 0)


def test_parquet_loaders_match_jax(tmp_path):
    import pandas as pd

    docs = _text_corpus(14, 12)
    df = pd.DataFrame({"all_rawtext": docs, "fos": ["cs", "bio", "cs", "math"] * 3,
                       "embeddings": [np.full(3, i, np.float32) for i in range(12)]})
    path = str(tmp_path / "corpus.parquet")
    df.to_parquet(path)
    for kw in (dict(), dict(fos="cs"), dict(max_docs=5), dict(text_column="missing")):
        got, want = loaders.load_parquet_corpus(path, **kw), j_loaders.load_parquet_corpus(
            path, **kw)
        assert got.documents == want.documents
        _same_array(got.embeddings, want.embeddings)
    got = loaders.load_parquet_partitions(path, ["cs", "bio", "none"])
    want = j_loaders.load_parquet_partitions(path, ["cs", "bio", "none"])
    for g, w in zip(got, want):
        assert g.documents == w.documents
        assert (g.embeddings is None) == (w.embeddings is None)
        if g.embeddings is not None:
            _same_array(g.embeddings, w.embeddings)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------
def _topics(seed, k=6, n=12, words=40):
    rng = np.random.default_rng(seed)
    return [[f"w{j}" for j in rng.choice(words, size=n, replace=False)] for _ in range(k)]


def _token_docs(seed, n_docs=50, words=40):
    rng = np.random.default_rng(seed)
    return [[f"w{j}" for j in rng.integers(0, words, size=rng.integers(0, 15))]
            for _ in range(n_docs)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topic_metrics_are_jax_s_bitwise(seed):
    topics, docs = _topics(seed), _token_docs(seed)
    for topn in (3, 10):
        assert metrics.npmi_coherence(topics, docs, topn) == j_metrics.npmi_coherence(
            topics, docs, topn)
        assert metrics.topic_diversity(topics, topn) == j_metrics.topic_diversity(topics, topn)
        assert metrics.inverted_rbo(topics, topn) == j_metrics.inverted_rbo(topics, topn)
    for p in (0.5, 0.9):
        assert metrics.rbo(topics[0], topics[1], p) == j_metrics.rbo(topics[0], topics[1], p)
        assert metrics.rbo(topics[0][:4], topics[1], p) == j_metrics.rbo(topics[0][:4],
                                                                         topics[1], p)
    assert metrics.npmi_coherence(topics, []) == j_metrics.npmi_coherence(topics, []) == 0.0
    assert metrics.topic_diversity([]) == j_metrics.topic_diversity([]) == 0.0
    assert metrics.inverted_rbo(topics[:1]) == j_metrics.inverted_rbo(topics[:1]) == 0.0
    assert metrics.rbo([], topics[0]) == j_metrics.rbo([], topics[0]) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_recovery_scores_are_jax_s_bitwise(seed):
    rng = np.random.default_rng(seed)
    beta_gt = rng.dirichlet(np.ones(30), 5)
    beta_pred = rng.dirichlet(np.ones(30), 7)
    thetas_gt, thetas_pred = rng.dirichlet(np.ones(5), 20), rng.dirichlet(np.ones(5), 20)
    assert metrics.topic_similarity_score(beta_pred, beta_gt) == (
        j_metrics.topic_similarity_score(beta_pred, beta_gt))
    assert metrics.document_similarity_score(thetas_pred, thetas_gt) == (
        j_metrics.document_similarity_score(thetas_pred, thetas_gt))
    for k in (None, 3):
        assert metrics.random_baseline_tss(beta_gt, seed, k) == j_metrics.random_baseline_tss(
            beta_gt, seed, k)
    id2token = {j: f"wd{c}" for j, c in enumerate(rng.choice(50, size=30, replace=False))}
    _same_array(metrics.convert_topic_word_to_init_size(50, beta_pred, id2token),
                j_metrics.convert_topic_word_to_init_size(50, beta_pred, id2token))


# ---------------------------------------------------------------------------
# The flow, end to end on the CPU
# ---------------------------------------------------------------------------
def test_raw_text_flow_end_to_end_on_the_cpu():
    corpus, docs = _wd_corpus(seed=5)
    res = run_vocab_consensus([loaders.RawCorpus(d) for d in docs], max_features=None)
    V = len(res.global_vocab)
    template = AVITM(input_size=V, n_components=5, hidden_sizes=(16, 16), batch_size=16,
                     num_epochs=2, device="cpu")
    trainer = FederatedTrainer(template, n_clients=2, device="cpu")
    result = trainer.fit(res.datasets)
    assert np.isfinite(result.losses).all() and result.losses.shape == (6, 2)
    model = trainer.make_global_model(result, res.datasets[0])
    topics = model.get_topics(10)
    assert len(topics) == 5 and all(t[0].startswith("wd") for t in topics)
    tokens = [d.split() for d in sum(docs, [])]
    npmi = metrics.npmi_coherence(topics, tokens)
    diversity = metrics.topic_diversity(topics)
    assert np.isfinite(npmi) and -1.0 <= npmi <= 1.0
    assert 0.0 < diversity <= 1.0
    assert npmi == j_metrics.npmi_coherence(topics, tokens)
    assert isinstance(result.client_params[0]["beta"], torch.Tensor)
