"""The five BASELINE.json evaluation configs as runnable presets.

The counterpart of ``gfedntm_tpu/presets.py`` over the port: each preset
builds its federation end to end (data -> ``run_vocab_consensus`` ->
``FederatedTrainer.fit`` of ``AVITM`` or ``CombinedTM`` -> artifacts and
``eval.metrics``), with the JAX presets' registry, arguments, corpora and
summaries, plus ``device`` (``None`` -> the GPU, resolved as every port
entry point resolves it). ``hashing_embedder`` is
:mod:`gfedntm_tpu_torch.data.embeddings`' copy. ``scale`` shrinks
corpus/epoch sizes uniformly for smoke runs (scale=1.0 is the evaluation
regime).

Presets whose data is external (20Newsgroups needs a local sklearn cache;
the non-IID preset needs the Semantic Scholar parquet) raise a clear error
when the data is absent instead of downloading — this framework never
fetches over the network.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from gfedntm_tpu_torch.data.embeddings import hashing_embedder
from gfedntm_tpu_torch.data.loaders import RawCorpus, partition_corpus
from gfedntm_tpu_torch.device import resolve_device

__all__ = ["PRESETS", "PresetResult", "hashing_embedder"]


@dataclass
class PresetResult:
    summary: dict[str, Any]
    trainer: Any
    result: Any
    extras: dict[str, Any]


def _run_federation(
    corpora: list[RawCorpus],
    family: str,
    model_kwargs: dict[str, Any],
    num_epochs: int,
    contextual: bool = False,
    local_steps: int = 1,
    device=None,
) -> PresetResult:
    from gfedntm_tpu_torch.federated.consensus import run_vocab_consensus
    from gfedntm_tpu_torch.federated.trainer import FederatedTrainer
    from gfedntm_tpu_torch.models.avitm import AVITM
    from gfedntm_tpu_torch.models.ctm import CombinedTM

    consensus = run_vocab_consensus(corpora, contextual=contextual)
    kwargs = dict(model_kwargs, input_size=len(consensus.global_vocab),
                  num_epochs=num_epochs, device=device)
    if family == "ctm":
        template = CombinedTM(**kwargs)
    else:
        template = AVITM(**kwargs)
    trainer = FederatedTrainer(
        template, n_clients=len(corpora), local_steps=local_steps,
        device=device,
    )
    result = trainer.fit(consensus.datasets)
    summary = {
        "n_clients": len(corpora),
        "vocab_size": len(consensus.global_vocab),
        "global_steps": int(result.losses.shape[0]),
        "final_mean_loss": float(result.losses[-1].mean()),
    }
    return PresetResult(
        summary=summary, trainer=trainer, result=result,
        extras={"consensus": consensus},
    )


def _synthetic_corpora(
    n_nodes: int, scale: float, seed: int, n_topics: int
):
    from gfedntm_tpu_torch.data.synthetic import generate_synthetic_corpus

    corpus = generate_synthetic_corpus(
        vocab_size=max(100, int(5000 * scale)),
        n_topics=n_topics,
        n_docs=max(20, int(1000 * scale)),
        nwords=(
            (150, 250) if scale >= 1.0 else (20, 40)
        ),
        n_nodes=n_nodes,
        frozen_topics=max(1, n_topics // 10),
        seed=seed,
    )
    return [RawCorpus(documents=list(n.documents)) for n in corpus.nodes], corpus


def prodlda_1client_synthetic(
    scale: float = 1.0, seed: int = 0, device=None
) -> PresetResult:
    """Config 1: ProdLDA, 1-client federation, synthetic corpus (K=10) —
    the degenerate one-client average (SURVEY.md §7.3)."""
    device = resolve_device(device)
    corpora, gt = _synthetic_corpora(1, scale, seed, n_topics=10)
    res = _run_federation(
        corpora, "avitm",
        dict(n_components=10, hidden_sizes=(50, 50), batch_size=64, seed=seed),
        num_epochs=max(2, int(100 * scale)),
        device=device,
    )
    res.extras["ground_truth"] = gt
    return res


def neurallda_2client_iid(
    scale: float = 1.0, seed: int = 0, device=None
) -> PresetResult:
    """Config 2: NeuralLDA (AVITM), 2-client federation, synthetic IID
    split."""
    device = resolve_device(device)
    corpora, gt = _synthetic_corpora(1, scale, seed, n_topics=10)
    halves = partition_corpus(corpora[0], 2)
    res = _run_federation(
        halves, "avitm",
        dict(n_components=10, model_type="LDA", hidden_sizes=(50, 50),
             batch_size=64, seed=seed),
        num_epochs=max(2, int(100 * scale)),
        device=device,
    )
    res.extras["ground_truth"] = gt
    return res


def prodlda_5client_20ng(
    scale: float = 1.0, seed: int = 0, data_home: str | None = None,
    device=None,
) -> PresetResult:
    """Config 3: ProdLDA, 5-client federation, 20Newsgroups — the
    north-star wall-clock/NPMI benchmark. Needs a local sklearn cache."""
    device = resolve_device(device)
    from gfedntm_tpu_torch.data.loaders import load_20newsgroups

    corpus = load_20newsgroups(data_home=data_home)
    if scale < 1.0:
        n = max(100, int(len(corpus.documents) * scale))
        corpus = RawCorpus(documents=corpus.documents[:n])
    clients = partition_corpus(corpus, 5)
    return _run_federation(
        clients, "avitm",
        dict(n_components=50, hidden_sizes=(50, 50), batch_size=64,
             seed=seed),
        num_epochs=max(2, int(100 * scale)),
        device=device,
    )


def combinedtm_5client(
    scale: float = 1.0, seed: int = 0,
    embedder: Callable[[list[str]], np.ndarray] | None = None,
    device=None,
) -> PresetResult:
    """Config 4: CombinedTM (CTM) with contextual embeddings, 5-client
    federation. ``embedder`` defaults to the deterministic hashing stand-in;
    pass an SBERT callable for the reference regime."""
    device = resolve_device(device)
    corpora, gt = _synthetic_corpora(5, scale, seed, n_topics=10)
    embed = embedder or hashing_embedder(768 if scale >= 1.0 else 64)
    with_emb = [
        RawCorpus(documents=c.documents, embeddings=embed(c.documents))
        for c in corpora
    ]
    res = _run_federation(
        with_emb, "ctm",
        dict(n_components=10, hidden_sizes=(50, 50), batch_size=64,
             seed=seed,
             contextual_size=with_emb[0].embeddings.shape[1]),
        num_epochs=max(2, int(100 * scale)),
        contextual=True,
        device=device,
    )
    res.extras["ground_truth"] = gt
    return res


# The reference ships a tiny Semantic Scholar CS fixture in-repo
# (334 docs, 5 fieldsOfStudy categories, precomputed 192-d embeddings) —
# the runnable stand-in for the full S2 corpus of docker-compose.yaml:21-157.
# Read from a checkout of the reference under the working directory; this
# repository does not carry it.
S2CS_TINY_PARQUET = "reference/static/datasets/s2cs_tiny.parquet"


def noniid_fos_5client(
    parquet_path: str | None = None,
    fos_categories: list[str] | None = None,
    scale: float = 1.0,
    seed: int = 0,
    text_column: str = "lemmas",
    fos_column: str = "fieldsOfStudy",
    n_components: int = 50,
    compute_metrics: bool = True,
    local_steps: int = 1,
    device=None,
) -> PresetResult:
    """Config 5: non-IID FOS-partitioned real corpus, 5 clients (the
    collab_vs_non_collab regime); one client per category of the parquet's
    FOS column. Defaults to the reference's in-repo ``s2cs_tiny`` fixture
    (read-only); categories default to the 5 largest in the file.

    ``compute_metrics`` scores the aggregated global model with NPMI
    coherence (vs the pooled corpus), topic diversity, and inverted RBO —
    the ``collab_vs_non_collab/train.py:22-101`` metric set, computed
    natively."""
    import os

    from gfedntm_tpu_torch.data.loaders import load_parquet_partitions

    device = resolve_device(device)
    if fos_categories is not None and len(fos_categories) != 5:
        raise ValueError("the baseline config uses exactly 5 categories")
    if parquet_path is None:
        parquet_path = S2CS_TINY_PARQUET
    if not os.path.exists(parquet_path):
        raise FileNotFoundError(
            f"non-IID preset needs a FOS-partitioned parquet; {parquet_path} "
            "not found (this framework never downloads data)"
        )
    if fos_categories is None:
        import pandas as pd

        # column-projected read: the full S2 corpus this stands in for is
        # multi-GB with an embeddings column
        counts = (
            pd.read_parquet(parquet_path, columns=[fos_column])[fos_column]
            .dropna()
            .value_counts()
        )
        fos_categories = list(counts.index[:5])
        if len(fos_categories) != 5:
            raise ValueError(
                f"the baseline config needs 5 FOS categories; "
                f"{parquet_path} has {len(fos_categories)}"
            )
    clients = load_parquet_partitions(
        parquet_path, fos_categories, text_column=text_column,
        fos_column=fos_column,
    )
    if scale < 1.0:
        clients = [
            RawCorpus(documents=c.documents[: max(20, int(len(c.documents) * scale))])
            for c in clients
        ]
    res = _run_federation(
        clients, "avitm",
        dict(n_components=n_components, hidden_sizes=(50, 50), batch_size=64,
             seed=seed),
        num_epochs=max(2, int(100 * scale)),
        local_steps=local_steps,
        device=device,
    )
    res.summary["fos_categories"] = fos_categories
    res.summary["local_steps"] = local_steps
    if compute_metrics:
        from gfedntm_tpu_torch.eval.metrics import (
            inverted_rbo,
            npmi_coherence,
            topic_diversity,
        )

        global_model = res.trainer.make_global_model(res.result)
        # any client dataset carries the global id2token
        global_model.train_data = res.extras["consensus"].datasets[0]
        topics = global_model.get_topics(10)
        corpus_tokens = [
            doc.lower().split() for c in clients for doc in c.documents
        ]
        res.summary["metrics"] = {
            "npmi": npmi_coherence(topics, corpus_tokens, topn=10),
            "topic_diversity": topic_diversity(topics, topn=10),
            "inverted_rbo": inverted_rbo(topics, topn=10),
        }
        res.extras["topics"] = topics
    return res


def realtext_docstrings_5client(
    scale: float = 1.0,
    seed: int = 0,
    n_components: int = 50,
    local_steps: int = 1,
    compute_metrics: bool = True,
    device=None,
) -> PresetResult:
    """Offline real-text federation: the site-packages docstring corpus
    (``data/local_corpus.py``), one client per package family — the
    always-available substitute for the 20NG/S2 presets on air-gapped
    hosts. ``local_steps`` exposes the FedAvg-proper exchange period
    (results/realtext_federated: E = 5 local epochs reaches centralized
    NPMI on this corpus; E=1 reproduces the reference algorithm's
    diversity collapse)."""
    import os

    from gfedntm_tpu_torch.data.local_corpus import (
        DocstringCorpusConfig,
        build_docstring_corpus,
    )
    from gfedntm_tpu_torch.data.preproc import (
        PreprocConfig,
        load_wordlist,
        preprocess_corpus,
    )
    from gfedntm_tpu_torch.federated.consensus import run_vocab_consensus
    from gfedntm_tpu_torch.federated.trainer import FederatedTrainer
    from gfedntm_tpu_torch.models.avitm import AVITM

    device = resolve_device(device)
    clients, info = build_docstring_corpus(
        DocstringCorpusConfig(
            docs_per_client=max(100, int(3000 * scale)), seed=seed
        )
    )
    # Same preprocessing as results/realtext_federated: shared df table
    # over the pooled corpus (one filtered vocabulary for all clients),
    # English stopwords, then split back per client. no_below scales down
    # with the corpus so tiny smoke runs keep a usable vocabulary.
    stop = load_wordlist(
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "wordlists", "english_generic.json",
        )
    )
    pooled = [d for c in clients for d in c.documents]
    bounds = np.cumsum([0] + [len(c.documents) for c in clients])
    prep = preprocess_corpus(
        pooled,
        PreprocConfig(
            min_lemas=10, no_below=max(3, int(20 * scale)), no_above=0.3,
            keep_n=10_000, stopwords=stop,
        ),
    )
    docs_by_client: list[list[str]] = [[] for _ in clients]
    for pos, idx in enumerate(prep.kept_indices):
        c = int(np.searchsorted(bounds, idx, side="right") - 1)
        docs_by_client[c].append(" ".join(prep.docs[pos]))
    clients = [RawCorpus(documents=d) for d in docs_by_client]
    consensus = run_vocab_consensus(clients, max_features=10_000)
    template = AVITM(
        input_size=len(consensus.global_vocab), n_components=n_components,
        hidden_sizes=(50, 50), batch_size=64, seed=seed,
        num_epochs=max(2, int(100 * scale)), device=device,
    )
    trainer = FederatedTrainer(
        template, n_clients=len(clients), local_steps=local_steps,
        device=device,
    )
    result = trainer.fit(consensus.datasets)
    summary = {
        "n_clients": len(clients),
        "vocab_size": len(consensus.global_vocab),
        "global_steps": int(result.losses.shape[0]),
        "final_mean_loss": float(result.losses[-1].mean()),
        "corpus_info": info["per_client"],
    }
    res = PresetResult(
        summary=summary, trainer=trainer, result=result,
        extras={"consensus": consensus},
    )
    if compute_metrics:
        from gfedntm_tpu_torch.eval.metrics import npmi_coherence, topic_diversity

        gm = trainer.make_global_model(result, dataset=consensus.datasets[0])
        topics = gm.get_topics(10)
        tokens = [d.split() for c in clients for d in c.documents]
        res.summary["metrics"] = {
            "npmi": npmi_coherence(topics, tokens, topn=10),
            "topic_diversity": topic_diversity(topics, topn=10),
        }
        res.extras["topics"] = topics
    return res


PRESETS: dict[str, Callable[..., PresetResult]] = {
    "prodlda_1client_synthetic": prodlda_1client_synthetic,
    "neurallda_2client_iid": neurallda_2client_iid,
    "prodlda_5client_20ng": prodlda_5client_20ng,
    "combinedtm_5client": combinedtm_5client,
    "noniid_fos_5client": noniid_fos_5client,
    "realtext_docstrings_5client": realtext_docstrings_5client,
}
