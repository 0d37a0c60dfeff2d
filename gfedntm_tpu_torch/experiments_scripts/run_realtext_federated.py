"""Real-text federated run on the offline docstring corpus, over the port.

The twin of ``experiments_scripts/run_realtext_federated.py``: the
installed packages' docstrings (:mod:`gfedntm_tpu_torch.data.local_corpus`),
5 clients partitioned by package family (math / deep learning / cloud RPC /
NLP / data analysis), the same one-client-per-field non-IID shape as the
reference's docker-compose federation (``docker-compose.yaml:21-149``).
Shared preprocessing over the pooled corpus, vocabulary consensus, then:

Arms: federated parity (per-minibatch FedAvg, the reference algorithm),
federated local_steps at 1-epoch and 5-epoch exchange periods (the opt-in
FedAvg-proper fix) and centralized (context ceiling, ``AVITM.fit`` with
validation) — all scored with NPMI / topic diversity / inverted RBO
against the pooled corpus, plus top-10 topics in real words, each arm's
wall seconds and K1-K3 launches (on the GPU every training step launches
them). The corpus is whatever the interpreter's site-packages hold, which
differs between hosts: the report records its size (documents per client,
files scanned, vocabulary).

Run: python -m gfedntm_tpu_torch.experiments_scripts.run_realtext_federated
[out_json] [--device cpu|cuda]; writes
``results_torch/realtext_federated/metrics.json`` by default.
``REALTEXT_SCALE`` (0.1 shrinks docs and epochs for a smoke run),
``REALTEXT_SEED``, ``REALTEXT_EPOCHS`` and ``REALTEXT_ARMS`` (a
comma-list of exchange periods E) are the JAX script's, or keywords of
:func:`run`.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from gfedntm_tpu_torch.device import device_parser, resolve_device
from gfedntm_tpu_torch.experiments_scripts import K1_K3, REPO_ROOT, RESULTS, card, synchronize
from gfedntm_tpu_torch.ops.fused_decoder import launch_counts, launches_since

TOPN = 10
K = 50


def _env(name: str, given, default):
    return given if given is not None else os.environ.get(name, default)


def run(out_path: str | None = None, scale: float | None = None, seed: int | None = None,
        epochs: int | None = None, arms: str | None = None, device=None) -> dict:
    """The corpus, the federated arms and the centralized arm; returns the
    report, written to ``out_path`` (default
    ``results_torch/realtext_federated/metrics.json``)."""
    from gfedntm_tpu_torch.data.loaders import RawCorpus
    from gfedntm_tpu_torch.data.local_corpus import DocstringCorpusConfig, build_docstring_corpus
    from gfedntm_tpu_torch.data.preparation import prepare_dataset
    from gfedntm_tpu_torch.data.preproc import PreprocConfig, load_wordlist, preprocess_corpus
    from gfedntm_tpu_torch.eval.metrics import inverted_rbo, npmi_coherence, topic_diversity
    from gfedntm_tpu_torch.federated.consensus import run_vocab_consensus
    from gfedntm_tpu_torch.federated.trainer import FederatedTrainer
    from gfedntm_tpu_torch.models.avitm import AVITM

    dev = resolve_device(device)
    scale = float(_env("REALTEXT_SCALE", scale, "1.0"))
    seed = int(_env("REALTEXT_SEED", seed, "0"))
    epochs = int(_env("REALTEXT_EPOCHS", epochs, str(max(3, int(100 * scale)))))
    arms = _env("REALTEXT_ARMS", arms, None)

    # ---- corpus ---------------------------------------------------------
    t0 = time.perf_counter()
    clients_raw, info = build_docstring_corpus(
        DocstringCorpusConfig(docs_per_client=max(200, int(3000 * scale)), seed=seed))
    extract_s = time.perf_counter() - t0

    # Shared preprocessing over the POOLED corpus (one df table: the same
    # filtered vocabulary for every client), then split back per client.
    stop = load_wordlist(str(REPO_ROOT / "wordlists" / "english_generic.json"))
    pooled = [d for c in clients_raw for d in c.documents]
    bounds = np.cumsum([0] + [len(c.documents) for c in clients_raw])
    prep = preprocess_corpus(
        pooled,
        PreprocConfig(min_lemas=15, no_below=20, no_above=0.3, keep_n=10_000, stopwords=stop),
    )
    docs_by_client: list[list[str]] = [[] for _ in clients_raw]
    for pos, idx in enumerate(prep.kept_indices):
        client = int(np.searchsorted(bounds, idx, side="right") - 1)
        docs_by_client[client].append(" ".join(prep.docs[pos]))
    clients = [RawCorpus(documents=d) for d in docs_by_client]
    corpus_tokens = [list(d) for d in prep.docs]
    prep_s = time.perf_counter() - t0 - extract_s

    names = list(info["per_client"].keys())
    report: dict = {
        "backend": dev.type,
        "device": card(dev),
        "seed": seed,
        "corpus": {
            "source": "site-packages docstrings (offline; data/local_corpus.py)",
            "clients": {n: len(c.documents) for n, c in zip(names, clients)},
            "n_docs_after_prep": len(prep.docs),
            "vocab_after_prep": len(prep.vocabulary),
            "extract_s": round(extract_s, 1),
            "preproc_s": round(prep_s, 1),
            "extraction_info": info["per_client"],
            "extraction_totals": {k: v for k, v in info.items() if k != "per_client"},
        },
        "arms": {},
    }

    def score(topics):
        return {
            "npmi": round(npmi_coherence(topics, corpus_tokens, topn=TOPN), 4),
            "topic_diversity": round(topic_diversity(topics, topn=TOPN), 4),
            "inverted_rbo": round(inverted_rbo(topics, topn=TOPN), 4),
        }

    # ---- consensus + federated arms ------------------------------------
    consensus = run_vocab_consensus(clients, max_features=10_000)
    V = len(consensus.global_vocab)
    report["corpus"]["consensus_vocab"] = V
    steps_per_epoch = max(1, -(-max(len(d) for d in consensus.datasets) // 64))
    if arms:
        arm_list = [("federated_parity" if int(e) == 1 else f"federated_local_steps_E{int(e)}",
                     int(e)) for e in arms.split(",")]
    else:
        arm_list = [
            ("federated_parity", 1),
            ("federated_local_steps", steps_per_epoch),
            ("federated_local_steps_5ep", 5 * steps_per_epoch),
        ]
    for arm_name, local_steps in arm_list:
        template = AVITM(input_size=V, n_components=K, hidden_sizes=(50, 50), batch_size=64,
                         num_epochs=epochs, lr=2e-3, momentum=0.99, seed=seed, device=dev)
        trainer = FederatedTrainer(template, n_clients=len(clients), local_steps=local_steps,
                                   seed=seed, device=dev)
        before = launch_counts(K1_K3)
        synchronize(dev)
        t0 = time.perf_counter()
        result = trainer.fit(consensus.datasets)
        synchronize(dev)
        wall = time.perf_counter() - t0
        gm = trainer.make_global_model(result, dataset=consensus.datasets[0])
        topics = gm.get_topics(TOPN)
        report["arms"][arm_name] = {
            "local_steps": local_steps,
            "wall_s": round(wall, 1),
            "global_steps": int(result.losses.shape[0]),
            "client_steps": int(result.losses.size),
            "launches": launches_since(before),
            "final_mean_loss": float(result.losses[-1].mean()),
            **score(topics),
            "topics_top10": topics,
        }
        print(arm_name, json.dumps(report["arms"][arm_name])[:300], flush=True)

    # ---- centralized context arm ----------------------------------------
    union_docs = [d for c in clients for d in c.documents]
    train_data, val_data, input_size, _id2token, _, _ = prepare_dataset(union_docs)
    model = AVITM(input_size=input_size, n_components=K, hidden_sizes=(50, 50), batch_size=64,
                  num_epochs=epochs, lr=2e-3, momentum=0.99, seed=seed, device=dev)
    before = launch_counts(K1_K3)
    synchronize(dev)
    t0 = time.perf_counter()
    model.fit(train_data, val_data)
    synchronize(dev)
    wall = time.perf_counter() - t0
    topics_c = model.get_topics(TOPN)
    report["arms"]["centralized"] = {
        "wall_s": round(wall, 1),
        "training_steps": len(model.step_losses),
        "launches": launches_since(before),
        **score(topics_c),
        "topics_top10": topics_c,
    }

    out_path = out_path or str(RESULTS / "realtext_federated" / "metrics.json")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(
        {k: (v if k != "arms" else {
            a: {kk: vv for kk, vv in arm.items() if kk != "topics_top10"}
            for a, arm in v.items()
        }) for k, v in report.items()}, indent=2))
    return report


def main(argv: list[str] | None = None) -> int:
    p = device_parser(__doc__)
    p.add_argument("out_json", nargs="?", default=None)
    args = p.parse_args(argv)
    run(out_path=args.out_json, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
