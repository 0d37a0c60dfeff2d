"""Artifacts for BASELINE configs 2 and 4 over the port.

The twin of ``experiments_scripts/run_presets_24.py``: config 2
(NeuralLDA, 2-client IID) and config 4 (CombinedTM with contextual
embeddings, 5-client) through the port's presets
(:func:`gfedntm_tpu_torch.presets.neurallda_2client_iid`,
:func:`~gfedntm_tpu_torch.presets.combinedtm_5client`) at scale 1.0. Per
config: the federation summary (clients, vocab, steps, final loss),
ground-truth TSS of the aggregated global model (the corpora are
synthetic: single softmax, correct word mapping), topic diversity, the
wall seconds and the K1-K3 launches. Config 2's LDA decode launches no
kernel; config 4's CombinedTM launches K1-K3 on every client step on the
GPU. Reference regime: CTM 5-client is the shipped default
(``docker-compose.yaml:21-157``).

Run: python -m gfedntm_tpu_torch.experiments_scripts.run_presets_24
[out_json] [--device cpu|cuda]; writes ``results_torch/presets_24/metrics.json``
by default.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from gfedntm_tpu_torch.device import device_parser, resolve_device
from gfedntm_tpu_torch.experiments_scripts import K1_K3, RESULTS, card, synchronize, tss_of
from gfedntm_tpu_torch.ops.fused_decoder import launch_counts, launches_since


def quality(res) -> dict:
    """TSS of the global model against the generator's topics, its random
    floor, topic diversity and the top-10 topics."""
    from gfedntm_tpu_torch.eval.metrics import topic_diversity, topic_similarity_score

    gt = res.extras["ground_truth"]
    consensus = res.extras["consensus"]
    model = res.trainer.make_global_model(res.result, dataset=consensus.datasets[0])
    beta = model.model.beta.detach().float().cpu().numpy()
    tss = tss_of(beta, gt.topic_vectors, consensus.global_vocab.id2token)
    k = beta.shape[0]
    rand_tss = float(topic_similarity_score(
        np.random.default_rng(99).dirichlet(np.full(gt.topic_vectors.shape[1], 0.01), k),
        gt.topic_vectors))
    topics = model.get_topics(10)
    return {
        "tss_vs_ground_truth": round(float(tss), 4),
        "tss_max": k,
        "tss_random_floor": round(rand_tss, 4),
        "topic_diversity": round(topic_diversity(topics, topn=10), 4),
        "topics_top10": topics,
    }


def run(out_path: str | None = None, scale: float = 1.0, device=None) -> dict:
    """Both presets at ``scale``; returns the report, written to
    ``out_path`` (default ``results_torch/presets_24/metrics.json``)."""
    from gfedntm_tpu_torch.presets import combinedtm_5client, neurallda_2client_iid

    dev = resolve_device(device)

    def timed(preset):
        before = launch_counts(K1_K3)
        synchronize(dev)
        t0 = time.perf_counter()
        res = preset(scale=scale, device=dev)
        synchronize(dev)
        return res, time.perf_counter() - t0, launches_since(before)

    report: dict = {"backend": dev.type, "device": card(dev), "scale": scale, "configs": {}}
    res2, wall, launches = timed(neurallda_2client_iid)
    report["configs"]["config2_neurallda_2client_iid"] = {
        "wall_s": round(wall, 1),
        "summary": res2.summary,
        "launches": launches,
        "client_steps": int(res2.result.losses.size),
        **quality(res2),
    }
    print("config 2 done", flush=True)

    res4, wall, launches = timed(combinedtm_5client)
    report["configs"]["config4_combinedtm_5client"] = {
        "wall_s": round(wall, 1),
        "summary": res4.summary,
        "launches": launches,
        "client_steps": int(res4.result.losses.size),
        "embedder": "deterministic hashing stand-in, 768-d (SBERT needs network egress; the "
                    "CTM contextual path is identical)",
        **quality(res4),
    }

    out_path = out_path or str(RESULTS / "presets_24" / "metrics.json")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w", encoding="utf8") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(
        {c: {k: v for k, v in d.items() if k != "topics_top10"}
         for c, d in report["configs"].items()}, indent=2))
    return report


def main(argv: list[str] | None = None) -> int:
    p = device_parser(__doc__)
    p.add_argument("out_json", nargs="?", default=None)
    args = p.parse_args(argv)
    run(out_path=args.out_json, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
