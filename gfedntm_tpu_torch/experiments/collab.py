"""Collaborative-vs-non-collaborative real-corpus experiment.

Rebuilds `experiments/collab_vs_non_collab/train.py:22-158`: given a corpus
partitioned by category (the reference's Semantic Scholar parquet partitioned
by its ``fos`` field), train **centralized** models on the full corpus over a
grid of topic counts and **non-collaborative** models per category, and score
every model with topic diversity + inverted RBO (and NPMI when a reference
corpus is supplied). The reference delegates training to TMWrapper/Mallet;
here the native :class:`gfedntm_tpu_torch.experiments.tm_wrapper.TMWrapper` trains
the framework's own models.

The counterpart of ``gfedntm_tpu/experiments/collab.py`` over the port's
:class:`~gfedntm_tpu_torch.experiments.tm_wrapper.TMWrapper`; ``device``
(``None``: the GPU) is where every model trains.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping, Sequence

from gfedntm_tpu_torch.experiments.tm_wrapper import TMWrapper

logger = logging.getLogger(__name__)


@dataclass
class CollabExperimentConfig:
    """Sweep configuration (reference defaults: K in {10,20,30,40,50},
    `train.py:36-38`)."""

    n_topics_grid: tuple[int, ...] = (10, 20, 30, 40, 50)
    model_type: str = "avitm"
    compute_npmi: bool = False
    model_kwargs: dict[str, Any] = field(default_factory=dict)


def run_collab_experiment(
    partitions: Mapping[str, Sequence[str]],
    models_root: str | Path,
    cfg: CollabExperimentConfig | None = None,
    results_path: str | Path | None = None,
    device=None,
) -> dict[str, Any]:
    """``partitions`` maps category → list of documents (the reference's
    per-``fos`` split, obtainable via
    :func:`gfedntm_tpu_torch.data.loaders.partition_corpus`).

    Returns ``{"centralized": {K: metrics}, "non_collab": {category: {K:
    metrics}}}`` and optionally writes it as JSON."""
    cfg = cfg or CollabExperimentConfig()
    wrapper = TMWrapper(models_root, device=device)
    full_corpus = [doc for docs in partitions.values() for doc in docs]
    # Tokenize the reference corpus ONCE; every model in the sweep scores
    # against the same token lists.
    reference_corpus = (
        [doc.split() for doc in full_corpus] if cfg.compute_npmi else None
    )

    results: dict[str, Any] = {"centralized": {}, "non_collab": {}}
    for k in cfg.n_topics_grid:
        logger.info("centralized model, K=%d, %d docs", k, len(full_corpus))
        model, _ = wrapper.train_model(
            f"centralized_k{k}", full_corpus,
            model_type=cfg.model_type, n_topics=k,
            model_kwargs=cfg.model_kwargs,
        )
        results["centralized"][k] = wrapper.evaluate_model(
            model, reference_corpus
        )

    for category, docs in partitions.items():
        results["non_collab"][category] = {}
        for k in cfg.n_topics_grid:
            logger.info(
                "non-collab model %r, K=%d, %d docs", category, k, len(docs)
            )
            model, _ = wrapper.train_model(
                f"{category}_k{k}", list(docs),
                model_type=cfg.model_type, n_topics=k,
                model_kwargs=cfg.model_kwargs,
            )
            results["non_collab"][category][k] = wrapper.evaluate_model(
                model, reference_corpus
            )

    if results_path is not None:
        results_path = Path(results_path)
        results_path.parent.mkdir(parents=True, exist_ok=True)
        serializable = {
            "centralized": {
                str(k): v for k, v in results["centralized"].items()
            },
            "non_collab": {
                cat: {str(k): v for k, v in by_k.items()}
                for cat, by_k in results["non_collab"].items()
            },
        }
        with open(results_path, "w", encoding="utf8") as f:
            json.dump(serializable, f, indent=2)
    return results
