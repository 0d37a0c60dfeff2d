"""Native centralized-baseline harness (the reference's TMWrapper).

The reference's `src/aux_modules/tmWrapper/tm_wrapper.py:15-400` shells out to
the external ``topicmodeler`` git submodule (Java Mallet / torch CTM) to train
centralized baseline models, manages model folders with backup semantics
(`tm_wrapper.py:226-241`), writes train-config JSONs
(`tm_wrapper.py:123-169`), and computes post-hoc quality metrics — NPMI
coherence vs a reference corpus, RBO, topic diversity
(`tm_wrapper.py:358-400`).

This rebuild trains the framework's own AVITM/CTM models in process — no
subprocesses, no Java — while keeping the same workflow surface: named model
folders, persisted train configs, timing, and the same metric set (computed
by :mod:`gfedntm_tpu_torch.eval.metrics`).

The counterpart of ``gfedntm_tpu/experiments/tm_wrapper.py`` over the port's
models, preparation and metrics: every model trains on ``device`` (``None``:
the GPU, where each fit's prodLDA steps run the fused kernels).
"""

from __future__ import annotations

import json
import logging
import shutil
import time
from pathlib import Path
from typing import Any, Sequence

import numpy as np

from gfedntm_tpu_torch.data.preparation import prepare_dataset, prepare_ctm_dataset
from gfedntm_tpu_torch.eval.metrics import (
    inverted_rbo,
    npmi_coherence,
    topic_diversity,
)
from gfedntm_tpu_torch.models.avitm import AVITM
from gfedntm_tpu_torch.models.ctm import CombinedTM, ZeroShotTM

logger = logging.getLogger(__name__)


class TMWrapper:
    """Train/evaluate centralized topic models with managed output folders,
    on ``device`` (``None``: the GPU)."""

    def __init__(self, models_root: str | Path, device=None):
        self.models_root = Path(models_root)
        self.models_root.mkdir(parents=True, exist_ok=True)
        self.device = device

    # ---- folder management (`tm_wrapper.py:226-241`) -----------------------
    def _prepare_model_dir(self, name: str, overwrite: bool = True) -> Path:
        """Create the model folder; an existing one is moved aside to
        ``<name>_old`` first (reference backup semantics)."""
        model_dir = self.models_root / name
        if model_dir.exists():
            if not overwrite:
                raise FileExistsError(str(model_dir))
            backup = self.models_root / f"{name}_old"
            if backup.exists():
                shutil.rmtree(backup)
            model_dir.rename(backup)
        model_dir.mkdir(parents=True)
        return model_dir

    # ---- training ----------------------------------------------------------
    def train_model(
        self,
        name: str,
        corpus: Sequence[str],
        model_type: str = "avitm",
        n_topics: int = 25,
        embeddings: np.ndarray | None = None,
        model_kwargs: dict[str, Any] | None = None,
    ) -> tuple[Any, Path]:
        """Train one centralized model; persists the train config JSON and
        the trained model under ``models_root/name`` and returns
        ``(model, model_dir)``.

        ``model_type``: ``avitm`` (prodLDA), ``lda`` (NeuralLDA),
        ``zeroshot`` or ``combined`` (CTM — needs ``embeddings``)."""
        model_kwargs = dict(model_kwargs or {})
        model_dir = self._prepare_model_dir(name)
        t0 = time.perf_counter()

        if model_type in ("avitm", "lda", "prodlda"):
            train_data, val_data, input_size, id2token, _docs, vocab = (
                prepare_dataset(corpus)
            )
            model = AVITM(
                input_size=input_size,
                n_components=n_topics,
                model_type="LDA" if model_type == "lda" else "prodLDA",
                device=self.device,
                **model_kwargs,
            )
            model.fit(train_data, val_data)
        elif model_type in ("zeroshot", "combined"):
            if embeddings is None:
                raise ValueError(
                    f"model_type={model_type!r} needs precomputed contextual "
                    "embeddings"
                )
            (train_data, val_data, input_size, id2token, qt, _emb_train,
             _emb_all, _docs) = prepare_ctm_dataset(
                list(corpus), custom_embeddings=embeddings
            )
            cls = ZeroShotTM if model_type == "zeroshot" else CombinedTM
            model = cls(
                input_size=input_size,
                contextual_size=train_data.contextual_size,
                n_components=n_topics,
                device=self.device,
                **model_kwargs,
            )
            model.fit(train_data, val_data)
        else:
            raise ValueError(f"unknown model_type: {model_type!r}")

        elapsed = time.perf_counter() - t0
        config = {
            "name": name,
            "model_type": model_type,
            "n_topics": n_topics,
            "n_docs": len(corpus),
            "train_seconds": elapsed,
            "model_kwargs": {
                k: v for k, v in model_kwargs.items()
                if isinstance(v, (int, float, str, bool, list, tuple))
            },
        }
        with open(model_dir / "trainconfig.json", "w", encoding="utf8") as f:
            json.dump(config, f, indent=2)
        model.save(str(model_dir))
        logger.info("trained %s (%s) in %.1fs", name, model_type, elapsed)
        return model, model_dir

    # ---- hierarchical training (`tm_wrapper.py:278-357`) -------------------
    def train_htm_submodel(
        self,
        version: str,
        father_model: Any,
        father_dir: str | Path,
        corpus: Sequence[str],
        name: str,
        expansion_topic: int,
        thr: float | None = None,
        model_type: str = "avitm",
        n_topics: int = 10,
        model_kwargs: dict[str, Any] | None = None,
    ) -> tuple[Any, Path, list[str]]:
        """Train a second-level (child) model under a father model's folder.

        The reference's ``train_htm_submodel`` (`tm_wrapper.py:298-357`)
        delegates child-corpus construction to the external ``topicmodeler``
        submodule (not vendored in the reference repo) via
        ``topicmodeling.py --hierarchical``; the two HTM versions it selects
        are implemented natively here:

        - **HTM-WS** (word selection): each word occurrence in each document
          is assigned to its most responsible father topic
          (``argmax_k theta[d,k] * beta[k,w]``); the child corpus keeps, per
          document, only the words assigned to ``expansion_topic``.
          Documents left empty are dropped.
        - **HTM-DS** (document selection): the child corpus keeps the full
          text of documents whose father doc-topic weight on
          ``expansion_topic`` exceeds ``thr`` (default ``1/K_father``).

        The child model trains on the reduced corpus with its own fitted
        vocabulary and is saved under ``father_dir/name`` with a
        ``config.json`` recording ``hierarchy_level=1``, the HTM version,
        the expansion topic and the threshold (reference
        ``_get_model_config(hierarchy_level=1, ...)``,
        `tm_wrapper.py:331-341`).

        Returns ``(child_model, child_dir, child_corpus)``.
        """
        version = version.upper()
        if version not in ("HTM-WS", "HTM-DS"):
            raise ValueError(
                f"version must be 'HTM-WS' or 'HTM-DS', got {version!r}"
            )
        corpus = list(corpus)
        k_father = father_model.n_components

        # Father posteriors over ITS OWN training vocabulary: re-prepare the
        # corpus (prepare_dataset is deterministic: 75/25 split seed 42,
        # CountVectorizer vocab) so beta columns align with token ids.
        from gfedntm_tpu_torch.data.datasets import BowDataset
        from gfedntm_tpu_torch.data.vocab import vectorize

        _tr, _va, _size, id2token, _docs, vocab = prepare_dataset(corpus)
        bow = vectorize(corpus, vocab)
        data = BowDataset(X=bow, idx2token=id2token)
        thetas = np.asarray(father_model.get_doc_topic_distribution(data))
        betas = np.asarray(father_model.get_topic_word_distribution())
        if betas.shape[1] != bow.shape[1]:
            raise ValueError(
                f"corpus re-vectorizes to {bow.shape[1]} tokens but the "
                f"father model was trained on {betas.shape[1]} — pass the "
                "father's training corpus"
            )

        if version == "HTM-DS":
            thr = (1.0 / k_father) if thr is None else float(thr)
            keep = thetas[:, expansion_topic] > thr
            child_corpus = [corpus[i] for i in np.flatnonzero(keep)]
        else:  # HTM-WS
            tokens = [id2token[j] for j in range(len(id2token))]
            child_corpus = []
            for d in range(bow.shape[0]):
                present = np.flatnonzero(bow[d] > 0)
                if present.size == 0:
                    continue
                # responsibility argmax over father topics, per present word
                resp = thetas[d][:, None] * betas[:, present]  # [K, n_w]
                assigned = present[resp.argmax(axis=0) == expansion_topic]
                if assigned.size == 0:
                    continue
                counts = bow[d, assigned].astype(int)
                child_corpus.append(
                    " ".join(
                        " ".join([tokens[w]] * c)
                        for w, c in zip(assigned, counts)
                    )
                )
        if len(child_corpus) < 8:
            raise ValueError(
                f"{version} selected only {len(child_corpus)} documents for "
                f"topic {expansion_topic} (thr={thr}) — not enough to train "
                "a child model"
            )

        # Child folder lives inside the father's folder; train_model's
        # _prepare_model_dir supplies the reference backup semantics
        # (`tm_wrapper.py:332-346`).
        father_dir = Path(father_dir)
        child_wrapper = TMWrapper(father_dir, device=self.device)
        child_model, child_dir = child_wrapper.train_model(
            name, child_corpus, model_type=model_type, n_topics=n_topics,
            model_kwargs=model_kwargs,
        )
        hier_config = {
            "trainer": model_type,
            "TMparam": {
                k: v for k, v in (model_kwargs or {}).items()
                if isinstance(v, (int, float, str, bool, list, tuple))
            },
            "hierarchy_level": 1,
            "htm_version": version,
            "expansion_tpc": int(expansion_topic),
            "thr": thr,
            "father_model": str(father_dir),
            "n_child_docs": len(child_corpus),
        }
        with open(child_dir / "config.json", "w", encoding="utf8") as f:
            json.dump(hier_config, f, indent=2)
        logger.info(
            "trained %s child %s on %d docs (topic %d)",
            version, name, len(child_corpus), expansion_topic,
        )
        return child_model, child_dir, child_corpus

    # ---- metrics (`tm_wrapper.py:358-400`) ---------------------------------
    def evaluate_model(
        self,
        model: Any,
        reference_corpus: Sequence[str] | Sequence[list[str]] | None = None,
        topn: int = 10,
    ) -> dict[str, float]:
        """NPMI coherence (vs reference corpus), inverted RBO, and topic
        diversity of the trained model's topics.

        ``reference_corpus`` may be raw strings or pre-tokenized token
        lists — sweeps that score many models against one corpus should
        tokenize once and pass the token lists."""
        n_take = min(max(topn, 25), model.input_size)
        topics = model.get_topics(n_take)
        metrics: dict[str, float] = {
            "topic_diversity": topic_diversity(topics, topn=n_take),
            "inverted_rbo": inverted_rbo(topics, topn=topn),
        }
        if reference_corpus is not None:
            tokenized = [
                doc.split() if isinstance(doc, str) else doc
                for doc in reference_corpus
            ]
            metrics["npmi"] = npmi_coherence(topics, tokenized, topn=topn)
        return metrics
