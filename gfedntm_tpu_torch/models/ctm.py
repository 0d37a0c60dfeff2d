"""CTM trainers: ZeroShotTM and CombinedTM (contextualized topic models).

Counterpart of ``gfedntm_tpu/models/ctm.py:22-187`` (itself the reference's
``ctm_network/ctm.py:20-807``). :class:`CTM` trains through
:class:`~gfedntm_tpu_torch.models.avitm.AVITM`'s loop, fit, validation,
inference, ``save``/``load`` (the JAX package's npz + JSON format, in both
directions) and the sharded fits, with three differences that its hooks
carry:

- the network's encoder is ZeroShotTM's (``inference_type="zeroshot"``:
  the contextual embedding, plus the labels) or CombinedTM's
  (``"combined"``: BoW, ``adapt_bert`` of the embedding, plus the labels),
  and ``label_size`` L > 0 adds the label head;
- the loss weighs the KL by ``loss_weights["beta"]`` and adds the label
  head's cross-entropy (``ctm.py:286-296``);
- the corpus is a :class:`~gfedntm_tpu_torch.data.datasets.CTMDataset`,
  staged as ``x_bow``, ``x_ctx`` and, when the dataset has labels and
  ``label_size > 0``, ``labels``. Only the BoW counts take the bf16 count
  screen: the embeddings are real values.

The prodLDA decode is the same function of theta, beta and x_bow as
AVITM's, so a fused CTM runs it through the same kernels (K1-K3, and K5
when sharded).
"""

from __future__ import annotations

import numpy as np

from gfedntm_tpu_torch.data.datasets import CTMDataset
from gfedntm_tpu_torch.models.avitm import AVITM


class CTM(AVITM):
    """Contextualized Topic Model: pick the encoder with ``inference_type``
    or use :class:`ZeroShotTM` / :class:`CombinedTM` (``ctm.py:785-807``).
    Arguments are the JAX ``CTM``'s plus ``device`` (``None`` -> the GPU)."""

    family = "ctm"

    def __init__(
        self,
        logger=None,
        input_size: int = 1000,
        contextual_size: int = 768,
        n_components: int = 10,
        model_type: str = "prodLDA",
        hidden_sizes: tuple[int, ...] = (100, 100),
        activation: str = "softplus",
        dropout: float = 0.2,
        learn_priors: bool = True,
        batch_size: int = 64,
        lr: float = 2e-3,
        momentum: float = 0.99,
        solver: str = "adam",
        num_epochs: int = 100,
        reduce_on_plateau: bool = False,
        topic_prior_mean: float = 0.0,
        topic_prior_variance: float | None = None,
        num_samples: int = 10,
        num_data_loader_workers: int = 0,
        label_size: int = 0,
        loss_weights: dict | None = None,
        inference_type: str = "zeroshot",
        verbose: bool = False,
        seed: int = 0,
        fused_decoder: bool | str = "auto",
        compute_dtype: str = "float32",
        device=None,
    ):
        if not contextual_size > 0:
            raise ValueError("contextual_size must be > 0")
        if inference_type not in ("zeroshot", "combined"):
            raise ValueError("inference_type must be 'zeroshot' or 'combined'")
        self.contextual_size = contextual_size
        self.label_size = label_size
        self.inference_type = inference_type
        self.weights = loss_weights if loss_weights else {"beta": 1.0}
        super().__init__(
            logger=logger, input_size=input_size, n_components=n_components,
            model_type=model_type, hidden_sizes=hidden_sizes, activation=activation,
            dropout=dropout, learn_priors=learn_priors, batch_size=batch_size, lr=lr,
            momentum=momentum, solver=solver, num_epochs=num_epochs,
            reduce_on_plateau=reduce_on_plateau, topic_prior_mean=topic_prior_mean,
            topic_prior_variance=topic_prior_variance, num_samples=num_samples,
            num_data_loader_workers=num_data_loader_workers, verbose=verbose, seed=seed,
            fused_decoder=fused_decoder, compute_dtype=compute_dtype, device=device,
        )

    def _contextual_size(self) -> int:
        return self.contextual_size

    def _label_size(self) -> int:
        return self.label_size

    def _beta_weight(self) -> float:
        return float(self.weights.get("beta", 1.0))

    def _host_data(self, dataset: CTMDataset) -> dict:
        """``x_bow``, ``x_ctx`` and, with labels and ``label_size > 0``,
        ``labels`` (``ctm.py:115-129``); the count screen reads x_bow."""
        data = {**super()._host_data(dataset), "x_ctx": dataset.X_ctx}
        if dataset.labels is not None and self.label_size > 0:
            data["labels"] = dataset.labels
        return data

    # ---- CTM-specific inspection APIs (ctm.py:597-775) ---------------------
    def get_word_distribution_by_topic_id(self, topic_id: int) -> list[tuple[str, float]]:
        """(word, probability) pairs of one topic, most probable first
        (``ctm.py:597-618``)."""
        if topic_id < 0 or topic_id >= self.n_components:
            raise ValueError(f"topic_id must be in [0, {self.n_components})")
        dist = self.get_topic_word_distribution()[topic_id]
        idx2token = self.train_data.idx2token if self.train_data else {}
        pairs = [(idx2token.get(i, str(i)), float(p)) for i, p in enumerate(dist)]
        return sorted(pairs, key=lambda t: -t[1])

    def get_top_documents_per_topic_id(
        self,
        unpreprocessed_corpus: list[str],
        document_topic_distributions: np.ndarray,
        topic_id: int,
        k: int = 5,
    ) -> list[tuple[str, float]]:
        """The k documents with the most theta mass on one topic
        (``ctm.py:620-646``)."""
        probs = np.asarray(document_topic_distributions)[:, topic_id]
        top = np.argsort(-probs)[:k]
        return [(unpreprocessed_corpus[i], float(probs[i])) for i in top]

    def get_ldavis_data_format(
        self, vocab: list[str], dataset: CTMDataset, n_samples: int = 20
    ) -> dict:
        """pyLDAvis' input bundle (``ctm.py:753-775``)."""
        X = np.asarray(dataset.X)
        return {
            "topic_term_dists": self.get_topic_word_distribution(),
            "doc_topic_dists": self.get_doc_topic_distribution(dataset, n_samples),
            "doc_lengths": X.sum(axis=1),
            "vocab": vocab,
            "term_frequency": X.sum(axis=0),
        }


class ZeroShotTM(CTM):
    """Contextual-only encoder: train on one language's embeddings, infer on
    any aligned language (``ctm.py:785-799``)."""

    def __init__(self, **kwargs):
        kwargs["inference_type"] = "zeroshot"
        super().__init__(**kwargs)


class CombinedTM(CTM):
    """BoW + contextual encoder (``ctm.py:801-807``)."""

    def __init__(self, **kwargs):
        kwargs["inference_type"] = "combined"
        super().__init__(**kwargs)
