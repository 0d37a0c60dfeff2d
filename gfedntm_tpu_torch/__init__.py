"""gfedntm_tpu_torch — the PyTorch + CUDA port of ``gfedntm_tpu``.

The package mirrors the JAX package's layout (``data/``, ``native/``,
``models/``, ``ops/``, ``parallel/``, ``train/``, ``federated/``, ``eval/``)
so each module's counterpart is found under the same path. A user's flow
starts from raw text: ``RawCorpus`` per client -> ``run_vocab_consensus``
-> ``AVITM`` -> ``FederatedTrainer.fit`` -> ``make_global_model`` ->
``get_topics`` -> ``npmi_coherence`` / ``topic_diversity``. The CTM flow
adds each document's contextual embedding (``hashing_embedder`` stands in
for a sentence encoder) and optional one-hot labels: ``CTMDataset`` ->
``CombinedTM`` or ``ZeroShotTM`` -> the same trainers. A federation server
drives ``FederatedAVITM`` / ``FederatedCTM`` one minibatch at a time and
averages their snapshots with ``weighted_mean``. ``ServingPlane`` serves a
federation's published rounds (doc→θ over gRPC and HTTP). It imports ``torch``,
``numpy`` and the standard library only — never ``jax`` or anything of
``gfedntm_tpu``.

Entry points run on the GPU unless the caller passes ``device="cpu"``; with
no CUDA device they raise rather than quietly take the CPU (see
:func:`gfedntm_tpu_torch.device.resolve_device`). The fused ProdLDA decode +
reconstruction loss runs hand-written CUDA kernels on the GPU
(:mod:`gfedntm_tpu_torch.ops.fused_decoder`), built with ``nvcc`` at first use.

Attribute access is lazy: importing the package loads no submodule.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "AVITM": "gfedntm_tpu_torch.models.avitm",
    "CTM": "gfedntm_tpu_torch.models.ctm",
    "CTMDataset": "gfedntm_tpu_torch.data.datasets",
    "CombinedTM": "gfedntm_tpu_torch.models.ctm",
    "FederatedAVITM": "gfedntm_tpu_torch.federated.stepper",
    "FederatedCTM": "gfedntm_tpu_torch.federated.stepper",
    "StepStatus": "gfedntm_tpu_torch.federated.stepper",
    "ZeroShotTM": "gfedntm_tpu_torch.models.ctm",
    "hashing_embedder": "gfedntm_tpu_torch.data.embeddings",
    "weighted_mean": "gfedntm_tpu_torch.federated.aggregation",
    "FederatedTrainer": "gfedntm_tpu_torch.federated.trainer",
    "FederatedResult": "gfedntm_tpu_torch.federated.trainer",
    "BowDataset": "gfedntm_tpu_torch.data.datasets",
    "RawCorpus": "gfedntm_tpu_torch.data.loaders",
    "generate_synthetic_corpus": "gfedntm_tpu_torch.data.synthetic",
    "npmi_coherence": "gfedntm_tpu_torch.eval.metrics",
    "resolve_device": "gfedntm_tpu_torch.device",
    "run_vocab_consensus": "gfedntm_tpu_torch.federated.consensus",
    "topic_diversity": "gfedntm_tpu_torch.eval.metrics",
    "ModelSource": "gfedntm_tpu_torch.serving",
    "ServingEngine": "gfedntm_tpu_torch.serving",
    "ServingPlane": "gfedntm_tpu_torch.serving",
    "make_infer_stub": "gfedntm_tpu_torch.serving",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'gfedntm_tpu_torch' has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)
