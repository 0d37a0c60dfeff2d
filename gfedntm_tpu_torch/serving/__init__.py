"""Serving plane: hot-swappable doc→topic inference on the GPU.

Counterpart of ``gfedntm_tpu/serving/``, with the same ``__all__``:

- :mod:`~gfedntm_tpu_torch.serving.engine` — published-round model source
  (journal/checkpoint prefer-newer), the bucket-padded encoder-only doc→θ
  engine, and the quality-gated atomic hot-swap.
- :mod:`~gfedntm_tpu_torch.serving.service` — micro-batch coalescing, the
  gRPC ``Infer`` servicer, the ops-HTTP ``/infer`` + ``/ready`` surface,
  and the :class:`ServingPlane` process wrapper.
- :mod:`~gfedntm_tpu_torch.serving.loadgen` — the closed-loop saturating
  load generator.
"""

from gfedntm_tpu_torch.serving.engine import (
    ModelSource,
    PublishedModel,
    ServingEngine,
    default_buckets,
)
from gfedntm_tpu_torch.serving.loadgen import ClosedLoopLoadGen
from gfedntm_tpu_torch.serving.service import (
    Batcher,
    InferenceServicer,
    QueueFullError,
    ServingPlane,
    make_infer_stub,
)

__all__ = [
    "Batcher",
    "ClosedLoopLoadGen",
    "InferenceServicer",
    "ModelSource",
    "PublishedModel",
    "QueueFullError",
    "ServingEngine",
    "ServingPlane",
    "default_buckets",
    "make_infer_stub",
]
