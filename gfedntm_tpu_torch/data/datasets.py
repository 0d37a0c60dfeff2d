"""Dataset container and batch schedules.

A copy of ``gfedntm_tpu/data/datasets.py`` (``BowDataset``, ``CTMDataset``,
``EpochSchedule``, ``make_epoch_schedule``, ``make_run_schedule``), kept
here so the port never imports the JAX package. For the same seed the
schedules are the same numpy arrays as the original's, which is what lets
the port and the JAX package train on identical batches.

Every epoch is padded to ``ceil(n/B)`` full batches; a boolean mask marks
the real rows, and the mask-aware loss and BatchNorm compute exactly what
the reference computes on its ragged final batch.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class BowDataset:
    """Dense doc-term matrix plus vocabulary mapping."""

    X: np.ndarray  # [n_docs, V] float32 counts
    idx2token: dict[int, str] = field(default_factory=dict)

    def __post_init__(self):
        self.X = np.asarray(self.X, dtype=np.float32)

    def __len__(self) -> int:
        return self.X.shape[0]

    @property
    def vocab_size(self) -> int:
        return self.X.shape[1]


@dataclass
class CTMDataset(BowDataset):
    """BoW + contextual (SBERT) embeddings + optional one-hot labels.

    Validates length agreement like the reference (``dataset.py:17-27``).
    """

    X_ctx: np.ndarray | None = None  # [n_docs, contextual_size]
    labels: np.ndarray | None = None  # [n_docs, label_size] one-hot

    def __post_init__(self):
        super().__post_init__()
        if self.X_ctx is None:
            raise ValueError("CTMDataset requires contextual embeddings")
        self.X_ctx = np.asarray(self.X_ctx, dtype=np.float32)
        if len(self.X_ctx) != len(self.X):
            raise ValueError(
                f"length mismatch: {len(self.X)} bow vs {len(self.X_ctx)} contextual"
            )
        if self.labels is not None:
            self.labels = np.asarray(self.labels, dtype=np.float32)
            if len(self.labels) != len(self.X):
                raise ValueError("length mismatch between labels and bow")

    @property
    def contextual_size(self) -> int:
        return self.X_ctx.shape[1]


@dataclass(frozen=True)
class EpochSchedule:
    """Static-shape batch schedule for one dataset.

    ``indices`` [steps_per_epoch, batch_size] int32 (pad rows repeat index 0),
    ``mask``    [steps_per_epoch, batch_size] bool (False on pad rows).
    """

    indices: np.ndarray
    mask: np.ndarray

    @property
    def steps_per_epoch(self) -> int:
        return self.indices.shape[0]


def make_epoch_schedule(
    n_docs: int, batch_size: int, rng: np.random.Generator, shuffle: bool = True
) -> EpochSchedule:
    """One epoch of DataLoader(shuffle)-equivalent batches, padded to full
    static shape. drop_last=False semantics: the ragged final batch becomes a
    full batch with masked padding rows."""
    order = rng.permutation(n_docs) if shuffle else np.arange(n_docs)
    steps = max(1, -(-n_docs // batch_size))
    padded = np.zeros(steps * batch_size, dtype=np.int32)
    padded[:n_docs] = order
    mask = np.zeros(steps * batch_size, dtype=bool)
    mask[:n_docs] = True
    return EpochSchedule(
        indices=padded.reshape(steps, batch_size),
        mask=mask.reshape(steps, batch_size),
    )


def make_run_schedule(
    n_docs: int,
    batch_size: int,
    num_steps: int,
    seed: int,
    shuffle: bool = True,
) -> EpochSchedule:
    """Concatenate per-epoch schedules until ``num_steps`` global steps are
    covered (a client whose epochs are shorter keeps cycling with fresh
    shuffles, mirroring the iterator reset at ``federated_avitm.py:114-138``).
    Returns arrays shaped [num_steps, batch_size]."""
    rng = np.random.default_rng(seed)
    idx_chunks, mask_chunks, have = [], [], 0
    while have < num_steps:
        ep = make_epoch_schedule(n_docs, batch_size, rng, shuffle)
        idx_chunks.append(ep.indices)
        mask_chunks.append(ep.mask)
        have += ep.steps_per_epoch
    indices = np.concatenate(idx_chunks, axis=0)[:num_steps]
    mask = np.concatenate(mask_chunks, axis=0)[:num_steps]
    return EpochSchedule(indices=indices, mask=mask)


def full_batch_indices(n_docs: int, batch_size: int) -> tuple:
    """Unshuffled padded index/mask arrays covering a dataset once
    (inference order, DataLoader(shuffle=False) — ``avitm.py:489-491``).
    Copied from ``gfedntm_tpu/train/steps.py``."""
    steps = max(1, -(-n_docs // batch_size))
    idx = np.zeros(steps * batch_size, dtype=np.int32)
    idx[:n_docs] = np.arange(n_docs)
    mask = np.zeros(steps * batch_size, dtype=bool)
    mask[:n_docs] = True
    return idx.reshape(steps, batch_size), mask.reshape(steps, batch_size)
