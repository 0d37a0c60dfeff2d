"""Learning-rate scheduling on a monitored metric.

A copy of ``ReduceLROnPlateau`` from ``gfedntm_tpu/train/schedulers.py``
(:16-50): mode min, factor 0.1, patience 10, relative threshold 1e-4,
min_lr 0. ``torch.optim.lr_scheduler.ReduceLROnPlateau`` with the same
settings differs in one place: it skips a reduction that would change the
LR by less than its ``eps`` (1e-8), so after enough plateaus its LR stops
falling where the JAX package's keeps falling. :func:`set_learning_rate`
writes the LR into an optimizer's param groups, as the JAX function writes
it into the ``inject_hyperparams`` state.
"""

from __future__ import annotations

import torch


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau (mode='min') semantics:
    factor=0.1, patience=10, threshold=1e-4 (relative), min_lr=0."""

    def __init__(
        self,
        initial_lr: float,
        factor: float = 0.1,
        patience: int = 10,
        threshold: float = 1e-4,
        min_lr: float = 0.0,
    ):
        self.lr = float(initial_lr)
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        """Record one epoch's monitored metric; returns the (possibly
        reduced) learning rate."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write ``lr`` into every param group of ``optimizer``."""
    for group in optimizer.param_groups:
        group["lr"] = lr
