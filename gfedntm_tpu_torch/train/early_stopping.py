"""Early stopping on validation loss (reference ``pytorchtools.py:4-55``).

A copy of ``gfedntm_tpu/train/early_stopping.py``. Semantics: score =
-val_loss; an epoch "improves" when ``score >= best + delta``; otherwise a
patience counter increments and training stops when it reaches
``patience``. On improvement an optional checkpoint callback fires (the
reference calls ``model.save(path)``).
"""

from __future__ import annotations

from typing import Callable


class EarlyStopping:
    def __init__(
        self,
        patience: int = 5,
        delta: float = 0.0,
        checkpoint_fn: Callable[[], None] | None = None,
        verbose: bool = False,
    ):
        self.patience = patience
        self.delta = delta
        self.checkpoint_fn = checkpoint_fn
        self.verbose = verbose
        self.counter = 0
        self.best_score: float | None = None
        self.early_stop = False
        self.val_loss_min = float("inf")

    def __call__(self, val_loss: float) -> None:
        score = -val_loss
        if self.best_score is None:
            self.best_score = score
            self._checkpoint(val_loss)
        elif score < self.best_score + self.delta:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_score = score
            self._checkpoint(val_loss)
            self.counter = 0

    def _checkpoint(self, val_loss: float) -> None:
        if self.checkpoint_fn is not None:
            self.checkpoint_fn()
        self.val_loss_min = val_loss
