"""Global-model divergence detection + rollback bookkeeping.

A copy of ``gfedntm_tpu/train/guardian.py`` (numpy and the standard library
only); ``tests/test_torch_data_plane.py`` holds its verdicts to the
original's.

The admission gate (:mod:`gfedntm_tpu_torch.federation.sanitize`) and the robust
aggregators (:mod:`gfedntm_tpu_torch.federated.aggregation`) screen *individual*
updates, but a federation can still diverge: a coordinated majority, a bad
hyperparameter interaction with an adaptive server optimizer, or a slow
poisoning below every per-round threshold all corrupt the global model
*gradually*. :class:`DivergenceGuardian` is the backstop — it watches the
aggregate itself and tells the server when to roll back to the last good
:class:`~gfedntm_tpu_torch.train.checkpoint.FederationCheckpointer` round.

Health signals, per averaged round:

- **finiteness** of the new global average — a NaN/Inf global is
  *immediately* divergent (no patience): pushing it once poisons every
  client irrecoverably under per-minibatch averaging;
- **round loss** (the *median* of the accepted replies' ``StepReply.loss``
  — the loss scalar is client-reported and attacker-controlled, so a mean
  would let one byzantine reply force rollbacks at will; non-finite
  reports are ignored unless they are ALL non-finite) against its own
  EWMA: ``loss > loss_factor * EWMA`` for ``patience`` consecutive rounds
  is a divergence;
- **global parameter norm** against its EWMA, same patience rule — loss can
  look flat while parameters silently blow up (the classic softmax
  saturation failure).

The EWMAs only absorb *healthy* rounds, so a slowly exploding loss cannot
drag its own baseline along with it. The guardian also remembers which
clients' accepted updates (by admitted weight) dominated the unhealthy
streak, so the server can quarantine the likely culprits at rollback time.
"""

from __future__ import annotations

import logging
from typing import Any, Iterable, Mapping

import numpy as np

__all__ = ["DivergenceGuardian"]

# Divergence reason codes (the `divergence_rollback` event vocabulary).
NONFINITE_GLOBAL = "nonfinite_global"
LOSS_EXPLOSION = "loss_explosion"
NORM_EXPLOSION = "norm_explosion"


def _global_norm(average: Mapping[str, np.ndarray]) -> float:
    total = 0.0
    for value in average.values():
        arr = np.asarray(value, np.float64).ravel()
        total += float(np.dot(arr, arr))
    return float(np.sqrt(total))


class DivergenceGuardian:
    """Rolling health watch over the server's round aggregates.

    ``patience`` consecutive unhealthy rounds (or one non-finite global)
    constitute a divergence; ``loss_factor`` / ``norm_factor`` set how far
    above its EWMA a signal must move to count as unhealthy. ``observe``
    returns the divergence reason (or ``None``); the caller performs the
    actual rollback and then calls :meth:`note_rollback` to reset the
    baselines against the restored state.
    """

    def __init__(
        self,
        patience: int = 3,
        loss_factor: float = 4.0,
        norm_factor: float = 10.0,
        ewma_alpha: float = 0.3,
        dominance_factor: float = 2.0,
        metrics: Any = None,
        logger: logging.Logger | None = None,
    ):
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        if loss_factor <= 1.0 or norm_factor <= 1.0:
            raise ValueError(
                "loss_factor/norm_factor must be > 1 (an explosion "
                "threshold at or below the baseline flags every round)"
            )
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {ewma_alpha}"
            )
        self.patience = int(patience)
        self.loss_factor = float(loss_factor)
        self.norm_factor = float(norm_factor)
        self.ewma_alpha = float(ewma_alpha)
        self.dominance_factor = float(dominance_factor)
        self.metrics = metrics
        self.logger = logger or logging.getLogger("DivergenceGuardian")
        self._loss_ewma: float | None = None
        self._norm_ewma: float | None = None
        self._streak = 0
        # Admitted weight per client over the CURRENT unhealthy streak —
        # the attribution base for the rollback quarantine.
        self._streak_weight: dict[int, float] = {}

    # ---- health state -------------------------------------------------------
    @property
    def healthy(self) -> bool:
        """True while no unhealthy streak is open — the server only writes
        round checkpoints in this state, so the checkpoint it would roll
        back to can never itself be mid-divergence."""
        return self._streak == 0

    def _ewma(self, current: float | None, value: float) -> float:
        if current is None:
            return value
        return (1.0 - self.ewma_alpha) * current + self.ewma_alpha * value

    # ---- per-round observation ----------------------------------------------
    def observe(
        self,
        round_idx: int,
        losses: Iterable[float],
        average: Mapping[str, np.ndarray],
        contributors: "Iterable[tuple[int, float]]" = (),
    ) -> str | None:
        """Digest one averaged round; returns a divergence reason code or
        None. ``losses`` are the accepted replies' reported losses (the
        gate already dropped rejected clients — their losses must not move
        the health baseline); ``contributors`` are ``(client_id,
        admitted_weight)`` pairs for quarantine attribution."""
        for key in sorted(average):
            arr = np.asarray(average[key])
            if arr.dtype.kind == "f" and not np.all(np.isfinite(arr)):
                self._streak = max(self._streak, 1)
                self._note_contributors(contributors)
                self.logger.error(
                    "round %d: global average tensor %r is non-finite",
                    round_idx, key,
                )
                return NONFINITE_GLOBAL

        losses = [float(v) for v in losses]
        finite = [v for v in losses if np.isfinite(v)]
        # Median, not mean: StepReply.loss is client-reported. A single
        # byzantine client whose tensors pass the gate could still report
        # loss=NaN/1e30 and, under a mean, trip a rollback every `patience`
        # rounds forever — a training-denial loop. The median moves only
        # when a majority of the admitted cohort reports an explosion.
        round_loss = float(np.median(finite)) if finite else float("nan")
        norm = _global_norm(average)
        reason = None
        if losses and not finite:
            # every admitted contributor reports a non-finite loss: the
            # fleet already computes on poisoned state
            reason = LOSS_EXPLOSION
        elif (
            self._loss_ewma is not None
            and np.isfinite(round_loss)
            and round_loss > self.loss_factor * abs(self._loss_ewma)
        ):
            reason = LOSS_EXPLOSION
        elif (
            self._norm_ewma is not None
            and norm > self.norm_factor * max(self._norm_ewma, 1e-12)
        ):
            reason = NORM_EXPLOSION

        if reason is None:
            self._streak = 0
            self._streak_weight.clear()
            if np.isfinite(round_loss):
                self._loss_ewma = self._ewma(self._loss_ewma, round_loss)
            self._norm_ewma = self._ewma(self._norm_ewma, norm)
            return None

        self._streak += 1
        self._note_contributors(contributors)
        self.logger.warning(
            "round %d unhealthy (%s: loss %.4g vs EWMA %s, norm %.4g vs "
            "EWMA %s) — streak %d/%d",
            round_idx, reason, round_loss, self._loss_ewma, norm,
            self._norm_ewma, self._streak, self.patience,
        )
        if self.metrics is not None:
            self.metrics.registry.counter("unhealthy_rounds").inc()
        if self._streak >= self.patience:
            return reason
        return None

    def _note_contributors(self, contributors) -> None:
        for client_id, weight in contributors:
            self._streak_weight[client_id] = (
                self._streak_weight.get(client_id, 0.0) + float(weight)
            )

    # ---- rollback support ----------------------------------------------------
    def dominant_contributors(self) -> list[int]:
        """Clients whose admitted weight over the unhealthy streak exceeds
        ``dominance_factor`` x the equal share — the quarantine candidates.
        Empty when influence was evenly spread (quarantining everyone is
        quarantining no one)."""
        total = sum(self._streak_weight.values())
        n = len(self._streak_weight)
        if n < 2 or total <= 0:
            return []
        cutoff = self.dominance_factor * total / n
        return sorted(
            cid for cid, w in self._streak_weight.items() if w > cutoff
        )

    def note_rollback(self) -> None:
        """Reset every baseline after the server restored a checkpoint:
        the EWMAs describe the diverged trajectory, not the restored one."""
        self._loss_ewma = None
        self._norm_ewma = None
        self._streak = 0
        self._streak_weight.clear()
