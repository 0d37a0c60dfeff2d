"""Externally-stepped federated models (the reference's ``FederatedModel``).

Counterpart of ``gfedntm_tpu/federated/stepper.py:55-418``, itself the
reference's ``federated_model.py:17-197``, ``federated_avitm.py:13-193``
and ``federated_ctm.py:12-190``: training is not driven by a local ``fit``
loop but stepped from outside, one minibatch at a time, by a federation
orchestrator. Per global step:

1. the orchestrator calls :meth:`FederatedStepper.train_mb_delta`: one
   forward/backward/optimizer step on the current minibatch, which returns
   the post-step snapshot of the shared state (the reference's "gradients"
   are post-Adam-step parameters);
2. the orchestrator averages the clients' snapshots, sample-weighted
   (:func:`~gfedntm_tpu_torch.federated.aggregation.weighted_mean`);
3. it calls :meth:`FederatedStepper.delta_update_fit` with the average: the
   shared entries are overwritten, loss and sample accounting advance, and
   the client moves to its next minibatch, each client rolling over its own
   epochs (``federated_avitm.py:85-147``).

Snapshots are keyed by the JAX package's '/'-joined Flax variable paths
(``params/beta``, ``params/inf_net/input_layer/kernel``,
``batch_stats/beta_batchnorm/num_batches_tracked``), with [in, out]
kernels and int32 counters (:mod:`gfedntm_tpu_torch.interop`), so a JAX
stepper's snapshot sets into a torch stepper and back unchanged.

Each client's batch schedule comes from its model's numpy generator, as
the JAX stepper's does, so both step through the same minibatches; the
step's noise and dropout come from the model's torch generator where the
JAX stepper folds a PRNG key from its model.

The intended-semantics fixes of the JAX package are kept: the sample
accounting reads the minibatch just processed, and a CTM's label loss is
part of the tracked loss. The JAX stepper's multi-chip ``mesh`` (a
data-parallel client) is not ported yet: the constructor raises for one.

``metrics`` (a :class:`~gfedntm_tpu_torch.utils.observability.MetricsLogger`,
as the federation client passes it) is the JAX stepper's hook
(``gfedntm_tpu/federated/stepper.py:96-107, 206-246``): a ``stepper_step_s``
histogram of every step but the first (which builds the kernels), and the
device-memory gauges ``device_bytes_in_use/cuda<i>`` and
``device_peak_bytes_in_use/cuda<i>`` from ``torch.cuda`` after each step
(none on the CPU).
"""

from __future__ import annotations

import time

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from gfedntm_tpu_torch import interop
from gfedntm_tpu_torch.data.datasets import BowDataset, make_epoch_schedule
from gfedntm_tpu_torch.eval.metrics import (
    convert_topic_word_to_init_size,
    document_similarity_score,
    topic_similarity_score,
)
from gfedntm_tpu_torch.models.avitm import AVITM
from gfedntm_tpu_torch.models.params import SHARE_ALL, build_share_mask
from gfedntm_tpu_torch.train.steps import grad_step, take
from gfedntm_tpu_torch.utils.serialization import save_model_as_npz

THETAS_THRESHOLD = 3e-3  # federated_model.py:172


@dataclass
class StepStatus:
    """Outcome of one :meth:`FederatedStepper.delta_update_fit` (what the
    reference signals through mutable client state,
    ``federated_avitm.py:106-147``)."""

    current_mb: int
    current_epoch: int
    epoch_ended: bool
    finished: bool
    epoch_loss: float | None = None


class FederatedStepper:
    """Wraps a configured :class:`AVITM` or CTM for one-minibatch-at-a-time
    federated stepping (the ``FederatedModel`` contract).

    ``grads_to_share`` takes reference state-dict keys or ``SHARE_ALL``
    (``federated_model.py:98-131``). ``epoch_snapshot_dir`` saves the model
    at every epoch's end (``federated_ctm.py:150-159``). ``metrics`` feeds
    the step-time histogram and the device-memory gauges."""

    def __init__(
        self,
        model: AVITM,
        grads_to_share: tuple[str, ...] = SHARE_ALL,
        epoch_snapshot_dir: str | None = None,
        metrics=None,
        mesh=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "FederatedStepper: the multi-device client (mesh) is not ported yet "
                "(ROADMAP queue 1)")
        self.model = model
        self.grads_to_share = tuple(grads_to_share)
        self.epoch_snapshot_dir = epoch_snapshot_dir
        self.metrics = metrics
        self._first_step_done = False
        keys = list(model.model.state_dict())
        self.share_mask = build_share_mask(keys, self.grads_to_share)
        self._paths = {key: "/".join((collection, *path))
                       for key in keys for collection, path in [interop.flax_path(key)]}
        self._keys = {path: key for key, path in self._paths.items()}
        self._shared_keys = frozenset(self._paths[k] for k in keys if self.share_mask[k])
        # Counters mirroring FederatedModel/FederatedAVITM state.
        self.current_mb = 0  # global minibatch counter
        self.current_epoch = 0
        self.samples_processed = 0.0  # within the current epoch
        self.train_loss = 0.0  # summed batch loss within the current epoch
        self.best_loss_train = float("inf")
        self.best_components: np.ndarray | None = None
        self.epoch_losses: list[float] = []
        self.finished = False
        self.loss = float("nan")
        self._data = None
        self._schedule = None
        self._step_in_epoch = 0
        self._last_batch_size = 0.0
        self._pending_step = False

    # ---- phase set-up (preFit, federated_model.py:57-96) -------------------
    def pre_fit(self, train_dataset: BowDataset) -> None:
        """Stage the client's corpus on the model's device and draw the first
        epoch's shuffled batch schedule."""
        self.model.train_data = train_dataset
        self._data = self.model._device_data(train_dataset)
        self._new_epoch_schedule()

    def _new_epoch_schedule(self) -> None:
        self._schedule = make_epoch_schedule(
            len(self.model.train_data), self.model.batch_size, self.model._np_rng)
        self._step_in_epoch = 0

    @property
    def steps_remaining(self) -> int:
        """Scheduled minibatch steps left in the ``num_epochs`` budget, so a
        round of ``local_steps`` > 1 can end on the last scheduled step."""
        if self._schedule is None or self.finished:
            return 0
        per = self._schedule.steps_per_epoch
        return (self.model.num_epochs - self.current_epoch) * per - self._step_in_epoch

    # ---- the two protocol steps --------------------------------------------
    def train_mb_delta(self, snapshot: bool = True) -> dict[str, np.ndarray]:
        """One local forward/backward/optimizer step on the current minibatch
        (``federated_avitm.py:51-83``, ``federated_ctm.py:50-114``); returns
        the post-step snapshot of the shared state, or ``{}`` with
        ``snapshot=False`` (the intermediate steps of a ``local_steps`` > 1
        round, of which only the last is exchanged)."""
        if self._schedule is None:
            raise RuntimeError("pre_fit must be called before stepping")
        m = self.model
        t0 = time.perf_counter() if self.metrics is not None else 0.0
        i = self._step_in_epoch
        idx = torch.as_tensor(self._schedule.indices[i], device=m.device, dtype=torch.long)
        mask = torch.as_tensor(self._schedule.mask[i], device=m.device, dtype=torch.float32)
        loss = grad_step(m.model, m.optimizer, take(self._data, idx), mask, m.fused_decoder,
                         generator=m.generator, beta_weight=m._beta_weight())
        self.loss = float(loss)
        if self.metrics is not None:
            # float(loss) synchronized, so this is the step's wall time.
            self._observe_step(time.perf_counter() - t0)
        self._last_batch_size = float(self._schedule.mask[i].sum())
        self._pending_step = True
        return self.get_gradients() if snapshot else {}

    def _observe_step(self, seconds: float) -> None:
        reg = self.metrics.registry
        if self._first_step_done:
            reg.histogram("stepper_step_s").observe(seconds)
        self._first_step_done = True
        dev = self.model.device
        if dev.type == "cuda":
            reg.gauge(f"device_bytes_in_use/cuda{dev.index}").set(
                torch.cuda.memory_allocated(dev))
            reg.gauge(f"device_peak_bytes_in_use/cuda{dev.index}").set(
                torch.cuda.max_memory_allocated(dev))

    def get_gradients(self) -> dict[str, np.ndarray]:
        """``{flax path: array}`` of the shared entries, host copies in the
        JAX package's layout (``federated_model.py:98-115``)."""
        return {self._paths[key]: interop.to_flax(key, t)
                for key, t in self.model.model.state_dict().items()
                if self.share_mask[key]}

    @torch.no_grad()
    def set_gradients(self, averaged: dict[str, np.ndarray]) -> None:
        """Overwrite the shared entries with the server's average
        (``federated_model.py:117-131``); an unknown path raises, a known
        path that is not shared is skipped. Each value goes to the device as
        it is, and a kernel is transposed there; values take the entry's
        dtype (a float counter truncates, as ``jnp.asarray(v, int32)``
        does)."""
        state = self.model.model.state_dict()
        for path, value in averaged.items():
            key = self._keys.get(path)
            if key is None:
                raise KeyError(f"unknown shared tensor {path!r}")
            if path not in self._shared_keys:
                continue
            leaf = torch.as_tensor(np.asarray(value), device=state[key].device)
            state[key].copy_(leaf.t() if path.endswith("/kernel") else leaf)

    def delta_update_fit(self, averaged: dict[str, np.ndarray]) -> StepStatus:
        """Apply the aggregate, account the step and advance to the next
        minibatch, rolling over this client's epoch at its end
        (``federated_avitm.py:85-147``)."""
        if not self._pending_step:
            raise RuntimeError("delta_update_fit requires a preceding train_mb_delta "
                               "(one aggregate per exchanged step)")
        self._pending_step = False
        self.set_gradients(averaged)
        return self._advance_accounting()

    def advance_local(self) -> StepStatus:
        """Advance past the current minibatch without an aggregate: the
        intermediate steps of a ``local_steps`` > 1 round."""
        if not self._pending_step:
            raise RuntimeError("advance_local requires a preceding train_mb_delta")
        self._pending_step = False
        return self._advance_accounting()

    def _advance_accounting(self) -> StepStatus:
        self.train_loss += self.loss
        self.samples_processed += self._last_batch_size
        self.current_mb += 1
        self._step_in_epoch += 1
        epoch_ended = self._step_in_epoch >= self._schedule.steps_per_epoch
        epoch_loss = None
        if epoch_ended:
            epoch_loss = self.train_loss / max(self.samples_processed, 1.0)
            self.epoch_losses.append(epoch_loss)
            # Keep the best epoch's beta, not the last (federated_avitm.py:125-130).
            if epoch_loss < self.best_loss_train:
                self.best_loss_train = epoch_loss
                self.best_components = self.model.model.beta.detach().cpu().numpy().copy()
                self.model.best_components = self.best_components
            self.train_loss = 0.0
            self.samples_processed = 0.0
            if self.epoch_snapshot_dir is not None:
                self.model.nn_epoch = self.current_epoch
                self.model.save(self.epoch_snapshot_dir)
            self.current_epoch += 1
            self._new_epoch_schedule()
            if self.current_epoch >= self.model.num_epochs:
                self.finished = True
        return StepStatus(current_mb=self.current_mb, current_epoch=self.current_epoch,
                          epoch_ended=epoch_ended, finished=self.finished,
                          epoch_loss=epoch_loss)

    # ---- finalization (federated_model.py:151-197) -------------------------
    def get_results_model(self, save_dir: str | None = None,
                          n_samples: int | None = None) -> dict[str, Any]:
        """The client's final artifacts: its documents' MC thetas with values
        below 3e-3 zeroed and rows renormalized, the softmax betas and the
        top-word topics; an npz bundle into ``save_dir`` when given
        (``federated_model.py:151-181``)."""
        m = self.model
        if m.best_components is None:
            # Stopped before the first epoch ended: the current beta.
            m.best_components = m.model.beta.detach().cpu().numpy().copy()
            self.best_components = m.best_components
        thetas = m.get_doc_topic_distribution(m.train_data, n_samples or m.num_samples)
        thetas = np.where(thetas < THETAS_THRESHOLD, 0.0, thetas)
        norm = thetas.sum(axis=1, keepdims=True)
        thetas = thetas / np.where(norm == 0.0, 1.0, norm)
        betas = m.get_topic_word_distribution()
        topics = m.get_topics()
        if save_dir is not None:
            save_model_as_npz(save_dir, betas=betas, thetas=thetas, topics=topics,
                              n_components=m.n_components)
        return {"thetas": thetas, "betas": betas, "topics": topics}

    def get_topics_in_server(self, save_dir: str | None = None) -> np.ndarray:
        """The server's final artifact: betas only, since the server holds no
        corpus to infer thetas from (``federated_model.py:183-197``)."""
        betas = self.model.get_topic_word_distribution()
        if save_dir is not None:
            save_model_as_npz(save_dir, betas=betas, thetas=None, topics=None,
                              n_components=self.model.n_components, name="server_model")
        return betas

    def evaluate_synthetic_model(self, beta_gt: np.ndarray, thetas_gt: np.ndarray | None = None,
                                 vocab_size: int | None = None) -> dict[str, float]:
        """Ground-truth recovery on a synthetic corpus
        (``federated_avitm.py:152-193``): TSS of the betas, re-projected onto
        the synthetic vocabulary when ``vocab_size`` is given, and DSS of
        the thetas when ``thetas_gt`` is."""
        m = self.model
        betas = m.get_topic_word_distribution()
        if vocab_size is not None:
            betas = convert_topic_word_to_init_size(vocab_size, betas, m.train_data.idx2token)
        out = {"tss": topic_similarity_score(betas, beta_gt)}
        if thetas_gt is not None:
            thetas = m.get_doc_topic_distribution(m.train_data, m.num_samples)
            out["dss"] = document_similarity_score(thetas, thetas_gt)
        return out


class FederatedAVITM(FederatedStepper):
    """AVITM under the externally-stepped protocol (``federated_avitm.py``).
    Construct with a configured :class:`~gfedntm_tpu_torch.models.avitm.AVITM`."""


class FederatedCTM(FederatedStepper):
    """CTM under the externally-stepped protocol (``federated_ctm.py``): the
    CTM loss (beta-weighted KL + RL + the label cross-entropy) comes from
    the wrapped :class:`~gfedntm_tpu_torch.models.ctm.CTM`."""
