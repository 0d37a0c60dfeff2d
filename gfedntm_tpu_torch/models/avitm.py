"""AVITM trainer: ProdLDA / NeuralLDA with the reference's public API.

Counterpart of ``gfedntm_tpu/models/avitm.py:41-493`` (itself the
reference's ``avitm.py:20-640``): the constructor's validation; ``fit`` with
validation-based early stopping, the plateau scheduler on the monitored
loss, checkpoints into ``save_dir`` and the NaN abort (``:275-395``);
``get_doc_topic_distribution`` / ``get_predicted_topics`` /
``get_topic_word_matrix`` / ``get_topic_word_distribution`` / ``get_topics``;
``save`` / ``load`` in the JAX package's npz + JSON format (``:450-493``);
and ``compute_dtype="bfloat16"``: the network computes in bf16 while its
parameters, BatchNorm statistics and optimizer state stay float32, and the
fused kernels read beta and x stored in bf16 (``:81``, ``:124-134``).
:class:`~gfedntm_tpu_torch.models.ctm.CTM` (ZeroShotTM, CombinedTM)
subclasses it through the hooks ``_contextual_size``, ``_label_size``,
``_beta_weight`` and ``_host_data`` (``avitm.py:171-225``): the corpus is
staged as a dict of ``x_bow`` (and CTM's ``x_ctx``, ``labels``).

Schedules come from ``np.random.default_rng(seed)`` exactly as in the JAX
package, so both train and validate on the same batches: each epoch draws
its training schedule, then its validation schedule, from the one numpy
generator. The reparameterization noise and dropout come from a
``torch.Generator`` on the model's device, seeded with ``seed + 1``.

``fused_decoder="auto"`` (and ``True``) runs prodLDA's decode + loss through
the fused kernels: the CUDA kernels on the GPU, their plain versions on the
CPU. A kernel that fails to build or launch raises. ``False`` is the user's
explicit choice of the unfused decode; LDA always takes it. Validation
always takes the unfused decode, as the JAX package's eval does.

``save`` writes ``epoch_{nn_epoch}.npz`` (the variables under Flax names,
through :mod:`gfedntm_tpu_torch.interop`) and ``epoch_{nn_epoch}.json`` (the
config), so a model saved by either package loads in the other.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import time

import numpy as np
import torch

from gfedntm_tpu_torch.data.datasets import (
    BowDataset,
    full_batch_indices,
    make_epoch_schedule,
)
from gfedntm_tpu_torch.device import resolve_device
from gfedntm_tpu_torch.interop import flax_from_state_dict, state_dict_from_flax
from gfedntm_tpu_torch.models.networks import DecoderNetwork
from gfedntm_tpu_torch.parallel.collectives import check_equal_across
from gfedntm_tpu_torch.parallel.sharded import DocShard
from gfedntm_tpu_torch.train.early_stopping import EarlyStopping
from gfedntm_tpu_torch.train.optimizers import build_optimizer
from gfedntm_tpu_torch.train.schedulers import ReduceLROnPlateau, set_learning_rate
from gfedntm_tpu_torch.train.steps import (
    check_bf16_bow_counts,
    eval_steps,
    grad_step,
    take,
)
from gfedntm_tpu_torch.utils.flops import measure_step_flops
from gfedntm_tpu_torch.utils.serialization import load_variables, save_variables

_ACTIVATIONS = (
    "softplus", "relu", "sigmoid", "swish", "tanh", "leakyrelu", "rrelu",
    "elu", "selu",
)
_SOLVERS = ("adagrad", "adam", "sgd", "adadelta", "rmsprop")


def _require(ok: bool, message: str) -> None:
    if not ok:
        raise ValueError(message)


class AVITM:
    """Autoencoding Variational Inference for Topic Models.

    Constructor arguments mirror the JAX package's (``avitm.py:58-82``) plus
    ``device`` (``None`` -> the GPU; ``"cpu"`` must be asked for).
    ``num_data_loader_workers`` is accepted for config compatibility and
    ignored.
    """

    family = "avitm"
    inference_type = "bow"

    def __init__(
        self,
        logger=None,
        input_size: int = 1000,
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
        verbose: bool = False,
        seed: int = 0,
        fused_decoder: bool | str = "auto",
        compute_dtype: str = "float32",
        device: str | torch.device | None = None,
    ):
        _require(isinstance(input_size, int) and input_size > 0,
                 "input_size must by type int > 0.")
        _require(isinstance(n_components, int) and n_components > 0,
                 "n_components must by type int > 0.")
        _require(model_type.lower() in ("lda", "prodlda"),
                 "model must be 'LDA' or 'prodLDA'.")
        _require(isinstance(hidden_sizes, tuple), "hidden_sizes must be type tuple.")
        _require(activation in _ACTIVATIONS, f"activation must be one of {_ACTIVATIONS}")
        _require(dropout >= 0, "dropout must be >= 0.")
        _require(isinstance(learn_priors, bool), "learn_priors must be boolean.")
        _require(isinstance(batch_size, int) and batch_size > 0,
                 "batch_size must be int > 0.")
        _require(lr > 0, "lr must be > 0.")
        _require(isinstance(momentum, float) and 0 < momentum <= 1,
                 "momentum must be 0 < float <= 1.")
        _require(solver in _SOLVERS,
                 "solver must be 'adam', 'adadelta', 'sgd', 'rmsprop' or 'adagrad'")
        _require(isinstance(topic_prior_mean, float),
                 "topic_prior_mean must be type float")
        _require(fused_decoder in ("auto", True, False),
                 "fused_decoder must be 'auto', True or False")
        _require(compute_dtype in ("float32", "bfloat16"),
                 "compute_dtype must be 'float32' or 'bfloat16'")

        self.logger = logger or logging.getLogger(self.__class__.__name__)
        self.device = resolve_device(device)
        self.input_size = input_size
        self.n_components = n_components
        self.model_type = model_type
        self.hidden_sizes = tuple(hidden_sizes)
        self.activation = activation
        self.dropout = dropout
        self.learn_priors = learn_priors
        self.batch_size = batch_size
        self.lr = lr
        self.momentum = momentum
        self.solver = solver
        self.num_epochs = num_epochs
        self.reduce_on_plateau = reduce_on_plateau
        self.topic_prior_mean = topic_prior_mean
        self.topic_prior_variance = topic_prior_variance
        self.num_samples = num_samples
        self.num_data_loader_workers = num_data_loader_workers
        self.verbose = verbose
        self.seed = seed
        # bf16 storage holds BoW counts exactly only up to 256: the corpus is
        # screened once, where it is staged (_device_data).
        self.compute_dtype = compute_dtype
        self._bf16_bow_checked = False
        # The request as given: a data layout of more than one rank refuses
        # an explicit True and resolves "auto" to the unfused decode
        # (federated/stepper.py).
        self.fused_request = fused_decoder
        self.fused_decoder = fused_decoder in ("auto", True) and model_type.lower() == "prodlda"

        self.epoch_losses: list[float] = []
        self.step_losses: list[float] = []  # every step's summed batch loss
        self.validation_losses: list[float] = []  # every validated epoch's loss
        self.train_data: BowDataset | None = None
        self.validation_data: BowDataset | None = None
        self.model_dir: str | None = None
        self.nn_epoch: int | None = None
        self.best_components: np.ndarray | None = None

        self.model = self.network(input_size, torch.Generator().manual_seed(seed))
        self.optimizer = self.build_optimizer(self.model)
        self._np_rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

    def network(self, input_size: int, generator: torch.Generator | None = None
                ) -> DecoderNetwork:
        """A network of this configuration over ``input_size`` words on the
        model's device, its weights drawn from ``generator`` (a CPU
        generator; ``None``: torch's default initialization)."""
        return DecoderNetwork(
            input_size=input_size, n_components=self.n_components,
            model_type=self.model_type, hidden_sizes=self.hidden_sizes,
            activation=self.activation, dropout=self.dropout, learn_priors=self.learn_priors,
            topic_prior_mean=self.topic_prior_mean,
            topic_prior_variance=self.topic_prior_variance, generator=generator,
            compute_dtype=self._module_dtype(), inference_type=self.inference_type,
            contextual_size=self._contextual_size(), label_size=self._label_size(),
        ).to(self.device)

    def _module_dtype(self) -> torch.dtype:
        """The network's compute dtype (its parameters stay float32)."""
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    # ---- subclass hooks (CTM overrides) ------------------------------------
    def _contextual_size(self) -> int:
        return 0

    def _label_size(self) -> int:
        return 0

    def _beta_weight(self) -> float:
        return 1.0

    def _host_data(self, dataset: BowDataset) -> dict:
        """The dataset's arrays as the steps read them: ``{"x_bow": X}``.
        Under bf16 compute the first corpus staged is screened for counts
        bf16 cannot hold (``avitm.py:259-268``); only the BoW counts are
        screened."""
        if self.compute_dtype == "bfloat16" and not self._bf16_bow_checked:
            self._bf16_bow_checked = True
            check_bf16_bow_counts(dataset.X, self.logger)
        return {"x_bow": dataset.X}

    def _device_data(self, dataset: BowDataset) -> dict:
        """:meth:`_host_data` on the model's device."""
        return {key: torch.as_tensor(value, device=self.device)
                for key, value in self._host_data(dataset).items()}

    def build_optimizer(self, model: DecoderNetwork) -> torch.optim.Optimizer:
        """A fresh optimizer of this configuration over ``model``'s params."""
        return build_optimizer(model.parameters(), self.solver, self.lr, self.momentum)

    def step_flops(self, dataset: BowDataset) -> float:
        """Model FLOPs of one training step at ``batch_size``
        (:func:`~gfedntm_tpu_torch.utils.flops.measure_step_flops`): every GEMM
        of the forward, backward and update, and the fused decoder's
        2·B·K·V + 4·B·K·V. It is counted on a CPU replica of the network
        with a fresh optimizer, on the first ``batch_size`` documents of
        ``dataset`` (repeated when it holds fewer), so this model's state,
        its generator and the kernels' launch counts are untouched; the
        count depends on shapes only, so it is the card's too."""
        replica = copy.deepcopy(self.model).to("cpu")
        data = {key: torch.as_tensor(value) for key, value in self._host_data(dataset).items()}
        rows = torch.arange(self.batch_size) % len(dataset)
        return measure_step_flops(
            grad_step, replica, self.build_optimizer(replica), take(data, rows),
            torch.ones(self.batch_size), self.fused_decoder,
            generator=torch.Generator().manual_seed(0), beta_weight=self._beta_weight())

    # ---- training ----------------------------------------------------------
    def fit(
        self,
        train_dataset: BowDataset,
        validation_dataset: BowDataset | None = None,
        save_dir: str | None = None,
        patience: int = 5,
        delta: float = 0.0,
        n_samples: int = 20,
    ) -> None:
        """Train with optional validation-based early stopping
        (``avitm.py:275-395``). With a validation set, every improvement of
        the validation loss saves into ``save_dir``; without one, every epoch
        does. ``best_components`` is beta after the last epoch run."""
        self.model_dir = save_dir
        corpus = DocShard(self._device_data(train_dataset))
        val_corpus = (None if validation_dataset is None
                      else DocShard(self._device_data(validation_dataset)))
        save = (lambda: self.save(save_dir)) if save_dir else None
        self._run_epochs(self.model, self.optimizer, train_dataset, corpus,
                         validation_dataset, val_corpus, save, patience, delta)
        self._finish_fit(train_dataset, n_samples)

    def _run_epochs(self, net, optimizer, train_dataset: BowDataset, x: DocShard,
                    validation_dataset: BowDataset | None = None,
                    x_val: DocShard | None = None, checkpoint_fn=None,
                    patience: int = 5, delta: float = 0.0, vshard=None,
                    on_epoch=None) -> None:
        """The epoch loop of :meth:`fit` on ``net`` and its ``optimizer``:
        every epoch's numpy schedule, its steps (``x`` holds the corpus on
        the device), the epoch and step losses; then, with a validation set
        (``x_val`` on the device), the validation schedule and loss, the NaN
        abort, :class:`EarlyStopping` (``checkpoint_fn`` on every
        improvement) and the plateau scheduler on the validation loss;
        without one, the NaN abort, the scheduler on the training loss and
        ``checkpoint_fn`` every epoch. On a rank of a sharded fit
        (:mod:`gfedntm_tpu_torch.parallel.sharded`), ``net`` is the
        rank-local network, ``x`` and ``x_val`` are the rank's
        :class:`DocShard` blocks (their data group splits each batch's rows)
        and ``vshard`` (a ``DpMpGroups``) runs the fused loss through K5
        and the unfused decodes on the rank's columns.
        ``on_epoch(epoch, seconds)`` gets each epoch's training wall time
        (synced)."""
        self.train_data = train_dataset
        self.validation_data = validation_dataset
        scheduler = ReduceLROnPlateau(self.lr) if self.reduce_on_plateau else None
        early_stopping = None
        if validation_dataset is not None:
            early_stopping = EarlyStopping(patience=patience, delta=delta,
                                           checkpoint_fn=checkpoint_fn, verbose=self.verbose)
        n_train = len(train_dataset)
        self.epoch_losses, self.step_losses, self.validation_losses = [], [], []
        for epoch in range(self.num_epochs):
            self.nn_epoch = epoch
            sched = make_epoch_schedule(n_train, self.batch_size, self._np_rng)
            start = time.perf_counter()
            losses = torch.stack([
                grad_step(net, optimizer, batch, mask, self.fused_decoder,
                          generator=self.generator, vshard=vshard, rows=rows,
                          data_group=x.data_group, beta_weight=self._beta_weight())
                for batch, mask, rows in x.steps(sched)
            ])
            train_loss = float(losses.sum()) / n_train
            if on_epoch is not None:
                on_epoch(epoch, time.perf_counter() - start)
            self.epoch_losses.append(train_loss)
            self.step_losses.extend(losses.cpu().tolist())
            if validation_dataset is not None:
                vsched = make_epoch_schedule(len(validation_dataset), self.batch_size,
                                             self._np_rng)
                val_loss = self._validation_loss(net, x_val, vsched, vshard)
                self.validation_losses.append(val_loss)
                if self.verbose:
                    self.logger.info("Epoch: [%d/%d]\tTrain Loss: %.4f\tValid Loss: %.4f",
                                     epoch + 1, self.num_epochs, train_loss, val_loss)
                if np.isnan(val_loss) or np.isnan(train_loss):
                    break
                early_stopping(val_loss)
                if early_stopping.early_stop:
                    self.logger.info("Early stopping")
                    break
                if scheduler is not None:
                    set_learning_rate(optimizer, scheduler.step(val_loss))
            else:
                # NaN abort in the train-only path too (intended reference
                # semantics: a NaN run is garbage either way).
                if np.isnan(train_loss):
                    break
                if scheduler is not None:
                    set_learning_rate(optimizer, scheduler.step(train_loss))
                if checkpoint_fn is not None:
                    checkpoint_fn()
                if self.verbose:
                    self.logger.info("Epoch: [%d/%d]\tTrain Loss: %.4f",
                                     epoch + 1, self.num_epochs, train_loss)

    def _validation_loss(self, net, x_val: DocShard, vsched, vshard=None) -> float:
        """The validation loss of one epoch: the summed losses of the
        validation schedule ``vsched`` over ``len(validation_data)``
        (``avitm.py:353-363``), the noise drawn from the model's generator.
        On a rank of a sharded fit (``x_val`` holds the rank's block) it is
        summed over the data group and checked to be equal on every rank."""
        losses = eval_steps(net, x_val.steps(vsched), generator=self.generator, vshard=vshard,
                            data_group=x_val.data_group, fused=self.fused_decoder,
                            beta_weight=self._beta_weight())
        val_loss = float(losses.sum()) / len(self.validation_data)
        if x_val.groups is not None and x_val.groups.world_group is not None:
            # Every rank decides early stopping and the LR on this value.
            check_equal_across(val_loss, x_val.groups.world_group, self.device,
                               "the validation loss")
        return val_loss

    def _finish_fit(self, train_dataset: BowDataset, n_samples: int) -> None:
        """``best_components`` and the training documents' topic mixtures
        from the trained (full) network."""
        self.best_components = self.model.beta.detach().cpu().numpy()
        self.training_doc_topic_distributions = self.get_doc_topic_distribution(
            train_dataset, n_samples
        )

    # ---- inference ---------------------------------------------------------
    @torch.no_grad()
    def get_doc_topic_distribution(
        self, dataset: BowDataset, n_samples: int = 20
    ) -> np.ndarray:
        """Theta averaged over ``n_samples`` reparameterization draws
        (``avitm.py:470-523``), with running BatchNorm stats and no dropout;
        a CTM reads the dataset's contextual embeddings (and labels)."""
        data = self._device_data(dataset)
        idx, _ = full_batch_indices(len(dataset), self.batch_size)
        thetas = []
        for step_idx in torch.as_tensor(idx, device=self.device, dtype=torch.long):
            batch = take(data, step_idx)
            draws = [self.model.get_theta(batch["x_bow"], batch.get("x_ctx"),
                                          batch.get("labels"), generator=self.generator)
                     for _ in range(n_samples)]
            thetas.append(torch.stack(draws).mean(0))
        # A bf16 model's mixtures are bf16, as the JAX package's; numpy holds
        # them as float32.
        return torch.cat(thetas).float().cpu().numpy()[: len(dataset)]

    def get_predicted_topics(self, dataset: BowDataset, n_samples: int = 20) -> list[int]:
        """Most likely topic per document (``avitm.py:412``)."""
        thetas = self.get_doc_topic_distribution(dataset, n_samples)
        return np.argmax(thetas, axis=1).tolist()

    def get_topic_word_matrix(self) -> np.ndarray:
        """Unnormalized beta for prodLDA; softmax-BN beta for LDA
        (``decoder_network.py:121-132``)."""
        beta = self.model.beta.detach().cpu().numpy()
        if self.model_type.lower() == "lda":
            bn = self.model.beta_batchnorm
            normed = (beta - bn.running_mean.cpu().numpy()) / np.sqrt(
                bn.running_var.cpu().numpy() + 1e-5
            )
            e = np.exp(normed - normed.max(axis=1, keepdims=True))
            return e / e.sum(axis=1, keepdims=True)
        return beta

    def get_topic_word_distribution(self) -> np.ndarray:
        """Row-softmax of the topic-word matrix (``avitm.py:539-551``)."""
        mat = self.get_topic_word_matrix()
        e = np.exp(mat - mat.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    def get_topics(self, k: int = 10) -> list[list[str]]:
        """Top-k words per topic from ``best_components`` (``avitm.py:553-580``)."""
        _require(k <= self.input_size, "k must be <= input size.")
        component_dists = self.best_components
        idx2token = self.train_data.idx2token if self.train_data else {}
        topics_list = []
        for i in range(self.n_components):
            idxs = np.argsort(-component_dists[i])[:k]
            topics_list.append([idx2token.get(int(j), str(int(j))) for j in idxs])
        return topics_list

    # ---- persistence -------------------------------------------------------
    def _config_dict(self) -> dict:
        return {
            "input_size": self.input_size,
            "n_components": self.n_components,
            "model_type": self.model_type,
            "hidden_sizes": list(self.hidden_sizes),
            "activation": self.activation,
            "dropout": self.dropout,
            "learn_priors": self.learn_priors,
            "batch_size": self.batch_size,
            "lr": self.lr,
            "momentum": self.momentum,
            "solver": self.solver,
            "num_epochs": self.num_epochs,
            "topic_prior_mean": self.topic_prior_mean,
            "topic_prior_variance": self.topic_prior_variance,
            "num_samples": self.num_samples,
            "nn_epoch": self.nn_epoch,
        }

    def save(self, models_dir: str | None = None) -> None:
        """Write ``epoch_{nn_epoch}.npz`` and ``.json`` into ``models_dir``
        (``avitm.py:459-471``). A bf16-compute model writes its float32
        state, which is all it holds."""
        self._write(models_dir, self.model.state_dict())

    def _write(self, models_dir: str | None, state_dict) -> None:
        """:meth:`save` of the network state ``state_dict`` (a full one: the
        V-sharded fit writes the state gathered from its ranks)."""
        if models_dir is None:
            return
        os.makedirs(models_dir, exist_ok=True)
        tag = f"epoch_{self.nn_epoch}"
        params, batch_stats = flax_from_state_dict(state_dict)
        save_variables(os.path.join(models_dir, f"{tag}.npz"),
                       {"params": params, "batch_stats": batch_stats})
        with open(os.path.join(models_dir, f"{tag}.json"), "w") as f:
            json.dump(self._config_dict(), f, indent=2, default=str)

    def load(self, model_dir: str, epoch: int) -> None:
        """Restore a checkpoint written by ``save`` of either package
        (``avitm.py:473-493``) onto the model's device, with a fresh
        optimizer."""
        variables = load_variables(os.path.join(model_dir, f"epoch_{epoch}.npz"))
        self.model.load_state_dict(state_dict_from_flax(
            variables["params"], variables.get("batch_stats", {})))
        self.optimizer = self.build_optimizer(self.model)
        self.nn_epoch = epoch
        self.best_components = self.model.beta.detach().cpu().numpy()
