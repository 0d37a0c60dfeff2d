"""Federated training of C clients in one process on one device.

Counterpart of ``gfedntm_tpu/federated/trainer.py:52-214, 217-684``. The
semantics are the reference's (``federated_avitm.py:51-83``,
``server.py:476-487``): per global step every client runs one local
minibatch forward/backward/optimizer step on its own data and optimizer
state; then every shared floating state-dict entry — parameters and
BatchNorm buffers alike — is replaced in every client by the average across
clients weighted by each client's sample count. Integer entries
(``num_batches_tracked``) are not averaged, and optimizer state stays per
client. Clients cycle their own epochs independently. The template's compute
dtype rides along: a bf16-compute template trains bf16 networks whose shared
state, float32 like the template's, is averaged as above.

The JAX package runs this as one SPMD program over a client mesh; here it is
a loop over C (model, optimizer) pairs on one GPU. Checkpoint/resume,
metrics and the segment callback are later slices.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np
import torch

from gfedntm_tpu_torch.data.datasets import BowDataset, make_run_schedule
from gfedntm_tpu_torch.device import resolve_device
from gfedntm_tpu_torch.models.avitm import AVITM
from gfedntm_tpu_torch.models.params import SHARE_ALL, build_share_mask
from gfedntm_tpu_torch.train.steps import grad_step


@dataclass
class FederatedResult:
    """Outcome of a federated run. State dicts hold tensors on the
    trainer's device."""

    global_params: dict  # shared params after the last exchange (client 0's view)
    client_params: list  # per client {name: parameter}
    client_batch_stats: list  # per client {name: buffer}
    losses: np.ndarray  # [S, C] per-step per-client summed batch loss
    steps_per_epoch: np.ndarray  # [C]
    n_samples: np.ndarray  # [C] FedAvg weights
    epoch_losses: list[list[float]] = field(default_factory=list)  # per client


class FederatedTrainer:
    """Orchestrates a federated run from per-client datasets.

    ``template`` is a configured (untrained) :class:`AVITM` whose network,
    optimizer state and hyperparameters every client clones — the
    reference's server-initialized global model shipped to all clients
    (``server.py:290-331``). ``local_steps`` E exchanges every E global
    steps (and always at the last one); E=1 is the reference's
    per-minibatch FedAvg.
    """

    def __init__(
        self,
        template: AVITM,
        n_clients: int,
        grads_to_share: tuple[str, ...] = SHARE_ALL,
        max_iters: int = 25_000,
        seed: int = 0,
        local_steps: int = 1,
        device: str | torch.device | None = None,
    ):
        if local_steps < 1:
            raise ValueError(f"local_steps must be >= 1, got {local_steps}")
        self.device = resolve_device(device)
        self.template = template
        self.n_clients = n_clients
        self.grads_to_share = tuple(grads_to_share)
        self.max_iters = max_iters
        self.seed = seed
        self.local_steps = int(local_steps)
        self.share_mask = build_share_mask(
            template.model.state_dict().keys(), self.grads_to_share
        )

    def fit(self, datasets: list[BowDataset]) -> FederatedResult:
        t = self.template
        C, B = self.n_clients, t.batch_size
        if len(datasets) != C:
            raise ValueError(f"expected {C} client datasets, got {len(datasets)}")
        n_samples = np.array([len(d) for d in datasets], dtype=np.float32)
        steps_per_epoch = np.array(
            [max(1, -(-len(d) // B)) for d in datasets], dtype=np.int64
        )
        total_steps = int(min(steps_per_epoch.max() * t.num_epochs, self.max_iters))

        dev = self.device
        schedules = [
            make_run_schedule(len(d), B, total_steps, seed=self.seed * 1000 + c)
            for c, d in enumerate(datasets)
        ]
        indices = [torch.as_tensor(s.indices, device=dev, dtype=torch.long) for s in schedules]
        masks = [torch.as_tensor(s.mask, device=dev, dtype=torch.float32) for s in schedules]
        data = [t._device_data(d.X) for d in datasets]

        # Identical initial state for every client: the template's network
        # and optimizer state (server.py:303-311 semantics).
        models, optimizers = [], []
        for _ in range(C):
            model = copy.deepcopy(t.model).to(dev)
            opt = t.build_optimizer(model)
            opt.load_state_dict(t.optimizer.state_dict())
            models.append(model)
            optimizers.append(opt)
        weights = torch.as_tensor(n_samples, device=dev)
        total_weight = float(n_samples.sum())
        # Exchange after step s iff (s+1) % E == 0, and always after the last.
        exchange = ((np.arange(total_steps) + 1) % self.local_steps) == 0
        if total_steps:
            exchange[-1] = True

        generator = torch.Generator(device=dev).manual_seed(self.seed + 17)
        losses = torch.zeros((total_steps, C), device=dev)
        for step in range(total_steps):
            for c in range(C):
                losses[step, c] = grad_step(
                    models[c], optimizers[c], data[c][indices[c][step]],
                    masks[c][step], t.fused_decoder, generator=generator,
                )
            if exchange[step]:
                self._fedavg(models, weights, total_weight)
        losses_np = losses.cpu().numpy()

        epoch_losses: list[list[float]] = []
        for c in range(C):
            spe = int(steps_per_epoch[c])
            epoch_losses.append([
                float(losses_np[e * spe:(e + 1) * spe, c].sum()) / float(n_samples[c])
                for e in range(total_steps // spe)
            ])
        client_params = [
            {k: p.detach().clone() for k, p in m.named_parameters()} for m in models
        ]
        return FederatedResult(
            global_params={k: v.clone() for k, v in client_params[0].items()},
            client_params=client_params,
            client_batch_stats=[
                {k: b.clone() for k, b in m.named_buffers()} for m in models
            ],
            losses=losses_np,
            steps_per_epoch=steps_per_epoch,
            n_samples=n_samples,
            epoch_losses=epoch_losses,
        )

    @torch.no_grad()
    def _fedavg(self, models, weights, total_weight: float) -> None:
        """Sample-weighted average of every shared floating entry, written
        back into every client (``server.py:476-487``)."""
        states = [m.state_dict() for m in models]
        for key, shared in self.share_mask.items():
            if not shared or not states[0][key].is_floating_point():
                continue
            stacked = torch.stack([s[key] for s in states])
            avg = torch.tensordot(weights, stacked, dims=1) / total_weight
            for s in states:
                s[key].copy_(avg)

    def _model_from(self, params: dict, buffers: dict,
                    dataset: BowDataset | None) -> AVITM:
        model = copy.copy(self.template)
        model.model = copy.deepcopy(self.template.model)
        model.model.load_state_dict({**params, **buffers})
        model.optimizer = model.build_optimizer(model.model)
        model.best_components = model.model.beta.detach().cpu().numpy()
        if dataset is not None:
            model.train_data = dataset
        return model

    def make_client_model(self, result: FederatedResult, c: int,
                          dataset: BowDataset | None = None) -> AVITM:
        """Client ``c``'s trained model as a standalone AVITM (the
        ``get_results_model`` path, ``federated_model.py:151-181``)."""
        return self._model_from(result.client_params[c],
                                result.client_batch_stats[c], dataset)

    def make_global_model(self, result: FederatedResult,
                          dataset: BowDataset | None = None) -> AVITM:
        """The server's view: the aggregated model (``get_topics_in_server``,
        ``federated_model.py:183-197``). Pass a dataset so ``get_topics``
        resolves token names from its ``idx2token``."""
        return self._model_from(result.global_params,
                                result.client_batch_stats[0], dataset)
