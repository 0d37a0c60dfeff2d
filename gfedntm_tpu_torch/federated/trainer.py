"""Federated training of C clients: in one process on one device, or over
the ranks of a client layout.

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
state, float32 like the template's, is averaged as above. A CTM template
(:class:`~gfedntm_tpu_torch.models.ctm.CTM`) trains CTM clients: each
client's contextual embeddings and labels are staged beside its BoW corpus
(``trainer.py:335-345``), its steps take the CTM loss, and
:meth:`FederatedTrainer.make_global_model` / :meth:`make_client_model`
return CTMs (``:652-684``).

The JAX package runs this as one SPMD program over a client mesh. Here,
without a layout, it is a loop over C (model, optimizer) pairs on one
device. With one (``devices=`` or ``mesh=``, a
:class:`~gfedntm_tpu_torch.parallel.mesh.ClientLayout`; the JAX trainer's
``devices``/``mesh``, ``:217-265``), every rank of the layout calls
:meth:`FederatedTrainer.fit` with the same arguments and steps only its
block of clients, on its device, with the fused kernels as on one device;
the padded clients carry no data and no weight and are not stepped. The
run stays bitwise the one-device run:

- every rank makes every client's noise and dropout draws from the one
  stateful generator, in the fixed order (step by step, client by client),
  and keeps its own clients' draws: a client of another rank is drawn for
  on a one-word replica of the network (the draws' shapes do not depend on
  the vocabulary), which launches no kernel;
- FedAvg gathers the shared state of every client in client order
  (``collectives.gather_by_sum``: adding zeros is exact) and reduces it on
  every rank with the one-device arithmetic.

``fit`` runs in segments (``trainer.py:464-584``): ``checkpoint_every``
steps each, or the whole run. After each segment it logs
``federated_segment``, calls ``segment_callback`` and checkpoints into
``checkpoint_dir`` (:class:`~gfedntm_tpu_torch.train.checkpoint.CheckpointManager`);
``resume=True`` restores the latest checkpoint and continues from its
absolute step. Every client's noise and dropout come from one stateful
generator, drawn in a fixed order (step by step, client by client), so a
checkpoint also holds that generator's state: with it, a resumed run
repeats the uninterrupted one bit for bit, as the JAX package's
absolute-step RNG folding makes its runs do. Segments do not change the
draw order, so a run without checkpoints is the same with or without them.
A checkpoint holds every client (gathered to the layout's rank 0, which
writes it), so one written on any layout resumes on any other.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from gfedntm_tpu_torch.data.datasets import BowDataset, make_run_schedule
from gfedntm_tpu_torch.device import resolve_device
from gfedntm_tpu_torch.models.avitm import AVITM
from gfedntm_tpu_torch.models.params import SHARE_ALL, build_share_mask
from gfedntm_tpu_torch.parallel.collectives import gather_by_sum, sum_in_rank_order
from gfedntm_tpu_torch.parallel.mesh import ClientLayout, make_client_mesh
from gfedntm_tpu_torch.train.checkpoint import CheckpointManager, to_cpu
from gfedntm_tpu_torch.train.steps import grad_step, take
from gfedntm_tpu_torch.utils.flops import mfu as compute_mfu
from gfedntm_tpu_torch.utils.flops import resolve_peak_flops_per_device
from gfedntm_tpu_torch.utils.observability import phase_timer


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

    ``template`` is a configured (untrained) :class:`AVITM` or CTM whose network,
    optimizer state and hyperparameters every client clones — the
    reference's server-initialized global model shipped to all clients
    (``server.py:290-331``). ``local_steps`` E exchanges every E global
    steps (and always at the last one); E=1 is the reference's
    per-minibatch FedAvg.

    ``devices`` (a rank count: :func:`make_client_mesh` over the default
    group's first ranks) or ``mesh`` (a layout; its padded client count is
    recomputed for ``n_clients``) runs the clients over ranks (module
    docstring); ``device`` is this rank's. Without either, or with a layout
    of one rank, the run is this process's alone.
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
        devices: int | None = None,
        mesh: ClientLayout | None = None,
    ):
        if local_steps < 1:
            raise ValueError(f"local_steps must be >= 1, got {local_steps}")
        if mesh is not None and devices is not None:
            raise ValueError("pass either devices= or mesh=, not both (a layout already "
                             "fixes its ranks)")
        if mesh is not None:
            layout = dataclasses.replace(mesh, c_pad=-(-n_clients // mesh.ranks) * mesh.ranks)
        elif devices is not None:
            layout, _ = make_client_mesh(n_clients, ranks=devices)
        else:
            layout = None
        if layout is not None and layout.ranks > 1 and layout.group is None:
            raise ValueError(f"a layout of {layout.ranks} ranks needs a process group: "
                             "initialize the default group first")
        #: The client layout (``None``: this process alone).
        self.layout = layout if layout is not None and layout.ranks > 1 else None
        self.c_pad = n_clients if self.layout is None else self.layout.c_pad
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
        # The entries FedAvg averages: shared and floating.
        state = template.model.state_dict()
        self._avg_keys = [key for key, shared in self.share_mask.items()
                          if shared and state[key].is_floating_point()]
        # Segment lengths already run: the first segment of a length pays
        # the kernel build and allocator warm-up, as the JAX package's pays
        # its compile, and stays out of the step-time histogram.
        self._seen_lengths: set[int] = set()

    def fit(
        self,
        datasets: list[BowDataset],
        checkpoint_dir: str | None = None,
        checkpoint_every: int | None = None,
        resume: bool = False,
        metrics=None,
        segment_callback=None,
    ) -> FederatedResult:
        """Run the federated fit (see the class and module docstrings).

        ``checkpoint_dir`` saves the run after every segment of
        ``checkpoint_every`` steps and at its end; ``resume=True`` continues
        from the latest checkpoint there. ``metrics`` (a
        :class:`~gfedntm_tpu_torch.utils.observability.MetricsLogger`) gets
        the JAX package's records: ``phase`` for the schedules, the corpus
        staging and every segment (timed between device syncs), ``resume``,
        ``federated_segment``, the ``trainer_step_s`` histogram, the
        ``federated_mesh_devices``, ``docs_per_s`` and ``mfu`` gauges and a
        registry snapshot. ``mfu`` is the FLOPs of one global step (C
        clients' :meth:`AVITM.step_flops`, counted once before the steps)
        over the steady seconds per step and the device's peak
        (:func:`~gfedntm_tpu_torch.utils.flops.resolve_peak_flops_per_device`);
        like ``docs_per_s`` it needs a steady segment, one whose length ran
        before.

        ``segment_callback(step, params, batch_stats)`` is called after each
        segment with the absolute step and, per client, copies of the
        network's parameters and buffers, ``[{name: tensor}, ...]`` as in
        :attr:`FederatedResult.client_params`: copies, since the clients go
        on training in place. (The JAX package passes its stacked
        ``[C, ...]`` variable trees instead.)"""
        t = self.template
        C, B = self.n_clients, t.batch_size
        if len(datasets) != C:
            raise ValueError(f"expected {C} client datasets, got {len(datasets)}")
        layout = self.layout
        if layout is not None and layout.rank < 0:
            raise ValueError("this rank is past the layout's ranks (more ranks than clients); "
                             "call fit on the layout's ranks only")
        n_samples = np.array([len(d) for d in datasets], dtype=np.float32)
        steps_per_epoch = np.array(
            [max(1, -(-len(d) // B)) for d in datasets], dtype=np.int64
        )
        total_steps = int(min(steps_per_epoch.max() * t.num_epochs, self.max_iters))
        # The clients this rank steps (all of them without a layout).
        own = list(range(C)) if layout is None else [c for c in layout.block() if c < C]

        dev = self.device
        with phase_timer(metrics, "build_schedules"):
            schedules = [
                make_run_schedule(len(d), B, total_steps, seed=self.seed * 1000 + c)
                for c, d in enumerate(datasets)
            ]
        with phase_timer(metrics, "stage_data"):
            indices = {c: torch.as_tensor(schedules[c].indices, device=dev, dtype=torch.long)
                       for c in own}
            masks = {c: torch.as_tensor(schedules[c].mask, device=dev, dtype=torch.float32)
                     for c in own}
            data = {c: t._device_data(datasets[c]) for c in own}
            self._sync(metrics)

        # Identical initial state for every client: the template's network
        # and optimizer state (server.py:303-311 semantics).
        models, optimizers = {}, {}
        for c in own:
            model = copy.deepcopy(t.model).to(dev)
            opt = t.build_optimizer(model)
            opt.load_state_dict(t.optimizer.state_dict())
            models[c] = model
            optimizers[c] = opt
        weights = torch.as_tensor(n_samples, device=dev)
        total_weight = float(n_samples.sum())
        # Exchange after step s iff (s+1) % E == 0, and always after the last.
        exchange = ((np.arange(total_steps) + 1) % self.local_steps) == 0
        if total_steps:
            exchange[-1] = True

        generator = torch.Generator(device=dev).manual_seed(self.seed + 17)
        draws = None if len(own) == C else _DrawReplica(t, B, datasets)
        losses = torch.zeros((total_steps, C), device=dev)
        manager = None
        start_step = 0
        if checkpoint_dir is not None:
            manager = CheckpointManager(checkpoint_dir)
            if resume and manager.latest_step() is not None:
                start_step = self._restore(manager, models, optimizers, generator, losses)
                if metrics is not None:
                    metrics.log("resume", step=start_step)

        def checkpoint(step, force=False):
            states = self._gather_states(models, optimizers)
            if states is not None:
                manager.save(step, {
                    "step": step,
                    "models": states[0],
                    "optimizers": states[1],
                    "losses": losses[:step],
                    "generator": generator.get_state(),
                }, force=force)
            self._barrier()

        # Model FLOPs of one global step, counted before the timed window on
        # a CPU replica (the run's state and launch counts stay untouched).
        step_flops = C * t.step_flops(datasets[0]) if metrics is not None else None
        seg_len = checkpoint_every or total_steps
        steady_s, steady_steps = 0.0, 0
        step = start_step
        while step < total_steps:
            n = min(seg_len, total_steps - step)
            self._sync(metrics)
            t0 = time.perf_counter()
            try:
                for s in range(step, step + n):
                    for c in range(C):
                        if c not in models:
                            draws.take(c, generator)
                            continue
                        losses[s, c] = grad_step(
                            models[c], optimizers[c], take(data[c], indices[c][s]),
                            masks[c][s], t.fused_decoder, generator=generator,
                            beta_weight=t._beta_weight(),
                        )
                    if exchange[s]:
                        self._fedavg(models, weights, total_weight)
                self._sync(metrics)
            finally:
                # Logged even when the segment raises, so a crashed run
                # keeps its in-flight segment timing.
                seg_s = time.perf_counter() - t0
                if metrics is not None:
                    metrics.log("phase", phase="program_segment", seconds=seg_s, steps=n)
            if layout is not None:
                # Every rank's losses of the segment (each column is one
                # rank's, the others zero: the sum is exact).
                losses[step:step + n] = sum_in_rank_order(losses[step:step + n], layout.group)
            if n in self._seen_lengths:
                steady_s += seg_s
                steady_steps += n
                if metrics is not None:
                    metrics.registry.histogram("trainer_step_s").observe(seg_s / n)
            self._seen_lengths.add(n)
            step += n
            if metrics is not None:
                metrics.log("federated_segment", step=step,
                            mean_loss=float(losses[step - n:step].mean()))
            if segment_callback is not None:
                params, buffers = self._client_tensors(models)
                segment_callback(step, params, buffers)
            if manager is not None and step < total_steps:
                checkpoint(step)
        if manager is not None:
            # A run that resumed complete already has its final checkpoint.
            if start_step < total_steps:
                checkpoint(total_steps, force=True)
            manager.close()
        losses_np = losses.cpu().numpy()

        if metrics is not None:
            reg = metrics.registry
            n_dev = 1 if layout is None else layout.ranks
            reg.gauge("federated_mesh_devices").set(float(n_dev))
            if steady_steps > 0 and steady_s > 0:
                docs_per_step = float(sum(s.mask.sum() for s in schedules)) / total_steps
                docs_per_s = docs_per_step * steady_steps / steady_s
                reg.gauge("docs_per_s").set(docs_per_s)
                reg.gauge("docs_per_s_per_device").set(docs_per_s / n_dev)
                peak, _source = resolve_peak_flops_per_device(dev)
                mfu_val = compute_mfu(step_flops, steady_s / steady_steps, n_dev, peak)
                if mfu_val is not None:
                    reg.gauge("mfu").set(mfu_val)
            metrics.snapshot_registry(step=total_steps)

        epoch_losses: list[list[float]] = []
        for c in range(C):
            spe = int(steps_per_epoch[c])
            epoch_losses.append([
                float(losses_np[e * spe:(e + 1) * spe, c].sum()) / float(n_samples[c])
                for e in range(total_steps // spe)
            ])
        client_params, client_buffers = self._client_tensors(models)
        return FederatedResult(
            global_params={k: v.clone() for k, v in client_params[0].items()},
            client_params=client_params,
            client_batch_stats=client_buffers,
            losses=losses_np,
            steps_per_epoch=steps_per_epoch,
            n_samples=n_samples,
            epoch_losses=epoch_losses,
        )

    def _client_tensors(self, models: dict) -> tuple[list, list]:
        """Copies of every client's parameters and buffers, ``[{name:
        tensor}, ...]`` in client order on this rank's device; over a layout
        they are gathered from their ranks (a collective)."""
        if self.layout is None:
            ordered = [models[c] for c in range(self.n_clients)]
            return ([{k: p.detach().clone() for k, p in m.named_parameters()} for m in ordered],
                    [{k: b.clone() for k, b in m.named_buffers()} for m in ordered])
        params = dict(self.template.model.named_parameters())
        every = self._every_client(models)
        states = [{k: v.to(self.device) for k, v in every[c][0].items()}
                  for c in range(self.n_clients)]
        return ([{k: v for k, v in st.items() if k in params} for st in states],
                [{k: v for k, v in st.items() if k not in params} for st in states])

    def _every_client(self, models: dict, optimizers: dict | None = None) -> dict:
        """``{client: (state dict, optimizer state or None)}`` of every
        client, CPU copies on every rank of the layout (pickled over its
        group)."""
        mine = {c: (to_cpu(models[c].state_dict()),
                    None if optimizers is None else to_cpu(optimizers[c].state_dict()))
                for c in models}
        parts = [None] * self.layout.ranks
        dist.all_gather_object(parts, mine, group=self.layout.group)
        return {c: v for part in parts for c, v in part.items()}

    def _gather_states(self, models: dict, optimizers: dict):
        """``([state dict per client], [optimizer state per client])`` in
        client order for a checkpoint, gathered over a layout; ``None`` on
        every rank but the layout's rank 0, which writes it."""
        if self.layout is None:
            return ([models[c].state_dict() for c in range(self.n_clients)],
                    [optimizers[c].state_dict() for c in range(self.n_clients)])
        every = self._every_client(models, optimizers)
        if self.layout.rank != 0:
            return None
        return ([every[c][0] for c in range(self.n_clients)],
                [every[c][1] for c in range(self.n_clients)])

    def _barrier(self) -> None:
        """Wait for every rank of the layout (a checkpoint is on disk before
        any rank goes on)."""
        if self.layout is not None:
            dist.barrier(group=self.layout.group)

    def _sync(self, metrics) -> None:
        """Wait for the device, when a metrics logger times the run."""
        if metrics is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _restore(manager, models, optimizers, generator, losses) -> int:
        """Load the latest checkpoint into this rank's clients, the generator
        and the first rows of ``losses``; returns its absolute step."""
        state = manager.restore()
        if len(state["models"]) != losses.shape[1]:
            raise ValueError(f"checkpoint holds {len(state['models'])} clients, "
                             f"the run has {losses.shape[1]}")
        for c, model in models.items():
            model.load_state_dict(state["models"][c])
            optimizers[c].load_state_dict(state["optimizers"][c])
        generator.set_state(state["generator"])
        step = int(state["step"])
        losses[:step] = state["losses"].to(losses.device)
        return step

    @torch.no_grad()
    def _fedavg(self, models, weights, total_weight: float) -> None:
        """Sample-weighted average of every shared floating entry, written
        back into every client (``server.py:476-487``); ``models`` is every
        client's network in client order, or ``{client: network}`` of this
        rank's. Over a layout each entry of every client is gathered first,
        so every rank averages the same [C, ...] stack with the same
        arithmetic."""
        C = self.n_clients
        if not isinstance(models, dict):
            models = dict(enumerate(models))
        states = {c: m.state_dict() for c, m in models.items()}
        keys = self._avg_keys
        stacks = (self._gathered(states, keys) if self.layout is not None
                  else {key: torch.stack([states[c][key] for c in range(C)]) for key in keys})
        for key in keys:
            avg = torch.tensordot(weights, stacks[key], dims=1) / total_weight
            for s in states.values():
                s[key].copy_(avg)

    def _gathered(self, states: dict, keys: list) -> dict:
        """``{key: [C, ...]}``: the entries ``keys`` of every client, in
        client order, from one collective over the layout (this rank's
        block flattened side by side, zeros for the padded clients)."""
        layout, C = self.layout, self.n_clients
        ref = self.template.model.state_dict()
        sizes = [ref[key].numel() for key in keys]
        zero = torch.zeros(sum(sizes), device=self.device)
        rows = torch.stack([
            torch.cat([states[c][key].reshape(-1) for key in keys]) if c in states else zero
            for c in layout.block()])
        every = gather_by_sum(rows, layout.group).reshape(layout.c_pad, -1)[:C]
        parts = every.split(sizes, dim=1)
        return {key: part.reshape(C, *ref[key].shape).contiguous()
                for key, part in zip(keys, parts)}

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
        """Client ``c``'s trained model as a standalone model of the
        template's class, AVITM or CTM (the ``get_results_model`` path,
        ``federated_model.py:151-181``)."""
        return self._model_from(result.client_params[c],
                                result.client_batch_stats[c], dataset)

    def make_global_model(self, result: FederatedResult,
                          dataset: BowDataset | None = None) -> AVITM:
        """The server's view: the aggregated model (``get_topics_in_server``,
        ``federated_model.py:183-197``). Pass a dataset so ``get_topics``
        resolves token names from its ``idx2token``."""
        return self._model_from(result.global_params,
                                result.client_batch_stats[0], dataset)


class _DrawReplica:
    """Draws the noise and dropout of a client that another rank steps, so
    that the one stateful generator advances as in the one-device run: the
    same encoder and reparameterization on a one-word replica of the
    template's network, in training mode on a batch of zeros of the
    client's shapes (a CTM's embeddings, and its labels where the client
    has them). The draws' shapes do not depend on the vocabulary, the
    replica's state is never read, and no kernel is launched."""

    def __init__(self, template, batch_size: int, datasets: list):
        self.net = template.network(1, torch.Generator().manual_seed(0))
        self.net.train()
        dev, B = template.device, batch_size
        ctx, labels = template._contextual_size(), template._label_size()
        self.inputs = {}
        for c, d in enumerate(datasets):
            has_labels = getattr(d, "labels", None) is not None and labels > 0
            self.inputs[c] = (
                torch.zeros((B, 1), device=dev),
                torch.zeros((B, ctx), device=dev) if ctx else None,
                torch.zeros((B, labels), device=dev) if has_labels else None,
            )
        self.mask = torch.ones(B, device=dev)

    @torch.no_grad()
    def take(self, client: int, generator: torch.Generator) -> None:
        x_bow, x_ctx, labels = self.inputs[client]
        self.net.encode_theta(x_bow, x_ctx, labels, mask=self.mask, generator=generator)
