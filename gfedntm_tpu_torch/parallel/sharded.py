"""Sharded AVITM training (prodLDA, fused or not, and LDA): data parallel,
V-sharded (model parallel), or both on a ``dp x mp`` layout.

Counterpart of ``gfedntm_tpu/parallel/sharded.py`` (``_leaf_spec`` :51-62,
``shard_data`` :77-88, ``fit_sharded`` :114-250, ``shard_docs`` :253-278,
``fit_data_sharded`` :281-554). Every V-sized axis is split over the model
group of a :class:`~gfedntm_tpu_torch.parallel.mesh.DpMpGroups` layout:

- ``beta`` [K, V] on dim 1 — the fused loss runs on each rank's columns
  through K5 (:func:`~gfedntm_tpu_torch.ops.fused_decoder.prodlda_recon_loss_vsharded`);
  the unfused prodLDA and the LDA decodes run on them in plain ops, their
  softmax over V merged over the model group and theta's decode gradient
  summed over it (``DecoderNetwork.forward``'s ``model_group``), and the
  reconstruction term summed over it
  (:func:`~gfedntm_tpu_torch.train.steps.batch_loss`); none launches a
  kernel, as in the JAX package;
- the encoder's input layer, ``inf_net.input_layer.weight`` [H, V] in torch's
  layout (the JAX kernel is [V, H]), on dim 1 — :class:`VShardedLinear` sums
  the ranks' ``x_m W_m^T`` and adds the bias once;
- ``beta_batchnorm.running_mean`` / ``running_var`` [V] on dim 0: per
  column, so local to the model rank (prodLDA's take the batch statistics
  of z = theta beta and sync over the data group; LDA's normalize the
  replicated beta over its topic rows and stay local);
- each rank holds only its columns of the corpus.

Every batch's rows are split over the data group, and so is the corpus: each
data rank holds one contiguous block of the documents (:class:`DocShard`,
the counterpart of ``shard_docs`` and of ``shard_data``'s
``P("data", "model")``). The encoder's BatchNorms (and the unfused prodLDA
decode's) take the whole batch's statistics over the data group, every draw
is made at the whole batch's shape, and every gradient is summed over the
data group before the optimizer steps (``train/steps.py``), so the run is
the single-device run up to float reduction order, as under GSPMD.

Everything else is replicated, and stays bitwise equal on every rank: each
rank draws the same schedule from the model's numpy generator and the same
noise from its identically seeded torch generator, and every reduction that
feeds replicated state is folded in rank order.

A bf16-compute model (``compute_dtype="bfloat16"``) trains the same way:
its input layer sums the ranks' partial products in float32 and rounds once
(:class:`VShardedLinear`), and K5 reads the rank's beta and x in bf16.

With a validation set, each epoch's validation loss runs in eval mode on
the rank-local network and the rank's rows: through K5's forward with
``training=False`` when the fused loss is sharded (the softmax over V spans
the model group), the merged unfused decode otherwise
(:func:`~gfedntm_tpu_torch.train.steps.eval_loss`), summed over the data
group. Early stopping saves the gathered state from world rank 0.

A later slice: CTM.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from gfedntm_tpu_torch.data.datasets import BowDataset
from gfedntm_tpu_torch.device import resolve_device
from gfedntm_tpu_torch.models.layers import MaskedBatchNorm, Rows
from gfedntm_tpu_torch.parallel.collectives import (
    gather_by_sum,
    sum_forward_identity_backward,
)
from gfedntm_tpu_torch.parallel.mesh import DpMpGroups, pad_to_multiple
from gfedntm_tpu_torch.train.steps import pad_batch_axis

#: State-dict keys split on V, and the dim that holds V (torch layouts).
V_SHARDED = {
    "beta": 1,
    "inf_net.input_layer.weight": 1,
    "beta_batchnorm.running_mean": 0,
    "beta_batchnorm.running_var": 0,
}


def leaf_shard_dim(name: str, shape, vocab_size: int) -> int | None:
    """The dim of ``name`` split over the model group, or ``None`` when the
    leaf is replicated (``_leaf_spec`` in torch's layouts)."""
    dim = V_SHARDED.get(name)
    if dim is not None and tuple(shape)[dim] != vocab_size:
        raise ValueError(f"{name} {tuple(shape)}: dim {dim} is not the vocabulary ({vocab_size})")
    return dim


def _columns(t: torch.Tensor, dim: int, cols: slice) -> torch.Tensor:
    return t.narrow(dim, cols.start, cols.stop - cols.start).clone()


def _gather_columns(t: torch.Tensor, dim: int, groups: DpMpGroups) -> torch.Tensor:
    return torch.cat(list(gather_by_sum(t.contiguous(), groups.model_group)), dim=dim)


def shard_state_dict(full, groups: DpMpGroups) -> dict:
    """This rank's slice of a full state dict."""
    vocab = full["beta"].shape[1]
    cols = groups.v_slice(vocab)
    out = {}
    for name, t in full.items():
        dim = leaf_shard_dim(name, t.shape, vocab)
        out[name] = t if dim is None else _columns(t, dim, cols)
    return out


def gather_state_dict(local, groups: DpMpGroups) -> dict:
    """The full state dict from every model rank's slice (a collective: every
    rank of the model group calls it with its own ``local``)."""
    return {
        name: t if name not in V_SHARDED else _gather_columns(t, V_SHARDED[name], groups)
        for name, t in local.items()
    }


def _map_optimizer_state(state: dict, names: list[str], fn) -> dict:
    """A copy of an optimizer state dict with ``fn(tensor, dim)`` applied to
    the V-shaped slots (Adam's moments, Adagrad's sums) of the V-split
    parameters; ``names`` are the parameter names in the optimizer's order."""
    out = copy.deepcopy(state)
    for i, slot in out["state"].items():
        dim = V_SHARDED.get(names[i])
        for key, value in slot.items():
            if dim is not None and torch.is_tensor(value) and value.dim() > 0:
                slot[key] = fn(value, dim)
    return out


class VShardedLinear(nn.Module):
    """The encoder's input layer with its V columns split over the model
    group: ``h = sum_m x_m W_m^T + b``. The bias is added once, after the
    sum, and the sum's backward is the identity (everything after it is
    replicated on every rank of the group), so each rank's weight gradient
    is ``dh^T x_m``.

    Under a bf16 ``compute_dtype`` each rank's product takes the
    bf16-rounded x and W in float32 (exact products, float32 sums), the
    partials are summed in float32 and the sum is rounded to bf16 once
    before the bf16 bias: the unsharded bf16 layer (:class:`Linear`)
    rounds its float32-accumulated product once too, so the two differ
    only in the order of the sum."""

    def __init__(self, in_local: int, out_features: int, group,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_local))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.group = group
        self.compute_dtype = compute_dtype

    def forward(self, x_local: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return sum_forward_identity_backward(F.linear(x_local, self.weight),
                                                 self.group) + self.bias
        part = F.linear(x_local.to(dt).float(), self.weight.to(dt).float())
        return sum_forward_identity_backward(part, self.group).to(dt) + self.bias.to(dt)


def local_network(network: nn.Module, groups: DpMpGroups) -> nn.Module:
    """A copy of ``network`` for this rank: with mp > 1 it holds the rank's
    V shard (a :class:`VShardedLinear` input layer, ``beta`` and its
    BatchNorm over the local columns), and with dp > 1 its BatchNorms sync
    over the data group (``set_data_group``: LDA's ``beta_batchnorm``
    stays local). Parameter order is the full network's."""
    local = copy.deepcopy(network)
    if groups.mp > 1:
        cols = groups.v_slice(network.beta.shape[1])
        width = cols.stop - cols.start
        device = network.beta.device
        hidden = network.inf_net.input_layer.out_features
        local.inf_net.input_layer = VShardedLinear(width, hidden, groups.model_group,
                                                   network.compute_dtype).to(device)
        local.beta = nn.Parameter(torch.empty(network.beta.shape[0], width, device=device))
        local.beta_batchnorm = MaskedBatchNorm(width).to(device)
        local.load_state_dict(shard_state_dict(network.state_dict(), groups))
    local.set_data_group(groups.data_group)
    return local


class DocShard:
    """A corpus as one rank holds it on the device: with ``groups``, the
    rank's data block of the documents (rows ``[start, start + n)`` of the
    corpus zero-padded to a multiple of dp; ``shard_docs``,
    ``gfedntm_tpu/parallel/sharded.py:253-278``) and its model group's
    columns; without, the whole corpus (``local``).

    :meth:`steps` yields each step's batch as this rank takes it. With
    dp > 1 each rank writes the batch rows it owns into a zeroed
    [B_pad, V_local] buffer and one ``all_reduce`` sum over the data group
    gives every rank the whole batch exactly (adding zeros is exact); each
    keeps its own rows."""

    def __init__(self, local: torch.Tensor, groups: DpMpGroups | None = None, start: int = 0):
        self.local = local
        self.groups = groups
        self.start = start
        self.dp = 1 if groups is None else groups.dp
        self.data_group = None if groups is None else groups.data_group

    @classmethod
    def place(cls, X: np.ndarray, groups: DpMpGroups, stage) -> "DocShard":
        """This rank's block of ``X`` [docs, V], uploaded by ``stage`` (the
        model's ``_device_data``): only its documents and columns."""
        cols = groups.v_slice(X.shape[1])
        per = pad_to_multiple(X.shape[0], groups.dp) // groups.dp
        start = groups.data_rank * per
        block = X[start:start + per, cols]
        if block.shape[0] < per:
            block = np.concatenate([block, np.zeros((per - block.shape[0], block.shape[1]),
                                                    block.dtype)])
        return cls(stage(np.ascontiguousarray(block)), groups, start)

    def gather_bytes(self, batch_size: int) -> int:
        """Bytes of one step's batch buffer that the gather sums over the
        data group (0 without one)."""
        if self.data_group is None:
            return 0
        return pad_to_multiple(batch_size, self.dp) * self.local.shape[1] * self.local.element_size()

    def gather(self, indices: torch.Tensor) -> torch.Tensor:
        """The rows ``indices`` (corpus document ids) of the corpus' columns
        this rank holds, on every rank of the data group."""
        n = self.local.shape[0]
        own = indices - self.start
        mine = (own >= 0) & (own < n)
        buf = torch.where(mine[:, None], self.local[own.clamp(0, n - 1)], 0.0)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.data_group)
        return buf

    def steps(self, sched):
        """``(x, mask, rows)`` for each step of the epoch schedule ``sched``:
        the rank's rows of the batch (padded with masked rows to a multiple
        of dp, ``pad_batch_axis``), their mask, and their
        :class:`~gfedntm_tpu_torch.models.layers.Rows` (``None`` with one
        data rank)."""
        indices, masks = pad_batch_axis(sched.indices, sched.mask, self.dp)
        device = self.local.device
        indices = torch.as_tensor(indices, device=device, dtype=torch.long)
        masks = torch.as_tensor(masks, device=device, dtype=torch.float32)
        if self.data_group is None:
            for i in range(len(indices)):
                yield self.local[indices[i]], masks[i], None
            return
        span = self.groups.row_slice(indices.shape[1])
        rows = Rows(sched.indices.shape[1], span.start, span.stop)
        for i in range(len(indices)):
            yield self.gather(indices[i])[span], masks[i, span], rows


def fit_sharded(model, train_dataset: BowDataset, groups: DpMpGroups,
                validation_dataset: BowDataset | None = None, save_dir: str | None = None,
                patience: int = 5, delta: float = 0.0, n_samples: int = 20,
                device: str | torch.device | None = None) -> nn.Module:
    """Train ``model`` (an AVITM built alike on every rank) for its
    ``num_epochs`` on the ``dp x mp`` layout ``groups``
    (``gfedntm_tpu/parallel/sharded.py:114-250``): batch rows split over
    the data group, the V axis over the model group.

    Runs ``model.fit``'s own epoch loop (``AVITM._run_epochs``) on the
    rank-local network, so it matches ``model.fit(train_dataset,
    validation_dataset, save_dir, patience, delta)`` epoch for epoch up to
    float reduction order: the same schedules, validation epochs,
    :class:`~gfedntm_tpu_torch.train.early_stopping.EarlyStopping`, plateau
    scheduler and NaN abort. With more than one rank the fused loss runs
    through K5 (``:160-171``): its rows-sharded branch in training when
    dp > 1, its forward in eval mode for the validation loss. The unfused
    prodLDA and LDA decodes run at any ``dp x mp``: with mp > 1 on the
    rank's columns, their softmax over V merged over the model group, in
    training and validation alike, with no kernel. Every validation loss is
    checked to be equal on every rank of the world, so every rank takes the
    same early-stopping and scheduler decisions. An improvement saves into
    ``save_dir``: every rank gathers the state (a collective), world rank 0
    writes ``epoch_{n}.npz`` and ``.json``, and the world waits at a
    barrier. As in the JAX package, a run without a validation set saves
    nothing.

    On exit ``model`` holds the gathered full network and optimizer state,
    and, as after ``model.fit``, ``best_components`` and
    ``training_doc_topic_distributions`` (``n_samples`` draws), equal on
    every rank; the rank-local network is returned.

    ``device`` (``None``: the GPU) must be the model's device."""
    if getattr(model, "family", None) != "avitm":
        raise NotImplementedError("fit_sharded: CTM is a later slice (ROADMAP queue 1, CTM)")
    _check_device(model, device, "fit_sharded")
    return _fit_on_ranks(model, train_dataset, groups, validation_dataset, save_dir, patience,
                         delta, n_samples, vshard_of(groups))


def fit_data_sharded(model, train_dataset: BowDataset, groups: DpMpGroups,
                     validation_dataset: BowDataset | None = None, metrics=None,
                     save_dir: str | None = None, patience: int = 5, delta: float = 0.0,
                     n_samples: int = 20,
                     device: str | torch.device | None = None) -> dict:
    """Data-parallel training of one model over the ``dp`` ranks of
    ``groups`` (mp = 1): the path a federation client runs its local corpus
    on (``gfedntm_tpu/parallel/sharded.py:281-554``).

    The corpus is split by documents over the ranks (:class:`DocShard`),
    the state is replicated, each step's batch is padded with masked rows
    to a multiple of dp (``pad_batch_axis``) and split over the ranks; the
    BatchNorm statistics are the whole batch's and every gradient is summed
    over the ranks, so the run is ``model.fit``'s up to float reduction
    order. Validation, early stopping, saves and the scheduler behave as in
    :func:`fit_sharded`. The model must be built with
    ``fused_decoder=False``, as in the JAX package: the fused loss takes
    :func:`fit_sharded`.

    ``groups`` takes the place of the JAX ``mesh``/``n_devices``; ``donate``
    and ``peak_flops_per_device`` have no PyTorch meaning and are not taken.
    Telemetry through ``metrics`` (a
    :class:`~gfedntm_tpu_torch.utils.observability.MetricsLogger`): a
    ``phase`` event per epoch (``phase="sharded_epoch"``, the training
    steps' wall seconds, synced), the gauges ``sharded_devices``,
    ``sharded_docs_per_s`` and ``sharded_docs_per_s_per_device``, and one
    ``sharded_fit`` event.

    Returns the JAX summary's keys. Steady time excludes the first epoch,
    as there. ``compile_s``, ``flops_per_step``, ``flops_per_epoch``,
    ``mfu`` and ``peak_flops_source`` are ``None``: eager PyTorch compiles
    no program, and the FLOP count waits on a port of ``utils/flops.py``
    (ROADMAP queue 1). The trained state is left on ``model``, as after
    :func:`fit_sharded`."""
    if getattr(model, "family", None) != "avitm":
        raise NotImplementedError("fit_data_sharded: CTM is a later slice (ROADMAP queue 1, CTM)")
    if model.fused_decoder:
        raise ValueError(
            "fit_data_sharded runs the unfused loss; the fused decoder composes with "
            "layouts via fit_sharded's V-sharded path instead (build the model with "
            "fused_decoder=False)")
    if groups.mp != 1:
        raise ValueError(f"fit_data_sharded is data parallel only: mp must be 1, got {groups.mp}"
                         " (fit_sharded splits the vocabulary)")
    _check_device(model, device, "fit_data_sharded")
    n_dev = groups.dp
    if metrics is not None:
        metrics.registry.gauge("sharded_devices").set(float(n_dev))
    epoch_s: list[float] = []

    def on_epoch(epoch: int, seconds: float) -> None:
        epoch_s.append(seconds)
        if metrics is not None:
            metrics.log("phase", phase="sharded_epoch", seconds=seconds, epoch=epoch)

    _fit_on_ranks(model, train_dataset, groups, validation_dataset, save_dir, patience, delta,
                  n_samples, None, on_epoch)
    n_train = len(train_dataset)
    steady_s = sum(epoch_s[1:], 0.0)  # epoch 0 holds the warm-up
    per_epoch_s = steady_s / (len(epoch_s) - 1) if len(epoch_s) > 1 else None
    docs_per_s = n_train / per_epoch_s if per_epoch_s else None
    summary = {
        "devices": n_dev,
        "epochs_run": len(model.epoch_losses),
        "compile_s": None,
        "steady_s": round(steady_s, 3),
        "docs_per_s": round(docs_per_s, 1) if docs_per_s else None,
        "docs_per_s_per_device": round(docs_per_s / n_dev, 1) if docs_per_s else None,
        "flops_per_step": None,
        "steps_per_epoch": max(1, -(-n_train // model.batch_size)),
        "flops_per_epoch": None,
        "mfu": None,
        "peak_flops_source": None,
        "batch_pad": pad_to_multiple(model.batch_size, n_dev),
    }
    if metrics is not None:
        if docs_per_s:
            metrics.registry.gauge("sharded_docs_per_s").set(docs_per_s)
            metrics.registry.gauge("sharded_docs_per_s_per_device").set(docs_per_s / n_dev)
        metrics.log("sharded_fit", devices=n_dev, docs_per_s=summary["docs_per_s"],
                    mfu=summary["mfu"], compile_s=summary["compile_s"])
    return summary


def vshard_of(groups: DpMpGroups) -> DpMpGroups | None:
    """The ``vshard`` argument of a step on this layout: ``None`` on one
    rank, else the layout."""
    return groups if groups.dp * groups.mp > 1 else None


def _check_device(model, device, caller: str) -> None:
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"{caller}: device {dev} is not the model's {model.device}")


def _fit_on_ranks(model, train_dataset, groups, validation_dataset, save_dir, patience, delta,
                  n_samples, vshard, on_epoch=None) -> nn.Module:
    """The epoch loop of both fits on this rank's network, corpus blocks and
    optimizer shard, then the gather back into ``model``."""
    vocab = model.input_size
    names = [name for name, _ in model.model.named_parameters()]
    net = local_network(model.model, groups)
    optimizer = model.build_optimizer(net)
    cols = groups.v_slice(vocab)
    optimizer.load_state_dict(_map_optimizer_state(
        model.optimizer.state_dict(), names, lambda t, dim: _columns(t, dim, cols)))
    corpus = DocShard.place(train_dataset.X, groups, model._device_data)
    val_corpus = None
    checkpoint_fn = None
    if validation_dataset is not None:
        val_corpus = DocShard.place(validation_dataset.X, groups, model._device_data)
        if save_dir:
            def checkpoint_fn():
                save_gathered(model, net, groups, save_dir)
    model._run_epochs(net, optimizer, train_dataset, corpus, validation_dataset, val_corpus,
                      checkpoint_fn, patience, delta, vshard=vshard, on_epoch=on_epoch)

    model.model.load_state_dict(gather_state_dict(net.state_dict(), groups))
    model.optimizer = model.build_optimizer(model.model)
    model.optimizer.load_state_dict(_map_optimizer_state(
        optimizer.state_dict(), names, lambda t, dim: _gather_columns(t, dim, groups)))
    model._finish_fit(train_dataset, n_samples)
    return net


def save_gathered(model, net: nn.Module, groups: DpMpGroups, save_dir: str) -> None:
    """``model.save(save_dir)`` of the full state gathered from the rank-local
    ``net``s: a collective, so every rank calls it; world rank 0 writes, and
    every rank waits until it has."""
    full = gather_state_dict(net.state_dict(), groups)
    if groups.is_root:
        model._write(save_dir, full)
    if groups.world_group is not None:
        dist.barrier(group=groups.world_group)
