"""V-sharded (model-parallel) ProdLDA training.

Counterpart of ``gfedntm_tpu/parallel/sharded.py`` (``_leaf_spec`` :51-62,
``shard_data`` :77-88, ``fit_sharded`` :114-250). Every V-sized axis is split
over the model group of a :class:`~gfedntm_tpu_torch.parallel.mesh.DpMpGroups`
layout:

- ``beta`` [K, V] on dim 1 — the fused loss runs on each rank's columns
  through K5 (:func:`~gfedntm_tpu_torch.ops.fused_decoder.prodlda_recon_loss_vsharded`);
- the encoder's input layer, ``inf_net.input_layer.weight`` [H, V] in torch's
  layout (the JAX kernel is [V, H]), on dim 1 — :class:`VShardedLinear` sums
  the ranks' ``x_m W_m^T`` and adds the bias once;
- ``beta_batchnorm.running_mean`` / ``running_var`` [V] on dim 0;
- each rank holds only its columns of the corpus.

Everything else is replicated, and stays bitwise equal on every rank of a
model group: each rank draws the same schedule from the model's numpy
generator and the same noise from its identically seeded torch generator,
and every reduction that feeds replicated state is folded in rank order.

A bf16-compute model (``compute_dtype="bfloat16"``) trains the same way:
its input layer sums the ranks' partial products in float32 and rounds once
(:class:`VShardedLinear`), and K5 reads the rank's beta and x in bf16.

With a validation set, each epoch's validation loss runs in eval mode on
the rank-local network: through K5's forward with ``training=False`` when
mp > 1 (the softmax over V spans the model group), the unfused decode when
mp = 1 (:func:`~gfedntm_tpu_torch.train.steps.eval_loss`). Early stopping
saves the gathered state from model rank 0 (:func:`fit_sharded`).

Later slices: the data-parallel half (dp > 1: the encoder's two BatchNorms
need statistics synced over the data group, and every gradient a SUM over
it), and CTM.
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
from gfedntm_tpu_torch.models.layers import MaskedBatchNorm
from gfedntm_tpu_torch.parallel.collectives import (
    gather_by_sum,
    sum_forward_identity_backward,
)
from gfedntm_tpu_torch.parallel.mesh import DpMpGroups

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
    """A copy of ``network`` holding this rank's V shard: a
    :class:`VShardedLinear` input layer, ``beta`` and its BatchNorm over
    the local columns. Parameter order is the full network's."""
    cols = groups.v_slice(network.beta.shape[1])
    width = cols.stop - cols.start
    local = copy.deepcopy(network)
    device = network.beta.device
    hidden = network.inf_net.input_layer.out_features
    local.inf_net.input_layer = VShardedLinear(width, hidden, groups.model_group,
                                               network.compute_dtype).to(device)
    local.beta = nn.Parameter(torch.empty(network.beta.shape[0], width, device=device))
    local.beta_batchnorm = MaskedBatchNorm(width).to(device)
    local.load_state_dict(shard_state_dict(network.state_dict(), groups))
    return local


def fit_sharded(model, train_dataset: BowDataset, groups: DpMpGroups,
                validation_dataset: BowDataset | None = None, save_dir: str | None = None,
                patience: int = 5, delta: float = 0.0, n_samples: int = 20,
                device: str | torch.device | None = None) -> nn.Module:
    """Train ``model`` (an AVITM built alike on every rank) for its
    ``num_epochs`` with its V axis split over ``groups``
    (``gfedntm_tpu/parallel/sharded.py:114-250``).

    Runs ``model.fit``'s own epoch loop (``AVITM._run_epochs``) on the
    rank-local network, so it matches ``model.fit(train_dataset,
    validation_dataset, save_dir, patience, delta)`` epoch for epoch up to
    float reduction order: the same schedules, validation epochs,
    :class:`~gfedntm_tpu_torch.train.early_stopping.EarlyStopping`, plateau
    scheduler and NaN abort. With more than one rank the fused loss runs
    through K5 (``:160-171``), so the model must be prodLDA with
    ``fused_decoder`` on, and so does the validation loss, in eval mode.
    Every validation loss is checked to be equal on every rank of the model
    group, so every rank takes the same early-stopping and scheduler
    decisions. An improvement saves into ``save_dir``: every rank gathers
    the state (a collective), model rank 0 writes ``epoch_{n}.npz`` and
    ``.json``, and the group waits at a barrier. As in the JAX package, a
    run without a validation set saves nothing.

    On exit ``model`` holds the gathered full network and optimizer state,
    and, as after ``model.fit``, ``best_components`` and
    ``training_doc_topic_distributions`` (``n_samples`` draws), equal on
    every rank; the rank-local network is returned.

    ``device`` (``None``: the GPU) must be the model's device."""
    if getattr(model, "family", None) != "avitm":
        raise NotImplementedError("fit_sharded: CTM is a later slice (ROADMAP queue 1, CTM)")
    if groups.dp > 1:
        raise NotImplementedError(
            "fit_sharded: dp > 1 needs the encoder BatchNorm statistics synced over the "
            "data group and every gradient summed over it (ROADMAP queue 1, fit_sharded "
            "beyond dp = 1)")
    vshard = groups if groups.mp > 1 else None
    if vshard is not None and not model.fused_decoder:
        raise NotImplementedError(
            "fit_sharded: with mp > 1 only prodLDA through the fused loss (K5) is "
            "ported; the unfused and LDA decodes are a later slice (ROADMAP queue 1, "
            "fit_sharded beyond dp = 1)")
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"fit_sharded: device {dev} is not the model's {model.device}")

    vocab = model.input_size
    names = [name for name, _ in model.model.named_parameters()]
    net = local_network(model.model, groups)
    optimizer = model.build_optimizer(net)
    cols = groups.v_slice(vocab)
    optimizer.load_state_dict(_map_optimizer_state(
        model.optimizer.state_dict(), names, lambda t, dim: _columns(t, dim, cols)))
    # shard_data (:77-88): this rank's columns of the corpus only.
    x_local = model._device_data(np.ascontiguousarray(train_dataset.X[:, cols]))
    x_val = None
    checkpoint_fn = None
    if validation_dataset is not None:
        x_val = model._device_data(np.ascontiguousarray(validation_dataset.X[:, cols]))
        if save_dir:
            def checkpoint_fn():
                save_gathered(model, net, groups, save_dir)
    model._run_epochs(net, optimizer, train_dataset, x_local, validation_dataset, x_val,
                      checkpoint_fn, patience, delta, vshard=vshard)

    model.model.load_state_dict(gather_state_dict(net.state_dict(), groups))
    model.optimizer = model.build_optimizer(model.model)
    model.optimizer.load_state_dict(_map_optimizer_state(
        optimizer.state_dict(), names, lambda t, dim: _gather_columns(t, dim, groups)))
    model._finish_fit(train_dataset, n_samples)
    return net


def save_gathered(model, net: nn.Module, groups: DpMpGroups, save_dir: str) -> None:
    """``model.save(save_dir)`` of the full state gathered from the rank-local
    ``net``s: a collective, so every rank of the model group calls it; model
    rank 0 writes, and the group waits until it has."""
    full = gather_state_dict(net.state_dict(), groups)
    if groups.model_rank == 0:
        model._write(save_dir, full)
    if groups.model_group is not None:
        dist.barrier(group=groups.model_group)
