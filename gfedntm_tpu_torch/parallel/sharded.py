"""Sharded AVITM and CTM training (prodLDA, fused or not, and LDA): data
parallel, V-sharded (model parallel), or both on a ``dp x mp`` layout.

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
- the BoW encoder's input layer, ``inf_net.input_layer.weight`` [H, V] in
  torch's layout (the JAX kernel is [V, H]), on dim 1 — :class:`VShardedLinear`
  sums the ranks' ``x_m W_m^T`` and adds the bias once;
- CombinedTM's ``inf_net.adapt_bert`` (weight [V, 768], bias [V]) on dim 0,
  as the JAX package shards its kernel's V axis: each rank projects the
  contextual embedding onto its own columns, and the gradient stays local;
- CombinedTM's input layer [H, 2V + L] on both V-wide column blocks (the
  BoW and the ``adapt_bert`` columns): :class:`VShardedLinear` sums the
  ranks' products of their two blocks and adds the label columns' product
  and the bias once. The JAX package keeps this kernel replicated and lets
  GSPMD gather the [B, V] ``adapt_bert`` activation (``sharded.py:131-133``);
  the split computes the same function without that gather. ZeroShotTM's
  input layer [H, 768 + L] is not V-wide and stays replicated
  (:data:`SPLITS`);
- ``beta_batchnorm.running_mean`` / ``running_var`` [V] on dim 0: per
  column, so local to the model rank (prodLDA's take the batch statistics
  of z = theta beta and sync over the data group; LDA's normalize the
  replicated beta over its topic rows and stay local);
- each rank holds only its columns of the BoW corpus, and every column of
  the contextual embeddings and labels (which split over ``data`` only, as
  the JAX package's ``shard_data`` places them).

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

A CTM's label cross-entropy is a mean over the whole batch's real rows: each
data rank divides its rows' sum by that count (``train/steps.py``).
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
from gfedntm_tpu_torch.models.layers import Linear, MaskedBatchNorm, Rows
from gfedntm_tpu_torch.parallel.collectives import (
    gather_by_sum,
    sum_forward_identity_backward,
)
from gfedntm_tpu_torch.parallel.mesh import DpMpGroups, pad_to_multiple
from gfedntm_tpu_torch.train.steps import pad_batch_axis, take
from gfedntm_tpu_torch.utils.flops import mfu as compute_mfu
from gfedntm_tpu_torch.utils.flops import resolve_peak_flops_per_device

_DECODER_SPLIT = {
    "beta": (1, 1),
    "beta_batchnorm.running_mean": (0, 1),
    "beta_batchnorm.running_var": (0, 1),
}
#: Per encoder (``inference_type``), the state-dict keys split on V:
#: ``name -> (dim, blocks)``. Along ``dim`` the leaf starts with ``blocks``
#: V-wide blocks, each split over the model group into the rank's columns;
#: whatever follows them (CombinedTM's label columns) is replicated.
SPLITS = {
    "bow": {**_DECODER_SPLIT, "inf_net.input_layer.weight": (1, 1)},
    "zeroshot": dict(_DECODER_SPLIT),
    "combined": {**_DECODER_SPLIT, "inf_net.input_layer.weight": (1, 2),
                 "inf_net.adapt_bert.weight": (0, 1), "inf_net.adapt_bert.bias": (0, 1)},
}


def _split_of(name: str, shape, vocab_size: int, inference_type: str):
    """``(dim, blocks)`` of ``name`` split over the model group, or ``None``
    when the leaf is replicated (``_leaf_spec`` in torch's layouts)."""
    split = SPLITS[inference_type].get(name)
    if split is not None and tuple(shape)[split[0]] < split[1] * vocab_size:
        raise ValueError(f"{name} {tuple(shape)}: dim {split[0]} does not hold {split[1]} "
                         f"vocabulary blocks ({vocab_size})")
    return split


def _columns(t: torch.Tensor, split, vocab: int, cols: slice) -> torch.Tensor:
    """This rank's part of ``t``: its ``cols`` of each V-wide block along the
    split's dim, then the replicated rest."""
    dim, blocks = split
    parts = [t.narrow(dim, b * vocab + cols.start, cols.stop - cols.start)
             for b in range(blocks)]
    parts.append(t.narrow(dim, blocks * vocab, t.shape[dim] - blocks * vocab))
    return torch.cat(parts, dim=dim).clone()


def _gather_columns(t: torch.Tensor, split, width: int, groups: DpMpGroups) -> torch.Tensor:
    """Inverse of :func:`_columns` over the model group (a collective):
    ``width`` is the rank's vocabulary columns, V/mp."""
    dim, blocks = split
    parts = [torch.cat(list(gather_by_sum(t.narrow(dim, b * width, width).contiguous(),
                                          groups.model_group)), dim=dim)
             for b in range(blocks)]
    parts.append(t.narrow(dim, blocks * width, t.shape[dim] - blocks * width))
    return torch.cat(parts, dim=dim)


def shard_state_dict(full, groups: DpMpGroups, inference_type: str) -> dict:
    """This rank's slice of a full state dict of a network with the
    ``inference_type`` encoder."""
    vocab = full["beta"].shape[1]
    cols = groups.v_slice(vocab)
    out = {}
    for name, t in full.items():
        split = _split_of(name, t.shape, vocab, inference_type)
        out[name] = t if split is None else _columns(t, split, vocab, cols)
    return out


def gather_state_dict(local, groups: DpMpGroups, inference_type: str) -> dict:
    """The full state dict from every model rank's slice (a collective: every
    rank of the model group calls it with its own ``local``: a state dict,
    its parameters' gradients or its buffers)."""
    splits = SPLITS[inference_type]
    # The rank's vocabulary columns: the width of a leaf that is one V block.
    width = next(t.shape[dim] for name, t in local.items()
                 if name in splits for dim, blocks in [splits[name]] if blocks == 1)
    return {name: t if name not in splits else _gather_columns(t, splits[name], width, groups)
            for name, t in local.items()}


def _map_optimizer_state(state: dict, names: list[str], fn, inference_type: str) -> dict:
    """A copy of an optimizer state dict with ``fn(tensor, split)`` applied to
    the parameter-shaped slots (Adam's moments, Adagrad's sums) of the
    V-split parameters; ``names`` are the parameter names in the optimizer's
    order."""
    splits = SPLITS[inference_type]
    out = copy.deepcopy(state)
    for i, slot in out["state"].items():
        split = splits.get(names[i])
        for key, value in slot.items():
            if split is not None and torch.is_tensor(value) and value.dim() > 0:
                slot[key] = fn(value, split)
    return out


class VShardedLinear(nn.Module):
    """The encoder's input layer with its V columns split over the model
    group: ``h = sum_m x_m W_m^T + t T^T + b``. ``x_m`` are the rank's
    ``in_split`` columns of the input (CombinedTM's: its BoW columns, then
    its ``adapt_bert`` columns) and ``t`` the ``tail`` columns that follow
    them, which every rank holds whole (CombinedTM's labels). The tail's
    product and the bias are added once, after the sum, and the sum's
    backward is the identity (everything after it is replicated on every
    rank of the group), so each rank's weight gradient is ``dh^T x_m`` on
    its columns and the whole ``dh^T t`` on the tail's.

    Under a bf16 ``compute_dtype`` each rank's product takes the
    bf16-rounded x and W in float32 (exact products, float32 sums), the
    partials and the tail's product are summed in float32 and the sum is
    rounded to bf16 once before the bf16 bias: the unsharded bf16 layer
    (:class:`Linear`) rounds its float32-accumulated product once too, so
    the two differ only in the order of the sum."""

    def __init__(self, in_split: int, out_features: int, group,
                 compute_dtype: torch.dtype = torch.float32, tail: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_split + tail))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.group = group
        self.compute_dtype = compute_dtype
        self.in_split = in_split

    def forward(self, x_local: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        n = self.in_split
        x, w = x_local, self.weight
        if dt != torch.float32:
            x, w = x.to(dt).float(), w.to(dt).float()
        h = sum_forward_identity_backward(F.linear(x[:, :n], w[:, :n]), self.group)
        if w.shape[1] > n:
            h = h + F.linear(x[:, n:], w[:, n:])
        if dt == torch.float32:
            return h + self.bias
        return h.to(dt) + self.bias.to(dt)


def local_network(network: nn.Module, groups: DpMpGroups) -> nn.Module:
    """A copy of ``network`` for this rank: with mp > 1 it holds the rank's
    V shard (``beta`` and its BatchNorm over the local columns; a BoW or
    CombinedTM encoder's input layer as a :class:`VShardedLinear`, and
    CombinedTM's ``adapt_bert`` onto the local columns; ZeroShotTM's
    encoder whole), and with dp > 1 its BatchNorms sync over the data group
    (``set_data_group``: LDA's ``beta_batchnorm`` stays local). Parameter
    order is the full network's."""
    local = copy.deepcopy(network)
    if groups.mp > 1:
        kind = network.inference_type
        cols = groups.v_slice(network.beta.shape[1])
        width = cols.stop - cols.start
        device = network.beta.device
        dt = network.compute_dtype
        splits = SPLITS[kind]
        layer = network.inf_net.input_layer
        if "inf_net.input_layer.weight" in splits:
            blocks = splits["inf_net.input_layer.weight"][1]
            local.inf_net.input_layer = VShardedLinear(
                blocks * width, layer.out_features, groups.model_group, dt,
                tail=layer.in_features - blocks * network.beta.shape[1]).to(device)
        if "inf_net.adapt_bert.weight" in splits:
            local.inf_net.adapt_bert = Linear(network.inf_net.adapt_bert.in_features, width,
                                              dt).to(device)
        local.beta = nn.Parameter(torch.empty(network.beta.shape[0], width, device=device))
        local.beta_batchnorm = MaskedBatchNorm(width).to(device)
        local.load_state_dict(shard_state_dict(network.state_dict(), groups, kind))
    local.set_data_group(groups.data_group)
    return local


class DocShard:
    """A corpus as one rank holds it on the device: with ``groups``, the
    rank's data block of the documents (rows ``[start, start + n)`` of the
    corpus zero-padded to a multiple of dp; ``shard_docs``,
    ``gfedntm_tpu/parallel/sharded.py:253-278``) and its model group's
    columns of ``x_bow`` (the contextual embeddings and labels whole);
    without, the whole corpus. ``local`` is a dict of tensors keyed as a
    batch (``x_bow``, and for CTM ``x_ctx``, ``labels``).

    :meth:`steps` yields each step's batch as this rank takes it. With
    dp > 1 each rank writes the batch rows it owns into a zeroed
    [B_pad, width] buffer (every array side by side) and one ``all_reduce``
    sum over the data group gives every rank the whole batch exactly
    (adding zeros is exact); each keeps its own rows."""

    def __init__(self, local: dict, groups: DpMpGroups | None = None, start: int = 0):
        self.local = local
        self.groups = groups
        self.start = start
        self.dp = 1 if groups is None else groups.dp
        self.data_group = None if groups is None else groups.data_group

    @classmethod
    def place(cls, arrays: dict, groups: DpMpGroups, stage) -> "DocShard":
        """This rank's block of the corpus ``arrays`` (numpy, keyed as a
        batch, e.g. the model's ``_host_data``), each uploaded by ``stage``:
        only its documents, and of ``x_bow`` only its columns."""
        n_docs = len(arrays["x_bow"])
        per = pad_to_multiple(n_docs, groups.dp) // groups.dp
        start = groups.data_rank * per
        local = {}
        for key, X in arrays.items():
            cols = groups.v_slice(X.shape[1]) if key == "x_bow" else slice(None)
            block = X[start:start + per, cols]
            if block.shape[0] < per:
                block = np.concatenate([block, np.zeros((per - block.shape[0], block.shape[1]),
                                                        block.dtype)])
            local[key] = stage(np.ascontiguousarray(block))
        return cls(local, groups, start)

    def gather_bytes(self, batch_size: int) -> int:
        """Bytes of one step's batch buffer that the gather sums over the
        data group (0 without one)."""
        if self.data_group is None:
            return 0
        row = sum(t.shape[1] * t.element_size() for t in self.local.values())
        return pad_to_multiple(batch_size, self.dp) * row

    def gather(self, indices: torch.Tensor) -> dict:
        """The rows ``indices`` (corpus document ids) of the arrays this rank
        holds, on every rank of the data group."""
        local = list(self.local.values())
        n = local[0].shape[0]
        own = indices - self.start
        mine = (own >= 0) & (own < n)
        rows = torch.cat([t[own.clamp(0, n - 1)] for t in local], dim=1)
        buf = torch.where(mine[:, None], rows, 0.0)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.data_group)
        parts = buf.split([t.shape[1] for t in local], dim=1)
        return {key: part.contiguous() for key, part in zip(self.local, parts)}

    def batch(self, indices: torch.Tensor, mask: torch.Tensor, full: int):
        """``(batch, mask, rows)`` of one step: ``indices`` and ``mask`` are
        the step's whole batch, padded to a multiple of dp, of which the
        first ``full`` rows are the schedule's; the rank's rows of the
        batch, their mask and their
        :class:`~gfedntm_tpu_torch.models.layers.Rows` (``None`` with one
        data rank)."""
        if self.data_group is None:
            return take(self.local, indices), mask, None
        span = self.groups.row_slice(indices.shape[0])
        batch = self.gather(indices)
        return ({key: t[span] for key, t in batch.items()}, mask[span],
                Rows(full, span.start, span.stop))

    def steps(self, sched):
        """:meth:`batch` of each step of the epoch schedule ``sched``, its
        batch axis padded with masked rows to a multiple of dp
        (``pad_batch_axis``)."""
        indices, masks = pad_batch_axis(sched.indices, sched.mask, self.dp)
        device = self.local["x_bow"].device
        indices = torch.as_tensor(indices, device=device, dtype=torch.long)
        masks = torch.as_tensor(masks, device=device, dtype=torch.float32)
        for i in range(len(indices)):
            yield self.batch(indices[i], masks[i], sched.indices.shape[1])


def fit_sharded(model, train_dataset: BowDataset, groups: DpMpGroups,
                validation_dataset: BowDataset | None = None, save_dir: str | None = None,
                patience: int = 5, delta: float = 0.0, n_samples: int = 20,
                device: str | torch.device | None = None) -> nn.Module:
    """Train ``model`` (an AVITM or a CTM built alike on every rank) for its
    ``num_epochs`` on the ``dp x mp`` layout ``groups``
    (``gfedntm_tpu/parallel/sharded.py:114-250``): batch rows split over
    the data group, the V axis over the model group (a CTM's contextual
    embeddings and labels split over the data group only).

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
    as there. ``compile_s`` is ``None``: eager PyTorch compiles no program.
    ``flops_per_step`` is the model FLOPs of one step of the whole batch
    over all ranks (:meth:`AVITM.step_flops`, counted once before the
    fit), ``flops_per_epoch`` that times ``steps_per_epoch``, and ``mfu``
    the steady epoch's FLOP/s per rank over ``peak_flops_source``'s peak
    (:mod:`gfedntm_tpu_torch.utils.flops`; ``None`` with a single epoch);
    an ``mfu`` also sets the ``sharded_mfu`` gauge. The trained state is
    left on ``model``, as after :func:`fit_sharded`."""
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
    n_train = len(train_dataset)
    steps_per_epoch = max(1, -(-n_train // model.batch_size))
    flops_per_step = model.step_flops(train_dataset)
    flops_per_epoch = flops_per_step * steps_per_epoch
    peak, peak_source = resolve_peak_flops_per_device(model.device)
    if metrics is not None:
        metrics.registry.gauge("sharded_devices").set(float(n_dev))
    epoch_s: list[float] = []

    def on_epoch(epoch: int, seconds: float) -> None:
        epoch_s.append(seconds)
        if metrics is not None:
            metrics.log("phase", phase="sharded_epoch", seconds=seconds, epoch=epoch)

    _fit_on_ranks(model, train_dataset, groups, validation_dataset, save_dir, patience, delta,
                  n_samples, None, on_epoch)
    steady_s = sum(epoch_s[1:], 0.0)  # epoch 0 holds the warm-up
    per_epoch_s = steady_s / (len(epoch_s) - 1) if len(epoch_s) > 1 else None
    docs_per_s = n_train / per_epoch_s if per_epoch_s else None
    mfu_val = compute_mfu(flops_per_epoch, per_epoch_s or 0.0, n_dev, peak)
    summary = {
        "devices": n_dev,
        "epochs_run": len(model.epoch_losses),
        "compile_s": None,
        "steady_s": round(steady_s, 3),
        "docs_per_s": round(docs_per_s, 1) if docs_per_s else None,
        "docs_per_s_per_device": round(docs_per_s / n_dev, 1) if docs_per_s else None,
        "flops_per_step": flops_per_step,
        "steps_per_epoch": steps_per_epoch,
        "flops_per_epoch": flops_per_epoch,
        "mfu": round(mfu_val, 6) if mfu_val is not None else None,
        "peak_flops_source": peak_source,
        "batch_pad": pad_to_multiple(model.batch_size, n_dev),
    }
    if metrics is not None:
        if docs_per_s:
            metrics.registry.gauge("sharded_docs_per_s").set(docs_per_s)
            metrics.registry.gauge("sharded_docs_per_s_per_device").set(docs_per_s / n_dev)
        if mfu_val is not None:
            metrics.registry.gauge("sharded_mfu").set(mfu_val)
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
    kind = model.inference_type
    names = [name for name, _ in model.model.named_parameters()]
    net = local_network(model.model, groups)
    optimizer = model.build_optimizer(net)
    cols = groups.v_slice(vocab)
    optimizer.load_state_dict(_map_optimizer_state(
        model.optimizer.state_dict(), names,
        lambda t, split: _columns(t, split, vocab, cols), kind))

    def stage(a):
        return torch.as_tensor(a, device=model.device)

    corpus = DocShard.place(model._host_data(train_dataset), groups, stage)
    val_corpus = None
    checkpoint_fn = None
    if validation_dataset is not None:
        val_corpus = DocShard.place(model._host_data(validation_dataset), groups, stage)
        if save_dir:
            def checkpoint_fn():
                save_gathered(model, net, groups, save_dir)
    model._run_epochs(net, optimizer, train_dataset, corpus, validation_dataset, val_corpus,
                      checkpoint_fn, patience, delta, vshard=vshard, on_epoch=on_epoch)

    model.model.load_state_dict(gather_state_dict(net.state_dict(), groups, kind))
    model.optimizer = model.build_optimizer(model.model)
    width = cols.stop - cols.start
    model.optimizer.load_state_dict(_map_optimizer_state(
        optimizer.state_dict(), names,
        lambda t, split: _gather_columns(t, split, width, groups), kind))
    model._finish_fit(train_dataset, n_samples)
    return net


def save_gathered(model, net: nn.Module, groups: DpMpGroups, save_dir: str) -> None:
    """``model.save(save_dir)`` of the full state gathered from the rank-local
    ``net``s: a collective, so every rank calls it; world rank 0 writes, and
    every rank waits until it has."""
    full = gather_state_dict(net.state_dict(), groups, model.inference_type)
    if groups.is_root:
        model._write(save_dir, full)
    if groups.world_group is not None:
        dist.barrier(group=groups.world_group)
