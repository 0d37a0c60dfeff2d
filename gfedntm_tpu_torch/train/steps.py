"""One training step: forward, loss, backward, optimizer update.

Counterpart of ``gfedntm_tpu/train/steps.py:142-320``: ``batch_loss`` is
``_batch_loss`` (the unfused decode), ``fused_batch_loss`` is
``_fused_batch_loss`` (the decode + reconstruction loss through the fused
kernels, with the decoder BatchNorm's running stats updated from the
kernels' batch statistics), ``grad_step`` is ``grad_step`` and
``eval_epoch`` is ``build_eval_epoch`` (:449-474, the validation epoch over
``_batch_loss(train=False)``, :250-302). PyTorch runs eagerly, so there is
no epoch program: training callers loop over steps.

A batch is a dict, as in the JAX package: ``x_bow`` [B, V] and, for CTM,
``x_ctx`` [B, contextual_size] and (optionally) one-hot ``labels`` [B, L]
(:func:`take` gathers one from a staged corpus). The fused decode reads
``x_bow`` for every family, ZeroShotTM's too, whose encoder ignores it.
``beta_weight`` weighs the KL (CTM's ``loss_weights["beta"]``; 1 for
AVITM, where ``1.0 * KL`` is the KL bit for bit), and when the network
returns label logits the loss adds their cross-entropy, a mean over the
whole batch's real rows (``_fused_batch_loss``/``_batch_loss``'s CTM
branch, ``:220-238``, ``:286-305``).

``noise=`` passes a fixed reparameterization eps through to the network, as
the JAX network's ``noise=`` does; ``generator`` draws it (and dropout)
otherwise.

``vshard=groups`` (a :class:`~gfedntm_tpu_torch.parallel.mesh.DpMpGroups`)
runs the step on a rank-local V-sharded network
(:func:`~gfedntm_tpu_torch.parallel.sharded.local_network`): the fused loss
goes through K5, ``prodlda_recon_loss_vsharded`` (``train/steps.py:186-220``),
on the rank's columns of x, and its validation loss through K5's forward
in eval mode (:func:`eval_loss`); the unfused prodLDA and the LDA decodes
run on the rank's columns with their softmax merged over the model group
(``DecoderNetwork.forward``'s ``model_group``), in training and in eval,
and the reconstruction term is summed over the model group
(:func:`batch_loss`).

A bf16-compute network (``compute_dtype=torch.bfloat16``) stores beta and x
in bf16 for the fused kernels (``_fused_batch_loss``, ``:176-180``);
:func:`check_bf16_bow_counts` is the one-time screen of a corpus for counts
bf16 cannot hold exactly.

Data parallelism (``data_group``, with ``rows`` the
:class:`~gfedntm_tpu_torch.models.layers.Rows` of the whole batch that ``x``
holds): each rank takes the loss of its rows, with the BatchNorm statistics
of the whole batch (the network's data group, ``set_data_group``) and every
draw at the whole batch's shape; after the backward every gradient is
summed over the data group (:func:`sum_gradients`), so each rank steps its
optimizer on the whole batch's gradient, as the JAX package's GSPMD program
does (``:65-88``, ``:110-127``). The label cross-entropy divides by the
whole batch's count of real rows. The step's loss is the sum of the ranks'.
"""

from __future__ import annotations

import numpy as np
import torch

from gfedntm_tpu_torch.models.layers import batch_count
from gfedntm_tpu_torch.models.losses import (
    elbo_sum,
    gaussian_kl,
    reconstruction_loss,
)
from gfedntm_tpu_torch.models.networks import DecoderNetwork
from gfedntm_tpu_torch.ops.fused_decoder import (
    prodlda_recon_loss,
    prodlda_recon_loss_vsharded,
)
from gfedntm_tpu_torch.parallel.collectives import (
    sum_forward_identity_backward,
    sum_in_rank_order,
)
from gfedntm_tpu_torch.parallel.mesh import pad_to_multiple


#: bfloat16 has an 8-bit significand: integers are exactly representable
#: only up to 2**8 = 256. BoW term counts above that are rounded when x rides
#: the fused kernels' bf16 storage.
BF16_EXACT_COUNT_MAX = 256.0


def check_bf16_bow_counts(x_bow, logger=None) -> bool:
    """Copy of ``gfedntm_tpu/train/steps.py:check_bf16_bow_counts``
    (:35-58): True (and a loud warning through ``logger``) when ``x_bow``
    holds counts that bf16 storage cannot represent exactly, i.e.
    ``max > 256``. Called once per corpus, where the corpus is staged to the
    device."""
    x_max = float(np.max(x_bow)) if np.size(x_bow) else 0.0
    if x_max <= BF16_EXACT_COUNT_MAX:
        return False
    if logger is not None:
        logger.warning(
            "compute_dtype='bfloat16' with BoW counts up to %.0f: bf16 "
            "represents integers exactly only up to %.0f, so the most "
            "frequent terms of long documents will be silently quantized "
            "in the fused reconstruction loss. Use compute_dtype='float32'"
            " (or cap counts in preprocessing) if exact counts matter.",
            x_max, BF16_EXACT_COUNT_MAX,
        )
    return True


def pad_batch_axis(indices, mask, multiple: int):
    """Copy of ``gfedntm_tpu/train/steps.py:pad_batch_axis`` (:91-119):
    an ``[S, B]`` epoch schedule with its batch axis padded up to a multiple
    of ``multiple`` with masked rows on doc 0 (a real row, so every gather
    stays in bounds); the first ``B`` rows of every step are unchanged."""
    b = int(indices.shape[1])
    b_pad = pad_to_multiple(b, multiple)
    if b_pad == b:
        return indices, mask
    s = indices.shape[0]
    idx_out = np.zeros((s, b_pad), dtype=indices.dtype)
    idx_out[:, :b] = indices
    mask_out = np.zeros((s, b_pad), dtype=mask.dtype)
    mask_out[:, :b] = mask
    return idx_out, mask_out


def take(data: dict, idx) -> dict:
    """The rows ``idx`` of every array of a staged corpus (a batch)."""
    return {key: value[idx] for key, value in data.items()}


def _inputs(batch: dict) -> tuple:
    """The network's positional inputs of a batch: x_bow, x_ctx, labels."""
    return batch["x_bow"], batch.get("x_ctx"), batch.get("labels")


def _elbo(out, rl, m, beta_weight: float, batch: dict, data_group) -> torch.Tensor:
    """The masked batch sum of ``beta_weight * KL + RL``, plus the label
    cross-entropy when the network returned label logits."""
    kl = gaussian_kl(
        out.prior_mean, out.prior_variance, out.posterior_mean,
        out.posterior_variance, out.posterior_log_variance,
    )
    return elbo_sum(kl, rl, beta_weight, m, out.estimated_labels, batch.get("labels"),
                    data_group)


def sum_gradients(model: DecoderNetwork, data_group) -> None:
    """Replace every parameter's gradient by its sum over ``data_group``,
    added in rank order on one flattened buffer (one collective per step),
    so every rank holds the same gradients bit for bit."""
    if data_group is None:
        return
    params = list(model.parameters())
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    total = sum_in_rank_order(torch.cat([g.reshape(-1) for g in grads]), data_group)
    for p, part in zip(params, total.split([g.numel() for g in grads])):
        p.grad = part.view_as(p).clone()


def batch_loss(model: DecoderNetwork, batch: dict, mask, noise=None, generator=None,
               rows=None, vshard=None, bn_mask: bool = True, beta_weight: float = 1.0,
               data_group=None):
    """Forward + reference loss on one (padded, masked) batch. Masked rows
    contribute exact zeros; the network clamps log-variance, so every row's
    loss term is finite. ``bn_mask=False`` gives the decoder's BatchNorm no
    row mask, as the eval forward has none.

    Under ``vshard`` (a V-sharded rank: ``x_bow`` holds its columns) the
    decode spans the model group, and the reconstruction term of the rank's
    columns is summed over the group with an identity backward (every rank's
    loss is the same function of each rank's term); the KL and the label
    term are added once, outside that sum. Without it this is
    ``avitm_loss`` (``ctm_loss`` for a CTM network), bit for bit.
    ``data_group`` (or ``vshard``'s) counts the label term's real rows."""
    model_group = None if vshard is None else vshard.model_group
    if vshard is not None:
        data_group = vshard.data_group
    out = model(*_inputs(batch), mask=mask if bn_mask else None, noise=noise,
                generator=generator, rows=rows, model_group=model_group)
    rl = reconstruction_loss(batch["x_bow"], out.word_dist)
    if model_group is not None:
        rl = sum_forward_identity_backward(rl, model_group)
    return _elbo(out, rl, mask, beta_weight, batch, data_group)


def fused_batch_loss(model: DecoderNetwork, batch: dict, mask, noise=None, generator=None,
                     vshard=None, rows=None, beta_weight: float = 1.0, data_group=None):
    """Training loss through the fused decode + reconstruction kernels: the
    [B, V] word distribution never exists. The decoder BatchNorm's running
    stats are updated from the kernels' batch statistics with
    MaskedBatchNorm's semantics (momentum 0.1, unbiased running variance);
    under ``vshard`` each rank updates its own columns', and with a data
    group (``data_group`` or ``vshard``'s) the statistics, their count and
    the label term's count are the whole batch's."""
    if vshard is not None:
        data_group = vshard.data_group
    out = model.encode_theta(*_inputs(batch), mask=mask, noise=noise, generator=generator,
                             rows=rows)
    x = batch["x_bow"]
    m = mask.to(torch.float32)
    bn = model.beta_batchnorm
    storage = "bfloat16" if model.compute_dtype == torch.bfloat16 else "float32"
    if vshard is None:
        rl, b_mean, b_var = prodlda_recon_loss(
            out.theta, model.beta, x, bn.running_mean, bn.running_var, m, True,
            storage_dtype=storage,
        )
    else:
        rl, b_mean, b_var = prodlda_recon_loss_vsharded(
            out.theta, model.beta, x, bn.running_mean, bn.running_var, m,
            groups=vshard, training=True, storage_dtype=storage,
        )
    bn.update_running_stats(b_mean, b_var, batch_count(m, data_group))
    return _elbo(out, rl, m, beta_weight, batch, data_group)


def grad_step(model: DecoderNetwork, optimizer: torch.optim.Optimizer, batch: dict, mask,
              fused: bool, noise=None, generator=None, vshard=None, rows=None,
              data_group=None, beta_weight: float = 1.0) -> torch.Tensor:
    """One forward/backward/optimizer update in training mode; returns the
    batch loss (detached, on the model's device). ``fused`` selects the
    fused kernels for prodLDA; LDA always takes the unfused decode. Under
    ``vshard`` the fused loss runs through K5 and the unfused decodes merge
    their softmax over the model group (:func:`batch_loss`). With a
    ``data_group`` the gradients and the returned loss are summed over
    it."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    if fused and model.is_prodlda:
        loss = fused_batch_loss(model, batch, mask, noise, generator, vshard, rows,
                                beta_weight, data_group)
    else:
        loss = batch_loss(model, batch, mask, noise, generator, rows, vshard,
                          beta_weight=beta_weight, data_group=data_group)
    loss.backward()
    sum_gradients(model, data_group)
    optimizer.step()
    loss = loss.detach()
    return loss if data_group is None else sum_in_rank_order(loss, data_group)


@torch.no_grad()
def eval_loss(model: DecoderNetwork, batch: dict, mask, noise=None, generator=None,
              vshard=None, rows=None, fused: bool = True, beta_weight: float = 1.0,
              data_group=None) -> torch.Tensor:
    """Validation loss of one (padded, masked) batch in eval mode: running
    BatchNorm statistics, no dropout, a fresh reparameterization draw
    (``noise`` or ``generator``). The decode is the unfused one, even for a
    fused prodLDA network, with no BatchNorm mask and the loss masked by
    ``mask`` (``_batch_loss(train=False)``).

    Under ``vshard`` the softmax over V spans the model group. For a
    ``fused`` prodLDA network the decode + reconstruction loss run through
    K5's forward with ``training=False`` (:func:`prodlda_recon_loss_vsharded`:
    K1's running-statistics branch and K2 on the rank's columns, their
    softmax partials merged over the group), plus the KL (and the label
    term); the JAX package gets the same function from GSPMD on its unfused
    eval (``parallel/sharded.py:147-151``). Any other network runs the same
    merged plain decode as in training (:func:`batch_loss` with the model
    group), and launches no kernel. The caller sets eval mode
    (:func:`eval_epoch` does). ``rows`` as in :func:`grad_step`; the loss
    is this rank's rows'."""
    if vshard is None or not (fused and model.is_prodlda):
        return batch_loss(model, batch, mask, noise, generator, rows, vshard, bn_mask=False,
                          beta_weight=beta_weight, data_group=data_group)
    out = model.encode_theta(*_inputs(batch), mask=None, noise=noise, generator=generator,
                             rows=rows)
    m = mask.to(torch.float32)
    bn = model.beta_batchnorm
    storage = "bfloat16" if model.compute_dtype == torch.bfloat16 else "float32"
    rl, _, _ = prodlda_recon_loss_vsharded(
        out.theta, model.beta, batch["x_bow"], bn.running_mean, bn.running_var, m,
        groups=vshard, training=False, storage_dtype=storage,
    )
    return _elbo(out, rl, m, beta_weight, batch, vshard.data_group)


def eval_epoch(model: DecoderNetwork, data: dict, indices, masks, noise=None,
               generator=None, vshard=None, beta_weight: float = 1.0) -> torch.Tensor:
    """Per-step summed validation losses ([steps], on the model's device) of
    one validation schedule: ``indices`` and ``masks`` [steps, B] index the
    rows of the staged corpus ``data``. ``noise`` [steps, B, K] injects each
    step's reparameterization eps; otherwise ``generator`` draws them. The
    model's train/eval mode is restored afterwards."""
    return eval_steps(model, ((take(data, indices[i]), masks[i], None)
                              for i in range(len(indices))),
                      noise, generator, vshard, beta_weight=beta_weight)


def eval_steps(model: DecoderNetwork, steps, noise=None, generator=None, vshard=None,
               data_group=None, fused: bool = True, beta_weight: float = 1.0) -> torch.Tensor:
    """:func:`eval_epoch` over ``steps``, an iterable of ``(batch, mask,
    rows)`` (this rank's rows of each validation batch,
    :meth:`~gfedntm_tpu_torch.parallel.sharded.DocShard.steps`); with a
    ``data_group`` the per-step losses are summed over it. ``fused`` as in
    :func:`eval_loss`."""
    was_training = model.training
    model.eval()
    try:
        losses = torch.stack([
            eval_loss(model, batch, mask, None if noise is None else noise[i], generator,
                      vshard, rows, fused, beta_weight, data_group)
            for i, (batch, mask, rows) in enumerate(steps)
        ])
    finally:
        model.train(was_training)
    return losses if data_group is None else sum_in_rank_order(losses, data_group)
