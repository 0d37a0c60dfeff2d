"""Deterministic reductions over a process group, built from ``all_reduce``.

Gloo takes CUDA tensors only in ``all_reduce`` and ``broadcast``, so every
collective here is an ``all_reduce`` with SUM, and one code path serves gloo
and NCCL alike.

- **Gather by sum** (:func:`gather_by_sum`): each rank writes its partial
  into its own row of a zeroed ``[n, ...]`` buffer and the buffer is summed.
  Adding zeros is exact, so every rank holds every partial bit for bit,
  ``-1e30`` softmax sentinels included.
- **Fold in rank order**: reductions of the gathered partials
  (:func:`sum_in_rank_order`, :func:`merge_softmax`) run in group-rank
  order on every rank, so their results are bitwise equal on every rank
  whatever the backend's own reduction order.
- **Sum forward, identity backward** (:func:`sum_forward_identity_backward`):
  the autograd convention of a sum whose consumers are replicated on every
  rank of the group. Each rank's gradient of the sum is already the whole
  gradient, so the backward passes it through.
  ``torch.distributed.nn.functional.all_reduce`` all-reduces the gradient
  instead, which would scale the inputs' gradients by the group size.
- **Sum forward, sum backward** (:func:`sum_forward_sum_backward`): a sum
  whose consumers differ on every rank, as the data group's BatchNorm
  statistics feed each rank's own rows. The gradient of each rank's
  partial is then the sum of every rank's gradient of the sum, folded in
  rank order too, as SyncBatchNorm's backward does.
- **Identity forward, sum backward** (:func:`identity_forward_sum_backward`):
  a value replicated on every rank of the group (theta over the model
  group) that each rank then uses on its own part of the work (its
  vocabulary columns). Each rank's gradient is the part that flows
  through its own columns, so the backward sums them.
- **Softmax over the group** (:func:`softmax_over_group`): a row softmax
  whose columns are split over the group, from the rows' maximum and
  their summed exponentials over the group; its backward sums the rows'
  dots over the group.

A group of ``None`` is a group of one rank: gathering returns the partial
alone. A group is any process group: one of the default group's
(``new_group``), or one a node builds on a store of its own
(``ProcessGroupGloo(store, rank, size)``, a mesh client's), which the
default group's rank tables do not know: ranks and sizes are the group's
own.

:func:`check_equal_across` raises unless a host value (a validation loss
that decides early stopping) is the same on every rank of a group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def gather_by_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``[n, *t.shape]``: row i holds group rank i's ``t`` on every rank."""
    if group is None:
        return t.unsqueeze(0)
    buf = t.new_zeros((group.size(), *t.shape))
    buf[group.rank()] = t
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


def sum_in_rank_order(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of every rank's ``t``, added in group-rank order."""
    parts = gather_by_sum(t, group)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def merge_softmax(m_loc: torch.Tensor, s_loc: torch.Tensor, group):
    """Online-softmax merge of per-shard row maxima and denominators:
    ``m = max_i m_i``, ``l = sum_i s_i * exp(min(m_i - m, 0))``
    (``gfedntm_tpu/ops/fused_decoder.py:898-901``). A row fully masked on
    every shard keeps ``(-1e30, 0)``."""
    parts = gather_by_sum(torch.stack([m_loc, s_loc]), group)
    m = parts[:, 0].amax(dim=0)
    l = parts[0, 1] * torch.exp(torch.clamp_max(parts[0, 0] - m, 0.0))
    for part in parts[1:]:
        l = l + part[1] * torch.exp(torch.clamp_max(part[0] - m, 0.0))
    return m.contiguous(), l.contiguous()


class _SumIdentityGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return sum_in_rank_order(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_forward_identity_backward(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of every rank's ``t`` whose backward is the identity."""
    return _SumIdentityGrad.apply(t, group)


class _SumSumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return sum_in_rank_order(t, group)

    @staticmethod
    def backward(ctx, grad):
        return sum_in_rank_order(grad.contiguous(), ctx.group), None


def sum_forward_sum_backward(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of every rank's ``t`` whose backward sums the gradient over the
    group: each rank's loss reaches every rank's partial."""
    return _SumSumGrad.apply(t, group)


class _IdentitySumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return sum_in_rank_order(grad.contiguous(), ctx.group), None


def identity_forward_sum_backward(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself, whose backward sums the gradient over the group: each
    rank's loss reaches ``t`` through that rank's part of the work only."""
    return _IdentitySumGrad.apply(t, group)


class _SoftmaxOverGroup(torch.autograd.Function):
    """``torch.softmax``'s arithmetic over a row split on the group: the
    forward in float32 rounded once to the input's dtype; the backward
    ``y * (g - c)`` from the rounded output ``y``, in float32, with
    ``c = sum_v g y`` the rows' dot over every rank's columns."""

    @staticmethod
    def forward(ctx, z, group):
        zf = z.float()
        m = gather_by_sum(zf.amax(dim=1), group).amax(dim=0)
        e = torch.exp(zf - m[:, None])
        y = (e / sum_in_rank_order(e.sum(dim=1), group)[:, None]).to(z.dtype)
        ctx.group = group
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        y, = ctx.saved_tensors
        yf, gf = y.float(), grad.float()
        c = sum_in_rank_order((gf * yf).sum(dim=1), ctx.group)
        return (yf * (gf - c[:, None])).to(grad.dtype), None


def softmax_over_group(z: torch.Tensor, group) -> torch.Tensor:
    """``softmax(z, dim=1)`` of the rows of ``z`` whose columns are split
    over ``group`` (each rank holds its own): ``exp(z - M) / S`` with ``M``
    the row maximum over the group and ``S`` the row sum of ``exp(z - M)``
    over the group. ``M`` is a constant shift. ``S`` feeds every rank's
    columns, so its sum is sum forward, sum backward: the backward sums the
    rows' dots ``sum_v g y`` over the group. The arithmetic is
    ``torch.softmax``'s for a bf16 input too (float32 inside, one rounding;
    the backward from the rounded output), so a sharded bf16 decode differs
    from the unsharded one by the sums' order only. A group of ``None`` is
    ``torch.softmax`` itself."""
    if group is None:
        return torch.softmax(z, dim=1)
    return _SoftmaxOverGroup.apply(z, group)


def check_equal_across(value: float, group, device: torch.device, what: str) -> None:
    """Raise unless ``value`` is bitwise the same float on every rank of
    ``group`` (NaN equals NaN). Pass ``DpMpGroups.world_group`` to check
    every rank."""
    seen = gather_by_sum(torch.tensor([value], dtype=torch.float64, device=device),
                         group).flatten().tolist()
    same = [v == value or (v != v and value != value) for v in seen]
    if not all(same):
        raise RuntimeError(f"{what} differs across the group's ranks: {seen}")
