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

A group of ``None`` is a group of one rank: gathering returns the partial
alone.

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
    buf = t.new_zeros((dist.get_world_size(group), *t.shape))
    buf[dist.get_rank(group)] = t
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


def check_equal_across(value: float, group, device: torch.device, what: str) -> None:
    """Raise unless ``value`` is bitwise the same float on every rank of
    ``group`` (NaN equals NaN). Pass ``DpMpGroups.world_group`` to check
    every rank."""
    seen = gather_by_sum(torch.tensor([value], dtype=torch.float64, device=device),
                         group).flatten().tolist()
    same = [v == value or (v != v and value != value) for v in seen]
    if not all(same):
        raise RuntimeError(f"{what} differs across the group's ranks: {seen}")
