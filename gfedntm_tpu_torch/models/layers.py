"""A linear layer with a compute dtype, mask-aware affine-free BatchNorm
(torch semantics) and dropout drawn from an explicit generator.

Counterpart of ``gfedntm_tpu/models/layers.py``. ``TorchDense`` there is
:class:`Linear` here: ``nn.Linear`` in float32, and under a bf16 compute
dtype ``x.to(bf16) @ W.to(bf16)`` rounded to bf16, then ``+ b.to(bf16)``
in bf16 (``layers.py:44-49``); the weights stay float32. ``nn.BatchNorm1d``
has no row mask, so :class:`MaskedBatchNorm` is written out:

- training normalizes with the *biased* batch variance over the real
  (mask > 0) rows; masked rows are normalized too but excluded from the
  statistics;
- the running variance takes the *unbiased* one, and both running stats
  blend with momentum 0.1: ``new = (1 - m) * old + m * batch``;
- eval normalizes with the running stats;
- ``num_batches_tracked`` is kept for state-dict parity with the
  reference's ``grads_to_share`` keys;
- it computes in float32 whatever the input's dtype and returns the input's
  dtype, with float32 running statistics (``layers.py:104-116``);
- with a data ``group`` (rows split over data-parallel ranks) its batch
  statistics are those of the whole batch: each masked sum, and the count,
  is summed over the group, the gradient of each sum too
  (:func:`~gfedntm_tpu_torch.parallel.collectives.sum_forward_sum_backward`),
  and the running statistics take the whole batch's count. GSPMD gives the
  JAX package the same statistics (``gfedntm_tpu/train/steps.py:65-88``).

Data-parallel ranks draw dropout (and the networks their reparameterization
noise) at the whole batch's shape and keep their own rows (:class:`Rows`,
:func:`draw`), so the generator's stream, and every row's draw, is the
single-device run's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from gfedntm_tpu_torch.parallel.collectives import (
    sum_forward_sum_backward,
    sum_in_rank_order,
)


class Rows(NamedTuple):
    """This rank's rows ``[start, stop)`` of a batch of ``full`` rows that is
    padded with masked rows past ``full`` to split evenly over a data
    group."""

    full: int
    start: int
    stop: int


def window(t: torch.Tensor, rows: Rows | None) -> torch.Tensor:
    """The rows of ``t`` (a whole batch, [full, ...]) in ``rows``, with zero
    rows past ``full``; ``t`` itself when ``rows`` is ``None``."""
    if rows is None:
        return t
    if rows.stop > t.shape[0]:
        t = torch.cat([t, t.new_zeros((rows.stop - t.shape[0], *t.shape[1:]))])
    return t[rows.start:rows.stop]


def draw(sample, shape, rows: Rows | None, **kwargs) -> torch.Tensor:
    """``sample(shape, **kwargs)`` (``torch.rand``, ``torch.randn``) for a
    tensor of ``shape``; under ``rows`` drawn at the whole batch's shape
    and windowed to this rank's rows."""
    if rows is None:
        return sample(shape, **kwargs)
    return window(sample((rows.full, *shape[1:]), **kwargs), rows)


def batch_count(mask: torch.Tensor, group) -> torch.Tensor:
    """The number of real (mask > 0) rows of the whole batch, at least 1:
    the count of ``mask`` summed over the data ``group``."""
    return torch.clamp_min(sum_in_rank_order(mask.to(torch.float32).sum(), group), 1.0)


class Linear(nn.Linear):
    """``nn.Linear`` with ``TorchDense``'s compute dtype: float32 is
    ``nn.Linear`` itself; bf16 multiplies in bf16 (float32 accumulation,
    one rounding) and adds the bias in bf16."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class MaskedBatchNorm(nn.Module):
    """Affine-free BatchNorm1d with an optional [batch] row mask; ``group``
    (a data group, set by the data-parallel trainers) syncs its training
    statistics over the group's rows."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.eps = eps
        self.group = None
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        xf = x.to(torch.float32)
        if not self.training:
            mean, var = self.running_mean, self.running_var
        elif self.group is not None:
            m = (torch.ones_like(xf[:, :1]) if mask is None
                 else mask.to(torch.float32)[:, None])
            n = batch_count(m, self.group)
            mean = sum_forward_sum_backward((xf * m).sum(dim=0), self.group) / n
            var = sum_forward_sum_backward((torch.square(xf - mean) * m).sum(dim=0),
                                           self.group) / n
            self.update_running_stats(mean, var, n)
        else:
            if mask is None:
                n = torch.tensor(float(max(1, x.shape[0])), device=x.device)
                mean = xf.mean(dim=0)
                var = torch.square(xf - mean).mean(dim=0)
            else:
                m = mask.to(torch.float32)[:, None]
                n = torch.clamp_min(m.sum(), 1.0)
                mean = (xf * m).sum(dim=0) / n
                var = (torch.square(xf - mean) * m).sum(dim=0) / n
            self.update_running_stats(mean, var, n)
        return ((xf - mean) / torch.sqrt(var + self.eps)).to(x.dtype)

    @torch.no_grad()
    def update_running_stats(
        self, mean: torch.Tensor, var_biased: torch.Tensor, n: torch.Tensor
    ) -> None:
        """Blend one batch's statistics into the running stats (momentum 0.1,
        unbiased running variance); also used by the fused decoder path,
        whose kernel returns the batch statistics."""
        var_unbiased = var_biased * (n / torch.clamp_min(n - 1.0, 1.0))
        m = self.momentum
        self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean.detach())
        self.running_var.copy_((1.0 - m) * self.running_var + m * var_unbiased.detach())
        self.num_batches_tracked += 1


def dropout(
    x: torch.Tensor, p: float, training: bool, generator: torch.Generator | None,
    rows: Rows | None = None,
) -> torch.Tensor:
    """Inverted dropout with keep-probability ``1 - p`` drawn from
    ``generator`` (flax ``nn.Dropout`` semantics: kept units scale by
    ``1/(1-p)``); ``x`` holds the batch rows ``rows`` (:func:`draw`)."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = draw(torch.rand, x.shape, rows, generator=generator, device=x.device) < (1.0 - p)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
