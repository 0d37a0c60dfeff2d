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
  dtype, with float32 running statistics (``layers.py:104-116``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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
    """Affine-free BatchNorm1d with an optional [batch] row mask."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.eps = eps
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        xf = x.to(torch.float32)
        if not self.training:
            mean, var = self.running_mean, self.running_var
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
    x: torch.Tensor, p: float, training: bool, generator: torch.Generator | None
) -> torch.Tensor:
    """Inverted dropout with keep-probability ``1 - p`` drawn from
    ``generator`` (flax ``nn.Dropout`` semantics: kept units scale by
    ``1/(1-p)``)."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (1.0 - p)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
