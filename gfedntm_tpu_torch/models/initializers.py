"""Parameter initializers with torch's default distributions, drawn from an
explicit ``torch.Generator``.

Counterpart of ``gfedntm_tpu/models/initializers.py``: ``nn.Linear`` weights
and biases are U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's kaiming-uniform
with a=sqrt(5)); ``beta`` is ``xavier_uniform`` (reference
``decoder_network.py:91-95``). The distributions match; the draws do not.
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def init_linear_(layer: nn.Linear, generator: torch.Generator) -> None:
    """torch's default ``nn.Linear`` init: weight and bias U(-b, b),
    b = 1/sqrt(fan_in)."""
    bound = 1.0 / math.sqrt(layer.in_features)
    layer.weight.uniform_(-bound, bound, generator=generator)
    if layer.bias is not None:
        layer.bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def xavier_uniform_2d_(tensor: torch.Tensor, generator: torch.Generator) -> None:
    """``nn.init.xavier_uniform_`` (gain 1) on a [rows, cols] matrix: torch
    treats dim 1 as fan_in and dim 0 as fan_out."""
    fan_out, fan_in = tensor.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    tensor.uniform_(-bound, bound, generator=generator)
