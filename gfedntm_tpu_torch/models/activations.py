"""Activation registry matching the reference's supported set.

Counterpart of ``gfedntm_tpu/models/activations.py``: the nine names
{softplus, relu, sigmoid, swish, tanh, leakyrelu, rrelu, elu, selu}. ``swish``
is SiLU. ``rrelu`` uses the deterministic mean slope (1/8 + 1/3)/2 in both
modes, as the JAX package does when no ``rrelu`` key is supplied — which its
networks never do.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.nn import functional as F

_RRELU_SLOPE = (1.0 / 8.0 + 1.0 / 3.0) / 2.0

ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "softplus": F.softplus,
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "swish": F.silu,
    "tanh": torch.tanh,
    "leakyrelu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "rrelu": lambda x: torch.where(x >= 0, x, x * _RRELU_SLOPE),
    "elu": F.elu,
    "selu": F.selu,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Look up an activation by its reference-compatible string name."""
    try:
        return ACTIVATIONS[name.lower()]
    except KeyError:
        raise ValueError(
            f"activation must be one of {sorted(ACTIVATIONS)}, got {name!r}"
        ) from None


class Activation(nn.Module):
    """An activation by name, as a module (so it can sit in ``nn.Sequential``)."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name
        self.fn = get_activation(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)

    def extra_repr(self) -> str:
        return self.name
