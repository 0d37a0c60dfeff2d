"""Optimizer factory matching the reference's torch solvers.

Counterpart of ``gfedntm_tpu/train/optimizers.py``; the reference builds one
of {adam, sgd, adagrad, adadelta, rmsprop} (``avitm.py:140-153``). Adam uses
``betas=(momentum, 0.99)`` with the config default momentum 0.99
(``dft_params.cf:15``) and eps 1e-8.
"""

from __future__ import annotations

from typing import Iterable

import torch


def build_optimizer(
    params: Iterable[torch.nn.Parameter],
    solver: str = "adam",
    lr: float = 2e-3,
    momentum: float = 0.99,
) -> torch.optim.Optimizer:
    solver = solver.lower()
    if solver == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(momentum, 0.99), eps=1e-8)
    if solver == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=momentum)
    if solver == "adagrad":
        return torch.optim.Adagrad(params, lr=lr, eps=1e-10)
    if solver == "adadelta":
        return torch.optim.Adadelta(params, lr=lr, rho=0.9, eps=1e-6)
    if solver == "rmsprop":
        return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8, momentum=momentum)
    raise ValueError(
        "solver must be 'adam', 'adadelta', 'sgd', 'rmsprop' or "
        f"'adagrad', got {solver!r}"
    )
