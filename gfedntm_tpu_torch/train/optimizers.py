"""Optimizer factory that steps as the JAX package's optax solvers do.

Counterpart of ``gfedntm_tpu/train/optimizers.py``, which builds one of
{adam, sgd, adagrad, adadelta, rmsprop} from optax 0.2.6
(``optimizers.py:56-70``). Each solver here takes the same update as its
optax twin, so that the optimizer state bridges 1:1
(:mod:`gfedntm_tpu_torch.interop`):

- adam: ``torch.optim.Adam`` with ``betas=(momentum, 0.99)``, eps 1e-8 (the
  reference config's momentum 0.99, ``dft_params.cf:15``);
- sgd: :class:`SGD`, torch's with a step count; optax's ``trace`` runs
  before the learning-rate scale, as torch's momentum buffer does;
- adagrad: ``torch.optim.Adagrad`` with optax's ``initial_accumulator_value``
  0.1. optax divides by ``sqrt(sum + eps)``, torch by ``sqrt(sum) + eps``;
  at eps 1e-10 the two agree to float32 rounding;
- adadelta: ``torch.optim.Adadelta`` (rho 0.9, eps 1e-6), optax's formula;
- rmsprop: :class:`RMSprop` below, since torch's puts eps outside the square
  root and scales by the learning rate after its momentum.
"""

from __future__ import annotations

from typing import Iterable

import torch


class SGD(torch.optim.SGD):
    """``torch.optim.SGD`` that also counts its steps in each parameter's
    ``step`` slot, as the other solvers do: optax's ``inject_hyperparams``
    keeps that count beside sgd's ``trace``."""

    @torch.no_grad()
    def step(self, closure=None):
        loss = super().step(closure)
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    state = self.state[p]
                    state["step"] = state.get("step", torch.tensor(0.0)) + 1
        return loss


class RMSprop(torch.optim.Optimizer):
    """optax's ``rmsprop(lr, decay, eps, momentum)`` with ``eps_in_sqrt``:
    ``scale_by_rms`` → scale by ``-lr`` → ``trace``::

        square_avg      = decay * square_avg + (1 - decay) * g**2
        momentum_buffer = momentum * momentum_buffer - lr * g / sqrt(square_avg + eps)
        p              += momentum_buffer

    ``momentum_buffer`` holds the learning-rate-scaled, negated update, as
    optax's ``TraceState.trace`` does, so a learning rate changed between
    steps (``reduce_on_plateau``) scales only the new term. The slots keep
    torch's names (``square_avg``, ``momentum_buffer``, ``step``)."""

    def __init__(self, params, lr: float = 1e-2, decay: float = 0.99,
                 eps: float = 1e-8, momentum: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, decay, eps, momentum = (group[k] for k in ("lr", "decay", "eps", "momentum"))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    state["square_avg"] = torch.zeros_like(p)
                    state["momentum_buffer"] = torch.zeros_like(p)
                state["step"] += 1
                sq = state["square_avg"]
                sq.mul_(decay).addcmul_(g, g, value=1 - decay)
                update = g * torch.rsqrt(sq + eps) * -lr
                buf = state["momentum_buffer"]
                buf.mul_(momentum).add_(update)
                p.add_(buf)
        return loss


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
        return SGD(params, lr=lr, momentum=momentum)
    if solver == "adagrad":
        return torch.optim.Adagrad(params, lr=lr, initial_accumulator_value=0.1, eps=1e-10)
    if solver == "adadelta":
        return torch.optim.Adadelta(params, lr=lr, rho=0.9, eps=1e-6)
    if solver == "rmsprop":
        return RMSprop(params, lr=lr, decay=0.99, eps=1e-8, momentum=momentum)
    raise ValueError(
        "solver must be 'adam', 'adadelta', 'sgd', 'rmsprop' or "
        f"'adagrad', got {solver!r}"
    )
