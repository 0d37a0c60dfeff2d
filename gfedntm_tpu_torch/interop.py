"""Weight bridge between a Flax variable tree and the port's state dict.

The JAX package keeps ``{"params": ..., "batch_stats": ...}`` nested dicts
whose paths follow Flax module names (``inf_net/hiddens_l0/kernel``); the
port's modules carry the reference's torch state-dict keys
(``inf_net.hiddens.l_0.0.weight``). The bridge

- transposes a Flax ``kernel`` [in, out] into a torch ``weight`` [out, in];
- maps ``hiddens_l{i}`` to ``hiddens.l_{i}.0``;
- maps ``batch_stats/...`` to the BatchNorm buffers, with
  ``num_batches_tracked`` int32 in JAX and int64 in torch.

It takes and returns numpy arrays on the Flax side, so it needs no JAX.
Every leaf bridges alike, the CTM encoders' too (``inf_net.adapt_bert``,
CombinedTM's [2V + L, H] and ZeroShotTM's [768 + L, H] input kernels,
``label_classification``). :func:`flax_path`, :func:`to_flax` and
:func:`from_flax` convert one leaf, which the federated stepper's snapshots
use: they are keyed by '/'-joined Flax paths (``params/beta``,
``batch_stats/beta_batchnorm/num_batches_tracked``), as the JAX stepper's.
``parallel.sharded.shard_state_dict`` slices a bridged state dict into one
rank's V shard, so a V-sharded run starts from the JAX package's weights.

The Adam bridge (:func:`optax_adam_state`, :func:`load_optax_adam_state`)
carries a torch ``Adam``'s state in optax's layout, as numpy, without
optax: ``optax.adam``'s state is ``(ScaleByAdamState(count, mu, nu),
EmptyState())``, and under ``reduce_on_plateau`` the JAX package wraps it in
``inject_hyperparams`` (``InjectStatefulHyperparamsState(count, hyperparams,
hyperparams_states, inner_state)``; ``gfedntm_tpu/train/optimizers.py:38-78``).
optax keeps one int32 ``count`` where torch keeps a ``step`` per parameter;
``mu`` and ``nu`` are trees of the parameters' Flax paths, kernels [in, out]
(they transpose with their kernel). The federation's join ships this state
(``GlobalSetup.init_opt_state``).
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Mapping

import numpy as np
import torch

_FLAX_HIDDEN = re.compile(r"^hiddens_l(\d+)$")
_TORCH_HIDDEN = re.compile(r"(^|\.)hiddens\.l_(\d+)\.0\.")
_BN_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _walk(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def torch_key(path: tuple[str, ...]) -> str:
    """The state-dict key of one Flax variable path (within its collection)."""
    parts = [
        f"hiddens.l_{m.group(1)}.0" if (m := _FLAX_HIDDEN.match(p)) else p
        for p in path
    ]
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def flax_path(key: str) -> tuple[str, tuple[str, ...]]:
    """``(collection, path)`` of one state-dict key in the Flax variable
    tree: ``("params", ("inf_net", "hiddens_l0", "kernel"))`` for
    ``inf_net.hiddens.l_0.0.weight``."""
    key = _TORCH_HIDDEN.sub(lambda m: f"{m.group(1)}hiddens_l{m.group(2)}.", key)
    parts = key.split(".")
    if parts[-1] in _BN_BUFFERS:
        return "batch_stats", tuple(parts)
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "params", tuple(parts)


def to_flax(key: str, tensor: torch.Tensor) -> np.ndarray:
    """The Flax leaf of the state-dict entry ``key``: a copy on the host, a
    weight transposed to its [in, out] kernel (on the tensor's device,
    before the one copy to the host), the counter int32."""
    leaf = key.rsplit(".", 1)[-1]
    t = tensor.detach()
    if leaf == "num_batches_tracked":
        t = t.to(torch.int32)
    elif leaf == "weight":
        t = t.t()
    t = t.contiguous()
    # A CPU tensor's numpy view shares its memory: copy it.
    return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()


def from_flax(path: tuple[str, ...], leaf) -> torch.Tensor:
    """The state-dict tensor of the Flax leaf at ``path`` (within its
    collection): float32, a kernel transposed, the counter int64."""
    arr = np.array(leaf, copy=True)
    if path[-1] == "num_batches_tracked":
        return torch.tensor(int(arr), dtype=torch.long)
    arr = arr.astype(np.float32)
    if path[-1] == "kernel":
        arr = np.ascontiguousarray(arr.T)
    return torch.from_numpy(arr)


def _params_tree(module: torch.nn.Module, leaf) -> dict:
    """``{flax path: leaf(key, parameter)}`` over ``module``'s parameters as a
    nested dict (the optax ``mu`` / ``nu`` layout)."""
    tree: dict = {}
    for key, p in module.named_parameters():
        collection, path = flax_path(key)
        if collection != "params":
            raise ValueError(f"parameter {key!r} maps to the {collection} collection")
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf(key, p)
    return tree


def _adam(optimizer: torch.optim.Optimizer) -> None:
    if not isinstance(optimizer, torch.optim.Adam):
        raise NotImplementedError(
            f"the optax state bridge covers Adam only, not {type(optimizer).__name__} "
            "(ROADMAP queue 1)")


def optax_adam_state(module: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     inject_lr: bool = False):
    """The optax layout of ``optimizer``'s Adam state over ``module``'s
    parameters, as a tree of numpy arrays for
    :func:`gfedntm_tpu_torch.federation.codec.tree_to_bundle` (a fresh
    optimizer's is count 0 and zero moments, as ``optax.adam().init``'s).
    ``inject_lr`` wraps it as ``inject_hyperparams`` does, with the first
    param group's learning rate as float32."""
    from gfedntm_tpu_torch.federation.codec import Fields

    _adam(optimizer)
    steps = {int(optimizer.state[p]["step"]) for p in module.parameters()
             if "step" in optimizer.state.get(p, {})}
    if len(steps) > 1:
        raise ValueError(f"parameters at different Adam steps {sorted(steps)}: "
                         "optax keeps one count")
    count = np.asarray(steps.pop() if steps else 0, np.int32)

    def moment(name):
        def leaf(key, p):
            t = optimizer.state.get(p, {}).get(name)
            return to_flax(key, torch.zeros_like(p) if t is None else t)
        return _params_tree(module, leaf)

    adam = (Fields(count=count, mu=moment("exp_avg"), nu=moment("exp_avg_sq")), ())
    if not inject_lr:
        return adam
    lr = np.asarray(optimizer.param_groups[0]["lr"], np.float32)
    return Fields(count=count, hyperparams={"learning_rate": lr},
                  hyperparams_states={}, inner_state=adam)


@torch.no_grad()
def load_optax_adam_state(module: torch.nn.Module, optimizer: torch.optim.Optimizer,
                          state) -> None:
    """Set ``optimizer``'s Adam state from the optax layout (the inverse of
    :func:`optax_adam_state`): every parameter's ``step`` is the count, its
    moments are ``mu`` and ``nu`` at its Flax path (kernels transposed),
    on its device. An injected learning rate replaces the param groups' only
    where it differs from theirs in float32, so a state bridged from this
    optimizer loads back bitwise."""
    _adam(optimizer)
    if isinstance(state, Mapping):  # inject_hyperparams
        lr = np.float32(state["hyperparams"]["learning_rate"])
        for group in optimizer.param_groups:
            if np.float32(group["lr"]) != lr:
                group["lr"] = float(lr)
        state = state["inner_state"]
    adam = state[0]
    count = float(np.asarray(adam["count"]))
    for key, p in module.named_parameters():
        _, path = flax_path(key)

        def at(tree):
            for part in path:
                tree = tree[part]
            return from_flax(path, tree).to(p.device)

        # The step stays a host float32 scalar, as Adam's own lazy init
        # makes it (not capturable, not fused).
        optimizer.state[p] = {"step": torch.tensor(count, dtype=torch.float32),
                              "exp_avg": at(adam["mu"]), "exp_avg_sq": at(adam["nu"])}


def state_dict_from_flax(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any]
) -> "OrderedDict[str, torch.Tensor]":
    """Build a port state dict from Flax ``params`` / ``batch_stats`` trees
    of numpy arrays."""
    out: OrderedDict[str, torch.Tensor] = OrderedDict()
    for tree in (params, batch_stats):
        for path, leaf in _walk(tree):
            out[torch_key(path)] = from_flax(path, leaf)
    return out


def flax_from_state_dict(
    state_dict: Mapping[str, torch.Tensor],
) -> tuple[dict, dict]:
    """Inverse of :func:`state_dict_from_flax`: ``(params, batch_stats)``
    nested dicts of numpy arrays."""
    trees: dict = {"params": {}, "batch_stats": {}}
    for key, tensor in state_dict.items():
        collection, path = flax_path(key)
        tree = trees[collection]
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = to_flax(key, tensor)
    return trees["params"], trees["batch_stats"]
