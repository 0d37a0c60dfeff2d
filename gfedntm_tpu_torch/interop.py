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
