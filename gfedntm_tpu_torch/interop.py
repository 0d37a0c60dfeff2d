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


def state_dict_from_flax(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any]
) -> "OrderedDict[str, torch.Tensor]":
    """Build a port state dict from Flax ``params`` / ``batch_stats`` trees
    of numpy arrays."""
    out: OrderedDict[str, torch.Tensor] = OrderedDict()
    for path, leaf in _walk(params):
        arr = np.array(leaf, dtype=np.float32, copy=True)
        if path[-1] == "kernel":
            arr = np.ascontiguousarray(arr.T)
        out[torch_key(path)] = torch.from_numpy(arr)
    for path, leaf in _walk(batch_stats):
        arr = np.array(leaf, copy=True)
        if path[-1] == "num_batches_tracked":
            out[torch_key(path)] = torch.tensor(int(arr), dtype=torch.long)
        else:
            out[torch_key(path)] = torch.from_numpy(arr.astype(np.float32))
    return out


def flax_from_state_dict(
    state_dict: Mapping[str, torch.Tensor],
) -> tuple[dict, dict]:
    """Inverse of :func:`state_dict_from_flax`: ``(params, batch_stats)``
    nested dicts of numpy arrays."""
    params: dict = {}
    batch_stats: dict = {}
    for key, tensor in state_dict.items():
        arr = tensor.detach().cpu().numpy()
        key = _TORCH_HIDDEN.sub(lambda m: f"{m.group(1)}hiddens_l{m.group(2)}.", key)
        parts = key.split(".")
        if parts[-1] in _BN_BUFFERS:
            tree = batch_stats
            if parts[-1] == "num_batches_tracked":
                arr = np.asarray(arr, dtype=np.int32)
        else:
            tree = params
            if parts[-1] == "weight":
                parts[-1] = "kernel"
                arr = np.ascontiguousarray(arr.T)
        for p in parts[:-1]:
            tree = tree.setdefault(p, {})
        tree[parts[-1]] = np.array(arr, copy=True)
    return params, batch_stats
