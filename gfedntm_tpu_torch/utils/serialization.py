"""Model artifact serialization.

A copy of ``gfedntm_tpu/utils/serialization.py`` with its
``flax.traverse_util`` import replaced by :func:`flatten_dict` and
:func:`unflatten_dict` below, so the files are the JAX package's byte for
byte:

- ``save_variables`` / ``load_variables``: one ``.npz`` of a nested variable
  tree (``{"params": ..., "batch_stats": ...}`` of numpy arrays) with
  '/'-joined path keys, the format of ``AVITM.save``;
- ``save_model_as_npz``: the reference's final-artifact bundle of
  betas/thetas/topics (``auxiliary_functions.py:66-99``).

The port's torch state dicts go through
:func:`gfedntm_tpu_torch.interop.flax_from_state_dict` first, so the tree
holds Flax names, [in, out] kernels and int32 ``num_batches_tracked``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import numpy as np


def flatten_dict(tree: Mapping[str, Any], sep: str = "/") -> dict[str, Any]:
    """``{"a/b": leaf}`` from ``{"a": {"b": leaf}}``, in insertion order, as
    ``flax.traverse_util.flatten_dict(tree, sep=sep)`` gives it (empty
    sub-dicts are dropped)."""
    flat: dict[str, Any] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            for sub, leaf in flatten_dict(value, sep).items():
                flat[f"{key}{sep}{sub}"] = leaf
        else:
            flat[key] = value
    return flat


def unflatten_dict(flat: Mapping[str, Any], sep: str = "/") -> dict[str, Any]:
    """Inverse of :func:`flatten_dict`."""
    tree: dict[str, Any] = {}
    for key, leaf in flat.items():
        *parents, name = key.split(sep)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def save_variables(path: str, variables: dict) -> None:
    flat = flatten_dict(variables, sep="/")
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})


def load_variables(path: str) -> dict:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return unflatten_dict(flat, sep="/")


def save_model_as_npz(
    save_dir: str,
    betas: np.ndarray,
    thetas: np.ndarray | None,
    topics: list[list[str]] | None,
    n_components: int,
    name: str = "model",
) -> str:
    """Reference final-artifact schema: keys ``betas``, ``thetas``,
    ``ntopics``, ``topics`` (``auxiliary_functions.py:66-99``; the server-side
    variant stores betas only, ``federated_model.py:183-197``)."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{name}.npz")
    payload = {"betas": betas, "ntopics": n_components}
    if thetas is not None:
        payload["thetas"] = thetas
    if topics is not None:
        payload["topics"] = np.array(
            json.dumps([list(t) for t in topics])
        )
    np.savez(path, **payload)
    return path
