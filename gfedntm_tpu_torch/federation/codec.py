"""numpy/tree ⇄ protobuf tensor codecs for the network federation path.

Counterpart of ``gfedntm_tpu/federation/codec.py``. The records and the flat
``{name: array}`` bundles that carry every per-step exchange
(:func:`np_dtype`, :func:`array_to_record`, :func:`record_to_array`,
:func:`flatdict_to_bundle`, :func:`bundle_to_flatdict`; ``codec.py:41-119``)
are copied as they are.

:func:`tree_to_bundle` / :func:`bundle_to_tree` (``codec.py:124-171``) name
a tree's leaves by ``jax.tree_util.keystr`` paths. Here the same names come
without jax, from the same flatten order:

- a ``dict`` flattens in sorted-key order, each key named ``['key']``;
- a ``tuple`` or ``list`` in index order, named ``[i]``; an empty one (an
  optax ``EmptyState``) has no leaves;
- :class:`Fields` (a NamedTuple such as optax's ``ScaleByAdamState``) in
  field order, named ``.field``.

So ``{"params": ..., "batch_stats": ...}`` of a bridged model
(:func:`gfedntm_tpu_torch.interop.flax_from_state_dict`) gives
``['batch_stats']['beta_batchnorm']['num_batches_tracked']``, …,
``['params']['inf_net']['input_layer']['kernel']``, …, and the Adam state of
:func:`gfedntm_tpu_torch.interop.optax_opt_state` gives ``[0].count``,
``[0].mu['beta']``, … — the JAX server's records, name for name.
"""

from __future__ import annotations

import time
from typing import Any, Iterator, Mapping

import ml_dtypes
import numpy as np

from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb
from gfedntm_tpu_torch.utils.observability import DEFAULT_BYTE_BUCKETS

# dtype whitelist (superset of the reference's float32/float64/int64,
# auxiliary_functions.py:24-35; int32/bool appear in optax/BatchNorm state).
ALLOWED_DTYPES = frozenset(
    {"float32", "float64", "bfloat16", "int32", "int64", "uint32", "bool"}
)

# Dtypes a record's raw payload may be stored in. float16 is wire-only: it
# exists as a quantized transport format (compression.QuantizeStage), never
# as a logical model dtype.
WIRE_DTYPES = ALLOWED_DTYPES | {"float16"}


def np_dtype(name: str) -> np.dtype:
    """numpy dtype for a wire dtype name. bfloat16 is not a stock numpy
    dtype — it comes from ml_dtypes, which makes the raw 2-byte
    little-endian payload stable across endpoints."""
    if name == "bfloat16":
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def array_to_record(name: str, value: Any) -> pb.TensorRecord:
    arr = np.asarray(value)
    dtype = arr.dtype.name
    if dtype not in ALLOWED_DTYPES:
        raise TypeError(f"dtype {dtype!r} of {name!r} is not serializable")
    # bf16 ships as its raw 2-byte payload (ml_dtypes gives both endpoints
    # the same buffer layout).
    return pb.TensorRecord(
        name=name, shape=list(arr.shape), dtype=dtype,
        data=np.ascontiguousarray(arr).tobytes(),
    )


def record_to_array(record: pb.TensorRecord) -> np.ndarray:
    if record.dtype not in ALLOWED_DTYPES:
        raise TypeError(f"dtype {record.dtype!r} not allowed on the wire")
    if record.codec not in ("", "raw"):
        raise ValueError(
            f"record {record.name!r} is compressed ({record.codec!r}); "
            "decode it through federation.compression, not the raw codec"
        )
    wire = record.wire_dtype or record.dtype
    if wire not in WIRE_DTYPES:
        raise TypeError(f"wire dtype {wire!r} not allowed on the wire")
    arr = np.frombuffer(record.data, dtype=np_dtype(wire))
    arr = arr.reshape(tuple(record.shape))
    if wire != record.dtype:  # quantized transport: upcast to logical dtype
        return arr.astype(np_dtype(record.dtype))
    return arr.copy()


def _note_codec(metrics, op: str, bundle: pb.TensorBundle,
                seconds: float) -> None:
    """Feed codec telemetry (seconds + serialized bytes per bundle) into a
    MetricsLogger's registry (registry only: totals surface through
    ``metrics_snapshot``)."""
    reg = metrics.registry
    nbytes = bundle.ByteSize()
    reg.histogram(f"codec_{op}_s").observe(seconds)
    reg.histogram(
        "codec_bundle_bytes", buckets=DEFAULT_BYTE_BUCKETS
    ).observe(nbytes)
    reg.counter(f"codec_{op}d_bytes").inc(nbytes)
    reg.counter(f"codec_{op}_calls").inc()


# ---- flat {name: array} dicts (the shared-subset snapshots) ----------------

def flatdict_to_bundle(
    tensors: Mapping[str, np.ndarray], metrics=None
) -> pb.TensorBundle:
    t0 = time.perf_counter() if metrics is not None else 0.0
    bundle = pb.TensorBundle(
        tensors=[array_to_record(k, v) for k, v in sorted(tensors.items())]
    )
    if metrics is not None:
        _note_codec(metrics, "encode", bundle, time.perf_counter() - t0)
    return bundle


def bundle_to_flatdict(
    bundle: pb.TensorBundle, metrics=None
) -> dict[str, np.ndarray]:
    t0 = time.perf_counter() if metrics is not None else 0.0
    out = {r.name: record_to_array(r) for r in bundle.tensors}
    if metrics is not None:
        _note_codec(metrics, "decode", bundle, time.perf_counter() - t0)
    return out


# ---- trees (variables / optimizer state) -----------------------------------

class Fields(dict):
    """A NamedTuple node of a tree (optax's ``ScaleByAdamState``,
    ``InjectStatefulHyperparamsState``): its leaves flatten in field
    (insertion) order and are named ``.field``."""


def _walk(tree: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    if isinstance(tree, Fields):
        for name, value in tree.items():
            yield from _walk(value, f"{path}.{name}")
    elif isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _walk(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, value in enumerate(tree):
            yield from _walk(value, f"{path}[{i}]")
    else:
        yield path, tree


def leaves_with_names(tree: Any) -> list[tuple[str, Any]]:
    """``[(keystr path, leaf)]`` in jax's flatten order."""
    return list(_walk(tree))


def _rebuild(template: Any, leaves: Iterator[Any]) -> Any:
    if isinstance(template, Fields):
        return Fields((name, _rebuild(v, leaves)) for name, v in template.items())
    if isinstance(template, Mapping):
        out = {key: _rebuild(template[key], leaves) for key in sorted(template)}
        return {key: out[key] for key in template}
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def tree_to_bundle(tree: Any, metrics=None) -> pb.TensorBundle:
    """Serialize every array leaf of ``tree`` in flatten order."""
    t0 = time.perf_counter() if metrics is not None else 0.0
    bundle = pb.TensorBundle(
        tensors=[array_to_record(n, l) for n, l in leaves_with_names(tree)]
    )
    if metrics is not None:
        _note_codec(metrics, "encode", bundle, time.perf_counter() - t0)
    return bundle


def bundle_to_tree(template: Any, bundle: pb.TensorBundle, metrics=None) -> Any:
    """Rebuild a tree with ``template``'s structure from a bundle produced
    by :func:`tree_to_bundle` (or the JAX package's) on a structurally
    identical tree. A name, count or shape mismatch raises; each leaf takes
    the template leaf's dtype."""
    t0 = time.perf_counter() if metrics is not None else 0.0
    named = leaves_with_names(template)
    records = list(bundle.tensors)
    if len(records) != len(named):
        raise ValueError(
            f"bundle has {len(records)} tensors, template {len(named)} leaves"
        )
    new_leaves = []
    for (name, leaf), record in zip(named, records):
        if record.name != name:
            raise ValueError(
                f"leaf path mismatch: wire {record.name!r} vs template {name!r}"
            )
        arr = record_to_array(record)
        tmpl = np.asarray(leaf)
        if tuple(arr.shape) != tmpl.shape:
            raise ValueError(
                f"shape mismatch at {name!r}: wire {arr.shape} vs "
                f"template {tmpl.shape}"
            )
        new_leaves.append(arr.astype(tmpl.dtype))
    out = _rebuild(template, iter(new_leaves))
    if metrics is not None:
        _note_codec(metrics, "decode", bundle, time.perf_counter() - t0)
    return out
