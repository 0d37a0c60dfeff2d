"""Wire-compression strategies for the federation hot path.

A copy of ``gfedntm_tpu/federation/compression.py`` (numpy, grpc and the
standard library only), its imports rewritten to ``gfedntm_tpu_torch``; the
rest is the original's, so both packages speak the same wire
(``tests/test_torch_federation_codec.py`` holds it to the original).

The protocol exchanges full client parameter bundles every round, so the
wire moves ``2 x clients x |theta|`` float32 bytes per round — the dominant
cost of the network path (the FL communication survey, arXiv:2405.20431,
names update compression the highest-leverage lever for exactly this
shape). This module layers a :class:`WireCodec` strategy *under*
:mod:`gfedntm_tpu_torch.federation.codec`: the proto schema is unchanged except
for three additive ``TensorRecord`` fields (``codec``/``aux``/``wire_dtype``)
and a ``TensorBundle.ref_round`` tag.

Three composable stages, spec'd as a ``+``-joined string (the **codec id**
negotiated at join time):

- ``delta`` — encode values relative to the last *broadcast aggregate* both
  endpoints hold. One optimizer step moves parameters a little; the delta's
  dynamic range is tiny, which is what makes the lossy stages cheap.
- ``topk:<frac>`` — keep only the largest-magnitude ``frac`` of each
  tensor's (delta) entries, shipping ``uint32`` indices + values. Lossy;
  the dropped mass goes into a per-endpoint **error-feedback residual**
  that is added back before the next selection, so nothing is lost
  permanently — only delayed. Implies ``delta`` (top-k of raw parameters
  would zero most of the model).
- ``fp16`` / ``bf16`` — quantize the transmitted values buffer; decode
  upcasts to the logical dtype recorded on the wire.

Reference discipline (the part that makes delta safe): every delta-encoded
bundle carries ``ref_round`` = 1 + the round whose broadcast it is relative
to. Decoders that do not hold that exact reference **fail loudly**
(:class:`ReferenceMismatch`) instead of mis-decoding; the server keeps a
small cache of recent broadcast views so a client that missed one push
still decodes.

Per-recipient push encoding (README "Hierarchical federation & wire
efficiency"): the downlink maintains one **canonical view chain** —
``view_i = view_{i-1} + recon(compress(avg_i - view_{i-1} + residual))``,
exactly the consecutive-round delta stream — and every recipient of a
push converges onto the round's canonical view regardless of how far
behind it was:

- a recipient holding the immediately-previous view gets the canonical
  chain bundle (computed once per round, shared);
- a recipient holding an older cached view gets an exact **catch-up**
  bundle: the entries where the canonical view changed since its round,
  shipped as *assignment* records (``sparse_set``: uint32 indices + values
  at the logical dtype) so the reconstruction is bit-exact — additive
  float deltas would drift by an ulp and silently corrupt the uplink
  reference chain;
- a recipient with no usable reference (fresh join, or its view was
  evicted from the bounded cache) gets a self-contained view bundle (raw
  records of the canonical view) — degraded compression, never an error.

Both reference caches (uplink broadcast views, downlink canonical views)
are bounded LRU keyed by round; evictions are instrumented
(``codec_refs_evicted`` counter, eviction-age gauge, ``codec_ref_evicted``
events) and degrade to self-contained pushes / loud
:class:`ReferenceMismatch` heals, never to mis-decodes.

Integer/bool tensors and zero-size arrays always ride raw records — the
lossy stages are float-only by construction.
"""

from __future__ import annotations

import math
import time
from collections import OrderedDict
from typing import Any, Mapping

import numpy as np

from gfedntm_tpu_torch.federation import codec
from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb

__all__ = [
    "CodecError",
    "ReferenceMismatch",
    "WireCodec",
    "make_codec",
    "UplinkEncoder",
    "UplinkDecoder",
    "DownlinkEncoder",
    "DownlinkDecoder",
]


class CodecError(ValueError):
    """A bundle could not be decoded under the negotiated codec."""


class ReferenceMismatch(CodecError):
    """A delta bundle references a broadcast this endpoint does not hold."""


_QUANT_DTYPES = {"fp16": "float16", "bf16": "bfloat16"}


class WireCodec:
    """Parsed, canonicalized compression spec (the negotiated codec id).

    ``spec`` is ``None``/``""``/``"none"``/``"identity"`` for the identity
    codec, else a ``+``-joined subset of ``delta``, ``topk:<frac>``,
    ``fp16``/``bf16`` in any order. ``topk`` implies ``delta``.
    """

    def __init__(self, spec: str | None = None):
        self.delta = False
        self.topk_frac: float | None = None
        self.quant: str | None = None  # wire dtype name or None
        raw = (spec or "none").strip().lower()
        if raw not in ("none", "identity"):
            for stage in raw.split("+"):
                stage = stage.strip()
                if stage == "delta":
                    self.delta = True
                elif stage.startswith("topk:"):
                    frac = float(stage.split(":", 1)[1])
                    if not 0.0 < frac <= 1.0:
                        raise ValueError(
                            f"topk fraction must be in (0, 1], got {frac}"
                        )
                    self.topk_frac = frac
                elif stage in _QUANT_DTYPES:
                    if self.quant is not None:
                        raise ValueError(f"duplicate quantize stage in {raw!r}")
                    self.quant = _QUANT_DTYPES[stage]
                else:
                    raise ValueError(
                        f"unknown codec stage {stage!r} in {raw!r} "
                        "(want delta, topk:<frac>, fp16, bf16)"
                    )
            if self.topk_frac is not None:
                self.delta = True  # top-k without a base zeroes the model

    @property
    def codec_id(self) -> str:
        """Canonical spec string — the value negotiated on the wire."""
        stages = []
        if self.delta:
            stages.append("delta")
        if self.topk_frac is not None:
            stages.append(f"topk:{self.topk_frac:g}")
        if self.quant is not None:
            stages.append("fp16" if self.quant == "float16" else "bf16")
        return "+".join(stages) or "none"

    @property
    def identity(self) -> bool:
        return not (self.delta or self.topk_frac is not None or self.quant)

    @property
    def lossy(self) -> bool:
        return self.topk_frac is not None or self.quant is not None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"WireCodec({self.codec_id!r})"


def make_codec(spec: "str | WireCodec | None") -> WireCodec:
    return spec if isinstance(spec, WireCodec) else WireCodec(spec)


def _compressible(arr: np.ndarray) -> bool:
    """Lossy/delta stages apply to non-empty float tensors only."""
    return arr.dtype.kind == "f" and arr.size > 0


def _note_eviction(
    metrics, direction: str, evicted_round: int, now_round: int
) -> None:
    """Reference-cache eviction telemetry: cumulative
    eviction counter, the age (in rounds) of the view just evicted — a
    rising age means the cache is cycling faster than the fleet rotates —
    and one JSONL event per eviction (bounded at one per push round)."""
    age = max(0, int(now_round) - int(evicted_round))
    if metrics is not None:
        metrics.registry.counter("codec_refs_evicted").inc()
        metrics.registry.gauge(
            f"codec_ref_evicted_age_rounds/{direction}"
        ).set(age)
        metrics.log(
            "codec_ref_evicted", direction=direction,
            round=int(evicted_round), age=age,
        )


def _note_wire(metrics, op: str, raw_bytes: int, wire_bytes: int) -> None:
    """Registry-only wire telemetry: cumulative raw-vs-compressed bytes and
    the running compression ratio (``compressed_bytes`` + the
    compression-ratio gauge). Per-call JSONL events would dominate the
    stream at one encode/decode per client per round."""
    reg = metrics.registry
    raw_c = reg.counter(f"uncompressed_bytes_{op}")
    cmp_c = reg.counter(f"compressed_bytes_{op}")
    raw_c.inc(raw_bytes)
    cmp_c.inc(wire_bytes)
    reg.counter("compressed_bytes").inc(wire_bytes)
    total_raw = raw_c.value
    total_cmp = cmp_c.value
    if total_cmp > 0:
        reg.gauge(f"compression_ratio_{op}").set(total_raw / total_cmp)


class _Session:
    """Shared encode/decode machinery for one direction of the wire.

    Holds no policy about *which* reference to use — subclasses manage
    reference lifetime (single last-applied aggregate client-side, a small
    round-keyed cache server-side) and whether an error-feedback residual
    is carried.
    """

    def __init__(self, codec_: WireCodec, metrics=None, role: str = ""):
        self.codec = make_codec(codec_)
        self.metrics = metrics
        self.role = role
        self.residual: dict[str, np.ndarray] | None = (
            {} if self.codec.lossy else None
        )

    def reset(self) -> None:
        """Forget every delta reference and error-feedback residual this
        session carries — the divergence-rollback path (README "Robust
        aggregation & divergence recovery"): after the server restores a
        checkpointed round, references derived from the diverged trajectory
        must not be decoded (or deltaed) against, and residuals holding
        un-delivered diverged mass must not be re-injected into the
        restored state. The next encode after a reset is self-contained."""
        if self.residual is not None:
            self.residual = {}
        if self.metrics is not None:
            self.metrics.registry.counter("codec_resets").inc()

    # ---- encode ------------------------------------------------------------
    def _encode(
        self,
        tensors: Mapping[str, np.ndarray],
        reference: "dict[str, np.ndarray] | None",
        ref_round: int,
    ) -> tuple[pb.TensorBundle, dict[str, np.ndarray]]:
        """Encode ``tensors`` into a bundle; returns ``(bundle, view)``
        where ``view`` is exactly what the decoder will reconstruct (the
        residual bookkeeping and reference chains are built from it)."""
        c = self.codec
        t0 = time.perf_counter() if self.metrics is not None else 0.0
        use_delta = c.delta and reference is not None
        records = []
        view: dict[str, np.ndarray] = {}
        raw_bytes = 0
        for name in sorted(tensors):
            arr = np.asarray(tensors[name])
            raw_bytes += arr.nbytes
            if not _compressible(arr) or c.identity:
                records.append(codec.array_to_record(name, arr))
                view[name] = arr
                continue
            base = None
            if use_delta:
                if name not in reference:
                    raise CodecError(
                        f"delta encode: no reference for tensor {name!r}"
                    )
                base = np.asarray(reference[name])
            d = (arr - base) if base is not None else arr
            if self.residual is not None:
                prev = self.residual.get(name)
                if prev is not None:
                    d = d + prev
            # Top-k is only meaningful on *deltas* — sparsifying raw
            # parameters (first round, or a push to a not-yet-synced
            # fleet) would zero most of the model. Without a base the
            # tensor ships dense (still quantized).
            rec, recon_d = self._compress_values(
                name, arr, d, sparse_ok=base is not None
            )
            if self.residual is not None:
                self.residual[name] = d - recon_d
            records.append(rec)
            view[name] = (
                (base + recon_d) if base is not None else recon_d
            ).astype(arr.dtype)
        bundle = pb.TensorBundle(
            tensors=records,
            # proto3 cannot distinguish 0 from unset, so the wire carries
            # round + 1; 0 means "self-contained bundle".
            ref_round=(ref_round + 1) if use_delta else 0,
        )
        if self.metrics is not None:
            self.metrics.registry.histogram(
                f"wire_encode_s/{self.role or 'wire'}"
            ).observe(time.perf_counter() - t0)
            _note_wire(self.metrics, "sent", raw_bytes, bundle.ByteSize())
        return bundle, view

    def _compress_values(
        self, name: str, arr: np.ndarray, d: np.ndarray,
        sparse_ok: bool = True,
    ) -> tuple[pb.TensorRecord, np.ndarray]:
        """Top-k select + quantize the (delta) values ``d``; returns the
        wire record and the dense reconstruction the decoder will see."""
        c = self.codec
        flat = np.ascontiguousarray(d).reshape(-1)
        wire_dtype = c.quant  # None = ship at logical dtype
        if sparse_ok and c.topk_frac is not None and c.topk_frac < 1.0:
            k = max(1, math.ceil(c.topk_frac * flat.size))
            if k < flat.size:
                idx = np.argpartition(np.abs(flat), flat.size - k)[-k:]
            else:
                idx = np.arange(flat.size)
            idx = np.sort(idx).astype(np.uint32)
            values = flat[idx]
            if wire_dtype is not None:
                values = values.astype(codec.np_dtype(wire_dtype))
            recon_flat = np.zeros_like(flat)
            recon_flat[idx] = values.astype(flat.dtype)
            rec = pb.TensorRecord(
                name=name, shape=list(arr.shape), dtype=arr.dtype.name,
                codec="topk", data=values.tobytes(), aux=idx.tobytes(),
                wire_dtype=wire_dtype or "",
            )
            return rec, recon_flat.reshape(d.shape)
        values = flat
        if wire_dtype is not None:
            values = values.astype(codec.np_dtype(wire_dtype))
        recon = values.astype(flat.dtype).reshape(d.shape)
        rec = pb.TensorRecord(
            name=name, shape=list(arr.shape), dtype=arr.dtype.name,
            codec="dense", data=values.tobytes(),
            wire_dtype=wire_dtype or "",
        )
        return rec, recon

    # ---- decode ------------------------------------------------------------
    def _decode(
        self,
        bundle: pb.TensorBundle,
        reference: "dict[str, np.ndarray] | None",
    ) -> dict[str, np.ndarray]:
        t0 = time.perf_counter() if self.metrics is not None else 0.0
        delta_bundle = bundle.ref_round > 0
        if delta_bundle and reference is None:
            raise ReferenceMismatch(
                f"bundle references broadcast round {bundle.ref_round - 1} "
                "but this endpoint holds no such reference"
            )
        out: dict[str, np.ndarray] = {}
        raw_bytes = 0
        for rec in bundle.tensors:
            if rec.codec in ("", "raw"):
                arr = codec.record_to_array(rec)
            elif rec.codec == "sparse_set":
                # Catch-up assignment record (per-recipient push encoding):
                # copy the reference tensor and OVERWRITE the listed
                # entries with the shipped values — bit-exact convergence
                # onto the canonical view (an additive float delta would
                # round). Only legal inside a delta bundle.
                if not delta_bundle:
                    raise CodecError(
                        f"sparse_set record {rec.name!r} outside a delta "
                        "bundle"
                    )
                base = reference.get(rec.name)
                if base is None:
                    raise ReferenceMismatch(
                        f"catch-up bundle tensor {rec.name!r} has no "
                        "reference entry"
                    )
                arr = self._apply_sparse_set(rec, np.asarray(base))
            elif rec.codec in ("dense", "topk"):
                arr = self._decode_values(rec)
                if delta_bundle:
                    base = reference.get(rec.name)
                    if base is None:
                        raise ReferenceMismatch(
                            f"delta bundle tensor {rec.name!r} has no "
                            "reference entry"
                        )
                    arr = (np.asarray(base) + arr).astype(arr.dtype)
            else:
                raise CodecError(
                    f"unknown record codec {rec.codec!r} for {rec.name!r}"
                )
            out[rec.name] = arr
            raw_bytes += arr.nbytes
        if self.metrics is not None:
            self.metrics.registry.histogram(
                f"wire_decode_s/{self.role or 'wire'}"
            ).observe(time.perf_counter() - t0)
            _note_wire(self.metrics, "recv", raw_bytes, bundle.ByteSize())
        return out

    @staticmethod
    def _apply_sparse_set(rec: pb.TensorRecord, base: np.ndarray) -> np.ndarray:
        """Decode one ``sparse_set`` record onto its reference tensor."""
        if rec.dtype not in codec.ALLOWED_DTYPES:
            raise CodecError(f"dtype {rec.dtype!r} not allowed on the wire")
        if rec.wire_dtype:
            raise CodecError(
                f"sparse_set record {rec.name!r} must ship logical-dtype "
                "values (exact reconstruction)"
            )
        values = np.frombuffer(rec.data, dtype=codec.np_dtype(rec.dtype))
        idx = np.frombuffer(rec.aux, dtype=np.uint32)
        if idx.size != values.size:
            raise CodecError(
                f"sparse_set record {rec.name!r}: {idx.size} indices for "
                f"{values.size} values"
            )
        shape = tuple(rec.shape)
        if tuple(base.shape) != shape:
            raise CodecError(
                f"sparse_set record {rec.name!r}: reference shape "
                f"{tuple(base.shape)} != record shape {shape}"
            )
        numel = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if idx.size and int(idx.max()) >= numel:
            raise CodecError(
                f"sparse_set record {rec.name!r}: index {int(idx.max())} "
                f"out of range for {numel} elements"
            )
        out = np.array(base, dtype=codec.np_dtype(rec.dtype), copy=True)
        flat = out.reshape(-1)
        flat[idx] = values
        return out

    @staticmethod
    def _decode_values(rec: pb.TensorRecord) -> np.ndarray:
        if rec.dtype not in codec.ALLOWED_DTYPES:
            raise CodecError(f"dtype {rec.dtype!r} not allowed on the wire")
        wire = rec.wire_dtype or rec.dtype
        if wire not in codec.WIRE_DTYPES:
            raise CodecError(f"wire dtype {wire!r} not allowed on the wire")
        values = np.frombuffer(rec.data, dtype=codec.np_dtype(wire))
        values = values.astype(codec.np_dtype(rec.dtype))
        shape = tuple(rec.shape)
        if rec.codec == "dense":
            return values.reshape(shape)
        idx = np.frombuffer(rec.aux, dtype=np.uint32)
        if idx.size != values.size:
            raise CodecError(
                f"topk record {rec.name!r}: {idx.size} indices for "
                f"{values.size} values"
            )
        numel = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if idx.size and int(idx.max()) >= numel:
            raise CodecError(
                f"topk record {rec.name!r}: index {int(idx.max())} out of "
                f"range for {numel} elements"
            )
        dense = np.zeros(numel, dtype=values.dtype)
        dense[idx] = values
        return dense.reshape(shape)


class UplinkEncoder(_Session):
    """Client side of the StepReply path: encodes post-step snapshots
    relative to the last *applied* aggregate, carrying the error-feedback
    residual across rounds."""

    def __init__(self, codec_: WireCodec, metrics=None, role: str = "uplink"):
        super().__init__(codec_, metrics=metrics, role=role)
        self._ref: dict[str, np.ndarray] | None = None
        self._ref_round = -1

    def reset(self) -> None:
        """Drop the applied-aggregate reference AND the error-feedback
        residual (a rollback re-broadcast's ``reset_session``): the next
        snapshot is encoded self-contained and carries no mass from the
        discarded trajectory."""
        self._ref = None
        self._ref_round = -1
        super().reset()

    def note_aggregate(
        self, tensors: Mapping[str, np.ndarray], round_idx: int
    ) -> None:
        """Record the aggregate this client just applied — the reference the
        next snapshot is delta-encoded against."""
        if self.codec.delta:
            self._ref = {k: np.asarray(v) for k, v in tensors.items()}
            self._ref_round = int(round_idx)

    def encode(self, snapshot: Mapping[str, np.ndarray]) -> pb.TensorBundle:
        bundle, _view = self._encode(snapshot, self._ref, self._ref_round)
        return bundle


class UplinkDecoder(_Session):
    """Server side of the StepReply path. Keeps a small round-keyed cache of
    *client-held views* of recent broadcasts (what :class:`DownlinkEncoder`
    reports each push reconstructs to), so a client whose last push was one
    or two rounds stale still decodes; anything older raises
    :class:`ReferenceMismatch` — loud, and healed by the next push."""

    def __init__(self, codec_: WireCodec, metrics=None, max_refs: int = 8,
                 role: str = "uplink"):
        super().__init__(codec_, metrics=metrics, role=role)
        self.max_refs = int(max_refs)
        self._refs: "OrderedDict[int, dict[str, np.ndarray]]" = OrderedDict()
        self.residual = None  # decode side carries no residual

    def note_push(
        self, round_idx: int, client_view: Mapping[str, np.ndarray]
    ) -> None:
        if not self.codec.delta:
            return
        self._refs[int(round_idx)] = dict(client_view)
        while len(self._refs) > self.max_refs:
            evicted_round, _view = self._refs.popitem(last=False)
            # Bounded-cache eviction: an uplink that
            # still deltas against this round will raise a loud
            # ReferenceMismatch (codec_ref_miss) and heal on its next
            # push — degraded, never a mis-decode.
            _note_eviction(
                self.metrics, "uplink", evicted_round, round_idx
            )

    def reset(self) -> None:
        """Drop the whole broadcast-view cache (divergence rollback): an
        uplink deltaed against a pre-rollback broadcast now raises
        :class:`ReferenceMismatch` — loud, and healed by the rolled-back
        re-broadcast."""
        self._refs.clear()
        super().reset()

    def decode(self, bundle: pb.TensorBundle) -> dict[str, np.ndarray]:
        reference = None
        if bundle.ref_round > 0:
            reference = self._refs.get(bundle.ref_round - 1)
            if reference is None:
                raise ReferenceMismatch(
                    f"no cached broadcast view for round "
                    f"{bundle.ref_round - 1} (cache holds "
                    f"{sorted(self._refs)})"
                )
        return self._decode(bundle, reference)


class DownlinkEncoder(_Session):
    """Server side of the Aggregate push path.

    Maintains the **canonical view chain**: each :meth:`advance` encodes
    the round's aggregate as a delta against the previous canonical view
    (the EF residual carries any lossy-stage mass forward), caches the
    reconstruction view in a bounded round-keyed LRU, and
    :meth:`bundle_for` then serves *per-recipient* bundles — the shared
    canonical chain bundle for up-to-date recipients, exact catch-up
    bundles for recipients holding an older cached view, and a
    self-contained view bundle when no usable reference exists (README
    "Hierarchical federation & wire efficiency"). The legacy
    :meth:`encode` (fleet-consensus ``allow_delta``) remains for
    single-stream callers."""

    def __init__(self, codec_: WireCodec, metrics=None,
                 role: str = "downlink", max_views: int = 8):
        super().__init__(codec_, metrics=metrics, role=role)
        self._last_view: dict[str, np.ndarray] | None = None
        self._last_round = -1
        self.max_views = int(max_views)
        # Canonical client views by round (bounded LRU) + this round's
        # chain bundle. The view dicts are shared by reference with the
        # uplink decoder's cache — one copy of each round's tensors.
        self._views: "OrderedDict[int, dict[str, np.ndarray]]" = OrderedDict()
        self._canonical: pb.TensorBundle | None = None
        # Served-bundle memo for the CURRENT round, keyed by acked_round
        # (-1 = the self-contained view bundle). bundle_for runs under
        # the server's codec lock with one call per concurrent pusher —
        # without this, N stale recipients cost N identical O(model)
        # encodes serialized on that lock.
        self._served: dict[int, pb.TensorBundle] = {}

    def reset(self) -> None:
        """Forget the last broadcast view AND the whole canonical view
        cache (divergence rollback): the next push is encoded
        self-contained regardless of what any recipient claims to hold."""
        self._last_view = None
        self._last_round = -1
        self._views.clear()
        self._canonical = None
        self._served.clear()
        super().reset()

    @property
    def last_round(self) -> int:
        """Round of the broadcast a delta push would reference (-1 =
        none yet). Under cohort/async pacing recipients hold broadcasts
        of different rounds, so the server's ``allow_delta`` check
        compares each recipient's last-acked round to THIS — not merely
        membership in an acked set."""
        return self._last_round

    def encode(
        self,
        average: Mapping[str, np.ndarray],
        round_idx: int,
        allow_delta: bool = False,
    ) -> tuple[pb.TensorBundle, dict[str, np.ndarray]]:
        """Returns ``(bundle, client_view)`` — feed ``client_view`` to
        :meth:`UplinkDecoder.note_push` (it is the exact tensor set every
        client that applies this push will hold)."""
        reference = self._last_view if allow_delta else None
        ref_round = self._last_round if allow_delta else -1
        bundle, view = self._encode(average, reference, ref_round)
        self._note_view(view, int(round_idx))
        self._canonical = bundle
        return bundle, view

    def advance(
        self, average: Mapping[str, np.ndarray], round_idx: int
    ) -> tuple[pb.TensorBundle, dict[str, np.ndarray]]:
        """Advance the canonical view chain one round: encode ``average``
        as a delta against the previous canonical view whenever one exists
        (self-contained otherwise — first round, or after :meth:`reset`),
        cache the reconstruction view, and return ``(chain_bundle, view)``.
        Call once per pushed round, then :meth:`bundle_for` per
        recipient."""
        bundle, view = self._encode(
            average, self._last_view, self._last_round
        )
        self._note_view(view, int(round_idx))
        self._canonical = bundle
        return bundle, view

    def _note_view(self, view: dict[str, np.ndarray], round_idx: int) -> None:
        self._last_view = view
        self._last_round = round_idx
        self._served.clear()  # memoized bundles describe the prior round
        if not self.codec.delta:
            return
        self._views[round_idx] = view
        while len(self._views) > max(1, self.max_views):
            evicted_round, _view = self._views.popitem(last=False)
            # A recipient still holding this round falls back to a
            # self-contained view bundle on its next push (degraded
            # compression, not an error).
            _note_eviction(
                self.metrics, "downlink", evicted_round, round_idx
            )

    def bundle_for(self, acked_round: "int | None") -> pb.TensorBundle:
        """The push bundle for one recipient, keyed by the round of the
        last broadcast that recipient acked (``None`` = no reference).
        Must follow an :meth:`advance` for the current round.

        - the chain bundle is self-contained → everyone shares it;
        - ``acked_round`` is the chain bundle's own reference → the shared
          chain bundle;
        - ``acked_round`` still cached → an exact catch-up bundle onto the
          canonical view;
        - otherwise (never acked, or evicted) → a self-contained view
          bundle."""
        if self._canonical is None or self._last_view is None:
            raise CodecError("bundle_for before the first advance()")
        chain_ref = int(self._canonical.ref_round) - 1  # -1 = self-contained
        if chain_ref < 0:
            return self._canonical
        if acked_round is not None and int(acked_round) == chain_ref:
            return self._canonical
        if acked_round is not None and int(acked_round) in self._views:
            key = int(acked_round)
            if key not in self._served:
                self._served[key] = self._catchup_bundle(key)
            return self._served[key]
        if -1 not in self._served:
            self._served[-1] = self._view_bundle()
        return self._served[-1]

    def _catchup_bundle(self, acked_round: int) -> pb.TensorBundle:
        """Exact catch-up onto the canonical view for a recipient holding
        the cached view of ``acked_round``: per float tensor, the entries
        that changed since then as ``sparse_set`` assignment records
        (uint32 indices + logical-dtype values — bit-exact, see
        :meth:`_Session._apply_sparse_set`), falling back to a raw dense
        record when the change is too dense for sparse framing to win."""
        t0 = time.perf_counter() if self.metrics is not None else 0.0
        old = self._views[acked_round]
        records = []
        raw_bytes = 0
        for name in sorted(self._last_view):
            arr = np.asarray(self._last_view[name])
            raw_bytes += arr.nbytes
            base = old.get(name)
            if (
                not _compressible(arr) or base is None
                or np.asarray(base).shape != arr.shape
            ):
                records.append(codec.array_to_record(name, arr))
                continue
            flat = np.ascontiguousarray(arr).reshape(-1)
            base_flat = np.ascontiguousarray(np.asarray(base)).reshape(-1)
            idx = np.flatnonzero(flat != base_flat)
            sparse_bytes = idx.size * (4 + arr.dtype.itemsize)
            if sparse_bytes >= flat.size * arr.dtype.itemsize:
                records.append(codec.array_to_record(name, arr))
                continue
            idx32 = idx.astype(np.uint32)
            records.append(pb.TensorRecord(
                name=name, shape=list(arr.shape), dtype=arr.dtype.name,
                codec="sparse_set", data=flat[idx].tobytes(),
                aux=idx32.tobytes(),
            ))
        bundle = pb.TensorBundle(
            tensors=records, ref_round=acked_round + 1
        )
        if self.metrics is not None:
            self.metrics.registry.counter("codec_catchup_pushes").inc()
            self.metrics.registry.histogram(
                f"wire_encode_s/{self.role or 'wire'}"
            ).observe(time.perf_counter() - t0)
            _note_wire(self.metrics, "sent", raw_bytes, bundle.ByteSize())
        return bundle

    def _view_bundle(self) -> pb.TensorBundle:
        """Self-contained raw encoding of the canonical view — the bounded
        fallback when a recipient has no usable reference. Raw records are
        exact by construction, so the recipient still converges onto the
        canonical view and its future uplinks decode against the shared
        round-keyed cache."""
        t0 = time.perf_counter() if self.metrics is not None else 0.0
        records = [
            codec.array_to_record(name, np.asarray(self._last_view[name]))
            for name in sorted(self._last_view)
        ]
        bundle = pb.TensorBundle(tensors=records, ref_round=0)
        if self.metrics is not None:
            raw = sum(
                np.asarray(v).nbytes for v in self._last_view.values()
            )
            self.metrics.registry.counter("codec_selfcontained_pushes").inc()
            self.metrics.registry.histogram(
                f"wire_encode_s/{self.role or 'wire'}"
            ).observe(time.perf_counter() - t0)
            _note_wire(self.metrics, "sent", raw, bundle.ByteSize())
        return bundle


class DownlinkDecoder(_Session):
    """Client side of the Aggregate push path: holds the single last-applied
    broadcast view as the delta reference."""

    def __init__(self, codec_: WireCodec, metrics=None,
                 role: str = "downlink"):
        super().__init__(codec_, metrics=metrics, role=role)
        self._ref: dict[str, np.ndarray] | None = None
        self._ref_round = -1
        self.residual = None

    def reset(self) -> None:
        """Drop the last-applied broadcast reference (a rollback
        re-broadcast's ``reset_session``); the incoming push must then be
        self-contained."""
        self._ref = None
        self._ref_round = -1
        super().reset()

    def decode(
        self, bundle: pb.TensorBundle, round_idx: int
    ) -> dict[str, np.ndarray]:
        if bundle.ref_round > 0 and bundle.ref_round - 1 != self._ref_round:
            raise ReferenceMismatch(
                f"push deltas against broadcast round {bundle.ref_round - 1} "
                f"but this client last applied round {self._ref_round}"
            )
        out = self._decode(
            bundle, self._ref if bundle.ref_round > 0 else None
        )
        if self.codec.delta:
            self._ref = dict(out)
            self._ref_round = int(round_idx)
        return out


def encode_push_for_recipients(
    downlink_enc: "DownlinkEncoder | None",
    uplink_dec: "UplinkDecoder | None",
    average: "Mapping[str, np.ndarray]",
    round_idx: int,
    recipients: "list[int]",
    acked: "Mapping[int, int]",
    reset: bool,
    metrics: Any = None,
) -> "dict[int, pb.Aggregate]":
    """One round's push encoded **per recipient** (README "Hierarchical
    federation & wire efficiency"): advance the canonical view chain
    once, then serve each recipient the bundle matched to its own
    last-acked reference — the shared chain bundle when up to date, a
    catch-up bundle for an older cached view, a self-contained view
    bundle when it holds nothing usable. Recipients sharing a reference
    share one encoded bundle, so encode cost is O(distinct references),
    not O(cohort). ``downlink_enc=None`` is the identity-codec path: one
    raw bundle for everyone.

    This is the ONE implementation of the reference/reset rules, shared
    by ``FederatedServer._encode_push`` and
    ``RelayNode._fanout_aggregate`` — the two tiers must not drift. The
    caller holds whatever lock guards the codec sessions."""
    if downlink_enc is None:
        agg = pb.Aggregate(
            shared=codec.flatdict_to_bundle(average, metrics=metrics),
            round=round_idx, reset_session=reset,
        )
        return {cid: agg for cid in recipients}
    _bundle, view = downlink_enc.advance(average, round_idx=round_idx)
    if uplink_dec is not None:
        uplink_dec.note_push(round_idx, view)
    out: dict[int, pb.Aggregate] = {}
    by_ref: "dict[int | None, pb.Aggregate]" = {}
    for cid in recipients:
        # A session reset deliberately severs every reference chain: the
        # recipient drops its codec state before applying, so its bundle
        # must not assume one.
        ref = None if reset else acked.get(cid)
        agg = by_ref.get(ref)
        if agg is None:
            agg = pb.Aggregate(
                shared=downlink_enc.bundle_for(ref),
                round=round_idx, reset_session=reset,
            )
            by_ref[ref] = agg
        out[cid] = agg
    return out
