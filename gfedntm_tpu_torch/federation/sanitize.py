"""Update admission gate: the data-plane trust boundary of the federation.

A copy of ``gfedntm_tpu/federation/sanitize.py`` (numpy; the device branch
over the port's :class:`~gfedntm_tpu_torch.federation.device_agg.DeviceAggEngine`),
its imports rewritten to ``gfedntm_tpu_torch``;
``tests/test_torch_data_plane.py`` holds its decisions, norms and clipped
snapshots to the original's, bitwise.

:class:`UpdateGate` screens every decoded client snapshot before it can
enter the aggregate step:

1. **conformance** — key set, per-tensor shape AND dtype must match the
   server's shared template;
2. **finiteness** — every tensor must be NaN/Inf-free;
3. **norm screening** — the update norm ``||snapshot - current_global||``
   is tested against the round cohort's ``median + k * MAD`` (a robust
   outlier test that needs no tuning against absolute scales), and
   optionally hard-clipped to ``max_update_norm`` (gradient-clipping
   semantics: the direction is kept, the influence is bounded).

Rejected updates are excluded from the average, logged as
``update_rejected`` telemetry events with a machine-readable reason code,
and counted per client; ``consecutive(client)`` lets the server feed
repeat offenders into the probation machinery
(``Federation.mark_suspect(reason="poisoned")``) so a persistently
poisonous client is backed off and eventually dropped exactly like a
persistently unreachable one. :func:`decode_and_admit` is the one
decode-and-gate pipeline of a round's replies.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch

from gfedntm_tpu_torch.utils import flightrec

__all__ = ["Rejection", "GateResult", "UpdateGate", "update_norm"]

# Reason codes (the `update_rejected` event's `reason` field vocabulary).
KEY_SKEW = "key_skew"
SHAPE_SKEW = "shape_skew"
DTYPE_SKEW = "dtype_skew"
NONFINITE = "nonfinite"
NORM_OUTLIER = "norm_outlier"

#: MAD → sigma for normally distributed data (the usual robust-scale
#: consistency constant).
_MAD_SIGMA = 1.4826


def update_norm(
    snapshot: Mapping[str, np.ndarray],
    reference: Mapping[str, np.ndarray],
) -> float:
    """Global L2 norm of ``snapshot - reference`` over the shared subset
    (float64 accumulation — a poisoned float32 update can overflow a
    same-dtype square)."""
    total = 0.0
    for key, value in snapshot.items():
        d = (
            np.asarray(value, np.float64)
            - np.asarray(reference[key], np.float64)
        )
        total += float(np.dot(d.ravel(), d.ravel()))
    return float(np.sqrt(total))


@dataclass
class Rejection:
    """One gated-out update: who, why, and with what norm (NaN when the
    rejection happened before the norm stage)."""

    client_id: int
    reason: str
    detail: str
    norm: float = float("nan")


@dataclass
class GateResult:
    """Outcome of one round's admission pass.

    ``stacked`` is only set by the device backend (see
    :meth:`UpdateGate.set_engine`): the accepted cohort as a
    ``device_agg.StackedRound`` — clip already applied on the plane — for
    the aggregator to consume without ever round-tripping through
    per-key host dicts."""

    accepted: list  # [(client_id, weight, snapshot)]
    rejected: list  # [Rejection]
    clipped: list  # [(client_id, norm, max_norm)]
    stacked: Any = None


class UpdateGate:
    """Per-round admission screening of decoded client snapshots.

    ``mad_k <= 0`` disables the cohort outlier test; ``max_update_norm``
    ``None`` disables the hard clip; ``check_finite=False`` turns the gate
    into a pure conformance check (used by tests that need to demonstrate
    unprotected poisoning). The MAD test only
    runs on cohorts of at least ``min_cohort`` candidates: a median over
    one or two updates is not a statistic.
    """

    def __init__(
        self,
        *,
        check_finite: bool = True,
        mad_k: float = 4.0,
        mad_rel_floor: float = 0.5,
        max_update_norm: float | None = None,
        min_cohort: int = 3,
        suspect_after: int = 2,
        metrics: Any = None,
        logger: logging.Logger | None = None,
    ):
        if mad_rel_floor < 0:
            raise ValueError(
                f"mad_rel_floor must be >= 0, got {mad_rel_floor}"
            )
        if max_update_norm is not None and max_update_norm <= 0:
            raise ValueError(
                f"max_update_norm must be > 0, got {max_update_norm}"
            )
        if suspect_after < 1:
            raise ValueError(
                f"suspect_after must be >= 1, got {suspect_after}"
            )
        self.check_finite = bool(check_finite)
        self.mad_k = float(mad_k)
        # Scale floor as a fraction of the median norm: with a tiny cohort
        # the MAD collapses toward 0 and every deviation would read as an
        # outlier; the floor keeps the rejection threshold at least
        # (1 + mad_k * mad_rel_floor) x the median.
        self.mad_rel_floor = float(mad_rel_floor)
        self.max_update_norm = (
            None if max_update_norm is None else float(max_update_norm)
        )
        self.min_cohort = int(min_cohort)
        self.suspect_after = int(suspect_after)
        self.metrics = metrics
        self.logger = logger or logging.getLogger("UpdateGate")
        self._expected_keys: frozenset[str] | None = None
        self._expected_shapes: dict[str, tuple] = {}
        self._expected_dtypes: dict[str, np.dtype] = {}
        # Device-resident backend: when an engine is attached,
        # finiteness/norms/clip run on the stacked cohort on the server's
        # device instead of host numpy per tensor. Decisions are identical
        # by contract (tests/test_torch_data_plane.py).
        self._engine: Any = None
        self._template: dict[str, np.ndarray] | None = None
        self._plane: Any = None
        # Consecutive rejection streak per client (reset on acceptance):
        # the "repeated offender" signal the server feeds into probation.
        self._streak: dict[int, int] = {}
        self.total_rejections: dict[int, int] = {}

    # ---- template ----------------------------------------------------------
    def set_template(self, template: Mapping[str, np.ndarray]) -> None:
        """Pin the authoritative key/shape/dtype contract (the server's
        shared template subset)."""
        self._expected_keys = frozenset(template)
        self._expected_shapes = {
            k: tuple(np.asarray(v).shape) for k, v in template.items()
        }
        self._expected_dtypes = {
            k: np.asarray(v).dtype for k, v in template.items()
        }
        self._template = {k: np.asarray(v) for k, v in template.items()}
        self._plane = None  # re-derived lazily from the new template

    def set_engine(self, engine: Any) -> None:
        """Attach a ``device_agg.DeviceAggEngine``: subsequent rounds run
        the data plane (finiteness, norms, clip) on its device and hand the
        aggregator a stacked cohort (``GateResult.stacked``). ``None``
        restores the pure-numpy path."""
        self._engine = engine

    def consecutive(self, client_id: int) -> int:
        """Current consecutive-rejection streak for one client."""
        return self._streak.get(client_id, 0)

    # ---- per-candidate checks ----------------------------------------------
    def _conformance(self, client_id: int, snap: Mapping) -> Rejection | None:
        if self._expected_keys is None:
            return None
        if frozenset(snap) != self._expected_keys:
            missing = sorted(self._expected_keys - set(snap))[:3]
            unexpected = sorted(set(snap) - self._expected_keys)[:3]
            return Rejection(
                client_id, KEY_SKEW,
                f"missing={missing}, unexpected={unexpected}",
            )
        for key in snap:
            arr = np.asarray(snap[key])
            want = self._expected_shapes[key]
            if tuple(arr.shape) != want:
                return Rejection(
                    client_id, SHAPE_SKEW,
                    f"{key}: {tuple(arr.shape)} != {want}",
                )
            if arr.dtype != self._expected_dtypes[key]:
                return Rejection(
                    client_id, DTYPE_SKEW,
                    f"{key}: {arr.dtype} != {self._expected_dtypes[key]}",
                )
        return None

    @staticmethod
    def _nonfinite(client_id: int, snap: Mapping) -> Rejection | None:
        for key in sorted(snap):
            arr = np.asarray(snap[key])
            if arr.dtype.kind == "f" and not np.all(np.isfinite(arr)):
                bad = int(arr.size - np.isfinite(arr).sum())
                return Rejection(
                    client_id, NONFINITE,
                    f"{key}: {bad}/{arr.size} non-finite values",
                )
        return None

    def _outlier_threshold(self, norms: list[float]) -> float | None:
        """The cohort's rejection threshold, or None when the MAD test
        cannot run (disabled, or cohort too small)."""
        if self.mad_k <= 0 or len(norms) < self.min_cohort:
            return None
        arr = np.asarray(norms, np.float64)
        med = float(np.median(arr))
        mad = float(np.median(np.abs(arr - med)))
        scale = max(_MAD_SIGMA * mad, self.mad_rel_floor * med, 1e-12)
        return med + self.mad_k * scale

    # ---- the round pass ----------------------------------------------------
    @staticmethod
    def _screen_norm(
        norm: float, client_id: int, staleness: "Mapping[int, int] | None"
    ) -> float:
        """The norm the MAD outlier screen judges: raw, divided by
        ``1 + staleness``. Under cohort/async pacing a client steps from
        the broadcast it last applied, so its raw update-vs-current-global
        norm carries the drift of ``s`` intervening aggregations — honest
        stale members would read as outliers against fresh peers. The
        first-order normalization makes the cohort statistics compare
        like with like (the gate's cohort-awareness); with no
        staleness map (sync pacing) the division is by exactly 1.0 and
        decisions are bit-identical to the historical screen. The hard
        clip deliberately still uses the RAW norm — influence on the
        aggregate is bounded in absolute terms no matter how stale the
        update claims to be."""
        if staleness is None:
            return norm
        return norm / (1.0 + max(0, int(staleness.get(client_id, 0))))

    def admit_round(
        self,
        candidates: "list[tuple[int, float, dict[str, np.ndarray]]]",
        current_global: Mapping[str, np.ndarray],
        round_idx: int,
        staleness: "Mapping[int, int] | None" = None,
    ) -> GateResult:
        """Screen one round's ``(client_id, weight, snapshot)`` candidates.

        Order matters: conformance and finiteness run per candidate; norms
        are then computed for the structurally-sound survivors ONLY (a
        shape-skewed or NaN update must not pollute the cohort statistics
        it is judged against); MAD outliers are rejected on staleness-
        normalized norms (see :meth:`_screen_norm`; raw norms when no
        ``staleness`` map is given); finally the hard clip bounds whoever
        remains on RAW norms. Telemetry and streak bookkeeping happen
        here so every caller gets identical accounting.

        With a device engine attached (:meth:`set_engine`) the same pass
        runs on the stacked device plane — identical decisions, and the
        result additionally carries ``stacked`` for the device-resident
        aggregator.
        """
        if self._engine is not None and self._template is not None:
            return self._admit_round_device(
                candidates, current_global, round_idx, staleness
            )
        rejected: list[Rejection] = []
        clipped: list[tuple[int, float, float]] = []
        sound: list[tuple[int, float, dict, float]] = []
        for client_id, weight, snap in candidates:
            rej = self._conformance(client_id, snap)
            if rej is None and self.check_finite:
                rej = self._nonfinite(client_id, snap)
            if rej is not None:
                rejected.append(rej)
                continue
            norm = (
                update_norm(snap, current_global)
                if (self.mad_k > 0 or self.max_update_norm is not None)
                and self.check_finite
                else float("nan")
            )
            sound.append((client_id, weight, snap, norm))

        threshold = self._outlier_threshold([
            self._screen_norm(n, c, staleness)
            for c, _w, _s, n in sound if np.isfinite(n)
        ])
        accepted: list[tuple[int, float, dict]] = []
        for client_id, weight, snap, norm in sound:
            screen = self._screen_norm(norm, client_id, staleness)
            if threshold is not None and screen > threshold:
                rejected.append(Rejection(
                    client_id, NORM_OUTLIER,
                    f"update norm {norm:.3e} (screened {screen:.3e}) > "
                    f"cohort threshold {threshold:.3e}",
                    norm=norm,
                ))
                continue
            if (
                self.max_update_norm is not None
                and np.isfinite(norm) and norm > self.max_update_norm
            ):
                factor = self.max_update_norm / norm
                snap = {
                    k: np.asarray(
                        np.asarray(current_global[k], np.float64)
                        + factor * (
                            np.asarray(v, np.float64)
                            - np.asarray(current_global[k], np.float64)
                        ),
                        dtype=np.asarray(v).dtype,
                    )
                    for k, v in snap.items()
                }
                clipped.append((client_id, norm, self.max_update_norm))
            accepted.append((client_id, weight, snap))

        self._account(accepted, rejected, clipped, round_idx)
        return GateResult(accepted=accepted, rejected=rejected,
                          clipped=clipped)

    def _admit_round_device(
        self,
        candidates: "list[tuple[int, float, dict[str, np.ndarray]]]",
        current_global: Mapping[str, np.ndarray],
        round_idx: int,
        staleness: "Mapping[int, int] | None" = None,
    ) -> GateResult:
        """The admission pass on the device plane: conformance stays host
        metadata work, then the structurally-sound candidates are stacked
        ONCE and the engine computes every row's non-finite count and
        float64 update norm; MAD screening is O(N) host arithmetic over
        those norms; the clip is one more device pass with per-row
        factors. Semantics mirror the numpy branch above
        decision-for-decision (tests/test_torch_data_plane.py pins this);
        a row whose plane norm is not finite though its values are finite
        in their own dtype gets its norm recomputed with the numpy f64
        accumulator on the host, as in the JAX gate."""
        from gfedntm_tpu_torch.federation.device_agg import FlatPlane, StackedRound

        if self._plane is None:
            self._plane = FlatPlane(self._template)
        plane, engine = self._plane, self._engine

        # Phase-1 rejections (conformance + finiteness) are collected with
        # their candidate index and emitted in candidate order — the exact
        # accounting order of the numpy branch, whose single loop
        # interleaves both checks.
        phase1: list[tuple[int, Rejection]] = []
        sound: list[tuple[int, float, dict]] = []
        sound_src: list[int] = []
        for ci, (client_id, weight, snap) in enumerate(candidates):
            rej = self._conformance(client_id, snap)
            if rej is not None:
                phase1.append((ci, rej))
                continue
            sound.append((client_id, weight, snap))
            sound_src.append(ci)

        if not sound:
            rejected = [rej for _ci, rej in phase1]
            self._account([], rejected, [], round_idx)
            return GateResult(accepted=[], rejected=rejected, clipped=[])

        mat = engine.stack(plane, [s for _c, _w, s in sound])
        gvec = engine.put_vector(plane, current_global)
        need_norm = (
            self.mad_k > 0 or self.max_update_norm is not None
        ) and self.check_finite
        if self.check_finite or need_norm:
            counts, norms = engine.gate_stats(mat, gvec)
        else:
            # Gate fully disabled (conformance only): the numpy branch
            # computes nothing here — skip the device pass too.
            counts = np.zeros(len(sound), np.int64)
            norms = np.full(len(sound), np.nan)
        finite_rows: list[int] = []
        for i, (client_id, _w, snap) in enumerate(sound):
            if self.check_finite and counts[i] > 0:
                # The per-key host scan only runs for the (rare) flagged
                # row, to reproduce the numpy rejection detail. A row the
                # host finds finite in its own dtype (values that only
                # overflowed the f32 *plane* — possible for wider-dtype
                # templates) is NOT a numpy-path NONFINITE: let it fall
                # through to the norm stage, where its infinite plane
                # norm rejects it as the documented overflow outlier.
                rej = self._nonfinite(client_id, snap)
                if rej is not None:
                    phase1.append((sound_src[i], rej))
                    continue
            finite_rows.append(i)
        rejected = [rej for _ci, rej in sorted(phase1, key=lambda t: t[0])]
        if need_norm:
            for i in finite_rows:
                # f32 plane overflow (values finite in their own dtype
                # whose squares exceed f32 range): recompute THIS row's
                # norm with the numpy f64 accumulator so the decision —
                # screen, clip, or admit — is exactly the oracle's.
                # Rare path, O(overflowed rows) host work.
                if not np.isfinite(norms[i]):
                    norms[i] = update_norm(sound[i][2], current_global)

        threshold = (
            self._outlier_threshold([
                self._screen_norm(float(norms[i]), sound[i][0], staleness)
                for i in finite_rows if np.isfinite(norms[i])
            ])
            if need_norm else None
        )
        accepted_rows: list[int] = []
        accepted: list[tuple[int, float, dict]] = []
        clipped: list[tuple[int, float, float]] = []
        factors = np.ones(len(sound), np.float32)
        clip_rows: set[int] = set()
        for i in finite_rows:
            client_id, weight, snap = sound[i]
            norm = float(norms[i]) if need_norm else float("nan")
            screen = self._screen_norm(norm, client_id, staleness)
            if threshold is not None and screen > threshold:
                rejected.append(Rejection(
                    client_id, NORM_OUTLIER,
                    f"update norm {norm:.3e} (screened {screen:.3e}) > "
                    f"cohort threshold {threshold:.3e}",
                    norm=norm,
                ))
                continue
            if (
                self.max_update_norm is not None
                and np.isfinite(norm) and norm > self.max_update_norm
            ):
                factors[i] = self.max_update_norm / norm
                clip_rows.add(i)
                clipped.append((client_id, norm, self.max_update_norm))
            accepted_rows.append(i)
            accepted.append((client_id, weight, snap))

        if clip_rows:
            mat = engine.clip(mat, gvec, factors)
            # Keep the host dicts consistent with the clipped plane: the
            # stacked rows are authoritative for the aggregate, but the
            # dicts feed the non-f32 remainder and any numpy fallback.
            # Only the clipped rows round-trip to host.
            for pos, i in enumerate(accepted_rows):
                if i in clip_rows:
                    client_id, weight, _snap = sound[i]
                    row = mat[i].cpu().numpy()
                    accepted[pos] = (
                        client_id, weight, plane.unflatten(row),
                    )

        stacked = None
        if accepted_rows:
            rows = (
                mat if len(accepted_rows) == len(sound)
                else mat[torch.as_tensor(accepted_rows, device=mat.device)]
            )
            stacked = StackedRound(
                engine, plane,
                [w for _c, w, _s in accepted], rows,
                [s for _c, _w, s in accepted],
                gvec=gvec,
            )
        self._account(accepted, rejected, clipped, round_idx)
        return GateResult(accepted=accepted, rejected=rejected,
                          clipped=clipped, stacked=stacked)

    def _account(self, accepted, rejected, clipped, round_idx: int) -> None:
        m = self.metrics
        for client_id, _w, _s in accepted:
            self._streak.pop(client_id, None)
            # Flight-ring context (README "Incident forensics"): the
            # JSONL stream records rejections only; a postmortem needs
            # the full per-client verdict history leading into an
            # incident — acceptances included.
            flightrec.note(
                m, "gate_verdict", client=client_id, round=round_idx,
                verdict="accepted",
            )
        for rej in rejected:
            flightrec.note(
                m, "gate_verdict", client=rej.client_id, round=round_idx,
                verdict="rejected", reason=rej.reason, detail=rej.detail,
            )
            self._streak[rej.client_id] = (
                self._streak.get(rej.client_id, 0) + 1
            )
            self.total_rejections[rej.client_id] = (
                self.total_rejections.get(rej.client_id, 0) + 1
            )
            self.logger.warning(
                "round %d: rejecting client %d update (%s: %s); excluding "
                "it from the average", round_idx, rej.client_id, rej.reason,
                rej.detail,
            )
            if m is not None:
                m.registry.counter("updates_rejected").inc()
                m.registry.counter(f"updates_rejected/{rej.reason}").inc()
                if rej.reason in (KEY_SKEW, SHAPE_SKEW, DTYPE_SKEW):
                    # Historical conformance counter, kept for dashboard
                    # continuity with the earlier skew-skip logic.
                    m.registry.counter("key_skew_excluded").inc()
                event = dict(
                    client=rej.client_id, round=round_idx,
                    reason=rej.reason, detail=rej.detail,
                )
                if np.isfinite(rej.norm):
                    event["norm"] = rej.norm
                m.log("update_rejected", **event)
        for client_id, norm, max_norm in clipped:
            flightrec.note(
                m, "gate_verdict", client=client_id, round=round_idx,
                verdict="clipped", norm=norm, max_norm=max_norm,
            )
            self.logger.warning(
                "round %d: clipping client %d update norm %.3e -> %.3e",
                round_idx, client_id, norm, max_norm,
            )
            if m is not None:
                m.registry.counter("updates_clipped").inc()
                m.log(
                    "update_clipped", client=client_id, round=round_idx,
                    norm=norm, max_norm=max_norm,
                )


def decode_and_admit(
    replies: "list[tuple[Any, Any]]",
    decode: "Any",
    gate: UpdateGate,
    current_global: Mapping[str, np.ndarray],
    round_idx: int,
    *,
    metrics: Any = None,
    was_suspect: frozenset = frozenset(),
    weight_scale: "Mapping[int, float] | None" = None,
    staleness: "Mapping[int, int] | None" = None,
    on_decode_error: "Any",
    on_poisoned: "Any",
    on_recovered: "Any",
) -> "tuple[GateResult, dict[int, float], dict[int, tuple[Any, Any]]]":
    """Decode one round's ``(member_record, StepReply)`` pairs and pass
    them through ``gate`` — the ONE decode-and-gate pipeline shared by the
    root server (``FederatedServer._collect_snapshots``) and the relay
    tier (``RelayNode._train_round``), the uplink twin of
    ``compression.encode_push_for_recipients``: a gate-policy change
    (rejection reasons, staleness normalization, recovery semantics) made
    on one tier MUST apply at the other, or a poisoner behind a relay is
    screened by stale rules.

    Shared here: the decode attempt with ``codec_ref_miss``
    counter/event accounting (a reply the codec cannot decode costs the
    round one contributor, never an error), FedAvg weight assembly
    (``reply.nr_samples`` falling back to the member's join-time corpus
    size, optionally scaled by ``weight_scale`` — the async staleness
    discount), the admission call itself, the repeat-offender screen
    (``gate.consecutive() >= gate.suspect_after``), and admission-scoped
    probation recovery (a ``was_suspect`` member only clears when its
    update is *accepted*). Tier-specific policy stays with the caller via
    the three hooks: ``on_decode_error(rec, err)`` (logging),
    ``on_poisoned(rec, rejection)`` (probation entry), and
    ``on_recovered(client_id)``.

    Returns ``(gate_result, losses_by_id, records_by_id)`` where
    ``records_by_id`` maps member id to its ``(record, reply)`` pair for
    the decodable replies.
    """
    from gfedntm_tpu_torch.federation.compression import CodecError

    records: "dict[int, tuple[Any, Any]]" = {}
    losses: "dict[int, float]" = {}
    candidates: "list[tuple[int, float, dict[str, np.ndarray]]]" = []
    for rec, reply in replies:
        try:
            snap = decode(reply.shared)
        except CodecError as err:
            if metrics is not None:
                metrics.registry.counter("codec_ref_miss").inc()
                metrics.log(
                    "codec_ref_miss", client=rec.client_id,
                    ref_round=int(reply.shared.ref_round) - 1,
                    round=round_idx,
                )
            on_decode_error(rec, err)
            continue
        records[rec.client_id] = (rec, reply)
        losses[rec.client_id] = float(reply.loss)
        weight = float(reply.nr_samples) or rec.nr_samples
        if weight_scale is not None:
            weight *= float(weight_scale.get(rec.client_id, 1.0))
        candidates.append((rec.client_id, weight, snap))

    result = gate.admit_round(
        candidates, current_global, round_idx, staleness=staleness,
    )
    for rej in result.rejected:
        rec, _reply = records[rej.client_id]
        if gate.consecutive(rej.client_id) >= gate.suspect_after:
            on_poisoned(rec, rej)
    for client_id, _w, _s in result.accepted:
        if client_id in was_suspect:
            on_recovered(client_id)
    return result, losses, records
