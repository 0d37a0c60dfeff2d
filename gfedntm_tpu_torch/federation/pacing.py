"""The federation server's round engines: sync, cohort, async and push pacing.

Counterpart of ``gfedntm_tpu/federation/pacing.py``, the server's round
*control plane*:

- :class:`PacingSpec`, :func:`parse_pacing`, :func:`fallback_deadline`
  and the pure pacing math (:func:`inclusion_scale`, :func:`scale_update`,
  :func:`staleness_discount`, :meth:`RoundEngine.clamped_staleness`) are
  copies, pinned bitwise to the JAX functions
  (``tests/test_torch_pacing.py``);
- :class:`RoundEngine` keeps the shared machinery: the bounded poll
  executor, the adaptive per-client poll deadline from the straggler
  detector's EWMAs, one poll, the guardian/quality tail and the
  per-recipient push with its delta-reference bookkeeping;
- :class:`SyncEngine` is the all-clients barrier (JAX ``pacing.py:595-801``):
  poll every eligible client concurrently (each poll carrying the incident
  trigger's capture token, each reply's solicited flight record taken in),
  quorum over the full unfinished membership, the update gate and the
  configured strategy over the admitted replies, the divergence guardian's
  verdict (and its rollback swap), the model-quality step, push to every
  replier, journal the pushed round, the fleet, SLO and privacy tick, and
  checkpoint every ``checkpoint_every`` rounds while the guardian is
  healthy, and once at the end;
- :class:`CohortEngine` (``cohort:K``, :802-913) samples K of the eligible
  clients per round with ``np.random.default_rng((seed, round))``,
  denominates the quorum over the cohort, reweights the admitted mean by
  the inverse inclusion probability (not for robust estimators) and
  reports the live K/eligible as the privacy ledger's q;
- :class:`AsyncEngine` (``async:B``, :914-1163) keeps one poll in flight per
  eligible client and aggregates whenever B updates are buffered, each
  discounted by ``1/(1+s)^alpha`` for its server-clamped staleness s,
  drained in client-id order;
- :class:`PushEngine` (``push:B``, :1164-1372) never polls: clients stream
  ``PushUpdate`` RPCs that the server's servicer buffers (:meth:`PushEngine.submit`),
  the engine drains and aggregates them like FedBuff and advances the
  broadcast chain, and each client picks the round up in its next push's
  reply; a member silent for four poll deadlines is struck into probation.

Shard supervision (``relay_grace_rounds > 0`` on a root whose members are
relays, JAX ``pacing.py:536-556, 618-656``): a shard silent past the grace
leaves the wait for pollable members and the sync quorum's denominator,
with its weight dropped from the HT population estimate, one warning per
expiry and the ``live_shards`` gauge; cohort and async inherit the wait.
Every engine reports each round to the server's round profiler
(``s.profiler.observe``).
"""

from __future__ import annotations

import math
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

import numpy as np

from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb
from gfedntm_tpu_torch.federation.registry import SUSPECT
from gfedntm_tpu_torch.utils import flightrec
from gfedntm_tpu_torch.utils.observability import span, trace_pairs

if TYPE_CHECKING:  # pragma: no cover - typing only
    from gfedntm_tpu_torch.federation.server import FederatedServer

__all__ = [
    "PacingSpec",
    "parse_pacing",
    "fallback_deadline",
    "make_engine",
    "inclusion_scale",
    "scale_update",
    "staleness_discount",
    "RoundEngine",
    "SyncEngine",
    "CohortEngine",
    "AsyncEngine",
    "PushEngine",
]

#: Adaptive poll-deadline constants: never below the floor (an EWMA of
#: milliseconds must not produce a deadline a GC pause can blow), at most
#: the historical fixed deadline (the cold-start fallback), and sized as
#: margin + headroom x this client's EWMA.
POLL_DEADLINE_FLOOR_S = 10.0
POLL_DEADLINE_HEADROOM = 10.0
POLL_DEADLINE_MARGIN_S = 5.0


def fallback_deadline(local_steps: int) -> float:
    """The historical fixed poll deadline: 120 s covers one minibatch plus
    the first-poll compile; an E-step round adds 2 s/step."""
    return 120.0 + 2.0 * float(local_steps)


@dataclass(frozen=True)
class PacingSpec:
    """Parsed pacing configuration (see :func:`parse_pacing`)."""

    policy: str  # "sync" | "cohort" | "async" | "push"
    cohort_size: int = 0  # cohort: K clients sampled per round
    buffer_size: int = 0  # async/push: admitted updates per aggregation
    staleness_alpha: float = 0.5
    seed: int = 0

    @property
    def spec_id(self) -> str:
        """Canonical spec string (CLI / ``/status`` / telemetry form)."""
        if self.policy == "cohort":
            return f"cohort:{self.cohort_size}"
        if self.policy in ("async", "push"):
            return f"{self.policy}:{self.buffer_size}"
        return "sync"


def parse_pacing(
    spec: "str | PacingSpec | None",
    *,
    cohort_size: "int | None" = None,
    async_buffer: "int | None" = None,
    staleness_alpha: float = 0.5,
    seed: int = 0,
) -> PacingSpec:
    """Parse a pacing spec: ``sync`` (default), ``cohort[:K]``,
    ``async[:B]``, ``push[:B]``. The K/B may come inline (``cohort:8``)
    or from the dedicated knobs (``--cohort_size`` / ``--async_buffer``);
    inline wins when both are given and disagree loudly otherwise."""
    if isinstance(spec, PacingSpec):
        return spec
    raw = (spec or "sync").strip().lower()
    name, _, arg = raw.partition(":")
    if name not in ("sync", "cohort", "async", "push"):
        raise ValueError(
            f"unknown pacing policy {raw!r} (want sync, cohort[:K], "
            f"async[:B] or push[:B])"
        )
    if staleness_alpha < 0:
        raise ValueError(
            f"staleness_alpha must be >= 0, got {staleness_alpha}"
        )
    if name == "sync":
        if arg:
            raise ValueError("sync pacing takes no argument")
        return PacingSpec("sync", staleness_alpha=staleness_alpha, seed=seed)
    inline = int(arg) if arg else None
    if name == "cohort":
        k = inline if inline is not None else cohort_size
        if k is None:
            raise ValueError(
                "cohort pacing needs a size: --pacing cohort:<K> or "
                "--cohort_size"
            )
        if inline is not None and cohort_size not in (None, inline):
            raise ValueError(
                f"conflicting cohort sizes: pacing spec says {inline}, "
                f"--cohort_size says {cohort_size}"
            )
        if k < 1:
            raise ValueError(f"cohort size must be >= 1, got {k}")
        return PacingSpec(
            "cohort", cohort_size=int(k),
            staleness_alpha=staleness_alpha, seed=seed,
        )
    b = inline if inline is not None else async_buffer
    if b is None:
        raise ValueError(
            f"{name} pacing needs a buffer: --pacing {name}:<B> or "
            "--async_buffer"
        )
    if inline is not None and async_buffer not in (None, inline):
        raise ValueError(
            f"conflicting {name} buffers: pacing spec says {inline}, "
            f"--async_buffer says {async_buffer}"
        )
    if b < 1:
        raise ValueError(f"{name} buffer must be >= 1, got {b}")
    return PacingSpec(
        name, buffer_size=int(b),
        staleness_alpha=staleness_alpha, seed=seed,
    )


def make_engine(server: "FederatedServer", spec: PacingSpec) -> "RoundEngine":
    if spec.policy == "cohort":
        return CohortEngine(server, spec)
    if spec.policy == "async":
        return AsyncEngine(server, spec)
    if spec.policy == "push":
        return PushEngine(server, spec)
    return SyncEngine(server, spec)


# ---- unbiased partial-participation reweighting -----------------------------

def inclusion_scale(
    admitted_weight: float, inclusion_p: float, expected_weight: float,
    max_scale: float = float("inf"),
) -> float:
    """Horvitz-Thompson participation correction for a K-of-N cohort.

    With uniform K-of-N sampling (inclusion probability ``p = K/N``) and
    per-client round weights ``w_i``, the unbiased estimate of the full-
    population FedAvg update ``sum_i (w_i / W) u_i`` from the sampled
    cohort S is ``sum_{i in S} (w_i / (p W)) u_i``. The cohort's own
    normalized aggregate is ``g + sum_S (w_i / W_S) u_i``, so multiplying
    its *update* by ``W_S / (p W)`` — this function — recovers the HT
    estimate exactly for the weighted-mean stage:

        E[g + scale * (mean_S - g)] = g + sum_i (w_i / W) u_i

    ``expected_weight`` is W, the expected full-round weight over the
    eligible population; when all clients carry equal weight the factor
    is exactly 1 and cohort pacing degenerates to the plain cohort mean.
    Degenerate inputs (empty cohort, unknown population weight) return
    the neutral 1.0; ``max_scale`` caps the factor at its natural bound
    ``1/p`` so a stale population-weight estimate can never overshoot.
    """
    if (
        inclusion_p <= 0.0 or expected_weight <= 0.0
        or admitted_weight <= 0.0
    ):
        return 1.0
    return float(
        min(admitted_weight / (inclusion_p * expected_weight), max_scale)
    )


def scale_update(
    average: "dict[str, np.ndarray]",
    current_global: "dict[str, np.ndarray]",
    scale: float,
) -> "dict[str, np.ndarray]":
    """``g + scale * (average - g)`` per float tensor (in float64, cast
    back to each tensor's dtype); non-float tensors pass through. The
    identity scale returns ``average`` unchanged — and bit-identical."""
    if scale == 1.0:
        return average
    out: dict[str, np.ndarray] = {}
    for key, val in average.items():
        arr = np.asarray(val)
        if arr.dtype.kind != "f":
            out[key] = arr
            continue
        cur = np.asarray(current_global[key], np.float64)
        out[key] = np.asarray(
            cur + float(scale) * (np.asarray(arr, np.float64) - cur),
            dtype=arr.dtype,
        )
    return out


def staleness_discount(staleness: int, alpha: float) -> float:
    """FedBuff-style staleness damping ``1/(1+s)^alpha``: an update based
    on the current broadcast (s=0) keeps full weight; ``alpha=0``
    disables discounting."""
    return float(1.0 / (1.0 + max(0, int(staleness))) ** float(alpha))


# ---- engines ----------------------------------------------------------------

class RoundEngine:
    """Shared machinery: the bounded poll executor, adaptive poll
    deadlines, one poll, and the per-recipient push. The driving loop
    itself is policy-specific (:meth:`run`)."""

    policy = "sync"

    def __init__(self, server: "FederatedServer", spec: PacingSpec):
        self.server = server
        self.spec = spec
        self._lock = threading.Lock()
        # The last polled roster, read by the ops thread's /status.
        self._last_cohort: tuple[int, ...] = ()  # guarded-by: _lock
        # Last-known per-round admitted weight per client (the HT
        # population-weight estimate); /status summarizes it.
        self._round_weight: dict[int, float] = {}  # guarded-by: _lock
        # Shards already warned about as past the relay grace (loop thread
        # only): loud once per outage, not once per round.
        self._grace_noted: set[int] = set()

    def pool_workers(self, poll_workers: int) -> int:
        """Bound the persistent poll executor to the configured width."""
        return max(1, int(poll_workers))

    def poll_deadline(self, rec) -> float:
        """Per-call TrainStep deadline derived from the straggler
        detector's live poll-latency EWMAs. The fixed ``120 + 2E``
        deadline is kept as the cold-start fallback (no EWMA history,
        or a first poll whose compile dominates) and as the upper
        bound; the floor keeps a milliseconds-scale EWMA from producing
        a deadline that ordinary jitter could blow."""
        base = fallback_deadline(self.server.local_steps)
        if rec.client_id not in self.server._poll_warmed:
            return base  # first poll carries the kernels' build
        ewmas = self.server.straggler.ewma_view()
        if not ewmas:
            return base
        # Per-client: a warmed client with no EWMA of its own yet borrows
        # the population's slowest as the conservative default.
        mine = ewmas.get(rec.client_id, max(ewmas.values()))
        derived = POLL_DEADLINE_MARGIN_S + POLL_DEADLINE_HEADROOM * mine
        return min(base, max(POLL_DEADLINE_FLOOR_S, derived))

    def clamped_staleness(self, replies, iteration: int) -> "dict[int, int]":
        """Per-client staleness: the client's claim
        (``iteration - StepReply.base_round``) clamped to the server's own
        upper bound from the push-ack bookkeeping. The claim alone is
        attacker-controlled — a byzantine client reporting ``base_round=0``
        at round 100 would have its norm screened at 1/101 of its true
        magnitude. The server knows when it last delivered a broadcast to
        each client (``_push_acked``), so a claim can never exceed
        ``iteration - (last_acked + 1)``; a client with no acked push may
        genuinely still be on the replicated init, so its bound is
        ``iteration`` itself."""
        s = self.server
        with s._push_lock:
            acked = dict(s._push_acked)
        out: dict[int, int] = {}
        for rec, reply in replies:
            claimed = max(0, int(iteration) - int(reply.base_round))
            seen = acked.get(rec.client_id)
            observed = (
                iteration - (int(seen) + 1) if seen is not None
                else iteration
            )
            out[rec.client_id] = max(0, min(claimed, observed))
        return out

    def inclusion_q(self) -> float:
        """Per-round client inclusion probability, the q the privacy ledger
        credits for subsampling amplification. Only cohort pacing samples
        (overridden there); sync polls everyone and async/push
        participation is availability-driven, not a sampling distribution,
        so all three return the conservative 1.0."""
        return 1.0

    def status(self) -> "dict[str, Any]":
        with self._lock:
            return {
                "policy": self.spec.spec_id,
                "staleness_alpha": self.spec.staleness_alpha,
                "last_cohort": list(self._last_cohort),
            }

    def _note_cohort(self, cohort) -> None:
        with self._lock:
            self._last_cohort = tuple(rec.client_id for rec in cohort)

    def _note_admitted_weights(self) -> None:
        """Fold this round's admitted per-client weights into the
        population-weight estimate the HT correction uses."""
        with self._lock:
            for client_id, weight, _loss in self.server._round_accepted:
                self._round_weight[client_id] = float(weight)

    def _poll_one(self, stubs: dict, rec, iteration: int, rpc_kwargs: dict):
        """Poll one client for its round step; failures feed the
        probation machinery and return a reply-less triple."""
        s = self.server
        addr = rec.address  # snapshot: rejoin may change it mid-RPC
        t0 = time.perf_counter()
        try:
            stub = s._stub_for(stubs, rec)
            if stub is None:
                raise RuntimeError("client has no serving address")
            # One seq per logical delivery: retry attempts reuse the same
            # request, so a retry after a timed-out-but-delivered call is
            # answered from the client's replay cache instead of running
            # more local steps.
            deadline = self.poll_deadline(rec)
            flightrec.note(
                s.metrics, "poll_dispatch", client=rec.client_id,
                round=iteration, deadline_s=deadline,
                broadcast_round=int(s.global_iterations),
            )
            reply = stub.TrainStep(
                pb.StepRequest(
                    global_iter=iteration,
                    local_steps=s.local_steps,
                    broadcast_round=s.global_iterations,
                    seq=s._next_step_seq(),
                    capture_token=s.flightrec_token(),
                ),
                timeout=deadline,
                **rpc_kwargs,
            )
            if reply.flightrec and s._incident_trigger is not None:
                # A solicited flight-record snapshot rides the reply.
                s._incident_trigger.ingest_remote(reply.flightrec)
            return rec, reply, time.perf_counter() - t0
        except Exception as exc:
            s._note_client_failure(rec, addr, iteration, exc, "TrainStep")
            return rec, None, time.perf_counter() - t0

    # ---- the guardian/encode tail -----------------------------------------
    def _guard_quality(self, iteration: int, snapshots, average):
        """Divergence guardian verdict (and rollback swap), then the
        model-quality step; returns the (possibly restored) average to
        install."""
        s = self.server
        accepted_average = average
        if s.guardian is not None:
            verdict = s.guardian.observe(
                iteration,
                losses=[loss for _c, _w, loss in s._round_accepted],
                average=average,
                contributors=[(c, w) for c, w, _l in s._round_accepted],
            )
            if verdict is not None:
                restored = s._divergence_rollback(iteration, verdict)
                if restored is not None:
                    average = restored
        return s._quality_step(
            iteration, snapshots, average, accepted_average
        )

    def _guard_quality_encode(
        self, iteration: int, snapshots, average, replies
    ):
        """Guardian and quality tail + the ``last_average`` install + the
        per-recipient wire-codec push encode."""
        s = self.server
        average = self._guard_quality(iteration, snapshots, average)
        s.last_average = average
        return s._encode_push(average, iteration, replies)

    @staticmethod
    def push_bytes(aggs: "dict[int, Any]", replies: list) -> int:
        """True wire cost of one round's per-recipient pushes."""
        return sum(
            aggs[rec.client_id].ByteSize() for rec, _reply in replies
            if rec.client_id in aggs
        )

    def _push_round(self, stubs: dict, pool, aggs, replies, rpc_kwargs,
                    iteration: int):
        """Concurrent per-recipient push + progress bookkeeping
        (``aggs``: client id → its encoded Aggregate); returns the acked
        client ids and records each acker's broadcast round (the
        delta-reference bookkeeping the next push's per-recipient
        encoding reads)."""
        s = self.server

        def push(item):
            rec, reply = item
            addr = rec.address
            try:
                ack = stubs[rec.client_id][2].ApplyAggregate(
                    aggs[rec.client_id], **rpc_kwargs
                )
                s.federation.update_progress(
                    rec.client_id, reply.current_mb,
                    reply.current_epoch, reply.loss,
                    finished=ack.finished,
                )
                return rec.client_id
            except Exception as exc:
                s.federation.update_progress(
                    rec.client_id, reply.current_mb,
                    reply.current_epoch, reply.loss, finished=False,
                )
                s._note_client_failure(
                    rec, addr, iteration, exc, "ApplyAggregate"
                )
                return None

        acked = {cid for cid in pool.map(push, replies) if cid is not None}
        # Install under the lock so a ReadyForTraining rejoin's discard
        # can never interleave with the update (see server._push_acked).
        with s._push_lock:
            for rec, _reply in replies:
                if rec.client_id in acked:
                    s._push_acked[rec.client_id] = iteration
                else:
                    s._push_acked.pop(rec.client_id, None)
        # Crash-recovery journal: the round is now fully pushed — one
        # atomic journal write makes it the restart point, so a kill from
        # here on replays at most the next (in-flight) round.
        s._journal_round(iteration)
        return acked

    def _wait_for_pollable(self, iteration: int) -> list:
        """No pollable client right now: convert probation backoffs and
        the post-recovery reconnect grace into wall-clock waits (no rounds
        burned) and return the next pollable roster — empty when the
        federation is over (or stopping)."""
        s = self.server
        while not s._stopping.is_set():
            pending = s.federation.pending_suspects(iteration)
            grace = s.relay_grace_rounds
            if grace > 0 and pending:
                # Shard supervision: a relay silent past the grace is not
                # worth a wall-clock wait — the loop degrades to the live
                # shards (the dead one is still re-polled if its backed-off
                # retry round comes while others keep the run alive).
                gone = {
                    rec.client_id
                    for rec in s.federation.grace_expired(iteration, grace)
                }
                pending = [x for x in pending if x.client_id not in gone]
            if not pending and not s._awaiting_reconnect_grace():
                return []
            if pending:
                # Earliest scheduled probation retry, as wall-clock (one
                # backoff tick per round it is denominated in).
                gap = min(x.next_retry_round for x in pending) - iteration
                wait_s = s.round_backoff_s * max(1, gap)
            else:
                wait_s = s.round_backoff_s
            if s._stopping.wait(wait_s):
                return []
            active = s.federation.active_clients()
            if active:
                return active
        return []

    def _maybe_checkpoint(self, iteration: int) -> None:
        s = self.server
        if (
            s.checkpoint_every > 0 and s.save_dir is not None
            and s.last_average is not None
            and s.global_iterations % s.checkpoint_every == 0
            and (s.guardian is None or s.guardian.healthy)
        ):
            # While the guardian has an open unhealthy streak, the
            # periodic checkpoint is withheld: the state it would persist
            # is exactly what a rollback may be about to discard.
            s._save_round_checkpoint()

    def _final_checkpoint(self) -> None:
        s = self.server
        if (
            s.checkpoint_every > 0 and s.save_dir is not None
            and s.last_average is not None and not s._aborted.is_set()
        ):
            s._save_round_checkpoint()

    def run(self, stubs: dict, pool: ThreadPoolExecutor) -> None:
        raise NotImplementedError


class SyncEngine(RoundEngine):
    """The all-clients barrier: poll every eligible client, quorum over
    the full unfinished membership, FedAvg over the admitted replies, push
    to every replier."""

    policy = "sync"

    # -- policy hooks (overridden by CohortEngine) ---------------------------
    def select_cohort(self, iteration: int, active: list) -> list:
        return active

    def gate_staleness(self, replies, iteration: int):
        """Per-client staleness map for the admission gate's normalized
        outlier screen. Sync pacing returns None — every replier stepped
        from the same broadcast, and the screen stays the unnormalized
        one."""
        return None

    def quorum_denominator(self, cohort: list, iteration: int = 0) -> int:
        """The round's full unfinished membership — including suspects
        still inside their backoff window. Denominating over only the
        polled set would make the quorum vacuous exactly when it matters:
        with every peer in backoff, a lone straggler would be 1/1 and its
        solo reply would become the average.

        Shard supervision: with ``relay_grace_rounds > 0``, a shard silent
        past the grace leaves the denominator (the root aggregates over
        live shards instead of skipping every round until the dead relay's
        probation runs out), and its last-known weight leaves the HT
        population estimate."""
        s = self.server
        active = s.federation.active_clients()
        expired = s.federation.grace_expired(iteration, s.relay_grace_rounds)
        if expired:
            gone = {rec.client_id for rec in expired}
            with self._lock:
                for cid in gone:
                    self._round_weight.pop(cid, None)
            for cid in sorted(gone - self._grace_noted):
                s.logger.warning(
                    "shard %d silent past the %d-round grace window; "
                    "quorum now denominates over live shards without it",
                    cid, s.relay_grace_rounds,
                )
            # A shard that answers again (mark_recovered clears its streak)
            # leaves this memo, so a later second expiry is loud again.
            self._grace_noted = gone
            active = [rec for rec in active if rec.client_id not in gone]
            if s.metrics is not None:
                s.metrics.registry.gauge("live_shards").set(len(active))
        elif self._grace_noted:
            self._grace_noted = set()
        return len(active)

    def combine(self, snapshots, iteration: int):
        s = self.server
        return s.aggregator.aggregate(
            snapshots, current_global=s._current_global()
        )

    def run(self, stubs: dict, pool: ThreadPoolExecutor) -> None:
        s = self.server
        m = s.metrics
        for iteration in range(s.global_iterations, s.max_iters):
            if s._stopping.is_set():
                break
            active = s.federation.active_clients(iteration)
            if not active:
                # Every pollable client is in probation backoff or gone:
                # wait in wall-clock (never burning max_iters rounds) and
                # poll whoever comes back early; an empty roster after the
                # waits is the end of the federation.
                active = self._wait_for_pollable(iteration)
                if not active:
                    break

            if s.profiler is not None:
                s.profiler.observe(iteration)

            cohort = self.select_cohort(iteration, active)
            self._note_cohort(cohort)

            with span(m, "round", round=iteration) as round_sp:
                # Trace metadata for this round's polls/pushes — built once
                # here because the pool threads the RPCs run on do not
                # inherit the round span's contextvars.
                rpc_kwargs = {}
                if m is not None:
                    rpc_kwargs["metadata"] = trace_pairs(
                        s.trace_id, round_sp.span_id, iteration
                    )

                # Suspects entering this round's poll: probation clearance
                # is admission-scoped (see _collect_snapshots).
                was_suspect = frozenset(
                    rec.client_id for rec in cohort
                    if rec.status == SUSPECT
                )

                # 1. concurrent poll: one local round per polled client.
                with span(m, "poll", parent=round_sp, clients=len(cohort)):
                    polled = list(pool.map(
                        lambda rec: self._poll_one(
                            stubs, rec, iteration, rpc_kwargs
                        ),
                        cohort,
                    ))
                replies = [
                    (rec, reply) for rec, reply, _lat in polled
                    if reply is not None
                ]
                if m is not None:
                    s._note_round_poll(round_sp, polled, replies, iteration)
                if not replies:
                    # A fully failed round ends the federation only when
                    # nobody is left to come back (everyone dropped or
                    # finished, nobody mid-reconnect); otherwise wait out
                    # a backoff tick and let probation re-poll.
                    if (
                        not s.federation.active_clients()
                        and not s._awaiting_reconnect_grace()
                    ):
                        break
                    s._stopping.wait(s.round_backoff_s)
                    continue
                membership = self.quorum_denominator(cohort, iteration)
                quorum = max(
                    1, math.ceil(s.quorum_fraction * membership)
                )
                if len(replies) < quorum:
                    # Below-quorum rounds are SKIPPED, not averaged.
                    s._skip_below_quorum(
                        iteration, len(replies), membership, quorum,
                        "replies",
                    )
                    continue

                # 2. aggregate step over the shared subset: decode and
                # check the replies, then the configured strategy.
                with span(m, "average", parent=round_sp):
                    snapshots = s._collect_snapshots(
                        replies, iteration, was_suspect,
                        staleness=self.gate_staleness(replies, iteration),
                    )
                    if len(snapshots) < quorum:
                        s._skip_below_quorum(
                            iteration, len(snapshots), membership, quorum,
                            "admitted",
                        )
                        continue
                    self._note_admitted_weights()
                    average = self.combine(snapshots, iteration)
                    aggs = self._guard_quality_encode(
                        iteration, snapshots, average, replies
                    )

                # 3. concurrent push + progress bookkeeping.
                with span(m, "push", parent=round_sp, clients=len(replies)):
                    self._push_round(
                        stubs, pool, aggs, replies, rpc_kwargs, iteration
                    )
                if m is not None:
                    round_sp.annotate(
                        bytes_pushed=self.push_bytes(aggs, replies)
                    )
            s.global_iterations = iteration + 1
            s._fleet_tick(iteration)
            self._maybe_checkpoint(iteration)
            if m is not None and iteration % 50 == 0:
                m.snapshot_registry(rounds=iteration + 1)
                m.log(
                    "federated_iteration", iteration=iteration,
                    mean_loss=float(
                        np.mean([r.loss for _, r in replies])
                    ),
                )
        # Final checkpoint so a resume of a finished (or stopped) run does
        # not replay rounds since the last periodic save.
        self._final_checkpoint()


class CohortEngine(SyncEngine):
    """K-of-N cohort sampling on top of the sync barrier: the round only
    ever touches the sampled clients, the quorum denominates over the
    cohort, and the aggregate is corrected to the unbiased full-
    population expectation (:func:`inclusion_scale`)."""

    policy = "cohort"

    def __init__(self, server: "FederatedServer", spec: PacingSpec):
        super().__init__(server, spec)
        self._inclusion_p = 1.0
        self._expected_weight = 0.0
        self._last_scale = 1.0

    def pool_workers(self, poll_workers: int) -> int:
        # The executor is sized to the cohort: non-participants are never
        # polled, so threads beyond K would only ever idle.
        return max(1, min(int(poll_workers), self.spec.cohort_size))

    def select_cohort(self, iteration: int, active: list) -> list:
        s = self.server
        k = min(self.spec.cohort_size, len(active))
        if k >= len(active):
            cohort = list(active)
            self._inclusion_p = 1.0
        else:
            # Seeded per-round sampling: the roster is a pure function of
            # (seed, round, eligible set) — reproducible across resumes
            # and independent of poll timing. Eligibility already encodes
            # the registry states: suspects inside their backoff window
            # and quarantined/dropped clients are not in `active`.
            rng = np.random.default_rng((self.spec.seed, iteration))
            picked = rng.choice(len(active), size=k, replace=False)
            chosen = {active[int(i)].client_id for i in picked}
            cohort = [rec for rec in active if rec.client_id in chosen]
            self._inclusion_p = k / len(active)
        # Expected full-round population weight W for the HT correction:
        # per-client last-known admitted round weights, defaulting to the
        # cohort mean (neutral — scale 1.0 — until heterogeneity is
        # actually observed).
        with self._lock:
            known = dict(self._round_weight)
        default = (
            sum(known.values()) / len(known) if known else 1.0
        )
        self._expected_weight = float(sum(
            known.get(rec.client_id, default) for rec in active
        ))
        if s.metrics is not None:
            s.metrics.registry.gauge("cohort_size").set(len(cohort))
            s.metrics.registry.gauge("cohort_eligible").set(len(active))
            s.metrics.log(
                "cohort_sampled", round=iteration, k=len(cohort),
                eligible=len(active), q=self._inclusion_p,
                cohort=[rec.client_id for rec in cohort],
            )
        return cohort

    def inclusion_q(self) -> float:
        """The live K/eligible of the most recent sample — first-class,
        so the privacy accountant never re-derives K/N from config (a
        probation-shrunk eligible pool makes the true q *larger* than
        the configured K/N; reading the sampler's own value keeps the
        amplification credit honest)."""
        return float(self._inclusion_p)

    def quorum_denominator(self, cohort: list, iteration: int = 0) -> int:
        """Under cohort pacing the quorum denominator is
        the sampled cohort — against the full membership, a K=8 sample of
        N=100 could never reach a 0.5 quorum and every round would skip."""
        return len(cohort)

    def gate_staleness(self, replies, iteration: int):
        """Cohort members step from whatever broadcast they last applied
        (they may not have been sampled for many rounds), so the gate's
        outlier screen judges staleness-normalized norms — an honest
        client carrying ``s`` rounds of global drift must not read as a
        poisoner against freshly-synced peers. Claims are clamped to the
        server-observed bound (:meth:`clamped_staleness`) so the
        normalization is not an attacker-widened screen."""
        return self.clamped_staleness(replies, iteration)

    def combine(self, snapshots, iteration: int):
        s = self.server
        average = super().combine(snapshots, iteration)
        if s.aggregator.estimator.name != "mean":
            # Byzantine-robust mean stages deliberately ignore sample
            # weights (influence must not be buyable), so inverse-
            # inclusion-probability reweighting has no unbiasedness to
            # restore — the robust estimate passes through.
            self._last_scale = 1.0
            return average
        admitted = sum(w for _c, w, _l in s._round_accepted)
        scale = inclusion_scale(
            admitted, self._inclusion_p, self._expected_weight,
            max_scale=1.0 / max(self._inclusion_p, 1e-9),
        )
        self._last_scale = scale
        if s.metrics is not None:
            s.metrics.registry.gauge("cohort_inclusion_scale").set(scale)
        return scale_update(average, s._current_global(), scale)

    def status(self) -> "dict[str, Any]":
        out = super().status()
        out.update(
            cohort_size=self.spec.cohort_size,
            inclusion_p=self._inclusion_p,
            inclusion_scale=self._last_scale,
        )
        return out


class AsyncEngine(RoundEngine):
    """FedBuff-style buffered asynchrony: one free-running poll per
    eligible client, aggregation whenever ``buffer_size`` admitted
    updates accumulate, staleness-discounted weights, push (and re-poll)
    only for the drained contributors."""

    policy = "async"

    def __init__(self, server: "FederatedServer", spec: PacingSpec):
        super().__init__(server, spec)
        # Completed-but-unaggregated updates: appended by the loop thread
        # as poll futures resolve, drained at each aggregation; /status
        # reads the depth from ops-endpoint threads.
        self._pending: list = []  # guarded-by: _lock
        self._stale_max = 0

    def status(self) -> "dict[str, Any]":
        out = super().status()
        with self._lock:
            depth = len(self._pending)
        out.update(
            buffer_size=self.spec.buffer_size,
            buffer_depth=depth,
            stale_max=self._stale_max,
        )
        return out

    # -- deterministic buffer mechanics (unit-tested directly) ---------------
    def buffer_append(self, rec, reply, latency: float) -> int:
        """Buffer one completed poll; returns the new depth."""
        with self._lock:
            self._pending.append((rec, reply, latency))
            return len(self._pending)

    def buffer_drain(self) -> list:
        """Drain the whole buffer in client-id order: the aggregation
        arithmetic (weighted sums in list order) is then deterministic
        given the same buffered set, regardless of arrival order."""
        with self._lock:
            drained = list(self._pending)
            self._pending.clear()
        drained.sort(key=lambda item: item[0].client_id)
        return drained

    def staleness_of(self, reply, iteration: int) -> int:
        """How many aggregations happened since this update's base
        broadcast. ``StepReply.base_round`` is 1 + the round tag of the
        last aggregate the client applied (0 = never, i.e. the initial
        replicated state), which equals the number of aggregations the
        client had seen — so staleness is the plain difference against
        the server's aggregation counter."""
        return max(0, int(iteration) - int(reply.base_round))

    def discounts_for(
        self, drained: list, iteration: int,
        stale_map: "dict[int, int] | None" = None,
    ) -> "dict[int, float]":
        """Per-client staleness discount factors for one drained batch,
        with telemetry for every actually-discounted update. ``stale_map``
        (the production path) carries server-clamped staleness from
        :meth:`clamped_staleness`; without it the reply's own claim is
        used (unit-test convenience)."""
        s = self.server
        out: dict[int, float] = {}
        stales: list[int] = []
        for rec, reply, _lat in drained:
            stale = (
                stale_map[rec.client_id] if stale_map is not None
                else self.staleness_of(reply, iteration)
            )
            factor = staleness_discount(stale, self.spec.staleness_alpha)
            out[rec.client_id] = factor
            stales.append(stale)
            if stale > 0 and s.metrics is not None:
                s.metrics.registry.counter("updates_stale_discounted").inc()
                s.metrics.log(
                    "update_stale_discounted", client=rec.client_id,
                    round=iteration, staleness=stale, factor=factor,
                )
        self._stale_max = max(stales) if stales else 0
        return out

    # -- the loop ------------------------------------------------------------
    def run(self, stubs: dict, pool: ThreadPoolExecutor) -> None:
        s = self.server
        iteration = s.global_iterations
        inflight: dict[int, Any] = {}  # client_id -> Future
        held: set[int] = set()  # buffered, awaiting an aggregation
        # Budget: aggregations are bounded by max_iters; skipped (below-
        # quorum) aggregation attempts get their own generous budget so a
        # fleet that only ever sends poison still terminates.
        skips = 0
        while (
            iteration < s.max_iters
            and skips < max(16, 4 * s.max_iters)
            and not s._stopping.is_set()
        ):
            if s.profiler is not None:
                s.profiler.observe(iteration)
            # 1. keep one poll in flight per eligible client (free-running
            # clients: each new poll starts the moment the previous
            # completes and its update is aggregated + pushed).
            active = s.federation.active_clients(iteration)
            for rec in active:
                if rec.client_id in inflight or rec.client_id in held:
                    continue
                inflight[rec.client_id] = pool.submit(
                    self._poll_one, stubs, rec, iteration, {}
                )
            if not inflight:
                with self._lock:
                    buffered = len(self._pending)
                if buffered:
                    # End-game partial drain: fewer unfinished clients
                    # remain than the buffer asks for.
                    iteration, skips = self._aggregate_once(
                        stubs, pool, iteration, skips, held
                    )
                    continue
                pending = s.federation.pending_suspects(iteration)
                if not pending and not s._awaiting_reconnect_grace():
                    break
                if pending:
                    gap = (
                        min(x.next_retry_round for x in pending) - iteration
                    )
                    wait_s = s.round_backoff_s * max(1, gap)
                else:
                    wait_s = s.round_backoff_s  # reconnect grace tick
                if s._stopping.wait(wait_s):
                    break
                continue
            # 2. fold completed polls into the buffer.
            done, _not_done = wait(
                set(inflight.values()), timeout=0.05,
                return_when=FIRST_COMPLETED,
            )
            if done:
                for client_id in [
                    cid for cid, fut in inflight.items() if fut in done
                ]:
                    rec, reply, lat = inflight.pop(client_id).result()
                    if reply is None:
                        continue  # failure: probation already recorded
                    self.buffer_append(rec, reply, lat)
                    held.add(rec.client_id)
            with self._lock:
                buffered = len(self._pending)
            # 3. aggregate as soon as the buffer fills. The effective
            # buffer shrinks to the live population so a fleet smaller
            # than B (clients finishing out) still aggregates.
            alive = s.federation.alive_count()
            effective = max(1, min(self.spec.buffer_size, alive))
            if buffered >= effective:
                iteration, skips = self._aggregate_once(
                    stubs, pool, iteration, skips, held
                )
        self._final_checkpoint()

    def _aggregate_once(
        self, stubs: dict, pool, iteration: int, skips: int,
        held: "set[int]",
    ) -> "tuple[int, int]":
        """One buffered aggregation: drain, discount by staleness, gate,
        aggregate, guard, push to the drained contributors. Returns the
        (possibly advanced) aggregation counter and skip count; drained
        clients leave ``held`` and re-enter the free-running poll."""
        s = self.server
        m = s.metrics
        drained = self.buffer_drain()
        held.difference_update(rec.client_id for rec, _r, _l in drained)
        if not drained:
            return iteration, skips
        self._note_cohort([rec for rec, _r, _l in drained])
        with span(m, "round", round=iteration, pacing="async") as round_sp:
            rpc_kwargs = {}
            if m is not None:
                rpc_kwargs["metadata"] = trace_pairs(
                    s.trace_id, round_sp.span_id, iteration
                )
            polled = [(rec, reply, lat) for rec, reply, lat in drained]
            replies = [(rec, reply) for rec, reply, _lat in drained]
            if m is not None:
                s._note_round_poll(round_sp, polled, replies, iteration)
            was_suspect = frozenset(
                rec.client_id for rec, _r, _l in drained
                if rec.status == SUSPECT
            )
            stale_map = self.clamped_staleness(replies, iteration)
            discounts = self.discounts_for(drained, iteration, stale_map)
            quorum = max(
                1, math.ceil(s.quorum_fraction * len(drained))
            )
            with span(m, "average", parent=round_sp):
                snapshots = s._collect_snapshots(
                    replies, iteration, was_suspect,
                    weight_scale=discounts,
                    staleness=stale_map,
                )
                if len(snapshots) < quorum:
                    # Below-quorum drains are dropped (not averaged); the
                    # contributors are NOT pushed — they re-enter the
                    # free-running poll and their next update supersedes
                    # the dropped one.
                    s._skip_below_quorum(
                        iteration, len(snapshots), len(drained), quorum,
                        "admitted by the update gate",
                    )
                    return iteration, skips + 1
                self._note_admitted_weights()
                average = s.aggregator.aggregate(
                    snapshots, current_global=s._current_global()
                )
                aggs = self._guard_quality_encode(
                    iteration, snapshots, average, replies
                )
            if m is not None:
                stales = [
                    stale_map[rec.client_id] for rec, _reply in replies
                ]
                m.log(
                    "async_aggregated", round=iteration,
                    buffered=len(drained), admitted=len(snapshots),
                    stale_max=max(stales), stale_mean=float(
                        sum(stales) / len(stales)
                    ),
                )
            with span(m, "push", parent=round_sp, clients=len(replies)):
                self._push_round(
                    stubs, pool, aggs, replies, rpc_kwargs, iteration
                )
            if m is not None:
                round_sp.annotate(
                    bytes_pushed=self.push_bytes(aggs, replies),
                    clients=len(replies),
                )
        s.global_iterations = iteration + 1
        s._fleet_tick(iteration)
        self._maybe_checkpoint(iteration)
        if m is not None and iteration % 50 == 0:
            m.snapshot_registry(rounds=iteration + 1)
            m.log(
                "federated_iteration", iteration=iteration,
                mean_loss=float(
                    np.mean([r.loss for _, r in replies])
                ),
            )
        return iteration + 1, skips


class PushEngine(AsyncEngine):
    """Client-initiated push rounds (``pacing_policy="push:<B>"``).

    The polling direction inverts: the server never dispatches TrainStep.
    Clients stream ``PushUpdate`` RPCs on their own clock (each carrying
    one local round's update, authenticated by the durable-session
    token); the servicer buffers them (:meth:`submit`) and this engine
    drains/aggregates exactly like FedBuff — deterministic client-id
    drain order, server-clamped staleness discounts, the full admission
    gate — once ``B`` updates accumulate. No broadcast fan-out follows:
    each contributor picks the freshest round up in its next PushUpdate
    *reply*, per-recipient delta-encoded against whatever it reports
    holding. Per-aggregation server work is therefore O(updates
    received), with no poll threads and no per-cohort deadline
    bookkeeping — the control-plane cost is flat in the population size.

    A member that stops pushing altogether is struck through the same
    probation machinery as a failed poll (:meth:`_strike_idle`), so a
    crashed client cannot hold the federation open forever.
    """

    policy = "push"

    #: A member is struck (probation) when silent for this many multiples
    #: of the historical per-round deadline.
    IDLE_DEADLINE_FACTOR = 4.0

    def __init__(self, server: "FederatedServer", spec: PacingSpec):
        super().__init__(server, spec)
        # Wakes the engine the moment a push lands (vs. sleeping out a
        # full backoff tick) — latency, not correctness.
        self._wake = threading.Event()
        # Wall-clock of each member's last accepted push; consulted by
        # the idle-strike sweep. Written by gRPC threads via submit().
        self._last_push: dict[int, float] = {}  # guarded-by: _lock
        # Last idle-strike sweep (engine thread only): the sweep is
        # throttled so the idle loop stays O(1) per tick, not O(N).
        self._last_sweep = 0.0

    def pool_workers(self, poll_workers: int) -> int:
        # No polls: the executor only ever runs the final stop broadcast.
        return max(1, min(int(poll_workers), 4))

    def submit(self, rec, reply) -> int:
        """Buffer one client-initiated update (called from PushUpdate
        servicer threads); returns the new buffer depth."""
        depth = self.buffer_append(rec, reply, 0.0)
        with self._lock:
            self._last_push[rec.client_id] = time.monotonic()
        self._wake.set()
        return depth

    def status(self) -> "dict[str, Any]":
        out = super().status()
        out["push"] = True
        return out

    def _strike_idle(self, iteration: int) -> None:
        """Probation sweep for members that stopped pushing: one strike
        per elapsed idle window (the strike resets the member's clock, so
        a genuinely dead client drops after ``probation_rounds`` windows
        while a slow-but-alive one clears itself with its next push).

        Throttled to a fraction of the idle window: the sweep walks the
        whole registry (O(N)), and running it on every ``round_backoff_s``
        tick would put an O(N) scan between aggregations whose advertised
        cost is O(updates received) — at 10^4 members that IS the round
        time. Sub-window sweep granularity buys nothing: a strike only
        fires after a full multi-minute window elapses."""
        s = self.server
        window = self.IDLE_DEADLINE_FACTOR * fallback_deadline(s.local_steps)
        now = time.monotonic()
        if now - self._last_sweep < max(5.0, window / 8.0):
            return
        self._last_sweep = now
        for rec in s.federation.active_clients(iteration):
            # Check and reset under ONE lock hold: submit() stamps
            # _last_push from gRPC threads, and a separate read-then-write
            # would let a push landing in between be clobbered by the
            # stale strike — permanently dropping a live client at low
            # probation_rounds.
            with self._lock:
                last = self._last_push.setdefault(rec.client_id, now)
                if now - last <= window:
                    continue
                self._last_push[rec.client_id] = now
            s._note_client_failure(
                rec, rec.address, iteration,
                TimeoutError(
                    f"no PushUpdate for {now - last:.0f}s "
                    f"(window {window:.0f}s)"
                ),
                "PushUpdate",
            )

    # -- the loop ------------------------------------------------------------
    def run(self, stubs: dict, pool: ThreadPoolExecutor) -> None:
        s = self.server
        iteration = s.global_iterations
        skips = 0
        while (
            iteration < s.max_iters
            and skips < max(16, 4 * s.max_iters)
            and not s._stopping.is_set()
        ):
            if s.profiler is not None:
                s.profiler.observe(iteration)
            # Clear BEFORE reading the buffer depth: any push landing
            # after this point re-sets the event, so either the depth
            # read below sees it or the wait returns immediately —
            # clearing later (after the O(N) idle sweep) erased wakeups
            # from pushes that filled the buffer in that window and slept
            # a full backoff tick on a full buffer.
            self._wake.clear()
            with self._lock:
                buffered = len(self._pending)
            alive = s.federation.alive_count()
            effective = max(1, min(self.spec.buffer_size, alive or 1))
            if buffered >= effective:
                iteration, skips = self._aggregate_push(iteration, skips)
                continue
            if alive == 0:
                if buffered:
                    # End-game partial drain: the last unfinished members
                    # pushed and finished in the same breath.
                    iteration, skips = self._aggregate_push(
                        iteration, skips
                    )
                    continue
                pending = s.federation.pending_suspects(iteration)
                if not pending and not s._awaiting_reconnect_grace():
                    break
            self._strike_idle(iteration)
            self._wake.wait(s.round_backoff_s)
        self._final_checkpoint()

    def _aggregate_push(
        self, iteration: int, skips: int
    ) -> "tuple[int, int]":
        """One buffered aggregation, reply-delivered: drain, discount by
        server-clamped staleness, gate, aggregate, guard — then advance
        the canonical broadcast chain WITHOUT a fan-out (contributors
        sync in their next PushUpdate replies) and journal the round."""
        s = self.server
        m = s.metrics
        drained = self.buffer_drain()
        if not drained:
            return iteration, skips
        self._note_cohort([rec for rec, _r, _l in drained])
        with span(m, "round", round=iteration, pacing="push") as round_sp:
            replies = [(rec, reply) for rec, reply, _lat in drained]
            was_suspect = frozenset(
                rec.client_id for rec, _r, _l in drained
                if rec.status == SUSPECT
            )
            stale_map = self.clamped_staleness(replies, iteration)
            discounts = self.discounts_for(drained, iteration, stale_map)
            quorum = max(
                1, math.ceil(s.quorum_fraction * len(drained))
            )
            with span(m, "average", parent=round_sp):
                snapshots = s._collect_snapshots(
                    replies, iteration, was_suspect,
                    weight_scale=discounts,
                    staleness=stale_map,
                )
                if len(snapshots) < quorum:
                    s._skip_below_quorum(
                        iteration, len(snapshots), len(drained), quorum,
                        "admitted by the update gate",
                    )
                    return iteration, skips + 1
                self._note_admitted_weights()
                average = s.aggregator.aggregate(
                    snapshots, current_global=s._current_global()
                )
                average = self._guard_quality(
                    iteration, snapshots, average
                )
                s.last_average = average
                s._advance_broadcast(average, iteration)
            if m is not None:
                stales = [
                    stale_map[rec.client_id] for rec, _reply in replies
                ]
                round_sp.annotate(clients=len(replies))
                m.log(
                    "push_aggregated", round=iteration,
                    buffered=len(drained), admitted=len(snapshots),
                    stale_max=max(stales), stale_mean=float(
                        sum(stales) / len(stales)
                    ),
                )
        s.global_iterations = iteration + 1
        s._fleet_tick(iteration)
        # The round is complete the moment the chain advances — replies
        # deliver it; journal now so a crash replays at most this round.
        s._journal_round(iteration)
        self._maybe_checkpoint(iteration)
        if m is not None and iteration % 50 == 0:
            m.snapshot_registry(rounds=iteration + 1)
            m.log(
                "federated_iteration", iteration=iteration,
                mean_loss=float(
                    np.mean([r.loss for _, r in replies])
                ),
            )
        return iteration + 1, skips
