"""The federation server's round engine: sync pacing.

Counterpart of ``gfedntm_tpu/federation/pacing.py`` (:114-801), the
server's round *control plane*:

- :class:`PacingSpec`, :func:`parse_pacing` and :func:`fallback_deadline`
  are copies;
- :class:`RoundEngine` keeps the shared machinery: the bounded poll
  executor, the adaptive per-client poll deadline from the straggler
  detector's EWMAs, one poll, and the per-recipient push with its
  delta-reference bookkeeping;
- :class:`SyncEngine` is the all-clients barrier of the JAX engine, line
  for line where the port has the plane it drives: poll every eligible
  client concurrently (each poll carrying the incident trigger's capture
  token, each reply's solicited flight record taken in), quorum over the
  full unfinished membership, the update gate and the configured strategy
  over the admitted replies, the divergence guardian's verdict (and its
  rollback swap), the model-quality step, push to every replier, journal
  the pushed round, the fleet, SLO and privacy tick, and checkpoint every
  ``checkpoint_every`` rounds while the guardian is healthy, and once at
  the end (JAX ``pacing.py:396-589``, ``:690-791``).

What the port's server does not have yet is left out of the loop: the
device profiler window and relay shard supervision
(``relay_grace_rounds``). The server refuses the options that would need
them, so the loop here is the JAX loop with those switched off. ``cohort``,
``async`` and ``push`` pacing parse, and :func:`make_engine` raises
``NotImplementedError`` for them (ROADMAP queue 1).
"""

from __future__ import annotations

import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
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
    "RoundEngine",
    "SyncEngine",
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
    """The engine of ``spec``: sync. Cohort, async and push pacing are not
    ported yet and raise."""
    if spec.policy != "sync":
        raise NotImplementedError(
            f"{spec.spec_id} pacing is not ported yet (ROADMAP queue 1); "
            "the port's server runs sync pacing"
        )
    return SyncEngine(server, spec)


class RoundEngine:
    """Shared machinery: the bounded poll executor, adaptive poll
    deadlines, one poll, and the per-recipient push. The driving loop
    itself is policy-specific (:meth:`run`)."""

    policy = "sync"

    def __init__(self, server: "FederatedServer", spec: PacingSpec):
        self.server = server
        self.spec = spec
        # The last polled roster, read by the ops thread's /status.
        self._lock = threading.Lock()
        self._last_cohort: tuple[int, ...] = ()

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

    def inclusion_q(self) -> float:
        """Per-round client inclusion probability, the q the privacy ledger
        credits: sync pacing polls everyone, so 1.0 (no amplification)."""
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

    def quorum_denominator(self, cohort: list, iteration: int = 0) -> int:
        """The round's full unfinished membership — including suspects
        still inside their backoff window. Denominating over only the
        polled set would make the quorum vacuous exactly when it matters:
        with every peer in backoff, a lone straggler would be 1/1 and its
        solo reply would become the average."""
        return len(self.server.federation.active_clients())

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

            cohort = active
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
                        replies, iteration, was_suspect
                    )
                    if len(snapshots) < quorum:
                        s._skip_below_quorum(
                            iteration, len(snapshots), membership, quorum,
                            "admitted",
                        )
                        continue
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
