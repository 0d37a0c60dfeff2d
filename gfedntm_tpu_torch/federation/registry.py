"""Thread-safe federation membership registry.

A copy of ``gfedntm_tpu/federation/registry.py`` (numpy, grpc and the
standard library only), its imports rewritten to ``gfedntm_tpu_torch``; the
rest is the original's, so both packages speak the same wire
(``tests/test_torch_federation_codec.py`` holds it to the original).

Rebuilds ``src/federation/federation.py:14-170`` (``Federation``) and
``src/federation/federation_client.py:10-125`` (``FederationClient``): the
server's bookkeeping of connected clients across the consensus and training
phases. Differences from the reference: clients are keyed by their declared
``client_id`` (the reference keys by gRPC peer string and back-fills ids);
state transitions are guarded by one RLock + a Condition so quorum waits are
event-driven instead of poll-with-timeout (``server.py:237-238``'s
``waiting`` library with its 120 s expiry — SURVEY.md §2.5 item 9)."""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field


# Liveness states of a training-phase client. ACTIVE clients are polled
# every round; SUSPECT clients (≥1 consecutive failed round) are re-polled
# with a per-round exponential backoff until they either answer again
# (→ ACTIVE, a "recovery") or exhaust their probation budget (→ DROPPED,
# which also sets ``finished`` so the round loop and quorum maths treat
# them exactly like an early finisher).
ACTIVE = "active"
SUSPECT = "suspect"
DROPPED = "dropped"

#: Cap on the suspect re-poll backoff, in rounds.
MAX_RETRY_BACKOFF_ROUNDS = 8


def looks_like_session_token(token: str) -> bool:
    """True iff ``token`` has the shape of a minted session credential
    (32 lowercase hex chars — ``uuid4().hex``). The adoptive tier of a
    re-homing member uses this to tell a cross-tier failover (valid-
    format token it never minted → loud ``member_rehomed`` admit) from a
    garbled or hand-rolled credential (plain fresh join)."""
    return (
        len(token) == 32
        and all(c in "0123456789abcdef" for c in token)
    )


@dataclass
class ClientRecord:
    """Per-client federation state (reference ``FederationClient``):
    identity, FedAvg weight, phase flags, liveness/probation state, and
    training progress counters."""

    client_id: int
    nr_samples: float = 0.0
    vocab: tuple[str, ...] = ()
    address: str = ""
    vocab_sent: bool = False
    ready_for_training: bool = False
    finished: bool = False
    current_mb: int = 0
    current_epoch: int = 0
    last_loss: float = float("nan")
    status: str = ACTIVE
    consecutive_failures: int = 0
    next_retry_round: int = 0
    # Why the client is (or last was) in probation: "rpc" for transport
    # failures, "poisoned" for updates the admission gate rejected,
    # "divergence" for a quarantine after a global-model rollback.
    suspect_reason: str = ""
    # Durable-session credential (README "Crash recovery & sessions"):
    # minted by the server in its GetGlobalSetup reply, persisted with
    # every round checkpoint/journal membership snapshot. A client
    # re-presenting it in ReadyForTraining is the SAME live process
    # reconnecting — its server-side state (straggler EWMA, push-ack
    # posture) survives; a token-less or mismatched rejoin is a fresh
    # process and starts clean.
    session_token: str = ""
    # True between the token mint (GetGlobalSetup) and the client's first
    # ReadyForTraining — distinguishes the initial ready of a new session
    # from a genuine live-process reconnect (see Federation.classify_join).
    session_fresh: bool = False
    # Set when the server recovered from a crash while this member held
    # live wire-codec session state the new process does not: its first
    # token reconnect is answered Ack code 3 ("reset your codec
    # sessions") so both ends restart from self-contained bundles.
    needs_codec_reset: bool = False
    # Restored from a recovery snapshot but not yet reconnected: the
    # round loop holds the federation open for these members for a
    # bounded grace window instead of declaring the run finished the
    # moment every already-reconnected member completes.
    awaiting_reconnect: bool = False
    # Round of the FIRST failure of the current probation streak (None
    # while healthy). Shard supervision (README "Crash recovery &
    # sessions"): a root whose members are relays denominates quorum
    # over *live* shards — a relay silent since more than
    # ``relay_grace_rounds`` rounds ago leaves the denominator instead
    # of stalling every round until its probation budget runs out.
    suspect_since_round: "int | None" = None


@dataclass
class Federation:
    """Registry of connected clients with quorum signalling."""

    min_clients: int = 1
    # Mutated by gRPC servicer threads (connect/disconnect) and read by
    # the training loop; _cond wraps the same RLock, so holding either
    # guards the registry.
    _clients: dict[int, ClientRecord] = field(default_factory=dict)  # guarded-by: _lock, _cond
    _lock: threading.RLock = field(default_factory=threading.RLock)

    def __post_init__(self):
        self._cond = threading.Condition(self._lock)

    # ---- consensus phase ---------------------------------------------------
    def connect_vocab(
        self, client_id: int, vocab: tuple[str, ...], nr_samples: float
    ) -> ClientRecord:
        with self._cond:
            rec = self._clients.setdefault(client_id, ClientRecord(client_id))
            rec.vocab = tuple(vocab)
            rec.nr_samples = float(nr_samples)
            rec.vocab_sent = True
            self._cond.notify_all()
            return rec

    def wait_vocab_quorum(self, timeout: float | None = None) -> bool:
        """Block until ``min_clients`` clients have offered vocabularies
        (reference ``can_send_aggragated_vocab``, ``server.py:333-347``)."""
        with self._cond:
            return self._cond.wait_for(
                lambda: sum(c.vocab_sent for c in self._clients.values())
                >= self.min_clients,
                timeout=timeout,
            )

    def set_session_token(self, client_id: int, token: str) -> ClientRecord:
        """Store a freshly-minted session token for a client (creating
        its record if this is the first contact). Minting marks the
        session fresh and clears any pending codec-reset order — a
        process that just passed through GetGlobalSetup has no stale
        session state to reset."""
        with self._cond:
            rec = self._clients.setdefault(client_id, ClientRecord(client_id))
            rec.session_token = token
            rec.session_fresh = True
            rec.needs_codec_reset = False
            return rec

    def classify_join(self, client_id: int, token: str) -> str:
        """Classify one ReadyForTraining: ``"new"`` (token-less, unknown,
        or mismatched — a fresh process), ``"first"`` (the initial ready
        of a just-minted session), or ``"restore"`` (a live process
        re-presenting its credential after a connection loss)."""
        with self._lock:
            rec = self._clients.get(client_id)
            if rec is None or not token or rec.session_token != token:
                return "new"
            if rec.session_fresh:
                rec.session_fresh = False
                return "first"
            return "restore"

    def consume_codec_reset(self, client_id: int) -> bool:
        """Read-and-clear the member's pending codec-reset order (set by
        server recovery for members that held live codec sessions)."""
        with self._lock:
            rec = self._clients.get(client_id)
            if rec is None or not rec.needs_codec_reset:
                return False
            rec.needs_codec_reset = False
            return True

    def restore_member(
        self, client_id: int, nr_samples: float = 0.0,
        session_token: str = "", finished: bool = False,
        current_mb: int = 0, current_epoch: int = 0,
        needs_codec_reset: bool = False,
    ) -> ClientRecord:
        """Rebuild one membership record from a checkpoint/journal
        snapshot on server recovery. The record is NOT ready for
        training — the client must reconnect (presenting its restored
        session token) before it is polled again."""
        with self._cond:
            rec = self._clients.setdefault(client_id, ClientRecord(client_id))
            rec.nr_samples = float(nr_samples)
            rec.session_token = session_token
            rec.session_fresh = False
            rec.needs_codec_reset = bool(needs_codec_reset)
            rec.finished = bool(finished)
            rec.current_mb = int(current_mb)
            rec.current_epoch = int(current_epoch)
            rec.ready_for_training = False
            rec.awaiting_reconnect = not finished
            # `finished` alone keeps the member out of every poll; status
            # stays ACTIVE (a checkpointed finisher is not a drop).
            rec.status = ACTIVE
            self._cond.notify_all()
            return rec

    def awaiting_reconnect(self) -> list[ClientRecord]:
        """Restored unfinished members that have not reconnected yet."""
        with self._lock:
            return [
                c for c in self.get_clients()
                if c.awaiting_reconnect and not c.finished
            ]

    # ---- training phase ----------------------------------------------------
    def connect_ready(self, client_id: int, address: str) -> ClientRecord:
        """Also the rejoin path: a client that was dropped mid-training
        (marked ``finished``) and comes back re-enters the active set; its
        address may have changed (new serving port)."""
        with self._cond:
            rec = self._clients.setdefault(client_id, ClientRecord(client_id))
            rec.address = address
            rec.ready_for_training = True
            rec.finished = False
            rec.awaiting_reconnect = False
            # A (re)joining client starts with a clean probation slate — a
            # fresh process is a fresh liveness history (and a reconnecting
            # live process has, by reconnecting, just proven liveness).
            rec.status = ACTIVE
            rec.consecutive_failures = 0
            rec.next_retry_round = 0
            rec.suspect_reason = ""
            rec.suspect_since_round = None
            self._cond.notify_all()
            return rec

    def wait_training_quorum(self, timeout: float | None = None) -> bool:
        """Reference ``can_start_training`` (``server.py:349-363``)."""
        with self._cond:
            return self._cond.wait_for(
                lambda: sum(
                    c.ready_for_training for c in self._clients.values()
                )
                >= self.min_clients,
                timeout=timeout,
            )

    def mark_dropped(self, client_id: int, address: str) -> None:
        """Permanently drop a client after a failed RPC — but only if it has
        not rejoined since: a rejoin changes the serving address, and a stale
        in-flight failure against the OLD address must not clobber the
        fresh registration."""
        with self._lock:
            rec = self._clients.get(client_id)
            if rec is not None and rec.address == address:
                rec.finished = True
                rec.status = DROPPED

    def mark_suspect(
        self, client_id: int, address: str, round_idx: int,
        probation_rounds: int = 3, reason: str = "rpc",
    ) -> str | None:
        """Record one failed round for a client: ACTIVE/SUSPECT clients gain
        a consecutive-failure count and a backed-off ``next_retry_round``
        (1, 2, 4, ... rounds out, capped); after ``probation_rounds``
        consecutive failures the drop becomes permanent. ``reason`` tags
        WHY the client is on probation ("rpc" transport failures,
        "poisoned" for gate-rejected updates, "divergence" for a rollback
        quarantine) — surfaced in the membership snapshot. Returns the
        client's new status, or None when the failure is stale (the client
        rejoined on a different address since the RPC was issued)."""
        with self._lock:
            rec = self._clients.get(client_id)
            if rec is None or rec.address != address:
                return None
            rec.consecutive_failures += 1
            rec.suspect_reason = reason
            if rec.suspect_since_round is None:
                rec.suspect_since_round = round_idx
            if rec.consecutive_failures >= probation_rounds:
                rec.status = DROPPED
                rec.finished = True
            else:
                rec.status = SUSPECT
                rec.next_retry_round = round_idx + min(
                    2 ** (rec.consecutive_failures - 1),
                    MAX_RETRY_BACKOFF_ROUNDS,
                )
            return rec.status

    def mark_recovered(self, client_id: int) -> bool:
        """A suspect client answered a poll again: clear its probation
        state. Returns True iff this was an actual SUSPECT→ACTIVE
        transition (so callers can count recoveries, not every poll)."""
        with self._lock:
            rec = self._clients.get(client_id)
            if rec is None or rec.status != SUSPECT:
                return False
            rec.status = ACTIVE
            rec.consecutive_failures = 0
            rec.next_retry_round = 0
            rec.suspect_reason = ""
            rec.suspect_since_round = None
            return True

    def update_progress(
        self, client_id: int, current_mb: int, current_epoch: int,
        loss: float, finished: bool,
    ) -> None:
        with self._lock:
            # .get(): a client may disconnect() concurrently with the push
            # that reports its progress — a vanished record is a no-op, not
            # a KeyError that kills the push worker.
            rec = self._clients.get(client_id)
            if rec is None:
                return
            rec.current_mb = current_mb
            rec.current_epoch = current_epoch
            rec.last_loss = loss
            rec.finished = finished or rec.finished

    def disconnect(self, client_id: int) -> None:
        with self._cond:
            self._clients.pop(client_id, None)
            self._cond.notify_all()

    # ---- views -------------------------------------------------------------
    def get(self, client_id: int) -> "ClientRecord | None":
        """O(1) record lookup — the per-push hot path must not copy and
        sort the whole registry to find one member."""
        with self._lock:
            return self._clients.get(client_id)

    def get_clients(self) -> list[ClientRecord]:
        with self._lock:
            return sorted(self._clients.values(), key=lambda c: c.client_id)

    def active_clients(self, round_idx: int | None = None) -> list[ClientRecord]:
        """Clients to poll: ready, not finished/dropped, and — when a
        ``round_idx`` is given — not a suspect still inside its backoff
        window. Without a round, suspects are included regardless (the
        historical membership view)."""
        with self._lock:
            return [
                c for c in self.get_clients()
                if c.ready_for_training and not c.finished
                and (
                    round_idx is None
                    or c.status != SUSPECT
                    or c.next_retry_round <= round_idx
                )
            ]

    def pending_suspects(self, round_idx: int) -> list[ClientRecord]:
        """Suspects whose backed-off retry round is still in the future —
        the reason a reply-less round should wait rather than end the
        federation."""
        with self._lock:
            return [
                c for c in self.get_clients()
                if c.ready_for_training and not c.finished
                and c.status == SUSPECT and c.next_retry_round > round_idx
            ]

    def grace_expired(
        self, round_idx: int, grace_rounds: int
    ) -> list[ClientRecord]:
        """Suspects whose probation streak started ``grace_rounds`` or
        more rounds ago — the shards a supervising root stops counting
        in its quorum denominator (graceful degradation: the federation
        keeps aggregating over live shards instead of skipping every
        round until the dead relay's probation budget runs out).
        ``grace_rounds <= 0`` disables the view (flat-fleet semantics
        unchanged)."""
        if grace_rounds <= 0:
            return []
        with self._lock:
            return [
                c for c in self.get_clients()
                if c.ready_for_training and not c.finished
                and c.status == SUSPECT
                and c.suspect_since_round is not None
                and round_idx - c.suspect_since_round >= grace_rounds
            ]

    def membership_snapshot(self) -> list[dict]:
        """JSON-safe per-client membership view for the live ops endpoint's
        ``/status``: identity, liveness/probation state, and training
        progress (NaN losses become null — JSON has no NaN)."""
        with self._lock:
            return [
                {
                    "client_id": c.client_id,
                    "status": c.status,
                    "address": c.address,
                    "ready": bool(c.ready_for_training),
                    "finished": bool(c.finished),
                    "nr_samples": c.nr_samples,
                    "current_mb": c.current_mb,
                    "current_epoch": c.current_epoch,
                    "last_loss": (
                        None if math.isnan(c.last_loss)
                        else float(c.last_loss)
                    ),
                    "consecutive_failures": c.consecutive_failures,
                    "next_retry_round": c.next_retry_round,
                    "suspect_reason": c.suspect_reason,
                }
                for c in self.get_clients()
            ]

    def membership_summary(self, top_k: int = 5) -> dict:
        """One-pass O(N) *summary* of the membership for the live ops
        endpoint: counts per liveness state,
        ready/finished totals, total weight, and the ``top_k`` members
        with the worst consecutive-failure streaks — NOT the full
        per-client roster, whose 10⁴-entry dict build stalls the ops
        thread at scale (that view stays behind ``/status?full=1``)."""
        with self._lock:
            by_status: dict[str, int] = {}
            ready = finished = 0
            weight = 0.0
            worst: list[tuple[int, int, str]] = []
            for c in self._clients.values():
                by_status[c.status] = by_status.get(c.status, 0) + 1
                ready += bool(c.ready_for_training)
                finished += bool(c.finished)
                weight += c.nr_samples if c.ready_for_training else 0.0
                if c.consecutive_failures > 0:
                    worst.append((
                        c.consecutive_failures, c.client_id,
                        c.suspect_reason,
                    ))
            worst.sort(key=lambda t: (-t[0], t[1]))
            return {
                "total": len(self._clients),
                "by_status": by_status,
                "ready": ready,
                "finished": finished,
                "total_weight": weight,
                "top_failing": [
                    {"client_id": cid, "consecutive_failures": n,
                     "reason": reason}
                    for n, cid, reason in worst[:max(0, int(top_k))]
                ],
            }

    def alive_count(self) -> int:
        """Unfinished, training-ready clients — INCLUDING suspects inside
        their backoff window (they will be polled again). The async
        engine's effective buffer shrinks to this so a fleet smaller
        than the configured buffer still aggregates."""
        with self._lock:
            return sum(
                1 for c in self._clients.values()
                if c.ready_for_training and not c.finished
            )

    def total_weight(self) -> float:
        with self._lock:
            return float(
                sum(c.nr_samples for c in self._clients.values()
                    if c.ready_for_training)
            )

    def __len__(self) -> int:
        with self._lock:
            return len(self._clients)
