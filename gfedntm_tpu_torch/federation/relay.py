"""Hierarchical aggregation tier: the mid-level relay process.

Counterpart of ``gfedntm_tpu/federation/relay.py``. A :class:`RelayNode`
terminates a *shard* of clients with the same servicer, gate and data-plane
code the root server runs, pre-reduces their admitted updates into ONE
pseudo-update with :func:`~gfedntm_tpu_torch.federated.aggregation.weighted_mean`
(summed sample weight), and forwards it upstream as an ordinary client — so
the root's per-round work is O(relays), not O(clients), and each relay's is
O(its shard). The weighted mean of shard-weighted means with summed weights
is the flat population's weighted mean, so a two-tier topology reproduces
the flat FedAvg trajectory up to float re-association.

Protocol-wise the relay is both sides at once:

- **downstream** it serves ``gfedntm.Federation`` to its members —
  vocabulary intake, a GlobalSetup that mirrors the root's consensus (with
  relay-minted member session tokens), readiness with the durable-session
  classification (Ack 3 resets after a recovery, ``member_rehomed`` for a
  member of a dead tier) — and pushes re-encoded aggregates; it refuses
  ``PushUpdate`` (members are polled);
- **upstream** it serves ``gfedntm.FederationClient`` to the root: a
  ``TrainStep`` fans out to the shard, gates the replies through a full
  :class:`~gfedntm_tpu_torch.federation.sanitize.UpdateGate` (a poisoner
  behind a relay is screened at the relay), and answers with the
  pre-reduced pseudo-update; an ``ApplyAggregate`` is decoded once and
  re-broadcast to the shard with the relay's own per-recipient downlink
  encoding.

A relay sees its members' raw updates: place it inside the trust domain of
the clients it terminates (one relay per institution). Wire sessions are
per hop, so a delta or top-k codec applies on both tiers independently.

The shard journal (a ``RoundJournal`` record with ``extra`` = ``relay``,
``upstream_session``, ``codec_id``, ``setup_base_b64``) is the JAX
package's format: either package's relay adopts the other's journal of the
same relay id, and :meth:`RelayNode.maybe_autorecover` refuses another
relay's. All state is host-side numpy; ``device`` (``None`` is the GPU)
holds only the template model the shared key set is read from.

Unlike the JAX relay, the member seqs' base is in milliseconds (the JAX
relay's is in whole seconds): a respawn within the second of a kill must
not reissue seqs its members would answer from their replay caches.
"""

from __future__ import annotations

import base64
import itertools
import json
import logging
import math
import os
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from gfedntm_tpu_torch.data.vocab import Vocabulary, union_vocabularies
from gfedntm_tpu_torch.device import resolve_device
from gfedntm_tpu_torch.federated.aggregation import weighted_mean
from gfedntm_tpu_torch.federated.stepper import FederatedStepper
from gfedntm_tpu_torch.federation import codec, rpc
from gfedntm_tpu_torch.federation.client import load_global_setup
from gfedntm_tpu_torch.federation.compression import (
    DownlinkDecoder,
    DownlinkEncoder,
    UplinkDecoder,
    UplinkEncoder,
    WireCodec,
    encode_push_for_recipients,
)
from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb
from gfedntm_tpu_torch.federation.registry import (
    DROPPED,
    SUSPECT,
    Federation,
    looks_like_session_token,
)
from gfedntm_tpu_torch.federation.resilience import RetryPolicy
from gfedntm_tpu_torch.federation.sanitize import UpdateGate, decode_and_admit
from gfedntm_tpu_torch.federation.server import build_template_model
from gfedntm_tpu_torch.train.checkpoint import CheckpointIntegrityError, RoundJournal
from gfedntm_tpu_torch.utils import flightrec
from gfedntm_tpu_torch.utils.observability import (
    FleetRegistry,
    TelemetryShipper,
    encode_telemetry_report,
    span,
)


class RelayNode:
    """One mid-tier aggregator: terminates ``min_members`` clients and joins
    the upstream federation as client ``relay_id``.

    The keywords are the JAX relay's, plus ``device``. ``sanitize``,
    ``outlier_mad_k`` and ``max_update_norm`` parameterize the relay's own
    admission gate over its shard; ``fault_injector`` scripts faults into
    the relay's member stubs; ``save_dir`` with ``journal_every > 0`` keeps
    the shard journal; ``liveness_timeout``/``reconnect_window`` drive the
    upstream watchdog; ``dump_dir`` arms a flight recorder."""

    def __init__(
        self,
        relay_id: int,
        upstream_address: str,
        min_members: int,
        listen_address: str = "[::]:0",
        advertise_host: str = "localhost",
        logger: logging.Logger | None = None,
        metrics=None,
        sanitize: bool = True,
        outlier_mad_k: float = 4.0,
        max_update_norm: float | None = None,
        probation_rounds: int = 3,
        poll_workers: int = 16,
        setup_timeout: float = 3600.0,
        retry_policy: RetryPolicy | None = None,
        fault_injector=None,
        wire_codec: str | None = "auto",
        save_dir: str | None = None,
        journal_every: int = 1,
        liveness_timeout: float = 300.0,
        watchdog_poll_s: float = 2.0,
        reconnect_window: float = 180.0,
        dump_dir: str | None = None,
        flightrec_entries: int = 2048,
        flightrec_seconds: float = 300.0,
        device=None,
    ):
        if relay_id <= 0:
            raise ValueError("relay ids are upstream client ids (>= 1)")
        self.device = resolve_device(device)
        self.relay_id = relay_id
        self.upstream_address = upstream_address
        self.listen_address = listen_address
        self.advertise_host = advertise_host
        self.logger = logger or logging.getLogger(f"Relay{relay_id}")
        self.metrics = metrics
        self.setup_timeout = float(setup_timeout)
        self.poll_workers = int(poll_workers)
        self.probation_rounds = int(probation_rounds)
        self.retry_policy = retry_policy or RetryPolicy(metrics=metrics)
        self.fault_injector = fault_injector
        self.wire_codec_spec = wire_codec
        # Shard crash recovery: the shard (member tokens, codec posture, last
        # applied round, upstream session, the serialized downstream setup)
        # is journaled every `journal_every` applied rounds, so a killed
        # relay respawned with the same arguments restores the tier
        # (maybe_autorecover). 0 disables journaling and autorecovery.
        self.save_dir = save_dir
        self.journal_every = int(journal_every)
        self._round_journal: RoundJournal | None = None
        self._journal_disabled = False
        self._recovered = False
        self._recovered_at: float | None = None
        self._resume_ready_needed: int | None = None
        # Upstream liveness: the root drives this relay by polling it; a
        # root silent past `liveness_timeout` triggers a token re-present
        # for up to `reconnect_window` seconds before the shard is given up.
        self.liveness_timeout = float(liveness_timeout)
        self.watchdog_poll_s = float(watchdog_poll_s)
        self.reconnect_window = float(reconnect_window)
        self._last_upstream = time.monotonic()
        self._watchdog: threading.Thread | None = None

        self.federation = Federation(min_clients=min_members)
        self.update_gate = UpdateGate(
            check_finite=bool(sanitize),
            mad_k=float(outlier_mad_k) if sanitize else 0.0,
            max_update_norm=max_update_norm if sanitize else None,
            metrics=metrics, logger=self.logger,
        )

        # Fleet telemetry: a shard-local registry absorbs the members'
        # reports, and the upstream shipper sends one merged
        # "relayN:shard" node (plus the relay's own registry) on the
        # StepReply it already answers — O(relays) at the root.
        self.fleet = FleetRegistry(metrics=metrics)
        self._shipper = TelemetryShipper(nodes_fn=self._telemetry_nodes)

        # Incident forensics: dump_dir arms a flight recorder and a local
        # trigger, and lets the relay answer a root's capture token with its
        # members' rings and its own in one bundle. Unset constructs nothing.
        self.dump_dir = dump_dir
        self._incident_trigger = None
        self._last_capture_token = ""  # guarded-by: _lock
        if dump_dir is not None and metrics is not None:
            recorder = flightrec.FlightRecorder(
                max_entries=flightrec_entries,
                max_seconds=flightrec_seconds,
                registry=metrics.registry,
            )
            metrics.recorder = recorder
            self._incident_trigger = flightrec.IncidentTrigger(
                recorder, dump_dir, metrics=metrics,
                node=metrics.node or f"relay{relay_id}",
            )

        # Serializes the train/apply data plane (the root never overlaps
        # calls to one client; the lock makes it a fact).
        self._lock = threading.RLock()
        self._setup_lock = threading.Lock()
        self._setup_ready = threading.Event()
        self._setup_base: pb.GlobalSetup | None = None
        # The setup base as the journal stores it (base64 of the serialized
        # GlobalSetup, ~3x the model's shared state): it never changes after
        # the join, so it is encoded once, not at every journaled round.
        self._setup_base_b64: str | None = None
        self._ready_sent = False
        self.session_token = ""
        self.global_vocab: Vocabulary | None = None
        self._template_flat: dict[str, np.ndarray] | None = None
        self._current: dict[str, np.ndarray] | None = None
        self._applied_round = -1
        self._last_seq = 0
        self._last_reply: pb.StepReply | None = None
        # The round each member last acked (the per-recipient downlink
        # encoding reads it).
        self._member_acked: dict[int, int] = {}  # guarded-by: _lock
        # Member seqs: monotonic across respawns, in milliseconds (2^20 seqs
        # per millisecond of the previous process's life).
        self._member_seq = (time.time_ns() // 1_000_000) << 20
        self._seq_counter = itertools.count(1)

        self._codec: WireCodec | None = None
        self._uplink_up: UplinkEncoder | None = None      # relay -> root
        self._downlink_up: DownlinkDecoder | None = None  # root -> relay
        self._uplink_down: UplinkDecoder | None = None    # members -> relay
        self._downlink_down: DownlinkEncoder | None = None  # relay -> members

        self._grpc_server = None
        self._member_stubs: dict[int, tuple] = {}
        self._pool = ThreadPoolExecutor(max_workers=self.poll_workers)
        self._advertised_address = ""
        self.stopped = threading.Event()
        self._finalized = False

    # ---- lifecycle ---------------------------------------------------------
    def start(self) -> str:
        """Open the upstream channel and serve both protocol faces; returns
        the relay's advertised address."""
        channel = rpc.make_channel(self.upstream_address)
        self._fed_stub = rpc.ServiceStub(
            channel, "gfedntm.Federation",
            metrics=self.metrics, peer="root",
            retry_policy=self.retry_policy,
        )
        self._grpc_server = rpc.make_server(
            max_workers=max(self.poll_workers,
                            2 * self.federation.min_clients + 4)
        )
        rpc.add_service(
            self._grpc_server, "gfedntm.Federation", self,
            metrics=self.metrics,
        )
        rpc.add_service(
            self._grpc_server, "gfedntm.FederationClient", self,
            metrics=self.metrics,
        )
        port = self._grpc_server.add_insecure_port(self.listen_address)
        self._grpc_server.start()
        self._advertised_address = f"{self.advertise_host}:{port}"
        if self.liveness_timeout > 0:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop,
                name=f"relay{self.relay_id}-watchdog", daemon=True,
            )
            self._watchdog.start()
        self.logger.info(
            "relay %d serving %d-member shard on %s (upstream %s)",
            self.relay_id, self.federation.min_clients,
            self._advertised_address, self.upstream_address,
        )
        return self._advertised_address

    def wait_done(self, timeout: float | None = None) -> bool:
        return self.stopped.wait(timeout)

    def shutdown(self, grace: float = 0.5) -> None:
        if self._grpc_server is not None:
            self._grpc_server.stop(grace)
        self._pool.shutdown(wait=False)
        for _addr, channel, _stub in self._member_stubs.values():
            channel.close()

    def abort(self) -> None:
        """Hard-crash simulation: tear both protocol faces down now — no
        stop broadcast to the shard, no finalize, no journal finished-stamp
        — so a respawned relay with the same arguments exercises
        :meth:`maybe_autorecover` as after a real kill."""
        if self._grpc_server is not None:
            # Stop serving before flagging stopped: a member RPC racing the
            # abort must fail like a dead process, not be answered
            # "federation already finished".
            self._grpc_server.stop(0)
        self.stopped.set()  # parks the watchdog; _finalize was not run
        self._pool.shutdown(wait=False)
        for _addr, channel, _stub in self._member_stubs.values():
            channel.close()

    # ---- downstream Federation service (members -> relay) ------------------
    def OfferVocab(self, request: pb.VocabOffer, context) -> pb.Ack:
        self.federation.connect_vocab(
            request.client_id, tuple(request.tokens), request.nr_samples
        )
        self.logger.info(
            "relay %d: member %d offered %d tokens (%.0f samples)",
            self.relay_id, request.client_id, len(request.tokens),
            request.nr_samples,
        )
        return pb.Ack(code=0, detail="vocab accepted by relay")

    def GetGlobalSetup(self, request: pb.JoinRequest, context) -> pb.GlobalSetup:
        """Block for the shard's vocabulary quorum, run the upstream join
        once (the union vocabulary and summed weight offered as this relay's
        own), then mirror the root's consensus downstream with a
        relay-minted member session token. A recovered relay holds the
        setup base from its journal already: a late joiner must not block
        on a vocabulary quorum the restored shard will never re-offer."""
        if not self._setup_ready.is_set():
            self.federation.wait_vocab_quorum()
        with self._setup_lock:
            if self._setup_base is None:
                self._setup_base = self._upstream_setup()
                self._setup_ready.set()
            base = self._setup_base
        client_id = int(request.client_id)
        if client_id <= 0:
            return base
        token = uuid.uuid4().hex
        self.federation.set_session_token(client_id, token)
        with self._lock:
            self._member_acked.pop(client_id, None)
        reply = pb.GlobalSetup()
        reply.CopyFrom(base)
        reply.session_token = token
        return reply

    def _upstream_setup(self) -> pb.GlobalSetup:
        """The once-per-relay upstream join: offer the shard's union
        vocabulary under the relay's identity, block on the root's
        consensus, negotiate the per-hop codec sessions, and build the
        downstream GlobalSetup base (same consensus, relay-paced)."""
        members = [
            c for c in self.federation.get_clients() if c.vocab_sent
        ]
        union = union_vocabularies([Vocabulary(c.vocab) for c in members])
        weight = float(sum(c.nr_samples for c in members))
        with span(self.metrics, "relay_join", relay=self.relay_id):
            self._fed_stub.OfferVocab(pb.VocabOffer(
                client_id=self.relay_id, tokens=list(union.tokens),
                nr_samples=weight,
            ))
            setup = self._fed_stub.GetGlobalSetup(
                pb.JoinRequest(client_id=self.relay_id),
                timeout=self.setup_timeout,
            )
        self.session_token = setup.session_token or ""
        self._last_upstream = time.monotonic()
        if (setup.pacing_id or "").startswith("push"):
            # The relay is polled by the root (TrainStep fan-out); it does
            # not originate PushUpdate rounds. A push-paced root would never
            # drive this shard: fail the join loudly instead.
            raise ValueError(
                f"relay {self.relay_id}: the upstream federation paces "
                f"{setup.pacing_id!r}, but the relay tier requires a "
                "polled policy (sync/cohort/async) — run the root "
                "without push pacing"
            )
        self.global_vocab = Vocabulary(tuple(setup.vocab))
        self._negotiate_codec(setup.codec_id or "none")
        self._adopt_template(setup)
        self.logger.info(
            "relay %d joined upstream: %d members, %.0f total weight, "
            "vocab %d, codec %r",
            self.relay_id, len(members), weight, len(self.global_vocab),
            self._codec.codec_id,
        )
        if self.metrics is not None:
            self.metrics.log(
                "relay_joined", relay=self.relay_id,
                members=len(members), weight=weight,
            )
        base = pb.GlobalSetup()
        base.CopyFrom(setup)
        # Members are paced by this relay (it fans the root's polls out),
        # never directly by the root's policy.
        base.pacing_id = "sync"
        base.session_token = ""
        return base

    def _adopt_template(self, setup: pb.GlobalSetup) -> None:
        """The shared key set, shapes and dtypes the gate checks and the
        pseudo-update presents, from a template model with the setup's
        initial state (the round-0 reference of the gate's norms)."""
        hyper = json.loads(setup.hyperparams_json)
        template = build_template_model(
            hyper["family"], len(self.global_vocab), hyper["kwargs"],
            device=self.device,
        )
        if len(setup.init_variables.tensors):
            load_global_setup(template, setup, metrics=self.metrics)
        self._template_flat = shared_flat(
            template, tuple(hyper["grads_to_share"])
        )
        self.update_gate.set_template(self._template_flat)

    def _negotiate_codec(self, server_codec_id: str) -> None:
        if self.wire_codec_spec in (None, "auto"):
            self._codec = WireCodec(server_codec_id)
        else:
            self._codec = WireCodec(self.wire_codec_spec)
            if self._codec.codec_id != server_codec_id:
                raise ValueError(
                    f"relay {self.relay_id} configured codec "
                    f"{self._codec.codec_id!r} but the federation runs "
                    f"{server_codec_id!r}"
                )
        if not self._codec.identity:
            m = self.metrics
            self._uplink_up = UplinkEncoder(self._codec, metrics=m)
            self._downlink_up = DownlinkDecoder(self._codec, metrics=m)
            self._uplink_down = UplinkDecoder(
                self._codec, metrics=m,
                max_refs=max(8, 2 * self.federation.min_clients),
            )
            self._downlink_down = DownlinkEncoder(
                self._codec, metrics=m,
                max_views=max(8, 2 * self.federation.min_clients),
            )

    def _reset_upstream_sessions(self) -> None:
        """Drop both directions of the relay-root hop's codec sessions (the
        member hop's chain off this relay, which never lost them)."""
        with self._lock:
            if self._uplink_up is not None:
                self._uplink_up.reset()
            if self._downlink_up is not None:
                self._downlink_up.reset()

    def _upstream_join_request(self, telemetry: bytes = b"") -> pb.JoinRequest:
        return pb.JoinRequest(
            client_id=self.relay_id,
            address=self._advertised_address,
            codec_id=(
                self._codec.codec_id if self._codec is not None else "none"
            ),
            session_token=self.session_token,
            recovered=self._recovered,
            telemetry=telemetry,
        )

    def ReadyForTraining(self, request: pb.JoinRequest, context) -> pb.Ack:
        """Member readiness, classified as the root classifies it: a token
        reconnect against a recovered relay restores the member's shard
        state and orders an Ack 3 codec reset; an unknown token of the valid
        format is a member of a dead tier re-homing here, admitted fresh but
        loud. The upstream ready is (re-)sent once the shard reaches its bar
        — ``min_members``, or after recovery the restored-membership quorum,
        whichever is lower."""
        if self.stopped.is_set():
            return pb.Ack(code=1, detail="federation already finished")
        client_codec = request.codec_id or "none"
        negotiated = (
            self._codec.codec_id if self._codec is not None else "none"
        )
        if client_codec != negotiated:
            return pb.Ack(
                code=2,
                detail=(
                    f"wire codec mismatch: relay runs {negotiated!r}, "
                    f"member offered {client_codec!r}"
                ),
            )
        kind = self.federation.classify_join(
            request.client_id, request.session_token
        )
        self.federation.connect_ready(request.client_id, request.address)
        if request.telemetry:
            self.fleet.ingest_bytes(request.telemetry)
        ack_code, ack_detail = 0, "ready recorded by relay"
        if kind == "restore":
            self.logger.info(
                "relay %d: member %d reconnected with its session token",
                self.relay_id, request.client_id,
            )
            if self.metrics is not None:
                self.metrics.registry.counter("session_restores").inc()
                self.metrics.log(
                    "session_restored", client=request.client_id,
                )
            if (
                self.federation.consume_codec_reset(request.client_id)
                and self._codec is not None
                and not self._codec.identity
            ):
                ack_code = 3
                ack_detail = (
                    "session restored by a recovered relay; reset "
                    "wire-codec sessions"
                )
        elif kind == "new":
            # A fresh process holds no broadcast reference: the next
            # downstream push to it must be self-contained.
            with self._lock:
                self._member_acked.pop(request.client_id, None)
            if looks_like_session_token(request.session_token):
                self.logger.warning(
                    "relay %d: member %d presented an unknown session "
                    "token — re-homed member of a dead tier; admitting "
                    "as a fresh join", self.relay_id, request.client_id,
                )
                if self.metrics is not None:
                    self.metrics.registry.counter("members_rehomed").inc()
                    self.metrics.log(
                        "member_rehomed", client=request.client_id,
                    )
        ready = sum(
            c.ready_for_training for c in self.federation.get_clients()
        )
        needed = self.federation.min_clients
        if self._resume_ready_needed is not None:
            needed = min(needed, self._resume_ready_needed)
        with self._setup_lock:
            if ready >= needed and not self._ready_sent:
                self._ready_sent = True
                ack = self._fed_stub.ReadyForTraining(
                    self._upstream_join_request()
                )
                self.logger.info(
                    "relay %d: shard complete (%d members) — upstream "
                    "ready ack %d", self.relay_id, ready, ack.code,
                )
                self._last_upstream = time.monotonic()
                if self._recovered_at is not None:
                    # Time to quorum after the relay crash (the metric the
                    # `recovery_time` SLO bounds).
                    elapsed = time.monotonic() - self._recovered_at
                    self._recovered_at = None
                    if self.metrics is not None:
                        self.metrics.registry.gauge(
                            "recovery_time_s"
                        ).set(elapsed)
                if ack.code == 1:
                    self._finalize()
                    return pb.Ack(code=1, detail="federation finished")
                if ack.code == 3:
                    # A recovered root restored our session: start the
                    # upstream hop's codec sessions self-contained.
                    self._reset_upstream_sessions()
                # The roster (tokens included) is worth surviving now: a
                # crash before the first applied round must still restore
                # the membership.
                self._journal_shard()
        return pb.Ack(code=ack_code, detail=ack_detail)

    def PushUpdate(self, request: pb.StepReply, context) -> pb.Aggregate:
        """Members of a relay shard are polled, never push-paced — a member
        push means misconfiguration."""
        self.logger.warning(
            "relay %d: member %d sent PushUpdate (shard members are "
            "polled); refusing", self.relay_id, request.client_id,
        )
        return pb.Aggregate(stop=True)

    # ---- upstream FederationClient service (root -> relay) -----------------
    def TrainStep(self, request: pb.StepRequest, context) -> pb.StepReply:
        """One upstream round: fan the poll out to the shard, gate the
        decoded replies, pre-reduce the admitted set with the weighted mean,
        and answer with the pseudo-update (summed weight). A round with no
        admissible member update raises — the root's probation treats the
        relay like any failed client."""
        with self._lock:
            self._last_upstream = time.monotonic()
            seq = int(request.seq)
            if (
                seq and self._last_reply is not None
                and seq <= self._last_seq
            ):
                # Replayed delivery: idempotent, as at a leaf client.
                if self.metrics is not None:
                    self.metrics.registry.counter("rpcs_deduplicated").inc()
                    self.metrics.log(
                        "rpc_deduplicated", client=self.relay_id,
                        method="TrainStep", seq=seq,
                    )
                return self._last_reply
            reply = self._train_round(request)
            if seq:
                self._last_seq = seq
                self._last_reply = reply
            return reply

    def _member_stub(self, rec):
        entry = self._member_stubs.get(rec.client_id)
        if entry is None or entry[0] != rec.address:
            if entry is not None:
                entry[1].close()
            channel = rpc.make_channel(rec.address)
            stub = rpc.ServiceStub(
                channel, "gfedntm.FederationClient",
                metrics=self.metrics, peer=f"client{rec.client_id}",
                retry_policy=self.retry_policy,
                fault_injector=self.fault_injector,
            )
            entry = (rec.address, channel, stub)
            self._member_stubs[rec.client_id] = entry
        return entry[2]

    def _note_member_failure(self, rec, round_idx: int, exc: Exception,
                             what: str, reason: str = "rpc") -> None:
        status = self.federation.mark_suspect(
            rec.client_id, rec.address, round_idx,
            probation_rounds=self.probation_rounds, reason=reason,
        )
        if status == DROPPED:
            self.logger.warning(
                "relay %d: dropping member %d after repeated failed %s "
                "(%s)", self.relay_id, rec.client_id, what, exc,
            )
        else:
            self.logger.warning(
                "relay %d: member %d suspect after failed %s (%s)",
                self.relay_id, rec.client_id, what, exc,
            )

    def _train_round(self, request: pb.StepRequest) -> pb.StepReply:
        round_idx = int(request.global_iter)
        members = self.federation.active_clients(round_idx)
        if not members:
            raise RuntimeError(
                f"relay {self.relay_id}: no pollable members this round"
            )
        was_suspect = frozenset(
            rec.client_id for rec in members if rec.status == SUSPECT
        )
        downstream = pb.StepRequest(
            global_iter=request.global_iter,
            local_steps=request.local_steps,
            broadcast_round=self._applied_round + 1,
            # A solicited flight-record pull fans out with the poll; the
            # relay pre-bundles the members' answers upstream.
            capture_token=request.capture_token,
        )

        def poll(rec):
            req = pb.StepRequest()
            req.CopyFrom(downstream)
            req.seq = self._member_seq + next(self._seq_counter)
            try:
                stub = self._member_stub(rec)
                return rec, stub.TrainStep(req, timeout=None), None
            except Exception as exc:  # noqa: BLE001 — probation accounting
                return rec, None, exc

        with span(self.metrics, "relay_fanout", relay=self.relay_id,
                  round=round_idx, members=len(members)):
            polled = list(self._pool.map(poll, members))
        answered = []
        frec_bundles: list[dict] = []
        for rec, reply, exc in polled:
            if reply is None:
                self._note_member_failure(rec, round_idx, exc, "TrainStep")
                continue
            if reply.telemetry:
                # The members' reports land in the shard-local fleet view;
                # the upstream reply carries their merge.
                self.fleet.ingest_bytes(reply.telemetry)
            if reply.flightrec:
                try:
                    frec_bundles.extend(
                        flightrec.decode_bundles(reply.flightrec)
                    )
                except Exception:  # noqa: BLE001 — best-effort forensics
                    self.logger.warning(
                        "relay %d: member %d flight-record blob not "
                        "decodable; dropping it", self.relay_id,
                        rec.client_id,
                    )
            answered.append((rec, reply))

        if self._uplink_down is not None:
            decode = self._uplink_down.decode
        else:
            def decode(bundle):
                return codec.bundle_to_flatdict(bundle, metrics=self.metrics)

        # The root's decode-and-gate pipeline: the relay screens its members
        # with the same admission, repeat-offender and recovery rules.
        result, losses, records = decode_and_admit(
            answered, decode, self.update_gate, self._current_global(),
            round_idx, metrics=self.metrics, was_suspect=was_suspect,
            on_decode_error=lambda rec, err: self.logger.warning(
                "relay %d: member %d reply not decodable (%s)",
                self.relay_id, rec.client_id, err,
            ),
            on_poisoned=lambda rec, rej: self._note_member_failure(
                rec, round_idx,
                RuntimeError(f"{rej.reason}: {rej.detail}"),
                "update admission", reason="poisoned",
            ),
            on_recovered=self.federation.mark_recovered,
        )
        if not result.accepted:
            raise RuntimeError(
                f"relay {self.relay_id}: round {round_idx} admitted no "
                "member updates"
            )

        pseudo = self._pre_reduce(result.accepted)
        total_w = float(sum(w for _cid, w, _snap in result.accepted))
        loss_num = sum(
            w * losses[cid] for cid, w, _ in result.accepted
            if np.isfinite(losses[cid])
        )
        loss_den = sum(
            w for cid, w, _ in result.accepted
            if np.isfinite(losses[cid])
        )
        mean_loss = float(loss_num / loss_den) if loss_den else float("nan")
        if self.metrics is not None:
            self.metrics.log(
                "relay_preaggregated", relay=self.relay_id,
                round=round_idx, members=len(polled),
                admitted=len(result.accepted), weight=total_w,
            )

        shared = self._encode_upstream(pseudo)
        replies = [records[cid][1] for cid, _w, _s in result.accepted]
        reply = pb.StepReply(
            client_id=self.relay_id,
            shared=shared,
            loss=mean_loss,
            nr_samples=total_w,
            current_mb=max(r.current_mb for r in replies),
            current_epoch=max(r.current_epoch for r in replies),
            finished=all(
                c.finished for c in self.federation.get_clients()
            ),
            base_round=self._applied_round + 1,
            seq=int(request.seq),
            telemetry=self._shipper.build(),
        )
        tok = request.capture_token
        with self._lock:
            fresh_token = bool(tok) and tok != self._last_capture_token
            if fresh_token:
                self._last_capture_token = tok
        if fresh_token:
            # Pre-bundle: the members' solicited snapshots plus this relay's
            # own ring, one upstream blob (token-deduped).
            own = flightrec.build_remote_snapshot(self.metrics, tok)
            if own is not None:
                frec_bundles.extend(flightrec.decode_bundles(own))
            if frec_bundles:
                reply.flightrec = flightrec.encode_bundles(frec_bundles)
        return reply

    def _pre_reduce(self, accepted) -> dict[str, np.ndarray]:
        """The pre-reduction: one pseudo-update whose weight is the sum of
        the admitted member weights (what makes two-tier FedAvg the flat
        one). The mean promotes to float64 (and would average int counters
        as floats): it is cast back to the template's dtypes, or the root's
        conformance gate rejects it as a dtype skew."""
        pseudo = weighted_mean([(w, snap) for _cid, w, snap in accepted])
        return {
            k: np.asarray(v).astype(self._template_flat[k].dtype)
            if k in self._template_flat else np.asarray(v)
            for k, v in pseudo.items()
        }

    def _encode_upstream(self, pseudo: dict[str, np.ndarray]) -> pb.TensorBundle:
        if self._uplink_up is not None:
            return self._uplink_up.encode(pseudo)
        return codec.flatdict_to_bundle(pseudo, metrics=self.metrics)

    def _telemetry_nodes(self) -> dict:
        """The relay's upstream report sources: its own registry plus the
        shard's pre-reduced merge as a single synthetic node."""
        nodes: dict = {}
        if self.metrics is not None:
            node = self.metrics.node or f"relay{self.relay_id}"
            nodes[node] = self.metrics.registry.snapshot()
        shard = self.fleet.merged()
        if shard:
            nodes[f"relay{self.relay_id}:shard"] = shard
        return nodes

    def _current_global(self) -> dict[str, np.ndarray]:
        return (
            self._current if self._current is not None
            else self._template_flat
        )

    def ApplyAggregate(self, request: pb.Aggregate, context) -> pb.AggregateReply:
        """Decode the root's push once, re-broadcast it to the shard with
        the relay's own per-recipient downlink encoding, and account member
        progress. Stop broadcasts and session resets fan out."""
        with self._lock:
            self._last_upstream = time.monotonic()
            if request.stop:
                self._fanout_stop()
                self._finalize()
                return pb.AggregateReply(
                    client_id=self.relay_id, finished=True,
                )
            round_idx = int(request.round)
            if (
                not request.reset_session
                and round_idx <= self._applied_round
            ):
                if self.metrics is not None:
                    self.metrics.registry.counter("rpcs_deduplicated").inc()
                    self.metrics.log(
                        "rpc_deduplicated", client=self.relay_id,
                        method="ApplyAggregate", round=round_idx,
                    )
                return pb.AggregateReply(
                    client_id=self.relay_id,
                    finished=all(
                        c.finished for c in self.federation.get_clients()
                    ),
                )
            if request.reset_session:
                # The root discarded the trajectory our upstream session
                # describes; the shard's sessions chain off ours, so the
                # reset cascades down before anything decodes.
                self.logger.warning(
                    "relay %d: upstream ordered a codec session reset "
                    "(round %d)", self.relay_id, round_idx,
                )
                for session in (
                    self._uplink_up, self._downlink_up,
                    self._uplink_down, self._downlink_down,
                ):
                    if session is not None:
                        session.reset()
                self._member_acked.clear()
            if self._downlink_up is not None:
                average = self._downlink_up.decode(
                    request.shared, round_idx=round_idx
                )
                if self._uplink_up is not None:
                    self._uplink_up.note_aggregate(average, round_idx)
            else:
                average = codec.bundle_to_flatdict(
                    request.shared, metrics=self.metrics
                )
            self._current = average
            self._applied_round = round_idx
            finished = self._fanout_aggregate(
                average, round_idx, bool(request.reset_session)
            )
            if self.journal_every > 0 and round_idx % self.journal_every == 0:
                self._journal_shard()
            return pb.AggregateReply(
                client_id=self.relay_id, finished=finished,
            )

    def _fanout_aggregate(
        self, average: dict[str, np.ndarray], round_idx: int, reset: bool
    ) -> bool:
        """Re-broadcast one decoded aggregate to every unfinished member,
        per-recipient encoded against each member's own acked round."""
        members = [
            c for c in self.federation.get_clients()
            if c.ready_for_training and not c.finished
        ]
        aggs = encode_push_for_recipients(
            self._downlink_down, self._uplink_down, average, round_idx,
            [rec.client_id for rec in members], self._member_acked,
            reset, metrics=self.metrics,
        )

        def push(rec):
            try:
                ack = self._member_stub(rec).ApplyAggregate(
                    aggs[rec.client_id]
                )
                self.federation.update_progress(
                    rec.client_id, rec.current_mb, ack.current_epoch,
                    rec.last_loss, finished=ack.finished,
                )
                return rec.client_id
            except Exception as exc:  # noqa: BLE001 — probation accounting
                self._note_member_failure(
                    rec, round_idx, exc, "ApplyAggregate"
                )
                return None

        with span(self.metrics, "relay_push", relay=self.relay_id,
                  round=round_idx, members=len(members)):
            acked = {
                cid for cid in self._pool.map(push, members)
                if cid is not None
            }
        # Reentrant: ApplyAggregate holds _lock already; taking it here
        # keeps the guard local to the mutation.
        with self._lock:
            for rec in members:
                if rec.client_id in acked:
                    self._member_acked[rec.client_id] = round_idx
                else:
                    self._member_acked.pop(rec.client_id, None)
        return all(c.finished for c in self.federation.get_clients())

    def _fanout_stop(self) -> None:
        stop = pb.Aggregate(stop=True)
        for rec in self.federation.get_clients():
            if not rec.ready_for_training:
                continue
            try:
                self._member_stub(rec).ApplyAggregate(stop)
            except Exception as exc:  # noqa: BLE001 — best-effort stop
                self.logger.warning(
                    "relay %d: stop broadcast to member %d failed: %s",
                    self.relay_id, rec.client_id, exc,
                )

    def _finalize(self) -> None:
        if self._finalized:
            return
        self._finalized = True
        self._mark_journal_finished()
        self.logger.info(
            "relay %d: federation finished after round %d",
            self.relay_id, self._applied_round,
        )
        if self.metrics is not None:
            self.metrics.snapshot_registry(relay=self.relay_id)
        self.stopped.set()

    # ---- the shard journal -------------------------------------------------
    def _journal(self) -> RoundJournal:
        if self._round_journal is None:
            if self.save_dir is None:
                raise ValueError("the shard journal requires save_dir")
            self._round_journal = RoundJournal(
                os.path.join(self.save_dir, "checkpoints")
            )
        return self._round_journal

    def _membership_state(self) -> "list[dict]":
        """JSON-able shard membership (member session tokens included), the
        snapshot shape the root journals, so a respawned relay re-admits
        member token reconnects."""
        return [
            {
                "client_id": c.client_id,
                "nr_samples": c.nr_samples,
                "current_mb": c.current_mb,
                "current_epoch": c.current_epoch,
                "finished": bool(c.finished),
                "status": c.status,
                "session_token": c.session_token,
            }
            for c in self.federation.get_clients()
        ]

    def _note_journal_write_failure(self, round_idx: int,
                                    err: Exception) -> None:
        """A shard-journal write hit the filesystem's failure surface
        (ENOSPC, EIO): degrade loudly — ``journal_write_failed`` event and
        counter — and disable journaling for the rest of the run. The shard
        keeps training; only autorecovery is forfeited."""
        self._journal_disabled = True
        self.logger.error(
            "relay %d: shard journal write at round %d failed (%s); "
            "journaling disabled for this run — a crash now loses the "
            "shard", self.relay_id, round_idx, err,
        )
        if self.metrics is not None:
            self.metrics.registry.counter("journal_write_failures").inc()
            self.metrics.log(
                "journal_write_failed", round=round_idx, error=str(err),
            )

    def _journal_shard(self) -> None:
        """Journal the shard: member roster (tokens included), upstream
        session, codec id, last applied round and broadcast average, and
        the serialized downstream setup base — everything
        ``maybe_autorecover`` needs. ``round == -1`` is the valid
        pre-first-round roster journal."""
        if (
            self.journal_every <= 0 or self.save_dir is None
            or self._journal_disabled or self._setup_base is None
        ):
            return
        try:
            self._journal().record(
                self._applied_round,
                self._current_global(),
                self._membership_state(),
                vocab=list(self.global_vocab.tokens),
                extra={
                    "relay": self.relay_id,
                    "upstream_session": self.session_token,
                    "codec_id": (
                        self._codec.codec_id if self._codec is not None
                        else "none"
                    ),
                    "setup_base_b64": self._journaled_setup_base(),
                },
            )
        except OSError as err:
            self._note_journal_write_failure(self._applied_round, err)
        except Exception:
            self.logger.exception(
                "relay %d: shard journal write at round %d failed",
                self.relay_id, self._applied_round,
            )
            if self.metrics is not None:
                self.metrics.registry.counter("journal_errors").inc()

    def _journaled_setup_base(self) -> str:
        if self._setup_base_b64 is None:
            self._setup_base_b64 = base64.b64encode(
                self._setup_base.SerializeToString()
            ).decode("ascii")
        return self._setup_base_b64

    def _mark_journal_finished(self) -> None:
        """Stamp the journal after a normal stop so the next start under
        this save_dir begins fresh. Attempted even when a write failure
        disabled journaling: only the stamp stops the next start from
        resurrecting a stale journal."""
        if self.journal_every <= 0 or self.save_dir is None:
            return
        try:
            self._journal().mark_finished()
        except Exception:
            self.logger.exception(
                "relay %d: marking the shard journal finished failed",
                self.relay_id,
            )
            if self.metrics is not None:
                self.metrics.registry.counter("journal_errors").inc()

    def maybe_autorecover(self) -> "int | None":
        """Relay crash recovery (call before :meth:`start`): when
        ``save_dir`` holds a shard journal of an interrupted run, restore
        the tier — consensus vocabulary, codec sessions (fresh), downstream
        setup base, upstream session token, last applied round and average,
        member roster with tokens — and return the resume round; ``None``
        is a fresh start (no journal, or the previous run finished). The
        restored members are not ready: each must token-reconnect (getting
        an Ack 3 codec reset), and the upstream ready is re-sent with
        ``recovered=True`` once the restored-membership quorum re-forms.
        A journal of another relay id, or corrupt state, raises."""
        if self.save_dir is None or self.journal_every <= 0:
            return None
        try:
            finished = bool(
                (self._journal().load_meta() or {}).get("finished")
            )
        except CheckpointIntegrityError:
            finished = False
        if finished:
            self.logger.info(
                "relay %d: previous shard under %s finished cleanly; "
                "starting fresh", self.relay_id, self.save_dir,
            )
            return None
        jstate = self._journal().load()
        if jstate is None:
            return None
        if int(jstate.get("relay", self.relay_id)) != self.relay_id:
            raise ValueError(
                f"shard journal under {self.save_dir} belongs to relay "
                f"{jstate.get('relay')}, not relay {self.relay_id} — "
                "refusing to adopt another tier's shard"
            )
        self.global_vocab = Vocabulary(tuple(jstate["vocab"]))
        self._negotiate_codec(jstate.get("codec_id") or "none")
        base = pb.GlobalSetup.FromString(
            base64.b64decode(jstate["setup_base_b64"])
        )
        self._adopt_template(base)
        with self._setup_lock:
            self._setup_base = base
            self._setup_base_b64 = jstate["setup_base_b64"]
            self._setup_ready.set()
        self.session_token = jstate.get("upstream_session") or ""
        round_idx = int(jstate["round"])
        self._applied_round = round_idx
        if round_idx >= 0:
            # The journaled average comes back from the npz as written;
            # present the template dtypes downstream.
            self._current = {
                k: np.asarray(v).astype(self._template_flat[k].dtype)
                if k in self._template_flat else np.asarray(v)
                for k, v in jstate["average"].items()
            }
        unfinished = 0
        codec_live = self._codec is not None and not self._codec.identity
        for m in jstate.get("membership", []):
            self.federation.restore_member(
                int(m["client_id"]),
                nr_samples=float(m.get("nr_samples", 0.0)),
                session_token=m.get("session_token", ""),
                finished=bool(m.get("finished")),
                current_mb=int(m.get("current_mb", 0)),
                current_epoch=int(m.get("current_epoch", 0)),
                needs_codec_reset=codec_live,
            )
            if not m.get("finished"):
                unfinished += 1
        if unfinished:
            # Resume quorum: half the restored unfinished members — a member
            # that died with the relay must not hold the shard hostage (the
            # root's probation covers the gap).
            self._resume_ready_needed = max(1, math.ceil(0.5 * unfinished))
        self._recovered = True
        self._recovered_at = time.monotonic()
        self.logger.warning(
            "relay %d: auto-recovered an interrupted shard — resuming at "
            "round %d with %d restored members (%d unfinished); awaiting "
            "member token-reconnects", self.relay_id, round_idx,
            len(jstate.get("membership", [])), unfinished,
        )
        if self.metrics is not None:
            self.metrics.registry.counter("relay_recoveries").inc()
            self.metrics.log(
                "relay_recovered", relay=self.relay_id, round=round_idx,
                members=len(jstate.get("membership", [])),
            )
        return round_idx

    # ---- upstream liveness -------------------------------------------------
    def _watchdog_loop(self) -> None:
        """The root drives this relay by polling it; a root silent past
        ``liveness_timeout`` triggers the upstream reconnect loop. Silence
        before the upstream ready is expected (the shard is forming)."""
        while not self.stopped.is_set():
            if self.stopped.wait(self.watchdog_poll_s):
                return
            if not self._ready_sent:
                continue
            idle = time.monotonic() - self._last_upstream
            if idle < self.liveness_timeout:
                continue
            if self._upstream_reconnect(idle):
                continue
            # The upstream is gone for good (window exhausted, finished or
            # refused): release the shard so its members can re-home.
            with self._lock:
                if self.stopped.is_set():
                    return
                self.logger.error(
                    "relay %d: upstream unreachable — stopping the shard "
                    "so members can fail over", self.relay_id,
                )
                self._fanout_stop()
                self._finalize()
            return

    def _upstream_reconnect(self, idle: float) -> bool:
        """RECONNECTING against the root: re-present the relay's session
        token (a fresh upstream ready carrying a full shard telemetry
        report) under capped backoff until the root answers, the window is
        exhausted, or a stop arrives. True resumes the watchdog wait, False
        gives the shard up."""
        start = time.monotonic()
        self.logger.warning(
            "relay %d: no upstream activity for %.0f s — RECONNECTING "
            "(session %s…, up to %.0f s)",
            self.relay_id, idle, self.session_token[:8],
            self.reconnect_window,
        )
        if self.metrics is not None:
            self.metrics.registry.counter("reconnects_entered").inc()
        attempts = 0
        delays = self.retry_policy.delays()
        while not self.stopped.is_set():
            if time.monotonic() - start > self.reconnect_window:
                self.logger.error(
                    "relay %d: reconnect window (%.0f s) exhausted after "
                    "%d attempts", self.relay_id, self.reconnect_window,
                    attempts,
                )
                return False
            attempts += 1
            try:
                # A full report: deltas shipped into the dead connection
                # are lost; one RPC resynchronizes the root's shard view.
                ack = self._fed_stub.ReadyForTraining(
                    self._upstream_join_request(encode_telemetry_report(
                        self._telemetry_nodes(), full=True,
                    )),
                    timeout=10.0,
                )
            except Exception as exc:
                self.logger.info(
                    "relay %d: upstream reconnect attempt %d failed (%s)",
                    self.relay_id, attempts, exc,
                )
                self.stopped.wait(min(next(delays), 5.0))
                continue
            if ack.code == 1:
                self.logger.warning(
                    "relay %d: federation finished while disconnected",
                    self.relay_id,
                )
                return False
            if ack.code == 2:
                self.logger.error(
                    "relay %d: upstream reconnect rejected (%s)",
                    self.relay_id, ack.detail,
                )
                return False
            if ack.code == 3:
                # A recovered root holds none of the upstream hop's codec
                # session state.
                self.logger.warning(
                    "relay %d: recovered root ordered an upstream "
                    "wire-codec session reset", self.relay_id,
                )
                self._reset_upstream_sessions()
            self._last_upstream = time.monotonic()
            downtime = time.monotonic() - start
            self.logger.warning(
                "relay %d: upstream reconnected after %d attempt(s) "
                "(%.1f s offline)", self.relay_id, attempts, downtime,
            )
            if self.metrics is not None:
                self.metrics.registry.counter("client_reconnections").inc()
                self.metrics.log(
                    "client_reconnected", client=self.relay_id,
                    attempts=attempts, downtime_s=downtime,
                )
            return True
        return True  # stop arrived mid-reconnect: nothing left to do


def shared_flat(template, grads_to_share: tuple[str, ...]) -> dict[str, np.ndarray]:
    """The template's shared flat subset in the JAX wire layout ('/'-paths,
    [in, out] kernels, int32 counters) — the authoritative key set the root
    server gates against (``FederatedServer._shared_template``), built
    without holding a server (JAX ``relay.py:1238-1256``)."""
    return FederatedStepper(template, grads_to_share).get_gradients()
