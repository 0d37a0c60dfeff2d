"""Federated server for the cross-datacenter network path.

Counterpart of ``gfedntm_tpu/federation/server.py`` (itself the reference's
``src/federation/server.py:37-553``), the sync path: phase-1 vocabulary
consensus as a gRPC servicer (``OfferVocab``, ``GetGlobalSetup``,
``ReadyForTraining`` with durable-session tokens), then phase-2
per-minibatch orchestration, where the :class:`~gfedntm_tpu_torch.federation.pacing.SyncEngine`
polls every client concurrently for its post-step shared state, FedAvg
weights the replies by their ``nr_samples``, and the average is pushed back
(``ApplyAggregate``); clients that finish early drop out of the polls, and
the run ends with a stop broadcast and ``server_model.npz``.

It speaks the JAX package's protocol byte for byte, so JAX clients join it
and port clients join a JAX server: the ``GlobalSetup`` carries the
template's variables and Adam state in the JAX layout (Flax '/'-paths,
[in, out] kernels, int32 counters, optax's ``[0].count``/``mu``/``nu``;
:mod:`gfedntm_tpu_torch.interop`, :mod:`gfedntm_tpu_torch.federation.codec`).
The template model lives on ``device`` (``None`` is the GPU); FedAvg runs in
numpy on the host, as the JAX server's does on a CPU backend.

The JAX server's other planes are not ported yet, and asking for one raises
``NotImplementedError`` (ROADMAP queue 1): round checkpoints and the
journal (and so resume), the update admission gate beyond conformance
(``sanitize``, ``max_update_norm``), differential privacy, the divergence
guardian, the quality monitor and contribution tracker, the ops endpoint,
SLOs, the device profiler, incident dumps, relay supervision, device-resident
aggregation, the server optimizers and robust mean stages, and cohort,
async and push pacing.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from gfedntm_tpu_torch import interop
from gfedntm_tpu_torch.data.vocab import Vocabulary, union_vocabularies
from gfedntm_tpu_torch.device import resolve_device
from gfedntm_tpu_torch.federated.aggregation import make_aggregator
from gfedntm_tpu_torch.federated.stepper import FederatedStepper
from gfedntm_tpu_torch.federation import codec, pacing, rpc
from gfedntm_tpu_torch.federation.compression import (
    CodecError,
    DownlinkEncoder,
    UplinkDecoder,
    encode_push_for_recipients,
    make_codec,
)
from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb
from gfedntm_tpu_torch.federation.registry import (
    DROPPED,
    Federation,
    looks_like_session_token as _looks_like_session_token,
)
from gfedntm_tpu_torch.federation.resilience import RetryPolicy
from gfedntm_tpu_torch.models.avitm import AVITM
from gfedntm_tpu_torch.models.ctm import CTM
from gfedntm_tpu_torch.models.params import SHARE_ALL
from gfedntm_tpu_torch.utils.observability import StragglerDetector, new_trace_id

#: A client whose replies fail the conformance check this many rounds in a
#: row enters probation (the JAX gate's ``suspect_after``).
SUSPECT_AFTER = 2


def build_template_model(
    family: str, vocab_size: int, model_kwargs: dict[str, Any], device=None,
) -> AVITM:
    """Construct the global template model (server-side init that every
    client replicates, ``server.py:290-331``) on ``device`` (``None`` is the
    GPU)."""
    kwargs = dict(model_kwargs)
    kwargs["input_size"] = int(vocab_size)
    if "hidden_sizes" in kwargs:
        kwargs["hidden_sizes"] = tuple(kwargs["hidden_sizes"])
    if family == "avitm":
        return AVITM(device=device, **kwargs)
    if family == "ctm":
        return CTM(device=device, **kwargs)
    raise ValueError(f"unknown model family {family!r}")


def model_variables(model: AVITM) -> dict:
    """``{"params", "batch_stats"}`` of ``model`` as the JAX package's
    variable tree of numpy arrays."""
    params, batch_stats = interop.flax_from_state_dict(model.model.state_dict())
    return {"params": params, "batch_stats": batch_stats}


def model_opt_state(model: AVITM):
    """``model``'s optimizer state in optax's layout (``inject_hyperparams``
    under ``reduce_on_plateau``, as the JAX model builds it)."""
    return interop.optax_adam_state(model.model, model.optimizer,
                                    inject_lr=model.reduce_on_plateau)


#: JAX server options whose planes are not ported yet, with the values that
#: keep each off (or select what the port has). Any other value raises
#: ``NotImplementedError``.
_QUEUED_OPTIONS = {
    "pacing_policy": ("sync",), "cohort_size": (None,), "async_buffer": (None,),
    "aggregator_kwargs": (None,), "robust_aggregator": (None,),
    "aggregation_backend": ("auto", "numpy"), "checkpoint_every": (0,),
    "journal_every": (0,), "sanitize": (False,), "max_update_norm": (None,),
    "divergence_patience": (0,), "ops_port": (None,), "profiler": (None,),
    "quality_every": (0,), "quality_guard": (False,), "relay_grace_rounds": (0,),
    "slo_specs": (None,), "dp": ("off",), "dump_dir": (None,),
}


class FederatedServer:
    """gRPC servicer + sync training orchestrator.

    Parameters mirror the JAX server's (``min_clients`` = the CLI's
    ``--min_clients_federation``, ``family`` + ``model_kwargs``,
    ``max_iters``, the resilience knobs, ``wire_codec``), plus ``device``
    for the template model. The options of planes that are not ported yet
    (see the module docstring) are accepted only at their off values.

    ``metrics`` is an optional
    :class:`~gfedntm_tpu_torch.utils.observability.MetricsLogger`: each
    round then emits nested ``round → {poll, average, push}`` spans,
    per-client poll-latency histograms and staleness gauges, and RPC/codec
    registry metrics.
    """

    def __init__(
        self,
        min_clients: int,
        family: str = "avitm",
        model_kwargs: dict[str, Any] | None = None,
        grads_to_share: tuple[str, ...] = SHARE_ALL,
        max_iters: int = 25_000,
        save_dir: str | None = None,
        logger: logging.Logger | None = None,
        metrics=None,
        poll_workers: int = 16,
        local_steps: int = 1,
        retry_policy: RetryPolicy | None = None,
        probation_rounds: int = 3,
        quorum_fraction: float = 0.5,
        round_backoff_s: float = 0.5,
        fault_injector=None,
        aggregator="fedavg",
        wire_codec: str = "none",
        codec_ref_cache: int = 8,
        straggler_z: float = 2.0,
        device: str | torch.device | None = None,
        **queued: Any,
    ):
        for name, value in queued.items():
            if name not in _QUEUED_OPTIONS:
                raise TypeError(f"FederatedServer got an unexpected option {name!r}")
            if value not in _QUEUED_OPTIONS[name]:
                raise NotImplementedError(
                    f"FederatedServer({name}={value!r}): that plane of the JAX "
                    "server is not ported yet (ROADMAP queue 1)")
        if local_steps < 1:
            raise ValueError(f"local_steps must be >= 1, got {local_steps}")
        if probation_rounds < 1:
            raise ValueError(
                f"probation_rounds must be >= 1, got {probation_rounds}"
            )
        if not 0.0 <= quorum_fraction <= 1.0:
            raise ValueError(
                f"quorum_fraction must be in [0, 1], got {quorum_fraction}"
            )
        self.device = resolve_device(device)
        self.family = family
        self.model_kwargs = dict(model_kwargs or {})
        self.grads_to_share = tuple(grads_to_share)
        self.max_iters = max_iters
        self.save_dir = save_dir
        self.logger = logger or logging.getLogger("FederatedServer")
        self.metrics = metrics
        self.poll_workers = poll_workers
        self.pacing = pacing.parse_pacing("sync")
        # FedAvg exchange period in local minibatches (1 = the reference's
        # per-minibatch averaging; E>1 = FedAvg proper), carried to clients
        # per StepRequest.
        self.local_steps = int(local_steps)
        self.retry_policy = retry_policy or RetryPolicy(metrics=metrics)
        self.probation_rounds = int(probation_rounds)
        self.quorum_fraction = float(quorum_fraction)
        self.round_backoff_s = float(round_backoff_s)
        self.fault_injector = fault_injector
        self.aggregator = make_aggregator(aggregator)
        # Wire codec, negotiated with every client at join time: the
        # GlobalSetup advertises this id, ReadyForTraining verifies the
        # client runs the same one (mismatch = Ack code 2).
        self.wire_codec = make_codec(wire_codec)
        self._uplink_dec = UplinkDecoder(
            self.wire_codec, metrics=metrics, max_refs=codec_ref_cache,
        )
        self._downlink_enc = DownlinkEncoder(
            self.wire_codec, metrics=metrics, max_views=codec_ref_cache,
        )
        self._codec_lock = threading.Lock()
        # Per-client round of the last acked push: a push may only be
        # delta-encoded against a reference its recipient holds. Written
        # by the training loop and by servicer threads (a rejoiner is
        # discarded in ReadyForTraining), so every mutation holds the lock.
        self._push_lock = threading.Lock()
        self._push_acked: dict[int, int] = {}  # guarded-by: _push_lock
        # Idempotent TrainStep: every delivery carries a server-minted seq,
        # monotonic across restarts (wall-clock epoch base); clients answer
        # a replayed seq from their cache, and `_reply_seen` drops a
        # duplicate StepReply before it can count twice in the average.
        self._seq_epoch = int(time.time()) << 20
        self._seq_counter = itertools.count(1)
        self._reply_seen: dict[int, int] = {}
        self.client_retry_policy = dataclasses.replace(
            self.retry_policy, idempotent=True
        )
        # Clients whose first poll (which builds the kernels) has been seen.
        self._poll_warmed: set[int] = set()
        self.trace_id: str | None = None
        self.straggler = StragglerDetector(
            registry=metrics.registry if metrics is not None else None,
            z_threshold=straggler_z,
        )
        self.federation = Federation(min_clients=min_clients)
        self.template: AVITM | None = None
        self.global_vocab: Vocabulary | None = None
        self.last_average: dict[str, np.ndarray] | None = None
        self.global_betas: np.ndarray | None = None
        self.global_iterations = 0
        self._setup_lock = threading.Lock()
        # Built exactly once under _setup_lock — every joiner blocked in
        # GetGlobalSetup must receive the SAME consensus reply.
        self._setup_reply: pb.GlobalSetup | None = None  # guarded-by: _setup_lock
        self._train_lock = threading.Lock()
        self._train_thread: threading.Thread | None = None  # guarded-by: _train_lock
        # Set BEFORE the stop-broadcast snapshot, so a ReadyForTraining in
        # the shutdown window is turned away with code=1.
        self._stopping = threading.Event()
        self.training_done = threading.Event()
        self._grpc_server = None
        self._template_shared: dict[str, np.ndarray] | None = None
        self._reject_streak: dict[int, int] = {}

    # ---- lifecycle ---------------------------------------------------------
    def start(self, address: str = "[::]:50051") -> str:
        # Every client parks one worker thread inside GetGlobalSetup until
        # quorum; size the pool so intake RPCs can still be dispatched.
        self._grpc_server = rpc.make_server(
            max_workers=max(
                self.poll_workers, 2 * self.federation.min_clients + 4
            )
        )
        rpc.add_service(
            self._grpc_server, "gfedntm.Federation", self,
            metrics=self.metrics,
        )
        port = self._grpc_server.add_insecure_port(address)
        self._grpc_server.start()
        self.logger.info("federation server listening on port %d", port)
        host = address.rsplit(":", 1)[0]
        return f"localhost:{port}" if host in ("[::]", "0.0.0.0") else f"{host}:{port}"

    def stop(self, grace: float = 1.0, join_timeout: float = 10.0) -> None:
        """Graceful shutdown: signal the training loop, give it
        ``join_timeout`` seconds for its stop broadcast and finalization,
        then stop the gRPC server."""
        self._stopping.set()
        t = self._train_thread
        if t is not None and t.is_alive():
            t.join(join_timeout)
            if t.is_alive():
                self.logger.warning(
                    "training thread still running after %.1fs; stopping "
                    "the gRPC server anyway", join_timeout,
                )
        if self._grpc_server is not None:
            self._grpc_server.stop(grace)

    def wait_done(self, timeout: float | None = None) -> bool:
        return self.training_done.wait(timeout)

    # ---- Federation service (client -> server) -----------------------------
    def OfferVocab(self, request: pb.VocabOffer, context) -> pb.Ack:
        """Phase-1 vocabulary intake (``sendLocalDic``, ``server.py:175-210``)."""
        self.federation.connect_vocab(
            request.client_id, tuple(request.tokens), request.nr_samples
        )
        self.logger.info(
            "client %d offered %d tokens (%.0f samples)",
            request.client_id, len(request.tokens), request.nr_samples,
        )
        return pb.Ack(code=0, detail=f"vocab of {len(request.tokens)} accepted")

    def GetGlobalSetup(self, request: pb.JoinRequest, context) -> pb.GlobalSetup:
        """Blocks for vocabulary quorum, then returns the agreed vocabulary +
        replicated initial model/optimizer state, plus a freshly minted
        durable-session token."""
        self.federation.wait_vocab_quorum()
        with self._setup_lock:
            if self._setup_reply is None:
                self._setup_reply = self._build_setup_reply()
            base = self._setup_reply
        return self._mint_session(int(request.client_id), base)

    def _mint_session(
        self, client_id: int, base: pb.GlobalSetup
    ) -> pb.GlobalSetup:
        """Per-client GlobalSetup: the shared consensus reply plus a fresh
        session token. Passing through GetGlobalSetup defines a client as a
        NEW process, so server-side state of the old process is discarded."""
        if client_id <= 0:
            return base
        token = uuid.uuid4().hex
        self.federation.set_session_token(client_id, token)
        self._forget_process(client_id)
        reply = pb.GlobalSetup()
        reply.CopyFrom(base)
        reply.session_token = token
        return reply

    def _forget_process(self, client_id: int) -> None:
        """Drop what describes a client's previous process: its push-ack
        posture, reply-seq guard, poll warm-up and straggler EWMA."""
        with self._push_lock:
            self._push_acked.pop(client_id, None)
        self._reply_seen.pop(client_id, None)
        self._poll_warmed.discard(client_id)
        self.straggler.forget(client_id)

    def _build_setup_reply(self) -> pb.GlobalSetup:
        vocabs = [
            Vocabulary(c.vocab) for c in self.federation.get_clients()
            if c.vocab_sent
        ]
        self.global_vocab = union_vocabularies(vocabs)
        self.template = build_template_model(
            self.family, len(self.global_vocab), self.model_kwargs,
            device=self.device,
        )
        self.logger.info(
            "consensus: %d clients, global vocabulary %d tokens",
            len(vocabs), len(self.global_vocab),
        )
        return self._setup_reply_from_template()

    def _setup_reply_from_template(self) -> pb.GlobalSetup:
        """The GlobalSetup message for the current vocabulary + template
        state: variables and Adam state in the JAX layout."""
        hyper = {
            "family": self.family,
            "kwargs": {**self.model_kwargs, "input_size": len(self.global_vocab)},
            "grads_to_share": list(self.grads_to_share),
        }
        return pb.GlobalSetup(
            vocab=list(self.global_vocab.tokens),
            model_family=self.family,
            codec_id=self.wire_codec.codec_id,
            pacing_id=self.pacing.spec_id,
            local_steps=self.local_steps,
            hyperparams_json=json.dumps(hyper),
            init_variables=codec.tree_to_bundle(
                model_variables(self.template), metrics=self.metrics
            ),
            init_opt_state=codec.tree_to_bundle(
                model_opt_state(self.template), metrics=self.metrics
            ),
        )

    def _shared_template(self) -> dict[str, np.ndarray]:
        """The template model's shared flat subset — the authoritative key
        set, shapes and dtypes every client reply must match."""
        if self._template_shared is None:
            self._template_shared = FederatedStepper(
                self.template, self.grads_to_share).get_gradients()
        return self._template_shared

    def ReadyForTraining(self, request: pb.JoinRequest, context) -> pb.Ack:
        """Client readiness signal; the training thread starts exactly once
        when quorum is reached (``trainFederatedModel``,
        ``server.py:365-406``). A client (re)joining after the federation
        finished gets ``code=1``; a codec mismatch gets ``code=2``."""
        if self._stopping.is_set() or self.training_done.is_set():
            return pb.Ack(code=1, detail="federation already finished")
        client_codec = request.codec_id or "none"
        if client_codec != self.wire_codec.codec_id:
            self.logger.error(
                "client %d runs wire codec %r but this federation "
                "negotiated %r; rejecting join",
                request.client_id, client_codec, self.wire_codec.codec_id,
            )
            if self.metrics is not None:
                self.metrics.registry.counter("codec_mismatches").inc()
                self.metrics.log(
                    "codec_mismatch", client=request.client_id,
                    server_codec=self.wire_codec.codec_id,
                    client_codec=client_codec,
                )
            return pb.Ack(
                code=2,
                detail=(
                    f"wire codec mismatch: federation runs "
                    f"{self.wire_codec.codec_id!r}, client offered "
                    f"{client_codec!r}"
                ),
            )
        # Durable sessions: a ready presenting a still-current token is a
        # live process reconnecting — its server-side state survives. A
        # token-less or mismatched ready is a fresh process.
        kind = self.federation.classify_join(
            request.client_id, request.session_token
        )
        self.federation.connect_ready(request.client_id, request.address)
        if kind == "restore":
            self.logger.info(
                "client %d reconnected with its session token",
                request.client_id,
            )
            if self.metrics is not None:
                self.metrics.registry.counter("session_restores").inc()
                self.metrics.log(
                    "session_restored", client=request.client_id,
                )
        elif kind == "new":
            if _looks_like_session_token(request.session_token):
                self.logger.warning(
                    "client %d presented an unknown session token — "
                    "re-homed member of a dead tier; admitting as a "
                    "fresh join", request.client_id,
                )
                if self.metrics is not None:
                    self.metrics.registry.counter("members_rehomed").inc()
                    self.metrics.log(
                        "member_rehomed", client=request.client_id,
                    )
            self._forget_process(request.client_id)
        if self._stopping.is_set() or self.training_done.is_set():
            return pb.Ack(code=1, detail="federation already finished")
        with self._train_lock:
            if (
                self._train_thread is None
                and sum(
                    c.ready_for_training
                    for c in self.federation.get_clients()
                )
                >= self.federation.min_clients
            ):
                self._train_thread = threading.Thread(
                    target=self._run_training, name="federated-training",
                    daemon=True,
                )
                self._train_thread.start()
        return pb.Ack(code=0, detail="ready recorded")

    # ---- phase-2 training loop (server.py:408-553) -------------------------
    def _stub_for(self, stubs: dict, rec) -> rpc.ServiceStub | None:
        """Persistent per-client stub, created on first use and keyed by
        (client, address): a rejoining client usually serves on a new
        port, so a stale cached channel is closed and replaced."""
        if not rec.address:
            entry = stubs.get(rec.client_id)
            return entry[2] if entry else None
        entry = stubs.get(rec.client_id)
        if entry is None or entry[0] != rec.address:
            if entry is not None:
                entry[1].close()
            channel = rpc.make_channel(rec.address)
            # Training RPCs are idempotent (seq-numbered TrainStep, round-
            # deduplicated ApplyAggregate): the stubs run the idempotent
            # retry twin.
            stub = rpc.ServiceStub(
                channel, "gfedntm.FederationClient",
                metrics=self.metrics, peer=f"client{rec.client_id}",
                retry_policy=self.client_retry_policy,
                fault_injector=self.fault_injector,
            )
            entry = (rec.address, channel, stub)
            stubs[rec.client_id] = entry
        return entry[2]

    def _note_client_failure(self, rec, addr: str, round_idx: int,
                             exc: Exception, what: str,
                             reason: str = "rpc") -> None:
        """Probation with per-round backoff (``SUSPECT``) for
        ``probation_rounds`` consecutive failed rounds, then the permanent
        drop."""
        status = self.federation.mark_suspect(
            rec.client_id, addr, round_idx,
            probation_rounds=self.probation_rounds, reason=reason,
        )
        if status is None:  # stale: the client rejoined on a new address
            return
        reg = self.metrics.registry if self.metrics is not None else None
        if status == DROPPED:
            self.logger.warning(
                "dropping client %d after %d failed rounds (last %s: %s)",
                rec.client_id, rec.consecutive_failures, what, exc,
            )
            self._poll_warmed.discard(rec.client_id)
            self.straggler.forget(rec.client_id)
            if reg is not None:
                reg.counter("client_drops").inc()
        else:
            self.logger.warning(
                "client %d suspect (failure %d/%d, retry at round %d) "
                "after failed %s: %s",
                rec.client_id, rec.consecutive_failures,
                self.probation_rounds, rec.next_retry_round, what, exc,
            )
            if reg is not None:
                reg.counter("client_suspect_rounds").inc()
                self.metrics.log(
                    "client_suspect", client=rec.client_id,
                    failures=rec.consecutive_failures, status=status,
                    round=round_idx, reason=reason,
                )

    def _note_round_poll(self, round_sp, polled, replies, iteration) -> None:
        """Straggler/staleness telemetry for one round's poll results."""
        reg = self.metrics.registry
        slowest_id, slowest_s = None, -1.0
        round_lats: dict[int, float] = {}
        for rec, reply, lat in polled:
            if reply is None:
                continue
            if rec.client_id not in self._poll_warmed:
                # The first poll builds the kernels: keep it out of the
                # straggler statistics.
                self._poll_warmed.add(rec.client_id)
                continue
            reg.histogram("client_poll_s").observe(lat)
            reg.histogram(f"client_poll_s/client{rec.client_id}").observe(lat)
            round_lats[rec.client_id] = lat
            if lat > slowest_s:
                slowest_id, slowest_s = rec.client_id, lat
        if slowest_id is not None:
            reg.gauge("round_slowest_client_id").set(slowest_id)
            reg.gauge("round_slowest_client_s").set(slowest_s)
            round_sp.annotate(
                slowest_client=slowest_id, slowest_s=slowest_s
            )
        for flagged in self.straggler.observe_round(round_lats):
            reg.counter("stragglers_detected").inc()
            self.metrics.log(
                "straggler_detected", client=flagged["client"],
                round=iteration, z=flagged["z"], ewma_s=flagged["ewma_s"],
            )
        if replies:
            max_mb = max(reply.current_mb for _rec, reply in replies)
            for rec, reply in replies:
                reg.gauge(f"client_staleness_mb/client{rec.client_id}").set(
                    max_mb - reply.current_mb
                )
            round_sp.annotate(
                clients=len(replies),
                bytes_pulled=sum(
                    reply.shared.ByteSize() for _rec, reply in replies
                ),
            )

    def _next_step_seq(self) -> int:
        """Fresh TrainStep delivery sequence number, monotonic within the
        process and across restarts."""
        return self._seq_epoch + next(self._seq_counter)

    def _current_global(self) -> dict[str, np.ndarray]:
        """The parameters every client stepped from this round: the last
        broadcast average, or the template init before round 0."""
        return (
            self.last_average if self.last_average is not None
            else self._shared_template()
        )

    def _conformance(self, snap: dict[str, np.ndarray]) -> str | None:
        """Why ``snap`` does not match the shared template's key set,
        shapes and dtypes (the JAX gate's conformance stage), or None."""
        template = self._shared_template()
        if frozenset(snap) != frozenset(template):
            missing = sorted(set(template) - set(snap))[:3]
            unexpected = sorted(set(snap) - set(template))[:3]
            return f"key_skew: missing={missing}, unexpected={unexpected}"
        for key, arr in snap.items():
            want = template[key]
            if arr.shape != want.shape:
                return f"shape_skew: {key}: {arr.shape} != {want.shape}"
            if arr.dtype != want.dtype:
                return f"dtype_skew: {key}: {arr.dtype} != {want.dtype}"
        return None

    def _collect_snapshots(
        self, replies: list, iteration: int,
        was_suspect: frozenset = frozenset(),
    ) -> list[tuple[float, dict[str, np.ndarray]]]:
        """Decode a round's replies and check each against the shared
        template. A replayed reply (a seq already consumed) is dropped; a
        reply the codec cannot decode, or that does not conform, costs the
        round one contributor, and a client whose replies fail
        ``SUSPECT_AFTER`` rounds in a row enters probation. The FedAvg
        weight is the reply's ``nr_samples`` (every minibatch of its round),
        falling back to the client's join-time corpus size. A suspect
        client clears probation only when its update is accepted."""
        m = self.metrics
        if self.wire_codec.identity:
            def decode(bundle):
                return codec.bundle_to_flatdict(bundle, metrics=m)
        else:
            decode = self._uplink_dec.decode
        accepted: list[tuple[float, dict[str, np.ndarray]]] = []
        for rec, reply in replies:
            seq = int(reply.seq)
            if seq and self._reply_seen.get(rec.client_id, 0) >= seq:
                self.logger.warning(
                    "round %d: dropping replayed StepReply from client "
                    "%d (seq %d already seen)", iteration, rec.client_id, seq,
                )
                if m is not None:
                    m.registry.counter("rpcs_deduplicated").inc()
                    m.log(
                        "rpc_deduplicated", client=rec.client_id,
                        method="TrainStep", seq=seq, round=iteration,
                    )
                continue
            if seq:
                self._reply_seen[rec.client_id] = seq
            try:
                snap = decode(reply.shared)
            except CodecError as err:
                if m is not None:
                    m.registry.counter("codec_ref_miss").inc()
                    m.log(
                        "codec_ref_miss", client=rec.client_id,
                        ref_round=int(reply.shared.ref_round) - 1,
                        round=iteration,
                    )
                self.logger.warning(
                    "round %d: client %d reply not decodable (%s); "
                    "excluding it from the average",
                    iteration, rec.client_id, err,
                )
                continue
            reason = self._conformance(snap)
            if reason is not None:
                streak = self._reject_streak.get(rec.client_id, 0) + 1
                self._reject_streak[rec.client_id] = streak
                self.logger.warning(
                    "round %d: rejecting client %d update (%s); excluding "
                    "it from the average", iteration, rec.client_id, reason,
                )
                if m is not None:
                    m.registry.counter("updates_rejected").inc()
                    m.log("update_rejected", client=rec.client_id,
                          round=iteration, reason=reason.split(":")[0],
                          detail=reason)
                if streak >= SUSPECT_AFTER:
                    self._note_client_failure(
                        rec, rec.address, iteration, RuntimeError(reason),
                        "update admission", reason="poisoned",
                    )
                continue
            self._reject_streak.pop(rec.client_id, None)
            accepted.append((float(reply.nr_samples) or rec.nr_samples, snap))
            if rec.client_id in was_suspect and self.federation.mark_recovered(
                rec.client_id
            ):
                self.logger.info(
                    "client %d recovered (update admitted at round %d)",
                    rec.client_id, iteration,
                )
                if m is not None:
                    m.registry.counter("client_recoveries").inc()
                    m.log("client_recovered", client=rec.client_id,
                          round=iteration)
        return accepted

    def _encode_push(
        self, average: dict[str, np.ndarray], iteration: int, replies: list
    ) -> "dict[int, pb.Aggregate]":
        """Encode one round's push per recipient through the negotiated
        wire codec: the shared chain bundle for an up-to-date recipient,
        an exact catch-up bundle for one holding an older cached view, a
        self-contained bundle for one holding nothing usable."""
        recipients = [rec.client_id for rec, _reply in replies]
        if self.wire_codec.identity:
            return encode_push_for_recipients(
                None, None, average, iteration, recipients, {},
                False, metrics=self.metrics,
            )
        with self._push_lock:
            acked = dict(self._push_acked)
        with self._codec_lock:
            return encode_push_for_recipients(
                self._downlink_enc, self._uplink_dec, average, iteration,
                recipients, acked, False, metrics=self.metrics,
            )

    def _skip_below_quorum(self, iteration: int, got: int, membership: int,
                           quorum: int, what: str) -> None:
        """Log/count one skipped round, then wait out a backoff tick."""
        self.logger.warning(
            "round %d below quorum (%d/%d %s, need %d): skipping average",
            iteration, got, membership, what, quorum,
        )
        if self.metrics is not None:
            self.metrics.registry.counter("quorum_skipped_rounds").inc()
            self.metrics.log(
                "quorum_skip", round=iteration, got=got, needed=quorum,
            )
        self._stopping.wait(self.round_backoff_s)

    def _run_training(self) -> None:
        if self.metrics is not None:
            # One trace identity per training run: every round span
            # inherits it and every poll/push advertises it.
            self.trace_id = (
                getattr(self.metrics, "trace_id", None) or new_trace_id()
            )
            self.metrics.trace_id = self.trace_id
            self.metrics.log(
                "trace_started", trace_id=self.trace_id,
                round=self.global_iterations,
            )
        try:
            self._training_loop()
        except Exception:  # pragma: no cover - defensive
            self.logger.exception("federated training loop failed")
        finally:
            if self.metrics is not None:
                self.metrics.snapshot_registry(rounds=self.global_iterations)
            self._stopping.set()
            self.training_done.set()

    def _training_loop(self) -> None:
        stubs: dict[int, tuple[str, Any, rpc.ServiceStub]] = {}
        engine = pacing.make_engine(self, self.pacing)
        pool = ThreadPoolExecutor(max_workers=engine.pool_workers(self.poll_workers))
        self.logger.info(
            "starting federated training (%s pacing): total weight %.0f",
            self.pacing.spec_id, self.federation.total_weight(),
        )
        try:
            engine.run(stubs, pool)
        finally:
            self._stop_broadcast(stubs)
            self._finalize()
            pool.shutdown(wait=False)
            for _addr, channel, _stub in stubs.values():
                channel.close()

    def _stop_broadcast(self, stubs: dict) -> None:
        """Stop broadcast (``server.py:523-551``) to every ready client,
        each attempt retried with backoff. ``_stopping`` goes up first:
        any ReadyForTraining from here on is answered code=1."""
        self._stopping.set()
        stop = pb.Aggregate(stop=True)
        for rec in self.federation.get_clients():
            if not rec.ready_for_training:
                continue
            stub = self._stub_for(stubs, rec)
            if stub is None:
                continue
            try:
                stub.ApplyAggregate(stop)
            except Exception as exc:
                self.logger.warning(
                    "stop broadcast to client %d failed: %s",
                    rec.client_id, exc,
                )

    def _finalize(self) -> None:
        """Write the aggregated global model (betas only — the server has no
        corpus; ``get_topics_in_server``, ``federated_model.py:183-197``)."""
        if self.template is None or self.last_average is None:
            return
        stepper = FederatedStepper(self.template, self.grads_to_share)
        stepper.set_gradients(self.last_average)
        self.global_betas = stepper.get_topics_in_server(self.save_dir)
        self.logger.info(
            "federated training done after %d global iterations",
            self.global_iterations,
        )
