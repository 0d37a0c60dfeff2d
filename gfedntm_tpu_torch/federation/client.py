"""Federated client node for the cross-datacenter network path.

Counterpart of ``gfedntm_tpu/federation/client.py`` (itself the
reference's ``src/federation/client.py``): the consensus-phase
:class:`Client` (local vocabulary → the server's global vocabulary and
replicated initial state → re-vectorization) and the training-phase
:class:`FederatedClientServicer`, a gRPC servicer embedded in the client
that answers the server's per-minibatch polls. The local stepping is the
port's :class:`~gfedntm_tpu_torch.federated.stepper.FederatedStepper`, on
``device`` (``None`` is the GPU), so each local step runs the fused decode's
CUDA kernels; this module only adds the wire.

A port client joins a JAX server and a JAX client joins the port's server:
the server's initial variables and Adam state arrive in the JAX layout and
are set into the port model through :mod:`gfedntm_tpu_torch.interop`, and
the snapshots go out keyed by Flax '/'-paths with [in, out] kernels.

gRPC runs each ``TrainStep`` on a worker thread. The CUDA current device is
per thread, so every tensor the stepper makes names its device, and the
snapshot is read to the host (which synchronizes) before it is encoded.

Kept from the JAX client: the replay cache (a replayed ``TrainStep`` seq is
answered from the cache and advances nothing), the ``base_round``
accounting, ``nr_samples`` summed over every minibatch of an E-step round,
codec negotiation, the liveness watchdog with its reconnect loop, and
finalization on the stop broadcast. Unlike the JAX client, a reconnect
holds the servicer's lock from its ready to the codec reset a recovered
server orders, so the recovered server's first poll cannot be answered with
a delta against a broadcast it never held.

Under every pacing but ``push`` the client is polled. Under ``push:B``
(the ``GlobalSetup``'s ``pacing_id``) it clocks its own rounds
(:meth:`Client._run_push_loop`): each local round of the setup's
``local_steps`` goes up as a ``PushUpdate`` carrying the session token and
a client-minted seq, and the reply's aggregate (or reset order, or empty
marker) completes the round with exactly one schedule advance
(:meth:`FederatedClientServicer.finish_push_round`).

Client-side differential privacy (``dp="client"``): a
:class:`~gfedntm_tpu_torch.privacy.mechanisms.ClientSanitizer` clips each
outgoing snapshot's delta from the last applied aggregate (the replicated
init before the first) and adds seeded noise before it is encoded, so only
the sanitized update leaves the client. Incident dumps (``dump_dir``): a
flight recorder on the client's logger, a local incident trigger, and the
answer to a server's capture token (the client's ring, once per token, on
the poll's reply).

The failover ladder (``client.py:821-984``): the reconnect loop records why
it ended (``_last_reconnect_outcome``), and only a window exhausted against
a dead endpoint walks on to the next of ``failover_addrs`` (a sibling relay
or the root), re-homing the control channel there with both codec sessions
reset (``client_rehomes``); an endpoint that answers finished or refused
ends the ladder. A :class:`~gfedntm_tpu_torch.utils.observability.RoundProfiler`
(``profiler``) is observed at each ``StepRequest`` and closed when the
client finalizes.

``mesh_devices`` N > 1 steps the client's corpus data-parallel over N
ranks (:class:`~gfedntm_tpu_torch.federation.mesh_client.MeshStepper`: this
process is rank 0 and starts the N - 1 followers once the GlobalSetup has
arrived); the wire is unchanged. 0 and 1 are the one-device stepper, bit
for bit.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from typing import Any

import numpy as np

from gfedntm_tpu_torch import interop
from gfedntm_tpu_torch.data.datasets import BowDataset, CTMDataset
from gfedntm_tpu_torch.data.loaders import RawCorpus
from gfedntm_tpu_torch.data.vocab import Vocabulary, build_vocabulary, vectorize
from gfedntm_tpu_torch.device import resolve_device
from gfedntm_tpu_torch.federated.stepper import FederatedStepper
from gfedntm_tpu_torch.federation import codec, rpc
from gfedntm_tpu_torch.federation.mesh_client import MeshRanks, MeshStepper
from gfedntm_tpu_torch.federation.compression import (
    DownlinkDecoder,
    ReferenceMismatch,
    UplinkEncoder,
    WireCodec,
)
from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb
from gfedntm_tpu_torch.federation.resilience import RetryPolicy
from gfedntm_tpu_torch.federation.server import (
    build_template_model,
    model_opt_state,
    model_variables,
)
from gfedntm_tpu_torch.privacy.mechanisms import ClientSanitizer, parse_dp
from gfedntm_tpu_torch.utils import flightrec, observability
from gfedntm_tpu_torch.utils.observability import span

#: Adaptive liveness-window constants: once inter-poll gaps have been
#: observed, the watchdog window is margin + headroom x the gap EWMA; the
#: floor keeps a milliseconds-scale cadence from producing a window that
#: ordinary jitter could blow. The fixed ``liveness_timeout x (120+2E)/120``
#: formula remains the cold-start fallback.
WATCHDOG_GAP_HEADROOM = 10.0
WATCHDOG_GAP_MARGIN_S = 5.0
WATCHDOG_FLOOR_S = 10.0


def load_global_setup(model, setup: pb.GlobalSetup, metrics=None) -> None:
    """Set a server's initial variables and optimizer state
    (``setup.init_variables``, ``setup.init_opt_state``, in the JAX layout)
    into the port ``model``, as a joining client does. A name, count or
    shape mismatch raises."""
    variables = codec.bundle_to_tree(
        model_variables(model), setup.init_variables, metrics=metrics,
    )
    model.model.load_state_dict(interop.state_dict_from_flax(
        variables["params"], variables["batch_stats"]))
    opt_state = codec.bundle_to_tree(
        model_opt_state(model), setup.init_opt_state, metrics=metrics,
    )
    interop.load_optax_opt_state(model.model, model.optimizer, opt_state)


class FederatedClientServicer:
    """The in-client gRPC service the server polls during training
    (``FederatedClientServer``, ``client.py:43-185``). A lock serializes
    access to the stepper.

    ``metrics`` (optional MetricsLogger) feeds codec byte/latency telemetry
    and a per-poll counter, and ships a delta-encoded telemetry report on
    every reply; the wrapped stepper carries its own step-time histogram.
    ``sanitizer`` (a ``ClientSanitizer``) clips and noises each outgoing
    snapshot against the last applied aggregate; ``profiler`` (a
    ``RoundProfiler``) observes each request's round."""

    def __init__(self, client_id: int, stepper: FederatedStepper,
                 on_stop, logger: logging.Logger, metrics=None,
                 on_activity=None, on_done=None, on_local_steps=None,
                 uplink: UplinkEncoder | None = None,
                 downlink: DownlinkDecoder | None = None,
                 profiler=None, sanitizer: ClientSanitizer | None = None):
        self.client_id = client_id
        self.stepper = stepper
        # The round profiler learns the round from each StepRequest.
        self.profiler = profiler
        # Client-mode DP: the clip and noise reference is the replicated
        # init until the first aggregate, then the last one applied.
        self.sanitizer = sanitizer
        self._dp_reference: dict[str, np.ndarray] | None = None  # guarded-by: _lock
        self.on_stop = on_stop
        self.logger = logger
        self.metrics = metrics
        # Negotiated wire-compression sessions (None = identity codec):
        # `uplink` encodes StepReply snapshots, `downlink` decodes pushes.
        self.uplink = uplink
        self.downlink = downlink
        # Liveness signals for the owning Client's watchdog: ``on_activity``
        # fires at dispatch, ``on_done`` when the call returns, and
        # ``on_local_steps`` reports each StepRequest's E.
        self.on_activity = on_activity or (lambda: None)
        self.on_done = on_done or (lambda: None)
        self.on_local_steps = on_local_steps or (lambda n: None)
        # Reentrant: the stop broadcast's on_stop finalizes under this lock,
        # and the Client's watchdog path takes it too.
        self._lock = threading.RLock()
        # Round tag of the last aggregate applied (-1 = still on the
        # replicated init), reported as StepReply.base_round (1 + tag).
        self._applied_round = -1  # guarded-by: _lock
        # Idempotency replay cache: the last server-minted TrainStep seq
        # and the reply it produced. A replayed delivery is answered from
        # here; re-running the local steps would double-advance training
        # and double-count this client in the average.
        self._last_step_seq = 0  # guarded-by: _lock
        self._last_step_reply: pb.StepReply | None = None  # guarded-by: _lock
        self.shipper = (
            observability.TelemetryShipper(
                registry=metrics.registry,
                node=metrics.node or f"client{client_id}",
            )
            if metrics is not None else None
        )
        # The last capture token answered: one flight-record snapshot per
        # incident, however many polls the token rides.
        self._last_capture_token = ""  # guarded-by: _lock
        # Under push pacing the token arrives on a PushUpdate reply and is
        # answered on the next push's StepReply.
        self._pending_capture_token = ""  # guarded-by: _lock

    def TrainStep(self, request: pb.StepRequest, context) -> pb.StepReply:
        """The round's local step(s); reply with the post-step shared
        subset (``getGradient``, ``client.py:77-133``). ``local_steps``
        <= 1 is the reference's one-minibatch round; E > 1 runs E-1
        aggregate-free local steps first, and only the final step's
        snapshot is exchanged."""
        self.on_activity()
        try:
            return self._train_step(request)
        finally:
            self.on_done()

    def _train_step(self, request: pb.StepRequest) -> pb.StepReply:
        with self._lock:
            seq = int(request.seq)
            if (
                seq and self._last_step_reply is not None
                and seq <= self._last_step_seq
            ):
                self.logger.warning(
                    "client %d: replayed TrainStep seq %d (have %d); "
                    "answering from the replay cache",
                    self.client_id, seq, self._last_step_seq,
                )
                if self.metrics is not None:
                    self.metrics.registry.counter("rpcs_deduplicated").inc()
                    self.metrics.log(
                        "rpc_deduplicated", client=self.client_id,
                        method="TrainStep", seq=seq,
                    )
                return self._last_step_reply
            if self.profiler is not None:
                self.profiler.observe(int(request.global_iter))
            requested = max(1, int(request.local_steps or 1))
            self.on_local_steps(requested)
            if self.sanitizer is not None and self._dp_reference is None:
                # Before any broadcast the reference is the replicated init,
                # read before a local step changes it.
                self._dp_reference = {
                    k: np.array(v, copy=True)
                    for k, v in self.stepper.get_gradients().items()
                }
            # Truncate the round to the remaining epoch budget so the
            # exchanged step is always the final scheduled one; never
            # train past num_epochs.
            n_run = max(1, min(requested, self.stepper.steps_remaining))
            losses = []
            # nr_samples covers every minibatch of the round, so the
            # server's FedAvg weight is the samples actually consumed.
            nr_samples = 0.0
            for _ in range(n_run - 1):
                self.stepper.train_mb_delta(snapshot=False)
                losses.append(self.stepper.loss)
                nr_samples += self.stepper._last_batch_size
                self.stepper.advance_local()
            snapshot = self.stepper.train_mb_delta()
            losses.append(self.stepper.loss)
            nr_samples += self.stepper._last_batch_size
            if self.metrics is not None:
                self.metrics.registry.counter("client_polls").inc()
            flightrec.note(
                self.metrics, "train_step", client=self.client_id,
                round=int(request.global_iter), seq=seq, steps=n_run,
                loss=float(losses[-1]), samples=nr_samples,
            )
            if self.sanitizer is not None:
                # DP-SGD at the source: from here on only the sanitized
                # update exists (codec, wire, server).
                snapshot = self.sanitizer.apply(
                    snapshot, self._dp_reference, self._applied_round + 1,
                )
            if self.uplink is not None:
                shared = self.uplink.encode(snapshot)
            else:
                shared = codec.flatdict_to_bundle(
                    snapshot, metrics=self.metrics
                )
            reply = pb.StepReply(
                client_id=self.client_id,
                shared=shared,
                loss=float(sum(losses) / len(losses)),
                nr_samples=nr_samples,
                current_mb=self.stepper.current_mb,
                current_epoch=self.stepper.current_epoch,
                finished=self.stepper.finished,
                base_round=self._applied_round + 1,
                seq=seq,
            )
            if self.shipper is not None:
                reply.telemetry = self.shipper.build()
            tok = request.capture_token or self._pending_capture_token
            if tok and tok != self._last_capture_token:
                # A solicited flight-record snapshot, once per token
                # (best-effort: a lost reply drops it, and the token rides
                # the next exchange).
                blob = flightrec.build_remote_snapshot(self.metrics, tok)
                if blob is not None:
                    reply.flightrec = blob
                    self._last_capture_token = tok
            self._pending_capture_token = ""
            if seq:
                self._last_step_seq = seq
                self._last_step_reply = reply
            return reply

    def forget_replays(self) -> None:
        """Drop the TrainStep replay cache: after a re-homing the new tier
        mints its own seqs, which may sit below the dead tier's (each node's
        base is its own start time), and none of them is a redelivery."""
        with self._lock:
            self._last_step_seq = 0
            self._last_step_reply = None

    def ApplyAggregate(self, request: pb.Aggregate, context) -> pb.AggregateReply:
        """Overwrite shared params with the global average and advance
        (``sendAggregatedTensor``, ``client.py:135-185``); a stop broadcast
        triggers finalization instead."""
        self.on_activity()
        try:
            return self._apply_aggregate(request)
        finally:
            self.on_done()

    def _reply(self, finished: bool, current_epoch: int) -> pb.AggregateReply:
        return pb.AggregateReply(client_id=self.client_id, finished=finished,
                                 current_epoch=current_epoch)

    def _apply_aggregate(self, request: pb.Aggregate) -> pb.AggregateReply:
        with self._lock:
            if request.stop:
                self.on_stop()
                return self._reply(True, self.stepper.current_epoch)
            if (
                not request.reset_session
                and int(request.round) <= self._applied_round
            ):
                # Replayed push for a round already applied: applying it
                # again would rewind the model and corrupt the
                # delta-reference chain.
                self.logger.warning(
                    "client %d: ignoring replayed push for round %d "
                    "(already applied)", self.client_id, int(request.round),
                )
                if self.metrics is not None:
                    self.metrics.registry.counter("rpcs_deduplicated").inc()
                    self.metrics.log(
                        "rpc_deduplicated", client=self.client_id,
                        method="ApplyAggregate", round=int(request.round),
                    )
                return self._reply(self.stepper.finished, self.stepper.current_epoch)
            flightrec.note(
                self.metrics, "aggregate_applied", client=self.client_id,
                round=int(request.round),
                reset_session=bool(request.reset_session),
            )
            if request.reset_session:
                # The server discarded the trajectory our codec session
                # state describes: drop delta references and the
                # error-feedback residual before decoding.
                self.logger.warning(
                    "client %d: server ordered a codec session reset "
                    "(round %d)", self.client_id, int(request.round),
                )
                if self.downlink is not None:
                    self.downlink.reset()
                if self.uplink is not None:
                    self.uplink.reset()
                if not len(request.shared.tensors):
                    # A bare reset order: nothing to apply, no round
                    # delivered.
                    return self._reply(self.stepper.finished,
                                       self.stepper.current_epoch)
            if self.downlink is not None:
                try:
                    average = self.downlink.decode(
                        request.shared, round_idx=int(request.round)
                    )
                except ReferenceMismatch:
                    self.logger.exception(
                        "client %d cannot decode the round %d push",
                        self.client_id, int(request.round),
                    )
                    raise
                if self.uplink is not None:
                    # The applied aggregate is the next snapshot's delta
                    # reference — the view the server cached for this push.
                    self.uplink.note_aggregate(average, int(request.round))
            else:
                average = codec.bundle_to_flatdict(
                    request.shared, metrics=self.metrics
                )
            self._applied_round = int(request.round)
            if self.sanitizer is not None:
                # The applied aggregate is the next round's reference (merged:
                # a partial push must not orphan keys the previous one had).
                ref = dict(self._dp_reference or {})
                ref.update(
                    (k, np.array(v, copy=True)) for k, v in average.items()
                )
                self._dp_reference = ref
            status = self.stepper.delta_update_fit(average)
            if status.epoch_ended:
                self.logger.info(
                    "client %d epoch %d done, loss %.4f",
                    self.client_id, status.current_epoch, status.epoch_loss,
                )
            return self._reply(status.finished, status.current_epoch)

    # ---- push pacing -------------------------------------------------------
    def local_round(self, local_steps: int) -> pb.StepReply:
        """One client-clocked local round under push pacing
        (``client.py:378-400``): the round's local steps and the StepReply to
        stream upstream, through the same snapshot and encode path as a
        poll, without the seq replay cache (a push carries no server-minted
        seq)."""
        self.on_activity()
        try:
            reply = self._train_step(pb.StepRequest(
                global_iter=self._applied_round + 1,
                local_steps=local_steps, seq=0,
            ))
            # The schedule advances only after the round completes
            # (finish_push_round), so `stepper.finished` is one step stale
            # here: on the final scheduled step it still reads False.
            # steps_remaining counts the pending step, so <= 1 means this
            # exchanged step is the last one.
            if self.stepper.steps_remaining <= 1:
                reply.finished = True
            return reply
        finally:
            self.on_done()

    def finish_push_round(self, agg: "pb.Aggregate | None") -> None:
        """Complete one push round with its PushUpdate reply
        (``client.py:402-423``): apply the reply's aggregate when it carries
        a new broadcast or a session-reset order, else advance past the
        exchanged step locally. Exactly one schedule advance happens either
        way (one aggregate per exchanged step)."""
        with self._lock:
            if agg is not None and agg.capture_token:
                # A solicited capture: answered on the next push.
                self._pending_capture_token = agg.capture_token
            if agg is not None and not agg.stop and (
                agg.reset_session or len(agg.shared.tensors)
            ):
                self._apply_aggregate(agg)
            if self.stepper._pending_step:
                # An empty marker, a bare reset order or a replayed round:
                # no aggregate consumed the pending step.
                self.stepper.advance_local()


class Client:
    """A federation participant (``Client``, ``client.py:190-532``).

    Drives the client lifecycle: local vocabulary → consensus →
    re-vectorization → replicated init → serving per-minibatch polls →
    finalization artifacts on stop. The stepper runs on ``device``
    (``None`` is the GPU; the tests pass ``"cpu"``).
    """

    def __init__(
        self,
        client_id: int,
        corpus: RawCorpus,
        server_address: str,
        listen_address: str = "[::]:0",
        advertise_host: str = "localhost",
        max_features: int | None = 2000,
        stop_words: str | None = None,
        save_dir: str | None = None,
        setup_timeout: float = 3600.0,
        logger: logging.Logger | None = None,
        metrics=None,
        liveness_timeout: float = 300.0,
        watchdog_poll_s: float = 2.0,
        retry_policy=None,
        wire_codec: str | None = "auto",
        profiler=None,
        reconnect_window: float = 180.0,
        mesh_devices: int = 0,
        failover_addrs: "tuple[str, ...] | list[str]" = (),
        dp: str = "off",
        dp_clip: float = 1.0,
        dp_sigma: float = 0.0,
        dp_delta: float = 1e-5,
        dp_budget: float = 0.0,
        dp_seed: int = 0,
        dump_dir: str | None = None,
        flightrec_entries: int = 2048,
        flightrec_seconds: float = 300.0,
        device=None,
    ):
        if client_id <= 0:
            raise ValueError("client ids start at 1 (0 is the server)")
        # Local DP: dp="client" sanitizes every outgoing snapshot; "server"
        # is the server's mechanism (parsed here only to validate it);
        # "off" constructs nothing.
        self.dp = parse_dp(
            dp, clip=dp_clip, sigma=dp_sigma, delta=dp_delta,
            budget=dp_budget, seed=dp_seed,
        )
        self._dp_sanitizer = (
            ClientSanitizer(self.dp, client_id=client_id, metrics=metrics)
            if self.dp.mode == "client" else None
        )
        # Incident dumps: a flight recorder on the logger and a local
        # trigger, which also lets the client answer a server's capture
        # token. No dump_dir constructs nothing.
        self.dump_dir = dump_dir
        self._incident_trigger = None
        if dump_dir is not None and metrics is not None:
            recorder = flightrec.FlightRecorder(
                max_entries=flightrec_entries,
                max_seconds=flightrec_seconds,
                registry=metrics.registry,
            )
            metrics.recorder = recorder
            self._incident_trigger = flightrec.IncidentTrigger(
                recorder, dump_dir, metrics=metrics,
                node=metrics.node or f"client{client_id}",
            )
        self.device = resolve_device(device)
        # The round profiler (observed by the servicer at each StepRequest)
        # records this client's device unless it names one.
        self.profiler = profiler
        if profiler is not None and profiler.device is None:
            profiler.device = self.device
        self.client_id = client_id
        # Multi-device local training (--mesh_devices): 0/1 = the one-device
        # stepper, bit for bit; N > 1 = a MeshStepper over N ranks, whose
        # followers start with the join and get the model once the
        # GlobalSetup fixes it.
        self.mesh_devices = int(mesh_devices)
        self._mesh_ranks: MeshRanks | None = None
        self.corpus = corpus
        self.server_address = server_address
        self.listen_address = listen_address
        self.advertise_host = advertise_host
        self.max_features = max_features
        self.stop_words = stop_words
        self.save_dir = save_dir
        self.setup_timeout = setup_timeout
        self.logger = logger or logging.getLogger(f"Client{client_id}")
        self.metrics = metrics
        # Liveness watchdog: with no poll/aggregate/stop within this window
        # after training starts, the client reconnects (or self-finalizes)
        # instead of blocking forever against a dead server. 0 disables.
        self.liveness_timeout = float(liveness_timeout)
        self.watchdog_poll_s = float(watchdog_poll_s)
        self._deadline_scale = 1.0
        self._gap_ewma: float | None = None
        # Durable session: with a server-minted token and
        # reconnect_window > 0, a client whose server contact dies
        # re-presents the token for up to reconnect_window seconds.
        self.reconnect_window = float(reconnect_window)
        # Re-homing: fallback endpoints tried in order once the reconnect
        # window against the current one is exhausted (consumed left to
        # right; empty keeps the single endpoint).
        self.failover_addrs: list[str] = list(failover_addrs or ())
        # Why the last _reconnect_loop ended ("exhausted", "finished",
        # "refused", "stopped" or "ok"): only an exhausted window against a
        # dead endpoint justifies re-homing.
        self._last_reconnect_outcome = "ok"
        self.session_token = ""
        self._advertised_address = ""
        self.retry_policy = retry_policy or RetryPolicy(metrics=metrics)
        # Wire codec: "auto" adopts the server's GlobalSetup id; an
        # explicit spec must match it or the join fails loudly.
        self.wire_codec = wire_codec
        self._codec: WireCodec | None = None
        self._uplink: UplinkEncoder | None = None
        self._downlink: DownlinkDecoder | None = None

        self.stepper: FederatedStepper | None = None
        self.global_vocab: Vocabulary | None = None
        self.dataset: BowDataset | None = None
        self.results: dict[str, Any] | None = None
        self.stopped = threading.Event()
        self._grpc_server = None
        self._servicer: FederatedClientServicer | None = None
        self._last_activity = time.monotonic()
        # In-flight server-call count: a TrainStep that runs for minutes
        # reads as activity, not as a dead server.
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._finalize_lock = threading.Lock()
        self._finalized = False
        # Pacing from the GlobalSetup: under push pacing the client streams
        # PushUpdate rounds of `_push_local_steps` with client-minted seqs.
        self._pacing_id = "sync"
        self._push_local_steps = 1
        self._push_seq = itertools.count(1)

    # ---- lifecycle ---------------------------------------------------------
    def _touch(self) -> None:
        self._last_activity = time.monotonic()

    def _rpc_begin(self) -> None:
        now = time.monotonic()
        with self._inflight_lock:
            self._inflight += 1
            gap = now - self._last_activity
            if gap >= 0.0:
                self._gap_ewma = (
                    gap if self._gap_ewma is None
                    else 0.7 * self._gap_ewma + 0.3 * gap
                )
        self._touch()

    def _rpc_end(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1
        self._touch()

    def _note_local_steps(self, local_steps: int) -> None:
        """Scale the liveness window by the server's per-round poll
        deadline (120 + 2E vs the base 120) once a StepRequest reveals E."""
        self._deadline_scale = max(
            1.0, (120.0 + 2.0 * local_steps) / 120.0
        )

    def _reconnect_available(self) -> bool:
        """Reconnecting makes sense only while this client still has
        training to resume: finished clients are not polled, so a quiet
        server is no sign of its death for them."""
        return (
            self.reconnect_window > 0
            and bool(self.session_token)
            and not (self.stepper is not None and self.stepper.finished)
        )

    def _watchdog_window(self) -> float:
        """The liveness window: the fixed formula before any inter-poll
        gap is observed, then derived from the observed cadence — it may
        shrink only when detection triggers a cheap reconnect probe, and
        only widen when it triggers the destructive self-finalize."""
        fixed = self.liveness_timeout * self._deadline_scale
        with self._inflight_lock:
            ewma = self._gap_ewma
        if ewma is None:
            return fixed
        adaptive = WATCHDOG_GAP_MARGIN_S + WATCHDOG_GAP_HEADROOM * ewma
        if self._reconnect_available():
            return min(fixed, max(adaptive, min(WATCHDOG_FLOOR_S, fixed)))
        return max(fixed, adaptive)

    def _idle_expired(self) -> float | None:
        """Seconds of idle time iff past the liveness window."""
        idle = time.monotonic() - self._last_activity
        return idle if idle > self._watchdog_window() else None

    def run(self) -> None:
        """Blocking end-to-end client lifecycle; returns once the server's
        stop broadcast has been processed and artifacts are written. When
        the liveness watchdog concludes the server is gone, the client
        first reconnects (re-presenting its session token for up to
        ``reconnect_window`` seconds) and self-finalizes only once that is
        exhausted or the federation is reported finished."""
        self.join_federation()
        self.serve_training()
        if self._pacing_id.startswith("push") and not self.stopped.is_set():
            # Push pacing: this client clocks its own rounds until finished
            # (or told to stop), then waits for the stop broadcast below.
            self._run_push_loop()
            if self.stopped.is_set():
                return
        if self.liveness_timeout <= 0:
            self.stopped.wait()
            return
        self._touch()
        while not self.stopped.wait(self.watchdog_poll_s):
            with self._inflight_lock:
                busy = self._inflight > 0
            if busy:
                continue
            idle = self._idle_expired()
            if idle is None:
                continue
            if self._reconnect_available():
                if self._reconnect_or_rehome(idle):
                    continue
            if self._watchdog_finalize():
                break

    def _run_push_loop(self) -> None:
        """Push pacing (``client.py:727-819``): run local rounds on this
        client's clock and stream each upstream as a ``PushUpdate``, applying
        whatever fresher broadcast the reply carries. Ends when local
        training finishes (the final push carries ``finished=True``), a
        ``stop`` reply arrives, or the server stays unreachable past the
        reconnect window."""
        reply: pb.StepReply | None = None
        retries = 0
        while not self.stopped.is_set():
            if reply is None:
                if self.stepper.finished:
                    return
                reply = self._servicer.local_round(self._push_local_steps)
                reply.session_token = self.session_token
                reply.seq = next(self._push_seq)
                retries = 0
            agg = None
            try:
                agg = self._federation_stub.PushUpdate(reply)
            except Exception as exc:
                self.logger.warning(
                    "client %d: PushUpdate failed (%s)", self.client_id, exc,
                )
                # The stub already retried transient failures: the server is
                # gone. Reconnect by session token (a recovered server's
                # Ack 3 resets the codec sessions), or self-finalize.
                if not (self._reconnect_available()
                        and self._reconnect_or_rehome(0.0)):
                    self._on_stop()
                    return
                if retries < 3:
                    # Re-present the held update: its seq makes the re-send
                    # idempotent, and the final round has no successor to
                    # supersede it.
                    retries += 1
                    continue
                # Retries exhausted: advance; the next round supersedes it.
            if (
                agg is not None and not agg.stop and agg.round < 0
                and not len(agg.shared.tensors)
            ):
                # Hold: the federation has not started aggregating; present
                # this round again rather than spend the epoch budget.
                self._touch()
                self.stopped.wait(0.5)
                continue
            # Exactly one schedule advance per pushed round, fresh state or
            # not (a failed push advances too).
            self._servicer.finish_push_round(agg)
            was_final = bool(reply.finished)
            reply = None
            self._touch()
            if self.metrics is not None:
                self.metrics.registry.counter(
                    "client_pushes" if agg is not None
                    else "client_pushes_abandoned"
                ).inc()
            if agg is not None and agg.stop:
                self.logger.info(
                    "client %d: server answered a push with stop; "
                    "finalizing", self.client_id,
                )
                self._on_stop()
                return
            if was_final:
                # The final local round went up; wait for the stop
                # broadcast like any early finisher.
                return

    def _reconnect_loop(self, idle: float) -> bool:
        """RECONNECTING: keep re-presenting the session token under capped
        backoff until the server answers, the window is exhausted, or a
        stop arrives. True resumes the watchdog wait, False lets it
        self-finalize."""
        start = time.monotonic()
        self.logger.warning(
            "client %d: no server activity for %.0f s — RECONNECTING "
            "(session %s…, up to %.0f s)",
            self.client_id, idle, self.session_token[:8],
            self.reconnect_window,
        )
        if self.metrics is not None:
            self.metrics.registry.counter("reconnects_entered").inc()
        attempts = 0
        delays = self.retry_policy.delays()
        while not self.stopped.is_set():
            if time.monotonic() - start > self.reconnect_window:
                self.logger.error(
                    "client %d: reconnect window (%.0f s) exhausted after "
                    "%d attempts; self-finalizing",
                    self.client_id, self.reconnect_window, attempts,
                )
                self._last_reconnect_outcome = "exhausted"
                return False
            attempts += 1
            # The servicer's lock is held from the ready to the reset it may
            # order: a recovered server can start training on this ready
            # and poll at once, and a poll answered before the reset would
            # send a delta against a broadcast that server never held.
            try:
                with self._session_lock():
                    ack = self._federation_stub.ReadyForTraining(
                        self._join_request(full_telemetry=True), timeout=10.0,
                    )
                    if ack.code == 3:
                        # A recovered server holds none of our codec session
                        # state: drop both directions.
                        self.logger.warning(
                            "client %d: recovered server ordered a wire-codec "
                            "session reset", self.client_id,
                        )
                        self._reset_codec_sessions()
            except Exception as exc:
                self.logger.info(
                    "client %d: reconnect attempt %d failed (%s)",
                    self.client_id, attempts, exc,
                )
                self.stopped.wait(min(next(delays), 5.0))
                continue
            if ack.code == 1:
                self.logger.warning(
                    "client %d: federation finished while disconnected; "
                    "finalizing", self.client_id,
                )
                self._last_reconnect_outcome = "finished"
                return False
            if ack.code == 2:
                self.logger.error(
                    "client %d: reconnect rejected (%s); finalizing",
                    self.client_id, ack.detail,
                )
                self._last_reconnect_outcome = "refused"
                return False
            self._touch()
            downtime = time.monotonic() - start
            self.logger.warning(
                "client %d: reconnected after %d attempt(s) (%.1f s "
                "offline)", self.client_id, attempts, downtime,
            )
            if self.metrics is not None:
                self.metrics.registry.counter("client_reconnections").inc()
                self.metrics.log(
                    "client_reconnected", client=self.client_id,
                    attempts=attempts, downtime_s=downtime,
                )
            self._last_reconnect_outcome = "ok"
            return True
        self._last_reconnect_outcome = "stopped"
        return True  # stop arrived mid-reconnect: nothing left to do

    def _rehome(self, address: str) -> None:
        """Point the control stub at a new upstream endpoint and drop this
        client's wire-codec sessions: no broadcast reference or uplink view
        survives a tier change, so the next bundles are self-contained on
        this end (the adoptive tier's fresh-join handling covers its end).
        Unlike the JAX client, the TrainStep replay cache goes too: the new
        tier's seqs are not ordered after the dead tier's."""
        old = self._fed_channel
        self._fed_channel = rpc.make_channel(address)
        self._federation_stub = rpc.ServiceStub(
            self._fed_channel, "gfedntm.Federation",
            metrics=self.metrics, peer="server",
            retry_policy=self.retry_policy,
        )
        self.server_address = address
        try:
            old.close()
        except Exception as exc:  # noqa: BLE001 — the old channel is dead
            self.logger.info(
                "client %d: closing the dead channel failed (%s)",
                self.client_id, exc,
            )
        with self._session_lock():
            self._reset_codec_sessions()
            if self._servicer is not None:
                self._servicer.forget_replays()

    def _reconnect_or_rehome(self, idle: float) -> bool:
        """The survivability ladder: reconnect to the current endpoint, and
        when that window is exhausted against a dead endpoint (not a
        finished or refusing one), fail over to the next of
        ``failover_addrs``, presenting the same session token there; the
        adoptive tier admits it as a fresh join and logs
        ``member_rehomed``."""
        if self._reconnect_loop(idle):
            return True
        while (
            self.failover_addrs
            and self._last_reconnect_outcome == "exhausted"
            and not self.stopped.is_set()
        ):
            target = self.failover_addrs.pop(0)
            self.logger.warning(
                "client %d: re-homing to %s (session %s…, %d fallback "
                "endpoint(s) left)", self.client_id, target,
                self.session_token[:8], len(self.failover_addrs),
            )
            if self.metrics is not None:
                self.metrics.registry.counter("client_rehomes").inc()
            self._rehome(target)
            if self._reconnect_loop(0.0):
                return True
        return False

    def _session_lock(self):
        """The servicer's (reentrant) lock, which every TrainStep and
        ApplyAggregate holds; a fresh one before training starts."""
        return (
            self._servicer._lock if self._servicer is not None
            else threading.RLock()
        )

    def _reset_codec_sessions(self) -> None:
        with self._session_lock():
            if self._uplink is not None:
                self._uplink.reset()
            if self._downlink is not None:
                self._downlink.reset()

    def _watchdog_finalize(self) -> bool:
        """Self-finalize under the servicer's lock, re-checking liveness
        once the lock is held. Returns False when the fire was spurious."""
        with self._session_lock():
            idle = self._idle_expired()
            if self.stopped.is_set() or idle is None:
                return False
            self.logger.warning(
                "client %d: no server activity for %.0f s (> %.0f s "
                "liveness window); self-finalizing", self.client_id, idle,
                self._watchdog_window(),
            )
            if self.metrics is not None:
                self.metrics.registry.counter("watchdog_self_finalized").inc()
                self.metrics.log(
                    "watchdog_fired", client=self.client_id, idle_s=idle
                )
            self._on_stop()
        return True

    def join_federation(self) -> None:
        """Phases 1-2 of the client lifecycle (``client.py:378-507``)."""
        if self.mesh_devices > 1 and self._mesh_ranks is None:
            # The followers import and reach their device while the
            # consensus runs.
            self._mesh_ranks = MeshRanks(self.device, self.mesh_devices, self.logger)
        self._fed_channel = rpc.make_channel(self.server_address)
        self._federation_stub = rpc.ServiceStub(
            self._fed_channel, "gfedntm.Federation",
            metrics=self.metrics, peer="server",
            retry_policy=self.retry_policy,
        )

        # 1. local vocabulary -> server (client.py:358-406)
        with span(self.metrics, "offer_vocab", client=self.client_id):
            local_vocab = build_vocabulary(
                self.corpus.documents, max_features=self.max_features,
                stop_words=self.stop_words,
            )
            self._federation_stub.OfferVocab(
                pb.VocabOffer(
                    client_id=self.client_id,
                    tokens=list(local_vocab.tokens),
                    nr_samples=float(len(self.corpus)),
                )
            )

        # 2. blocking wait for consensus + replicated init. GetGlobalSetup
        # blocks server-side until the vocabulary quorum, so it gets the
        # long phase timeout.
        with span(self.metrics, "get_setup", client=self.client_id):
            setup = self._federation_stub.GetGlobalSetup(
                pb.JoinRequest(client_id=self.client_id),
                timeout=self.setup_timeout,
            )
            self.session_token = setup.session_token or ""
            self._pacing_id = setup.pacing_id or "sync"
            self._push_local_steps = max(1, int(setup.local_steps or 1))
            self.global_vocab = Vocabulary(tuple(setup.vocab))
            self._negotiate_codec(setup.codec_id or "none")
            hyper = json.loads(setup.hyperparams_json)
            model = build_template_model(
                hyper["family"], len(self.global_vocab), hyper["kwargs"],
                device=self.device,
            )
            # Overwrite the locally initialized state with the server's
            # replicated init (NNUpdate/AdamUpdate, client.py:498-503).
            load_global_setup(model, setup, metrics=self.metrics)

        # 3. re-vectorize the local corpus against the GLOBAL vocabulary
        with span(self.metrics, "revectorize", client=self.client_id):
            X = vectorize(self.corpus.documents, self.global_vocab)
        if hyper["family"] == "ctm":
            if self.corpus.embeddings is None:
                raise ValueError("CTM federation requires embeddings")
            labels = None
            label_size = hyper["kwargs"].get("label_size", 0)
            if label_size and self.corpus.labels is not None:
                lab = np.asarray(self.corpus.labels)
                labels = (
                    lab if lab.ndim == 2
                    else np.eye(label_size, dtype=np.float32)[lab]
                )
            self.dataset = CTMDataset(
                X=X, idx2token=self.global_vocab.id2token,
                X_ctx=self.corpus.embeddings, labels=labels,
            )
        else:
            self.dataset = BowDataset(
                X=X, idx2token=self.global_vocab.id2token
            )

        # CTM federations snapshot the model at every epoch end, as the
        # reference does (``federated_ctm.py:150-159``); AVITM does not.
        snapshot_dir = (
            os.path.join(self.save_dir, "epoch_snapshots")
            if hyper["family"] == "ctm" and self.save_dir is not None
            else None
        )
        if self.mesh_devices > 1:
            self.logger.info("client %d data-sharding its local corpus over %d ranks",
                             self.client_id, self.mesh_devices)
            self.stepper = MeshStepper(
                model, self._mesh_ranks, hyper["family"], len(self.global_vocab),
                hyper["kwargs"], grads_to_share=tuple(hyper["grads_to_share"]),
                epoch_snapshot_dir=snapshot_dir, metrics=self.metrics, logger=self.logger,
            )
        else:
            self.stepper = FederatedStepper(
                model, grads_to_share=tuple(hyper["grads_to_share"]),
                epoch_snapshot_dir=snapshot_dir, metrics=self.metrics,
            )
        with span(self.metrics, "pre_fit", client=self.client_id):
            self.stepper.pre_fit(self.dataset)

    def _negotiate_codec(self, server_codec_id: str) -> None:
        """Adopt ("auto") or verify (explicit spec) the federation's wire
        codec, then build the per-direction sessions."""
        if self.wire_codec in (None, "auto"):
            self._codec = WireCodec(server_codec_id)
        else:
            self._codec = WireCodec(self.wire_codec)
            if self._codec.codec_id != server_codec_id:
                raise ValueError(
                    f"client {self.client_id} configured wire codec "
                    f"{self._codec.codec_id!r} but the federation runs "
                    f"{server_codec_id!r}; refusing to join with a "
                    "mismatched codec"
                )
        if not self._codec.identity:
            self._uplink = UplinkEncoder(self._codec, metrics=self.metrics)
            self._downlink = DownlinkDecoder(self._codec, metrics=self.metrics)
        self.logger.info(
            "client %d negotiated wire codec %r",
            self.client_id, self._codec.codec_id,
        )
        if self.metrics is not None:
            self.metrics.log(
                "codec_negotiated", client=self.client_id,
                codec=self._codec.codec_id,
            )

    def _join_request(self, full_telemetry: bool) -> pb.JoinRequest:
        """The ReadyForTraining request: this client's serving address,
        codec and session token, with a full telemetry report (the rejoin
        resynchronizes the server's view in one RPC)."""
        telemetry = b""
        if full_telemetry and self.metrics is not None:
            node = self.metrics.node or f"client{self.client_id}"
            telemetry = observability.encode_telemetry_report(
                {node: self.metrics.registry.snapshot()}, full=True,
            )
        return pb.JoinRequest(
            client_id=self.client_id,
            address=self._advertised_address,
            codec_id=(
                self._codec.codec_id if self._codec is not None else "none"
            ),
            session_token=self.session_token,
            telemetry=telemetry,
        )

    def serve_training(self) -> None:
        """Start the in-client servicer and signal readiness
        (``client.py:282-319,509-532``)."""
        servicer = FederatedClientServicer(
            self.client_id, self.stepper, self._on_stop, self.logger,
            metrics=self.metrics, on_activity=self._rpc_begin,
            on_done=self._rpc_end, on_local_steps=self._note_local_steps,
            uplink=self._uplink, downlink=self._downlink,
            profiler=self.profiler, sanitizer=self._dp_sanitizer,
        )
        self._servicer = servicer
        self._grpc_server = rpc.make_server(max_workers=4)
        rpc.add_service(
            self._grpc_server, "gfedntm.FederationClient", servicer,
            metrics=self.metrics,
        )
        port = self._grpc_server.add_insecure_port(self.listen_address)
        self._grpc_server.start()
        self.logger.info("client %d serving on port %d", self.client_id, port)
        self._advertised_address = f"{self.advertise_host}:{port}"
        ack = self._federation_stub.ReadyForTraining(
            self._join_request(full_telemetry=True)
        )
        if ack.code == 2:
            raise RuntimeError(
                f"client {self.client_id} join rejected: {ack.detail}"
            )
        if ack.code == 1:
            self.logger.warning(
                "client %d: federation already finished; finalizing",
                self.client_id,
            )
            self._on_stop()

    def _on_stop(self) -> None:
        """Finalize on the server's stop broadcast (or the liveness
        watchdog): thresholded thetas + betas + topics
        (``get_results_model``). Idempotent."""
        with self._finalize_lock:
            if self._finalized:
                return
            self._finalized = True
        try:
            if isinstance(self.stepper, MeshStepper):
                self._check_mesh_ranks()
            with span(self.metrics, "finalize", client=self.client_id):
                self.results = self.stepper.get_results_model(self.save_dir)
        except Exception:
            self.logger.exception(
                "client %d finalization failed", self.client_id
            )
            raise
        finally:
            if self._mesh_ranks is not None:
                self._mesh_ranks.close()
            if self.profiler is not None:
                self.profiler.close()
            if self.metrics is not None:
                self.metrics.snapshot_registry(client=self.client_id)
            self.stopped.set()

    def _check_mesh_ranks(self) -> None:
        """Read every rank's state digest and log it as the ``phase``
        ``mesh_ranks`` (``equal``: every rank holds rank 0's state bit for
        bit); unequal ranks raise."""
        t0 = time.perf_counter()
        digests = self.stepper.rank_digests()
        equal = all(d == digests[0] for d in digests[1:])
        if self.metrics is not None:
            self.metrics.log("phase", phase="mesh_ranks", seconds=time.perf_counter() - t0,
                             client=self.client_id, ranks=len(digests), equal=equal)
        if not equal:
            raise RuntimeError(f"client {self.client_id}: the mesh ranks' states differ")

    def shutdown(self, grace: float = 0.5) -> None:
        if self._mesh_ranks is not None:
            self._mesh_ranks.close()
        if self._grpc_server is not None:
            self._grpc_server.stop(grace)
        channel = getattr(self, "_fed_channel", None)
        if channel is not None:
            channel.close()
