"""Federated server for the cross-datacenter network path.

Counterpart of ``gfedntm_tpu/federation/server.py`` (itself the reference's
``src/federation/server.py:37-553``): phase-1 vocabulary consensus as a gRPC
servicer (``OfferVocab``, ``GetGlobalSetup``, ``ReadyForTraining`` with
durable-session tokens), then phase-2 orchestration by a pacing engine
(:mod:`~gfedntm_tpu_torch.federation.pacing`). Under ``sync`` pacing every
client is polled concurrently for its post-step shared state, FedAvg
weights the replies by their ``nr_samples``, and the average is pushed back
(``ApplyAggregate``); ``cohort:K`` polls a seeded K-of-N sample per round,
``async:B`` aggregates every B buffered updates with staleness discounts,
and ``push:B`` is never polled: clients stream ``PushUpdate`` and the reply
carries the freshest round, delta-encoded against what each client holds.
Clients that finish drop out, and the run ends with a stop broadcast and
``server_model.npz``.

It speaks the JAX package's protocol byte for byte, so JAX clients join it
and port clients join a JAX server: the ``GlobalSetup`` carries the
template's variables and Adam state in the JAX layout (Flax '/'-paths,
[in, out] kernels, int32 counters, optax's ``[0].count``/``mu``/``nu``;
:mod:`gfedntm_tpu_torch.interop`, :mod:`gfedntm_tpu_torch.federation.codec`).
The template model lives on ``device`` (``None`` is the GPU).

Its defaults are the JAX server's (``server.py:135-197``), and so are the
planes behind them:

- the update admission gate (:class:`~gfedntm_tpu_torch.federation.sanitize.UpdateGate`:
  conformance, finiteness, the cohort's median + MAD norm screen, the
  optional hard clip), whose repeat offenders enter probation;
- the robust mean stages and server optimizers
  (:func:`~gfedntm_tpu_torch.federated.aggregation.make_aggregator`);
- the aggregation plane on the server's device
  (:class:`~gfedntm_tpu_torch.federation.device_agg.DeviceAggEngine`):
  ``aggregation_backend="auto"`` is ``"device"`` on a CUDA server and
  ``"numpy"`` on a CPU one, and ``"device"`` on a CPU server runs the
  engine on the CPU. Unlike the JAX server, an engine failure is not
  degraded to numpy: it raises;
- the divergence guardian, which rolls the federation back to its last
  healthy round checkpoint;
- the round journal (every pushed round) and the round checkpoints, with
  crash autorecovery (:meth:`FederatedServer.maybe_autorecover`): the
  journal is the JAX package's format, so either package's server recovers
  from the other's journal;
- differential privacy (``dp="server"``: FedLD noise on the aggregate,
  drawn on the engine's device under the device backend, and the gate's
  clip tightened to ``dp_clip``; ``dp="client"``: the ledger of the
  clients' own mechanism) with its (ε, δ) ledger, which rides the journal
  and the checkpoints so a recovered run resumes it
  (:mod:`gfedntm_tpu_torch.privacy`);
- the model-quality plane: the topic-quality monitor with its coherence
  guard routed through the rollback, and the per-client contribution
  tracker (:mod:`gfedntm_tpu_torch.eval.monitor`);
- the ops endpoint (``/healthz``, ``/ready``, ``/metrics``, ``/status``,
  ``/status.fleet``, ``/alerts``), the fleet telemetry the clients
  piggyback on their replies and readies, and the SLO engine, ticked once
  per aggregated round (:mod:`gfedntm_tpu_torch.utils.slo`);
- incident dumps (``dump_dir``): a flight recorder on the logger and an
  incident trigger whose captures solicit the clients' rings through the
  next poll's capture token;
- shard supervision for a root whose members are relays
  (``relay_grace_rounds > 0``, :mod:`gfedntm_tpu_torch.federation.relay`):
  a shard silent for that many rounds leaves the quorum denominator and the
  wait for pollable members, so the root aggregates over live shards;
- a round profiler window (``profiler``, a
  :class:`~gfedntm_tpu_torch.utils.observability.RoundProfiler`) observed
  by every round engine and closed when training ends.

Every keyword of the JAX server is accepted.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import math
import os
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
from gfedntm_tpu_torch.eval.monitor import (
    COHERENCE_COLLAPSE,
    ContributionTracker,
    TopicQualityMonitor,
    load_reference_corpus,
)
from gfedntm_tpu_torch.federated.aggregation import contribution_stats, make_aggregator
from gfedntm_tpu_torch.federated.stepper import FederatedStepper
from gfedntm_tpu_torch.federation import codec, pacing, rpc
from gfedntm_tpu_torch.federation.compression import (
    DownlinkEncoder,
    UplinkDecoder,
    encode_push_for_recipients,
    make_codec,
)
from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb
from gfedntm_tpu_torch.federation.device_agg import DeviceAggEngine
from gfedntm_tpu_torch.federation.registry import (
    DROPPED,
    Federation,
    looks_like_session_token as _looks_like_session_token,
)
from gfedntm_tpu_torch.federation.resilience import RetryPolicy
from gfedntm_tpu_torch.federation.sanitize import UpdateGate, decode_and_admit
from gfedntm_tpu_torch.models.avitm import AVITM
from gfedntm_tpu_torch.models.ctm import CTM
from gfedntm_tpu_torch.models.params import SHARE_ALL
from gfedntm_tpu_torch.privacy import PrivacyAccountant, ServerNoiser, parse_dp
from gfedntm_tpu_torch.train.checkpoint import (
    CheckpointIntegrityError,
    FederationCheckpointer,
    RoundJournal,
)
from gfedntm_tpu_torch.train.guardian import DivergenceGuardian
from gfedntm_tpu_torch.utils import flightrec
from gfedntm_tpu_torch.utils.slo import SLOEngine
from gfedntm_tpu_torch.utils.observability import (
    FleetRegistry,
    OpsServer,
    StragglerDetector,
    new_trace_id,
)

#: Additive NPMI slack the coherence-collapse guard gets under any DP mode
#: (the JAX server's ``DP_GUARD_NOISE_FLOOR``): per-round noise jitter must
#: not read as decay, while a genuine collapse (a drop of several tenths)
#: still fires. ``quality_monitor_kwargs={"noise_floor": ...}`` overrides it.
DP_GUARD_NOISE_FLOOR = 0.05


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
    return interop.optax_opt_state(model.model, model.optimizer,
                                   inject_lr=model.reduce_on_plateau)


class FederatedServer:
    """gRPC servicer + training orchestrator under any pacing.

    Parameters and their defaults mirror the JAX server's
    (``min_clients`` = the CLI's ``--min_clients_federation``, ``family`` +
    ``model_kwargs``, ``max_iters``, the resilience knobs, the data-plane
    defense, checkpoints and the journal, ``wire_codec`` and
    ``codec_ref_cache_max``, and the pacing options ``pacing_policy``,
    ``cohort_size``, ``async_buffer``, ``staleness_alpha`` and
    ``pacing_seed``), plus ``device`` for the template model and the
    aggregation plane.

    The privacy (``dp*``), quality (``quality_*``), ops and fleet
    (``ops_port``, ``ops_host``, ``slo_specs``, ``fleet_max_*``) and
    incident (``dump_dir``, ``flightrec_*``) options are the JAX server's;
    each plane constructs nothing while its option is off.

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
        checkpoint_every: int = 25,
        round_backoff_s: float = 0.5,
        fault_injector=None,
        aggregator="fedavg",
        aggregator_kwargs: dict[str, Any] | None = None,
        robust_aggregator: str | None = None,
        aggregation_backend: str = "auto",
        sanitize: bool = True,
        max_update_norm: float | None = None,
        outlier_mad_k: float = 4.0,
        divergence_patience: int = 3,
        divergence_loss_factor: float = 4.0,
        wire_codec: str = "none",
        codec_ref_cache: int = 8,
        codec_ref_cache_max: int = 64,
        ops_port: int | None = None,
        ops_host: str = "127.0.0.1",
        profiler=None,
        straggler_z: float = 2.0,
        quality_every: int = 0,
        quality_ref: str | None = None,
        quality_topn: int = 10,
        quality_guard: bool = False,
        quality_history: int = 64,
        quality_monitor_kwargs: dict[str, Any] | None = None,
        pacing_policy: str = "sync",
        cohort_size: int | None = None,
        async_buffer: int | None = None,
        staleness_alpha: float = 0.5,
        pacing_seed: int = 0,
        journal_every: int = 1,
        reconnect_grace_s: float = 120.0,
        relay_grace_rounds: int = 0,
        slo_specs=None,
        fleet_max_nodes: int = 512,
        fleet_max_series: int = 512,
        dp: str = "off",
        dp_clip: float = 1.0,
        dp_sigma: float = 0.0,
        dp_delta: float = 1e-5,
        dp_budget: float = 0.0,
        dp_seed: int = 0,
        dump_dir: str | None = None,
        flightrec_entries: int = 2048,
        flightrec_seconds: float = 300.0,
        flightrec_debounce_s: float = 30.0,
        flightrec_max_bundles: int = 32,
        device: str | torch.device | None = None,
    ):
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
        # Round pacing: "sync" is the all-clients barrier; "cohort:<K>"
        # samples a seeded K-of-N roster per round with inverse-inclusion
        # reweighting; "async:<B>" is FedBuff-style buffered aggregation
        # with staleness-discounted updates; "push:<B>" inverts the poll
        # (clients stream PushUpdate). Parsed here so a bad spec fails at
        # construction; the engine is built when training starts.
        self.pacing = pacing.parse_pacing(
            pacing_policy, cohort_size=cohort_size,
            async_buffer=async_buffer, staleness_alpha=staleness_alpha,
            seed=pacing_seed,
        )
        # FedAvg exchange period in local minibatches (1 = the reference's
        # per-minibatch averaging; E>1 = FedAvg proper), carried to clients
        # per StepRequest.
        self.local_steps = int(local_steps)
        self.retry_policy = retry_policy or RetryPolicy(metrics=metrics)
        self.probation_rounds = int(probation_rounds)
        self.quorum_fraction = float(quorum_fraction)
        # Round checkpoint period (0 disables; needs save_dir).
        self.checkpoint_every = int(checkpoint_every)
        self.round_backoff_s = float(round_backoff_s)
        self.fault_injector = fault_injector
        # The aggregate step is a strategy call: FedAvg is the reference's
        # weighted mean bit for bit; FedAvgM/FedAdam/FedYogi carry
        # server-optimizer state across rounds (checkpointed and journaled
        # with the round state); a robust spec swaps the mean stage.
        self.aggregator = make_aggregator(
            aggregator, robust=robust_aggregator, **(aggregator_kwargs or {})
        )
        # Aggregation data plane: "device" stacks each round's admitted
        # snapshots on the server's device for the gate statistics and the
        # mean stage; "numpy" is the host oracle; "auto" is "device" on a
        # CUDA server. Resolved at first template use (_ensure_template).
        if aggregation_backend not in ("auto", "device", "numpy"):
            raise ValueError(
                f"aggregation_backend must be auto|device|numpy, got "
                f"{aggregation_backend!r}"
            )
        self.aggregation_backend = aggregation_backend
        self._agg_backend_resolved: str | None = None
        # Data-plane defense, three layers: (1) the update admission gate
        # screens every decoded reply (conformance always; finiteness +
        # norm screening unless sanitize=False) and feeds repeat offenders
        # into probation; (2) the aggregator's mean stage may be robust;
        # (3) the divergence guardian watches the aggregate itself and
        # rolls back to a checkpoint (divergence_patience=0 disables it).
        self.update_gate = UpdateGate(
            check_finite=bool(sanitize),
            mad_k=float(outlier_mad_k) if sanitize else 0.0,
            max_update_norm=max_update_norm if sanitize else None,
            metrics=metrics, logger=self.logger,
        )
        self.guardian = (
            DivergenceGuardian(
                patience=divergence_patience,
                loss_factor=divergence_loss_factor,
                metrics=metrics, logger=self.logger,
            )
            if divergence_patience > 0 else None
        )
        # Privacy plane: dp="off" constructs nothing. "server" adds FedLD
        # noise to the aggregate after the mean stage and tightens the
        # gate's clip to dp_clip (the sensitivity the noise is calibrated
        # to); "client" expects the clients to sanitize and runs only the
        # ledger, charged at q = 1 with the declared parameters.
        self.dp = parse_dp(
            dp, clip=dp_clip, sigma=dp_sigma, delta=dp_delta,
            budget=dp_budget, seed=dp_seed,
        )
        self.privacy_accountant = None
        self._dp_noiser = None
        if self.dp.enabled:
            self.privacy_accountant = PrivacyAccountant(
                sigma=self.dp.sigma, delta=self.dp.delta,
                budget=self.dp.budget, mode=self.dp.mode,
            )
            if self.dp.mode == "server":
                self._dp_noiser = ServerNoiser(self.dp, metrics=metrics)
                self.aggregator.noiser = self._dp_noiser
                if sanitize:
                    gate = self.update_gate
                    gate.max_update_norm = (
                        self.dp.clip if gate.max_update_norm is None
                        else min(gate.max_update_norm, self.dp.clip)
                    )
                else:
                    self.logger.warning(
                        "dp='server' with sanitize off: the admission gate "
                        "is not enforcing the DP clip, so the declared "
                        "sensitivity bound rests on clients clipping honestly",
                    )
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
        # Hard cap on both reference caches: the rotation-aware size of
        # non-sync pacing (~4N/K, _size_codec_caches) grows with N at fixed
        # K, and server memory must not; past the cap a long-unsampled
        # client costs one self-contained push or one loud reference miss.
        self.codec_ref_cache_max = int(codec_ref_cache_max)
        # Push pacing adds PushUpdate threads encoding per-recipient
        # replies while the engine advances the canonical chain: every
        # codec session touch holds this.
        self._codec_lock = threading.Lock()
        # Per-client round of the last acked push: a push may only be
        # delta-encoded against a reference its recipient holds. Written
        # by the training loop and by servicer threads (a rejoiner is
        # discarded in ReadyForTraining), so every mutation holds the lock.
        self._push_lock = threading.Lock()
        self._push_acked: dict[int, int] = {}  # guarded-by: _push_lock
        # Push pacing: the round of the last broadcast each client was
        # SENT in a PushUpdate reply (caps its base_round claim: a client
        # cannot ack a round it was never given), and, after a rollback or
        # a recovery, the round each member still owes a session reset for
        # (the reset rides its replies until it applied a later round).
        self._push_sent: dict[int, int] = {}  # guarded-by: _push_lock
        self._reset_owed: dict[int, int] = {}  # guarded-by: _push_lock
        # Receipt-time replay guard for client-minted PushUpdate seqs,
        # apart from `_reply_seen` (which the drain reads and records):
        # recording a push seq at receipt would make its drain a replay.
        self._push_seen: dict[int, int] = {}
        # Identity-codec PushUpdate reply memo: (average object, round,
        # encoded bundle), one encode per installed average.
        self._push_identity_memo: "tuple[Any, int, pb.TensorBundle] | None" = None
        # Set by a divergence rollback (and by crash recovery): the NEXT
        # push carries Aggregate.reset_session so every recipient drops its
        # wire-codec session state before applying.
        self._session_reset_pending = False
        # Idempotent TrainStep: every delivery carries a server-minted seq,
        # monotonic across restarts (wall-clock epoch base); clients answer
        # a replayed seq from their cache, and `_reply_seen` drops a
        # duplicate StepReply before it can count twice in the average. The
        # base is in milliseconds (the JAX server's is in seconds): a
        # replacement started within the second of a kill must not reissue
        # the dead server's seqs, which its clients would answer from their
        # replay caches. 2^20 seqs per millisecond of the old server's life
        # keep it monotonic, and the value stays within int64.
        self._seq_epoch = (time.time_ns() // 1_000_000) << 20
        self._seq_counter = itertools.count(1)
        self._reply_seen: dict[int, int] = {}
        self.client_retry_policy = dataclasses.replace(
            self.retry_policy, idempotent=True
        )
        # Crash-recovery plane: a per-pushed-round journal (atomic npz +
        # JSON under save_dir/checkpoints) lets a killed server restarted
        # with the same arguments resume from the last fully-pushed round
        # (journal_every rounds of work at risk; 0 disables journaling and
        # autorecovery).
        self.journal_every = int(journal_every)
        self._round_journal: RoundJournal | None = None
        # Set by the first journal write that fails with an OSError:
        # training continues, journaling (and autorecovery) is off.
        self._journal_disabled = False
        self._recovered_from: int | None = None
        self._recovered_source: str | None = None
        # Monotonic time of the autorecovery restore, read by the
        # recovery_time_s gauge when the post-recovery quorum re-forms.
        self._recovered_at: float | None = None
        # After recovery the original min_clients bar may be unreachable:
        # training restarts once quorum_fraction of the restored
        # unfinished membership is back.
        self._resume_ready_needed: int | None = None
        # Restored members that have not reconnected hold the round loop
        # open for this long after training resumes (bounded).
        self.reconnect_grace_s = float(reconnect_grace_s)
        self._recovery_deadline: float | None = None
        # Shard supervision: when the members are relays, a shard silent
        # for this many rounds leaves the quorum denominator, so the root
        # aggregates over live shards instead of stalling until the dead
        # relay's probation runs out. 0 keeps the flat fleet's semantics.
        self.relay_grace_rounds = int(relay_grace_rounds)
        # Clients whose first poll (which builds the kernels) has been seen.
        self._poll_warmed: set[int] = set()
        self.trace_id: str | None = None
        # Ops endpoint (port 0 binds an ephemeral port, None starts no
        # thread): /healthz, /ready, /metrics, /status, /status.fleet and,
        # with SLOs, /alerts.
        self.ops_port = ops_port
        self.ops_host = ops_host
        self.ops_actual_port: int | None = None
        self._ops_server: OpsServer | None = None
        # The round profiler window, observed by the round engines; it
        # records this server's device unless it names one.
        self.profiler = profiler
        if profiler is not None and profiler.device is None:
            profiler.device = self.device
        self.straggler = StragglerDetector(
            registry=metrics.registry if metrics is not None else None,
            z_threshold=straggler_z,
        )
        # Fleet telemetry: the clients' registry reports ride their replies
        # and readies; the SLO engine is ticked once per aggregated round
        # (_fleet_tick), so no thread and no extra round trip.
        self.fleet = FleetRegistry(
            metrics=metrics, max_nodes=fleet_max_nodes,
            max_series_per_node=fleet_max_series,
        )
        if slo_specs:
            self.slo = SLOEngine(
                slo_specs, snapshot_fn=self.fleet.merged, metrics=metrics,
            )
        else:
            self.slo = None
        # Incident dumps: with a dump_dir (and a logger), a flight recorder
        # rings every logger record and the trigger writes a bundle when a
        # detector fires, then solicits the clients' rings through the
        # capture token of the next poll. No dump_dir constructs nothing.
        self.dump_dir = dump_dir
        self._incident_trigger: "flightrec.IncidentTrigger | None" = None
        self._flightrec_solicit: "tuple[str, float] | None" = None
        if dump_dir is not None and metrics is not None:
            recorder = flightrec.FlightRecorder(
                max_entries=flightrec_entries,
                max_seconds=flightrec_seconds,
                registry=metrics.registry,
            )
            metrics.recorder = recorder
            self._incident_trigger = flightrec.IncidentTrigger(
                recorder, dump_dir, metrics=metrics,
                node=metrics.node or "server",
                status_cb=lambda: self._status(full=False),
                debounce_s=flightrec_debounce_s,
                max_bundles=flightrec_max_bundles,
                on_capture=self._solicit_flightrec,
            )
        # Model-quality plane: with quality_every > 0, each quality round
        # scores the global beta's topics (NPMI against quality_ref,
        # diversity, drift) and every averaged round feeds the contribution
        # tracker; 0 constructs no monitor and runs nothing.
        if quality_every < 0:
            raise ValueError(
                f"quality_every must be >= 0, got {quality_every}"
            )
        self.quality_every = int(quality_every)
        self.quality_ref = quality_ref
        self.quality_topn = int(quality_topn)
        self.quality_guard = bool(quality_guard)
        self.quality_history = int(quality_history)
        self.quality_monitor_kwargs = dict(quality_monitor_kwargs or {})
        self._quality_mon = None
        self.contributions = ContributionTracker(
            registry=metrics.registry if metrics is not None else None
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
        # _aborted models a hard server crash (tests, chip_smoke.py): the
        # loop exits WITHOUT the stop broadcast or finalization, leaving
        # clients to their liveness watchdogs, as a kill would.
        self._aborted = threading.Event()
        self.training_done = threading.Event()
        self._grpc_server = None
        self._engine: pacing.RoundEngine | None = None
        self._template_shared: dict[str, np.ndarray] | None = None
        self._expected_keys: frozenset[str] | None = None
        self._ckpt: FederationCheckpointer | None = None
        # The most recent admitted cohort, written by _collect_snapshots
        # and read by the guardian: (client_id, weight, reported loss).
        self._round_accepted: list[tuple[int, float, float]] = []

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
        if self.ops_port is not None:
            self._ops_server = OpsServer(
                registry=(
                    self.metrics.registry if self.metrics is not None
                    else None
                ),
                status_fn=self._status,
                host=self.ops_host, port=self.ops_port,
                fleet=self.fleet,
                alerts_fn=self.slo.status if self.slo is not None else None,
            )
            self.ops_actual_port = self._ops_server.start()
            self.logger.info(
                "ops endpoint on http://%s:%d (/metrics /healthz /status)",
                self.ops_host, self.ops_actual_port,
            )
            if self.metrics is not None:
                self.metrics.log(
                    "ops_server_started", port=self.ops_actual_port,
                )
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
        self._stop_ops_server()

    def abort(self) -> None:
        """Hard-crash simulation: kill the gRPC server now and abandon the
        training loop with no stop broadcast and no finalization — clients
        are left to their liveness watchdogs, and a later server can
        :meth:`maybe_autorecover`. A caller in the same process joins
        ``_train_thread`` before a replacement reads the journal, since a
        real kill takes the thread's last journal write with it."""
        self._aborted.set()
        self._stopping.set()
        if self._grpc_server is not None:
            self._grpc_server.stop(0)
        self._stop_ops_server()

    def _stop_ops_server(self) -> None:
        if self._ops_server is not None:
            self._ops_server.stop()
            self._ops_server = None

    def wait_done(self, timeout: float | None = None) -> bool:
        return self.training_done.wait(timeout)

    # ---- the ops endpoint's views ------------------------------------------
    def _status(self, full: bool = False) -> dict[str, Any]:
        """The ops endpoint's ``/status`` payload, with the JAX server's keys
        (``server.py:651-759``): round progress, membership, codec and
        compression, recovery, stragglers, the data plane, the quality and
        privacy planes (``None`` while off) and the fleet's headline counts.
        The default view is bounded (membership counts and top-k members);
        ``full=True`` (``/status?full=1``) gives the whole roster and the
        per-client straggler and contribution series."""
        reg = self.metrics.registry if self.metrics is not None else None

        def gauge(name):
            metric = reg.get(name) if reg is not None else None
            return metric.value if metric is not None else None

        def count(name):
            metric = reg.get(name) if reg is not None else None
            return int(metric.value) if metric is not None else 0

        return {
            "round": int(self.global_iterations),
            "max_iters": int(self.max_iters),
            "min_clients": int(self.federation.min_clients),
            "training_started": self._train_thread is not None,
            "training_done": self.training_done.is_set(),
            "stopping": self._stopping.is_set(),
            "trace_id": self.trace_id,
            "codec": self.wire_codec.codec_id,
            "aggregator": self.aggregator.name,
            "local_steps": self.local_steps,
            "quorum_fraction": self.quorum_fraction,
            "pacing": (
                self._engine.status() if self._engine is not None
                else {"policy": self.pacing.spec_id}
            ),
            "clients": (
                self.federation.membership_snapshot() if full
                else self.federation.membership_summary()
            ),
            "recovery": {
                "recovered_from": self._recovered_from,
                "source": self._recovered_source,
                "journal_every": self.journal_every,
                "session_restores": count("session_restores"),
                "rpcs_deduplicated": count("rpcs_deduplicated"),
            },
            "compression": {
                "ratio_sent": gauge("compression_ratio_sent"),
                "ratio_recv": gauge("compression_ratio_recv"),
            },
            "stragglers": (
                self.straggler.status() if full
                else self.straggler.summary()
            ),
            "data_plane": {
                "agg_backend": (
                    self._agg_backend_resolved or self.aggregation_backend
                ),
                "sanitize": self.update_gate.check_finite,
                "outlier_mad_k": self.update_gate.mad_k,
                "max_update_norm": self.update_gate.max_update_norm,
                "updates_rejected": count("updates_rejected"),
                "updates_clipped": count("updates_clipped"),
                "rejections_by_client": dict(
                    self.update_gate.total_rejections
                ),
                "divergence_rollbacks": count("divergence_rollbacks"),
                "clients_quarantined": count("clients_quarantined"),
                "guardian_healthy": (
                    self.guardian.healthy if self.guardian is not None
                    else None
                ),
            },
            "model_quality": self._model_quality_status(full=full),
            "privacy": (
                self.privacy_accountant.status()
                if self.privacy_accountant is not None else None
            ),
            "fleet": {
                "nodes": len(self.fleet.node_snapshots()),
                "reports_invalid": count("fleet_reports_invalid"),
                "reports_dropped": count("fleet_reports_dropped"),
                "alerts_firing": (
                    self.slo.status()["firing"]
                    if self.slo is not None else None
                ),
            },
        }

    def _model_quality_status(self, full: bool = False) -> dict[str, Any] | None:
        if self.quality_every <= 0:
            return None
        out: dict[str, Any] = {
            "every": self.quality_every,
            "guard": self.quality_guard,
            "reference": self.quality_ref,
        }
        if self._quality_mon is not None:
            out.update(self._quality_mon.status())
        out["contributions"] = (
            self.contributions.status() if full
            else self.contributions.summary()
        )
        return out

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

    def _forget_wire_posture(self, client_id: int) -> None:
        """Drop a client's push-ack, push-sent and owed-reset posture and
        its reply and push seq guards, and its poll warm-up."""
        with self._push_lock:
            self._push_acked.pop(client_id, None)
            self._push_sent.pop(client_id, None)
            self._reset_owed.pop(client_id, None)
        self._reply_seen.pop(client_id, None)
        self._push_seen.pop(client_id, None)
        self._poll_warmed.discard(client_id)

    def _forget_process(self, client_id: int) -> None:
        """Drop what describes a client's previous process: its wire
        posture, poll warm-up, straggler EWMA and contribution history."""
        self._forget_wire_posture(client_id)
        self.straggler.forget(client_id)
        self.contributions.forget(client_id)

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

    # ---- round checkpoints and the crash-recovery journal ------------------
    def _checkpointer(self) -> FederationCheckpointer:
        """The FederationCheckpointer under ``save_dir/checkpoints`` (round
        checkpointing needs a save_dir)."""
        if self._ckpt is None:
            if self.save_dir is None:
                raise ValueError("round checkpointing requires save_dir")
            self._ckpt = FederationCheckpointer(
                os.path.join(self.save_dir, "checkpoints")
            )
        return self._ckpt

    def _membership_state(self) -> list[dict[str, Any]]:
        """JSON-able membership snapshot persisted with checkpoints and the
        round journal — session tokens included, so a restarted server can
        re-admit live-process reconnects."""
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

    def _state_extra(self) -> dict[str, Any]:
        """JSON-able run descriptors persisted with checkpoints and the
        journal, as the JAX server writes them (:930-963): ``model_kwargs``
        lets a serving process rebuild the template model from the journal
        alone; ``quality`` is the coherence guard's view of the journaled
        round (``flagged`` while an unhealthy streak is open), and
        ``privacy`` the (ε, δ) ledger, so a recovered run resumes its spent
        budget instead of starting a fresh one."""
        extra: dict[str, Any] = {
            "family": self.family,
            "aggregator": self.aggregator.name,
            "wire_codec": self.wire_codec.codec_id,
            "model_kwargs": dict(self.model_kwargs),
        }
        mon = self._quality_mon
        if mon is not None:
            view = mon.status()
            streak = int(view.get("unhealthy_streak") or 0)
            last = view.get("last") or {}
            extra["quality"] = {
                "flagged": streak > 0,
                "unhealthy_streak": streak,
                "npmi": last.get("npmi"),
                "round": last.get("round"),
            }
        if self.privacy_accountant is not None:
            extra["privacy"] = self.privacy_accountant.state_dict()
        return extra

    def _save_round_checkpoint(self) -> None:
        """Persist round state; a checkpoint failure is loud but never
        kills training (the checkpoint is the recovery path, not the
        workload)."""
        try:
            self._checkpointer().save_round(
                self.global_iterations, self.last_average,
                self._membership_state(),
                vocab=list(self.global_vocab.tokens),
                extra=self._state_extra(),
                aggregator_state=self.aggregator.state_dict(),
            )
        except Exception:
            self.logger.exception(
                "round checkpoint at %d failed", self.global_iterations
            )
            return
        if self.metrics is not None:
            self.metrics.registry.counter("checkpoints_saved").inc()
            self.metrics.log("checkpoint", round=self.global_iterations)

    def _journal(self) -> RoundJournal:
        if self._round_journal is None:
            if self.save_dir is None:
                raise ValueError("the round journal requires save_dir")
            self._round_journal = RoundJournal(
                os.path.join(self.save_dir, "checkpoints")
            )
        return self._round_journal

    def _note_journal_write_failure(self, iteration: int,
                                    err: Exception) -> None:
        """A journal write hit the filesystem's failure surface (ENOSPC,
        EIO): degrade loudly and disable journaling for the rest of the
        run. Training continues; only crash autorecovery is lost."""
        self._journal_disabled = True
        self.logger.error(
            "round journal write at %d failed (%s); journaling disabled "
            "for the rest of this run — training continues WITHOUT crash "
            "autorecovery", iteration, err,
        )
        if self.metrics is not None:
            self.metrics.registry.counter("journal_write_failures").inc()
            self.metrics.log(
                "journal_write_failed", round=iteration, error=str(err),
            )

    def _journal_round(self, iteration: int) -> None:
        """Journal one fully-pushed round (called by the engine after the
        push). A failure is loud but never kills training."""
        if (
            self.journal_every <= 0 or self.save_dir is None
            or self._journal_disabled
            or self.last_average is None
            or iteration % self.journal_every != 0
        ):
            return
        try:
            self._journal().record(
                iteration, self.last_average, self._membership_state(),
                vocab=list(self.global_vocab.tokens),
                extra=self._state_extra(),
                aggregator_state=self.aggregator.state_dict(),
            )
        except OSError as err:
            self._note_journal_write_failure(iteration, err)
        except Exception:
            self.logger.exception(
                "round journal write at %d failed", iteration
            )
            if self.metrics is not None:
                self.metrics.registry.counter("journal_errors").inc()

    def _mark_journal_finished(self) -> None:
        """Stamp the journal after a normal shutdown so the next server
        start's autorecovery probe does not resurrect a finished run."""
        if self.journal_every <= 0 or self.save_dir is None:
            return
        try:
            self._journal().mark_finished()
        except Exception:
            self.logger.exception("marking the round journal finished failed")
            if self.metrics is not None:
                self.metrics.registry.counter("journal_errors").inc()

    def _load_journal_state(self) -> "dict[str, Any] | None":
        """The round journal's recovery state, or ``None`` when absent,
        disabled, or marked finished. A corrupt journal is loud
        (``checkpoint_invalid``) but degrades to the round checkpoint."""
        if self.journal_every <= 0 or self.save_dir is None:
            return None
        try:
            return self._journal().load()
        except CheckpointIntegrityError as err:
            self.logger.error(
                "round journal unusable (%s); falling back to the latest "
                "checkpoint", err,
            )
            if self.metrics is not None:
                self.metrics.registry.counter("checkpoint_invalid").inc()
                self.metrics.log("checkpoint_invalid", reason=str(err))
            return None

    def _invalid_checkpoint(self, err: Exception) -> None:
        self.logger.error("cannot resume: %s", err)
        if self.metrics is not None:
            self.metrics.registry.counter("checkpoint_invalid").inc()
            self.metrics.log("checkpoint_invalid", reason=str(err))

    def restore_from_checkpoint(self) -> int:
        """Rebuild vocabulary, template, ``last_average``, the round
        counter and the (not yet ready) membership from the newer of the
        round journal and the latest round checkpoint under ``save_dir``
        (``server.py:1083-1212``); the restored average is applied onto the
        template so rejoining clients replicate the trained state. Call
        before :meth:`start`. Returns the round the loop continues from;
        raises ``FileNotFoundError`` when there is nothing to resume and
        :class:`~gfedntm_tpu_torch.train.checkpoint.CheckpointIntegrityError`
        (after a ``checkpoint_invalid`` event) when what exists is corrupt
        or cannot be read by this package."""
        ckpt = self._checkpointer()
        jstate = self._load_journal_state()
        try:
            meta = ckpt.load_meta()
            ckpt_round = ckpt.latest_round() if meta is not None else None
        except CheckpointIntegrityError as err:
            if jstate is None:
                self._invalid_checkpoint(err)
                raise
            self.logger.error(
                "checkpoint unusable (%s); recovering from the round "
                "journal alone", err,
            )
            meta, ckpt_round = None, None
        # The journal records the last fully-PUSHED round R (resume at
        # R+1); the checkpoint sidecar records the resume round directly.
        # Prefer whichever is further along.
        use_journal = jstate is not None and (
            ckpt_round is None
            or int(jstate["round"]) + 1 >= int(ckpt_round)
        )
        if not use_journal and (meta is None or ckpt_round is None):
            raise FileNotFoundError(
                f"no federation checkpoint or round journal under "
                f"{ckpt.directory}"
            )
        source = jstate if use_journal else meta
        vocab = source.get("vocab")
        if not vocab:
            raise CheckpointIntegrityError(
                "recovery state has no consensus vocabulary; delete "
                f"{ckpt.directory} to start the federation fresh"
            )
        self.global_vocab = Vocabulary(tuple(vocab))
        self.template = build_template_model(
            self.family, len(self.global_vocab), self.model_kwargs,
            device=self.device,
        )
        self._template_shared = None
        template = self._shared_template()
        self._expected_keys = frozenset(template)
        self.update_gate.set_template(template)
        if use_journal:
            missing = [
                k for k in jstate["average_keys"] if k not in template
            ]
            if missing:
                raise ValueError(
                    f"journal avg keys not in template (model config "
                    f"changed since the journal?): {missing[:3]}"
                )
            round_idx = int(jstate["round"]) + 1
            average = {
                k: np.asarray(jstate["average"][k], dtype=v.dtype)
                for k, v in template.items() if k in jstate["average"]
            }
            self._restore_journal_aggregator(jstate)
        else:
            try:
                round_idx, average = ckpt.restore_round(template)
            except CheckpointIntegrityError as err:
                self._invalid_checkpoint(err)
                raise
            self._restore_aggregator_state(ckpt, meta, round_idx)
        self.last_average = average
        self.global_iterations = int(round_idx)
        self._restore_privacy(source.get("privacy"))
        self._restore_membership(source.get("membership") or ())
        # Recovered-server wire posture: this process holds no codec
        # session state and no push acks — the next push is
        # self-contained and orders a fleet-wide session reset, and token
        # reconnects get the per-client reset order (Ack code 3).
        self._session_reset_pending = not self.wire_codec.identity
        if self.pacing.policy == "push" and not self.wire_codec.identity:
            # A push server is never polled, so _encode_push (the consumer
            # of _session_reset_pending) never runs, and a client whose
            # channel heals within its stub's retry window never re-presents
            # its token for the Ack-3 reset: the reset rides every member's
            # PushUpdate replies instead, or its delta uplinks reference
            # pre-crash state this process does not hold.
            with self._push_lock:
                self._reset_owed = {
                    c.client_id: int(round_idx)
                    for c in self.federation.get_clients()
                    if not c.finished
                }
        self._recovered_from = int(round_idx)
        self._recovered_source = "journal" if use_journal else "checkpoint"
        FederatedStepper(self.template, self.grads_to_share).set_gradients(
            average
        )
        with self._setup_lock:
            self._setup_reply = self._setup_reply_from_template()
        self.logger.info(
            "resumed federation from round %d via the %s (%d restored "
            "members)", round_idx,
            "round journal" if use_journal else "checkpoint",
            len(source.get("membership", ())),
        )
        if self.metrics is not None:
            self.metrics.log("resume", step=round_idx)
        return round_idx

    def _restore_privacy(self, state) -> None:
        """Resume the (ε, δ) ledger from recovery state (``server.py:1213-1251``):
        ε continues and never resets. The journal is written before the
        round's ledger tick, so the journaled ledger can lag the released
        noise by one round: recovery charges one conservative catch-up
        step, and the server noiser's application counter follows the
        ledger's step count, so no draw the dead process may have spent is
        reused. A ledger in the recovery state of a server that now runs
        ``dp="off"`` is carried nowhere, loudly."""
        if state is None:
            return
        if self.privacy_accountant is None:
            self.logger.warning(
                "recovery state carries a privacy ledger (%s steps, "
                "mode=%s) but this server runs dp='off'; the ledger is NOT "
                "carried forward — rounds from here on are unaccounted",
                state.get("steps"), state.get("mode"),
            )
            return
        self.privacy_accountant.load_state_dict(dict(state))
        self.privacy_accountant.step(
            q=self.privacy_accountant.last_q or 1.0
        )
        if self._dp_noiser is not None:
            self._dp_noiser.applications = self.privacy_accountant.steps
        self.logger.info(
            "resumed privacy ledger: eps=%.4f at delta=%g after %d noised "
            "rounds (incl. one conservative catch-up step for the "
            "possibly-uncharged in-flight round)",
            self.privacy_accountant.epsilon(),
            self.privacy_accountant.delta, self.privacy_accountant.steps,
        )

    def _restore_journal_aggregator(self, jstate: dict) -> None:
        """Reload journaled server-optimizer slots (same name-mismatch
        stance as :meth:`_restore_aggregator_state`)."""
        saved_name = jstate.get("aggregator")
        arrays = jstate.get("aggregator_state") or {}
        if not arrays:
            return
        if saved_name is not None and saved_name != self.aggregator.name:
            self.logger.warning(
                "journal was written by aggregator %r but this server "
                "runs %r; server-optimizer state starts fresh",
                saved_name, self.aggregator.name,
            )
            return
        self.aggregator.load_state_dict(arrays)

    def _restore_membership(self, membership) -> None:
        """Repopulate the registry from a recovery snapshot: members keep
        their identity, FedAvg weight, progress and session tokens, but
        none are training-ready until they reconnect. The training restart
        bar becomes ``quorum_fraction`` of the restored unfinished
        membership (capped by ``min_clients``)."""
        unfinished = 0
        for m in membership:
            try:
                client_id = int(m["client_id"])
            except (KeyError, TypeError, ValueError):
                continue
            finished = bool(m.get("finished"))
            self.federation.restore_member(
                client_id,
                nr_samples=float(m.get("nr_samples") or 0.0),
                session_token=str(m.get("session_token") or ""),
                finished=finished,
                current_mb=int(m.get("current_mb") or 0),
                current_epoch=int(m.get("current_epoch") or 0),
                needs_codec_reset=not self.wire_codec.identity,
            )
            unfinished += not finished
        if unfinished:
            self._resume_ready_needed = max(
                1, math.ceil(self.quorum_fraction * unfinished)
            )

    def maybe_autorecover(self) -> "int | None":
        """Crash recovery with no operator flags: when ``save_dir`` holds a
        round journal (or checkpoint) of an interrupted run — this
        package's or the JAX package's — restore it and return the resume
        round; return ``None`` when there is nothing to recover or the
        previous run finished cleanly. Corrupt state still raises."""
        if self.save_dir is None or self.journal_every <= 0:
            # No journal ⇒ no autorecovery: without the journal's finished
            # stamp a cleanly-completed run would be resurrected.
            return None
        try:
            finished = bool(
                (self._journal().load_meta() or {}).get("finished")
            )
        except CheckpointIntegrityError:
            finished = False
        if finished:
            self.logger.info(
                "previous federation under %s finished cleanly; "
                "starting fresh", self.save_dir,
            )
            return None
        try:
            round_idx = self.restore_from_checkpoint()
        except FileNotFoundError:
            return None
        self.logger.warning(
            "auto-recovered an interrupted federation: resuming from "
            "round %d (re-admitting session-token reconnects)", round_idx,
        )
        self._recovered_at = time.monotonic()
        if self.metrics is not None:
            self.metrics.registry.counter("server_recoveries").inc()
            self.metrics.log(
                "server_recovered", round=round_idx,
                source=self._recovered_source or "checkpoint",
            )
        return round_idx

    def _restore_aggregator_state(self, ckpt, meta: dict, round_idx) -> None:
        """Reload the server aggregator's optimizer state saved with the
        round checkpoint; an aggregator-name mismatch or a round mismatch
        restarts it stateless, loudly."""
        saved_name = meta.get("aggregator")
        if saved_name is not None and saved_name != self.aggregator.name:
            self.logger.warning(
                "checkpoint was written by aggregator %r but this server "
                "runs %r; server-optimizer state starts fresh",
                saved_name, self.aggregator.name,
            )
            return
        state = ckpt.load_aggregator_state()
        if state is None:
            return
        state_round, arrays = state
        if int(state_round) != int(round_idx):
            self.logger.warning(
                "aggregator state is from round %d but the round "
                "checkpoint is %d (crash between the two saves); "
                "server-optimizer state starts fresh", state_round, round_idx,
            )
            return
        self.aggregator.load_state_dict(arrays)
        self.logger.info(
            "restored %s aggregator state (%d arrays) from round %d",
            self.aggregator.name, len(arrays), state_round,
        )

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
        if request.telemetry:
            # The joining client's full registry report rides its ready and
            # heals any deltas lost while it was away.
            self.fleet.ingest_bytes(request.telemetry)
        ack_code, ack_detail = 0, "ready recorded"
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
            if (
                self.federation.consume_codec_reset(request.client_id)
                and not self.wire_codec.identity
            ):
                # This server recovered from a crash and holds none of the
                # codec session state the reconnecting client carries:
                # order a client-side reset so the next bundles are
                # self-contained on both ends.
                ack_code = 3
                ack_detail = (
                    "session restored by a recovered server; reset "
                    "wire-codec sessions"
                )
            if request.recovered:
                # The presenter restored itself from its own journal: same
                # session and weight, but its wire-codec state died with
                # the old process.
                self._forget_wire_posture(request.client_id)
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
            # After crash recovery the original min_clients bar may be
            # unreachable: the restored run restarts once quorum_fraction
            # of the restored unfinished membership is back.
            needed = self.federation.min_clients
            if self._resume_ready_needed is not None:
                needed = min(needed, self._resume_ready_needed)
            if (
                self._train_thread is None
                and sum(
                    c.ready_for_training
                    for c in self.federation.get_clients()
                )
                >= needed
            ):
                if self._recovered_at is not None:
                    elapsed = time.monotonic() - self._recovered_at
                    self._recovered_at = None
                    if self.metrics is not None:
                        self.metrics.registry.gauge(
                            "recovery_time_s"
                        ).set(elapsed)
                self._train_thread = threading.Thread(
                    target=self._run_training, name="federated-training",
                    daemon=True,
                )
                self._train_thread.start()
        return pb.Ack(code=ack_code, detail=ack_detail)

    def PushUpdate(self, request: pb.StepReply, context) -> pb.Aggregate:
        """A client-initiated round under push pacing (``server.py:1543-1736``):
        buffer the streamed update for the engine's FedBuff drain and answer
        with the freshest broadcast, per-recipient delta-encoded against the
        round the client reports holding, so one RPC moves the update up and
        the model down.

        The durable-session token authenticates the push (a stale process's
        update must not enter the average); the client's ``base_round``
        claim is its broadcast ack, clamped to what this server sent it. The
        reply is a hold marker (``round=-1``) before training starts, an
        empty marker when the client is already current, and ``stop`` once
        the federation is over."""
        cid = int(request.client_id)
        m = self.metrics
        if self._stopping.is_set() or self.training_done.is_set():
            return pb.Aggregate(stop=True)
        if self.pacing.policy != "push":
            self.logger.warning(
                "client %d sent PushUpdate but this federation paces %s; "
                "refusing", cid, self.pacing.spec_id,
            )
            if m is not None:
                m.registry.counter("push_updates_refused").inc()
            return pb.Aggregate(stop=True)
        rec = self.federation.get(cid)
        if (
            rec is None or not rec.session_token
            or rec.session_token != request.session_token
        ):
            # An unknown member or a token minted for another process: the
            # pusher is stale, and is told to finalize.
            self.logger.warning(
                "client %d PushUpdate with a stale/unknown session "
                "token; refusing", cid,
            )
            if m is not None:
                m.registry.counter("push_updates_refused").inc()
            return pb.Aggregate(stop=True)
        engine = self._engine
        if not isinstance(engine, pacing.PushEngine):
            # Training has not started: a hold marker (round=-1, nothing
            # buffered), so the client re-presents the same round later.
            return pb.Aggregate(round=-1)

        # Every reply in a solicitation window carries the capture token;
        # the client answers it once, on its next push.
        tok = self.flightrec_token()

        # Broadcast-ack bookkeeping from the client's claim, capped by what
        # this server sent it (the delta encoder trusts the ack).
        claimed = int(request.base_round) - 1
        with self._push_lock:
            acked = min(claimed, self._push_sent.get(cid, -1))
            if acked >= 0:
                self._push_acked[cid] = acked
            else:
                self._push_acked.pop(cid, None)
            owed_round = self._reset_owed.get(cid)
            if owed_round is not None and acked >= owed_round:
                # The member applied a post-reset round THIS process sent
                # (acked is clamped to _push_sent): its reset landed. The
                # raw claim must not clear it — a surviving client's
                # pre-crash base_round can sit past the recovered round
                # while this process delivered nothing.
                self._reset_owed.pop(cid, None)
                owed_round = None
        reset = owed_round is not None

        # Replay guard: the stub retries UNAVAILABLE, so a push delivered
        # but whose reply was lost would be buffered twice without it. A
        # duplicate still gets the freshest broadcast, not a buffer slot.
        seq = int(request.seq)
        duplicate = bool(seq) and self._push_seen.get(cid, 0) >= seq
        if duplicate:
            self.logger.warning(
                "client %d: duplicate PushUpdate seq %d; answering "
                "without re-buffering", cid, seq,
            )
            if m is not None:
                m.registry.counter("rpcs_deduplicated").inc()
                m.log(
                    "rpc_deduplicated", client=cid, method="PushUpdate",
                    seq=seq,
                )
        else:
            if seq:
                self._push_seen[cid] = seq
            if request.telemetry:
                # The client's registry deltas ride its push.
                self.fleet.ingest_bytes(request.telemetry)
            if request.flightrec and self._incident_trigger is not None:
                # A solicited flight-record snapshot rides the push.
                self._incident_trigger.ingest_remote(request.flightrec)
            self.federation.update_progress(
                cid, int(request.current_mb), int(request.current_epoch),
                float(request.loss), finished=bool(request.finished),
            )
            depth = engine.submit(rec, request)
            if m is not None:
                m.registry.counter("push_updates_received").inc()
                m.registry.gauge("push_buffer_depth").set(depth)

        # Reply with the freshest installed broadcast. The round tag and the
        # bundle are read atomically against the engine's chain advance: a
        # round-K view labelled K-1 would skew the client's uplink chain.
        if self.wire_codec.identity:
            # Counter before payload: a race with the engine's install may
            # under-label (the client re-applies an identical view later)
            # but never over-label (the client would skip the real round).
            current = int(self.global_iterations) - 1
            avg = self.last_average
            if avg is None or current < 0 or (
                not reset and acked >= current
            ):
                # Nothing new: an empty marker (round <= applied); an owed
                # reset still rides it.
                return pb.Aggregate(
                    round=max(current, claimed, 0), reset_session=reset,
                    capture_token=tok,
                )
            # One encode per installed average (keyed by the dict's
            # identity, so a rollback's fresh dict invalidates it), not one
            # per push.
            memo = self._push_identity_memo
            if memo is None or memo[0] is not avg or memo[1] != current:
                memo = (avg, current, codec.flatdict_to_bundle(avg, metrics=m))
                self._push_identity_memo = memo
            agg = pb.Aggregate(
                shared=memo[2], round=current, reset_session=reset,
                capture_token=tok,
            )
        else:
            with self._codec_lock:
                # The chain's own round tags the bundle bundle_for serves. A
                # recovered server has a fresh chain (last_round=-1) until
                # its first aggregation: empty markers until then.
                current = self._downlink_enc.last_round
                if current < 0 or (not reset and acked >= current):
                    # A bare reset order still rides the empty marker: the
                    # client must drop its pre-crash sessions before its
                    # next uplink encode, or no update can decode.
                    return pb.Aggregate(
                        round=max(current, claimed, 0), reset_session=reset,
                        capture_token=tok,
                    )
                bundle = self._downlink_enc.bundle_for(
                    None if reset else (acked if acked >= 0 else None)
                )
            agg = pb.Aggregate(
                shared=bundle, round=current, reset_session=reset,
                capture_token=tok,
            )
        with self._push_lock:
            self._push_sent[cid] = current
        return agg

    def _advance_broadcast(
        self, average: dict[str, np.ndarray], iteration: int
    ) -> None:
        """Push pacing: advance the canonical broadcast chain for a round
        with no immediate recipients; members pick it up, per-recipient
        encoded, in their next PushUpdate replies."""
        if self.wire_codec.identity:
            return
        with self._codec_lock:
            _bundle, view = self._downlink_enc.advance(
                average, round_idx=iteration
            )
            self._uplink_dec.note_push(iteration, view)

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
            self.contributions.forget(rec.client_id)
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

    def _fleet_tick(self, iteration: int) -> None:
        """Once per aggregated round (``server.py:1883-1898``): fold the
        server's own registry into the fleet view, run one SLO evaluation
        over the merged snapshot, and charge the privacy ledger."""
        if self.metrics is not None:
            node = self.metrics.node or "server"
            self.fleet.ingest(
                node, self.metrics.registry.snapshot(), full=True,
            )
        if self.slo is not None:
            self.slo.evaluate()
        self._privacy_tick(iteration)

    def _privacy_tick(self, iteration: int) -> None:
        """Charge the (ε, δ) ledger for one aggregated round
        (``server.py:1900-1943``): skipped rounds apply no mechanism and are
        charged nothing, so the ledger's steps stay in step with the
        noiser's applications. q is the engine's inclusion probability: the
        cohort sampler's live K/eligible, 1 under sync, async and push
        pacing. Crossing the budget is loud (a warning, a
        counter and one ``privacy_budget_exceeded`` event) but never stops
        training."""
        acct = self.privacy_accountant
        if acct is None:
            return
        q = (
            self._engine.inclusion_q() if self._engine is not None
            else 1.0
        )
        was_exceeded = acct.exceeded
        eps = acct.step(q=q)
        if self.metrics is not None:
            self.metrics.registry.gauge("privacy_eps").set(eps)
            self.metrics.log(
                "privacy_budget", round=iteration, eps=float(eps),
                delta=acct.delta, steps=acct.steps, q=float(q),
                sigma=acct.sigma, mode=acct.mode, budget=acct.budget,
            )
        if acct.exceeded and not was_exceeded:
            self.logger.warning(
                "privacy budget EXCEEDED at round %d: eps=%.4f > declared "
                "budget %.4f (delta=%g); training continues — the offline "
                "`privacy` gate is the enforcement point",
                iteration, eps, acct.budget, acct.delta,
            )
            if self.metrics is not None:
                self.metrics.registry.counter(
                    "privacy_budget_exceeded"
                ).inc()
                self.metrics.log(
                    "privacy_budget_exceeded", round=iteration,
                    eps=float(eps), budget=acct.budget, delta=acct.delta,
                )

    # ---- incident dumps ----------------------------------------------------
    def _solicit_flightrec(self, incident_id: str, reason: str,
                           trigger_record: dict) -> None:
        """The incident trigger's post-capture hook: arm a capture token
        that rides every poll for the next 120 s, asking each client for
        its flight-record snapshot (best-effort; clients dedupe by
        token)."""
        self._flightrec_solicit = (incident_id, time.time() + 120.0)
        if self.metrics is not None:
            self.metrics.log(
                "flightrec_requested", incident_id=incident_id,
                reason=reason,
            )

    def flightrec_token(self) -> str:
        """The live solicitation token ("" when none is armed or its window
        has closed), stamped onto outgoing StepRequests."""
        sol = self._flightrec_solicit
        if sol is None:
            return ""
        token, expires = sol
        if time.time() >= expires:
            self._flightrec_solicit = None
            return ""
        return token

    def _next_step_seq(self) -> int:
        """Fresh TrainStep delivery sequence number, monotonic within the
        process and across restarts."""
        return self._seq_epoch + next(self._seq_counter)

    def _current_global(self) -> dict[str, np.ndarray]:
        """The parameters every client stepped from this round: the last
        broadcast average, or the template init before round 0 — the
        reference of the gate's update norms and of the server optimizer's
        pseudo-gradient."""
        return (
            self.last_average if self.last_average is not None
            else self._shared_template()
        )

    def _awaiting_reconnect_grace(self) -> bool:
        """True while the post-recovery grace window is open and some
        restored member has not reconnected: the round engine then waits
        (no rounds burned) instead of ending the federation without it."""
        if self._recovery_deadline is None:
            return False
        if time.monotonic() >= self._recovery_deadline:
            return False
        return bool(self.federation.awaiting_reconnect())

    def _ensure_template(self) -> None:
        if self._expected_keys is None:
            template = self._shared_template()
            self._expected_keys = frozenset(template)
            self.update_gate.set_template(template)
        self._resolve_agg_backend()

    def _resolve_agg_backend(self) -> None:
        """Pick the aggregation data-plane backend at first template use:
        ``auto`` is ``device`` on a CUDA server and ``numpy`` on a CPU one;
        ``device`` runs the engine on the server's device, CPU included.
        An engine failure raises: there is no fallback to numpy."""
        if self._agg_backend_resolved is not None:
            return
        mode = self.aggregation_backend
        if mode == "auto":
            mode = "device" if self.device.type == "cuda" else "numpy"
        if mode == "device":
            engine = DeviceAggEngine(self.device)
            self.update_gate.set_engine(engine)
            if self._dp_noiser is not None:
                # The server noise is drawn on the engine's device.
                self._dp_noiser.device_engine = engine
            self.logger.info("aggregation backend: device (%s)", engine.device)
        else:
            self.update_gate.set_engine(None)
        self._agg_backend_resolved = mode
        if self.metrics is not None:
            self.metrics.registry.gauge("agg_backend_device").set(
                1.0 if mode == "device" else 0.0
            )

    def _collect_snapshots(
        self, replies: list, iteration: int,
        was_suspect: frozenset = frozenset(),
        weight_scale: "dict[int, float] | None" = None,
        staleness: "dict[int, int] | None" = None,
    ):
        """Decode a round's replies and pass them through the update
        admission gate (:func:`~gfedntm_tpu_torch.federation.sanitize.decode_and_admit`,
        ``server.py:2062-2191``): conformance, finiteness and the cohort
        norm screen. A replayed reply (a seq already consumed) is dropped;
        anything the codec cannot decode or the gate rejects costs the
        round one contributor, and repeat offenders enter probation with
        ``reason="poisoned"``. A suspect clears probation only when its
        update is accepted. The FedAvg weight is the reply's
        ``nr_samples``, falling back to the join-time corpus size, times
        ``weight_scale``'s entry for the client (the async and push
        engines' staleness discount; absent entries scale by 1).
        ``staleness`` (rounds since each client's base broadcast) makes the
        norm screen judge staleness-normalized norms, so an honest client
        polled from an old broadcast does not read as a poisoner.

        Returns the admitted cohort as ``[(weight, snapshot)]`` on the
        numpy backend, or as a
        :class:`~gfedntm_tpu_torch.federation.device_agg.StackedRound` on
        the device backend; ``_round_accepted`` keeps (client, weight,
        loss) per admitted reply for the guardian."""
        self._ensure_template()
        m = self.metrics
        deduped: list = []
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
            if reply.telemetry:
                # The client's registry deltas ride its reply; one ingest
                # per reply that is not a replay.
                self.fleet.ingest_bytes(reply.telemetry)
            deduped.append((rec, reply))

        if self.wire_codec.identity:
            def decode(bundle):
                return codec.bundle_to_flatdict(bundle, metrics=m)
        else:
            decode = self._uplink_dec.decode

        def on_decode_error(rec, err):
            self.logger.warning(
                "round %d: client %d reply not decodable (%s); "
                "excluding it from the average",
                iteration, rec.client_id, err,
            )

        def on_poisoned(rec, rej):
            self._note_client_failure(
                rec, rec.address, iteration,
                RuntimeError(f"{rej.reason}: {rej.detail}"),
                "update admission", reason="poisoned",
            )

        def on_recovered(client_id):
            if self.federation.mark_recovered(client_id):
                self.logger.info(
                    "client %d recovered (update admitted at round %d)",
                    client_id, iteration,
                )
                if m is not None:
                    m.registry.counter("client_recoveries").inc()
                    m.log("client_recovered", client=client_id,
                          round=iteration)

        result, losses, _records = decode_and_admit(
            deduped, decode, self.update_gate, self._current_global(),
            iteration, metrics=m, was_suspect=was_suspect,
            weight_scale=weight_scale, staleness=staleness,
            on_decode_error=on_decode_error, on_poisoned=on_poisoned,
            on_recovered=on_recovered,
        )
        self._round_accepted = [
            (client_id, weight, losses[client_id])
            for client_id, weight, _snap in result.accepted
        ]
        if result.stacked is not None:
            return result.stacked
        return [
            (weight, snap) for _client_id, weight, snap in result.accepted
        ]

    def _encode_push(
        self, average: dict[str, np.ndarray], iteration: int, replies: list
    ) -> "dict[int, pb.Aggregate]":
        """Encode one round's push per recipient through the negotiated
        wire codec: the shared chain bundle for an up-to-date recipient,
        an exact catch-up bundle for one holding an older cached view, a
        self-contained bundle for one holding nothing usable."""
        reset_session = self._session_reset_pending
        self._session_reset_pending = False
        recipients = [rec.client_id for rec, _reply in replies]
        if self.wire_codec.identity:
            return encode_push_for_recipients(
                None, None, average, iteration, recipients, {},
                reset_session, metrics=self.metrics,
            )
        with self._push_lock:
            acked = dict(self._push_acked)
        with self._codec_lock:
            return encode_push_for_recipients(
                self._downlink_enc, self._uplink_dec, average, iteration,
                recipients, acked, reset_session, metrics=self.metrics,
            )

    def _divergence_rollback(
        self, iteration: int, verdict: str
    ) -> "dict[str, np.ndarray] | None":
        """Restore the last good checkpointed round after a divergence
        verdict and return its average (the rollback re-broadcast), or
        ``None`` when nothing safe exists to restore
        (``server.py:2229-2352``). Alongside the parameters the wire-codec
        sessions are reset (the re-broadcast is self-contained and orders
        every recipient to reset its own), the aggregator's optimizer
        state is rolled back to the same round, clients whose admitted
        weight dominated the unhealthy streak are quarantined through
        probation, and the guardian's baselines are re-anchored."""
        m = self.metrics
        restored: dict[str, np.ndarray] | None = None
        restored_round: int | None = None
        if self.save_dir is not None:
            try:
                ckpt = self._checkpointer()
                if ckpt.latest_round() is not None:
                    self._ensure_template()
                    restored_round, restored = ckpt.restore_round(
                        self._shared_template()
                    )
                    self._restore_aggregator_state(
                        ckpt, ckpt.load_meta() or {}, restored_round
                    )
            except Exception:
                self.logger.exception(
                    "round %d: divergence rollback restore failed",
                    iteration,
                )
                restored, restored_round = None, None
        if restored is None:
            # No checkpoint to return to. A non-finite aggregate must still
            # never reach a client — fall back to the last broadcast state;
            # a loss/norm explosion keeps the computed average and the
            # guardian keeps watching (and the periodic checkpoint stays
            # withheld while it is unhealthy).
            if verdict != "nonfinite_global":
                self.logger.error(
                    "round %d: divergence (%s) but no checkpoint to roll "
                    "back to; continuing with the current aggregate",
                    iteration, verdict,
                )
                return None
            restored = self._current_global()
            self.logger.error(
                "round %d: non-finite aggregate and no checkpoint; "
                "re-broadcasting the last finite state instead",
                iteration,
            )
        # The push reference chains describe the diverged trajectory: drop
        # them all, server-side now and client-side through the
        # re-broadcast's reset_session.
        with self._push_lock:
            self._push_acked.clear()
            self._push_sent.clear()
            if self.pacing.policy == "push":
                # Reply-delivered resets: every unfinished member owes one
                # until it applied a post-rollback round.
                self._reset_owed = {
                    c.client_id: iteration
                    for c in self.federation.get_clients()
                    if not c.finished
                }
        self._session_reset_pending = True
        if not self.wire_codec.identity:
            with self._codec_lock:
                self._uplink_dec.reset()
                self._downlink_enc.reset()
        quarantined = (
            self.guardian.dominant_contributors()
            if self.guardian is not None else []
        )
        for client_id in quarantined:
            rec = self.federation.get(client_id)
            if rec is None:
                continue
            self._note_client_failure(
                rec, rec.address, iteration,
                RuntimeError(f"dominated the diverged rounds ({verdict})"),
                "divergence quarantine", reason="divergence",
            )
            if m is not None:
                m.registry.counter("clients_quarantined").inc()
                m.log(
                    "client_quarantined", client=client_id,
                    round=iteration, reason=verdict,
                )
        if self.guardian is not None:
            self.guardian.note_rollback()
        self.logger.warning(
            "round %d: DIVERGENCE (%s) — rolled back to %s, quarantined "
            "%s", iteration, verdict,
            f"checkpointed round {restored_round}"
            if restored_round is not None else "last finite state",
            quarantined or "nobody",
        )
        if m is not None:
            m.registry.counter("divergence_rollbacks").inc()
            event = dict(round=iteration, reason=verdict)
            if restored_round is not None:
                event["restored_round"] = int(restored_round)
            m.log("divergence_rollback", **event)
        return restored

    # ---- the model-quality plane --------------------------------------------
    def _ensure_quality_monitor(self):
        """The topic-quality monitor, built on the first quality round (the
        global vocabulary exists only after consensus). Under any DP mode
        the coherence guard gets :data:`DP_GUARD_NOISE_FLOOR` of slack
        unless ``quality_monitor_kwargs`` sets its own."""
        if self.quality_every <= 0:
            return None
        if self._quality_mon is None:
            ref = (
                load_reference_corpus(self.quality_ref)
                if self.quality_ref else None
            )
            if ref is None:
                self.logger.warning(
                    "quality monitoring is on without quality_ref: NPMI "
                    "coherence (and the coherence guard) are disabled; "
                    "diversity and drift still run"
                )
            kwargs = dict(self.quality_monitor_kwargs)
            if self.dp.enabled and "noise_floor" not in kwargs:
                kwargs["noise_floor"] = DP_GUARD_NOISE_FLOOR
            self._quality_mon = TopicQualityMonitor(
                every=self.quality_every,
                id2token=self.global_vocab.id2token,
                ref_tokens=ref,
                topn=self.quality_topn,
                history=self.quality_history,
                metrics=self.metrics,
                logger=self.logger,
                **kwargs,
            )
        return self._quality_mon

    def _observe_contributions(self, iteration: int, snapshots,
                               average: dict[str, np.ndarray]) -> None:
        """Per-client contribution analytics over the admitted cohort: each
        update's cosine to the aggregate update the cohort produced (never a
        rollback's restored state) and the pairwise summary, from the numpy
        oracle or the engine's gram over the stacked round."""
        if len(snapshots) == 0:
            return
        client_ids = [c for c, _w, _l in self._round_accepted]
        if isinstance(snapshots, list):
            cos, norms, pair_mean, pair_min = contribution_stats(
                [s for _w, s in snapshots], self._current_global(), average,
            )
        else:  # the device backend's StackedRound
            cos, norms, pair_mean, pair_min = (
                snapshots.engine.contribution_stats(snapshots, average)
            )
        self.contributions.observe_round(
            iteration, client_ids, cos, norms, pair_mean, pair_min,
        )

    def _quality_step(
        self, iteration: int, snapshots, average: dict[str, np.ndarray],
        accepted_average: "dict[str, np.ndarray] | None" = None,
    ) -> dict[str, np.ndarray]:
        """One round's model-quality pass, after the aggregate and before the
        push (``server.py:2425-2496``): contribution analytics every averaged
        round, the topic monitor on its cadence, and with ``quality_guard``
        a ``coherence_collapse`` verdict routed through
        :meth:`_divergence_rollback` (the returned average is then the
        restored one). ``accepted_average`` is what the cohort produced when
        the loss guardian already swapped ``average`` for a checkpoint.
        Observation failures are counted in ``quality_errors`` and never
        kill the round loop."""
        if self.quality_every <= 0:
            return average
        m = self.metrics
        try:
            self._observe_contributions(
                iteration, snapshots,
                accepted_average if accepted_average is not None
                else average,
            )
        except Exception:
            self.logger.exception(
                "round %d: contribution analytics failed", iteration
            )
            if m is not None:
                m.registry.counter("quality_errors").inc()
        monitor = None
        try:
            monitor = self._ensure_quality_monitor()
        except Exception:
            self.logger.exception(
                "quality monitor construction failed; disabling the "
                "topic-quality plane (contribution analytics stay on)"
            )
            self.quality_ref = None
            if m is not None:
                m.registry.counter("quality_errors").inc()
        if monitor is None or not monitor.should_run(iteration):
            return average
        try:
            monitor.observe(iteration, average)
        except Exception:
            self.logger.exception(
                "round %d: quality observation failed", iteration
            )
            if m is not None:
                m.registry.counter("quality_errors").inc()
            return average
        if self.quality_guard and monitor.collapsed:
            restored = self._divergence_rollback(
                iteration, COHERENCE_COLLAPSE
            )
            if restored is not None:
                # Only a rollback that restored state re-anchors the
                # monitor; with nothing to restore the verdict keeps firing.
                monitor.note_rollback()
                return restored
        return average

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

    def _size_codec_caches(self) -> None:
        """Size both codec reference caches at training start
        (``server.py:2512``). Cohort, async and push recipients sync at
        different rounds, so uplink deltas may reference broadcasts older
        than the sync cache depth: size the caches to the rotation period
        (every client is polled again within ~N/K aggregations) so
        ``codec_ref_miss`` stays 0, capped at ``codec_ref_cache_max``."""
        if self.pacing.policy == "sync" or self.wire_codec.identity:
            return
        fan = max(self.pacing.cohort_size, self.pacing.buffer_size, 1)
        sized = max(
            self._uplink_dec.max_refs,
            4 * math.ceil(max(1, len(self.federation)) / fan),
        )
        capped = min(sized, max(1, self.codec_ref_cache_max))
        if capped < sized:
            self.logger.info(
                "codec reference cache capped at %d (rotation-aware "
                "size would be %d): long-unsampled clients degrade to "
                "self-contained pushes", capped, sized,
            )
        self._uplink_dec.max_refs = capped
        self._downlink_enc.max_views = capped

    def _run_training(self) -> None:
        # The recovery grace clock starts when training actually resumes.
        if self.federation.awaiting_reconnect():
            self._recovery_deadline = (
                time.monotonic() + self.reconnect_grace_s
            )
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
            if self.profiler is not None:
                self.profiler.close()
            if self.metrics is not None:
                self.metrics.snapshot_registry(rounds=self.global_iterations)
            self._stopping.set()
            self.training_done.set()

    def _training_loop(self) -> None:
        stubs: dict[int, tuple[str, Any, rpc.ServiceStub]] = {}
        engine = self._engine = pacing.make_engine(self, self.pacing)
        self._size_codec_caches()
        pool = ThreadPoolExecutor(max_workers=engine.pool_workers(self.poll_workers))
        self.logger.info(
            "starting federated training (%s pacing): total weight %.0f",
            self.pacing.spec_id, self.federation.total_weight(),
        )
        try:
            engine.run(stubs, pool)
        finally:
            if not self._aborted.is_set():
                self._stop_broadcast(stubs)
                self._finalize()
                self._mark_journal_finished()
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
