"""Simulated-client fleet for control-plane scale runs and smokes.

A copy of ``gfedntm_tpu/federation/simfleet.py`` over the port's server.
A :class:`SimClientServicer` is a protocol-faithful stand-in for a real
federated client: it answers ``TrainStep`` with ``applied_state + noise``
instead of running a stepper (so it launches no kernel), and applies pushes
by decoding them through real wire-codec sessions. Everything the scale
story is about — the gRPC message shapes, the per-recipient delta/topk
codec, the admission gate, the registry, the pacing engines — is the
production code; only the learning is stubbed, which makes a
thousands-of-clients loopback run feasible on one host.

Per-client persistent state is O(1) beyond the optional codec sessions:
with the identity codec a sim client holds only a *reference* to the
decoded broadcast (shared across the fleet via :class:`SharedDecode`), so
harness memory cannot mask the server's.

:class:`SimFleetServer` is a :class:`~gfedntm_tpu_torch.federation.server.FederatedServer`
whose ``_stub_for`` returns in-process stubs that count wire bytes
(``ByteSize()`` both ways) instead of opening sockets. Its template model
and aggregation plane live on ``device`` (``None`` is the GPU).
"""

from __future__ import annotations

import logging
import time
from typing import Any

import numpy as np

from gfedntm_tpu_torch.federation import codec
from gfedntm_tpu_torch.federation.compression import (
    DownlinkDecoder,
    UplinkEncoder,
    WireCodec,
    make_codec,
)
from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb
from gfedntm_tpu_torch.federation.server import FederatedServer, build_template_model
from gfedntm_tpu_torch.utils import observability

__all__ = [
    "SharedDecode",
    "SimClientServicer",
    "SimFleetServer",
    "ByteCounter",
    "make_sim_fleet",
]


class ByteCounter:
    """Wire-byte accounting for the loopback transport: request and reply
    proto sizes, exactly what gRPC would have moved."""

    def __init__(self):
        self.sent = 0  # server -> client payload bytes
        self.recv = 0  # client -> server payload bytes
        self.calls = 0

    def note(self, request, reply) -> None:
        self.calls += 1
        self.sent += request.ByteSize()
        if reply is not None:
            self.recv += reply.ByteSize()


class SharedDecode:
    """One decode per pushed bundle, shared by every identity-codec sim
    client that applies it — N copies of the same round's broadcast would
    charge the harness O(N·D) memory and drown the server signal."""

    def __init__(self):
        self._round = None
        self._view: dict[str, np.ndarray] | None = None

    def decode(self, agg: pb.Aggregate) -> dict[str, np.ndarray]:
        key = (int(agg.round), len(agg.shared.tensors))
        if self._round != key:
            self._view = codec.bundle_to_flatdict(agg.shared)
            self._round = key
        return self._view


class SimClientServicer:
    """Protocol-faithful fake client (see module docstring).

    ``steps`` bounds the client's local budget: the reply accompanying
    its last budgeted step carries ``finished=True`` so runs terminate
    exactly like a real fleet. ``noise`` scales the per-step parameter
    drift (rng seeded per client, deterministic).

    ``metrics`` opts the sim client into the fleet telemetry plane
    (README "Fleet telemetry & SLOs"): each local round observes a
    DETERMINISTIC synthetic ``local_step_s`` sample (a function of
    (client_id, step), so e2e tests can compare the server's fleet-merged
    histogram bucket-for-bucket against an offline merge of the clients'
    JSONL snapshots) and the reply piggybacks the node's delta-encoded
    report exactly like a real client."""

    def __init__(
        self,
        client_id: int,
        nr_samples: float = 10.0,
        steps: int = 8,
        noise: float = 1e-3,
        wire_codec: "str | WireCodec | None" = None,
        shared_decode: SharedDecode | None = None,
        seed: int = 0,
        metrics=None,
    ):
        self.client_id = int(client_id)
        self.nr_samples = float(nr_samples)
        self.steps = int(steps)
        self.noise = float(noise)
        self._rng = np.random.default_rng((seed, client_id))
        self._codec = make_codec(wire_codec)
        self._uplink = (
            UplinkEncoder(self._codec) if not self._codec.identity else None
        )
        self._downlink = (
            DownlinkDecoder(self._codec) if not self._codec.identity
            else None
        )
        self._shared_decode = shared_decode
        self.metrics = metrics
        self._shipper = (
            observability.TelemetryShipper(
                registry=metrics.registry,
                node=metrics.node or f"client{client_id}",
            )
            if metrics is not None else None
        )
        self._applied: dict[str, np.ndarray] | None = None
        self._applied_round = -1
        self._step = 0
        self.finished = False
        self.session_token = ""

    # -- local "training" ----------------------------------------------------
    def _snapshot(
        self, base: "dict[str, np.ndarray]"
    ) -> dict[str, np.ndarray]:
        # Snapshots present TEMPLATE dtypes, like a real stepper: a
        # decoded average carries float64-promoted int counters, and
        # echoing those back would trip the conformance gate.
        out = {}
        for k, v in base.items():
            arr = np.asarray(v)
            want = self._dtypes.get(k, arr.dtype)
            if arr.dtype.kind == "f" and arr.size:
                arr = arr + self.noise * self._rng.standard_normal(
                    arr.shape
                ).astype(arr.dtype)
            out[k] = arr.astype(want, copy=False)
        return out

    def build_update(
        self, template: "dict[str, np.ndarray]", seq: int = 0
    ) -> pb.StepReply:
        """One local round's StepReply: template-or-applied state plus
        noise, encoded through the real uplink session."""
        base = self._applied if self._applied is not None else template
        snap = self._snapshot(base)
        self._step += 1
        if self._step >= self.steps:
            self.finished = True
        if self.metrics is not None:
            # Deterministic synthetic step time (NOT wall clock): the
            # telemetry e2e asserts exact bucket-count equality between
            # the live fleet merge and the offline JSONL merge.
            self.metrics.registry.histogram("local_step_s").observe(
                0.001 * (1 + (self.client_id + self._step) % 7)
            )
        if self._uplink is not None:
            shared = self._uplink.encode(snap)
        else:
            shared = codec.flatdict_to_bundle(snap)
        return pb.StepReply(
            client_id=self.client_id,
            shared=shared,
            loss=1.0 / self._step,
            nr_samples=self.nr_samples,
            current_mb=self._step,
            current_epoch=0,
            finished=self.finished,
            base_round=self._applied_round + 1,
            seq=seq,
            session_token=self.session_token,
            telemetry=(
                self._shipper.build() if self._shipper is not None else b""
            ),
        )

    # -- servicer face (the loopback stub calls these) ------------------------
    def TrainStep(self, request: pb.StepRequest, context) -> pb.StepReply:
        return self.build_update(self._template, seq=int(request.seq))

    def ApplyAggregate(
        self, request: pb.Aggregate, context
    ) -> pb.AggregateReply:
        self.apply(request)
        return pb.AggregateReply(
            client_id=self.client_id, finished=self.finished,
            current_epoch=0,
        )

    def apply(self, agg: pb.Aggregate) -> None:
        if agg.stop:
            self.finished = True
            return
        if not len(agg.shared.tensors) and not agg.reset_session:
            return  # empty marker (push pacing: nothing new)
        if agg.reset_session:
            if self._uplink is not None:
                self._uplink.reset()
            if self._downlink is not None:
                self._downlink.reset()
            if not len(agg.shared.tensors):
                # Bare reset order (recovered push server, nothing
                # aggregated yet): sessions dropped, nothing delivered.
                return
        if self._downlink is not None:
            view = self._downlink.decode(
                agg.shared, round_idx=int(agg.round)
            )
            if self._uplink is not None:
                self._uplink.note_aggregate(view, int(agg.round))
        elif self._shared_decode is not None:
            view = self._shared_decode.decode(agg)
        else:
            view = codec.bundle_to_flatdict(agg.shared)
        self._applied = view
        self._applied_round = int(agg.round)

    def bind_template(self, template: "dict[str, np.ndarray]") -> None:
        self._template = template
        self._dtypes = {k: np.asarray(v).dtype for k, v in template.items()}


class _LoopbackChannel:
    def close(self) -> None:
        pass


class _LoopbackStub:
    """In-process transport counting proto bytes both ways."""

    def __init__(self, servicer: SimClientServicer, counter: ByteCounter,
                 injector=None, peer: str = ""):
        self._servicer = servicer
        self._counter = counter
        self._injector = injector
        self._peer = peer

    def TrainStep(self, request, timeout=None, **_kw):
        if self._injector is not None:
            self._injector.before_call(
                "gfedntm.FederationClient", "TrainStep", request,
                peer=self._peer,
            )
        reply = self._servicer.TrainStep(request, None)
        self._counter.note(request, reply)
        return reply

    def ApplyAggregate(self, request, timeout=None, **_kw):
        reply = self._servicer.ApplyAggregate(request, None)
        self._counter.note(request, reply)
        return reply


class SimFleetServer(FederatedServer):
    """FederatedServer whose transport is loopback calls into sim-client
    servicers — full control-plane fidelity without N sockets. ``kw`` are
    the server's (``device`` among them)."""

    def __init__(self, servicers: "dict[int, SimClientServicer]",
                 counter: ByteCounter | None = None, **kw):
        super().__init__(**kw)
        self._sim_servicers = servicers
        self.byte_counter = counter or ByteCounter()

    def _stub_for(self, stubs, rec):
        entry = stubs.get(rec.client_id)
        if entry is None:
            stub = _LoopbackStub(
                self._sim_servicers[rec.client_id], self.byte_counter,
                injector=self.fault_injector,
                peer=f"client{rec.client_id}",
            )
            entry = (rec.address, _LoopbackChannel(), stub)
            stubs[rec.client_id] = entry
        return entry[2]


def make_sim_fleet(
    n_clients: int,
    *,
    vocab_size: int = 120,
    steps: int = 6,
    wire_codec: "str | None" = None,
    client_codec: bool = False,
    seed: int = 0,
    logger: logging.Logger | None = None,
    client_metrics=None,
    device=None,
    **server_kw: Any,
) -> "tuple[SimFleetServer, dict[int, SimClientServicer], dict[str, np.ndarray]]":
    """Build a registered, training-ready simulated fleet: a tiny AVITM
    template, N sim clients (identity-codec clients share one decode),
    and a :class:`SimFleetServer` with every client connected + ready
    (the training thread is live on return). ``client_codec=False`` keeps
    per-client state O(1) (requires the identity codec server-side).
    ``client_metrics`` (``cid -> MetricsLogger | None``) opts sim clients
    into telemetry shipping (see :class:`SimClientServicer`). The server's
    template and aggregation plane live on ``device`` (``None`` is the
    GPU)."""
    from gfedntm_tpu_torch.data.vocab import Vocabulary

    kwargs = dict(
        n_components=4, hidden_sizes=(8,), batch_size=8, num_epochs=1,
        seed=0,
    )
    tokens = tuple(sorted(f"w{i:04d}" for i in range(vocab_size)))
    vocab = Vocabulary(tokens)
    codec_spec = wire_codec or "none"
    if client_codec is False and codec_spec != "none":
        raise ValueError(
            "client_codec=False (O(1) sim clients) requires the identity "
            "codec; pass client_codec=True for delta/topk runs"
        )
    shared = SharedDecode()
    servicers = {
        cid: SimClientServicer(
            cid, steps=steps,
            wire_codec=codec_spec if client_codec else None,
            shared_decode=shared, seed=seed,
            metrics=client_metrics(cid) if client_metrics else None,
        )
        for cid in range(1, n_clients + 1)
    }
    server = SimFleetServer(
        servicers,
        min_clients=n_clients,
        family="avitm",
        model_kwargs=kwargs,
        wire_codec=codec_spec,
        device=device,
        **server_kw,
    )
    server.global_vocab = vocab
    server.template = build_template_model(
        "avitm", len(tokens), kwargs, device=server.device,
    )
    template = server._shared_template()
    for cid, servicer in servicers.items():
        servicer.bind_template(template)
        server.federation.connect_vocab(cid, (), 10.0)
        server.federation.set_session_token(cid, f"sim-token-{cid}")
        servicer.session_token = f"sim-token-{cid}"
        ack = server.ReadyForTraining(
            pb.JoinRequest(
                client_id=cid, address=f"sim:{cid}",
                codec_id=codec_spec,
                session_token=f"sim-token-{cid}",
            ),
            None,
        )
        assert ack.code == 0, f"sim client {cid} refused: {ack.detail}"
    # The readiness quorum starts the training thread, but the pacing
    # engine is created inside it — without this wait a caller touching
    # server._engine (or pushing updates it expects to be buffered, not
    # HOLD-marked) races engine creation.
    deadline = time.monotonic() + 30.0
    while server._engine is None:
        if time.monotonic() > deadline:
            raise RuntimeError("sim fleet pacing engine did not start")
        time.sleep(0.001)
    return server, servicers, template
