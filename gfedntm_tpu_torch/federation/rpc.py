"""gRPC service wiring without generated service stubs.

A copy of ``gfedntm_tpu/federation/rpc.py`` (numpy, grpc and the
standard library only), its imports rewritten to ``gfedntm_tpu_torch``; the
rest is the original's, so both packages speak the same wire
(``tests/test_torch_federation_codec.py`` holds it to the original).

The image ships the gRPC runtime and ``protoc`` (message codegen) but not
``grpcio-tools`` (service codegen), so services are registered through
gRPC's generic-handler API from one declarative table. This replaces the
reference's checked-in generated stubs (``src/protos/federated_pb2_grpc.py``)
and also carries the channel options the reference sets for large tensor
messages (``main.py:218-242``: 250 MB caps + keepalive).
"""

from __future__ import annotations

import time
from typing import Any

import grpc

from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb
from gfedntm_tpu_torch.utils import observability as obs

SERVICES: dict[str, dict[str, tuple[Any, Any]]] = {
    "gfedntm.Federation": {
        "OfferVocab": (pb.VocabOffer, pb.Ack),
        "GetGlobalSetup": (pb.JoinRequest, pb.GlobalSetup),
        "ReadyForTraining": (pb.JoinRequest, pb.Ack),
        # Push pacing (README "Hierarchical federation & wire efficiency"):
        # a client-initiated round — the client streams its post-local-round
        # update, the reply carries the freshest broadcast (per-recipient
        # delta-encoded against whatever the client reports holding).
        "PushUpdate": (pb.StepReply, pb.Aggregate),
    },
    "gfedntm.FederationClient": {
        "TrainStep": (pb.StepRequest, pb.StepReply),
        "ApplyAggregate": (pb.Aggregate, pb.AggregateReply),
    },
    # Serving plane (README "Serving"): the user-facing doc->topic
    # inference workload, served by the `serve` CLI role against
    # journal/checkpoint-published rounds while the federation trains.
    "gfedntm.Inference": {
        "Infer": (pb.InferRequest, pb.InferReply),
    },
}

# Methods an impl may legitimately omit at add_service time (the caller
# then gets UNIMPLEMENTED): PushUpdate exists only under push pacing, and
# pre-push test servicers predate it. Everything else is mandatory —
# a missing production handler fails fast at registration.
OPTIONAL_METHODS: dict[str, frozenset[str]] = {
    "gfedntm.Federation": frozenset({"PushUpdate"}),
}

# Reference message caps (main.py:218-242, dft_params.cf:37-44) with sane
# keepalive: 60 s client pings, and servers must advertise a matching
# minimum ping interval or they answer with ENHANCE_YOUR_CALM GOAWAYs.
_MSG_CAPS = [
    ("grpc.max_send_message_length", 250 * 1024 * 1024),
    ("grpc.max_receive_message_length", 250 * 1024 * 1024),
]
CHANNEL_OPTIONS = _MSG_CAPS + [
    ("grpc.keepalive_time_ms", 60_000),
    ("grpc.keepalive_timeout_ms", 20_000),
    ("grpc.keepalive_permit_without_calls", 1),
]
SERVER_OPTIONS = _MSG_CAPS + [
    ("grpc.http2.min_recv_ping_interval_without_data_ms", 30_000),
    ("grpc.keepalive_permit_without_calls", 1),
]


def add_service(server: grpc.Server, service_name: str, impl: Any,
                fault_injector: Any = None, metrics: Any = None) -> None:
    """Register ``impl`` (an object with one method per RPC) on ``server``.

    ``fault_injector`` (a
    :class:`~gfedntm_tpu_torch.federation.resilience.FaultInjector`) intercepts
    each dispatch BEFORE the servicer method runs — an injected error
    surfaces to the remote caller as a real gRPC status, exercising its
    retry/probation paths over a healthy connection.

    ``metrics`` (a
    :class:`~gfedntm_tpu_torch.utils.observability.MetricsLogger`) wraps every
    dispatch in a ``serve`` span carrying the trace context extracted from
    the caller's gRPC metadata (trace id, the SENDER's span id as
    ``remote_parent_id``, round, the paired send/recv clock stamps the
    trace merger aligns on). ``metrics=None`` registers the raw behaviours
    unchanged — the un-instrumented dispatch path is bit-identical.

    An impl may omit a method listed in :data:`OPTIONAL_METHODS`
    (standard gRPC semantics: calling an unregistered method returns
    UNIMPLEMENTED) — e.g. a pre-push-pacing test servicer without
    ``PushUpdate``. Every other method is mandatory and raises here at
    registration time: a typo'd production handler must crash at
    startup, not surface mid-training as an UNIMPLEMENTED feeding the
    probation machinery."""
    spec = SERVICES[service_name]
    handlers = {}
    for method, (req_cls, resp_cls) in spec.items():
        behaviour = getattr(impl, method, None)
        if behaviour is None:
            if method in OPTIONAL_METHODS.get(service_name, ()):
                continue
            raise AttributeError(
                f"{type(impl).__name__} does not implement required "
                f"method {method} of {service_name}"
            )
        if fault_injector is not None:
            behaviour = _injected_behaviour(
                fault_injector, service_name, method, behaviour
            )
        if metrics is not None:
            behaviour = _traced_behaviour(
                metrics, service_name, method, behaviour
            )
        handlers[method] = grpc.unary_unary_rpc_method_handler(
            behaviour,
            request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString,
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(service_name, handlers),)
    )


def _injected_behaviour(injector: Any, service: str, method: str, fn: Any):
    from gfedntm_tpu_torch.federation.resilience import InjectedRpcError

    def behaviour(request, context):
        try:
            injector.before_call(service, method, request)
        except InjectedRpcError as exc:
            context.abort(exc.code(), exc.details())
        return fn(request, context)

    return behaviour


def _traced_behaviour(metrics: Any, service: str, method: str, fn: Any):
    """Wrap one servicer method in a ``serve`` span parented (remotely)
    under the caller's span via the trace metadata it attached. Sits
    OUTSIDE the fault injector so injected dispatch failures show up as
    failed serve spans in the merged trace."""
    short = service.rsplit(".", 1)[-1]

    def behaviour(request, context):
        fields = obs.extract_trace_context(
            context.invocation_metadata() if context is not None else ()
        )
        fields["rpc_recv_time"] = time.time()
        client_id = getattr(request, "client_id", 0)
        if client_id:
            fields["client"] = int(client_id)
        with obs.span(metrics, "serve", method=f"{short}.{method}",
                      **fields):
            return fn(request, context)

    return behaviour


def _with_deadline(fn, default_timeout: float | None, metrics=None,
                   service: str = "", method: str = "", peer: str = "",
                   retry_policy=None, fault_injector=None):
    """Apply a default gRPC deadline: a deadline-less unary call on an
    unconnectable channel blocks forever (no RST ⇒ no error), which would
    hang the training thread on the first unreachable client.

    With a ``metrics`` logger, each call also feeds the telemetry registry:
    per-method latency histograms (``rpc_s/<Service>.<Method>``), call/byte
    counters, and deadline-expiry counters. Successful calls stay out of
    the JSONL stream (they surface via ``metrics_snapshot``); failures are
    logged as individual ``rpc`` events — they are rare and diagnostic."""
    if metrics is not None:
        reg = metrics.registry
        short = service.rsplit(".", 1)[-1]
        hist = reg.histogram(f"rpc_s/{short}.{method}")
        calls = reg.counter("rpc_calls")
        errors = reg.counter("rpc_errors")
        deadline_expired = reg.counter("rpc_deadline_expired")
        bytes_sent = reg.counter("rpc_bytes_sent")
        bytes_recv = reg.counter("rpc_bytes_recv")

    def attempt(request, timeout: float | None = None, **kwargs):
        if timeout is None:
            timeout = default_timeout
        if fault_injector is not None:
            fault_injector.before_call(service, method, request, peer=peer)
        if metrics is None:
            response = fn(request, timeout=timeout, **kwargs)
            if fault_injector is not None:
                # Reply-payload faults (kind="corrupt"): the caller sees a
                # response the peer "emitted" corrupted — the data-plane
                # counterpart of the pre-call transport faults.
                response = fault_injector.after_call(
                    service, method, response, peer=peer
                )
            return response
        # Trace-context propagation: explicit caller metadata (the server's
        # poll/push workers pass trace_pairs with the round span) wins;
        # otherwise attach the ambient span context. The node label and a
        # FRESH send-time stamp (per attempt — retries re-send) ride along
        # so the servicer side can pair clocks. metrics=None skips all of
        # this: the un-instrumented wire is bit-identical.
        md = list(kwargs.pop("metadata", None) or ())
        if obs.TRACE_ID_KEY not in {k for k, _ in md}:
            md.extend(obs.ambient_trace_pairs(metrics))
        node = getattr(metrics, "node", None)
        if node:
            md.append((obs.NODE_KEY, node))
        md.append((obs.SEND_TIME_KEY, f"{time.time():.6f}"))
        kwargs["metadata"] = md
        t0 = time.perf_counter()
        calls.inc()
        bytes_sent.inc(request.ByteSize())
        try:
            response = fn(request, timeout=timeout, **kwargs)
        except Exception as exc:
            # Failures stay OUT of the latency histogram — a deadline
            # expiry observes the timeout constant, not a latency, and
            # would dominate the report's p95/p99. The rpc event below
            # carries the duration instead.
            dt = time.perf_counter() - t0
            errors.inc()
            code = (
                exc.code().name
                if isinstance(exc, grpc.RpcError) and callable(
                    getattr(exc, "code", None)
                )
                else type(exc).__name__
            )
            if code == "DEADLINE_EXCEEDED":
                deadline_expired.inc()
            metrics.log(
                "rpc", service=service, method=method, seconds=dt,
                ok=False, code=code, peer=peer,
            )
            raise
        hist.observe(time.perf_counter() - t0)
        bytes_recv.inc(response.ByteSize())
        if fault_injector is not None:
            response = fault_injector.after_call(
                service, method, response, peer=peer
            )
        return response

    if retry_policy is None:
        return attempt

    # The retry wrapper sits OUTSIDE the per-attempt instrumentation: every
    # attempt is individually metered (rpc_calls/rpc_errors/latency), while
    # the policy's own retry_* counters account the recovery behaviour.
    def call(request, timeout: float | None = None, **kwargs):
        return retry_policy.call(attempt, request, timeout=timeout, **kwargs)

    return call


class ServiceStub:
    """Client-side callables for one service over a persistent channel —
    unlike the reference, which opens a fresh channel per RPC
    (``server.py:449,515``; part of its ≥3 s/step orchestration floor).

    Every call carries a default deadline (the reference's 120 s
    phase-transition timeout, ``server.py:237``); pass ``timeout=`` per call
    to override. ``metrics`` (a
    :class:`~gfedntm_tpu_torch.utils.observability.MetricsLogger`) turns on
    per-call latency/byte instrumentation; ``peer`` labels error events.

    ``retry_policy`` (a
    :class:`~gfedntm_tpu_torch.federation.resilience.RetryPolicy`) transparently
    retries transient failures with backoff; ``fault_injector`` (a
    :class:`~gfedntm_tpu_torch.federation.resilience.FaultInjector`) fails
    scripted calls before they reach the wire — each retry attempt
    re-consults the script, so an N-times fault costs N attempts — and
    corrupts scripted replies after they return (``kind="corrupt"``
    payload faults: the data-plane chaos the admission gate defends
    against)."""

    def __init__(
        self,
        channel: grpc.Channel,
        service_name: str,
        default_timeout: float | None = 120.0,
        metrics=None,
        peer: str = "",
        retry_policy=None,
        fault_injector=None,
    ):
        for method, (req_cls, resp_cls) in SERVICES[service_name].items():
            setattr(
                self,
                method,
                _with_deadline(
                    channel.unary_unary(
                        f"/{service_name}/{method}",
                        request_serializer=req_cls.SerializeToString,
                        response_deserializer=resp_cls.FromString,
                    ),
                    default_timeout,
                    metrics=metrics,
                    service=service_name,
                    method=method,
                    peer=peer,
                    retry_policy=retry_policy,
                    fault_injector=fault_injector,
                ),
            )


def make_channel(address: str) -> grpc.Channel:
    return grpc.insecure_channel(address, options=CHANNEL_OPTIONS)


def make_server(max_workers: int = 16) -> grpc.Server:
    from concurrent.futures import ThreadPoolExecutor

    return grpc.server(
        ThreadPoolExecutor(max_workers=max_workers), options=SERVER_OPTIONS
    )
