"""Federation resilience primitives: retry policy + fault injection.

A copy of ``gfedntm_tpu/federation/resilience.py`` (numpy, grpc and the
standard library only), its imports rewritten to ``gfedntm_tpu_torch``; the
rest is the original's, so both packages speak the same wire
(``tests/test_torch_federation_codec.py`` holds it to the original).

The reference federation is fail-stop — the first client failure crashes the
round loop (SURVEY.md §5 "no retry"), and our initial rewrite only upgraded
that to fail-soft (one transient ``UNAVAILABLE`` permanently drops the
client). This module provides the two building blocks of the recovery story:

- :class:`RetryPolicy` — exponential backoff with decorrelated jitter and a
  per-gRPC-code classification of transient vs. permanent errors. Every
  :class:`~gfedntm_tpu_torch.federation.rpc.ServiceStub` call can route through
  one, so a connection blip costs milliseconds instead of a federation
  member. ``DEADLINE_EXCEEDED`` is deliberately NOT retried at the RPC
  layer: a timed-out ``TrainStep`` may have executed on the client (the
  call is not idempotent), so deadline expiries are handled one level up by
  the server's round-scoped probation (``registry.mark_suspect``), which
  re-polls the client on a later round instead of re-issuing the step.
- :class:`FaultInjector` — deterministic scripted per-call failures (drop,
  delay, error-code) AND per-reply payload corruptions (``nan`` /
  ``scale:<x>`` / ``random`` applied to the tensor bundle of a response),
  seeded, injectable into both the client-side stub and the servicer
  dispatch path, so every recovery path — transport-level and
  data-plane — is exercisable in-process without flaky socket games.

Both are pure-Python and dependency-free beyond ``grpc`` (already a
federation dependency); neither touches the wire format.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import grpc

from gfedntm_tpu_torch.utils import flightrec

#: gRPC status codes that indicate the request (very likely) never executed
#: and is safe to re-issue immediately: connection refused / channel reset
#: (UNAVAILABLE), server admission pushback (RESOURCE_EXHAUSTED), and
#: serializable-conflict style aborts (ABORTED).
TRANSIENT_CODES: frozenset[grpc.StatusCode] = frozenset({
    grpc.StatusCode.UNAVAILABLE,
    grpc.StatusCode.RESOURCE_EXHAUSTED,
    grpc.StatusCode.ABORTED,
})


def error_code(exc: BaseException) -> grpc.StatusCode | None:
    """The gRPC status code of an exception, or None for non-RPC errors."""
    code = getattr(exc, "code", None)
    if callable(code):
        try:
            code = code()
        except Exception:
            return None
    return code if isinstance(code, grpc.StatusCode) else None


def is_transient(exc: BaseException) -> bool:
    """Transient = safe to retry the same RPC. Non-gRPC connection errors
    (refused sockets surfacing as OS errors) count; everything else —
    including ``DEADLINE_EXCEEDED``, where the call may have run — is
    permanent at the RPC layer (see module docstring)."""
    code = error_code(exc)
    if code is not None:
        return code in TRANSIENT_CODES
    return isinstance(exc, ConnectionError)


@dataclass
class RetryPolicy:
    """Exponential backoff with decorrelated jitter (the AWS-architecture
    variant: each delay is uniform on ``[base, 3 * previous]``, capped).

    ``seed`` fixes the jitter sequence per call (each ``call`` re-derives
    its RNG from the seed), making retry timing reproducible in tests;
    ``seed=None`` uses the global RNG. ``sleep`` is injectable so tests can
    record delays instead of waiting them out. ``metrics`` (an object with
    a ``registry``, i.e. a MetricsLogger) feeds the ``retry_attempts`` /
    ``retry_successes`` / ``retry_giveups`` counters.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    seed: int | None = None
    metrics: Any = None
    # Idempotent mode (README "Crash recovery & sessions"): the guarded
    # RPCs carry sequence numbers that make a duplicate delivery safe
    # (the peer answers a replay from its cache), so DEADLINE_EXCEEDED —
    # "the call may have executed" — becomes retryable too. Leave False
    # for RPCs without replay protection.
    idempotent: bool = False
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}"
            )

    def delays(self) -> Iterator[float]:
        """Infinite decorrelated-jitter delay sequence (fresh per call)."""
        rng = random.Random(self.seed) if self.seed is not None else random
        prev = self.base_delay_s
        while True:
            prev = min(
                self.max_delay_s, rng.uniform(self.base_delay_s, prev * 3)
            )
            yield prev

    def retryable(self, exc: BaseException) -> bool:
        """Transient errors always; a deadline expiry additionally when
        the policy guards idempotent (sequence-numbered) RPCs."""
        if is_transient(exc):
            return True
        return (
            self.idempotent
            and error_code(exc) is grpc.StatusCode.DEADLINE_EXCEEDED
        )

    def call(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        """Invoke ``fn``, retrying transient failures up to ``max_attempts``
        total attempts. Permanent errors and exhausted budgets re-raise the
        last exception."""
        reg = self.metrics.registry if self.metrics is not None else None
        delays = self.delays()
        for attempt in range(1, self.max_attempts + 1):
            try:
                result = fn(*args, **kwargs)
            except Exception as exc:
                if not self.retryable(exc) or attempt >= self.max_attempts:
                    if reg is not None and self.retryable(exc):
                        reg.counter("retry_giveups").inc()
                    # Flight-ring context (README "Incident forensics"):
                    # the JSONL stream only ever sees the aggregate
                    # retry counters — the per-call giveup/backoff
                    # decisions are exactly the lead-in a postmortem
                    # needs.
                    flightrec.note(
                        self.metrics, "retry_giveup", attempt=attempt,
                        retryable=self.retryable(exc), error=repr(exc),
                    )
                    raise
                if reg is not None:
                    reg.counter("retry_attempts").inc()
                delay = next(delays)
                flightrec.note(
                    self.metrics, "retry_backoff", attempt=attempt,
                    delay_s=delay, error=repr(exc),
                )
                self.sleep(delay)
            else:
                if attempt > 1 and reg is not None:
                    reg.counter("retry_successes").inc()
                    flightrec.note(
                        self.metrics, "retry_success", attempt=attempt,
                    )
                return result
        raise AssertionError("unreachable")  # pragma: no cover


# ---- deterministic fault injection ------------------------------------------

class InjectedRpcError(grpc.RpcError):
    """A synthetic RPC failure carrying a real ``grpc.StatusCode`` so the
    production classification (:func:`is_transient`) and telemetry paths
    treat it exactly like a wire error."""

    def __init__(self, code: grpc.StatusCode, detail: str):
        super().__init__(detail)
        self._code = code
        self._detail = detail

    def code(self) -> grpc.StatusCode:
        return self._code

    def details(self) -> str:
        return self._detail


#: FaultSpec kinds that act BEFORE the call (fail/slow the RPC itself) vs
#: AFTER it (mutate the reply payload in place). "partition" is a
#: before-kind with its own wall-clock-window lifecycle (see
#: FaultInjector.before_call).
_BEFORE_KINDS = frozenset({"error", "delay"})
_AFTER_KINDS = frozenset({"corrupt"})


@dataclass
class FaultSpec:
    """One scripted fault: fires on the next ``times`` matching calls.

    ``kind``: ``"error"`` raises ``code``; ``"drop"`` is shorthand for an
    ``UNAVAILABLE`` error (a dropped connection); ``"delay"`` sleeps
    ``delay_s`` then lets the call proceed; ``"corrupt"`` mutates the
    reply's tensor payload per ``payload`` — ``"nan"`` (every float value
    becomes NaN), ``"scale:<x>"`` (values multiplied by ``x``, e.g. an
    adversarially boosted update), or ``"random"`` (values replaced with
    seeded noise); ``"partition"`` blackholes the matched peer for a
    wall-clock window — EVERY matching call fails ``UNAVAILABLE`` for
    ``delay_s`` seconds from the first matching call (the window arms on
    first contact), the network-partition persona. ``peer=""`` matches
    any peer; ``method="*"`` matches any method (a partition severs the
    whole link, not one RPC). ``skip`` lets that many matching calls pass
    untouched before the fault arms (e.g. poison round 4, not round 0).
    ``probability < 1`` fires probabilistically from the injector's
    seeded RNG (still deterministic for a fixed seed and call order).
    """

    method: str
    kind: str = "error"
    code: grpc.StatusCode = grpc.StatusCode.UNAVAILABLE
    delay_s: float = 0.0
    times: int = 1
    peer: str = ""
    probability: float = 1.0
    payload: str = ""
    skip: int = 0

    def __post_init__(self):
        if self.kind not in ("error", "drop", "delay", "corrupt",
                             "partition"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.delay_s < 0:
            raise ValueError(
                f"delay_s must be >= 0, got {self.delay_s} (a negative "
                "delay cannot fire and would make the spec silently inert)"
            )
        if self.times < 1:
            raise ValueError(f"times must be >= 1, got {self.times}")
        if self.skip < 0:
            raise ValueError(f"skip must be >= 0, got {self.skip}")
        if not 0.0 < self.probability <= 1.0:
            raise ValueError(
                f"probability must be in (0, 1], got {self.probability}"
            )
        if self.kind == "drop":
            self.kind, self.code = "error", grpc.StatusCode.UNAVAILABLE
        if self.kind == "partition":
            if self.delay_s <= 0:
                raise ValueError(
                    "partition fault needs delay_s > 0 (the blackhole "
                    "window in seconds)"
                )
            # The window is wall-clock, not call-count: armed_at is set by
            # the first matching call.
            self.armed_at: float | None = None
        if self.kind == "corrupt":
            if not (
                self.payload in ("nan", "random")
                or self.payload.startswith("scale:")
            ):
                raise ValueError(
                    f"corrupt fault needs payload 'nan', 'scale:<x>' or "
                    f"'random', got {self.payload!r}"
                )
            if self.payload.startswith("scale:"):
                float(self.payload.split(":", 1)[1])  # validate eagerly


class FaultInjector:
    """Deterministic scripted per-call fault injection.

    Inject into a :class:`~gfedntm_tpu_torch.federation.rpc.ServiceStub`
    (``fault_injector=``) to fail outgoing calls before they reach the wire,
    or into :func:`~gfedntm_tpu_torch.federation.rpc.add_service` to fail incoming
    dispatches before the servicer method runs. Specs for the same method
    are consumed FIFO; each fired fault is appended to :attr:`fired` for
    test assertions. Thread-safe — the server polls clients from a pool.
    """

    def __init__(self, seed: int = 0, metrics: Any = None,
                 sleep: Callable[[float], None] = time.sleep):
        self._specs: list[FaultSpec] = []
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._sleep = sleep
        self.metrics = metrics
        self.fired: list[tuple[str, str, str]] = []  # (method, peer, kind)

    def script(self, method: str, kind: str = "error", *,
               code: grpc.StatusCode = grpc.StatusCode.UNAVAILABLE,
               delay_s: float = 0.0, times: int = 1, peer: str = "",
               probability: float = 1.0, payload: str = "",
               skip: int = 0) -> FaultSpec:
        """Queue a fault for the next ``times`` matching calls (after
        letting ``skip`` matching calls through untouched)."""
        spec = FaultSpec(
            method=method, kind=kind, code=code, delay_s=delay_s,
            times=times, peer=peer, probability=probability,
            payload=payload, skip=skip,
        )
        with self._lock:
            self._specs.append(spec)
        return spec

    def pending(self, method: str | None = None) -> int:
        """Remaining scripted firings (for a method, or in total)."""
        with self._lock:
            return sum(
                s.times for s in self._specs
                if method is None or s.method == method
            )

    def _consume(self, method: str, peer: str,
                 kinds: frozenset) -> FaultSpec | None:
        """Pop one firing from the FIFO-matched spec for this call (must be
        called under the lock). A spec still inside its ``skip`` window
        absorbs the call without firing."""
        spec = next(
            (
                s for s in self._specs
                if s.times > 0 and s.method in ("*", method)
                and s.peer in ("", peer) and s.kind in kinds
            ),
            None,
        )
        if spec is None:
            return None
        if spec.skip > 0:
            spec.skip -= 1
            return None
        if spec.probability < 1.0 and (
            self._rng.random() >= spec.probability
        ):
            return None
        spec.times -= 1
        if spec.times <= 0:
            self._specs.remove(spec)
        self.fired.append((method, peer, spec.kind))
        if self.metrics is not None:
            self.metrics.registry.counter("faults_injected").inc()
        flightrec.note(
            self.metrics, "fault_injected", method=method, peer=peer,
            fault=spec.kind,
        )
        return spec

    def _check_partition(self, method: str, peer: str) -> FaultSpec | None:
        """Partition lifecycle (must be called under the lock): the first
        matching call arms the wall-clock window; every matching call
        inside it is blackholed; the first matching call past it heals
        the link and retires the spec. Unlike count-based faults, a
        partition fails EVERY call in its window — retry storms included —
        which is exactly what a severed link does."""
        spec = next(
            (
                s for s in self._specs
                if s.kind == "partition" and s.method in ("*", method)
                and s.peer in ("", peer)
            ),
            None,
        )
        if spec is None:
            return None
        if spec.skip > 0:
            spec.skip -= 1
            return None
        now = time.monotonic()
        if spec.armed_at is None:
            spec.armed_at = now
            if self.metrics is not None:
                self.metrics.registry.counter("partitions_injected").inc()
                self.metrics.log(
                    "partition_injected", peer=peer, method=method,
                    window_s=spec.delay_s,
                )
        if now - spec.armed_at <= spec.delay_s:
            self.fired.append((method, peer, spec.kind))
            if self.metrics is not None:
                self.metrics.registry.counter("faults_injected").inc()
            return spec
        self._specs.remove(spec)  # window elapsed: the link heals
        return None

    def before_call(self, service: str, method: str, request: Any = None,
                    peer: str = "") -> None:
        """Consult the script for one call; raises/sleeps per the matched
        spec, or returns immediately when nothing matches."""
        with self._lock:
            spec = self._check_partition(method, peer)
            if spec is not None:
                raise InjectedRpcError(
                    grpc.StatusCode.UNAVAILABLE,
                    f"injected partition for {service}/{method} "
                    f"(peer={peer!r}, window={spec.delay_s:g}s)",
                )
            spec = self._consume(method, peer, _BEFORE_KINDS)
        if spec is None:
            return
        # Act OUTSIDE the lock: a scripted delay must not serialize every
        # other injected call behind it.
        if spec.kind == "delay":
            self._sleep(spec.delay_s)
            return
        raise InjectedRpcError(
            spec.code,
            f"injected {spec.kind} for {service}/{method} (peer={peer!r})",
        )

    def after_call(self, service: str, method: str, response: Any = None,
                   peer: str = "") -> Any:
        """Consult the script AFTER a successful call: a matched ``corrupt``
        spec mutates the response's tensor bundle in place (the caller sees
        a reply whose payload the remote peer "emitted" corrupted — NaN
        tensors, adversarially scaled updates, random garbage). Returns the
        (possibly mutated) response."""
        with self._lock:
            spec = self._consume(method, peer, _AFTER_KINDS)
        if spec is None or response is None:
            return response
        bundle = getattr(response, "shared", None)
        if bundle is not None and getattr(bundle, "tensors", None):
            corrupt_bundle(
                bundle, spec.payload,
                seed=self._rng.randrange(2**32),
            )
        return response


# ---- fail-fast fault-spec validation ----------------------------------------
#
# A typo'd --chaos spec (unknown method name, unknown field) used to parse
# into an inert injector that silently never fired — the worst failure
# mode for a chaos harness, because "the fault never happened" reads as
# "the system survived it". The CLI --chaos flag and the scenario
# engine's persona loader both parse through here, so malformed specs
# fail loudly at startup instead.

#: FaultSpec fields settable from a JSON spec (anything else is a typo).
_SPEC_FIELDS = frozenset({
    "method", "kind", "code", "delay_s", "times", "peer", "probability",
    "payload", "skip",
})


def known_fault_methods() -> frozenset[str]:
    """Every RPC method name a fault spec can legally target: the union
    of all services in :data:`gfedntm_tpu_torch.federation.rpc.SERVICES`, plus
    the ``"*"`` wildcard."""
    from gfedntm_tpu_torch.federation import rpc

    methods = {m for spec in rpc.SERVICES.values() for m in spec}
    methods.add("*")
    return frozenset(methods)


def validate_fault_spec(spec: dict) -> dict:
    """Validate one JSON fault spec eagerly; returns a normalized copy
    (``code`` strings resolved to ``grpc.StatusCode``) or raises
    ``ValueError`` naming the problem. Checks the spec SHAPE — unknown
    keys, missing/unknown ``method``, unknown ``kind``, bad ``code``
    names — before :class:`FaultSpec` validates the values (negative
    delays, zero times, out-of-range probability)."""
    if not isinstance(spec, dict):
        raise ValueError(
            f"fault spec must be a JSON object, got {type(spec).__name__}"
        )
    unknown = set(spec) - _SPEC_FIELDS
    if unknown:
        raise ValueError(
            f"unknown fault-spec field(s) {sorted(unknown)} "
            f"(known: {sorted(_SPEC_FIELDS)})"
        )
    out = dict(spec)
    method = out.get("method")
    if not isinstance(method, str) or not method:
        raise ValueError("fault spec needs a 'method' name (or '*')")
    known = known_fault_methods()
    if method not in known:
        raise ValueError(
            f"unknown RPC method {method!r} — the spec would never fire "
            f"(known: {sorted(known)})"
        )
    code = out.get("code")
    if isinstance(code, str):
        resolved = getattr(grpc.StatusCode, code, None)
        if not isinstance(resolved, grpc.StatusCode):
            raise ValueError(f"unknown grpc.StatusCode name {code!r}")
        out["code"] = resolved
    elif code is not None and not isinstance(code, grpc.StatusCode):
        raise ValueError(
            f"'code' must be a grpc.StatusCode name string, got {code!r}"
        )
    # Value-domain validation: construct a throwaway FaultSpec so kind/
    # delay/times/probability/payload problems surface here, not at the
    # first (never-arriving) matching call. TypeError covers wrong-TYPED
    # values (e.g. "delay_s": "0.5" — a JSON string where a number is
    # expected fails the >= comparison), which must surface as the same
    # usage error, not a raw traceback.
    try:
        FaultSpec(**out)
    except TypeError as err:
        raise ValueError(f"bad fault-spec value: {err}")
    return out


def build_fault_injector(
    specs: "str | list[dict]",
    seed: int = 0,
    metrics: Any = None,
    sleep: Callable[[float], None] = time.sleep,
) -> FaultInjector:
    """Parse a ``--chaos``-style JSON list (or an already-decoded list)
    into a scripted :class:`FaultInjector`, validating every spec
    eagerly (:func:`validate_fault_spec`). Raises ``ValueError`` with a
    usage-quality message on any malformed spec."""
    import json

    if isinstance(specs, str):
        try:
            specs = json.loads(specs)
        except json.JSONDecodeError as err:
            raise ValueError(f"fault specs are not valid JSON: {err}")
    if not isinstance(specs, list):
        raise ValueError(
            f"fault specs must be a JSON list of objects, got "
            f"{type(specs).__name__}"
        )
    injector = FaultInjector(seed=seed, metrics=metrics, sleep=sleep)
    for i, raw in enumerate(specs):
        try:
            spec = validate_fault_spec(raw)
        except ValueError as err:
            raise ValueError(f"fault spec #{i}: {err}")
        injector.script(spec.pop("method"), **spec)
    return injector


def corrupt_bundle(bundle: Any, payload: str, seed: int = 0) -> None:
    """Corrupt every float tensor record of a ``TensorBundle`` in place.

    Operates on the WIRE values buffer (whatever dtype/codec the record
    ships — raw, dense-quantized, or top-k sparse), so it composes with any
    negotiated compression: the decoder sees exactly what a byzantine peer
    would have sent. ``payload`` is ``"nan"`` (all values → NaN),
    ``"scale:<x>"`` (values × x) or ``"random"`` (values ← seeded
    N(0, 10) noise)."""
    import numpy as np

    from gfedntm_tpu_torch.federation import codec as _codec

    rng = np.random.default_rng(seed)
    for rec in bundle.tensors:
        wire_name = rec.wire_dtype or rec.dtype
        try:
            wire_dtype = _codec.np_dtype(wire_name)
        except Exception:
            continue
        if np.dtype(wire_dtype).kind != "f":
            continue
        arr = np.frombuffer(rec.data, dtype=wire_dtype).copy()
        if arr.size == 0:
            continue
        if payload == "nan":
            arr[:] = np.nan
        elif payload.startswith("scale:"):
            arr *= np.asarray(
                float(payload.split(":", 1)[1]), dtype=arr.dtype
            )
        else:  # "random"
            arr[:] = rng.normal(0.0, 10.0, arr.size).astype(arr.dtype)
        rec.data = arr.tobytes()
