"""Structured telemetry of a training run: events, metrics, phases.

Copied from ``gfedntm_tpu/utils/observability.py`` (standard library only),
the part :class:`~gfedntm_tpu_torch.federated.trainer.FederatedTrainer`
uses, so the port's records are the same JSON the JAX package's
``validate_record`` accepts and its ``summarize_metrics`` reads:

- :data:`EVENT_SCHEMAS` and :func:`validate_record` (:76-256), the schema
  lint of the event stream;
- :class:`Counter`, :class:`Gauge`, :class:`Histogram` and
  :class:`MetricRegistry` (:257-442);
- :class:`MetricsLogger` (:445-566): thread-safe JSONL, flushed eagerly,
  ``keep_records``, ``node``, ``events``, ``snapshot_registry``, the
  flight-recorder tap (``recorder``), ``sync`` and the ambient ``trace_id``;
- :func:`phase_timer` (:894-906) and :func:`read_metrics` (:1473);
- what the federation's wire uses: ``DEFAULT_BYTE_BUCKETS`` (:266), the
  spans (:562-664), the trace context carried in gRPC metadata
  (:667-671, :800-861), the telemetry reports a client piggybacks on its
  replies (``encode_telemetry_report``,
  ``TelemetryShipper``, :1148-1229) and the ``StragglerDetector`` behind
  the server's adaptive poll deadline (:2456-2548).

- the fleet telemetry plane and the ops endpoint: the exact snapshot
  merges (``merge_metric_snapshots``, ``merge_node_snapshots``, :1076-1146),
  ``decode_telemetry_report`` (:1160), :class:`FleetRegistry` (:1232) and
  ``render_fleet_prometheus`` (:1354), ``sample_process_metrics`` (:1435),
  the run summaries of the quality and privacy planes
  (``summarize_model_quality``, ``summarize_privacy``, with
  ``collect_data_plane``; :1507, :1931, :2138), ``render_prometheus``
  (:2202) and :class:`OpsServer` (:2284);
- the round profiler window: ``parse_round_window`` (a copy, :921) and
  :class:`RoundProfiler` (:942), rewritten over ``torch.profiler``; and
  :func:`trace` (:909), the whole-block capture ``simulate`` wraps its
  fit in, rewritten over ``torch.profiler`` too;
- what the command line's readers render: ``summarize_metrics`` (:1612)
  and ``format_report`` (:1766) with ``_agg``, ``_fmt_s`` and
  ``_fmt_bytes``; ``collect_wire_tiers`` and ``format_wire_tiers``
  (:1542-1610); ``check_monotone_coherence``, ``format_quality_report``
  and ``_fmt_opt`` (:2002-2136); ``format_privacy_line`` (:2169); and the
  trace merge, ``merge_chrome_trace`` (:2628) with
  ``estimate_clock_offset`` and ``_serve_offset_samples`` (:2589-2626).

The JAX module imports ``jax`` inside a few functions (the profiler window,
the device-memory gauge), so it is copied by function, not by file;
``tests/test_torch_ops_plane.py`` and ``tests/test_torch_cli.py`` pin each
copied function's source to the original's. ``DeviceMemoryMonitor`` and
``timed_jit`` are XLA's and have no counterpart here.
"""

from __future__ import annotations

import bisect
import contextlib
import contextvars
import heapq
import inspect
import itertools
import json
import os
import re
import threading
import time
import zlib
from typing import Any, Iterator

# ---- event schema -----------------------------------------------------------

#: Required fields per event name, beyond the implicit ``event`` + ``time``.
#: Extra fields are always allowed; MISSING required fields (or an event name
#: absent from this table, under strict validation) are schema drift.
EVENT_SCHEMAS: dict[str, frozenset[str]] = {
    # timing
    "phase": frozenset({"phase", "seconds"}),
    "span": frozenset({"name", "span_id", "parent_id", "seconds"}),
    "jit_compile": frozenset({"what", "seconds"}),
    # registry state
    "metrics_snapshot": frozenset({"metrics"}),
    # RPC failures (successes aggregate into registry histograms only)
    "rpc": frozenset({"service", "method", "seconds", "ok"}),
    # resilience lifecycle (federation probation / quorum / checkpoint /
    # client watchdog; see README "Fault tolerance")
    "client_suspect": frozenset({"client", "failures", "status"}),
    "client_recovered": frozenset({"client"}),
    "quorum_skip": frozenset({"round", "got", "needed"}),
    "checkpoint": frozenset({"round"}),
    "watchdog_fired": frozenset({"client", "idle_s"}),
    # crash-survival plane (durable sessions / idempotent RPCs / server
    # auto-recovery / partition chaos; README "Crash recovery & sessions")
    "client_reconnected": frozenset({"client", "attempts"}),
    "session_restored": frozenset({"client"}),
    "rpc_deduplicated": frozenset({"client", "method"}),
    "server_recovered": frozenset({"round", "source"}),
    "partition_injected": frozenset({"peer", "window_s"}),
    # survivable hierarchy (relay crash recovery / member re-homing /
    # journal degradation; README "Crash recovery & sessions"): a
    # respawned relay that restored its shard from its own journal, a
    # member adopted by a new tier after its relay never came back (the
    # adoptive tier logs this LOUDLY — an unknown-but-valid-format token
    # is evidence of a cross-tier failover, not a fresh fleet member),
    # and a journal write that failed (ENOSPC/EIO) — training continues
    # but autorecovery is disabled for the rest of the run.
    "relay_recovered": frozenset({"relay", "round", "members"}),
    "member_rehomed": frozenset({"client"}),
    "journal_write_failed": frozenset({"round", "error"}),
    # data-plane defense (update admission gate / divergence guardian;
    # see README "Robust aggregation & divergence recovery")
    "update_rejected": frozenset({"client", "round", "reason"}),
    "update_clipped": frozenset({"client", "round", "norm", "max_norm"}),
    "divergence_rollback": frozenset({"round", "reason"}),
    "client_quarantined": frozenset({"client", "round"}),
    "checkpoint_invalid": frozenset({"reason"}),
    # wire codec negotiation + delta-reference discipline (federation
    # compression subsystem; see README "Aggregation strategies & wire
    # compression")
    "codec_negotiated": frozenset({"client", "codec"}),
    "codec_mismatch": frozenset({"client", "server_codec", "client_codec"}),
    "codec_ref_miss": frozenset({"client", "ref_round"}),
    # bounded reference caches + wire-efficient scale-out (per-recipient
    # delta encoding, push pacing, relay tier; README "Hierarchical
    # federation & wire efficiency")
    "codec_ref_evicted": frozenset({"direction", "round", "age"}),
    "push_aggregated": frozenset({"round", "buffered", "admitted"}),
    "relay_joined": frozenset({"relay", "members", "weight"}),
    "relay_preaggregated": frozenset({"relay", "round", "members",
                                      "admitted"}),
    # cross-process observability plane (README "Distributed tracing & ops
    # endpoint"): trace identity, live ops endpoint, device profiler window,
    # straggler analytics
    # federation pacing (cohort sampling / buffered async; README
    # "Federation pacing")
    "cohort_sampled": frozenset({"round", "k", "eligible", "q"}),
    "async_aggregated": frozenset({"round", "buffered", "admitted"}),
    "update_stale_discounted": frozenset(
        {"client", "round", "staleness", "factor"}
    ),
    "trace_started": frozenset({"trace_id"}),
    "ops_server_started": frozenset({"port"}),
    "profiler_started": frozenset({"dir", "round"}),
    "profiler_stopped": frozenset({"round"}),
    "straggler_detected": frozenset({"client", "round", "z"}),
    # model-quality plane (topic coherence / diversity / drift telemetry;
    # README "Model-quality observability")
    "quality_computed": frozenset({"round", "npmi", "diversity"}),
    "topic_drift": frozenset({"round", "mean_drift", "churn"}),
    # training progress
    "resume": frozenset({"step"}),
    "epoch": frozenset({"epoch"}),
    "federated_segment": frozenset({"step", "mean_loss"}),
    "federated_iteration": frozenset({"iteration", "mean_loss"}),
    "summary": frozenset(),
    # bench stream (bench.py emits through the same logger/schema)
    "bench_summary": frozenset({"backend"}),
    "bench_result": frozenset({"metric", "value", "unit", "backend"}),
    # staged bench sub-phases (bench.py run-phase staging: a stage record
    # lands in the stream the moment the stage completes, so a later hang
    # cannot erase it; README "Multi-chip training & bench interpretation")
    "bench_stage": frozenset({"stage", "seconds"}),
    # multi-chip data-sharded local training (parallel.sharded
    # .fit_data_sharded / the mesh-enabled federation client)
    "sharded_fit": frozenset({"devices", "docs_per_s"}),
    # serving plane (hot-swappable doc->topic inference; README "Serving"):
    # model lifecycle + request-path failures. Per-request successes stay
    # out of the JSONL stream (they aggregate into the serve_latency_s
    # histogram and the serving_* counters, surfaced via
    # metrics_snapshot) — at production QPS one event per request would
    # dwarf every other stream combined.
    "serve_model_loaded": frozenset({"round", "source"}),
    "serve_model_swapped": frozenset({"round", "prev_round"}),
    "serve_swap_refused": frozenset({"round", "reason"}),
    "serve_error": frozenset({"reason"}),
    # closed-loop load generator summary (scripts/serve_bench.py + the
    # serving e2e tests): one record per measured window, the JSONL
    # ground truth BENCH_SERVE artifacts are reproduced from.
    "serve_load_window": frozenset(
        {"seconds", "docs", "requests", "failures", "docs_per_s"}
    ),
    # serving-plane load shedding (README "Serving"): a full pending
    # queue sheds the ARRIVING request alone (RESOURCE_EXHAUSTED / 429);
    # queued and accepted requests are never dropped.
    "serve_shed": frozenset({"docs", "queued"}),
    # scenario matrix engine (README "Scenario matrix"): cell lifecycle
    # + per-cell degradation-contract verdicts — the ground truth the
    # BENCH_SCENARIO artifact and the SCENARIO=1 smoke stage key on.
    "scenario_cell_started": frozenset({"cell", "workload", "pacing"}),
    "scenario_contract": frozenset({"cell", "contract", "ok"}),
    "scenario_cell_finished": frozenset({"cell", "ok", "seconds"}),
    # fleet telemetry plane + SLO/alerting engine (README "Fleet telemetry
    # & SLOs"): alert lifecycle transitions from the pending→firing→
    # resolved state machine, plus the FleetRegistry cardinality guard's
    # report-withholding record (a report over the node/series cap is
    # dropped observably, never silently).
    "alert_pending": frozenset({"alert", "metric", "threshold"}),
    "alert_firing": frozenset({"alert", "metric", "threshold"}),
    "alert_resolved": frozenset({"alert"}),
    "fleet_overflow": frozenset({"node", "reason"}),
    # privacy plane (README "Differential privacy & posterior sampling"):
    # one dp_noise_applied per mechanism application (server FedLD /
    # client DP-SGD), one privacy_budget ledger row per aggregated round
    # (the accountant's running (eps, delta) — what the `privacy` CLI
    # gate replays), and a once-per-transition budget-exceeded marker.
    "dp_noise_applied": frozenset({"mode", "index", "std", "n", "dim"}),
    "privacy_budget": frozenset(
        {"round", "eps", "delta", "steps", "q", "sigma", "mode", "budget"}
    ),
    "privacy_budget_exceeded": frozenset(
        {"round", "eps", "budget", "delta"}
    ),
    # incident-forensics plane (README "Incident forensics"): one
    # incident_captured per atomic bundle a node's IncidentTrigger
    # writes, one flightrec_requested when the root solicits remote
    # flight-record snapshots from implicated nodes, and one
    # flightrec_received per remote node bundle that lands in the
    # root's incident dir off a piggybacked RPC reply.
    "incident_captured": frozenset(
        {"reason", "incident_id", "records", "path"}
    ),
    "flightrec_requested": frozenset({"incident_id", "reason"}),
    "flightrec_received": frozenset({"incident_id"}),
}


def validate_record(record: Any, strict: bool = True) -> dict[str, Any]:
    """Schema-lint one event record; returns it unchanged or raises
    ``ValueError``. ``strict=False`` lets unknown event names pass (their
    ``event``/``time`` envelope is still checked)."""
    if not isinstance(record, dict):
        raise ValueError(f"record must be a dict, got {type(record).__name__}")
    event = record.get("event")
    if not isinstance(event, str) or not event:
        raise ValueError(f"record needs a non-empty 'event' str: {record!r}")
    if not isinstance(record.get("time"), (int, float)):
        raise ValueError(f"record {event!r} needs a numeric 'time' field")
    required = EVENT_SCHEMAS.get(event)
    if required is None:
        if strict:
            raise ValueError(
                f"unknown event {event!r}: register it in "
                "observability.EVENT_SCHEMAS (and README 'Telemetry')"
            )
        return record
    missing = required - record.keys()
    if missing:
        raise ValueError(
            f"event {event!r} missing required fields {sorted(missing)}"
        )
    return record


# ---- metric registry --------------------------------------------------------

#: Exponential-ish latency edges, 100 µs .. 5 min (upper-inclusive buckets).
DEFAULT_TIME_BUCKETS_S: tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

#: Payload-size edges, 256 B .. 256 MB (the gRPC message cap).
DEFAULT_BYTE_BUCKETS: tuple[float, ...] = tuple(
    256.0 * 4.0 ** i for i in range(11)
)


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def snapshot(self) -> dict[str, Any]:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-value-wins gauge."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value: float | None = None
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def snapshot(self) -> dict[str, Any]:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram with upper-inclusive edges.

    ``counts[i]`` counts observations ``v <= edges[i]`` (first matching
    bucket); ``counts[-1]`` is the overflow bucket. Percentiles are
    estimated by linear interpolation inside the selected bucket, clamped
    to the observed [min, max] — exact at the tracked extremes, bucket-
    resolution elsewhere.
    """

    __slots__ = ("name", "edges", "counts", "count", "sum", "min", "max",
                 "_lock")

    def __init__(self, name: str, buckets: tuple[float, ...] | None = None):
        self.name = name
        self.edges = tuple(sorted(buckets or DEFAULT_TIME_BUCKETS_S))
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.edges, v)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            if not self.count:
                return {
                    "type": "histogram", "count": 0, "sum": 0.0,
                    "edges": list(self.edges), "counts": list(self.counts),
                }
            return {
                "type": "histogram",
                "count": self.count,
                "sum": self.sum,
                "min": self.min,
                "max": self.max,
                "edges": list(self.edges),
                "counts": list(self.counts),
            }

    def quantile(self, q: float) -> float | None:
        return quantile_from_snapshot(self.snapshot(), q)


def quantile_from_snapshot(snap: dict[str, Any], q: float) -> float | None:
    """Estimate the ``q``-quantile (0..1) from a histogram snapshot dict
    (the serialized form inside ``metrics_snapshot`` events)."""
    n = snap.get("count", 0)
    if not n:
        return None
    edges, counts = snap["edges"], snap["counts"]
    lo_all, hi_all = snap["min"], snap["max"]
    target = max(q, 0.0) * n
    cum = 0.0
    for i, c in enumerate(counts):
        if c and cum + c >= target:
            lo = lo_all if i == 0 else edges[i - 1]
            hi = edges[i] if i < len(edges) else hi_all
            lo = min(max(lo, lo_all), hi_all)
            hi = max(min(hi, hi_all), lo)
            frac = (target - cum) / c
            return lo + frac * (hi - lo)
        cum += c
    return hi_all


class MetricRegistry:
    """Get-or-create store of named counters/gauges/histograms; thread-safe.

    The first creation fixes a histogram's buckets; later ``histogram``
    calls for the same name return the existing instance (their ``buckets``
    argument is ignored).
    """

    def __init__(self):
        self._metrics: dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(
        self, name: str, buckets: tuple[float, ...] | None = None
    ) -> Histogram:
        return self._get(name, Histogram, buckets)

    def get(self, name: str):
        """Read-only lookup: the metric, or None — unlike the typed
        accessors this never creates (the ops endpoint's /status must not
        mint empty gauges just by being curled)."""
        with self._lock:
            return self._metrics.get(name)

    def drop(self, name: str) -> bool:
        """Remove a metric from the registry (idempotent; returns whether
        it existed). The eviction path of per-client series: detectors
        tracking a churning client population must drop a departed
        client's gauges, or the registry (and every later snapshot /
        Prometheus scrape) grows one series per client that ever lived."""
        with self._lock:
            return self._metrics.pop(name, None) is not None

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            metrics = list(self._metrics.items())
        return {name: m.snapshot() for name, m in sorted(metrics)}

# ---- structured event log ---------------------------------------------------

class MetricsLogger:
    """Append-only structured metrics. ``path=None`` keeps records in memory
    only (tests); otherwise each event is one JSON line, flushed eagerly so
    a crashed run keeps its telemetry.

    Thread-safe: one logger may be driven from many threads, and
    interleaved JSONL lines would corrupt the stream. ``validate=True``
    schema-lints every record at log time (tests; see
    :func:`validate_record`).

    ``node`` names this process ("server", "client3"); it is stamped on
    every record so per-node streams merge without guessing from filenames.
    ``trace_id`` is the process's ambient trace identity (see :class:`Span`);
    the federation server mints one per training run.
    """

    def __init__(self, path: str | None = None, validate: bool = False,
                 mode: str = "a", keep_records: bool | None = None,
                 node: str | None = None, trace_id: str | None = None):
        self.path = path
        self.validate = validate
        self.node = node
        # The process's ambient trace identity: spans inherit it and
        # outbound RPCs advertise it (ambient_trace_pairs).
        self.trace_id = trace_id
        # Flight-recorder tap (utils/flightrec.py): when a FlightRecorder is
        # attached, every record is also ringed and checked against the
        # incident trigger. None costs one attribute load per log().
        self.recorder = None
        # In-memory retention is for in-process consumers (.events(), tests).
        # Default: retain only when there is no file.
        self.keep_records = (
            path is None if keep_records is None else bool(keep_records)
        )
        self.records: list[dict[str, Any]] = []
        self.registry = MetricRegistry()
        self._lock = threading.Lock()
        self._fh = None
        if path is not None:
            if mode not in ("a", "w"):
                raise ValueError(f"mode must be 'a' or 'w', got {mode!r}")
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, mode)

    def log(self, event: str, **fields: Any) -> dict[str, Any]:
        record = {"event": event, "time": time.time(), **fields}
        if self.node is not None:
            record.setdefault("node", self.node)
        if self.validate:
            validate_record(record)
        # Serialize outside the lock; append + write inside it so lines
        # never interleave and records keeps file order.
        line = (
            json.dumps(record, default=float) if self.path is not None
            else None
        )
        with self._lock:
            if self.keep_records:
                self.records.append(record)
            if self._fh is not None and line is not None:
                self._fh.write(line + "\n")
                self._fh.flush()
        # Outside the lock: a capture the recorder triggers logs back
        # through this method.
        recorder = self.recorder
        if recorder is not None:
            recorder.observe(record)
        return record

    def sync(self) -> None:
        """Flush and fsync the JSONL stream (the incident dump path)."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                os.fsync(self._fh.fileno())

    def events(self, event: str) -> list[dict[str, Any]]:
        if not self.keep_records:
            raise RuntimeError(
                "events() needs in-memory retention: construct with "
                "keep_records=True (or path=None), or read the JSONL file "
                "via read_metrics()"
            )
        return [r for r in self.records if r["event"] == event]

    def snapshot_registry(self, **fields: Any) -> dict[str, Any] | None:
        """Dump the registry's cumulative state into the event stream."""
        snap = self.registry.snapshot()
        if not snap:
            return None
        return self.log("metrics_snapshot", metrics=snap, **fields)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---- phase timing -------------------------------------------------------------

@contextlib.contextmanager
def phase_timer(
    logger: MetricsLogger | None, phase: str, **fields: Any
) -> Iterator[None]:
    """Time a named phase; logs ``{"event": "phase", "phase": ..., "seconds": ...}``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - t0
        if logger is not None:
            logger.log("phase", phase=phase, seconds=elapsed, **fields)


@contextlib.contextmanager
def trace(log_dir: str | None, device=None) -> Iterator[None]:
    """A ``torch.profiler`` capture of the block, written as one Chrome
    trace (``trace.<pid>.pt.trace.json``) into ``log_dir``: CPU activity,
    and CUDA activity when ``device`` is a CUDA device. A no-op when
    ``log_dir`` is ``None``, so call sites need no branching (the JAX
    ``trace``, :909, is a ``jax.profiler.trace`` context)."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = str(device or "").startswith("cuda")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace.{os.getpid()}.pt.trace.json")
    )


# ---- hierarchical spans (observability.py:562-664) ---------------------------

_SPAN_IDS = itertools.count(1)
_CURRENT_SPAN: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "gfedntm_torch_current_span", default=None
)


class Span:
    """One timed region of a run. Logs a ``span`` event on exit with its
    monotonic duration, id, parent id, and any annotated attributes.

    Within a thread, nesting is implicit (contextvars). Work handed to a
    pool thread does NOT inherit the submitting thread's context — pass the
    enclosing span explicitly: ``span(logger, "poll", parent=round_span)``.

    A ``trace_id`` field is inherited from the parent span (explicit or
    ambient), falling back to the logger's ``trace_id``; the emitting
    thread id is recorded too (``thread``).
    """

    __slots__ = ("logger", "name", "fields", "span_id", "parent_id",
                 "_parent", "_token", "_t0")

    def __init__(self, logger: MetricsLogger, name: str, parent: Any,
                 fields: dict[str, Any]):
        self.logger = logger
        self.name = name
        self.fields = dict(fields)
        self.span_id = next(_SPAN_IDS)
        self.parent_id: int | None = None
        self._parent = parent
        self._token = None
        self._t0 = 0.0

    def annotate(self, **fields: Any) -> "Span":
        """Attach attributes that become fields of the logged span event."""
        self.fields.update(fields)
        return self

    def __enter__(self) -> "Span":
        cur = self._parent if self._parent is not None else _CURRENT_SPAN.get()
        if cur is not None:
            self.parent_id = getattr(cur, "span_id", cur)
        if self.fields.get("trace_id") is None:
            inherited = getattr(cur, "fields", {}).get("trace_id") if (
                cur is not None
            ) else None
            if inherited is None:
                inherited = getattr(self.logger, "trace_id", None)
            if inherited is not None:
                self.fields["trace_id"] = inherited
        self._token = _CURRENT_SPAN.set(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        seconds = time.perf_counter() - self._t0
        _CURRENT_SPAN.reset(self._token)
        self.logger.log(
            "span", name=self.name, span_id=self.span_id,
            parent_id=self.parent_id, seconds=seconds,
            ok=exc_type is None, thread=threading.get_ident(),
            **self.fields,
        )


class _NullSpan:
    """No-op span returned for ``logger=None`` call sites (zero overhead)."""

    __slots__ = ()
    span_id = None
    parent_id = None

    def annotate(self, **fields: Any) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


def span(logger: MetricsLogger | None, name: str, parent: Any = None,
         **fields: Any):
    """Hierarchical timing context; a no-op when ``logger`` is None."""
    if logger is None:
        return _NULL_SPAN
    return Span(logger, name, parent, fields)


def current_span() -> Span | None:
    """The thread's innermost open span, if any (contextvar-scoped)."""
    return _CURRENT_SPAN.get()


# ---- trace-context propagation in gRPC metadata (:667-671, :800-861) --------

TRACE_ID_KEY = "x-gfedntm-trace-id"
PARENT_SPAN_KEY = "x-gfedntm-parent-span"
ROUND_KEY = "x-gfedntm-round"
SEND_TIME_KEY = "x-gfedntm-send-time"
NODE_KEY = "x-gfedntm-node"


# ---- the telemetry contract (:685-805): span names and the required-event
# groups graftlint's GL001 reverse-lints over the port ----------------------

#: Span names the trace plane is built on: ``round`` (the server's per-round
#: root, used to pick the merge reference node) and ``serve`` (the servicer-
#: side child every instrumented RPC dispatch logs, carrying the extracted
#: trace context + the paired send/recv clock stamps). graftlint's
#: telemetry-contract rule (GL001) verifies every name still exists as a
#: span() call site. ``relay_fanout``/``relay_push`` time the relay tier's downstream
#: fan-out + pre-reduce and its aggregate re-broadcast; ``infer``,
#: ``serve_batch``, and ``serve_swap`` time the serving path (Infer RPC
#: dispatch, batcher micro-batch drain, hot-swap install) — without
#: them hierarchical and serving incidents merged into timelines with
#: no tier-local spans (README "Incident forensics").
TRACE_PLANE_SPANS: tuple[str, ...] = (
    "round", "serve", "relay_fanout", "relay_push", "infer",
    "serve_batch", "serve_swap",
)

#: Data-plane defense events (update admission gate, divergence guardian,
#: checkpoint integrity — README "Robust aggregation & divergence
#: recovery"). graftlint's telemetry-contract rule verifies each still
#: has an emission call site: the defense must never be silently
#: disconnected from telemetry.
DATA_PLANE_EVENTS: tuple[str, ...] = (
    "update_rejected",
    "update_clipped",
    "divergence_rollback",
    "client_quarantined",
    "checkpoint_invalid",
)

#: Model-quality plane events (topic coherence / drift telemetry — README
#: "Model-quality observability"). Same reverse-lint contract as the
#: data-plane events: graftlint's telemetry-contract rule verifies each
#: keeps an emission call site, so the quality monitor can never be silently disconnected
#: from the stream the `report` CLI reconstructs trajectories from.
MODEL_QUALITY_EVENTS: tuple[str, ...] = (
    "quality_computed",
    "topic_drift",
)

#: Wire-efficient scale-out events (bounded reference-cache evictions,
#: push-paced aggregations, the relay tier — README "Hierarchical
#: federation & wire efficiency"). Same reverse-lint contract: graftlint
#: verifies each keeps an emission call site, so the scale plane's
#: telemetry (which BENCH_SCALE reproducibility depends on) can never be
#: silently disconnected.
SCALEOUT_EVENTS: tuple[str, ...] = (
    "codec_ref_evicted",
    "push_aggregated",
    "relay_joined",
    "relay_preaggregated",
)

#: Serving-plane events (model load / hot-swap / quality-gated refusal /
#: request-path errors — README "Serving"). Same reverse-lint contract:
#: graftlint verifies each keeps an emission call site, so a refactor can
#: never silently disconnect the swap audit trail BENCH_SERVE
#: reproducibility (and the zero-dropped-requests claim) depends on.
SERVING_EVENTS: tuple[str, ...] = (
    "serve_model_loaded",
    "serve_model_swapped",
    "serve_swap_refused",
    "serve_error",
    "serve_load_window",
    "serve_shed",
)

#: Scenario-matrix events (cell lifecycle + per-cell degradation-
#: contract verdicts — README "Scenario matrix"). Same reverse-lint
#: contract: graftlint verifies each keeps an emission call site, so the
#: scenario engine can never silently stop recording the contract
#: verdicts BENCH_SCENARIO reproducibility depends on.
SCENARIO_EVENTS: tuple[str, ...] = (
    "scenario_cell_started",
    "scenario_contract",
    "scenario_cell_finished",
)

#: Fleet-telemetry / SLO plane events (alert state-machine transitions +
#: the FleetRegistry cardinality guard — README "Fleet telemetry & SLOs").
#: Same reverse-lint contract: graftlint verifies each keeps an emission
#: call site, so the alerting plane (which the `slo` CI gate and the
#: /alerts endpoint both key on) can never be silently disconnected.
FLEET_EVENTS: tuple[str, ...] = (
    "alert_pending",
    "alert_firing",
    "alert_resolved",
    "fleet_overflow",
)

#: Survivable-hierarchy events (relay crash autorecovery, cross-tier
#: member re-homing, journal-write degradation — README "Crash recovery
#: & sessions"). Same reverse-lint contract: graftlint verifies each
#: keeps an emission call site, so the hierarchy's crash-recovery audit
#: trail (which the chaos suite and the relay-crash scenario cells
#: assert against) can never be silently disconnected.
SURVIVAL_EVENTS: tuple[str, ...] = (
    "server_recovered",
    "relay_recovered",
    "member_rehomed",
    "journal_write_failed",
)

#: Privacy-plane events (DP mechanism applications + the accountant's
#: per-round (eps, delta) ledger — README "Differential privacy &
#: posterior sampling"). Same reverse-lint contract: graftlint verifies
#: each keeps an emission call site, so the privacy ledger (which the
#: `privacy` CI gate replays and the budget_monotone scenario contract
#: asserts against) can never be silently disconnected.
PRIVACY_EVENTS: tuple[str, ...] = (
    "dp_noise_applied",
    "privacy_budget",
    "privacy_budget_exceeded",
)

#: Incident-forensics events (flight-recorder bundles + server-
#: solicited remote capture — README "Incident forensics"). Same
#: reverse-lint contract: graftlint verifies each keeps an emission
#: call site, so the postmortem plane (which the `incident` CLI gate
#: replays bundles against) can never be silently disconnected.
INCIDENT_EVENTS: tuple[str, ...] = (
    "incident_captured",
    "flightrec_requested",
    "flightrec_received",
)


def new_trace_id() -> str:
    """A fresh 16-hex-char trace id (one federation training run)."""
    import uuid

    return uuid.uuid4().hex[:16]


def trace_pairs(trace_id: str | None = None, parent_span: int | None = None,
                round_idx: int | None = None) -> list[tuple[str, str]]:
    """Explicit outbound trace metadata — the server's poll/push workers
    use this (pool threads do not inherit the round span's contextvars)."""
    pairs: list[tuple[str, str]] = []
    if trace_id:
        pairs.append((TRACE_ID_KEY, str(trace_id)))
    if parent_span is not None:
        pairs.append((PARENT_SPAN_KEY, str(parent_span)))
    if round_idx is not None:
        pairs.append((ROUND_KEY, str(round_idx)))
    return pairs


def ambient_trace_pairs(logger: MetricsLogger | None) -> list[tuple[str, str]]:
    """Outbound trace metadata from the calling thread's ambient context:
    the innermost open span (id + inherited trace id), falling back to the
    logger's process-level ``trace_id``."""
    cur = _CURRENT_SPAN.get()
    trace_id = cur.fields.get("trace_id") if cur is not None else None
    if trace_id is None:
        trace_id = getattr(logger, "trace_id", None)
    return trace_pairs(
        trace_id, cur.span_id if cur is not None else None
    )


def extract_trace_context(invocation_metadata) -> dict[str, Any]:
    """Parse inbound gRPC metadata into span fields: ``trace_id``,
    ``remote_parent_id`` (the SENDER's span id), ``round``,
    ``rpc_send_time`` (sender wall clock), ``remote_node``. Missing or
    malformed entries are simply absent — un-instrumented peers must
    interoperate."""
    md: dict[str, str] = {}
    for k, v in (invocation_metadata or ()):
        md[str(k).lower()] = v
    out: dict[str, Any] = {}
    if md.get(TRACE_ID_KEY):
        out["trace_id"] = str(md[TRACE_ID_KEY])
    if md.get(NODE_KEY):
        out["remote_node"] = str(md[NODE_KEY])
    for key, field, conv in (
        (PARENT_SPAN_KEY, "remote_parent_id", int),
        (ROUND_KEY, "round", int),
        (SEND_TIME_KEY, "rpc_send_time", float),
    ):
        v = md.get(key)
        if v is not None:
            try:
                out[field] = conv(v)
            except (TypeError, ValueError):
                pass
    return out


# ---- telemetry reports piggybacked on replies (:1148-1229) ------------------

def encode_telemetry_report(
    nodes: "dict[str, dict[str, Any]]", full: bool
) -> bytes:
    """Serialize one telemetry report (``{node: {metric: snapshot}}``) to
    the compact zlib+JSON wire form carried in the ``telemetry`` proto
    fields. ``full`` tells the receiver to REPLACE each included node's
    series instead of patching."""
    return zlib.compress(json.dumps(
        {"nodes": nodes, "full": bool(full)}, default=float,
    ).encode())


class TelemetryShipper:
    """Builds the delta-encoded telemetry reports a node piggybacks on
    RPCs it already makes (StepReply / rejoin — zero extra round-trips).

    Each :meth:`build` ships only the metrics whose snapshot CHANGED since
    the last ship; every ``full_every``-th ship is a full snapshot, which
    re-synchronizes a receiver that missed deltas. Returns ``b""`` when
    nothing changed. Not thread-safe — call from the single thread that
    builds the carrying RPC reply.
    """

    def __init__(self, registry: MetricRegistry | None = None,
                 node: str = "", nodes_fn=None, full_every: int = 10):
        if nodes_fn is None:
            if registry is None:
                raise ValueError("need a registry or a nodes_fn")
            reg, name = registry, node

            def nodes_fn():
                return {name: reg.snapshot()}

        self._nodes_fn = nodes_fn
        self.full_every = max(1, int(full_every))
        self._ships = 0
        self._last: dict[str, dict[str, Any]] = {}

    def build(self) -> bytes:
        """The next report's wire bytes (``b""`` = nothing changed)."""
        nodes = self._nodes_fn()
        full = self._ships % self.full_every == 0
        self._ships += 1
        if full:
            payload = nodes
        else:
            payload = {}
            for node, metrics in nodes.items():
                prev = self._last.get(node, {})
                changed = {
                    name: snap for name, snap in metrics.items()
                    if prev.get(name) != snap
                }
                if changed:
                    payload[node] = changed
        self._last = {n: dict(m) for n, m in nodes.items()}
        if not payload:
            return b""
        return encode_telemetry_report(payload, full)


# ---- straggler analytics (:2456-2548) ---------------------------------------

class StragglerDetector:
    """Rolling per-client step-time EWMAs with z-score outlier flagging.

    Each round the server reports the warmed clients' poll latencies
    (:meth:`observe_round`); the detector updates one EWMA gauge per client
    (``client_step_ewma_s/clientN``) and flags any client whose EWMA sits
    more than ``z_threshold`` standard deviations above the population
    mean — provided the population is large enough to make a z-score
    meaningful (``min_clients``), the client has enough history
    (``min_rounds``), AND its EWMA exceeds ``min_ratio`` × the mean: a
    z-score alone is scale-invariant, so in a tightly-clustered fleet a
    client microseconds slower than its peers would otherwise flag.
    :meth:`status` serves the current per-client view to the ops
    endpoint's ``/status``.
    """

    def __init__(self, registry: MetricRegistry | None = None,
                 z_threshold: float = 2.0, alpha: float = 0.3,
                 min_clients: int = 3, min_rounds: int = 3,
                 min_ratio: float = 1.5):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.registry = registry
        self.z_threshold = float(z_threshold)
        self.alpha = float(alpha)
        self.min_clients = int(min_clients)
        self.min_rounds = int(min_rounds)
        self.min_ratio = float(min_ratio)
        self._ewma: dict[Any, float] = {}
        self._rounds: dict[Any, int] = {}
        self._current: dict[Any, dict[str, Any]] = {}
        self._lock = threading.Lock()

    def observe_round(
        self, latencies: dict[Any, float]
    ) -> list[dict[str, Any]]:
        """Fold one round's per-client latencies in; returns the newly
        computed stragglers as ``{"client", "z", "ewma_s"}`` dicts."""
        with self._lock:
            for cid, lat in latencies.items():
                prev = self._ewma.get(cid)
                self._ewma[cid] = (
                    float(lat) if prev is None
                    else self.alpha * float(lat) + (1 - self.alpha) * prev
                )
                self._rounds[cid] = self._rounds.get(cid, 0) + 1
                if self.registry is not None:
                    self.registry.gauge(
                        f"client_step_ewma_s/client{cid}"
                    ).set(self._ewma[cid])
            mature = {
                cid: e for cid, e in self._ewma.items()
                if self._rounds[cid] >= self.min_rounds
            }
            self._current = {
                cid: {"ewma_s": e, "z": None, "straggler": False}
                for cid, e in self._ewma.items()
            }
            if len(mature) < self.min_clients:
                return []
            values = list(mature.values())
            mean = sum(values) / len(values)
            var = sum((v - mean) ** 2 for v in values) / len(values)
            std = var ** 0.5
            if std <= 1e-12:
                return []
            flagged = []
            for cid, e in mature.items():
                z = (e - mean) / std
                self._current[cid]["z"] = z
                if (
                    z > self.z_threshold and e > self.min_ratio * mean
                    and cid in latencies
                ):
                    self._current[cid]["straggler"] = True
                    flagged.append({"client": cid, "z": z, "ewma_s": e})
            return flagged

    def ewma_view(self) -> dict[Any, float]:
        """Snapshot of the per-client poll-latency EWMAs — the live input
        to the pacing engines' adaptive poll deadline (a warmed client's
        deadline derives from these instead of the fixed 120 + 2E
        population-scale constant)."""
        with self._lock:
            return dict(self._ewma)

    def forget(self, client_id: Any) -> None:
        """Evict a departed client: a dropped client's frozen EWMA would
        otherwise skew the population mean/std forever (inflating std so
        genuine new stragglers stop flagging) and haunt ``/status``. Its
        gauge is dropped from the registry too — per-client series must
        not accumulate one ghost per client that ever churned through
        the federation. A rejoin re-warms from scratch, like the
        server's poll warm-up."""
        with self._lock:
            self._ewma.pop(client_id, None)
            self._rounds.pop(client_id, None)
            self._current.pop(client_id, None)
        if self.registry is not None:
            self.registry.drop(f"client_step_ewma_s/client{client_id}")

    def status(self) -> dict[str, dict[str, Any]]:
        """JSON-safe per-client view for the ops endpoint."""
        with self._lock:
            return {
                str(cid): dict(state)
                for cid, state in sorted(self._current.items(), key=str)
            }

    def summary(self, top_k: int = 5) -> dict[str, Any]:
        """Bounded view for the default ``/status`` scrape: counts plus
        the ``top_k`` slowest EWMAs. One heap pass over the live map —
        the full per-client materialize-and-sort that :meth:`status`
        does would stall the ops thread at 10⁴ clients; only the
        ``top_k`` winners are copied out."""
        with self._lock:
            top = heapq.nlargest(
                top_k, self._current.items(),
                key=lambda kv: (kv[1].get("ewma_s") or 0.0, str(kv[0])),
            )
            return {
                "observed": len(self._current),
                "flagged": sum(
                    1 for v in self._current.values() if v.get("straggler")
                ),
                "top_slowest": [
                    {"client": str(cid), **state} for cid, state in top
                ],
            }


# ---- reading a stream ---------------------------------------------------------

def read_metrics(path: str) -> list[dict[str, Any]]:
    """Parse a ``metrics.jsonl`` file; blank lines are skipped, malformed
    lines raise (a corrupt stream should be loud, not silently partial)."""
    records = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as err:
                raise ValueError(f"{path}:{lineno}: bad JSONL line: {err}")
    return records


# ---- fleet telemetry, run summaries, Prometheus and the ops endpoint -------


def merge_metric_snapshots(
    a: dict[str, Any], b: dict[str, Any]
) -> dict[str, Any]:
    """Merge two snapshot dicts of the SAME metric from different nodes.

    The merge is exact by construction: counters are monotone (values
    add), gauges are last-write-wins (``b`` wins when it carries a value),
    and histograms are fixed-bucket (identical edges ⇒ bucket-wise count
    addition loses nothing). This one primitive backs the relay tier's
    upstream pre-reduction, the server's :class:`FleetRegistry`, and the
    offline ``summarize`` cross-node merge, so live and post-hoc fleet
    views can never drift apart. Raises ``ValueError`` on a type or
    bucket-layout mismatch."""
    ta, tb = a.get("type"), b.get("type")
    if ta != tb:
        raise ValueError(f"cannot merge snapshot types {ta!r} and {tb!r}")
    if ta == "counter":
        return {"type": "counter",
                "value": float(a.get("value") or 0.0)
                + float(b.get("value") or 0.0)}
    if ta == "gauge":
        return {"type": "gauge",
                "value": b["value"] if b.get("value") is not None
                else a.get("value")}
    if ta == "histogram":
        if list(a["edges"]) != list(b["edges"]):
            raise ValueError(
                "cannot merge histograms with different bucket edges"
            )
        out: dict[str, Any] = {
            "type": "histogram",
            "count": a.get("count", 0) + b.get("count", 0),
            "sum": a.get("sum", 0.0) + b.get("sum", 0.0),
            "edges": list(a["edges"]),
            "counts": [x + y for x, y in zip(a["counts"], b["counts"])],
        }
        # Empty histograms omit min/max (Histogram.snapshot contract).
        mins = [s["min"] for s in (a, b) if "min" in s]
        maxs = [s["max"] for s in (a, b) if "max" in s]
        if mins:
            out["min"], out["max"] = min(mins), max(maxs)
        return out
    raise ValueError(f"cannot merge unknown snapshot type {ta!r}")


def merge_node_snapshots(
    nodes: "dict[str, dict[str, Any]]"
) -> dict[str, Any]:
    """Merge per-node registry snapshots (``{node: {metric: snapshot}}``)
    into one fleet-wide snapshot dict via :func:`merge_metric_snapshots`.
    A metric whose snapshots are unmergeable across nodes (type or bucket
    mismatch — a fleet running mixed code) is dropped from the merged view
    rather than poisoning the scrape; iteration order is node-sorted so
    gauge last-write-wins resolution is deterministic."""
    merged: dict[str, Any] = {}
    dropped: set[str] = set()
    for node in sorted(nodes):
        for name, snap in nodes[node].items():
            if name in dropped:
                continue
            cur = merged.get(name)
            if cur is None:
                merged[name] = dict(snap)
                continue
            try:
                merged[name] = merge_metric_snapshots(cur, snap)
            except (ValueError, KeyError, TypeError):
                del merged[name]
                dropped.add(name)
    return merged


def decode_telemetry_report(data: bytes) -> dict[str, Any]:
    """Parse a wire telemetry report; raises ``ValueError`` on garbage
    (truncated zlib stream, non-JSON, wrong shape)."""
    try:
        report = json.loads(zlib.decompress(data).decode())
    except Exception as err:
        raise ValueError(f"bad telemetry report: {err}")
    if not isinstance(report, dict) or not isinstance(
        report.get("nodes"), dict
    ):
        raise ValueError("bad telemetry report: missing 'nodes' mapping")
    return report


class FleetRegistry:
    """Server-side store of per-node registry snapshots: the live,
    federation-wide metrics view.

    Reports arrive via :meth:`ingest_bytes` (the wire form), are patched
    per-node with replace-semantics (cumulative snapshots ⇒ ingesting the
    same report twice is a no-op, so RPC replays deduplicate naturally),
    and merge on demand into one fleet snapshot (:meth:`merged`) via the
    exact merge primitive. A cardinality guard bounds both the node count
    and the per-node series count — an adversarial or runaway client can
    at worst have its OWN report withheld (counted in the
    ``fleet_reports_dropped`` counter + one ``fleet_overflow`` event per
    offending node, never silently)."""

    def __init__(self, metrics: "MetricsLogger | None" = None,
                 max_nodes: int = 512, max_series_per_node: int = 512):
        self.metrics = metrics
        self.max_nodes = int(max_nodes)
        self.max_series_per_node = int(max_series_per_node)
        self._nodes: dict[str, dict[str, Any]] = {}
        self._last_report: dict[str, float] = {}
        self._overflow_seen: set[tuple[str, str]] = set()
        self._lock = threading.Lock()

    def _overflow(self, node: str, reason: str) -> None:
        if self.metrics is not None:
            self.metrics.registry.counter("fleet_reports_dropped").inc()
            key = (node, reason)
            if key not in self._overflow_seen:
                self._overflow_seen.add(key)
                self.metrics.log("fleet_overflow", node=node, reason=reason)

    def ingest_bytes(self, data: bytes) -> bool:
        """Ingest one wire report; corrupt bytes are counted
        (``fleet_reports_invalid``), never raised — a garbled telemetry
        payload must not perturb the round loop carrying it."""
        if not data:
            return False
        try:
            report = decode_telemetry_report(bytes(data))
        except ValueError:
            if self.metrics is not None:
                self.metrics.registry.counter("fleet_reports_invalid").inc()
            return False
        ok = False
        full = bool(report.get("full"))
        for node in sorted(report["nodes"]):
            metrics = report["nodes"][node]
            if isinstance(metrics, dict):
                ok = self.ingest(str(node), metrics, full=full) or ok
        return ok

    def ingest(self, node: str, metrics: dict[str, Any],
               full: bool = False) -> bool:
        """Patch (or, with ``full``, replace) one node's series."""
        overflow_reason = None
        with self._lock:
            cur = self._nodes.get(node)
            if cur is None:
                if len(self._nodes) >= self.max_nodes:
                    overflow_reason = "max_nodes"
                else:
                    cur = self._nodes[node] = {}
            if cur is not None:
                if full:
                    cur.clear()
                for name in sorted(metrics):
                    if (name not in cur
                            and len(cur) >= self.max_series_per_node):
                        overflow_reason = "max_series_per_node"
                        break
                    cur[name] = metrics[name]
                self._last_report[node] = time.time()
        if overflow_reason is not None:
            self._overflow(node, overflow_reason)
        return overflow_reason is None

    def node_snapshots(self) -> dict[str, dict[str, Any]]:
        with self._lock:
            return {node: dict(m) for node, m in self._nodes.items()}

    def merged(self) -> dict[str, Any]:
        """The fleet-wide merged snapshot (one dict, same shape as a
        :meth:`MetricRegistry.snapshot` — every downstream consumer of
        single-registry snapshots works on it unchanged)."""
        return merge_node_snapshots(self.node_snapshots())

    def summary(self, top_k: int = 8) -> dict[str, Any]:
        """Bounded fleet summary for ``/status.fleet``: totals plus the
        top-k nodes by series count and the top-k busiest merged
        histograms — the response size is O(top_k) regardless of fleet
        size (the StragglerDetector top-k pattern)."""
        now = time.time()
        with self._lock:
            sizes = {node: len(m) for node, m in self._nodes.items()}
            ages = {node: now - t for node, t in self._last_report.items()}
        top_nodes = heapq.nlargest(
            top_k, sizes.items(), key=lambda kv: (kv[1], str(kv[0]))
        )
        merged = self.merged()
        hists = [
            (name, snap) for name, snap in merged.items()
            if snap.get("type") == "histogram" and snap.get("count")
        ]
        top_hists = heapq.nlargest(
            top_k, hists, key=lambda kv: (kv[1]["count"], kv[0])
        )
        return {
            "nodes": len(sizes),
            "series": sum(sizes.values()),
            "merged_series": len(merged),
            "top_nodes": [
                {"node": node, "series": n,
                 "report_age_s": round(ages.get(node, 0.0), 3)}
                for node, n in top_nodes
            ],
            "histograms": {
                name: _hist_stats(snap) for name, snap in top_hists
            },
        }


def render_fleet_prometheus(
    nodes: "dict[str, dict[str, Any]]", prefix: str = "gfedntm",
    max_series: int = 256,
) -> str:
    """Prometheus exposition of a fleet view: ``<prefix>_fleet_*``
    families carry the exact cross-node merge, ``<prefix>_node_*``
    families carry the per-node series with a ``node`` label (plus the
    usual ``key`` label). Distinct family prefixes keep both valid in one
    scrape alongside the process's own ``<prefix>_*`` registry. The
    per-node section shares the cardinality-cap discipline of
    :func:`render_prometheus`: each family exports its first
    ``max_series`` (node, key) pairs sorted (stable across scrapes) plus
    an overflow counter for the withheld remainder."""
    out = [render_prometheus(
        merge_node_snapshots(nodes), prefix=f"{prefix}_fleet",
        max_series=max_series,
    )]

    families: dict[str, list[tuple[str, str, dict[str, Any]]]] = {}
    for node, metrics in nodes.items():
        for name, snap in metrics.items():
            base, _, key = name.partition("/")
            families.setdefault(_prom_name(base), []).append(
                (node, key, snap)
            )
    overflow: dict[str, int] = {}
    lines: list[str] = []
    for base in sorted(families):
        series = sorted(families[base], key=lambda t: (t[0], t[1]))
        if max_series and len(series) > max_series:
            overflow[base] = len(series) - max_series
            series = series[:max_series]
        kind = series[0][2].get("type")
        full = f"{prefix}_node_{base}"
        if kind == "counter":
            full += "_total"
        if kind not in ("counter", "gauge", "histogram"):
            continue
        lines.append(f"# TYPE {full} {kind}")
        for node, key, snap in series:
            if snap.get("type") != kind:
                continue  # cross-node type mismatch: skip, never 500
            label_parts = [f'node="{_prom_label(node)}"']
            if key:
                label_parts.append(f'key="{_prom_label(key)}"')
            label = "{" + ",".join(label_parts) + "}"
            if kind == "counter":
                lines.append(f"{full}{label} {snap['value']}")
            elif kind == "gauge":
                if snap["value"] is not None:
                    lines.append(f"{full}{label} {snap['value']}")
            else:
                base_label = ",".join(label_parts)
                cum = 0
                for edge, count in zip(snap["edges"], snap["counts"]):
                    cum += count
                    lines.append(
                        f'{full}_bucket{{{base_label},le="{edge}"}} {cum}'
                    )
                cum += snap["counts"][-1]
                lines.append(
                    f'{full}_bucket{{{base_label},le="+Inf"}} {cum}'
                )
                lines.append(f"{full}_sum{label} {snap['sum']}")
                lines.append(f"{full}_count{label} {snap['count']}")
    if overflow:
        full = f"{prefix}_node_series_overflow_total"
        lines.append(f"# TYPE {full} counter")
        for base in sorted(overflow):
            lines.append(
                f'{full}{{family="{_prom_label(base)}"}} {overflow[base]}'
            )
    if lines:
        out.append("\n".join(lines) + "\n")
    return "".join(out)


#: Process start reference for the ``process_uptime_s`` gauge.
_PROCESS_START_TIME = time.time()


def sample_process_metrics(registry: MetricRegistry) -> None:
    """Refresh the process self-gauges (``process_rss_bytes``,
    ``process_uptime_s``, ``process_threads``) — stdlib only, sampled per
    ops scrape so every plane that serves ``/metrics`` exposes them
    without per-plane wiring. Makes the BENCH_SCALE flat-RSS claim
    scrapeable live instead of only measurable via subprocess
    ``ru_maxrss``."""
    rss = None
    try:
        # Current RSS (not the rusage high-water mark) when /proc exists.
        with open("/proc/self/statm") as fh:
            rss = int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    # graftlint: disable=exception-hygiene -- platform probe: no /proc
    # (macOS) falls back to the rusage peak below
    except Exception:
        try:
            import resource
            import sys

            ru = resource.getrusage(resource.RUSAGE_SELF)
            # ru_maxrss (the peak, the best available without /proc) is
            # bytes on macOS, KiB elsewhere.
            scale = 1 if sys.platform == "darwin" else 1024
            rss = int(ru.ru_maxrss) * scale
        # graftlint: disable=exception-hygiene -- no resource module
        # (non-POSIX): the gauge is simply absent
        except Exception:
            rss = None
    if rss is not None:
        registry.gauge("process_rss_bytes").set(rss)
    registry.gauge("process_uptime_s").set(
        time.time() - _PROCESS_START_TIME
    )
    registry.gauge("process_threads").set(threading.active_count())


def _hist_stats(snap: dict[str, Any]) -> dict[str, Any]:
    count = snap.get("count", 0)
    out: dict[str, Any] = {"count": count}
    if count:
        out["mean_s"] = snap["sum"] / count
        for q, label in ((0.5, "p50_s"), (0.95, "p95_s"), (0.99, "p99_s")):
            out[label] = quantile_from_snapshot(snap, q)
        out["min_s"], out["max_s"] = snap["min"], snap["max"]
    return out


def collect_data_plane(records: list[dict[str, Any]]) -> dict[str, Any]:
    """Aggregate the data-plane defense events of a stream (admission-gate
    rejections per client by reason, norm clips, divergence rollbacks,
    quarantines — README "Robust aggregation & divergence recovery") into
    one dict. Shared by the ``summarize`` and ``report`` engines so both
    CLIs show identical accounting."""
    rejections: dict[str, dict[str, int]] = {}
    clips: dict[str, int] = {}
    rollbacks: list[dict[str, Any]] = []
    quarantines: dict[str, int] = {}
    for r in records:
        event = r.get("event")
        if event == "update_rejected":
            by = rejections.setdefault(str(r.get("client")), {})
            reason = str(r.get("reason", "?"))
            by[reason] = by.get(reason, 0) + 1
        elif event == "update_clipped":
            cid = str(r.get("client"))
            clips[cid] = clips.get(cid, 0) + 1
        elif event == "divergence_rollback":
            rollbacks.append({
                "round": r.get("round"), "reason": r.get("reason"),
                "restored_round": r.get("restored_round"),
            })
        elif event == "client_quarantined":
            cid = str(r.get("client"))
            quarantines[cid] = quarantines.get(cid, 0) + 1
    return {
        "rejections": rejections,
        "clips": clips,
        "rollbacks": rollbacks,
        "quarantines": quarantines,
    }


def summarize_model_quality(
    records: list[dict[str, Any]]
) -> dict[str, Any]:
    """Aggregate a run's model-quality telemetry into a report dict: the
    per-round coherence/diversity/drift trajectory (``quality_computed``
    + ``topic_drift`` events keyed by round), the per-client contribution
    EWMAs (read from the LAST ``metrics_snapshot`` carrying the
    contribution gauges), and the data-plane accounting
    (:func:`collect_data_plane`). Everything comes from the JSONL stream
    alone — the report needs no live server."""
    quality: dict[int, dict[str, Any]] = {}
    last_gauges: dict[str, float] = {}
    topics_last: list[list[str]] | None = None
    alerts: dict[str, dict[str, Any]] = {}
    for r in records:
        event = r.get("event")
        if event in ("alert_pending", "alert_firing", "alert_resolved"):
            state = event[len("alert_"):]
            a = alerts.setdefault(
                str(r.get("alert")),
                {"pending": 0, "firing": 0, "resolved": 0,
                 "last_state": "ok", "metric": r.get("metric")},
            )
            a[state] += 1
            a["last_state"] = state
        elif event == "quality_computed":
            row = quality.setdefault(int(r.get("round", -1)), {})
            row.update(
                npmi=r.get("npmi"), diversity=r.get("diversity"),
                irbo=r.get("irbo"), n_topics=r.get("n_topics"),
            )
            if r.get("topics"):
                topics_last = r["topics"]
        elif event == "topic_drift":
            row = quality.setdefault(int(r.get("round", -1)), {})
            row.update(
                mean_drift=r.get("mean_drift"),
                max_drift=r.get("max_drift"),
                mean_js=r.get("mean_js"), churn=r.get("churn"),
            )
        elif event == "metrics_snapshot":
            for name, snap in (r.get("metrics") or {}).items():
                if snap.get("type") == "gauge" and snap["value"] is not None:
                    last_gauges[name] = snap["value"]

    contributions: dict[str, dict[str, Any]] = {}
    for name, value in last_gauges.items():
        base, _, key = name.partition("/")
        if base in ("client_contribution_cos", "client_contribution_share"):
            cid = key.removeprefix("client")
            field = (
                "cos_ewma" if base == "client_contribution_cos"
                else "share_ewma"
            )
            contributions.setdefault(cid, {})[field] = value

    return {
        "quality": [
            {"round": rnd, **row} for rnd, row in sorted(quality.items())
        ],
        "contributions": contributions,
        "pairwise": {
            "cos_mean": last_gauges.get("contribution_pairwise_cos_mean"),
            "cos_min": last_gauges.get("contribution_pairwise_cos_min"),
        },
        "topics": topics_last,
        "alerts": alerts,
        "data_plane": collect_data_plane(records),
    }


def summarize_privacy(
    records: "list[dict[str, Any]]",
) -> "dict[str, Any] | None":
    """Fold a stream's ``privacy_budget`` ledger into its final state
    (the accountant's running (eps, delta) — README "Differential
    privacy & posterior sampling"); ``None`` when the run carried no
    ledger (``--dp off``)."""
    last: dict[str, Any] | None = None
    rounds = 0
    exceeded = 0
    for r in records:
        event = r.get("event")
        if event == "privacy_budget":
            rounds += 1
            last = r
        elif event == "privacy_budget_exceeded":
            exceeded += 1
    if last is None:
        return None
    return {
        "mode": last.get("mode"),
        "eps": float(last.get("eps", 0.0)),
        "delta": float(last.get("delta", 0.0)),
        "sigma": float(last.get("sigma", 0.0)),
        "steps": int(last.get("steps", rounds)),
        "budget": float(last.get("budget", 0.0)),
        "rounds": rounds,
        "exceeded_events": exceeded,
    }


_PROM_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    name = _PROM_NAME_OK.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _prom_label(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def render_prometheus(snapshot: dict[str, Any],
                      prefix: str = "gfedntm",
                      max_series: int = 256) -> str:
    """Render a :meth:`MetricRegistry.snapshot` dict as Prometheus text
    exposition (version 0.0.4). Registry names like
    ``rpc_s/FederationClient.TrainStep`` split at the first ``/`` into the
    metric family (sanitized) plus a ``key`` label, so per-client and
    per-method series stay one scrapeable family.

    ``max_series`` caps the label cardinality per family: per-client
    series (poll latency, contribution EWMAs) grow with client churn, and
    an unbounded exposition would eventually dominate every scrape. A
    family over the cap exports its first ``max_series`` keys (sorted —
    stable across scrapes) plus one ``<prefix>_series_overflow_total``
    counter recording how many series were withheld, so the truncation is
    itself observable instead of silent. ``max_series=0`` disables the
    cap."""
    families: dict[str, list[tuple[str, dict[str, Any]]]] = {}
    for name, snap in snapshot.items():
        base, _, key = name.partition("/")
        families.setdefault(_prom_name(base), []).append((key, snap))

    overflow: dict[str, int] = {}
    lines: list[str] = []
    for base in sorted(families):
        series = sorted(families[base])
        if max_series and len(series) > max_series:
            overflow[base] = len(series) - max_series
            series = series[:max_series]
        kind = series[0][1].get("type")
        full = f"{prefix}_{base}"
        if kind == "counter":
            full += "_total"
        if kind in ("counter", "gauge", "histogram"):
            lines.append(f"# TYPE {full} {kind}")
        for key, snap in series:
            label = f'{{key="{_prom_label(key)}"}}' if key else ""
            if kind == "counter":
                lines.append(f"{full}{label} {snap['value']}")
            elif kind == "gauge":
                if snap["value"] is not None:
                    lines.append(f"{full}{label} {snap['value']}")
            elif kind == "histogram":
                base_label = (
                    f'key="{_prom_label(key)}",' if key else ""
                )
                cum = 0
                for edge, count in zip(snap["edges"], snap["counts"]):
                    cum += count
                    lines.append(
                        f'{full}_bucket{{{base_label}le="{edge}"}} {cum}'
                    )
                cum += snap["counts"][-1]
                lines.append(
                    f'{full}_bucket{{{base_label}le="+Inf"}} {cum}'
                )
                lines.append(f"{full}_sum{label} {snap['sum']}")
                lines.append(f"{full}_count{label} {snap['count']}")
    if overflow:
        full = f"{prefix}_series_overflow_total"
        lines.append(f"# TYPE {full} counter")
        for base in sorted(overflow):
            lines.append(
                f'{full}{{family="{_prom_label(base)}"}} {overflow[base]}'
            )
    return "\n".join(lines) + "\n"


def _accepts_kwarg(fn, name: str) -> bool:
    """True when ``fn`` can be called with keyword ``name``."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):  # builtins / C callables: no signature
        return False
    p = params.get(name)
    if p is not None:
        return p.kind is not inspect.Parameter.VAR_POSITIONAL
    return any(
        q.kind is inspect.Parameter.VAR_KEYWORD for q in params.values()
    )


class OpsServer:
    """Live ops endpoint: a stdlib ``ThreadingHTTPServer`` on a daemon
    thread serving

    - ``/healthz`` — liveness probe (``200 ok``): the ops thread exists;
    - ``/ready`` — readiness probe, distinct from liveness (README
      "Serving"): 200 only when ``ready_fn`` returns truthy — for the
      serving plane that means "a model is loaded and the encoder is
      warm", which a load balancer must gate on before routing traffic;
      503 otherwise. Without a ``ready_fn`` the route mirrors
      ``/healthz`` (a process with no warm-up phase is ready when alive);
    - ``/metrics`` — Prometheus text exposition of the registry
      (:func:`render_prometheus`);
    - ``/status`` — JSON from ``status_fn`` (the federation server's live
      round / membership / codec view). ``/status?full=1`` passes
      ``full=True`` through to ``status_fn`` (the federation server then
      serves the complete per-client roster instead of the bounded
      summary); a ``status_fn`` that takes no ``full`` kwarg is called
      plain — older callers keep working.

    ``routes`` mounts additional POST handlers (the serving plane's JSON
    ``/infer``): a dict of path -> ``fn(body_bytes, query_string)``
    returning ``(http_code, content_type, body_bytes)``. Handler
    exceptions surface as 500s, never kill the serving thread.

    Fleet telemetry (README "Fleet telemetry & SLOs"): passing a
    :class:`FleetRegistry` as ``fleet`` extends ``/metrics`` with the
    fleet-merged ``<prefix>_fleet_*`` families plus node-labeled
    ``<prefix>_node_*`` series, and mounts ``/status.fleet`` (the bounded
    top-k :meth:`FleetRegistry.summary`). An ``alerts_fn`` mounts
    ``/alerts`` (the SLO engine's live alert states). Every ``/metrics``
    scrape also refreshes the process self-gauges
    (:func:`sample_process_metrics`), so each ops plane exposes
    ``gfedntm_process_{rss_bytes,uptime_s,threads}`` for free.

    Entirely out of the training hot path: no thread is started unless
    :meth:`start` is called, and GET handlers only *read* registry
    snapshots.
    """

    def __init__(self, registry: MetricRegistry | None = None,
                 status_fn=None, host: str = "127.0.0.1", port: int = 0,
                 ready_fn=None, routes: dict | None = None,
                 fleet: "FleetRegistry | None" = None, alerts_fn=None):
        self.registry = registry or MetricRegistry()
        self.status_fn = status_fn
        self.ready_fn = ready_fn
        self.routes = dict(routes or {})
        self.fleet = fleet
        self.alerts_fn = alerts_fn
        self.host = host
        self.port = port
        self._httpd = None
        self._thread = None

    def start(self) -> int:
        """Bind + serve on a daemon thread; returns the actual port
        (``port=0`` binds an ephemeral one)."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        ops = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                path, _, query = self.path.partition("?")
                try:
                    if path == "/healthz":
                        code, ctype, body = 200, "text/plain", b"ok\n"
                    elif path == "/ready":
                        # Readiness is not liveness: a serving process is
                        # alive the moment its ops thread binds, but must
                        # not receive traffic until a model is loaded and
                        # warm (README "Serving").
                        ready = (
                            bool(ops.ready_fn()) if ops.ready_fn is not None
                            else True
                        )
                        code = 200 if ready else 503
                        ctype = "text/plain"
                        body = b"ready\n" if ready else b"not ready\n"
                    elif path == "/metrics":
                        sample_process_metrics(ops.registry)
                        text = render_prometheus(ops.registry.snapshot())
                        if ops.fleet is not None:
                            text += render_fleet_prometheus(
                                ops.fleet.node_snapshots()
                            )
                        code = 200
                        ctype = "text/plain; version=0.0.4"
                        body = text.encode()
                    elif path == "/status.fleet" and ops.fleet is not None:
                        code, ctype = 200, "application/json"
                        body = json.dumps(
                            ops.fleet.summary(), default=str, indent=1,
                        ).encode()
                    elif path == "/alerts" and ops.alerts_fn is not None:
                        code, ctype = 200, "application/json"
                        body = json.dumps(
                            ops.alerts_fn(), default=str, indent=1,
                        ).encode()
                    elif path == "/status":
                        full = "full=1" in query.split("&")
                        if ops.status_fn is None:
                            status = {}
                        elif full and _accepts_kwarg(ops.status_fn, "full"):
                            # Detected by signature, not by calling and
                            # catching TypeError — that would also eat a
                            # TypeError raised INSIDE status_fn and
                            # silently serve the summary view instead.
                            status = ops.status_fn(full=True)
                        else:
                            # status_fn without a full kwarg (older
                            # callers / test fixtures) serves its one view
                            status = ops.status_fn()
                        code, ctype = 200, "application/json"
                        body = json.dumps(
                            status, default=str, indent=1
                        ).encode()
                    else:
                        code, ctype, body = 404, "text/plain", b"not found\n"
                except Exception as err:  # never kill the serving thread
                    code, ctype = 500, "text/plain"
                    body = f"error: {err}\n".encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):  # noqa: N802 - http.server API
                path, _, query = self.path.partition("?")
                handler = ops.routes.get(path)
                try:
                    if handler is None:
                        code, ctype, body = 404, "text/plain", b"not found\n"
                    else:
                        length = int(self.headers.get("Content-Length", 0))
                        payload = self.rfile.read(length) if length else b""
                        code, ctype, body = handler(payload, query)
                except Exception as err:  # never kill the serving thread
                    code, ctype = 500, "text/plain"
                    body = f"error: {err}\n".encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="ops-server", daemon=True,
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# ---- the round profiler window (:921-1019) ----------------------------------

def parse_round_window(spec: str) -> tuple[int, int]:
    """Parse a ``--profile_rounds`` window: ``"start:stop"`` (half-open) or
    a single round ``"N"`` (= ``N:N+1``)."""
    try:
        if ":" in spec:
            lo_s, hi_s = spec.split(":", 1)
            lo, hi = int(lo_s), int(hi_s)
        else:
            lo = int(spec)
            hi = lo + 1
    except ValueError:
        raise ValueError(
            f"bad round window {spec!r}: expected 'start:stop' or 'round'"
        )
    if lo < 0 or hi <= lo:
        raise ValueError(
            f"bad round window {spec!r}: need 0 <= start < stop"
        )
    return lo, hi


#: Held by the one open window of this process: like ``jax.profiler``,
#: ``torch.profiler`` runs one session per process, and a second start
#: silently ends the first.
_PROFILER_SESSION = threading.Lock()


class _ProfilerSession:
    """One ``torch.profiler`` session on a thread of its own: the profiler's
    CPU callbacks belong to the thread that starts it, and it must stop on
    that thread, while rounds are observed from any thread (a server's
    round loop, a client's gRPC handlers). CPU ops of every thread are
    recorded where the installed PyTorch can (``profile_all_threads``);
    CUDA kernels come from CUPTI, which sees the whole process."""

    def __init__(self, path: str, cuda: bool):
        self.path = path
        self.cuda = cuda
        self._stop = threading.Event()
        self._started = threading.Event()
        self._done = threading.Event()
        self.error: BaseException | None = None
        self._thread = threading.Thread(
            target=self._run, name="round-profiler", daemon=True,
        )

    def _profile(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        try:
            from torch._C._profiler import _ExperimentalConfig

            config = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):  # an older PyTorch: this thread's ops
            config = None
        if self.cuda:
            torch.cuda.synchronize()
        return profile(activities=activities, experimental_config=config)

    def _run(self) -> None:
        try:
            prof = self._profile()
            prof.start()
        except BaseException as err:  # reported by start()
            self.error = err
            self._started.set()
            return
        self._started.set()
        self._stop.wait()
        try:
            if self.cuda:
                import torch

                torch.cuda.synchronize()
            prof.stop()
            prof.export_chrome_trace(self.path)
        except BaseException as err:  # reported by stop()
            self.error = err
        finally:
            self._done.set()

    def start(self) -> None:
        self._thread.start()
        self._started.wait()
        if self.error is not None:
            raise self.error

    def stop(self) -> None:
        self._stop.set()
        self._done.wait()
        self._thread.join()
        if self.error is not None:
            raise self.error


class RoundProfiler:
    """``torch.profiler`` capture around a round window [start, stop) — the
    JAX ``RoundProfiler`` (``observability.py:942-1019``) over the port's
    profiler.

    Driven by :meth:`observe` with the current round index — the server's
    round engines and the client servicer (which learns the round from each
    ``StepRequest``) both just report rounds as they see them; the profiler
    starts the trace on the first round inside the window and stops it on
    the first round at/after ``stop`` (or at :meth:`close`), writing one
    Chrome trace (``rounds_<start>-<stop>.<pid>.pt.trace.json``) under
    ``profile_dir``. It records CPU activity, and CUDA activity when
    ``device`` is a CUDA device (the owning server or client sets it from
    its own device when it is left ``None``). A ``None`` ``profile_dir``
    makes every method a no-op. A window that cannot start (a profiler
    error, or another window already open in this process) disables the
    instance loudly — ``profiler_failures`` counter and a warning — rather
    than killing the round loop; a failed stop warns and disables it.
    """

    def __init__(self, profile_dir: str | None, rounds: str = "1:2",
                 metrics: MetricsLogger | None = None, device=None):
        self.profile_dir = profile_dir
        self.metrics = metrics
        self.device = device
        self.start_round, self.stop_round = parse_round_window(rounds)
        self.trace_path: str | None = None
        self._active = False
        self._disabled = profile_dir is None
        self._session: _ProfilerSession | None = None
        self._lock = threading.Lock()

    def observe(self, round_idx: int) -> None:
        if self._disabled:
            return
        with self._lock:
            if (not self._active and
                    self.start_round <= round_idx < self.stop_round):
                self._start(round_idx)
            elif self._active and round_idx >= self.stop_round:
                self._stop(round_idx)

    def close(self) -> None:
        if self._disabled:
            return
        with self._lock:
            if self._active:
                self._stop(self.stop_round)

    # callers hold self._lock
    def _start(self, round_idx: int) -> None:
        import logging

        try:
            if not _PROFILER_SESSION.acquire(blocking=False):
                raise RuntimeError(
                    "another profiler window is open in this process"
                )
            try:
                os.makedirs(self.profile_dir, exist_ok=True)
                path = os.path.join(
                    self.profile_dir,
                    f"rounds_{self.start_round}-{self.stop_round}."
                    f"{os.getpid()}.pt.trace.json",
                )
                session = _ProfilerSession(
                    path, str(self.device or "").startswith("cuda")
                )
                session.start()
            except BaseException:
                _PROFILER_SESSION.release()
                raise
        except Exception as err:  # no profiler, or a window already open
            self._disabled = True
            if self.metrics is not None:
                self.metrics.registry.counter("profiler_failures").inc()
            logging.getLogger("RoundProfiler").warning(
                "torch.profiler unavailable (%s); device profiling disabled",
                err,
            )
            return
        self._session = session
        self.trace_path = path
        self._active = True
        if self.metrics is not None:
            self.metrics.log(
                "profiler_started", dir=self.profile_dir, round=round_idx,
            )

    def _stop(self, round_idx: int) -> None:
        import logging

        self._active = False
        session, self._session = self._session, None
        try:
            session.stop()
        except Exception as err:
            self._disabled = True
            logging.getLogger("RoundProfiler").warning(
                "torch.profiler stop failed: %s", err,
            )
            return
        finally:
            _PROFILER_SESSION.release()
        if self.metrics is not None:
            self.metrics.log("profiler_stopped", round=round_idx)


# ---- run reports (the command line's summarize and report readers) --------

def _agg(groups: dict, key: str, seconds: float) -> None:
    g = groups.setdefault(key, {"count": 0, "total_s": 0.0, "max_s": 0.0})
    g["count"] += 1
    g["total_s"] += seconds
    g["max_s"] = max(g["max_s"], seconds)


def collect_wire_tiers(
    node_records: "dict[str, list[dict[str, Any]]]"
) -> dict[str, dict[str, Any]]:
    """Per-node (per-tier) wire accounting from each stream's LAST
    ``metrics_snapshot`` (registries are cumulative): bytes moved raw vs
    compressed per direction, the resulting compression ratios, and the
    per-recipient-encoding counters (catch-up / self-contained pushes,
    reference evictions). In a hierarchical topology each relay and the
    root write their own ``metrics.jsonl``, so feeding them all to
    ``summarize``/``report`` reproduces the BENCH_SCALE per-tier numbers
    from JSONL alone (README "Hierarchical federation & wire
    efficiency")."""
    out: dict[str, dict[str, Any]] = {}
    for node, records in sorted(node_records.items()):
        last: dict[str, dict] = {}
        for r in records:
            if r.get("event") == "metrics_snapshot":
                for name, snap in (r.get("metrics") or {}).items():
                    last[name] = snap

        def cval(name: str) -> float:
            snap = last.get(name)
            if snap is None or snap.get("type") != "counter":
                return 0.0
            return float(snap.get("value") or 0.0)

        sent_raw, sent = (
            cval("uncompressed_bytes_sent"), cval("compressed_bytes_sent")
        )
        recv_raw, recv = (
            cval("uncompressed_bytes_recv"), cval("compressed_bytes_recv")
        )
        out[node] = {
            "sent_bytes": sent,
            "sent_raw_bytes": sent_raw,
            "ratio_sent": (sent_raw / sent) if sent else None,
            "recv_bytes": recv,
            "recv_raw_bytes": recv_raw,
            "ratio_recv": (recv_raw / recv) if recv else None,
            "rpc_bytes_sent": cval("rpc_bytes_sent"),
            "rpc_bytes_recv": cval("rpc_bytes_recv"),
            "catchup_pushes": cval("codec_catchup_pushes"),
            "selfcontained_pushes": cval("codec_selfcontained_pushes"),
            "refs_evicted": cval("codec_refs_evicted"),
        }
    return out


def format_wire_tiers(tiers: dict[str, dict[str, Any]]) -> str:
    """Render :func:`collect_wire_tiers` as the per-tier table the
    ``summarize``/``report`` CLIs append when fed multiple streams."""
    lines = ["wire accounting per tier:"]
    lines.append(
        f"  {'node':<16}{'sent':>12}{'ratio':>8}{'recv':>12}{'ratio':>8}"
        f"{'catchup':>9}{'selfcont':>10}{'evicted':>9}"
    )
    for node, t in tiers.items():
        sent = t["sent_bytes"] or t["rpc_bytes_sent"]
        recv = t["recv_bytes"] or t["rpc_bytes_recv"]
        rs = f"{t['ratio_sent']:.2f}x" if t["ratio_sent"] else "-"
        rr = f"{t['ratio_recv']:.2f}x" if t["ratio_recv"] else "-"
        lines.append(
            f"  {node:<16}{_fmt_bytes(sent):>12}{rs:>8}"
            f"{_fmt_bytes(recv):>12}{rr:>8}"
            f"{t['catchup_pushes']:>9.0f}{t['selfcontained_pushes']:>10.0f}"
            f"{t['refs_evicted']:>9.0f}"
        )
    return "\n".join(lines)


def summarize_metrics(records: list[dict[str, Any]]) -> dict[str, Any]:
    """Aggregate a run's event stream into a report dict (see
    :func:`format_report` for the rendered form)."""
    times = [r["time"] for r in records
             if isinstance(r.get("time"), (int, float))]
    event_counts: dict[str, int] = {}
    phases: dict[str, dict] = {}
    spans: dict[str, dict] = {}
    rounds = {"count": 0, "total_s": 0.0, "bytes_pulled": 0.0,
              "bytes_pushed": 0.0}
    slowest: dict[Any, dict] = {}
    stragglers: dict[Any, dict] = {}
    compile_events: list[dict[str, Any]] = []
    rpc_errors: list[dict[str, Any]] = []
    per_node_snapshots: dict[str, dict[str, dict]] = {}
    alerts: dict[str, dict[str, Any]] = {}
    summary_event: dict[str, Any] | None = None

    for r in records:
        event = r.get("event", "?")
        event_counts[event] = event_counts.get(event, 0) + 1
        if event == "phase":
            _agg(phases, str(r.get("phase", "?")), float(r.get("seconds", 0)))
        elif event == "span":
            name = str(r.get("name", "?"))
            secs = float(r.get("seconds", 0))
            _agg(spans, name, secs)
            if name == "round":
                rounds["count"] += 1
                rounds["total_s"] += secs
                rounds["bytes_pulled"] += float(r.get("bytes_pulled", 0))
                rounds["bytes_pushed"] += float(r.get("bytes_pushed", 0))
                cid = r.get("slowest_client")
                if cid is not None:
                    s = slowest.setdefault(
                        cid, {"rounds_slowest": 0, "max_poll_s": 0.0}
                    )
                    s["rounds_slowest"] += 1
                    s["max_poll_s"] = max(
                        s["max_poll_s"], float(r.get("slowest_s", 0))
                    )
        elif event == "straggler_detected":
            st = stragglers.setdefault(
                r.get("client"), {"count": 0, "max_z": 0.0}
            )
            st["count"] += 1
            st["max_z"] = max(st["max_z"], float(r.get("z", 0.0)))
        elif event == "jit_compile":
            compile_events.append(
                {"what": r.get("what"), "seconds": r.get("seconds")}
            )
        elif event == "rpc" and not r.get("ok", True):
            rpc_errors.append(r)
        elif event == "metrics_snapshot":
            # Registries are cumulative, so — PER NODE — the last snapshot
            # mentioning a metric carries its totals. Keying by name alone
            # would let a multi-node stream's nodes clobber each other
            # (client7's local_step_s overwriting client3's); nodes merge
            # exactly below instead.
            node_snaps = per_node_snapshots.setdefault(
                str(r.get("node") or ""), {}
            )
            for name, snap in (r.get("metrics") or {}).items():
                node_snaps[name] = snap
        elif event in ("alert_pending", "alert_firing", "alert_resolved"):
            state = event[len("alert_"):]
            a = alerts.setdefault(
                str(r.get("alert")),
                {"pending": 0, "firing": 0, "resolved": 0,
                 "last_state": "ok", "metric": r.get("metric")},
            )
            a[state] += 1
            a["last_state"] = state
            if r.get("metric") is not None:
                a["metric"] = r.get("metric")
        elif event == "summary":
            summary_event = {
                k: v for k, v in r.items() if k not in ("event", "time")
            }

    # Fleet totals: counters sum, gauges last-wins, histograms add
    # bucket-wise — the same primitive the live FleetRegistry merge uses,
    # so offline summaries and /metrics can never disagree.
    last_snapshots = merge_node_snapshots(per_node_snapshots)

    step_time = {
        name: _hist_stats(snap)
        for name, snap in last_snapshots.items()
        if snap.get("type") == "histogram" and name.endswith("step_s")
        and snap.get("count")
    }
    rpc = {
        name.split("/", 1)[1]: _hist_stats(snap)
        for name, snap in last_snapshots.items()
        if name.startswith("rpc_s/") and snap.get("count")
    }
    # Every other populated histogram (codec encode/decode seconds, bundle
    # bytes, client poll latency, jit dispatch, ...): no histogram this
    # stream records may be write-only in the summary.
    other_hists = {
        name: _hist_stats(snap)
        for name, snap in last_snapshots.items()
        if snap.get("type") == "histogram" and snap.get("count")
        and not (name.endswith("step_s") or name.startswith("rpc_s/"))
    }
    counters = {
        name: snap["value"] for name, snap in last_snapshots.items()
        if snap.get("type") == "counter"
    }
    gauges = {
        name: snap["value"] for name, snap in last_snapshots.items()
        if snap.get("type") == "gauge"
    }

    return {
        "events_total": len(records),
        "wall_seconds": (max(times) - min(times)) if times else 0.0,
        "event_counts": dict(sorted(event_counts.items())),
        "phases": phases,
        "spans": spans,
        "rounds": rounds,
        "slowest_clients": slowest,
        "stragglers": stragglers,
        "step_time": step_time,
        "rpc": rpc,
        "histograms": other_hists,
        "rpc_errors": len(rpc_errors),
        "counters": counters,
        "gauges": gauges,
        "alerts": alerts,
        "compile": compile_events,
        "summary": summary_event,
        "data_plane": collect_data_plane(records),
    }


def _fmt_s(seconds: float | None) -> str:
    if seconds is None:
        return "-"
    if seconds < 1e-3:
        return f"{seconds * 1e6:.0f} µs"
    if seconds < 1.0:
        return f"{seconds * 1e3:.2f} ms"
    return f"{seconds:.2f} s"


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n:.0f} B"
        n /= 1024
    return f"{n:.1f} GiB"


def format_report(s: dict[str, Any]) -> str:
    """Render a :func:`summarize_metrics` dict as a human-readable report."""
    lines = [
        f"run summary: {s['events_total']} events over "
        f"{s['wall_seconds']:.2f} s wall clock",
    ]

    wall = s["wall_seconds"] or float("inf")
    breakdown = dict(s["phases"])
    for name, g in s["spans"].items():
        breakdown.setdefault(f"span:{name}", g)
    if breakdown:
        lines.append("")
        lines.append("phase breakdown:")
        lines.append(f"  {'phase':<24}{'total':>12}{'count':>8}{'%wall':>8}")
        for name, g in sorted(
            breakdown.items(), key=lambda kv: -kv[1]["total_s"]
        ):
            pct = 100.0 * g["total_s"] / wall if wall else 0.0
            lines.append(
                f"  {name:<24}{_fmt_s(g['total_s']):>12}{g['count']:>8}"
                f"{pct:>7.1f}%"
            )

    if s["step_time"]:
        lines.append("")
        lines.append("step time:")
        lines.append(
            f"  {'source':<24}{'count':>8}{'mean':>12}{'p50':>12}"
            f"{'p95':>12}{'p99':>12}"
        )
        for name, st in sorted(s["step_time"].items()):
            lines.append(
                f"  {name:<24}{st['count']:>8}{_fmt_s(st['mean_s']):>12}"
                f"{_fmt_s(st['p50_s']):>12}{_fmt_s(st['p95_s']):>12}"
                f"{_fmt_s(st['p99_s']):>12}"
            )

    if s["rpc"]:
        lines.append("")
        lines.append("rpc latency:")
        lines.append(
            f"  {'method':<32}{'count':>8}{'mean':>12}{'p50':>12}{'p95':>12}"
        )
        for name, st in sorted(s["rpc"].items()):
            lines.append(
                f"  {name:<32}{st['count']:>8}{_fmt_s(st['mean_s']):>12}"
                f"{_fmt_s(st['p50_s']):>12}{_fmt_s(st['p95_s']):>12}"
            )
        deadline = s["counters"].get("rpc_deadline_expired", 0)
        errors = s["counters"].get("rpc_errors", 0)
        lines.append(
            f"  errors: {errors:.0f} ({deadline:.0f} deadline expiries), "
            f"rpc error events: {s['rpc_errors']}"
        )

    if s.get("histograms"):
        lines.append("")
        lines.append("other distributions (codec, poll, dispatch, ...):")
        lines.append(
            f"  {'name':<32}{'count':>8}{'mean':>12}{'p50':>12}{'p95':>12}"
        )
        for name, st in sorted(s["histograms"].items()):
            fmt = _fmt_bytes if "bytes" in name else _fmt_s
            lines.append(
                f"  {name:<32}{st['count']:>8}{fmt(st['mean_s']):>12}"
                f"{fmt(st['p50_s']):>12}{fmt(st['p95_s']):>12}"
            )

    rounds = s["rounds"]
    if rounds["count"]:
        per = rounds["count"]
        lines.append("")
        lines.append(
            f"federation rounds: {per} "
            f"(mean {_fmt_s(rounds['total_s'] / per)}/round)"
        )
        lines.append(
            f"  bytes moved: {_fmt_bytes(rounds['bytes_pulled'])} pulled, "
            f"{_fmt_bytes(rounds['bytes_pushed'])} pushed "
            f"({_fmt_bytes((rounds['bytes_pulled'] + rounds['bytes_pushed']) / per)}"
            "/round)"
        )
        if s["slowest_clients"]:
            worst = max(
                s["slowest_clients"].items(),
                key=lambda kv: kv[1]["rounds_slowest"],
            )
            lines.append(
                f"  slowest client: {worst[0]} (straggler in "
                f"{worst[1]['rounds_slowest']}/{per} rounds, max poll "
                f"{_fmt_s(worst[1]['max_poll_s'])})"
            )
        for cid, st in sorted(s.get("stragglers", {}).items(),
                              key=lambda kv: -kv[1]["count"]):
            lines.append(
                f"  straggler detected: client {cid} x{st['count']} "
                f"(max z {st['max_z']:.1f})"
            )

    dp = s.get("data_plane") or {}
    if any(dp.get(k) for k in
           ("rejections", "clips", "rollbacks", "quarantines")):
        lines.append("")
        lines.append("data plane (admission gate / guardian):")
        for cid in sorted(
            set(dp.get("rejections", {})) | set(dp.get("clips", {}))
        ):
            by = dp.get("rejections", {}).get(cid, {})
            reasons = ", ".join(
                f"{r}:{n}" for r, n in sorted(by.items())
            ) or "-"
            lines.append(
                f"  client {cid}: {sum(by.values())} rejected ({reasons})"
                f", {dp.get('clips', {}).get(cid, 0)} clipped"
            )
        for rb in dp.get("rollbacks", ()):
            restored = rb.get("restored_round")
            lines.append(
                f"  rollback at round {rb.get('round')} "
                f"({rb.get('reason')}"
                + (f" -> restored round {restored}"
                   if restored is not None else "")
                + ")"
            )
        for cid, n in sorted(dp.get("quarantines", {}).items()):
            lines.append(f"  quarantined: client {cid} x{n}")

    if s.get("alerts"):
        lines.append("")
        lines.append("SLO alerts:")
        for name, a in sorted(s["alerts"].items()):
            metric = f" on {a['metric']}" if a.get("metric") else ""
            lines.append(
                f"  {name}{metric}: fired x{a['firing']} "
                f"(pending x{a['pending']}, resolved x{a['resolved']}), "
                f"last state {a['last_state']}"
            )

    enc = s["counters"].get("codec_encoded_bytes")
    dec = s["counters"].get("codec_decoded_bytes")
    if enc is not None or dec is not None:
        lines.append("")
        lines.append(
            f"codec: {_fmt_bytes(enc or 0)} encoded "
            f"({s['counters'].get('codec_encode_calls', 0):.0f} bundles), "
            f"{_fmt_bytes(dec or 0)} decoded "
            f"({s['counters'].get('codec_decode_calls', 0):.0f} bundles)"
        )

    if s["compile"]:
        lines.append("")
        lines.append("compile capture (first-call trace+compile+run):")
        for c in s["compile"]:
            lines.append(f"  {c['what']}: {_fmt_s(c['seconds'])}")

    if s["summary"]:
        lines.append("")
        lines.append(f"run result: {json.dumps(s['summary'], default=str)}")

    return "\n".join(lines)


def check_monotone_coherence(
    summary: dict[str, Any], tolerance: float
) -> list[str]:
    """CI gate: verify NPMI coherence never drops more than ``tolerance``
    below its running maximum over the quality trajectory. Returns the
    violations (empty = pass) — the ``report`` CLI exits non-zero on any,
    so the scenario harness can gate on model quality, not just on step
    time."""
    violations: list[str] = []
    best: float | None = None
    best_round: int | None = None
    for row in summary.get("quality", ()):
        npmi = row.get("npmi")
        if npmi is None:
            continue
        if best is not None and npmi < best - tolerance:
            violations.append(
                f"round {row['round']}: npmi {npmi:.4f} fell "
                f"{best - npmi:.4f} below the round-{best_round} peak "
                f"{best:.4f} (tolerance {tolerance:g})"
            )
        if best is None or npmi > best:
            best, best_round = npmi, row["round"]
    if not summary.get("quality"):
        violations.append(
            "no quality_computed events in the stream (was the run "
            "launched with --quality_every > 0 and --quality_ref?)"
        )
    elif best is None:
        # Quality rounds exist but NPMI was never computed (no reference
        # corpus): a gate that checked nothing must not report green.
        violations.append(
            "quality rounds carry no NPMI values — coherence was never "
            "measured (was the run launched with --quality_ref?)"
        )
    return violations


def _fmt_opt(value: Any, spec: str = "{:.3f}") -> str:
    return "-" if value is None else spec.format(value)


def format_quality_report(s: dict[str, Any]) -> str:
    """Render a :func:`summarize_model_quality` dict as a human-readable
    round-by-round model-health report."""
    lines: list[str] = []
    quality = s.get("quality") or []
    lines.append(
        f"model-quality report: {len(quality)} quality rounds"
    )

    if quality:
        lines.append("")
        lines.append(
            f"  {'round':>6}{'npmi':>9}{'diversity':>11}{'irbo':>8}"
            f"{'drift':>8}{'max':>8}{'churn':>7}"
        )
        for row in quality:
            lines.append(
                f"  {row['round']:>6}"
                f"{_fmt_opt(row.get('npmi')):>9}"
                f"{_fmt_opt(row.get('diversity')):>11}"
                f"{_fmt_opt(row.get('irbo')):>8}"
                f"{_fmt_opt(row.get('mean_drift')):>8}"
                f"{_fmt_opt(row.get('max_drift')):>8}"
                f"{_fmt_opt(row.get('churn'), '{:d}'):>7}"
            )

    contributions = s.get("contributions") or {}
    dp = s.get("data_plane") or {}
    if contributions or dp.get("rejections"):
        lines.append("")
        lines.append("per-client contributions (EWMA):")
        lines.append(
            f"  {'client':<8}{'cos->agg':>10}{'share':>8}{'rejected':>10}"
            f"{'clipped':>9}{'quarantined':>13}"
        )
        clients = sorted(
            set(contributions) | set(dp.get("rejections", {}))
            | set(dp.get("clips", {})) | set(dp.get("quarantines", {})),
            key=str,
        )
        for cid in clients:
            c = contributions.get(cid, {})
            rejected = sum(dp.get("rejections", {}).get(cid, {}).values())
            lines.append(
                f"  {cid:<8}{_fmt_opt(c.get('cos_ewma')):>10}"
                f"{_fmt_opt(c.get('share_ewma')):>8}"
                f"{rejected:>10}{dp.get('clips', {}).get(cid, 0):>9}"
                f"{dp.get('quarantines', {}).get(cid, 0):>13}"
            )

    pairwise = s.get("pairwise") or {}
    if pairwise.get("cos_mean") is not None:
        lines.append("")
        lines.append(
            f"cohort dispersion: pairwise cosine mean "
            f"{pairwise['cos_mean']:.3f}, min "
            f"{_fmt_opt(pairwise.get('cos_min'))} "
            "(low mean = heterogeneous / non-IID update directions)"
        )

    for rb in dp.get("rollbacks", ()):
        restored = rb.get("restored_round")
        lines.append(
            f"rollback at round {rb.get('round')} ({rb.get('reason')}"
            + (f" -> restored round {restored}"
               if restored is not None else "")
            + ")"
        )

    if s.get("alerts"):
        lines.append("")
        lines.append("SLO alerts:")
        for name, a in sorted(s["alerts"].items()):
            metric = f" on {a['metric']}" if a.get("metric") else ""
            lines.append(
                f"  {name}{metric}: fired x{a['firing']} "
                f"(pending x{a['pending']}, resolved x{a['resolved']}), "
                f"last state {a['last_state']}"
            )

    if s.get("topics"):
        lines.append("")
        lines.append("final topics (top words):")
        for i, words in enumerate(s["topics"]):
            lines.append(f"  topic {i}: {' '.join(words[:10])}")

    privacy = s.get("privacy")
    if privacy:
        lines.append("")
        lines.append(format_privacy_line(privacy))

    return "\n".join(lines)


def format_privacy_line(p: "dict[str, Any]") -> str:
    """One-line rendering of a :func:`summarize_privacy` dict."""
    budget = (
        f"budget {p['budget']:g}"
        + (f", EXCEEDED x{p['exceeded_events']}"
           if p.get("exceeded_events") else "")
        if p.get("budget") else "budget untracked"
    )
    return (
        f"privacy: dp={p['mode']} eps {p['eps']:.4g} at delta "
        f"{p['delta']:g} after {p['steps']} noised round(s) "
        f"(sigma {p['sigma']:g}, {budget})"
    )



# ---- cross-node trace merge (the command line's trace reader) --------------

def _serve_offset_samples(
    records: list[dict[str, Any]], remote: str
) -> list[float]:
    """``recv - send`` deltas of ``serve`` spans received FROM ``remote``:
    each sample is (receiver clock − sender clock) + network latency, so
    the minimum over many samples approaches the clock offset plus the
    latency floor."""
    out = []
    for r in records:
        if (
            r.get("event") == "span" and r.get("name") == "serve"
            and r.get("remote_node") == remote
            and isinstance(r.get("rpc_send_time"), (int, float))
            and isinstance(r.get("rpc_recv_time"), (int, float))
        ):
            out.append(float(r["rpc_recv_time"]) - float(r["rpc_send_time"]))
    return out


def estimate_clock_offset(
    node_records: list[dict[str, Any]],
    ref_records: list[dict[str, Any]],
    node: str, ref: str,
) -> float:
    """Seconds by which ``node``'s wall clock leads the reference's,
    NTP-style from the paired RPC send/recv stamps: with both directions
    available the latency floors cancel (``(min fwd − min rev) / 2``); a
    single direction degrades to the one-way bound."""
    fwd = _serve_offset_samples(node_records, ref)   # offset + latency
    rev = _serve_offset_samples(ref_records, node)   # -offset + latency
    if fwd and rev:
        return (min(fwd) - min(rev)) / 2.0
    if fwd:
        return min(fwd)
    if rev:
        return -min(rev)
    return 0.0


def merge_chrome_trace(
    node_records: dict[str, list[dict[str, Any]]],
    reference: str | None = None,
) -> dict[str, Any]:
    """Merge per-node telemetry streams into one Chrome trace-event JSON
    (load in Perfetto / chrome://tracing).

    One pid per node (the reference — the node owning the ``round`` spans —
    first), one tid per emitting thread, every ``span`` event an ``X``
    slice whose wall-clock start is shifted onto the reference clock by
    :func:`estimate_clock_offset`. ``serve`` spans carrying a
    ``remote_parent_id`` additionally get flow arrows from the sender's
    span, so a round renders as one connected tree across all processes.
    """
    if not node_records:
        raise ValueError("no node records to merge")
    if reference is None or reference not in node_records:
        if reference is not None:
            raise ValueError(
                f"reference node {reference!r} not among "
                f"{sorted(node_records)}"
            )
        reference = next(
            (
                node for node, recs in sorted(node_records.items())
                if any(
                    r.get("event") == "span" and r.get("name") == "round"
                    for r in recs
                )
            ),
            sorted(node_records)[0],
        )

    offsets = {
        node: (
            0.0 if node == reference else estimate_clock_offset(
                recs, node_records[reference], node, reference
            )
        )
        for node, recs in node_records.items()
    }

    # Wall-clock zero: earliest aligned span start across all nodes.
    starts = [
        float(r["time"]) - float(r.get("seconds", 0.0)) - offsets[node]
        for node, recs in node_records.items()
        for r in recs
        if r.get("event") == "span" and isinstance(r.get("time"), (int, float))
    ]
    t0 = min(starts) if starts else 0.0

    order = [reference] + sorted(n for n in node_records if n != reference)
    events: list[dict[str, Any]] = []
    # (node, span_id) -> (pid, tid, start_us) for flow binding
    span_index: dict[tuple[str, int], tuple[int, int, float]] = {}
    flows: list[tuple[str, dict[str, Any], float]] = []

    for pid, node in enumerate(order):
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": node},
        })
        tids: dict[Any, int] = {}
        for r in node_records[node]:
            if r.get("event") != "span":
                continue
            seconds = float(r.get("seconds", 0.0))
            start_us = (
                float(r["time"]) - seconds - offsets[node] - t0
            ) * 1e6
            tid = tids.setdefault(r.get("thread", 0), len(tids))
            args = {
                k: v for k, v in r.items()
                if k not in ("event", "time", "seconds", "thread", "name")
                and v is not None
            }
            events.append({
                "name": str(r.get("name", "span")), "cat": "span",
                "ph": "X", "pid": pid, "tid": tid,
                "ts": round(start_us, 3),
                "dur": round(max(seconds, 1e-6) * 1e6, 3),
                "args": args,
            })
            if isinstance(r.get("span_id"), int):
                span_index[(node, r["span_id"])] = (pid, tid, start_us)
            if (
                r.get("name") == "serve"
                and isinstance(r.get("remote_parent_id"), int)
                and isinstance(r.get("remote_node"), str)
            ):
                flows.append((node, r, start_us))

    flow_id = 0
    for node, r, child_start_us in flows:
        parent = span_index.get((r["remote_node"], r["remote_parent_id"]))
        if parent is None:
            continue
        flow_id += 1
        p_pid, p_tid, p_start_us = parent
        c_pid, c_tid, _ = span_index[(node, r["span_id"])]
        events.append({
            "name": "rpc", "cat": "trace", "ph": "s", "id": flow_id,
            "pid": p_pid, "tid": p_tid,
            "ts": round(max(p_start_us, 0.0) + 0.5, 3),
        })
        events.append({
            "name": "rpc", "cat": "trace", "ph": "f", "bp": "e",
            "id": flow_id, "pid": c_pid, "tid": c_tid,
            "ts": round(child_start_us, 3),
        })

    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "reference": reference,
            "clock_offsets_s": {n: offsets[n] for n in order},
            "epoch_origin_unix_s": t0,
        },
    }

