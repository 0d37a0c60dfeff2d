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
  ``keep_records``, ``node``, ``events``, ``snapshot_registry``; without the
  flight-recorder tap, ``sync`` and the trace identity of spans, which
  belong to the server;
- :func:`phase_timer` (:894-906) and :func:`read_metrics` (:1473).

Spans, tracing, fleet telemetry and Prometheus come with the server.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import threading
import time
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
    """

    def __init__(self, path: str | None = None, validate: bool = False,
                 mode: str = "a", keep_records: bool | None = None,
                 node: str | None = None):
        self.path = path
        self.validate = validate
        self.node = node
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
        return record

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
