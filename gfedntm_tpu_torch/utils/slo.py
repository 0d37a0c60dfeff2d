"""Declarative SLOs and a pending → firing → resolved alert state machine.

A copy of ``gfedntm_tpu/utils/slo.py`` (``SLOSpec``, ``load_slo_specs``,
``SLOEngine``, ``evaluate_stream``), kept here so the port never imports
the JAX package; ``tests/test_torch_ops_plane.py`` pins its source to the
original's.

An SLO names an objective over a registry metric in the fleet-merged
snapshot::

    {"name": "serve-p99", "metric": "serve_latency_s", "agg": "p99",
     "op": "<=", "threshold": 0.25, "window_s": 60, "for_s": 10}

``op threshold`` is the objective; an evaluation where it does not hold is
a violation. ``window_s`` evaluates over a trailing window (0: all time),
``for_s`` is the dwell before a violation fires. Aggregations: ``p50``,
``p95``, ``p99``, ``mean`` (histograms), ``value`` (a gauge, or a counter
or histogram count), ``rate`` (needs ``window_s > 0``). The federation
server evaluates the engine once per aggregated round; transitions emit
``alert_pending`` / ``alert_firing`` / ``alert_resolved`` events and are
served live at the ops endpoint's ``/alerts``.
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Any

from gfedntm_tpu_torch.utils import flightrec
from gfedntm_tpu_torch.utils.observability import (
    FleetRegistry,
    MetricsLogger,
    quantile_from_snapshot,
)

__all__ = [
    "SLOSpec",
    "SLOEngine",
    "load_slo_specs",
    "evaluate_stream",
]

_AGGS = ("p50", "p95", "p99", "mean", "value", "rate")
_OPS = {
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


class SLOSpec:
    """One validated SLO: ``name: metric agg op threshold`` over a
    trailing ``window_s`` with a ``for_s`` pending dwell."""

    __slots__ = ("name", "metric", "agg", "op", "threshold", "window_s",
                 "for_s")

    def __init__(self, name: str, metric: str, agg: str, op: str,
                 threshold: float, window_s: float = 0.0,
                 for_s: float = 0.0):
        if not name or not metric:
            raise ValueError("an SLO spec needs a name and a metric")
        if agg not in _AGGS:
            raise ValueError(
                f"SLO {name!r}: agg must be one of {_AGGS}, got {agg!r}"
            )
        if op not in _OPS:
            raise ValueError(
                f"SLO {name!r}: op must be one of {tuple(_OPS)}, got {op!r}"
            )
        if agg == "rate" and not window_s:
            raise ValueError(
                f"SLO {name!r}: agg 'rate' needs window_s > 0 (a rate over "
                "all time is just value/uptime)"
            )
        self.name = str(name)
        self.metric = str(metric)
        self.agg = str(agg)
        self.op = str(op)
        self.threshold = float(threshold)
        self.window_s = float(window_s or 0.0)
        self.for_s = float(for_s or 0.0)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SLOSpec":
        unknown = set(d) - {"name", "metric", "agg", "op", "threshold",
                            "window_s", "for_s"}
        if unknown:
            raise ValueError(
                f"SLO spec {d.get('name', '?')!r}: unknown keys "
                f"{sorted(unknown)}"
            )
        try:
            return cls(
                name=d["name"], metric=d["metric"],
                agg=d.get("agg", "value"), op=d["op"],
                threshold=d["threshold"],
                window_s=d.get("window_s", 0.0), for_s=d.get("for_s", 0.0),
            )
        except KeyError as err:
            raise ValueError(
                f"SLO spec {d.get('name', '?')!r}: missing key {err}"
            )

    def objective(self) -> str:
        win = f" over {self.window_s:g}s" if self.window_s else ""
        return (
            f"{self.agg}({self.metric}){win} {self.op} {self.threshold:g}"
        )


def load_slo_specs(spec: str) -> list[SLOSpec]:
    """Parse ``--slo``: a path to a JSON file, or inline JSON — either a
    list of spec objects or ``{"slos": [...]}``."""
    text = spec
    if os.path.exists(spec):
        with open(spec) as fh:
            text = fh.read()
    try:
        data = json.loads(text)
    except json.JSONDecodeError as err:
        raise ValueError(
            f"--slo is neither an existing file nor valid JSON: {err}"
        )
    if isinstance(data, dict):
        data = data.get("slos", [])
    if not isinstance(data, list):
        raise ValueError("--slo JSON must be a list of specs (or {'slos': "
                         "[...]})")
    return [SLOSpec.from_dict(d) for d in data]


def _window_delta(cur: dict[str, Any], base: dict[str, Any] | None
                  ) -> dict[str, Any]:
    """The histogram observed INSIDE the window: cumulative-at-now minus
    cumulative-at-window-start, bucket-wise (exact for fixed buckets).
    Window min/max are not tracked, so they are synthesized from the
    occupied bucket span — percentile interpolation then clamps to
    bucket resolution, which is the histogram's native precision anyway.
    A negative delta (registry restarted mid-window) falls back to the
    cumulative snapshot."""
    if base is None or base.get("type") != "histogram":
        delta = dict(cur)
    else:
        counts = [a - b for a, b in zip(cur["counts"], base["counts"])]
        count = cur.get("count", 0) - base.get("count", 0)
        if count < 0 or any(c < 0 for c in counts):
            delta = dict(cur)
        else:
            delta = {
                "type": "histogram", "count": count,
                "sum": cur.get("sum", 0.0) - base.get("sum", 0.0),
                "edges": list(cur["edges"]), "counts": counts,
            }
    if delta.get("count") and "min" not in delta:
        edges, counts = delta["edges"], delta["counts"]
        occupied = [i for i, c in enumerate(counts) if c]
        lo_i, hi_i = occupied[0], occupied[-1]
        delta["min"] = edges[lo_i - 1] if lo_i > 0 else 0.0
        delta["max"] = edges[hi_i] if hi_i < len(edges) else edges[-1]
    return delta


class _AlertState:
    __slots__ = ("state", "since", "value", "ever_fired", "history")

    def __init__(self):
        self.state = "ok"  # ok | pending | firing | resolved
        self.since: float | None = None
        self.value: float | None = None
        self.ever_fired = False
        # (time, metric snapshot) baselines for windowed evaluation.
        self.history: deque[tuple[float, dict[str, Any]]] = deque()


class SLOEngine:
    """Evaluates SLO specs against a snapshot source and runs the alert
    state machine. ``snapshot_fn`` returns a metric-name → snapshot dict
    (a single :meth:`MetricRegistry.snapshot`, or the fleet-merged
    :meth:`FleetRegistry.merged` view). Not thread-safe by design: call
    :meth:`evaluate` from the one loop that owns the plane (the pacing
    engine's aggregation tick / the serving watcher); :meth:`status` only
    reads plain attributes and is safe to serve from the ops thread."""

    def __init__(self, specs, snapshot_fn,
                 metrics: MetricsLogger | None = None):
        self.specs = [
            s if isinstance(s, SLOSpec) else SLOSpec.from_dict(s)
            for s in (specs or ())
        ]
        names = [s.name for s in self.specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO spec names in {names}")
        self.snapshot_fn = snapshot_fn
        self.metrics = metrics
        self._alerts = {s.name: _AlertState() for s in self.specs}

    # -- value extraction ----------------------------------------------------

    def _measure(self, spec: SLOSpec, snap: dict[str, Any],
                 st: _AlertState, now: float) -> float | None:
        kind = snap.get("type")
        if spec.window_s > 0:
            # Keep the newest baseline at least window_s old (plus one
            # younger entry so the window never over-stretches once
            # enough history exists).
            st.history.append((now, snap))
            while (len(st.history) > 1
                   and now - st.history[1][0] >= spec.window_s):
                st.history.popleft()
            base_t, base = st.history[0]
        else:
            base_t, base = now, None

        if kind == "gauge":
            return snap.get("value")
        if kind == "counter":
            if spec.agg == "rate":
                dt = now - base_t
                if dt <= 0 or base is None:
                    return None
                return (float(snap.get("value") or 0.0)
                        - float(base.get("value") or 0.0)) / dt
            return float(snap.get("value") or 0.0)
        if kind == "histogram":
            if spec.agg == "rate":
                dt = now - base_t
                if dt <= 0 or base is None:
                    return None
                return (snap.get("count", 0) - base.get("count", 0)) / dt
            window = (
                _window_delta(snap, base) if spec.window_s > 0
                else dict(snap)
            )
            if not window.get("count"):
                return None
            if spec.agg == "mean":
                return window["sum"] / window["count"]
            if spec.agg == "value":
                return float(window["count"])
            q = {"p50": 0.5, "p95": 0.95, "p99": 0.99}[spec.agg]
            return quantile_from_snapshot(window, q)
        return None

    # -- state machine -------------------------------------------------------

    def _fields(self, spec: SLOSpec, st: _AlertState,
                **extra: Any) -> dict[str, Any]:
        fields: dict[str, Any] = dict(
            alert=spec.name, metric=spec.metric,
            threshold=spec.threshold, value=st.value,
            objective=spec.objective(),
        )
        fields.update(extra)
        return fields

    def evaluate(self, now: float | None = None) -> list[dict[str, Any]]:
        """One evaluation pass; returns the transitions that happened
        (``[{"alert", "from", "to"}]``). A missing metric or an empty
        window is "no data", which never fires (and resolves a firing
        alert only when data returns and meets the objective)."""
        if now is None:
            import time as _time

            now = _time.time()
        snapshot = self.snapshot_fn() or {}
        transitions: list[dict[str, Any]] = []
        firing = 0
        for spec in self.specs:
            st = self._alerts[spec.name]
            snap = snapshot.get(spec.metric)
            value = (
                self._measure(spec, snap, st, now)
                if isinstance(snap, dict) else None
            )
            st.value = value
            # Flight-ring breadcrumb (README "Incident forensics"): every
            # evaluated sample, not just transitions — when alert_firing
            # triggers a bundle, the ring shows the measured series
            # walking toward the threshold. No-op without a recorder.
            flightrec.note(
                self.metrics, "slo_eval", alert=spec.name,
                metric=spec.metric, value=value,
                threshold=spec.threshold, state=st.state,
            )
            met = (
                _OPS[spec.op](value, spec.threshold)
                if value is not None else None
            )
            prev = st.state
            if met is False:
                if st.state in ("ok", "resolved"):
                    st.state, st.since = "pending", now
                    if self.metrics is not None:
                        self.metrics.log(
                            "alert_pending", **self._fields(spec, st)
                        )
                if st.state == "pending" and now - st.since >= spec.for_s:
                    pending_s = now - st.since
                    st.state, st.since = "firing", now
                    st.ever_fired = True
                    if self.metrics is not None:
                        self.metrics.log(
                            "alert_firing",
                            **self._fields(spec, st, pending_s=pending_s),
                        )
            elif met is True:  # no data (None) holds the current state
                if st.state == "firing":
                    st.state, st.since = "resolved", now
                    if self.metrics is not None:
                        self.metrics.log(
                            "alert_resolved", **self._fields(spec, st)
                        )
                elif st.state == "pending":
                    # A violation that never dwelt long enough to fire
                    # clears silently — pending is not an alert yet.
                    st.state, st.since = "ok", None
            if st.state == "firing":
                firing += 1
            if st.state != prev:
                transitions.append(
                    {"alert": spec.name, "from": prev, "to": st.state}
                )
        if self.metrics is not None:
            self.metrics.registry.gauge("slo_alerts_firing").set(firing)
        return transitions

    # -- views ---------------------------------------------------------------

    def status(self) -> dict[str, Any]:
        """The live ``/alerts`` view (JSON-ready)."""
        alerts = []
        for spec in self.specs:
            st = self._alerts[spec.name]
            alerts.append({
                "alert": spec.name,
                "objective": spec.objective(),
                "state": st.state,
                "since": st.since,
                "value": st.value,
                "threshold": spec.threshold,
                "ever_fired": st.ever_fired,
            })
        return {
            "alerts": alerts,
            "firing": sum(
                1 for a in self._alerts.values() if a.state == "firing"
            ),
        }

    def ever_fired(self) -> list[str]:
        """Names of the specs that ever reached firing (the CI gate)."""
        return [name for name, st in self._alerts.items() if st.ever_fired]


def evaluate_stream(
    node_records: "dict[str, list[dict[str, Any]]]",
    specs, metrics: MetricsLogger | None = None,
) -> SLOEngine:
    """Offline SLO evaluation: replay each node's ``metrics_snapshot``
    events in global time order through a :class:`FleetRegistry` and the
    SAME :class:`SLOEngine` the live planes run — the ``slo`` CLI
    subcommand's engine. Returns the engine (query :meth:`ever_fired` /
    :meth:`status` for the verdict)."""
    fleet = FleetRegistry(metrics=metrics)
    engine = SLOEngine(specs, snapshot_fn=fleet.merged, metrics=metrics)
    timeline: list[tuple[float, str, dict[str, Any]]] = []
    for node, records in node_records.items():
        for r in records:
            if r.get("event") != "metrics_snapshot":
                continue
            t = r.get("time")
            if not isinstance(t, (int, float)):
                continue
            timeline.append((float(t), str(r.get("node") or node), r))
    timeline.sort(key=lambda item: item[0])
    for t, node, r in timeline:
        fleet.ingest(node, r.get("metrics") or {}, full=True)
        engine.evaluate(now=t)
    return engine
