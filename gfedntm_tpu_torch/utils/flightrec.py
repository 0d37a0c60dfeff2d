"""Flight recorder & incident forensics (README "Incident forensics").

A copy of ``gfedntm_tpu/utils/flightrec.py`` (numpy, grpc and the
standard library only), its imports rewritten to ``gfedntm_tpu_torch``; the
rest is the original's, so both packages speak the same wire
(``tests/test_torch_federation_codec.py`` holds it to the original).

The JSONL telemetry stream is deliberately lossy: per-request successes
aggregate into histograms, gate verdicts surface only as rejections,
retry/backoff decisions never leave the process. That is the right
trade at 10^3-10^4 clients — and exactly wrong in the minutes before an
incident, when an operator needs the full-fidelity sequence of events
that led in. This module closes the detect->explain loop:

- :class:`FlightRecorder` — a bounded, lock-guarded ring (entry- AND
  time-capped, O(1) append) that taps every record the node's
  :class:`~gfedntm_tpu_torch.utils.observability.MetricsLogger` emits plus
  fine-grained :func:`note` context the stream drops (per-RPC retry
  decisions, per-client gate verdicts, pacing deadline math), with
  periodic registry snapshots so EWMA/counter state rides along.
- :class:`IncidentTrigger` — the one seam every existing detector fires
  through: when a trigger event (see :data:`TRIGGER_EVENTS`) passes the
  logger, the ring + ``/status`` + process self-metrics + faulthandler
  thread stacks are snapshotted into an ATOMIC on-disk bundle
  (:func:`~gfedntm_tpu_torch.train.checkpoint.atomic_write_bytes`), debounced
  per reason so an alert storm yields one bundle, with oldest-first
  eviction bounding the incident directory.
- remote-capture helpers (:func:`build_remote_snapshot`,
  :func:`encode_bundles` / :func:`decode_bundles`) — the wire format for
  server-solicited flight-record pulls that ride the next RPC exchange
  (best-effort, loss-tolerant, relay pre-bundled to O(relays) upstream
  cost; README "Incident forensics", remote-capture notes).

Recorder absent (``--dump_dir`` unset) is the contract default: nothing
is constructed, the logger tap is a single attribute check, and the
JSONL stream is bitwise identical to a recorder-less run.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import zlib
from typing import Any, Callable

#: Bundle file schema version (bumped on incompatible layout changes;
#: the `incident` CLI refuses versions it does not know).
BUNDLE_SCHEMA = 1

#: Prefix every bundle file name carries — the eviction scan, the
#: `incident` CLI, and the --assert-no-incidents gate all key on it.
BUNDLE_PREFIX = "inc-"

#: Trigger event -> incident reason: the detectors already built (SLO
#: alerting, divergence guardian, probation/quarantine, crash
#: autorecovery, privacy accountant, serving admission, chaos injection)
#: all announce through schema'd events on the node's logger, so ONE
#: tap on the logger is the whole wiring. ``incident_captured`` itself
#: is deliberately absent (no self-triggering), and ``client_suspect``
#: is included because a dead relay surfaces at the root only as its
#: member record entering probation.
TRIGGER_EVENTS: dict[str, str] = {
    "alert_firing": "slo_alert",
    "divergence_rollback": "divergence_rollback",
    "client_quarantined": "quarantine",
    "client_suspect": "client_suspect",
    "server_recovered": "autorecovery",
    "relay_recovered": "autorecovery",
    "privacy_budget_exceeded": "privacy_budget",
    "serve_swap_refused": "swap_refused",
    "serve_shed": "shed_storm",
    "partition_injected": "chaos",
}


def note(metrics: Any, kind: str, **fields: Any) -> None:
    """Record fine-grained context into ``metrics``' flight ring, if one
    is attached — a single ``getattr`` when there is none, so hot paths
    (retry loops, gate verdicts, pacing math) can call this
    unconditionally without measurable cost when forensics is off."""
    recorder = getattr(metrics, "recorder", None)
    if recorder is not None:
        recorder.note(kind, **fields)


class FlightRecorder:
    """Bounded ring of recent full-fidelity records for one node.

    Entry-capped by ``max_entries`` (deque maxlen — O(1) append) and
    time-capped by ``max_seconds`` (stale head records are pruned on
    append/snapshot). Two record shapes share the ring: logger event
    records (tapped verbatim from :meth:`MetricsLogger.log`, keyed by
    ``event``) and :meth:`note` records (keyed by ``kind``); both carry
    ``time``. When a ``registry`` is given, a snapshot of it is folded
    into the ring every ``snapshot_every_s`` so the EWMA/counter state
    leading into an incident is preserved too.
    """

    def __init__(self, max_entries: int = 2048, max_seconds: float = 300.0,
                 registry: Any = None, snapshot_every_s: float = 10.0):
        if max_entries <= 0:
            raise ValueError(f"max_entries must be positive: {max_entries}")
        self.max_entries = int(max_entries)
        self.max_seconds = float(max_seconds)
        self.registry = registry
        self.snapshot_every_s = float(snapshot_every_s)
        self.trigger: "IncidentTrigger | None" = None
        self._ring: collections.deque = collections.deque(
            maxlen=self.max_entries
        )
        self._lock = threading.Lock()
        self._last_registry_snap = 0.0
        self.dropped = 0  # entries evicted by the caps (observability)

    # -- append paths ------------------------------------------------------

    def observe(self, record: dict[str, Any]) -> None:
        """Logger tap: ring every emitted event record (pre-sampling,
        full fidelity), then give the trigger seam a look at it."""
        self._append(record)
        trigger = self.trigger
        if trigger is not None:
            trigger.maybe_trigger(record)

    def note(self, kind: str, **fields: Any) -> None:
        """Ring a fine-grained record the JSONL stream drops (retry
        decisions, gate verdicts, pacing math, RPC outcomes)."""
        self._append({"kind": kind, "time": time.time(), **fields})

    def _append(self, record: dict[str, Any]) -> None:
        now = time.time()
        with self._lock:
            if len(self._ring) == self.max_entries:
                self.dropped += 1
            self._ring.append(record)
            self._prune(now)
            reg = self.registry
            if (
                reg is not None
                and now - self._last_registry_snap >= self.snapshot_every_s
            ):
                # Stamp BEFORE snapshotting: a slow snapshot must not
                # re-arm itself for every queued append behind the lock.
                self._last_registry_snap = now
                try:
                    snap = reg.snapshot()
                except Exception:
                    snap = None
                if snap:
                    self._ring.append({
                        "kind": "registry_snapshot", "time": now,
                        "metrics": snap,
                    })

    def _prune(self, now: float) -> None:
        horizon = now - self.max_seconds
        ring = self._ring
        while ring and float(ring[0].get("time", now)) < horizon:
            ring.popleft()
            self.dropped += 1

    # -- read side ---------------------------------------------------------

    def snapshot(self) -> list[dict[str, Any]]:
        """Copy of the ring, oldest first, stale head pruned."""
        with self._lock:
            self._prune(time.time())
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


def _process_info() -> dict[str, Any]:
    """Cheap process self-metrics for a bundle (no psutil in the image:
    /proc + os.times cover what a postmortem needs)."""
    info: dict[str, Any] = {
        "pid": os.getpid(),
        "threads": threading.active_count(),
    }
    try:
        t = os.times()
        info["cpu_user_s"] = t.user
        info["cpu_system_s"] = t.system
    except Exception:
        pass
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith(("VmRSS:", "VmHWM:", "Threads:")):
                    key, _, value = line.partition(":")
                    info[key.strip().lower()] = value.strip()
    except OSError:
        pass
    return info


def _thread_stacks() -> str:
    """Every thread's current stack, via faulthandler (needs a real fd —
    a TemporaryFile, not StringIO), degrading to the pure-Python
    traceback walk if faulthandler is unavailable."""
    try:
        import faulthandler
        import tempfile

        with tempfile.TemporaryFile(mode="w+") as fh:
            faulthandler.dump_traceback(file=fh, all_threads=True)
            fh.seek(0)
            return fh.read()
    except Exception:
        import sys
        import traceback

        chunks = []
        for tid, frame in sys._current_frames().items():
            chunks.append(f"Thread {tid}:\n")
            chunks.extend(traceback.format_stack(frame))
        return "".join(chunks)


def bundle_filename(incident_id: str, node: str) -> str:
    """Canonical on-disk name: ``inc-<id>__<node>.json`` — the double
    underscore separates the CLI's (incident, node) grouping keys."""
    safe_node = "".join(
        c if c.isalnum() or c in "-." else "_" for c in (node or "unknown")
    )
    safe_id = "".join(
        c if c.isalnum() or c in "-." else "_" for c in incident_id
    )
    return f"{BUNDLE_PREFIX}{safe_id}__{safe_node}.json"


class IncidentTrigger:
    """The one trigger-driven dump seam for a node.

    Watches the logger tap for :data:`TRIGGER_EVENTS`, debounces per
    reason (an alert storm yields one bundle, with a suppressed count),
    and atomically writes an incident bundle: the flight ring, the
    node's ``/status`` payload (via ``status_cb``), process
    self-metrics, and faulthandler thread stacks. The on-disk incident
    directory is bounded (``max_bundles``, oldest evicted first). The
    JSONL stream is flushed AND fsynced around the dump
    (:meth:`MetricsLogger.sync`) so the stream on disk is consistent
    with every captured bundle — the crash-durability contract the
    postmortem merge depends on.

    ``on_capture(incident_id, reason, trigger_record)`` is the server's
    remote-solicitation hook; leaf nodes leave it unset.
    """

    def __init__(self, recorder: FlightRecorder, dump_dir: str,
                 metrics: Any = None, node: str | None = None,
                 status_cb: Callable[[], dict] | None = None,
                 debounce_s: float = 30.0, max_bundles: int = 32,
                 on_capture: Callable[[str, str, dict], None] | None = None):
        self.recorder = recorder
        self.dump_dir = dump_dir
        self.metrics = metrics
        self.node = node or (getattr(metrics, "node", None) or "unknown")
        self.status_cb = status_cb
        self.debounce_s = float(debounce_s)
        self.max_bundles = int(max_bundles)
        self.on_capture = on_capture
        self._lock = threading.Lock()
        self._last_by_reason: dict[str, float] = {}
        self._suppressed: dict[str, int] = {}
        self._capturing = threading.local()
        os.makedirs(dump_dir, exist_ok=True)
        recorder.trigger = self

    def maybe_trigger(self, record: dict[str, Any]) -> "str | None":
        """Logger-tap entry: capture iff ``record`` is a trigger event
        outside its reason's debounce window. Returns the bundle path
        when one was written."""
        reason = TRIGGER_EVENTS.get(record.get("event"))
        if reason is None:
            return None
        if getattr(self._capturing, "active", False):
            # A capture's own emissions (incident_captured, sync
            # side-effects) must never recurse into another capture.
            return None
        now = time.time()
        with self._lock:
            last = self._last_by_reason.get(reason)
            if last is not None and now - last < self.debounce_s:
                self._suppressed[reason] = (
                    self._suppressed.get(reason, 0) + 1
                )
                return None
            self._last_by_reason[reason] = now
        return self.capture(reason, trigger_record=record)

    def capture(self, reason: str, trigger_record: dict | None = None,
                incident_id: str | None = None) -> str:
        """Snapshot everything into one atomic bundle file; returns its
        path. Never raises into the emitting hot path — a forensics
        failure must not take down the plane it is explaining."""
        from gfedntm_tpu_torch.train.checkpoint import atomic_write_bytes

        self._capturing.active = True
        try:
            now = time.time()
            if incident_id is None:
                incident_id = f"{int(now * 1000):x}-{reason}"
            status = None
            if self.status_cb is not None:
                try:
                    status = self.status_cb()
                except Exception:
                    status = None
            with self._lock:
                suppressed = dict(self._suppressed)
            bundle = {
                "schema": BUNDLE_SCHEMA,
                "incident_id": incident_id,
                "node": self.node,
                "reason": reason,
                "time": now,
                "trigger": trigger_record,
                "ring": self.recorder.snapshot(),
                "ring_dropped": self.recorder.dropped,
                "suppressed": suppressed,
                "status": status,
                "process": _process_info(),
                "stacks": _thread_stacks(),
            }
            path = os.path.join(
                self.dump_dir, bundle_filename(incident_id, self.node)
            )
            # Stream-before-bundle ordering: everything the ring holds is
            # durably on disk before (and after) the bundle referencing it.
            self._sync_stream()
            self._evict()
            atomic_write_bytes(
                path, json.dumps(bundle, default=str).encode("utf-8")
            )
            if self.metrics is not None:
                self.metrics.log(
                    "incident_captured", reason=reason,
                    incident_id=incident_id, records=len(bundle["ring"]),
                    path=path,
                )
            self._sync_stream()
            if self.on_capture is not None:
                try:
                    self.on_capture(incident_id, reason, trigger_record or {})
                except Exception:
                    pass
            return path
        finally:
            self._capturing.active = False

    def ingest_remote(self, blob: bytes) -> list[str]:
        """Server-side landing zone for solicited remote snapshots: each
        decoded node bundle becomes its own file in the same incident
        dir (grouped with the local bundle by incident id), deduplicated
        by filename — re-shipped blobs from retried RPCs are free."""
        try:
            bundles = decode_bundles(blob)
        except Exception:
            return []
        written: list[str] = []
        from gfedntm_tpu_torch.train.checkpoint import atomic_write_bytes

        for bundle in bundles:
            if not isinstance(bundle, dict):
                continue
            incident_id = str(bundle.get("incident_id") or "unknown")
            node = str(bundle.get("node") or "unknown")
            path = os.path.join(
                self.dump_dir, bundle_filename(incident_id, node)
            )
            if os.path.exists(path):
                continue
            self._evict()
            try:
                atomic_write_bytes(
                    path, json.dumps(bundle, default=str).encode("utf-8")
                )
            except OSError:
                continue
            written.append(path)
            if self.metrics is not None:
                self.metrics.log(
                    "flightrec_received", incident_id=incident_id,
                    node=node,
                )
        return written

    def _sync_stream(self) -> None:
        sync = getattr(self.metrics, "sync", None)
        if sync is not None:
            try:
                sync()
            except Exception:
                pass

    def _evict(self) -> None:
        """Keep the incident dir bounded: oldest bundles leave first
        (mtime order), leaving room for one incoming bundle."""
        try:
            names = [
                n for n in os.listdir(self.dump_dir)
                if n.startswith(BUNDLE_PREFIX) and n.endswith(".json")
            ]
        except OSError:
            return
        if len(names) < self.max_bundles:
            return
        def mtime(name: str) -> float:
            try:
                return os.path.getmtime(os.path.join(self.dump_dir, name))
            except OSError:
                return 0.0
        for name in sorted(names, key=mtime)[: len(names) - self.max_bundles + 1]:
            try:
                os.remove(os.path.join(self.dump_dir, name))
            except OSError:
                pass


# ---- remote-capture wire format ---------------------------------------------

def encode_bundles(bundles: list[dict[str, Any]]) -> bytes:
    """zlib-compressed JSON list of node bundles — the
    ``StepReply.flightrec`` payload. Always a LIST so a relay can
    pre-bundle its members' snapshots with its own into one upstream
    blob (O(relays) root-side cost)."""
    return zlib.compress(json.dumps(bundles, default=str).encode("utf-8"))


def decode_bundles(blob: bytes) -> list[dict[str, Any]]:
    out = json.loads(zlib.decompress(blob).decode("utf-8"))
    if not isinstance(out, list):
        raise ValueError("flightrec blob must decode to a list of bundles")
    return out


def build_remote_snapshot(metrics: Any, incident_id: str) -> "bytes | None":
    """A leaf node's answer to a solicited capture: its ring (plus
    process self-metrics) as a one-element encoded bundle list, or
    ``None`` when no recorder is attached (best-effort — the server
    merges whatever arrives)."""
    recorder = getattr(metrics, "recorder", None)
    if recorder is None:
        return None
    bundle = {
        "schema": BUNDLE_SCHEMA,
        "incident_id": incident_id,
        "node": getattr(metrics, "node", None) or "unknown",
        "reason": "remote_capture",
        "time": time.time(),
        "trigger": None,
        "ring": recorder.snapshot(),
        "ring_dropped": recorder.dropped,
        "process": _process_info(),
    }
    return encode_bundles([bundle])
