"""Summarize a ``torch.profiler`` Chrome trace: where does the step time go?

The twin of ``experiments_scripts/analyze_trace.py``, which reads a
``jax.profiler`` trace. This reads the Chrome trace a ``torch.profiler``
run exports: ``trace.<pid>.pt.trace.json`` from
:func:`gfedntm_tpu_torch.utils.observability.trace` (the command line's
``--profile_dir``), or a ``RoundProfiler`` window. It aggregates wall time by
event name, the device's activity (CUDA kernels, copies and memsets:
events of category ``kernel``, ``gpu_memcpy``, ``gpu_memset``) apart from
the host threads' (operators, runtime calls, annotations), so the top
entries answer "launch overhead or math?" directly. The device's busy
milliseconds are the union of its events' intervals (streams overlap), and
its busy share is that over the trace's span. It touches no device.

Run: python -m gfedntm_tpu_torch.experiments_scripts.analyze_trace
<trace_dir or file> [top_n]
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import sys

#: Chrome-trace categories of the device's own activity. ``gpu_user_annotation``
#: ranges span kernels already counted, so they are left out.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: Process names of device streams, for traces without categories.
DEVICE_PROCESS_WORDS = ("gpu", "stream", "cuda", "/device")


def load_events(trace: str) -> tuple[list[dict], dict]:
    """The events of the largest trace file under ``trace`` (or ``trace``
    itself, a file), and ``{pid: process name}``."""
    if os.path.isfile(trace):
        path = trace
    else:
        paths = [p for pattern in ("*.trace.json.gz", "*.trace.json", "*.json")
                 for p in glob.glob(os.path.join(trace, "**", pattern), recursive=True)]
        if not paths:
            raise SystemExit(f"no trace files under {trace}")
        path = max(paths, key=os.path.getsize)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    pids = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pids[e["pid"]] = str(e.get("args", {}).get("name", e["pid"]))
    return events, pids


def bucket_of(event: dict, pids: dict) -> str | None:
    """``"device"``, ``"host"``, or ``None`` for an annotation range of the
    device timeline."""
    cat = event.get("cat")
    if cat == "gpu_user_annotation":
        return None
    if cat is not None:
        return "device" if cat in DEVICE_CATEGORIES else "host"
    name = pids.get(event.get("pid"), "?").lower()
    return "device" if any(w in name for w in DEVICE_PROCESS_WORDS) else "host"


def union_ms(intervals: list) -> float:
    """Milliseconds covered by ``(start_us, end_us)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1e3


def summarize(trace: str, top_n: int = 20) -> dict:
    events, pids = load_events(trace)
    by_bucket: dict[str, collections.Counter] = collections.defaultdict(collections.Counter)
    device_spans = []
    span = [float("inf"), float("-inf")]
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        bucket = bucket_of(e, pids)
        ts, dur = float(e.get("ts", 0.0)), float(e["dur"])
        span[0], span[1] = min(span[0], ts), max(span[1], ts + dur)
        if bucket is None:
            continue
        by_bucket[bucket][e.get("name", "?")] += dur
        if bucket == "device":
            device_spans.append((ts, ts + dur))
    wall_ms = max(span[1] - span[0], 0.0) / 1e3 if device_spans or by_bucket else 0.0
    out = {
        "trace": trace,
        "wall_span_ms": round(wall_ms, 3),
        "processes": sorted(set(pids.values())),
        "device_busy_ms": round(union_ms(device_spans), 3),
        "device_busy_share": (round(union_ms(device_spans) / wall_ms, 4) if wall_ms else None),
    }
    for bucket, counter in sorted(by_bucket.items()):
        total = sum(counter.values())
        out[bucket] = {
            "total_ms": round(total / 1e3, 3),
            "top": [
                {"name": n[:120], "ms": round(d / 1e3, 3),
                 "pct": round(100.0 * d / max(total, 1), 1)}
                for n, d in counter.most_common(top_n)
            ],
        }
    return out


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or len(argv) > 2:
        print("usage: python -m gfedntm_tpu_torch.experiments_scripts.analyze_trace "
              "<trace_dir or file> [top_n]", file=sys.stderr)
        return 2
    top_n = int(argv[1]) if len(argv) > 1 else 20
    print(json.dumps(summarize(argv[0], top_n), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
