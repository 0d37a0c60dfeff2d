"""Closed-loop saturating load generator for the serving plane.

A copy of ``gfedntm_tpu/serving/loadgen.py`` (``percentile_ms`` :31,
``ClosedLoopLoadGen`` :38-216), pinned to it by
``tests/test_torch_serving.py``: it uses only numpy and threads.

Closed loop means each of ``concurrency`` workers keeps exactly one
request in flight: send, wait, record, send again. Offered load then
self-adjusts to what the plane sustains — the measured docs/s IS the
saturation throughput at that concurrency, and latency percentiles are
honest (an open-loop generator would queue unboundedly past saturation
and measure its own backlog).

The generator is transport-agnostic: ``infer_fn`` is any callable
``(x_bow) -> (theta, model_round)`` — the in-process batcher
(``lambda x: batcher.submit(x).result()``), a gRPC stub
(:func:`gfedntm_tpu_torch.serving.service.make_infer_stub`), or an HTTP
wrapper. Every observation lands in per-second windows that are ALSO
emitted as ``serve_load_window`` telemetry events, so a load run's series
is reproducible from the JSONL stream alone.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

import numpy as np

__all__ = ["ClosedLoopLoadGen", "percentile_ms"]


def percentile_ms(latencies_s: "list[float]", q: float) -> float | None:
    """The q-quantile (0..1) of a latency sample, in milliseconds."""
    if not latencies_s:
        return None
    return float(np.quantile(np.asarray(latencies_s, np.float64), q) * 1e3)


class ClosedLoopLoadGen:
    """Drive ``infer_fn`` with ``concurrency`` closed-loop workers for
    ``duration_s`` and summarize sustained docs/s + latency percentiles.

    ``make_batch(worker_idx, seq) -> np.ndarray [B, V]`` supplies request
    payloads (defaults to nothing — callers must provide one); results
    are verified row-stochastic-ish (finite, right row count) so a
    serving-plane bug cannot masquerade as throughput. Failures are
    counted, never retried (closed loop: a failed request is a lost
    slot), and the run FAILS its zero-failure acceptance if any request
    errors — the hot-swap contract under test is "no dropped in-flight
    requests".
    """

    def __init__(
        self,
        infer_fn: Callable[[np.ndarray], tuple],
        make_batch: Callable[[int, int], np.ndarray],
        concurrency: int = 4,
        duration_s: float = 10.0,
        metrics=None,
        window_s: float = 1.0,
        min_rounds: int | None = None,
        max_duration_s: float | None = None,
    ):
        """``min_rounds`` makes the run condition-driven: after the
        ``duration_s`` floor, the load stays up until it has observed
        that many DISTINCT model rounds in responses (or
        ``max_duration_s`` elapses, default ``6 * duration_s``). Use it
        for hot-swap acceptance — a fixed wall-clock window races the
        trainer's round rate and the plane's swap cost, both of which
        scale with machine load."""
        if concurrency < 1:
            raise ValueError(f"concurrency must be >= 1, got {concurrency}")
        if min_rounds is not None and min_rounds < 1:
            raise ValueError(f"min_rounds must be >= 1, got {min_rounds}")
        self.infer_fn = infer_fn
        self.make_batch = make_batch
        self.concurrency = int(concurrency)
        self.duration_s = float(duration_s)
        self.metrics = metrics
        self.window_s = float(window_s)
        self.min_rounds = None if min_rounds is None else int(min_rounds)
        self.max_duration_s = float(
            max_duration_s if max_duration_s is not None
            else 6.0 * self.duration_s
        )
        self._lock = threading.Lock()
        self._latencies: list[float] = []
        self._failures: list[str] = []
        self._docs = 0
        self._requests = 0
        self._rounds_seen: set[int] = set()
        # (t_rel_window_end, docs, requests, failures, [latencies])
        self._windows: dict[int, dict[str, Any]] = {}

    # ---- worker ------------------------------------------------------------
    def _worker(self, idx: int, t_start: float, stop: threading.Event):
        seq = 0
        while not stop.is_set():
            x = self.make_batch(idx, seq)
            seq += 1
            t0 = time.perf_counter()
            try:
                theta, model_round = self.infer_fn(x)
            except Exception as err:
                with self._lock:
                    self._failures.append(f"{type(err).__name__}: {err}")
                    self._bump_window(t_start, failed=True)
                continue
            dt = time.perf_counter() - t0
            theta = np.asarray(theta)
            ok = (
                theta.shape[0] == x.shape[0]
                and np.isfinite(theta).all()
            )
            with self._lock:
                if not ok:
                    self._failures.append(
                        f"bad theta shape/values {theta.shape}"
                    )
                    self._bump_window(t_start, failed=True)
                    continue
                self._latencies.append(dt)
                self._docs += x.shape[0]
                self._requests += 1
                self._rounds_seen.add(int(model_round))
                self._bump_window(
                    t_start, docs=x.shape[0], latency=dt,
                )

    def _bump_window(
        self, t_start: float, docs: int = 0,
        latency: float | None = None, failed: bool = False,
    ) -> None:
        """Fold one completed call into its per-second window (caller
        holds the lock)."""
        w = int((time.perf_counter() - t_start) / self.window_s)
        win = self._windows.setdefault(
            w, {"docs": 0, "requests": 0, "failures": 0, "latencies": []},
        )
        win["docs"] += docs
        win["requests"] += 0 if failed else 1
        win["failures"] += 1 if failed else 0
        if latency is not None:
            win["latencies"].append(latency)

    # ---- run ---------------------------------------------------------------
    def run(self) -> dict[str, Any]:
        """Run the closed loop and return the summary dict (the
        BENCH_SERVE building block)."""
        stop = threading.Event()
        t_start = time.perf_counter()
        workers = [
            threading.Thread(
                target=self._worker, args=(i, t_start, stop),
                name=f"loadgen-{i}", daemon=True,
            )
            for i in range(self.concurrency)
        ]
        for w in workers:
            w.start()
        time.sleep(self.duration_s)
        if self.min_rounds is not None:
            hard = t_start + self.max_duration_s
            while time.perf_counter() < hard:
                with self._lock:
                    if len(self._rounds_seen) >= self.min_rounds:
                        break
                time.sleep(min(0.25, self.window_s))
        stop.set()
        for w in workers:
            w.join(timeout=60.0)
        wall = time.perf_counter() - t_start
        return self._summarize(wall)

    def _summarize(self, wall_s: float) -> dict[str, Any]:
        with self._lock:
            latencies = list(self._latencies)
            failures = list(self._failures)
            docs, requests = self._docs, self._requests
            rounds = sorted(self._rounds_seen)
            windows = {k: dict(v) for k, v in sorted(self._windows.items())}
        series = []
        for w, win in windows.items():
            lats = win.pop("latencies")
            row = {
                "t_s": round((w + 1) * self.window_s, 3),
                **win,
                "docs_per_s": win["docs"] / self.window_s,
                "p50_ms": percentile_ms(lats, 0.50),
                "p99_ms": percentile_ms(lats, 0.99),
            }
            series.append(row)
            if self.metrics is not None:
                self.metrics.log(
                    "serve_load_window", seconds=self.window_s,
                    docs=row["docs"], requests=row["requests"],
                    failures=row["failures"],
                    docs_per_s=row["docs_per_s"],
                    p50_ms=row["p50_ms"], p99_ms=row["p99_ms"],
                    t_s=row["t_s"],
                )
        return {
            "concurrency": self.concurrency,
            "duration_s": round(wall_s, 3),
            "requests": requests,
            "docs": docs,
            "failures": len(failures),
            "failure_samples": failures[:5],
            "docs_per_s": docs / wall_s if wall_s > 0 else 0.0,
            "qps": requests / wall_s if wall_s > 0 else 0.0,
            "p50_ms": percentile_ms(latencies, 0.50),
            "p95_ms": percentile_ms(latencies, 0.95),
            "p99_ms": percentile_ms(latencies, 0.99),
            "model_rounds_seen": rounds,
            "swaps_observed": max(0, len(rounds) - 1),
            "series": series,
        }
