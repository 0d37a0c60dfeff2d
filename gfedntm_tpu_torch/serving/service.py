"""The serving plane's request path: coalescing batcher, gRPC/HTTP
servicers, model watcher, and the :class:`ServingPlane` process wrapper.

Counterpart of ``gfedntm_tpu/serving/service.py``: the same classes over
the port's codec, protos, rpc, ``OpsServer``, ``SLOEngine``, ``flightrec``
and ``vectorize``, with the same status codes. :class:`ServingPlane` takes a
``device`` for its engine (``None`` is the GPU, and raises without CUDA).

Request flow::

    gRPC Infer / HTTP POST /infer
        └─> Batcher.submit(rows)          # returns a Future
              └─> worker thread coalesces pending requests into one
                  bucket-padded micro-batch
                    └─> ServingEngine.infer (slot-pinned)
              <─ per-request θ slices fulfil the Futures

Coalescing is what turns many small user requests into the few padded
shapes the engine runs: the worker drains whatever is queued the
moment it goes idle (up to ``max_batch`` docs, with a tiny linger so
concurrent callers can pile on), so under closed-loop load the batch
size tracks the offered concurrency — the ``serving_batch_fill`` gauge
tells you how full the buckets run.

Hot-swap safety: the batcher holds NO model state — every micro-batch
pins the engine slot for its own duration, so the watcher thread can
swap models at any moment without a dropped or torn request. In-flight
futures complete against the slot their batch started with.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable

import numpy as np

from gfedntm_tpu_torch.serving.engine import ModelSource, ServingEngine
from gfedntm_tpu_torch.utils.observability import span

__all__ = ["Batcher", "InferenceServicer", "QueueFullError", "ServingPlane"]


class QueueFullError(RuntimeError):
    """The batcher's pending queue is at its ``max_queue`` doc bound:
    the ARRIVING request is shed (gRPC ``RESOURCE_EXHAUSTED``, HTTP
    429) so queue depth and tail latency stay bounded under sustained
    overload — queued and in-flight requests are never dropped."""


class _Pending:
    __slots__ = ("x_bow", "future", "t_submit")

    def __init__(self, x_bow: np.ndarray):
        self.x_bow = x_bow
        self.future: "Future[tuple[np.ndarray, int]]" = Future()
        self.t_submit = time.perf_counter()


class Batcher:
    """Micro-batch coalescing in front of a :class:`ServingEngine`.

    One worker thread drains the pending queue into engine batches of up
    to ``max_batch`` docs. ``linger_s`` bounds how long the FIRST queued
    request may wait for company once the worker is idle (0 = dispatch
    immediately; a couple ms trades that latency for fuller buckets).
    Requests are never split below request granularity — a request's rows
    always travel in one micro-batch, so its future resolves exactly
    once.
    """

    def __init__(
        self,
        engine: ServingEngine,
        linger_s: float = 0.002,
        metrics=None,
        logger: logging.Logger | None = None,
        max_queue: int = 0,
    ):
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        self.engine = engine
        self.linger_s = float(linger_s)
        self.metrics = metrics
        self.logger = logger or logging.getLogger("Batcher")
        # Load shedding (README "Serving"): bound on PENDING DOCS (not
        # requests — requests vary in width). 0 = unbounded, the
        # historical behavior. When an arrival would push the pending
        # total past the bound it is shed alone via QueueFullError.
        self.max_queue = int(max_queue)
        # The bound applies against a NON-EMPTY backlog: a lone request
        # on an idle queue is always admitted, so a request wider than
        # max_queue (but within max_batch) is servable rather than shed
        # with a "retry later" that could never succeed.
        self._queued_docs = 0  # guarded-by: _cond
        self._queue: "collections.deque[_Pending]" = collections.deque()
        self._cond = threading.Condition()
        self._stopping = False
        self._thread: threading.Thread | None = None
        # Rolling (timestamp, docs, requests) window for the live QPS /
        # docs-per-s gauges — counters alone need two scrapes to rate.
        self._window: "collections.deque[tuple[float, int, int]]" = (
            collections.deque()
        )

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stopping = False
        self._thread = threading.Thread(
            target=self._run, name="serve-batcher", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        # Drain anything still queued: a stopping plane must FAIL pending
        # requests loudly, not leave callers blocked on forever-futures.
        with self._cond:
            pending = list(self._queue)
            self._queue.clear()
            self._queued_docs = 0
        for p in pending:
            p.future.set_exception(RuntimeError("serving plane stopped"))

    def submit(self, x_bow: np.ndarray) -> "Future[tuple[np.ndarray, int]]":
        """Enqueue one request batch; the future resolves to
        ``(theta, model_round)``."""
        x_bow = np.asarray(x_bow, np.float32)
        if x_bow.ndim != 2 or x_bow.shape[0] < 1:
            raise ValueError(
                f"request must be a non-empty [B, V] batch, got "
                f"{x_bow.shape}"
            )
        if x_bow.shape[0] > self.engine.max_batch:
            raise ValueError(
                f"request of {x_bow.shape[0]} docs exceeds max_batch "
                f"{self.engine.max_batch}; split client-side"
            )
        vocab = self.engine.vocab
        if vocab is not None and x_bow.shape[1] != len(vocab):
            # Reject a wrong-width request HERE, alone — coalesced into a
            # micro-batch it would fail the np.concatenate and poison
            # every co-batched request's future.
            raise ValueError(
                f"request has vocab width {x_bow.shape[1]}, the serving "
                f"model expects {len(vocab)}"
            )
        p = _Pending(x_bow)
        docs = int(x_bow.shape[0])
        with self._cond:
            if self._stopping:
                raise RuntimeError("serving plane is stopping")
            if (
                self.max_queue
                and self._queued_docs > 0
                and self._queued_docs + docs > self.max_queue
            ):
                queued = self._queued_docs
                if self.metrics is not None:
                    self.metrics.registry.counter(
                        "serving_requests_shed"
                    ).inc()
                    self.metrics.log(
                        "serve_shed", docs=docs, queued=queued,
                        max_queue=self.max_queue,
                    )
                raise QueueFullError(
                    f"serving queue full ({queued}/{self.max_queue} "
                    f"docs pending); retry later"
                )
            self._queue.append(p)
            self._queued_docs += docs
            if self.metrics is not None:
                self.metrics.registry.gauge("serving_queue_depth").set(
                    self._queued_docs
                )
            self._cond.notify()
        return p.future

    # ---- worker ------------------------------------------------------------
    def _take_batch(self) -> list[_Pending]:
        """Block for the first pending request, linger briefly for more,
        then take the largest prefix that fits one engine batch."""
        with self._cond:
            while not self._queue and not self._stopping:
                self._cond.wait(timeout=0.5)
            if self._stopping:
                return []
            if self.linger_s > 0 and len(self._queue) == 1:
                self._cond.wait(timeout=self.linger_s)
            batch: list[_Pending] = []
            docs = 0
            while self._queue:
                nxt = self._queue[0]
                if batch and (
                    docs + nxt.x_bow.shape[0] > self.engine.max_batch
                    # Only same-width requests coalesce: a width change
                    # between submit-time validation and dispatch (hot
                    # swap to a different vocabulary, or pre-load mixed
                    # widths) must fail ITS batch, never poison
                    # co-batched requests via the concatenate.
                    or nxt.x_bow.shape[1] != batch[0].x_bow.shape[1]
                ):
                    break
                batch.append(self._queue.popleft())
                docs += nxt.x_bow.shape[0]
            self._queued_docs -= docs
            if self.metrics is not None:
                self.metrics.registry.gauge("serving_queue_depth").set(
                    self._queued_docs
                )
            return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                if self._stopping:
                    return
                continue
            try:
                x = (
                    batch[0].x_bow if len(batch) == 1
                    else np.concatenate([p.x_bow for p in batch], axis=0)
                )
                with span(self.metrics, "serve_batch",
                          requests=len(batch), docs=int(x.shape[0])):
                    theta, model_round = self.engine.infer(x)
            except Exception as err:
                self.logger.exception("micro-batch inference failed")
                if self.metrics is not None:
                    self.metrics.registry.counter("serving_errors").inc(
                        len(batch)
                    )
                    self.metrics.log(
                        "serve_error", reason=f"{type(err).__name__}: {err}",
                        requests=len(batch),
                    )
                for p in batch:
                    if not p.future.set_running_or_notify_cancel():
                        continue
                    p.future.set_exception(err)
                continue
            now = time.perf_counter()
            lo = 0
            for p in batch:
                hi = lo + p.x_bow.shape[0]
                if p.future.set_running_or_notify_cancel():
                    p.future.set_result((theta[lo:hi], model_round))
                lo = hi
            if self.metrics is not None:
                reg = self.metrics.registry
                hist = reg.histogram("serve_latency_s")
                for p in batch:
                    hist.observe(now - p.t_submit)
                reg.counter("serving_requests").inc(len(batch))
                self._rate_gauges(now, lo, len(batch))

    def _rate_gauges(self, now: float, docs: int, requests: int) -> None:
        """Fold one completed micro-batch into the rolling 10 s QPS /
        docs-per-s gauges."""
        window = self._window
        window.append((now, docs, requests))
        horizon = now - 10.0
        while window and window[0][0] < horizon:
            window.popleft()
        span = max(now - window[0][0], 1e-3) if len(window) > 1 else None
        if span is not None:
            reg = self.metrics.registry
            reg.gauge("serving_docs_per_s").set(
                sum(d for _t, d, _r in window) / span
            )
            reg.gauge("serving_qps").set(
                sum(r for _t, _d, r in window) / span
            )


class InferenceServicer:
    """The ``gfedntm.Inference`` gRPC service: decodes the request's BoW
    bundle, rides the batcher, encodes θ back. Registered via
    :func:`gfedntm_tpu_torch.federation.rpc.add_service` like every other
    service — fault injection and serve-span tracing compose unchanged."""

    def __init__(self, batcher: Batcher, timeout_s: float = 30.0,
                 metrics=None):
        self.batcher = batcher
        self.timeout_s = float(timeout_s)
        self.metrics = metrics

    def Infer(self, request, context):
        import grpc

        from gfedntm_tpu_torch.federation import codec
        from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb

        try:
            records = {r.name: r for r in request.bow.tensors}
            if "bow" not in records:
                raise ValueError(
                    "InferRequest.bow must carry a 'bow' tensor record"
                )
            x = codec.record_to_array(records["bow"])
            with span(self.metrics, "infer",
                      request_id=int(request.request_id)):
                theta, model_round = self.batcher.submit(x).result(
                    timeout=self.timeout_s
                )
        except QueueFullError as err:
            # Load shed: the queue is at its --serve_max_queue bound.
            # RESOURCE_EXHAUSTED is the standard gRPC pushback code —
            # transient by the resilience classification, so polite
            # clients retry with backoff.
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(err))
        except (ValueError, TypeError) as err:
            # TypeError covers codec.record_to_array's disallowed-dtype
            # rejection — a malformed request, not a retryable outage.
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(err))
        except Exception as err:
            context.abort(grpc.StatusCode.UNAVAILABLE, str(err))
        reply = pb.InferReply(
            model_round=int(model_round),
            request_id=request.request_id,
        )
        reply.theta.tensors.append(
            codec.array_to_record("theta", np.asarray(theta, np.float32))
        )
        return reply


class ServingPlane:
    """One serving process: model watcher + engine + batcher + the two
    front doors (gRPC ``Infer``, ops-HTTP ``/infer``), run by the
    ``serve`` CLI role. ``device`` is the engine's.

    The watcher polls the federation ``save_dir`` every ``poll_s`` for a
    newer published round and hands it to the engine, which hot-swaps it
    behind the quality gate. ``/ready`` turns 200 the moment the first
    model is loaded AND warmed; ``/status`` carries the ``serving`` view
    (model round, swap counters, latency percentiles, batch fill).
    """

    def __init__(
        self,
        save_dir: str,
        family: str = "avitm",
        model_kwargs: dict[str, Any] | None = None,
        max_batch: int = 64,
        linger_s: float = 0.002,
        max_queue: int = 0,
        poll_s: float = 1.0,
        quality_gate: bool = True,
        metrics=None,
        logger: logging.Logger | None = None,
        ops_port: int | None = None,
        ops_host: str = "127.0.0.1",
        grpc_workers: int = 16,
        slo_specs=None,
        dump_dir: str | None = None,
        flightrec_entries: int = 2048,
        flightrec_seconds: float = 300.0,
        device=None,
    ):
        self.logger = logger or logging.getLogger("ServingPlane")
        self.metrics = metrics
        self.poll_s = float(poll_s)
        # Incident forensics (README "Incident forensics"): --dump_dir
        # arms a flight recorder on the serving stream plus a trigger —
        # a swap refusal or a shed storm dumps the ring (recent infer /
        # serve_batch spans, queue depth history) with /status attached.
        # Unset constructs nothing.
        self.dump_dir = dump_dir
        self._incident_trigger = None
        if dump_dir is not None and metrics is not None:
            from gfedntm_tpu_torch.utils import flightrec

            recorder = flightrec.FlightRecorder(
                max_entries=flightrec_entries,
                max_seconds=flightrec_seconds,
                registry=metrics.registry,
            )
            metrics.recorder = recorder
            self._incident_trigger = flightrec.IncidentTrigger(
                recorder, dump_dir, metrics=metrics,
                node=metrics.node or "serve",
                status_cb=lambda: self._status(full=False),
            )
        if slo_specs:
            from gfedntm_tpu_torch.utils.slo import SLOEngine

            # The serving plane evaluates its OWN registry (serve latency
            # / shed / error objectives) on the watcher's poll cadence —
            # same engine, same alert lifecycle as the federation root.
            self.slo = SLOEngine(
                slo_specs,
                snapshot_fn=(
                    metrics.registry.snapshot if metrics is not None
                    else dict
                ),
                metrics=metrics,
            )
        else:
            self.slo = None
        self.source = ModelSource(
            save_dir, family=family, model_kwargs=model_kwargs,
            logger=self.logger, metrics=metrics,
        )
        self.engine = ServingEngine(
            max_batch=max_batch, metrics=metrics, logger=self.logger,
            quality_gate=quality_gate, device=device,
        )
        self.batcher = Batcher(
            self.engine, linger_s=linger_s, metrics=metrics,
            logger=self.logger, max_queue=max_queue,
        )
        self.ops_port = ops_port
        self.ops_host = ops_host
        self.grpc_workers = int(grpc_workers)
        self._grpc_server = None
        self._ops_server = None
        self._watcher: threading.Thread | None = None
        self._stopping = threading.Event()
        self._last_considered: int | None = None
        self._vocab_cache = None
        self.bound_port: int | None = None
        self.ops_actual_port: int | None = None

    # ---- lifecycle ---------------------------------------------------------
    def start(self, listen_address: str = "[::]:0") -> int:
        """Bind the gRPC Infer endpoint (returns the bound port), start
        the batcher, the model watcher, and — when ``ops_port`` is set —
        the ops HTTP endpoint with ``/ready`` + ``/infer`` mounted."""
        from gfedntm_tpu_torch.federation import rpc

        self.batcher.start()
        self._grpc_server = rpc.make_server(max_workers=self.grpc_workers)
        rpc.add_service(
            self._grpc_server, "gfedntm.Inference",
            InferenceServicer(self.batcher, metrics=self.metrics),
            metrics=self.metrics,
        )
        self.bound_port = self._grpc_server.add_insecure_port(listen_address)
        self._grpc_server.start()
        if self.ops_port is not None:
            from gfedntm_tpu_torch.utils.observability import OpsServer

            registry = (
                self.metrics.registry if self.metrics is not None else None
            )
            self._ops_server = OpsServer(
                registry=registry, status_fn=self._status,
                host=self.ops_host, port=self.ops_port,
                ready_fn=lambda: self.engine.ready,
                routes={"/infer": self._http_infer},
                alerts_fn=self.slo.status if self.slo is not None else None,
            )
            self.ops_actual_port = self._ops_server.start()
            if self.metrics is not None:
                self.metrics.log(
                    "ops_server_started", port=self.ops_actual_port,
                    role="serve",
                )
        self._stopping.clear()
        self._watcher = threading.Thread(
            target=self._watch, name="serve-watcher", daemon=True
        )
        self._watcher.start()
        self.logger.info(
            "serving plane up: gRPC Infer on %s, ops on %s",
            self.bound_port, self.ops_actual_port,
        )
        return self.bound_port

    def stop(self) -> None:
        self._stopping.set()
        if self._watcher is not None:
            self._watcher.join(timeout=30.0)
            self._watcher = None
        if self._grpc_server is not None:
            # Grace lets in-flight Infer calls finish — the zero-dropped-
            # requests contract holds through shutdown too.
            self._grpc_server.stop(grace=5.0).wait(timeout=10.0)
            self._grpc_server = None
        self.batcher.stop()
        if self._ops_server is not None:
            self._ops_server.stop()
            self._ops_server = None

    def wait(self, timeout: float | None = None) -> bool:
        """Block until :meth:`stop` (the CLI role's foreground wait)."""
        return self._stopping.wait(timeout)

    # ---- model watcher ------------------------------------------------------
    def _watch(self) -> None:
        """Poll-and-swap loop. The FIRST poll (the initial model load +
        bucket warm-up) runs here too, not in :meth:`start` — the front
        doors bind immediately and ``/ready`` honestly answers 503 while
        the plane warms, instead of the process being unreachable."""
        while True:
            try:
                self._try_swap()
            except Exception:
                # The watcher must survive transient store states (a
                # checkpoint mid-write, a journal briefly ahead of its
                # sidecar) — next poll retries.
                self.logger.exception("model watch poll failed")
                if self.metrics is not None:
                    self.metrics.registry.counter(
                        "serving_source_errors"
                    ).inc()
            if self.slo is not None:
                # SLO tick on the watcher's clock: alert latency is
                # bounded by poll_s, and no extra thread exists.
                self.slo.evaluate()
            if self._stopping.wait(self.poll_s):
                return

    def _try_swap(self) -> bool:
        """One watcher step: peek the store, load + publish when a round
        newer than anything considered so far appears. Refused rounds
        count as considered — a flagged candidate is not re-refused every
        poll; the NEXT published round gets its own verdict."""
        newest = self.source.peek()
        if newest is None:
            return False
        round_idx, _source = newest
        if (
            self._last_considered is not None
            and round_idx <= self._last_considered
        ):
            return False
        pub = self.source.load()
        if pub is None:
            return False
        self._last_considered = max(
            pub.round, self._last_considered or pub.round
        )
        with span(self.metrics, "serve_swap", round=int(pub.round)):
            return self.engine.publish(pub)

    # ---- HTTP front door ----------------------------------------------------
    def _vocabulary(self):
        """Cached :class:`~gfedntm_tpu_torch.data.vocab.Vocabulary` for the
        serving model — rebuilt only when a swap changes the token set
        (the token2id map is O(V); it must not be rebuilt per request)."""
        tokens = self.engine.vocab
        if tokens is None:
            return None
        cached = self._vocab_cache
        if cached is None or cached.tokens != tokens:
            from gfedntm_tpu_torch.data.vocab import Vocabulary

            cached = Vocabulary(tokens)
            self._vocab_cache = cached
        return cached

    def _bow_from_json(self, payload: dict) -> np.ndarray:
        """A request body's documents as a dense [B, V] BoW batch:
        ``bow`` rows pass through; ``docs`` (raw text) are vectorized
        with the training analyzer (:func:`gfedntm_tpu_torch.data.vocab
        .vectorize` — the same path clients build their corpora with,
        C++ fast path included) against the SERVING model's vocabulary —
        the serving plane owns the vocab, users send text."""
        if "bow" in payload:
            x = np.asarray(payload["bow"], np.float32)
            if x.ndim == 1:
                x = x[None, :]
            return x
        docs = payload.get("docs")
        if not docs or not isinstance(docs, list):
            raise ValueError(
                "request JSON needs 'docs' (list of text documents) or "
                "'bow' (dense [B, V] count rows)"
            )
        vocab = self._vocabulary()
        if vocab is None:
            raise RuntimeError("no model loaded yet")
        from gfedntm_tpu_torch.data.vocab import vectorize

        return vectorize([str(d) for d in docs], vocab)

    def _http_infer(self, body: bytes, query: str):
        """POST /infer handler mounted on the OpsServer: JSON in, JSON
        out. Errors map to 400 (bad request) / 503 (no model yet)."""
        try:
            payload = json.loads(body or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("request body must be a JSON object")
            x = self._bow_from_json(payload)
            theta, model_round = self.batcher.submit(x).result(timeout=30.0)
        except QueueFullError as err:
            # Load shed (the serve_shed event + shed counter were
            # already recorded at the rejection site): HTTP 429.
            return 429, "application/json", json.dumps(
                {"error": str(err)}
            ).encode()
        except ValueError as err:
            if self.metrics is not None:
                self.metrics.registry.counter("serving_errors").inc()
                self.metrics.log("serve_error", reason=str(err))
            return 400, "application/json", json.dumps(
                {"error": str(err)}
            ).encode()
        except RuntimeError as err:
            if self.metrics is not None:
                self.metrics.registry.counter("serving_errors").inc()
                self.metrics.log("serve_error", reason=str(err))
            return 503, "application/json", json.dumps(
                {"error": str(err)}
            ).encode()
        body = json.dumps({
            "theta": np.asarray(theta, np.float64).round(6).tolist(),
            "model_round": int(model_round),
        }).encode()
        return 200, "application/json", body

    # ---- status -------------------------------------------------------------
    def _status(self, full: bool = False) -> dict[str, Any]:
        from gfedntm_tpu_torch.utils.observability import quantile_from_snapshot

        serving = self.engine.status()
        reg = self.metrics.registry if self.metrics is not None else None
        if reg is not None:
            hist = reg.get("serve_latency_s")
            snap = hist.snapshot() if hist is not None else None
            if snap and snap.get("count"):
                serving["latency_s"] = {
                    "count": snap["count"],
                    "p50": quantile_from_snapshot(snap, 0.50),
                    "p99": quantile_from_snapshot(snap, 0.99),
                }

            def _val(name):
                m = reg.get(name)
                return m.value if m is not None else None

            serving["qps"] = _val("serving_qps")
            serving["docs_per_s"] = _val("serving_docs_per_s")
            serving["batch_fill"] = _val("serving_batch_fill")
            serving["requests"] = int(_val("serving_requests") or 0)
            serving["errors"] = int(_val("serving_errors") or 0)
            serving["requests_shed"] = int(
                _val("serving_requests_shed") or 0
            )
            serving["queue_depth"] = _val("serving_queue_depth")
        serving["max_queue"] = self.batcher.max_queue
        if self.slo is not None:
            serving["alerts_firing"] = self.slo.status()["firing"]
        serving["watch"] = {
            "directory": self.source.directory,
            "poll_s": self.poll_s,
            "last_considered": self._last_considered,
        }
        return {"role": "serve", "serving": serving}


def make_infer_stub(address: str, timeout_s: float = 30.0, metrics=None):
    """Client-side convenience: a callable ``infer(x_bow) -> (theta,
    model_round)`` over a fresh channel to a serving plane — what the
    load generator and remote users drive."""
    from gfedntm_tpu_torch.federation import codec, rpc
    from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb

    channel = rpc.make_channel(address)
    stub = rpc.ServiceStub(
        channel, "gfedntm.Inference", default_timeout=timeout_s,
        metrics=metrics, peer=address,
    )

    def infer(x_bow: np.ndarray, request_id: int = 0):
        req = pb.InferRequest(request_id=int(request_id))
        req.bow.tensors.append(
            codec.array_to_record("bow", np.asarray(x_bow, np.float32))
        )
        reply = stub.Infer(req)
        theta = codec.record_to_array(reply.theta.tensors[0])
        return theta, int(reply.model_round)

    infer.channel = channel  # callers own the channel lifetime
    return infer
