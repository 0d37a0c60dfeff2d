"""The port's serving plane on the CPU (``device="cpu"``), against the JAX
package's.

- The cases of ``tests/test_serving.py`` over the port: the model source's
  prefer-newer rule, encoder-only inference (deterministic, batch-size
  invariant under bucket padding, the posterior mean of the training-path
  encoder for AVITM and CTM), the quality-gated swap, the coalescing
  batcher, load shedding, the gRPC and HTTP front doors, the load
  generator's ``min_rounds``, and one federation that journals rounds while
  a serving plane hot-swaps under live closed-loop load with no failed
  request.
- Against the JAX package: θ bitwise equal to the port model's
  ``get_theta(noise=0.0)`` and within 1e-6 of the JAX engine's on the same
  journal; a JAX server's journal served by the port and a port server's
  by the JAX engine; each package's stub against the other's plane;
  ``InferReply`` bytes equal to the JAX servicer's; the load generator is
  the JAX one's code.
- The port's own rule: a slot owns its module, so a swap with an unchanged
  model identity leaves the installed slot's tensors as they were.

Tolerances: 1e-6 absolute on θ between packages and across bucket sizes
(float32 sums in another order), 1e-5 against ``softmax(mu)`` in float64.
"""

import ast
import json
import os
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from gfedntm_tpu_torch.data.loaders import RawCorpus
from gfedntm_tpu_torch.federation.server import FederatedServer, build_template_model
from gfedntm_tpu_torch.serving import (
    Batcher,
    ClosedLoopLoadGen,
    ModelSource,
    ServingEngine,
    ServingPlane,
    default_buckets,
    make_infer_stub,
)
from gfedntm_tpu_torch.serving.engine import PublishedModel, _flat_variables
from gfedntm_tpu_torch.train.checkpoint import FederationCheckpointer, RoundJournal
from gfedntm_tpu_torch.utils.observability import MetricsLogger

REPO = Path(__file__).resolve().parents[1]
MODEL_KWARGS = dict(n_components=3, hidden_sizes=(8,), batch_size=8, num_epochs=2, seed=0)
CTM_KWARGS = dict(MODEL_KWARGS, contextual_size=12, inference_type="zeroshot")
VOCAB = tuple(f"tok{i:02d}" for i in range(30))
CPU = dict(device="cpu")


def _flat_average(family="avitm", vocab=VOCAB, kwargs=MODEL_KWARGS, scale=1.0):
    model = build_template_model(family, len(vocab), dict(kwargs), device="cpu")
    return {k: np.asarray(v) * scale for k, v in _flat_variables(model.model).items()}


def _extra(family="avitm", kwargs=MODEL_KWARGS, quality=None):
    extra = {"family": family, "model_kwargs": dict(kwargs)}
    if quality is not None:
        extra["quality"] = quality
    return extra


def _journal_round(tmp_path, round_idx, quality=None, scale=1.0):
    j = RoundJournal(os.path.join(str(tmp_path), "checkpoints"))
    j.record(round_idx, _flat_average(scale=scale), [], vocab=list(VOCAB),
             extra=_extra(quality=quality))
    return j


def _wait(cond, timeout=30.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.05)
    return cond()


def _published(family="avitm", kwargs=MODEL_KWARGS, round_idx=1):
    return PublishedModel(round=round_idx, source="journal", vocab=VOCAB, family=family,
                          model_kwargs=dict(kwargs),
                          average=_flat_average(family=family, kwargs=kwargs))


def _loaded_model(family, kwargs, average):
    """The port's template model with a flat average loaded through the
    weight bridge (the reference the engine is held to)."""
    from gfedntm_tpu_torch import interop

    model = build_template_model(family, len(VOCAB), dict(kwargs), device="cpu")
    trees = {"params": {}, "batch_stats": {}}
    for key, value in average.items():
        collection, *path = key.split("/")
        node = trees[collection]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    sd = interop.state_dict_from_flax(trees["params"], trees["batch_stats"])
    missing, unexpected = model.model.load_state_dict(sd, strict=False)
    assert not unexpected
    return model


# ---- model source (journal/checkpoint prefer-newer) -------------------------

class TestModelSource:
    def test_empty_dir_has_nothing_and_reader_creates_nothing(self, tmp_path):
        src = ModelSource(str(tmp_path))
        assert src.peek() is None
        assert src.load() is None
        assert not os.path.exists(os.path.join(str(tmp_path), "checkpoints"))

    def test_journal_round_loads(self, tmp_path):
        _journal_round(tmp_path, 5)
        src = ModelSource(str(tmp_path))
        assert src.peek() == (5, "journal")
        pub = src.load()
        assert pub.round == 5 and pub.source == "journal"
        assert pub.vocab == VOCAB and pub.family == "avitm"
        assert pub.model_kwargs["n_components"] == 3
        assert "params/beta" in pub.average

    def test_checkpoint_round_loads_on_model_round_scale(self, tmp_path):
        """The sidecar's ``round`` is the resume round (model round + 1)."""
        ckpt = FederationCheckpointer(os.path.join(str(tmp_path), "checkpoints"))
        ckpt.save_round(7, _flat_average(), [], vocab=list(VOCAB), extra=_extra())
        src = ModelSource(str(tmp_path))
        assert src.peek() == (6, "checkpoint")
        pub = src.load()
        assert pub.round == 6 and pub.source == "checkpoint"
        assert set(pub.average) == set(_flat_average())

    def test_prefer_newer_journal_over_stale_checkpoint(self, tmp_path):
        ckpt = FederationCheckpointer(os.path.join(str(tmp_path), "checkpoints"))
        ckpt.save_round(3, _flat_average(), [], vocab=list(VOCAB), extra=_extra())
        _journal_round(tmp_path, 9)
        assert ModelSource(str(tmp_path)).peek() == (9, "journal")

    def test_prefer_newer_checkpoint_over_stale_journal(self, tmp_path):
        _journal_round(tmp_path, 2)
        ckpt = FederationCheckpointer(os.path.join(str(tmp_path), "checkpoints"))
        ckpt.save_round(8, _flat_average(), [], vocab=list(VOCAB), extra=_extra())
        src = ModelSource(str(tmp_path))
        assert src.peek() == (7, "checkpoint")
        assert src.load().round == 7

    def test_journal_equal_to_checkpoint_model_round_wins(self, tmp_path):
        ckpt = FederationCheckpointer(os.path.join(str(tmp_path), "checkpoints"))
        ckpt.save_round(8, _flat_average(), [], vocab=list(VOCAB), extra=_extra())
        _journal_round(tmp_path, 8)
        assert ModelSource(str(tmp_path)).peek() == (8, "journal")

    def test_finished_journal_still_serves(self, tmp_path):
        j = _journal_round(tmp_path, 6)
        j.mark_finished()
        src = ModelSource(str(tmp_path))
        assert src.peek() == (6, "journal")
        assert src.load().round == 6

    def test_corrupt_journal_degrades_quietly(self, tmp_path):
        _journal_round(tmp_path, 4)
        meta_path = os.path.join(str(tmp_path), "checkpoints", RoundJournal.META_NAME)
        meta = json.load(open(meta_path))
        meta["round"] = 3  # stale JSON half
        with open(meta_path, "w") as fh:
            json.dump(meta, fh)
        m = MetricsLogger(validate=True)
        src = ModelSource(str(tmp_path), metrics=m)
        assert src.load() is None  # no checkpoint to degrade to
        assert m.registry.counter("serving_source_retries").value == 1

    def test_quality_record_rides_journal(self, tmp_path):
        _journal_round(tmp_path, 5, quality={"flagged": True, "unhealthy_streak": 2})
        pub = ModelSource(str(tmp_path)).load()
        assert pub.flagged
        assert pub.quality["unhealthy_streak"] == 2


# ---- encoder-only inference ----------------------------------------------------

class TestInferenceParity:
    def _engine_with(self, family="avitm", kwargs=MODEL_KWARGS):
        eng = ServingEngine(max_batch=8, **CPU)
        assert eng.publish(_published(family, kwargs))
        return eng

    def test_deterministic_no_sampling(self):
        eng = self._engine_with()
        x = np.random.default_rng(0).integers(0, 4, size=(5, len(VOCAB))).astype(np.float32)
        t1, _ = eng.infer(x)
        t2, _ = eng.infer(x)
        np.testing.assert_array_equal(t1, t2)
        assert t1.dtype == np.float32

    def test_batch_size_invariant_under_bucket_padding(self):
        eng = self._engine_with()
        x = np.random.default_rng(1).integers(0, 4, size=(8, len(VOCAB))).astype(np.float32)
        full, _ = eng.infer(x)
        one, _ = eng.infer(x[:1])
        three, _ = eng.infer(x[:3])
        np.testing.assert_allclose(one, full[:1], atol=1e-6)
        np.testing.assert_allclose(three, full[:3], atol=1e-6)

    @pytest.mark.parametrize("family,kwargs", [("avitm", MODEL_KWARGS), ("ctm", CTM_KWARGS)])
    def test_matches_training_path_posterior_mean(self, family, kwargs):
        """θ is the training-path encoder's posterior mean
        (``encode_theta`` in eval mode at zero noise), and softmax(mu)."""
        eng = self._engine_with(family, kwargs)
        module = eng._slot.module
        rng = np.random.default_rng(2)
        x = rng.integers(0, 4, size=(6, len(VOCAB))).astype(np.float32)
        ctx = rng.normal(size=(6, 12)).astype(np.float32) if family == "ctm" else None
        theta, _ = eng.infer(x, ctx)
        with torch.no_grad():
            out = module.encode_theta(torch.from_numpy(x),
                                      None if ctx is None else torch.from_numpy(ctx),
                                      noise=0.0)
        np.testing.assert_allclose(theta, out.theta.numpy(), atol=1e-5)
        mu = out.posterior_mean.numpy().astype(np.float64)
        e = np.exp(mu - mu.max(axis=1, keepdims=True))
        np.testing.assert_allclose(theta, e / e.sum(axis=1, keepdims=True), atol=1e-5)
        assert not module.training

    def test_get_theta_noise_zero_is_deterministic_and_bitwise_the_engines(self):
        """``get_theta(noise=0.0)`` of the port's template with the round's
        average loaded is the engine's θ, bitwise, at the same batch shape."""
        pub = _published()
        eng = ServingEngine(max_batch=8, **CPU)
        eng.publish(pub)
        model = _loaded_model("avitm", MODEL_KWARGS, pub.average)
        x = np.random.default_rng(3).integers(0, 4, size=(8, len(VOCAB))).astype(np.float32)
        with torch.no_grad():
            t1 = model.model.get_theta(torch.from_numpy(x), noise=0.0)
            t2 = model.model.get_theta(torch.from_numpy(x), noise=0.0)
        assert torch.equal(t1, t2)
        theta, _ = eng.infer(x)
        np.testing.assert_array_equal(theta, t1.numpy())

    def test_chunking_above_max_batch(self):
        eng = self._engine_with()
        x = np.random.default_rng(4).integers(0, 4, size=(19, len(VOCAB))).astype(np.float32)
        theta, _ = eng.infer(x)
        assert theta.shape == (19, 3)
        one, _ = eng.infer(x[17:18])
        np.testing.assert_allclose(one[0], theta[17], atol=1e-6)

    def test_vocab_width_mismatch_is_loud(self):
        eng = self._engine_with()
        with pytest.raises(ValueError, match="vocab width"):
            eng.infer(np.zeros((2, 7), np.float32))

    def test_default_buckets(self):
        assert default_buckets(64) == (1, 2, 4, 8, 16, 32, 64)
        assert default_buckets(6) == (1, 2, 4, 6)
        assert default_buckets(1) == (1,)


def test_ctm_needs_its_contextual_embedding():
    eng = ServingEngine(max_batch=4, **CPU)
    eng.publish(_published("ctm", CTM_KWARGS))
    with pytest.raises(ValueError, match="contextual"):
        eng.infer(np.ones((2, len(VOCAB)), np.float32))


@pytest.mark.parametrize("cls", ["engine", "plane"])
def test_entry_points_default_to_cuda(tmp_path, cls):
    """``device=None`` is the GPU: without CUDA the engine and the plane
    raise instead of serving from the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine() if cls == "engine" else ServingPlane(str(tmp_path))


# ---- quality-gated hot swap -----------------------------------------------------

class TestQualityGatedSwap:
    def test_flagged_round_never_swaps_in(self, tmp_path):
        m = MetricsLogger(validate=True)
        _journal_round(tmp_path, 5)
        src = ModelSource(str(tmp_path))
        eng = ServingEngine(max_batch=4, metrics=m, **CPU)
        assert eng.publish(src.load())
        assert eng.model_round == 5
        _journal_round(tmp_path, 6,
                       quality={"flagged": True, "unhealthy_streak": 2, "npmi": -0.4})
        assert eng.publish(src.load()) is False
        assert eng.model_round == 5
        assert m.registry.counter("serving_swaps_refused").value == 1
        (ev,) = m.events("serve_swap_refused")
        assert ev["round"] == 6 and ev["reason"] == "coherence_flagged"
        assert ev["kept_round"] == 5
        _journal_round(tmp_path, 7, quality={"flagged": False, "unhealthy_streak": 0})
        assert eng.publish(src.load())
        assert eng.model_round == 7
        (swap,) = m.events("serve_model_swapped")
        assert swap["round"] == 7 and swap["prev_round"] == 5

    def test_gate_off_swaps_flagged(self, tmp_path):
        _journal_round(tmp_path, 5)
        src = ModelSource(str(tmp_path))
        eng = ServingEngine(max_batch=4, quality_gate=False, **CPU)
        assert eng.publish(src.load())
        _journal_round(tmp_path, 6, quality={"flagged": True})
        assert eng.publish(src.load())
        assert eng.model_round == 6

    def test_stale_round_is_not_a_swap(self, tmp_path):
        _journal_round(tmp_path, 5)
        pub = ModelSource(str(tmp_path)).load()
        eng = ServingEngine(max_batch=4, **CPU)
        assert eng.publish(pub)
        assert eng.publish(pub) is False

    def test_swap_invisible_to_inflight_requests(self, tmp_path):
        """A slot taken before a swap keeps answering, with its own round's
        weights: the swap builds a new module."""
        _journal_round(tmp_path, 5)
        src = ModelSource(str(tmp_path))
        eng = ServingEngine(max_batch=4, **CPU)
        eng.publish(src.load())
        slot_before = eng._slot
        x = np.ones((2, len(VOCAB)), np.float32)
        theta_before = eng._infer_bucket(slot_before, x, None)
        _journal_round(tmp_path, 6, scale=0.5)
        eng.publish(src.load())
        assert eng._slot is not slot_before
        theta = eng._infer_bucket(slot_before, x, None)
        assert np.isfinite(theta).all()
        np.testing.assert_array_equal(theta, theta_before)
        assert not np.array_equal(eng.infer(x)[0], theta_before)


def test_a_reused_identity_builds_a_new_module_and_leaves_the_installed_slot(tmp_path):
    """The JAX engine reuses the installed module when the model identity
    is unchanged; a torch module holds its weights, so the port copies it:
    the new slot's module is another object, and every tensor of the
    installed slot is bitwise what it was."""
    _journal_round(tmp_path, 1)
    src = ModelSource(str(tmp_path))
    eng = ServingEngine(max_batch=4, **CPU)
    eng.publish(src.load())
    old = eng._slot
    before = {k: v.clone() for k, v in old.module.state_dict().items()}
    _journal_round(tmp_path, 2, scale=0.5)
    assert eng.publish(src.load())
    new = eng._slot
    assert new.module is not old.module
    for (key, value), tensor in zip(new.module.state_dict().items(),
                                    old.module.state_dict().values()):
        assert value.data_ptr() != tensor.data_ptr(), key
    for key, value in old.module.state_dict().items():
        assert torch.equal(value, before[key]), key
    assert not torch.equal(new.module.beta, old.module.beta)
    assert not old.module.training and not new.module.training


# ---- coalescing batcher ---------------------------------------------------------

class TestBatcher:
    def test_concurrent_submits_coalesce_and_resolve(self, tmp_path):
        m = MetricsLogger(validate=True)
        _journal_round(tmp_path, 1)
        eng = ServingEngine(max_batch=16, metrics=m, **CPU)
        eng.publish(ModelSource(str(tmp_path)).load())
        b = Batcher(eng, linger_s=0.005, metrics=m)
        b.start()
        try:
            rng = np.random.default_rng(0)
            xs = [rng.integers(0, 4, size=(2, len(VOCAB))).astype(np.float32)
                  for _ in range(12)]
            futs = [b.submit(x) for x in xs]
            for x, f in zip(xs, futs):
                theta, round_idx = f.result(timeout=30)
                assert theta.shape == (2, 3) and round_idx == 1
                expect, _ = eng.infer(x)
                np.testing.assert_allclose(theta, expect, atol=1e-6)
        finally:
            b.stop()
        assert m.registry.counter("serving_requests").value == 12
        assert m.registry.counter("serving_docs").value >= 24

    def test_oversize_request_rejected(self, tmp_path):
        _journal_round(tmp_path, 1)
        eng = ServingEngine(max_batch=4, **CPU)
        eng.publish(ModelSource(str(tmp_path)).load())
        with pytest.raises(ValueError, match="max_batch"):
            Batcher(eng).submit(np.zeros((5, len(VOCAB)), np.float32))

    def test_wrong_width_request_rejected_alone(self, tmp_path):
        _journal_round(tmp_path, 1)
        eng = ServingEngine(max_batch=8, **CPU)
        eng.publish(ModelSource(str(tmp_path)).load())
        b = Batcher(eng, linger_s=0.01)
        b.start()
        try:
            with pytest.raises(ValueError, match="vocab width"):
                b.submit(np.zeros((2, 7), np.float32))
            theta, _ = b.submit(np.ones((2, len(VOCAB)), np.float32)).result(timeout=30)
            assert theta.shape == (2, 3)
        finally:
            b.stop()

    def test_stop_fails_pending_loudly(self, tmp_path):
        _journal_round(tmp_path, 1)
        eng = ServingEngine(max_batch=4, **CPU)
        eng.publish(ModelSource(str(tmp_path)).load())
        b = Batcher(eng)  # never started: submissions just queue
        fut = b.submit(np.zeros((1, len(VOCAB)), np.float32))
        b.stop()
        with pytest.raises(RuntimeError, match="stopped"):
            fut.result(timeout=5)


class _GatedEngine:
    """Stub engine whose batches wait for ``release``: the queue fills
    while the worker is held, so overload is reached by construction, not
    by timing."""

    max_batch = 16
    vocab = None

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def infer(self, x):
        self.entered.set()
        assert self.release.wait(30)
        return np.full((x.shape[0], 3), 1.0 / 3, np.float32), 5


class TestLoadShedding:
    def test_overload_sheds_bounded_queue_zero_accepted_failures(self):
        """One batch holds the worker; the queue then takes requests up to
        ``max_queue`` docs and sheds the next arrival alone. Released, every
        accepted request resolves."""
        from gfedntm_tpu_torch.serving import QueueFullError

        m = MetricsLogger(validate=True)
        engine = _GatedEngine()
        b = Batcher(engine, linger_s=0.0, metrics=m, max_queue=8)
        b.start()
        try:
            futs = [b.submit(np.ones((2, 10), np.float32))]
            assert engine.entered.wait(30)
            futs += [b.submit(np.ones((2, 10), np.float32)) for _ in range(4)]
            assert m.registry.get("serving_queue_depth").value == 8
            sheds = 0
            for _ in range(3):
                with pytest.raises(QueueFullError, match="queue full"):
                    b.submit(np.ones((2, 10), np.float32))
                sheds += 1
            engine.release.set()
            for f in futs:
                theta, rnd = f.result(timeout=30)
                assert theta.shape == (2, 3) and rnd == 5
        finally:
            engine.release.set()
            b.stop()
        assert m.registry.counter("serving_requests_shed").value == sheds
        shed_events = m.events("serve_shed")
        assert len(shed_events) == sheds
        assert all(ev["queued"] == 8 and ev["max_queue"] == 8 for ev in shed_events)
        assert m.registry.get("serving_queue_depth").value == 0
        assert m.registry.counter("serving_requests").value == len(futs)

    def test_grpc_infer_maps_shed_to_resource_exhausted(self):
        import grpc

        from gfedntm_tpu_torch.federation import codec
        from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb
        from gfedntm_tpu_torch.serving import InferenceServicer, QueueFullError

        class _FullBatcher:
            def submit(self, x):
                raise QueueFullError("serving queue full")

        class _Abort(Exception):
            pass

        class _Ctx:
            code = None

            def abort(self, code, details):
                self.code = code
                raise _Abort(details)

        req = pb.InferRequest(request_id=1)
        req.bow.tensors.append(codec.array_to_record("bow", np.ones((1, 4), np.float32)))
        ctx = _Ctx()
        with pytest.raises(_Abort, match="queue full"):
            InferenceServicer(_FullBatcher()).Infer(req, ctx)
        assert ctx.code is grpc.StatusCode.RESOURCE_EXHAUSTED

    def test_http_infer_maps_shed_to_429(self, tmp_path):
        from gfedntm_tpu_torch.serving import QueueFullError

        plane = ServingPlane(str(tmp_path), max_queue=4, **CPU)

        class _FullBatcher:
            engine = plane.engine
            max_queue = 4

            def submit(self, x):
                raise QueueFullError("serving queue full (4/4)")

        plane.batcher = _FullBatcher()
        status, ctype, body = plane._http_infer(json.dumps({"bow": [[1, 0, 2]]}).encode(), "")
        assert status == 429
        assert "queue full" in json.loads(body)["error"]

    def test_oversized_request_on_idle_queue_is_served_not_shed(self):
        engine = _GatedEngine()
        engine.release.set()
        b = Batcher(engine, linger_s=0.0, max_queue=4)
        b.start()
        try:
            theta, rnd = b.submit(np.ones((8, 10), np.float32)).result(timeout=30)
            assert theta.shape == (8, 3) and rnd == 5
        finally:
            b.stop()

    def test_max_queue_validation(self):
        """The batcher half of the JAX ``test_max_queue_validation_and_cli_flag``
        (the flag half waits for a port CLI)."""
        with pytest.raises(ValueError, match="max_queue"):
            Batcher(_GatedEngine(), max_queue=-1)


# ---- front doors: /ready, HTTP /infer, gRPC Infer ------------------------------

def _http(url, data=None, expect_error=False):
    try:
        req = urllib.request.Request(
            url, data=data, headers={"Content-Type": "application/json"} if data else {})
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        if not expect_error:
            raise
        return err.code, err.read()


class TestFrontDoors:
    def test_ready_distinct_from_healthz_and_http_infer(self, tmp_path):
        m = MetricsLogger(validate=True)
        plane = ServingPlane(str(tmp_path), max_batch=8, poll_s=0.1, metrics=m, ops_port=0,
                             **CPU)
        plane.start("[::]:0")
        try:
            base = f"http://127.0.0.1:{plane.ops_actual_port}"
            assert _http(f"{base}/healthz")[0] == 200
            code, body = _http(f"{base}/ready", expect_error=True)
            assert code == 503 and b"not ready" in body
            _journal_round(tmp_path, 2)
            assert _wait(lambda: plane.engine.ready)
            assert _http(f"{base}/ready")[0] == 200
            code, body = _http(
                f"{base}/infer", json.dumps({"docs": ["tok01 tok02 tok01", "tok05"]}).encode())
            assert code == 200
            out = json.loads(body)
            theta = np.asarray(out["theta"])
            assert theta.shape == (2, 3) and out["model_round"] == 2
            np.testing.assert_allclose(theta.sum(1), 1.0, atol=1e-3)
            code, _ = _http(f"{base}/infer",
                            json.dumps({"bow": np.ones((1, len(VOCAB))).tolist()}).encode())
            assert code == 200
            code, _ = _http(f"{base}/infer", json.dumps({"nope": 1}).encode(),
                            expect_error=True)
            assert code == 400
            assert m.events("serve_error")
            status = json.loads(_http(f"{base}/status")[1])
            assert status["serving"]["ready"] is True
            assert status["serving"]["model_round"] == 2
            assert status["serving"]["requests"] >= 2
        finally:
            plane.stop()

    def test_grpc_infer_roundtrip(self, tmp_path):
        _journal_round(tmp_path, 3)
        plane = ServingPlane(str(tmp_path), max_batch=8, poll_s=0.1, **CPU)
        plane.start("[::]:0")
        try:
            assert _wait(lambda: plane.engine.ready)
            infer = make_infer_stub(f"localhost:{plane.bound_port}")
            x = np.random.default_rng(0).integers(0, 4, size=(4, len(VOCAB))).astype(np.float32)
            theta, model_round = infer(x, request_id=11)
            assert theta.shape == (4, 3) and model_round == 3
            expect, _ = plane.engine.infer(x)
            np.testing.assert_allclose(theta, expect, atol=1e-6)
            infer.channel.close()
        finally:
            plane.stop()


# ---- the load generator ---------------------------------------------------------

def test_loadgen_min_rounds_extends_past_duration():
    t0 = time.perf_counter()
    lock = threading.Lock()

    def infer(x):
        with lock:
            rnd = int((time.perf_counter() - t0) / 0.3)
        return np.full((x.shape[0], 3), 1 / 3, np.float32), rnd

    gen = ClosedLoopLoadGen(infer, lambda w, s: np.zeros((2, 5), np.float32), concurrency=2,
                            duration_s=0.2, min_rounds=3, max_duration_s=10.0)
    summary = gen.run()
    assert summary["swaps_observed"] >= 2, summary["model_rounds_seen"]
    assert 0.2 < summary["duration_s"] < 5.0
    assert summary["failures"] == 0
    with pytest.raises(ValueError):
        ClosedLoopLoadGen(infer, lambda w, s: None, duration_s=0.1, min_rounds=0)


def _strip_docstrings(tree):
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return tree


def test_loadgen_copy_is_the_original():
    """The port's load generator is the JAX one's code (docstrings aside;
    it imports nothing of either package)."""
    port = _strip_docstrings(ast.parse((REPO / "gfedntm_tpu_torch/serving/loadgen.py")
                                       .read_text()))
    jax_ = _strip_docstrings(ast.parse((REPO / "gfedntm_tpu/serving/loadgen.py").read_text()))
    assert ast.dump(port) == ast.dump(jax_)


# ---- across the packages --------------------------------------------------------

def _jax_journal(tmp_path, family, kwargs, round_idx=4):
    """A journal written by the JAX package's RoundJournal with the JAX
    template's variables."""
    from flax.traverse_util import flatten_dict

    from gfedntm_tpu.federation.server import build_template_model as j_build
    from gfedntm_tpu.train.checkpoint import RoundJournal as JRoundJournal

    model = j_build(family, len(VOCAB), dict(kwargs))
    flat = flatten_dict({"params": model.params, "batch_stats": model.batch_stats}, sep="/")
    JRoundJournal(os.path.join(str(tmp_path), "checkpoints")).record(
        round_idx, {k: np.asarray(v) for k, v in flat.items()}, [], vocab=list(VOCAB),
        extra=_extra(family, kwargs))
    return str(tmp_path)


@pytest.mark.parametrize("family,kwargs", [("avitm", MODEL_KWARGS), ("ctm", CTM_KWARGS)])
def test_theta_is_the_jax_engines_on_the_same_journal(tmp_path, family, kwargs):
    from gfedntm_tpu.serving import ModelSource as JModelSource
    from gfedntm_tpu.serving import ServingEngine as JServingEngine

    save_dir = _jax_journal(tmp_path, family, kwargs)
    pub = ModelSource(save_dir).load()
    assert set(pub.average) == set(_flat_average(family, kwargs=kwargs))
    eng = ServingEngine(max_batch=8, **CPU)
    assert eng.publish(pub)
    jeng = JServingEngine(max_batch=8)
    assert jeng.publish(JModelSource(save_dir).load())
    rng = np.random.default_rng(5)
    for rows in (1, 3, 8, 11):
        x = rng.integers(0, 4, size=(rows, len(VOCAB))).astype(np.float32)
        ctx = rng.normal(size=(rows, 12)).astype(np.float32) if family == "ctm" else None
        theta, rnd = eng.infer(x, ctx)
        want, jrnd = jeng.infer(x, ctx)
        assert rnd == jrnd == 4
        np.testing.assert_allclose(theta, np.asarray(want), atol=1e-6)
    assert eng.status() == {k: v for k, v in jeng.status().items()}


def _documents(seed=0, n=2, docs=24):
    rng = np.random.default_rng(seed)
    words = [f"tok{i:02d}" for i in range(45)]
    return [[" ".join(rng.choice(words, size=12)) for _ in range(docs)] for _ in range(n)]


def _federate(save_dir, side, max_iters=3, num_epochs=2, keep_going=False):
    """A two-client federation of one package to its end (or, with
    ``keep_going``, left running: returns the server, clients and
    threads)."""
    kwargs = dict(MODEL_KWARGS, num_epochs=num_epochs)
    if side == "port":
        from gfedntm_tpu_torch.federation.client import Client

        server = FederatedServer(min_clients=2, family="avitm", model_kwargs=kwargs,
                                 max_iters=max_iters, save_dir=save_dir, checkpoint_every=0,
                                 journal_every=1, **CPU)
        make = lambda c, docs, addr: Client(  # noqa: E731
            client_id=c + 1, corpus=RawCorpus(documents=docs), server_address=addr,
            max_features=45, **CPU)
    else:
        from gfedntm_tpu.data.loaders import RawCorpus as JRawCorpus
        from gfedntm_tpu.federation.client import Client as JClient
        from gfedntm_tpu.federation.server import FederatedServer as JServer

        server = JServer(min_clients=2, family="avitm", model_kwargs=kwargs,
                         max_iters=max_iters, save_dir=save_dir, checkpoint_every=0,
                         journal_every=1)
        make = lambda c, docs, addr: JClient(  # noqa: E731
            client_id=c + 1, corpus=JRawCorpus(documents=docs), server_address=addr,
            max_features=45)
    addr = server.start("[::]:0")
    clients = [make(c, docs, addr) for c, docs in enumerate(_documents())]
    threads = [threading.Thread(target=cl.run, daemon=True) for cl in clients]
    for t in threads:
        t.start()
    if keep_going:
        return server, clients, threads
    try:
        assert server.wait_done(timeout=120.0)
    finally:
        server.stop()
        for cl in clients:
            cl.shutdown()
        for t in threads:
            t.join(timeout=30)
    return server


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_server_journal_is_served_by_the_other_package(tmp_path, writer):
    """A JAX server's journal served by the port engine, and a port
    server's by the JAX engine: same round, same vocabulary, θ within
    1e-6."""
    from gfedntm_tpu.serving import ModelSource as JModelSource
    from gfedntm_tpu.serving import ServingEngine as JServingEngine

    save_dir = str(tmp_path / "fed")
    _federate(save_dir, writer)
    pub, jpub = ModelSource(save_dir).load(), JModelSource(save_dir).load()
    assert pub.round == jpub.round and pub.source == jpub.source == "journal"
    assert pub.vocab == jpub.vocab and set(pub.average) == set(jpub.average)
    eng = ServingEngine(max_batch=8, **CPU)
    jeng = JServingEngine(max_batch=8)
    assert eng.publish(pub) and jeng.publish(jpub)
    x = np.random.default_rng(6).integers(0, 3, size=(5, len(pub.vocab))).astype(np.float32)
    np.testing.assert_allclose(eng.infer(x)[0], np.asarray(jeng.infer(x)[0]), atol=1e-6)


@pytest.mark.parametrize("plane_side", ["jax", "port"])
def test_each_packages_stub_against_the_others_plane(tmp_path, plane_side):
    """gRPC ``Infer`` across the packages: the port stub against a JAX
    plane and the JAX stub against a port plane, on one journal; the
    ``/status`` serving view has the same keys on both planes."""
    from gfedntm_tpu.serving import ServingPlane as JServingPlane
    from gfedntm_tpu.serving import make_infer_stub as j_make_infer_stub

    save_dir = _jax_journal(tmp_path, "avitm", MODEL_KWARGS, round_idx=3)
    m, jm = MetricsLogger(validate=True), MetricsLogger(validate=True)
    planes = {"port": ServingPlane(save_dir, max_batch=4, poll_s=0.1, metrics=m, **CPU),
              "jax": JServingPlane(save_dir, max_batch=4, poll_s=0.1, metrics=jm)}
    for plane in planes.values():
        plane.start("[::]:0")
    try:
        assert all(_wait(lambda p=p: p.engine.ready) for p in planes.values())
        stub = (make_infer_stub if plane_side == "jax" else j_make_infer_stub)(
            f"localhost:{planes[plane_side].bound_port}")
        x = np.random.default_rng(7).integers(0, 4, size=(3, len(VOCAB))).astype(np.float32)
        theta, model_round = stub(x, request_id=5)
        stub.channel.close()
        assert model_round == 3 and theta.dtype == np.float32
        for plane in planes.values():
            got, _ = plane.batcher.submit(x).result(timeout=30)
            np.testing.assert_allclose(theta, np.asarray(got), atol=1e-6)
        views = {side: p._status()["serving"] for side, p in planes.items()}
        assert set(views["port"]) == set(views["jax"])
        assert set(views["port"]["watch"]) == set(views["jax"]["watch"])
    finally:
        for plane in planes.values():
            plane.stop()


def test_infer_reply_bytes_are_the_jax_servicers():
    from concurrent.futures import Future

    from gfedntm_tpu.serving import InferenceServicer as JInferenceServicer
    from gfedntm_tpu_torch.federation import codec
    from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb
    from gfedntm_tpu_torch.serving import InferenceServicer

    theta = np.random.default_rng(8).dirichlet(np.ones(3), size=4).astype(np.float32)

    class _Fixed:
        def submit(self, x):
            f = Future()
            f.set_result((theta[:x.shape[0]], 17))
            return f

    req = pb.InferRequest(request_id=42)
    req.bow.tensors.append(codec.array_to_record("bow", np.ones((4, 6), np.float32)))
    port = InferenceServicer(_Fixed()).Infer(req, None)
    jax_ = JInferenceServicer(_Fixed()).Infer(req, None)
    assert port.SerializeToString() == jax_.SerializeToString()
    assert port.model_round == 17 and port.request_id == 42


# ---- end to end: a live federation, a hot-swapping plane, closed-loop load ------

def test_e2e_hot_swap_under_live_load(tmp_path):
    """A port federation journals every round while a port plane polls its
    save_dir and hot-swaps under closed-loop gRPC load: no failed request,
    at least two swaps seen by the load, and no worker ever sees a round
    older than one it saw before. Condition-driven: the load stops once
    three distinct rounds have answered (within 20 s)."""
    srv_dir = str(tmp_path / "fed")
    server, clients, threads = _federate(srv_dir, "port", max_iters=300, num_epochs=40,
                                         keep_going=True)
    mserve = MetricsLogger(str(tmp_path / "serve" / "metrics.jsonl"), validate=True,
                           keep_records=True)
    plane = ServingPlane(srv_dir, max_batch=32, poll_s=0.1, metrics=mserve, ops_port=0,
                         **CPU)
    plane.start("[::]:0")
    seen: dict[int, list[int]] = {}
    try:
        assert _wait(lambda: plane.engine.ready, 60), "no model ever published"
        vocab_size = len(plane.engine.vocab)
        stub = make_infer_stub(f"localhost:{plane.bound_port}")
        batch_rngs = [np.random.default_rng(7 + i) for i in range(4)]

        def infer(x):
            theta, rnd = stub(x)
            seen.setdefault(threading.get_ident(), []).append(rnd)
            return theta, rnd

        gen = ClosedLoopLoadGen(
            infer, lambda w, s: batch_rngs[w].integers(0, 3, size=(4, vocab_size))
            .astype(np.float32),
            concurrency=4, duration_s=1.0, metrics=mserve, min_rounds=3, max_duration_s=20.0)
        summary = gen.run()
        stub.channel.close()
    finally:
        plane.stop()
        server.stop()
        for cl in clients:
            cl.shutdown()
        for t in threads:
            t.join(timeout=30)
        mserve.close()
    assert summary["failures"] == 0, summary["failure_samples"]
    assert summary["requests"] > 0
    assert summary["swaps_observed"] >= 2, summary["model_rounds_seen"]
    assert all(r == sorted(r) for r in seen.values())
    reg = mserve.registry
    assert reg.counter("serving_swaps").value >= 2
    assert reg.get("serve_latency_s").count == summary["requests"]
    rounds = [ev["round"] for ev in mserve.events("serve_model_swapped")]
    assert len(rounds) >= 2 and rounds == sorted(rounds)
    windows = mserve.events("serve_load_window")
    assert windows and sum(w["docs"] for w in windows) == summary["docs"]
    status = plane._status()
    assert status["serving"]["swaps"] >= 2 and status["serving"]["errors"] == 0


def test_a_jax_stores_orbax_round_is_refused_loudly(tmp_path):
    """A JAX store whose newest round is an orbax checkpoint (no journal)
    raises the port checkpointer's refusal instead of serving nothing."""
    from flax.traverse_util import flatten_dict

    from gfedntm_tpu.federation.server import build_template_model as j_build
    from gfedntm_tpu.train.checkpoint import FederationCheckpointer as JCheckpointer
    from gfedntm_tpu_torch.train.checkpoint import CheckpointIntegrityError

    model = j_build("avitm", len(VOCAB), dict(MODEL_KWARGS))
    flat = flatten_dict({"params": model.params, "batch_stats": model.batch_stats}, sep="/")
    ckpt = JCheckpointer(os.path.join(str(tmp_path), "checkpoints"))
    ckpt.save_round(4, {k: np.asarray(v) for k, v in flat.items()}, [], vocab=list(VOCAB),
                    extra=_extra())
    ckpt.close()
    src = ModelSource(str(tmp_path))
    assert src.peek() == (3, "checkpoint")
    with pytest.raises(CheckpointIntegrityError, match="orbax"):
        src.load()
