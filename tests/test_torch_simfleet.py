"""The port's simulated-client fleet (``federation/simfleet.py``) on the CPU.

- ``make_sim_fleet`` builds a training-ready fleet over the port's server
  (its template on ``device="cpu"``), and cohort, async, push and sync runs
  complete on the loopback transport.
- A sim client's updates and the template's bundle are byte for byte the
  JAX sim client's and codec's, and a poll-driven fleet (sync and
  ``cohort:K``, identity and ``delta+topk`` codecs) moves the JAX fleet's
  bytes at the same N, seed and codec, but for ``StepRequest.seq`` (the
  port's seq base is in milliseconds, the JAX server's in seconds); its
  cohort rosters are the JAX fleet's.
- Cohort and push bytes per round stay flat from N=100 to N=1,000 (within
  1.25x), as ``tests/test_scaleout.py``'s 1k-client smoke shows for push.
- The bounded reference caches of ``tests/test_scaleout.py``
  (``TestBoundedReferenceCaches`` and the rotating-cohort ratios) through
  the port's codec sessions and server.
"""

import math
import threading

import numpy as np
import pytest

from gfedntm_tpu.federation import simfleet as j_simfleet
from gfedntm_tpu.federation.server import build_template_model as j_build
from gfedntm_tpu_torch.federation import codec, simfleet
from gfedntm_tpu_torch.federation.compression import (
    DownlinkDecoder,
    DownlinkEncoder,
    ReferenceMismatch,
    UplinkDecoder,
    UplinkEncoder,
    WireCodec,
)
from gfedntm_tpu_torch.federation.server import FederatedServer
from gfedntm_tpu_torch.federation.simfleet import make_sim_fleet
from gfedntm_tpu_torch.utils.observability import MetricsLogger

MODEL_KWARGS = dict(n_components=3, hidden_sizes=(8,), batch_size=8, num_epochs=2, seed=0)
TIMEOUT = 120.0


@pytest.fixture(autouse=True)
def _count_before_stop(monkeypatch):
    """Both packages' sim servers record their bytes and calls just before
    the stop broadcast (an O(N) fan-out of stop messages, not a round's
    cost). The hook sits on the classes: a poll-driven run can end before
    ``make_sim_fleet`` returns."""
    for cls in (simfleet.SimFleetServer, j_simfleet.SimFleetServer):
        def before_stop(self, stubs, _stop=cls._stop_broadcast):
            self.counted = {"bytes": self.byte_counter.sent + self.byte_counter.recv,
                            "calls": self.byte_counter.calls}
            _stop(self, stubs)

        monkeypatch.setattr(cls, "_stop_broadcast", before_stop)


def _run(make, n, pacing, rounds, codec_spec=None, **kw):
    """One fleet to its end; returns (server, servicers, template, bytes
    counted before the stop broadcast)."""
    client_codec = codec_spec not in (None, "none")
    server, servicers, template = make(
        n, steps=rounds + 2, pacing_policy=pacing, max_iters=rounds,
        wire_codec=codec_spec, client_codec=client_codec, checkpoint_every=0,
        journal_every=0, round_backoff_s=0.01, **kw)
    try:
        if pacing.startswith("push"):
            _drive_push(server, servicers, template, int(pacing.split(":")[1]), rounds)
        assert server.wait_done(timeout=TIMEOUT), f"{pacing} N={n} did not finish"
    finally:
        server.stop(grace=0.1)
    assert server.global_iterations == rounds
    return server, servicers, template, server.counted


def _drive_push(server, servicers, template, fan, rounds):
    """``chip_smoke.push_rounds``' driver: B round-robin pushes (each reply
    applied), then wait for their aggregation, so every round drains
    exactly B updates."""
    import time

    order, i = sorted(servicers), 0
    deadline = time.monotonic() + TIMEOUT
    while not server.training_done.is_set() and server.global_iterations < rounds:
        done, pushed = server.global_iterations, 0
        while pushed < fan:
            servicer = servicers[order[i % len(order)]]
            i += 1
            if servicer.finished:
                continue
            update = servicer.build_update(template)
            agg = server.PushUpdate(update, None)
            server.byte_counter.note(agg, update)
            servicer.apply(agg)
            pushed += 1
        while server.global_iterations == done and not server.training_done.is_set():
            assert time.monotonic() < deadline, "a push round never aggregated"
            time.sleep(0.001)


def _jax_fleet(n, **kw):
    kw.pop("device", None)
    return j_simfleet.make_sim_fleet(n, **kw)


def _port_fleet(n, **kw):
    return make_sim_fleet(n, device="cpu", **kw)


@pytest.mark.parametrize("pacing", ["cohort:4", "async:4", "push:4", "sync"])
def test_make_sim_fleet_runs_on_the_cpu(tmp_path, pacing):
    metrics = MetricsLogger(validate=True)
    server, servicers, template, counted = _run(_port_fleet, 12, pacing, 3,
                                                save_dir=str(tmp_path), metrics=metrics)
    assert server.device.type == "cpu" and server.template.device.type == "cpu"
    assert isinstance(server, simfleet.SimFleetServer)
    assert len(servicers) == 12 and counted["bytes"] > 0
    assert sorted(template) == sorted(server._shared_template())
    assert server._status()["pacing"]["policy"] == pacing
    assert all(np.isfinite(np.asarray(v)).all() for v in server.last_average.values())


def test_sim_client_messages_are_the_jax_sim_clients():
    """From the same template, the port's and the JAX sim client's updates
    (the same seeded noise) serialize to the same bytes, under the identity
    and a delta codec, and both finish on the last budgeted step."""
    template = {k: np.asarray(v) for k, v in _template().items()}
    for spec in (None, "delta+topk:0.25"):
        port = simfleet.SimClientServicer(3, steps=4, wire_codec=spec, seed=5)
        jax = j_simfleet.SimClientServicer(3, steps=4, wire_codec=spec, seed=5)
        for sim in (port, jax):
            sim.bind_template(template)
        for seq in (1, 2, 3):
            got = port.build_update(template, seq=seq)
            want = jax.build_update(template, seq=seq)
            assert got.SerializeToString() == want.SerializeToString()
        assert port.finished is jax.finished is False
        got = port.build_update(template, seq=4)
        assert got.finished and jax.build_update(template, seq=4).finished


def _template():
    """A JAX template model's shared subset."""
    from gfedntm_tpu.federated.stepper import FederatedStepper

    return FederatedStepper(j_build("avitm", 40, MODEL_KWARGS)).get_gradients()


def _seq_free_counting(monkeypatch):
    """Count bytes with ``seq`` cleared on both the request and the reply:
    the one field whose value (the seq base) differs by design. The
    server's push pool calls ``note`` from several threads at once, so the
    totals are added under a lock, as the port's ``ByteCounter.note`` adds
    them (an unlocked ``+=`` lost updates under load)."""
    lock = threading.Lock()

    def note(self, request, reply):
        sent = _without_seq(request).ByteSize()
        recv = _without_seq(reply).ByteSize() if reply is not None else 0
        with lock:
            self.calls += 1
            self.sent += sent
            self.recv += recv

    monkeypatch.setattr(simfleet.ByteCounter, "note", note)
    monkeypatch.setattr(j_simfleet.ByteCounter, "note", note)


def _without_seq(msg):
    if "seq" not in type(msg).DESCRIPTOR.fields_by_name:
        return msg
    out = type(msg)()
    out.CopyFrom(msg)
    out.seq = 0
    return out


@pytest.mark.parametrize("pacing, codec_spec", [("sync", None), ("cohort:3", None),
                                                ("cohort:3", "delta+topk:0.25"),
                                                ("cohort:5", "delta")])
def test_poll_driven_fleet_bytes_are_the_jax_fleets(tmp_path, monkeypatch, pacing, codec_spec):
    _seq_free_counting(monkeypatch)
    runs = {}
    for name, make in (("port", _port_fleet), ("jax", _jax_fleet)):
        metrics = MetricsLogger(validate=True) if name == "port" else None
        kw = dict(save_dir=str(tmp_path / name), pacing_seed=4)
        if metrics is not None:
            kw["metrics"] = metrics
        server, _servicers, _template, counted = _run(make, 20, pacing, 4, codec_spec, **kw)
        runs[name] = (server, counted)
    port, jax = runs["port"], runs["jax"]
    assert port[1] == jax[1]
    assert port[0].byte_counter.sent == jax[0].byte_counter.sent
    assert port[0].byte_counter.recv == jax[0].byte_counter.recv


def test_cohort_fleet_rosters_are_the_jax_fleets(tmp_path):
    from gfedntm_tpu.utils.observability import MetricsLogger as JMetricsLogger

    logs = {"port": MetricsLogger(validate=True), "jax": JMetricsLogger(validate=True)}
    for name, make in (("port", _port_fleet), ("jax", _jax_fleet)):
        _run(make, 30, "cohort:4", 6, save_dir=str(tmp_path / name), pacing_seed=9,
             metrics=logs[name])
    got, want = ([(e["round"], e["eligible"], e["cohort"]) for e in log.events("cohort_sampled")]
                 for log in (logs["port"], logs["jax"]))
    assert got == want and len(got) == 6


@pytest.mark.parametrize("pacing", ["cohort:16", "push:16"])
def test_bytes_per_round_flat_from_100_to_1000_clients(tmp_path, pacing):
    """Per round, bytes are O(K or B) — under ``tests/test_scaleout.py``'s
    bound of 8 payloads per buffered update — and flat in N: within 1.25x
    from N=100 to N=1,000."""
    fan = 16
    per_round = {}
    for n in (100, 1000):
        _server, _servicers, template, counted = _run(
            _port_fleet, n, pacing, 4, save_dir=str(tmp_path / str(n)))
        payload = len(codec.flatdict_to_bundle(template).SerializeToString())
        per_round[n] = counted["bytes"] / 4
        assert per_round[n] < 8 * fan * payload, (n, per_round[n], payload)
    assert per_round[1000] <= 1.25 * per_round[100], per_round
    assert per_round[100] <= 1.25 * per_round[1000], per_round


def test_byte_counter_keeps_every_note_from_many_threads():
    """The server's poll and push pools call ``ByteCounter.note`` from
    several threads at once; with a switch interval of a microsecond, 32
    threads (more than the cores) must lose no call and no byte."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb

    request, reply = pb.Aggregate(round=7, stop=True), pb.AggregateReply(client_id=3)
    counter, threads, notes = simfleet.ByteCounter(), 32, 500

    def work(_):
        for _ in range(notes):
            counter.note(request, reply)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(threads) as pool:
            for future in [pool.submit(work, i) for i in range(threads)]:
                future.result(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(interval)
    n = threads * notes
    assert (counter.calls, counter.sent, counter.recv) == (
        n, n * request.ByteSize(), n * reply.ByteSize())


# ---- the bounded reference caches (tests/test_scaleout.py) --------------------

def _state(d=512, seed=0):
    rng = np.random.default_rng(seed)
    return {"plane": rng.standard_normal(d).astype(np.float32)}


def _walk(state, scale=1e-3, seed=1):
    rng = np.random.default_rng(seed)
    return {k: v + scale * rng.standard_normal(v.shape).astype(v.dtype)
            for k, v in state.items()}


def test_uplink_eviction_counter_age_gauge_and_event():
    m = MetricsLogger(validate=True)
    dec = UplinkDecoder(WireCodec("delta"), metrics=m, max_refs=2)
    view = _state(seed=5)
    for r in range(4):
        dec.note_push(r, view)
    assert m.registry.counter("codec_refs_evicted").value == 2
    events = m.events("codec_ref_evicted")
    assert [e["round"] for e in events] == [0, 1]
    assert all(e["direction"] == "uplink" for e in events)
    assert m.registry.gauge("codec_ref_evicted_age_rounds/uplink").value == 2


def test_uplink_eviction_is_loud_reference_miss_not_misdecode():
    wc = WireCodec("delta")
    dec = UplinkDecoder(wc, metrics=MetricsLogger(validate=True), max_refs=1)
    enc = UplinkEncoder(wc)
    v0, v1 = _state(seed=6), _state(seed=7)
    dec.note_push(0, v0)
    dec.note_push(1, v1)
    enc.note_aggregate(v0, 0)
    with pytest.raises(ReferenceMismatch):
        dec.decode(enc.encode(_walk(v0)))


def test_downlink_eviction_degrades_to_selfcontained_push():
    m = MetricsLogger(validate=True)
    wc = WireCodec("delta+topk:0.25")
    enc = DownlinkEncoder(wc, metrics=m, max_views=2)
    dec = DownlinkDecoder(wc)
    state = _state(seed=8)
    enc.advance(state, 0)
    dec.decode(enc.bundle_for(None), round_idx=0)
    views = {}
    for r in range(1, 5):
        state = _walk(state, seed=20 + r)
        _, views[r] = enc.advance(state, r)
    assert any(e["direction"] == "downlink" for e in m.events("codec_ref_evicted"))
    bundle = enc.bundle_for(0)
    assert bundle.ref_round == 0
    got = dec.decode(bundle, round_idx=4)
    for name, want in views[4].items():
        np.testing.assert_array_equal(got[name], want)
    assert m.registry.counter("codec_selfcontained_pushes").value >= 1


def test_server_caps_rotation_autosize(tmp_path):
    server = FederatedServer(min_clients=1, family="avitm", model_kwargs=MODEL_KWARGS,
                             wire_codec="delta", pacing_policy="cohort:2",
                             codec_ref_cache_max=16, save_dir=str(tmp_path), device="cpu")
    for cid in range(1, 201):
        server.federation.connect_vocab(cid, (), 1.0)
    server._size_codec_caches()
    assert server._uplink_dec.max_refs == 16
    assert server._downlink_enc.max_views == 16


def _rotation_bytes(n, k, rounds, codec_spec, d=30_000, max_views=None):
    rng = np.random.default_rng(0)
    state = {"plane": rng.standard_normal(d).astype(np.float32)}
    wc = WireCodec(codec_spec)
    enc_new = DownlinkEncoder(wc, max_views=max_views or 4 * math.ceil(n / k))
    enc_old = DownlinkEncoder(WireCodec(codec_spec))
    acked, new_bytes, old_bytes, misses = {}, 0, 0, 0
    dec = {cid: DownlinkDecoder(wc) for cid in range(n)}
    for r in range(rounds):
        state = {"plane": state["plane"] + 1e-3 * rng.standard_normal(d).astype(np.float32)}
        enc_new.advance(state, r)
        for cid in [(r * k + j) % n for j in range(k)]:
            bundle = enc_new.bundle_for(acked.get(cid))
            new_bytes += bundle.ByteSize()
            try:
                dec[cid].decode(bundle, round_idx=r)
            except ReferenceMismatch:
                misses += 1
                dec[cid].reset()
                dec[cid].decode(enc_new.bundle_for(None), round_idx=r)
            acked[cid] = r
        old_bundle, _ = enc_old.encode(state, r, allow_delta=False)
        old_bytes += old_bundle.ByteSize() * k
    return new_bytes, old_bytes, misses


def test_rotating_cohort_keeps_compression_over_2x():
    new_bytes, old_bytes, misses = _rotation_bytes(24, 4, rounds=24,
                                                   codec_spec="delta+topk:0.02")
    assert misses == 0
    assert old_bytes / new_bytes > 2.0


def test_undersized_cache_heals_via_reference_mismatch():
    new_bytes, old_bytes, misses = _rotation_bytes(12, 2, rounds=18,
                                                   codec_spec="delta+topk:0.1", max_views=1)
    assert misses == 0
    assert new_bytes <= old_bytes * 1.05


def test_codec_bundle_of_the_template_is_the_jax_codecs():
    """The push payload the fleet sizes itself by (the template bundle) is
    the JAX codec's, byte for byte."""
    from gfedntm_tpu.federation import codec as j_codec

    template = {k: np.asarray(v) for k, v in _template().items()}
    assert codec.flatdict_to_bundle(template).SerializeToString() == \
        j_codec.flatdict_to_bundle(template).SerializeToString()
