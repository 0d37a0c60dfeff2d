"""The root's shard supervision, the client's failover ladder and the round
profiler in the port, on the CPU.

- Shard grace (``relay_grace_rounds``): the sync engine's quorum
  denominates over live shards, drops an expired shard's weight, sets
  ``live_shards`` and warns once per expiry (again after a recovered shard
  expires anew), step for step with the JAX engine; the wait for pollable
  members (which cohort inherits) does not wait on an expired shard.
- ``tests/test_hierarchy_survival.py::TestClientRehoming`` against the port
  client, and ``_last_reconnect_outcome`` after each way the reconnect
  loop ends.
- An end-to-end relay loss: relay 102 is aborted and never comes back, and
  its members re-home to the root through ``failover_addrs``.
- ``RoundProfiler``: ``parse_round_window`` is the JAX copy; a trace only
  for its window, its events, a no-op without a directory, a second
  concurrent window disabled loudly, and the server's and a client's
  windows in a federation.
"""

import ast
import json
import logging
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from gfedntm_tpu.federation.pacing import make_engine as j_make_engine
from gfedntm_tpu.federation.server import FederatedServer as JServer
from gfedntm_tpu_torch.data.loaders import RawCorpus
from gfedntm_tpu_torch.federation.client import Client
from gfedntm_tpu_torch.federation.pacing import make_engine
from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb
from gfedntm_tpu_torch.federation.registry import DROPPED
from gfedntm_tpu_torch.federation.relay import RelayNode
from gfedntm_tpu_torch.federation.server import FederatedServer
from gfedntm_tpu_torch.utils.observability import (
    MetricsLogger,
    RoundProfiler,
    parse_round_window,
)

REPO = Path(__file__).resolve().parents[1]
MODEL_KWARGS = dict(n_components=3, hidden_sizes=(8,), batch_size=8, num_epochs=2, seed=0)


# ---- shard grace on the root -------------------------------------------------

def _supervising(server, n=3):
    for cid in range(101, 101 + n):
        server.federation.connect_vocab(cid, (f"w{cid}",), 10.0)
        server.federation.connect_ready(cid, f"localhost:{cid}")
    return server


def _grace_walk(server, engine):
    """Expire, recover and re-expire shard 101; returns the denominators
    and, per step, the shards it warned about."""
    fed = server.federation
    with engine._lock:
        engine._round_weight.update({101: 10.0, 102: 10.0, 103: 10.0})
    steps = []

    def step(round_idx):
        denominator = engine.quorum_denominator(fed.active_clients(), round_idx)
        steps.append((round_idx, denominator, sorted(engine._grace_noted)))

    fed.mark_suspect(101, "localhost:101", round_idx=5, probation_rounds=99)
    step(6)   # inside the grace: still counted
    step(7)   # expired: live shards only, one warning
    with engine._lock:
        assert 101 not in engine._round_weight
    step(8)   # still expired: no second warning
    assert fed.mark_recovered(101)
    step(9)   # recovered: counted again, memo cleared
    fed.mark_suspect(101, "localhost:101", round_idx=10, probation_rounds=99)
    step(12)  # a later expiry is loud again
    return steps


def test_sync_quorum_denominates_over_live_shards(caplog):
    m = MetricsLogger()
    server = _supervising(FederatedServer(min_clients=3, relay_grace_rounds=2, metrics=m,
                                          device="cpu"))
    engine = make_engine(server, server.pacing)
    with caplog.at_level(logging.WARNING):
        steps = _grace_walk(server, engine)
    assert steps == [(6, 3, []), (7, 2, [101]), (8, 2, [101]), (9, 3, []), (12, 2, [101])]
    warned = [r for r in caplog.records if "grace window" in r.getMessage()]
    assert len(warned) == 2
    assert m.registry.gauge("live_shards").value == 2
    jserver = _supervising(JServer(min_clients=3, relay_grace_rounds=2))
    assert _grace_walk(jserver, j_make_engine(jserver, jserver.pacing)) == steps


def test_grace_off_keeps_the_flat_denominator():
    server = _supervising(FederatedServer(min_clients=3, device="cpu"))
    engine = make_engine(server, server.pacing)
    server.federation.mark_suspect(101, "localhost:101", round_idx=1, probation_rounds=99)
    assert engine.quorum_denominator(server.federation.active_clients(), 50) == 3


@pytest.mark.parametrize("grace", [0, 2])
def test_cohort_wait_skips_shards_past_the_grace(grace):
    """Both shards in long backoff since round 1: past the grace the wait for
    pollable members returns at once (the run degrades to live shards, here
    none); without grace it waits in wall-clock until stopped."""
    server = _supervising(FederatedServer(min_clients=2, pacing_policy="cohort:2",
                                          relay_grace_rounds=grace, round_backoff_s=30.0,
                                          device="cpu"), n=2)
    engine = make_engine(server, server.pacing)
    for cid in (101, 102):
        for _ in range(5):
            server.federation.mark_suspect(cid, f"localhost:{cid}", round_idx=1,
                                           probation_rounds=99)
    assert len(server.federation.pending_suspects(4)) == 2
    timer = threading.Timer(0.3, server._stopping.set)
    timer.start()
    t0 = time.monotonic()
    try:
        assert engine._wait_for_pollable(4) == []
    finally:
        timer.cancel()
    waited = time.monotonic() - t0
    assert (waited < 0.25) if grace else (waited >= 0.25)


# ---- the client's failover ladder --------------------------------------------

def _client(**kw):
    kw.setdefault("client_id", 1)
    kw.setdefault("corpus", RawCorpus(documents=["alpha beta gamma"] * 3))
    kw.setdefault("server_address", "localhost:1")
    kw.setdefault("device", "cpu")
    return Client(**kw)


class _DeadChannel:
    closed = False

    def close(self):
        self.closed = True


class TestClientRehoming:
    def test_rehome_swaps_endpoint_and_resets_codec_sessions(self):
        client = _client(failover_addrs=["localhost:2", "localhost:3"])
        assert list(client.failover_addrs) == ["localhost:2", "localhost:3"]
        old = _DeadChannel()
        client._fed_channel = old
        client._federation_stub = object()

        class _Session:
            resets = 0

            def reset(self):
                self.resets += 1

        client._uplink = up = _Session()
        client._downlink = down = _Session()
        client._rehome("localhost:2")
        assert client.server_address == "localhost:2"
        assert old.closed, "the dead channel was not released"
        assert up.resets == 1 and down.resets == 1

    def test_rehome_forgets_the_replay_cache(self):
        """The adoptive tier's seqs may sit below the dead tier's: after a
        re-homing none of them may be answered from the replay cache."""
        import logging as _logging

        from gfedntm_tpu_torch.federation.client import FederatedClientServicer

        client = _client(failover_addrs=["localhost:2"])
        client._fed_channel = _DeadChannel()
        client._servicer = FederatedClientServicer(1, None, lambda: None,
                                                   _logging.getLogger("t"))
        client._servicer._last_step_seq = 1 << 60
        client._servicer._last_step_reply = pb.StepReply(client_id=1)
        client._rehome("localhost:2")
        assert client._servicer._last_step_seq == 0
        assert client._servicer._last_step_reply is None

    def test_failover_ladder_walks_endpoints_on_exhaustion(self):
        m = MetricsLogger()
        client = _client(failover_addrs=["localhost:2", "localhost:3"], metrics=m)
        client._fed_channel = _DeadChannel()
        outcomes = iter(["exhausted", "exhausted", "ok"])
        attempts = []

        def fake_loop(idle):
            client._last_reconnect_outcome = next(outcomes)
            attempts.append(client.server_address)
            return client._last_reconnect_outcome == "ok"

        client._reconnect_loop = fake_loop
        assert client._reconnect_or_rehome(0.0)
        assert attempts == ["localhost:1", "localhost:2", "localhost:3"]
        assert client.failover_addrs == []
        assert m.registry.counter("client_rehomes").value == 2

    def test_failover_ladder_stops_on_authoritative_answer(self):
        client = _client(failover_addrs=["localhost:2"])
        client._fed_channel = _DeadChannel()

        def fake_loop(idle):
            client._last_reconnect_outcome = "finished"
            return False

        client._reconnect_loop = fake_loop
        assert not client._reconnect_or_rehome(0.0)
        assert client.failover_addrs == ["localhost:2"]


class _Endpoint:
    def __init__(self, code):
        self.code = code

    def ReadyForTraining(self, request, timeout=None):
        return pb.Ack(code=self.code)


@pytest.mark.parametrize("outcome,code,window,result", [
    ("exhausted", 0, 0.0, False), ("finished", 1, 5.0, False),
    ("refused", 2, 5.0, False), ("ok", 0, 5.0, True), ("stopped", 0, 5.0, True),
])
def test_reconnect_loop_records_its_outcome(outcome, code, window, result):
    client = _client(reconnect_window=window)
    client.session_token = "ab" * 16
    client._federation_stub = _Endpoint(code)
    if outcome == "exhausted":
        time.sleep(0.01)  # the window is over before the first attempt
    if outcome == "stopped":
        client.stopped.set()
    assert client._reconnect_loop(0.0) is result
    assert client._last_reconnect_outcome == outcome


# ---- an end-to-end relay loss ------------------------------------------------

def _documents(n, docs=16, seed=11):
    rng = np.random.default_rng(seed)
    words = [f"tok{i:02d}" for i in range(45)]
    return [[" ".join(rng.choice(words, size=12)) for _ in range(docs)] for _ in range(n)]


def test_relay_loss_members_rehome_to_the_root(tmp_path):
    """Relay 102 is aborted after round 2 and never respawned: its members'
    reconnect windows against it are exhausted, each re-homes to the root
    (``client_rehomes`` 1, the root's ``member_rehomed``), and the run
    finishes with the root's live membership {101, 3, 4}. The root carries
    a round profiler on rounds [1, 2) and member 1 one on rounds [3, 4)."""
    root_log = MetricsLogger(validate=True, keep_records=True)
    root_prof = RoundProfiler(str(tmp_path / "prof_root"), "1:2", metrics=root_log)
    root = FederatedServer(min_clients=2, model_kwargs=dict(MODEL_KWARGS, num_epochs=6),
                           max_iters=400, save_dir=str(tmp_path / "root"), checkpoint_every=0,
                           round_backoff_s=0.05, metrics=root_log, profiler=root_prof,
                           device="cpu")
    root_addr = root.start("127.0.0.1:0")
    relays = [RelayNode(relay_id=rid, upstream_address=root_addr, min_members=2,
                        listen_address="127.0.0.1:0", advertise_host="127.0.0.1",
                        device="cpu") for rid in (101, 102)]
    addrs = [r.start() for r in relays]
    logs = [MetricsLogger(validate=True, keep_records=True) for _ in range(4)]
    prof1 = RoundProfiler(str(tmp_path / "prof_c1"), "3:4", metrics=logs[0])
    clients = []
    # Relay 101's shard trains ten times longer than 102's, so the run is
    # still going when 102's members have waited out their windows.
    corpora = _documents(2, docs=160, seed=9) + _documents(2, docs=16, seed=10)
    for c, docs in enumerate(corpora):
        kw = dict(liveness_timeout=1.0, watchdog_poll_s=0.05, reconnect_window=0.5)
        if c >= 2:
            kw["failover_addrs"] = [root_addr]
        if c == 0:
            kw["profiler"] = prof1
        clients.append(Client(client_id=c + 1, corpus=RawCorpus(documents=docs),
                              server_address=addrs[c // 2], listen_address="127.0.0.1:0",
                              advertise_host="127.0.0.1", max_features=45,
                              save_dir=str(tmp_path / f"c{c + 1}"), metrics=logs[c],
                              device="cpu", **kw))
    errors = []

    def run(client):
        try:
            client.run()
        except BaseException as err:  # reported below
            errors.append(repr(err))

    threads = [threading.Thread(target=run, args=(c,), daemon=True) for c in clients]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while relays[1]._applied_round < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert relays[1]._applied_round >= 2
        relays[1].abort()
        assert root.wait_done(timeout=120), "the federation did not finish"
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
    finally:
        root.stop()
        for r in relays:
            r.shutdown()
        for c in clients:
            c.shutdown()
    for c in clients:
        assert c.stepper.finished
    assert [lg.registry.counter("client_rehomes").value for lg in logs] == [0, 0, 1, 1]
    assert sorted(e["client"] for e in root_log.events("member_rehomed")) == [3, 4]
    live = sorted(c.client_id for c in root.federation.get_clients() if c.status != DROPPED)
    assert live == [3, 4, 101]
    assert np.isfinite(root.global_betas).all()
    for prof, log in ((root_prof, root_log), (prof1, logs[0])):
        assert [e["event"] for e in log.records if e["event"].startswith("profiler_")] == [
            "profiler_started", "profiler_stopped"]
        assert log.registry.counter("profiler_failures").value == 0
        assert Path(prof.trace_path).is_file()
        assert json.loads(Path(prof.trace_path).read_text())["traceEvents"]


# ---- the round profiler ------------------------------------------------------

def _jax_source(name):
    tree = ast.parse((REPO / "gfedntm_tpu/utils/observability.py").read_text())
    return next(ast.dump(n) for n in tree.body if getattr(n, "name", None) == name)


def _port_source(name):
    tree = ast.parse((REPO / "gfedntm_tpu_torch/utils/observability.py").read_text())
    return next(ast.dump(n) for n in tree.body if getattr(n, "name", None) == name)


def test_parse_round_window_is_the_jax_copy():
    assert _port_source("parse_round_window") == _jax_source("parse_round_window")
    assert parse_round_window("3") == (3, 4) and parse_round_window("2:5") == (2, 5)
    for bad in ("x", "3:3", "-1:2"):
        with pytest.raises(ValueError):
            parse_round_window(bad)


def _work():
    import torch

    return torch.randn(16, 16) @ torch.randn(16, 16)


def test_round_profiler_traces_only_its_window(tmp_path):
    import torch

    m = MetricsLogger(validate=True, keep_records=True)
    prof = RoundProfiler(str(tmp_path), "2:4", metrics=m, device="cpu")

    def round_work(r):
        # Rounds inside the window multiply matrices, rounds outside it
        # batches of them: the trace must hold only the former.
        prof.observe(r)
        if 2 <= r < 4:
            torch.mm(torch.randn(16, 16), torch.randn(16, 16))
        else:
            torch.bmm(torch.randn(2, 16, 16), torch.randn(2, 16, 16))

    for r in range(6):
        # Each round observed (and worked) on a thread of its own, as gRPC
        # handlers observe a client's rounds.
        t = threading.Thread(target=round_work, args=(r,))
        t.start()
        t.join()
    prof.close()
    events = [(e["event"], e["round"]) for e in m.records if e["event"].startswith("profiler_")]
    assert events == [("profiler_started", 2), ("profiler_stopped", 4)]
    assert [p.name for p in tmp_path.iterdir()] == [Path(prof.trace_path).name]
    names = [e.get("name") for e in json.loads(Path(prof.trace_path).read_text())["traceEvents"]]
    assert names.count("aten::mm") >= 1 and names.count("aten::bmm") == 0
    assert m.registry.counter("profiler_failures").value == 0


def test_round_profiler_close_ends_an_open_window(tmp_path):
    m = MetricsLogger(keep_records=True)
    prof = RoundProfiler(str(tmp_path), "1:100", metrics=m, device="cpu")
    prof.observe(1)
    _work()
    prof.close()
    assert [e["round"] for e in m.events("profiler_stopped")] == [100]
    assert Path(prof.trace_path).is_file()


def test_round_profiler_without_a_directory_is_a_no_op(tmp_path):
    m = MetricsLogger(keep_records=True)
    prof = RoundProfiler(None, "0:2", metrics=m)
    for r in range(3):
        prof.observe(r)
    prof.close()
    assert prof.trace_path is None and m.records == []


def test_second_concurrent_window_is_disabled_loudly(tmp_path, caplog):
    m = MetricsLogger(keep_records=True)
    first = RoundProfiler(str(tmp_path / "a"), "0:2", metrics=m, device="cpu")
    second = RoundProfiler(str(tmp_path / "b"), "0:2", metrics=m, device="cpu")
    first.observe(0)
    with caplog.at_level(logging.WARNING):
        second.observe(0)
        second.observe(1)
    assert second._disabled and second.trace_path is None
    assert m.registry.counter("profiler_failures").value == 1
    assert any("another profiler window" in r.getMessage() for r in caplog.records)
    first.observe(2)
    assert [e["event"] for e in m.records] == ["profiler_started", "profiler_stopped"]
    # The window is free again once the first has closed.
    third = RoundProfiler(str(tmp_path / "c"), "5:6", metrics=m, device="cpu")
    third.observe(5)
    third.close()
    assert Path(third.trace_path).is_file()


def test_owners_give_the_profiler_their_device():
    prof = RoundProfiler("unused", "1:2")
    FederatedServer(min_clients=1, profiler=prof, device="cpu")
    assert str(prof.device) == "cpu"
    named = RoundProfiler("unused", "1:2", device="cuda")
    _client(profiler=named)
    assert named.device == "cuda"
