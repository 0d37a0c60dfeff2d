"""Crash survival of the port's federation server, on the CPU: the round
journal, its interchange with the JAX package's, the round checkpoints of a
JAX server, and federations over localhost gRPC.

- The journal's contract (``tests/test_survival.py:68-168``): round trips,
  loud corruption, halves that disagree, a finished stamp.
- A journal written by the JAX ``RoundJournal`` loads in the port bitwise,
  and the port's in JAX, files byte for byte; a port server autorecovers a
  JAX server's journal; pointed at a JAX server's orbax checkpoints with no
  journal, it raises ``CheckpointIntegrityError`` with a hint.
- (h) Kill and autorecover: a port server is aborted after round 4 (its
  training thread joined, as a real kill takes it along), a replacement
  built with the same arguments recovers from the journal, both port
  clients come back by session token under the delta codec, and the run
  finishes; a third server finds nothing to recover.
- (k) Interop at the defaults: a JAX client under a port server, and a port
  client under a JAX server, every default on, both finish, and each
  server's journal reads in the other package.
"""

import os
import socket
import threading
import time

import numpy as np
import pytest

from gfedntm_tpu.data.loaders import RawCorpus as JRawCorpus
from gfedntm_tpu.federation.client import Client as JClient
from gfedntm_tpu.federation.server import FederatedServer as JServer
from gfedntm_tpu.train.checkpoint import FederationCheckpointer as JCheckpointer
from gfedntm_tpu.train.checkpoint import RoundJournal as JRoundJournal
from gfedntm_tpu_torch.data.loaders import RawCorpus
from gfedntm_tpu_torch.federation.client import Client
from gfedntm_tpu_torch.federation.server import FederatedServer, build_template_model
from gfedntm_tpu_torch.train.checkpoint import (
    CheckpointIntegrityError,
    FederationCheckpointer,
    RoundJournal,
    atomic_write_json,
)
from gfedntm_tpu_torch.utils.observability import MetricsLogger

MODEL_KWARGS = dict(n_components=3, hidden_sizes=(8,), batch_size=8, num_epochs=2, seed=0)
AVG = {"p/beta": np.arange(6, dtype=np.float32).reshape(2, 3)}


def _documents(n_clients, docs, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"tok{i:02d}" for i in range(45)]
    return [[" ".join(rng.choice(words, size=12)) for _ in range(docs)]
            for _ in range(n_clients)]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# ---- the journal ------------------------------------------------------------

class TestRoundJournal:
    def test_record_load_roundtrip_with_aggregator_state(self, tmp_path):
        j = RoundJournal(str(tmp_path))
        assert j.load() is None
        j.record(5, AVG, [{"client_id": 1, "session_token": "tok"}], vocab=["a", "b"],
                 extra={"family": "avitm", "aggregator": "x"},
                 aggregator_state={"m": np.full(3, 2.0)})
        state = j.load()
        assert state["round"] == 5 and state["family"] == "avitm"
        assert bitwise(state["average"]["p/beta"], AVG["p/beta"])
        assert bitwise(state["aggregator_state"]["m"], np.full(3, 2.0))
        assert state["membership"][0]["session_token"] == "tok"

    def test_corrupt_meta_and_missing_state_are_loud(self, tmp_path):
        j = RoundJournal(str(tmp_path))
        j.record(1, AVG, [])
        with open(j.meta_path, "w") as fh:
            fh.write('{"round": 1, "aver')
        with pytest.raises(CheckpointIntegrityError):
            j.load()
        j.record(1, AVG, [])
        os.unlink(j.state_path)
        with pytest.raises(CheckpointIntegrityError):
            j.load()

    def test_halves_disagreeing_detected(self, tmp_path):
        j = RoundJournal(str(tmp_path))
        j.record(3, AVG, [])
        atomic_write_json(j.meta_path,
                          {"round": 2, "average_keys": sorted(AVG), "membership": []})
        with pytest.raises(CheckpointIntegrityError, match="disagree"):
            j.load()

    def test_finished_marker_suppresses_load(self, tmp_path):
        j = RoundJournal(str(tmp_path))
        j.record(7, AVG, [])
        j.mark_finished()
        assert j.load() is None and j.load_meta()["finished"] is True
        assert j.load(include_finished=True)["round"] == 7

    def test_checkpoint_sidecar_partial_write_regression(self, tmp_path):
        ckpt = FederationCheckpointer(str(tmp_path / "ck"))
        ckpt.save_round(2, {"w": np.ones((2, 2), np.float32)}, [{"client_id": 1}],
                        vocab=["a"])
        assert ckpt.load_meta()["round"] == 2
        with open(ckpt.meta_path, "w") as fh:
            fh.write('{"round": 2, "average_')
        with pytest.raises(CheckpointIntegrityError):
            ckpt.load_meta()


def journal_args(seed=0):
    rng = np.random.default_rng(seed)
    average = {"params/beta": rng.normal(size=(3, 7)).astype(np.float32),
               "batch_stats/bn/mean": rng.normal(size=7).astype(np.float32),
               "params/n": np.int32(4)}
    return dict(round_idx=6, average=average,
                membership=[{"client_id": 1, "nr_samples": 40.0, "current_mb": 3,
                             "current_epoch": 0, "finished": False, "status": "active",
                             "session_token": "ab" * 16}],
                vocab=["tok00", "tok01"],
                extra={"family": "avitm", "aggregator": "fedadam", "wire_codec": "delta",
                       "model_kwargs": {"n_components": 3, "hidden_sizes": [8]}},
                aggregator_state={"m::params/beta": rng.normal(size=(3, 7)).astype(np.float32)})


@pytest.mark.parametrize("writer,reader", [(JRoundJournal, RoundJournal),
                                           (RoundJournal, JRoundJournal)])
def test_journals_load_across_the_packages_bitwise(tmp_path, writer, reader):
    args = journal_args()
    writer(str(tmp_path / "w")).record(**args)
    twin = {RoundJournal: JRoundJournal, JRoundJournal: RoundJournal}[writer]
    twin(str(tmp_path / "t")).record(**args)
    for name in ("journal.json", "journal_state.npz"):
        assert (tmp_path / "w" / name).read_bytes() == (tmp_path / "t" / name).read_bytes()
    state = reader(str(tmp_path / "w")).load()
    assert state["round"] == 6
    assert set(state["average"]) == set(args["average"])
    for key, value in args["average"].items():
        assert bitwise(state["average"][key], value), key
    for key, value in args["aggregator_state"].items():
        assert bitwise(state["aggregator_state"][key], value), key
    assert state["membership"] == args["membership"]
    assert state["model_kwargs"] == args["extra"]["model_kwargs"]


def _crashed_state(tmp_path, writer_cls):
    """A journal of round 2 of an interrupted federation, written by
    ``writer_cls``: the averages are a port template's shared state."""
    from gfedntm_tpu_torch.federated.stepper import FederatedStepper

    vocab = [f"tok{i:02d}" for i in range(30)]
    template = build_template_model("avitm", 30, MODEL_KWARGS, device="cpu")
    shared = FederatedStepper(template).get_gradients()
    average = {k: (v + np.float32(0.5)).astype(v.dtype) if v.dtype.kind == "f" else v
               for k, v in shared.items()}
    writer_cls(str(tmp_path / "checkpoints")).record(
        2, average, [{"client_id": c, "nr_samples": 16.0, "current_mb": 2,
                      "current_epoch": 0, "finished": False, "status": "active",
                      "session_token": f"{c:032x}"} for c in (1, 2)],
        vocab=vocab, extra={"family": "avitm", "aggregator": "fedavg",
                            "wire_codec": "none", "model_kwargs": dict(MODEL_KWARGS)})
    return average


@pytest.mark.parametrize("writer", [JRoundJournal, RoundJournal])
def test_port_server_autorecovers_a_journal(tmp_path, writer):
    average = _crashed_state(tmp_path, writer)
    m = MetricsLogger(validate=True)
    server = FederatedServer(min_clients=2, model_kwargs=MODEL_KWARGS, save_dir=str(tmp_path),
                             metrics=m, device="cpu")
    assert server.maybe_autorecover() == 3
    assert server._recovered_source == "journal" and server.global_iterations == 3
    for key, value in average.items():
        assert bitwise(server.last_average[key], value), key
    assert sorted(c.client_id for c in server.federation.get_clients()) == [1, 2]
    assert server._resume_ready_needed == 1
    assert len(server.global_vocab) == 30
    assert m.registry.counter("server_recoveries").value == 1
    # The template carries the restored state: rejoiners replicate it.
    assert server._setup_reply is not None


def test_jax_server_autorecovers_a_port_servers_journal(tmp_path):
    """A port server's journal and round checkpoint (torch files, which
    orbax does not read) on disk: a JAX server recovers from the journal."""
    server = FederatedServer(min_clients=2, model_kwargs=MODEL_KWARGS, save_dir=str(tmp_path),
                             device="cpu")
    average = _crashed_state(tmp_path, RoundJournal)
    assert server.maybe_autorecover() == 3
    server.global_iterations = 3
    server._save_round_checkpoint()
    jserver = JServer(min_clients=2, model_kwargs=MODEL_KWARGS, save_dir=str(tmp_path))
    assert jserver.maybe_autorecover() == 3
    assert jserver._recovered_source == "journal"
    for key, value in average.items():
        assert bitwise(jserver.last_average[key], value), key


def test_port_server_refuses_a_jax_checkpoint_without_journal(tmp_path):
    JCheckpointer(str(tmp_path / "checkpoints")).save_round(
        4, {"params/beta": np.ones((3, 30), np.float32)}, [{"client_id": 1}],
        vocab=[f"tok{i:02d}" for i in range(30)])
    m = MetricsLogger(validate=True)
    server = FederatedServer(min_clients=1, model_kwargs=MODEL_KWARGS, save_dir=str(tmp_path),
                             metrics=m, device="cpu")
    with pytest.raises(CheckpointIntegrityError, match="journal"):
        server.maybe_autorecover()
    assert server.last_average is None and server.template is None
    assert m.registry.counter("checkpoint_invalid").value == 1


def test_nothing_to_recover(tmp_path):
    assert FederatedServer(min_clients=1, save_dir=str(tmp_path), device="cpu") \
        .maybe_autorecover() is None
    _crashed_state(tmp_path, RoundJournal)
    assert FederatedServer(min_clients=1, save_dir=str(tmp_path), device="cpu",
                           journal_every=0).maybe_autorecover() is None
    RoundJournal(str(tmp_path / "checkpoints")).mark_finished()
    assert FederatedServer(min_clients=1, save_dir=str(tmp_path), device="cpu") \
        .maybe_autorecover() is None


def test_reconnect_resets_the_codec_before_a_poll_is_answered():
    """A recovered server can start training on a client's ready and poll it
    at once; the reconnecting client answers that poll only after the codec
    reset the ready's Ack ordered, so its reply is self-contained and not a
    delta against a broadcast the recovered server never held."""
    import logging

    from gfedntm_tpu_torch.data.datasets import BowDataset
    from gfedntm_tpu_torch.federated.stepper import FederatedAVITM
    from gfedntm_tpu_torch.federation.client import FederatedClientServicer
    from gfedntm_tpu_torch.federation.compression import (
        DownlinkDecoder,
        UplinkEncoder,
        WireCodec,
    )
    from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb

    stepper = FederatedAVITM(build_template_model("avitm", 30, MODEL_KWARGS, device="cpu"))
    rng = np.random.default_rng(0)
    stepper.pre_fit(BowDataset(X=rng.integers(0, 3, size=(20, 30)).astype(np.float32)))
    codec = WireCodec("delta")
    uplink, downlink = UplinkEncoder(codec), DownlinkDecoder(codec)
    uplink.note_aggregate(stepper.get_gradients(), 4)  # the dead server's round 4
    servicer = FederatedClientServicer(1, stepper, lambda: None, logging.getLogger("t"),
                                       uplink=uplink, downlink=downlink)
    client = Client(client_id=1, corpus=RawCorpus(documents=["a b"]),
                    server_address="localhost:1", reconnect_window=5.0, device="cpu")
    client._servicer, client._uplink, client._downlink = servicer, uplink, downlink
    client._codec, client.session_token = codec, "ab" * 16
    replies, polls = [], []

    class RecoveredServer:
        def ReadyForTraining(self, request, timeout=None):
            # The recovered server's first poll, sent while the ready is in
            # flight.
            poll = threading.Thread(target=lambda: replies.append(servicer.TrainStep(
                pb.StepRequest(global_iter=5, local_steps=1, seq=11), None)))
            poll.start()
            poll.join(timeout=0.5)
            polls.append(poll)
            return pb.Ack(code=3, detail="reset")

    client._federation_stub = RecoveredServer()
    assert client._reconnect_loop(idle=0.0)
    polls[0].join(timeout=30)
    assert len(replies) == 1 and replies[0].seq == 11
    assert replies[0].shared.ref_round == 0  # self-contained, not a delta on round 4


# ---- federations ------------------------------------------------------------

def _await_round(server, round_idx, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and server.global_iterations < round_idx:
        time.sleep(0.02)
    assert server.global_iterations >= round_idx, f"never reached round {round_idx}"


def _abort_and_join(server):
    """In-process stand-in for a kill: abort, then wait for the abandoned
    training thread to exit, so its last journal write cannot race the
    replacement server's read."""
    server.abort()
    t = server._train_thread
    if t is not None:
        t.join(timeout=60.0)
        assert not t.is_alive(), "aborted training thread never exited"


def test_h_server_kill_autorecovery_with_session_reconnect(tmp_path):
    port = _free_port()
    address = f"127.0.0.1:{port}"
    kwargs = dict(min_clients=2, family="avitm", model_kwargs=dict(MODEL_KWARGS, num_epochs=4),
                  max_iters=80, save_dir=str(tmp_path / "server"), checkpoint_every=0,
                  wire_codec="delta", device="cpu")
    m1 = MetricsLogger(validate=True)
    server1 = FederatedServer(metrics=m1, **kwargs)
    server1.start(address)
    mc = MetricsLogger(validate=True)
    clients = [Client(client_id=c + 1, corpus=RawCorpus(documents=docs),
                      server_address=address, listen_address="127.0.0.1:0",
                      advertise_host="127.0.0.1", max_features=45,
                      save_dir=str(tmp_path / f"c{c + 1}"), metrics=mc,
                      liveness_timeout=8.0, watchdog_poll_s=0.1, reconnect_window=60.0,
                      wire_codec="delta", device="cpu")
               for c, docs in enumerate(_documents(2, docs=40, seed=3))]
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    server2 = None
    try:
        for t in threads:
            t.start()
        _await_round(server1, 4)
        _abort_and_join(server1)
        killed_at = server1.global_iterations
        assert killed_at < 20, "the federation finished before the kill"

        m2 = MetricsLogger(validate=True)
        server2 = FederatedServer(metrics=m2, **kwargs)
        resumed = server2.maybe_autorecover()
        assert resumed is not None and resumed >= killed_at - 1
        assert server2._recovered_source == "journal"
        server2.start(address)
        assert server2.wait_done(timeout=90), "the recovered run did not finish"
        for t in threads:
            t.join(timeout=30)
    finally:
        for server in (server1, server2):
            if server is not None:
                server.stop(grace=0.2)
        for c in clients:
            c.shutdown(grace=0.2)
    assert all(c.stopped.is_set() and c.stepper.finished for c in clients)
    assert np.isfinite(server2.global_betas).all()
    assert server2.global_iterations > resumed
    assert m2.registry.counter("session_restores").value == 2
    assert mc.registry.counter("client_reconnections").value == 2
    assert m2.registry.counter("codec_ref_miss").value == 0
    assert mc.registry.counter("codec_ref_miss").value == 0
    assert m2.registry.counter("rpcs_deduplicated").value == 0
    assert m2.registry.gauge("recovery_time_s").value >= 0
    server3 = FederatedServer(**kwargs)
    assert server3.maybe_autorecover() is None


def _run(server, clients, timeout=120.0):
    addr = server.start("[::]:0")  # the JAX server returns localhost:<port> for [::] only
    for c in clients:
        c.server_address = addr
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    try:
        for t in threads:
            t.start()
        assert server.wait_done(timeout=timeout), "the federation did not finish"
        for t in threads:
            t.join(timeout=30)
        assert all(not t.is_alive() for t in threads)
    finally:
        server.stop(grace=0.2)
        for c in clients:
            c.shutdown(grace=0.2)


@pytest.mark.parametrize("server_side", ["port", "jax"])
def test_k_interop_at_the_defaults(tmp_path, server_side):
    """A JAX and a port client under a port server at its defaults, and the
    same pair under a JAX server at its own: both finish with finite betas
    and every client finished, and the server's journal reads in the other
    package with the server's last average, bitwise."""
    save_dir = tmp_path / "server"
    common = dict(min_clients=2, family="avitm", model_kwargs=MODEL_KWARGS, max_iters=100,
                  save_dir=str(save_dir))
    server = (FederatedServer(device="cpu", **common) if server_side == "port"
              else JServer(**common))
    docs = _documents(2, docs=24, seed=4)
    clients = [JClient(client_id=1, corpus=JRawCorpus(documents=docs[0]),
                       server_address="", max_features=45),
               Client(client_id=2, corpus=RawCorpus(documents=docs[1]), server_address="",
                      listen_address="127.0.0.1:0", advertise_host="127.0.0.1",
                      max_features=45, device="cpu")]
    _run(server, clients)
    assert all(c.stepper.finished for c in clients)
    assert np.isfinite(server.global_betas).all()
    assert server.global_iterations == 6
    reader = JRoundJournal if server_side == "port" else RoundJournal
    state = reader(str(save_dir / "checkpoints")).load(include_finished=True)
    assert state["round"] == 5 and state["finished"]
    for key, value in server.last_average.items():
        assert bitwise(state["average"][key], value), key
