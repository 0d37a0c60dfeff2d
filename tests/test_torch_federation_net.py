"""The port's gRPC federation on localhost, with the JAX package's nodes and
its own: server and clients run as threads in one process over real
sockets, on the CPU (``device="cpu"``). Two clients of unequal size (18 and
40 documents at batch 8: 3 and 5 steps per epoch), so one finishes early
and the server polls the other alone.

(a) JAX server, two port clients: each port client's state after the join
    is the JAX template's, bitwise; the StepReply sequences (current_mb,
    current_epoch, finished, nr_samples) equal those of the same federation
    with JAX clients; the shared state is bitwise equal across the port
    clients after every aggregate; the global betas are finite.
(b) JAX server, one JAX and one port client: the run finishes and the
    server's last average has the template's keys, shapes and dtypes.
(c) Port server, two JAX clients: the JAX join succeeds on the port's
    GlobalSetup, the run finishes, ``server_model.npz`` has the JAX
    server's keys.
(d) Port server, two port clients: every step loss, every StepStatus and
    the final beta are bitwise those of two in-process steppers driven
    through ``weighted_mean`` — the wire changes nothing.
(e) (a) under the ``delta+topk:0.25`` wire codec.
(f) (a) with CombinedTM and labels.
(g) A replayed TrainStep seq is answered from the replay cache, and nothing
    advances; a replayed push is ignored.
"""

import hashlib
import threading

import numpy as np
import pytest
import torch

from gfedntm_tpu.data.loaders import RawCorpus as JRawCorpus
from gfedntm_tpu.federation.client import Client as JClient
from gfedntm_tpu.federation.server import FederatedServer as JServer
from gfedntm_tpu_torch.data.loaders import RawCorpus
from gfedntm_tpu_torch.federated.aggregation import weighted_mean
from gfedntm_tpu_torch.federated.stepper import FederatedAVITM
from gfedntm_tpu_torch.federation import codec, rpc
from gfedntm_tpu_torch.federation.client import (
    Client,
    FederatedClientServicer,
    load_global_setup,
)
from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb
from gfedntm_tpu_torch.federation.server import (
    FederatedServer,
    build_template_model,
    model_opt_state,
    model_variables,
)

AVITM_KW = dict(n_components=4, hidden_sizes=(16, 16), batch_size=8, num_epochs=2, seed=0)
CTM_KW = dict(n_components=4, hidden_sizes=(8, 8), batch_size=8, num_epochs=2,
              contextual_size=6, label_size=3, inference_type="combined", seed=0)
TIMEOUT = 120.0


def documents(n_clients: int = 2, docs: int = 18, seed: int = 0):
    """``tests/test_federation_net.py``'s ``_make_corpora`` documents."""
    rng = np.random.default_rng(seed)
    words = [f"word{i:03d}" for i in range(90)]
    return [[" ".join(rng.choice(words[20 * c:20 * c + 60], size=25))
             for _ in range(docs + 22 * c)] for c in range(n_clients)]


def corpus(c, docs, ctm, cls):
    if not ctm:
        return cls(documents=docs)
    rng = np.random.default_rng(10 + c)
    return cls(documents=docs, embeddings=rng.normal(size=(len(docs), 6)).astype(np.float32),
               labels=rng.integers(0, 3, size=len(docs)))


def digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for key in sorted(arrays):
        h.update(key.encode())
        h.update(np.ascontiguousarray(arrays[key]).tobytes())
    return h.hexdigest()


class RecordingClient(Client):
    """A port client that records, after its join, its state's bundles and,
    per step, the loss, the StepStatus and a digest of its shared state."""

    def join_federation(self):
        super().join_federation()
        model = self.stepper.model
        self.joined = (codec.tree_to_bundle(model_variables(model)).SerializeToString(),
                       codec.tree_to_bundle(model_opt_state(model)).SerializeToString())
        self.losses, self.statuses, self.shared = [], [], []
        step, update = self.stepper.train_mb_delta, self.stepper.delta_update_fit

        def train_mb_delta(snapshot=True):
            out = step(snapshot)
            self.losses.append(self.stepper.loss)
            return out

        def delta_update_fit(averaged):
            status = update(averaged)
            self.statuses.append(status)
            self.shared.append((self.stepper.current_mb, digest(self.stepper.get_gradients())))
            return status

        self.stepper.train_mb_delta = train_mb_delta
        self.stepper.delta_update_fit = delta_update_fit


def recording(server_cls):
    """``server_cls`` recording every polled StepReply's accounting per
    client: (current_mb, current_epoch, finished, nr_samples)."""

    class Recording(server_cls):
        def _collect_snapshots(self, replies, iteration, *args, **kwargs):
            for rec, reply in replies:
                self.replies.setdefault(rec.client_id, []).append(
                    (reply.current_mb, reply.current_epoch, reply.finished, reply.nr_samples))
            return super()._collect_snapshots(replies, iteration, *args, **kwargs)

    return Recording


JRecServer, PRecServer = recording(JServer), recording(FederatedServer)


def federate(tmp_path, server_side, client_sides, family="avitm", wire_codec="none",
             local_steps=1):
    """Run one federation to its end; ``server_side`` and each of
    ``client_sides`` is ``"jax"`` or ``"port"``. Returns (server, clients)."""
    ctm = family == "ctm"
    kw = dict(CTM_KW if ctm else AVITM_KW)
    common = dict(min_clients=len(client_sides), family=family, model_kwargs=kw,
                  max_iters=200, save_dir=str(tmp_path / "server"), wire_codec=wire_codec,
                  local_steps=local_steps)
    server = (JRecServer(**common) if server_side == "jax"
              else PRecServer(device="cpu", **common))
    server.replies = {}
    addr = server.start("[::]:0")
    clients = []
    for c, (side, docs) in enumerate(zip(client_sides, documents(len(client_sides)))):
        if side == "port":
            clients.append(RecordingClient(
                client_id=c + 1, corpus=corpus(c, docs, ctm, RawCorpus), server_address=addr,
                max_features=80, device="cpu"))
        else:
            clients.append(JClient(client_id=c + 1, corpus=corpus(c, docs, ctm, JRawCorpus),
                                   server_address=addr, max_features=80))
    threads = [threading.Thread(target=cl.run, daemon=True) for cl in clients]
    try:
        for t in threads:
            t.start()
        assert server.wait_done(timeout=TIMEOUT), "federated training did not finish"
        for t in threads:
            t.join(timeout=30.0)
        assert all(cl.stopped.is_set() for cl in clients)
        assert all(not t.is_alive() for t in threads)
    finally:
        server.stop(grace=0.2, join_timeout=10.0)
        for cl in clients:
            cl.shutdown(grace=0.2)
    return server, clients


def check_port_clients(server, clients, reference):
    """(a)'s checks on a federation of port clients under a JAX server."""
    setup = server._setup_reply
    for cl in clients:
        assert cl.joined == (setup.init_variables.SerializeToString(),
                             setup.init_opt_state.SerializeToString())
    assert server.replies == reference.replies
    assert sorted(len(r) for r in server.replies.values()) == [6, 10]
    assert np.isfinite(server.global_betas).all()
    # Shared state bitwise equal across clients after every aggregate both
    # applied (the early finisher leaves after its sixth).
    a, b = (dict(cl.shared) for cl in clients)
    common = sorted(set(a) & set(b))
    assert len(common) == 6
    assert all(a[mb] == b[mb] for mb in common)


@pytest.fixture(scope="module")
def jax_clients_run(tmp_path_factory):
    return federate(tmp_path_factory.mktemp("jj"), "jax", ["jax", "jax"])


def test_a_jax_server_with_two_port_clients(tmp_path, jax_clients_run):
    server, clients = federate(tmp_path, "jax", ["port", "port"])
    check_port_clients(server, clients, jax_clients_run[0])
    assert [cl.stepper.current_epoch for cl in clients] == [2, 2]
    assert all(np.allclose(cl.results["thetas"].sum(1), 1.0) for cl in clients)


def test_b_jax_server_with_a_jax_and_a_port_client(tmp_path):
    server, clients = federate(tmp_path, "jax", ["jax", "port"])
    template = server._shared_template()
    assert sorted(server.last_average) == sorted(template)
    for key, value in template.items():
        got = np.asarray(server.last_average[key])
        assert got.shape == value.shape, key
        assert got.dtype == value.dtype or key.endswith("num_batches_tracked"), key
    assert np.isfinite(server.global_betas).all()
    assert clients[1].stepper.finished and clients[1].results is not None


def test_c_port_server_with_two_jax_clients(tmp_path, jax_clients_run):
    server, clients = federate(tmp_path, "port", ["jax", "jax"])
    assert server.replies == jax_clients_run[0].replies
    assert all(cl.stepper.finished for cl in clients)
    got = np.load(tmp_path / "server" / "server_model.npz")
    want = np.load(jax_clients_run[0].save_dir + "/server_model.npz")
    assert sorted(got.files) == sorted(want.files)
    for key in got.files:
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key
    assert np.isfinite(got["betas"]).all()


@pytest.mark.parametrize("local_steps", [1, 2])
def test_d_the_wire_is_bitwise_neutral(tmp_path, local_steps):
    """With ``local_steps`` E = 2 every round runs two local steps (the
    last round of an epoch budget fewer), the first without a snapshot,
    and the FedAvg weight is the samples of both."""
    server, clients = federate(tmp_path, "port", ["port", "port"], local_steps=local_steps)
    assert sorted(len(r) for r in server.replies.values()) == [-(-6 // local_steps),
                                                             -(-10 // local_steps)]
    # The same two steppers, driven in process from the server's init.
    steppers = []
    for cl in clients:
        model = build_template_model("avitm", len(server.global_vocab), AVITM_KW, device="cpu")
        load_global_setup(model, server._setup_reply)
        stepper = FederatedAVITM(model)
        stepper.pre_fit(cl.dataset)
        steppers.append(stepper)
    losses = [[] for _ in steppers]
    statuses = [[] for _ in steppers]
    while not all(s.finished for s in steppers):
        active = [c for c, s in enumerate(steppers) if not s.finished]
        snaps = []
        for c in active:
            st, samples = steppers[c], 0.0
            for _ in range(min(local_steps, st.steps_remaining) - 1):
                st.train_mb_delta(snapshot=False)
                losses[c].append(st.loss)
                samples += st._last_batch_size
                st.advance_local()
            snap = st.train_mb_delta()
            losses[c].append(st.loss)
            snaps.append((samples + st._last_batch_size, snap))
        avg = weighted_mean(snaps)
        for c in active:
            statuses[c].append(steppers[c].delta_update_fit(avg))
    for cl, stepper, loss, status in zip(clients, steppers, losses, statuses):
        assert cl.losses == loss
        assert cl.statuses == status
        assert torch.equal(cl.stepper.model.model.beta, stepper.model.model.beta)
        for key, value in stepper.model.model.state_dict().items():
            assert torch.equal(cl.stepper.model.model.state_dict()[key], value), key
    assert np.array_equal(server.global_betas, steppers[1].get_topics_in_server())
    assert (tmp_path / "server" / "server_model.npz").exists()


def test_e_a_non_identity_wire_codec(tmp_path, jax_clients_run):
    server, clients = federate(tmp_path, "jax", ["port", "port"], wire_codec="delta+topk:0.25")
    assert server.wire_codec.codec_id == "delta+topk:0.25"
    assert all(cl._codec.codec_id == "delta+topk:0.25" for cl in clients)
    check_port_clients(server, clients, jax_clients_run[0])


def test_f_combined_tm_with_labels(tmp_path):
    reference, _ = federate(tmp_path / "jax", "jax", ["jax", "jax"], family="ctm")
    server, clients = federate(tmp_path / "port", "jax", ["port", "port"], family="ctm")
    check_port_clients(server, clients, reference)
    assert "params/label_classification/kernel" in server.last_average
    assert all(cl.dataset.labels.shape == (len(cl.dataset), 3) for cl in clients)


def test_g_a_replayed_train_step_is_answered_from_the_cache():
    model = build_template_model("avitm", 30, AVITM_KW, device="cpu")
    stepper = FederatedAVITM(model)
    rng = np.random.default_rng(0)
    from gfedntm_tpu_torch.data.datasets import BowDataset
    stepper.pre_fit(BowDataset(X=rng.integers(0, 3, size=(20, 30)).astype(np.float32)))
    servicer = FederatedClientServicer(1, stepper, lambda: None,
                                       __import__("logging").getLogger("g"))
    grpc_server = rpc.make_server(max_workers=2)
    rpc.add_service(grpc_server, "gfedntm.FederationClient", servicer)
    port = grpc_server.add_insecure_port("[::]:0")
    grpc_server.start()
    channel = rpc.make_channel(f"localhost:{port}")
    try:
        stub = rpc.ServiceStub(channel, "gfedntm.FederationClient", default_timeout=30.0)
        first = stub.TrainStep(pb.StepRequest(global_iter=0, local_steps=1, seq=7))
        state = digest(stepper.get_gradients())
        again = stub.TrainStep(pb.StepRequest(global_iter=0, local_steps=1, seq=7))
        assert again.SerializeToString() == first.SerializeToString()
        assert digest(stepper.get_gradients()) == state
        assert stepper.current_mb == 0 and stepper._pending_step
        avg = codec.bundle_to_flatdict(first.shared)
        ack = stub.ApplyAggregate(pb.Aggregate(shared=first.shared, round=0))
        assert stepper.current_mb == 1 and not ack.finished
        stub.ApplyAggregate(pb.Aggregate(shared=codec.flatdict_to_bundle(
            {k: v * 0 for k, v in avg.items()}), round=0))
        assert stepper.current_mb == 1
        assert digest(stepper.get_gradients()) == digest(avg)
        later = stub.TrainStep(pb.StepRequest(global_iter=1, local_steps=1, seq=8))
        assert later.current_mb == 1 and later.base_round == 1
    finally:
        channel.close()
        grpc_server.stop(0)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FederatedServer(min_clients=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Client(client_id=1, corpus=RawCorpus(documents=["a b"]), server_address="localhost:1")


@pytest.mark.parametrize("option", [dict(sanitize=True), dict(checkpoint_every=25),
                                    dict(journal_every=1), dict(dp="server"),
                                    dict(divergence_patience=3), dict(ops_port=0),
                                    dict(pacing_policy="push:2"),
                                    dict(aggregation_backend="device"),
                                    dict(aggregator="fedadam")])
def test_server_refuses_planes_not_ported(option):
    with pytest.raises(NotImplementedError):
        FederatedServer(min_clients=1, device="cpu", **option)


@pytest.mark.parametrize("option", [dict(mesh_devices=2), dict(dp="client"),
                                    dict(dump_dir="x"), dict(profiler=object()),
                                    dict(failover_addrs=("localhost:2",))])
def test_client_refuses_options_not_ported(option):
    with pytest.raises(NotImplementedError):
        Client(client_id=1, corpus=RawCorpus(documents=["a b"]),
               server_address="localhost:1", device="cpu", **option)
