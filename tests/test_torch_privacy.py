"""The privacy plane in the port, on the CPU, held to the JAX package's.

- The copies (``privacy/accountant.py``, ``mechanisms.py``, ``__init__``)
  are the originals' sources but for their imports.
- Bitwise where the JAX path is numpy: the accountant's epsilon over a
  hypothesis sweep of (sigma, q, delta, steps) and its state round trip,
  ``host_noise_vector``, ``ServerNoiser`` on the host path and
  ``ClientSanitizer``.
- A port server under ``dp="server"`` on the numpy backend against a JAX
  server given the same snapshots: the same clipped, noised aggregates and
  the same ledger, round after round.
- Client-mode DP over localhost gRPC: port clients under a JAX server and
  JAX clients under a port server, each client's sanitizer replayed by the
  other package's on the captured inputs, bitwise the tensors on the wire.
- Recovery: a server-mode federation abandoned after its journal write
  resumes its ledger with one catch-up step and its noise index, in either
  package from either package's journal.
- ``DeviceAggEngine.noise_vector`` on the CPU: reproducible per (seed,
  index), and distribution-matched (zero mean, std within 5%), the JAX
  engine's contract.
"""

import threading
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gfedntm_tpu import privacy as jp
from gfedntm_tpu.data.loaders import RawCorpus as JRawCorpus
from gfedntm_tpu.federation.client import Client as JClient
from gfedntm_tpu.federation.protos import federated_pb2 as jpb
from gfedntm_tpu.federation.server import FederatedServer as JServer
from gfedntm_tpu.federation.server import build_template_model as j_build_template_model
from gfedntm_tpu.train.checkpoint import RoundJournal as JRoundJournal
from gfedntm_tpu_torch import privacy as tp
from gfedntm_tpu_torch.data.loaders import RawCorpus
from gfedntm_tpu_torch.federation import codec
from gfedntm_tpu_torch.federation.client import Client
from gfedntm_tpu_torch.federation.device_agg import DeviceAggEngine, FlatPlane, noise_seed
from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb
from gfedntm_tpu_torch.federation.server import FederatedServer, build_template_model
from gfedntm_tpu_torch.train.checkpoint import RoundJournal
from gfedntm_tpu_torch.utils.observability import MetricsLogger
from test_torch_federation_codec import _body

REPO = Path(__file__).resolve().parents[1]
MODEL_KWARGS = dict(n_components=6, hidden_sizes=(8, 8), batch_size=8, num_epochs=2, seed=0)
V = 120
DP = dict(dp_clip=1.0, dp_sigma=0.8, dp_delta=1e-5, dp_seed=7)


def bitwise(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def same_dicts(a, b) -> bool:
    return sorted(a) == sorted(b) and all(bitwise(a[k], b[k]) for k in a)


# ---- the copies ---------------------------------------------------------------

@pytest.mark.parametrize("module", ["privacy/accountant.py", "privacy/mechanisms.py",
                                    "privacy/__init__.py"])
def test_copies_are_the_originals(module):
    assert _body(REPO / "gfedntm_tpu_torch" / module, "gfedntm_tpu_torch") == _body(
        REPO / "gfedntm_tpu" / module, "gfedntm_tpu")


# ---- the accountant ---------------------------------------------------------

@settings(max_examples=30, deadline=None)
@given(sigma=st.floats(0.3, 8.0), q=st.floats(0.01, 1.0), delta=st.sampled_from([1e-3, 1e-5, 1e-7]),
       steps=st.integers(1, 25))
def test_accountant_epsilon_is_the_jax_ledgers(sigma, q, delta, steps):
    accts = [mod.PrivacyAccountant(sigma=sigma, delta=delta, budget=3.0) for mod in (tp, jp)]
    for _ in range(steps):
        assert accts[0].step(q=q) == accts[1].step(q=q)
    assert accts[0].epsilon(delta=1e-4) == accts[1].epsilon(delta=1e-4)
    assert accts[0].status() == accts[1].status()
    assert accts[0].state_dict() == accts[1].state_dict()
    # The ledger crosses the packages and continues.
    back = jp.PrivacyAccountant(sigma=sigma, delta=delta)
    back.load_state_dict(accts[0].state_dict())
    assert back.step(q=q) == accts[0].step(q=q)


@pytest.mark.parametrize("alpha,q,sigma", [(2, 0.5, 1.0), (8, 0.1, 2.0), (64, 1.0, 0.7),
                                           (33, 0.01, 4.0)])
def test_rdp_pieces_are_the_jax_ones(alpha, q, sigma):
    assert tp.subsampled_gaussian_rdp(alpha, q, sigma) == jp.subsampled_gaussian_rdp(alpha, q, sigma)
    rdp = {a: tp.subsampled_gaussian_rdp(a, q, sigma) * 5 for a in tp.ALPHAS}
    assert tp.eps_from_rdp(rdp, 1e-5) == jp.eps_from_rdp(rdp, 1e-5)


# ---- the mechanisms -----------------------------------------------------------

@pytest.mark.parametrize("dim,std,seed,index,extra", [(1, 1.0, 0, 0, ()), (1000, 0.3, 7, 5, ()),
                                                      (4097, 2.5, 3, 11, (4,))])
def test_host_noise_vector_is_the_jax_one(dim, std, seed, index, extra):
    assert bitwise(tp.host_noise_vector(dim, std, seed, index, extra),
                   jp.host_noise_vector(dim, std, seed, index, extra))


def _average(seed):
    rng = np.random.default_rng(seed)
    return {"params/beta": rng.normal(size=(6, 40)).astype(np.float32),
            "params/inf_net/f_mu/bias": rng.normal(size=6).astype(np.float32),
            "batch_stats/beta_batchnorm/mean": rng.normal(size=40).astype(np.float32),
            "batch_stats/beta_batchnorm/num_batches_tracked": np.array(7, np.int32)}


@pytest.mark.parametrize("n", [1, 2, 5])
def test_server_noiser_host_path_is_the_jax_one(n):
    specs = [mod.parse_dp("server", clip=0.5, sigma=1.3, seed=9) for mod in (tp, jp)]
    noisers = [mod.ServerNoiser(spec) for mod, spec in zip((tp, jp), specs)]
    for r in range(3):
        avg = _average(r)
        out = [nz.apply(avg, n) for nz in noisers]
        assert same_dicts(*out)
        assert bitwise(out[0]["batch_stats/beta_batchnorm/num_batches_tracked"],
                       avg["batch_stats/beta_batchnorm/num_batches_tracked"])
    assert noisers[0].applications == noisers[1].applications == 3
    assert noisers[0].noise_std(n) == 1.3 * 0.5 / n


@pytest.mark.parametrize("clip", [0.05, 100.0])
def test_client_sanitizer_is_the_jax_one(clip):
    sans = [mod.ClientSanitizer(mod.parse_dp("client", clip=clip, sigma=0.6, seed=4), client_id=3)
            for mod in (tp, jp)]
    logs = [MetricsLogger(keep_records=True), None]
    sans[0].metrics = logs[0]
    for r in range(3):
        params, ref = _average(10 + r), _average(20 + r)
        assert same_dicts(*(s.apply(params, ref, r) for s in sans))
    (event, *_rest) = logs[0].events("dp_noise_applied")
    assert event["clipped"] == (clip < 1.0) and event["index"] == 0 and event["n"] == 1


def test_parse_dp_validates_as_the_jax_one():
    for bad in (dict(mode="sever"), dict(mode="server"), dict(mode="client", sigma=1.0, clip=0),
                dict(mode="server", sigma=1.0, delta=1.5)):
        mode = bad.pop("mode")
        for mod in (tp, jp):
            with pytest.raises(ValueError):
                mod.parse_dp(mode, **bad)
    assert tp.parse_dp("off", sigma=-1) == tp.DPSpec("off")


# ---- the device noise -------------------------------------------------------

def test_device_noise_is_reproducible_per_seed_and_index():
    engine = DeviceAggEngine("cpu")
    plane = FlatPlane({"params/beta": np.zeros((50, 400), np.float32),
                       "params/b": np.zeros(17, np.float32)})
    a = engine.noise_vector(plane, std=0.7, seed=5, index=3)
    assert a.dtype == np.float32 and a.shape == (plane.dim,)
    assert bitwise(a, engine.noise_vector(plane, std=0.7, seed=5, index=3))
    for other in (dict(seed=5, index=4), dict(seed=6, index=3)):
        assert not np.array_equal(a, engine.noise_vector(plane, std=0.7, **other))
    # The JAX contract: a different PRNG from the host oracle, never equal.
    assert not np.array_equal(a, tp.host_noise_vector(plane.dim, 0.7, 5, 3))
    assert noise_seed(5, 3) == int(np.random.SeedSequence((5, 3)).generate_state(1, np.uint64)[0])


@pytest.mark.parametrize("std", [0.01, 1.0, 3.0])
def test_device_noise_matches_the_oracle_in_distribution(std):
    engine = DeviceAggEngine("cpu")
    plane = FlatPlane({"x": np.zeros(200_000, np.float32)})
    dev = engine.noise_vector(plane, std=std, seed=1, index=0).astype(np.float64)
    host = tp.host_noise_vector(plane.dim, std, 1, 0).astype(np.float64)
    for draws in (dev, host):
        assert abs(draws.mean()) < 0.02 * std
        assert abs(draws.std() / std - 1.0) < 0.05
    nxt = engine.noise_vector(plane, std=std, seed=1, index=1).astype(np.float64)
    assert abs(np.corrcoef(dev, nxt)[0, 1]) < 0.02


def test_server_noiser_draws_on_the_engine():
    spec = tp.parse_dp("server", clip=1.0, sigma=2.0, seed=3)
    log = MetricsLogger(keep_records=True)
    noiser = tp.ServerNoiser(spec, device_engine=DeviceAggEngine("cpu"), metrics=log)
    avg = _average(0)
    out = noiser.apply(avg, 4)
    assert log.events("dp_noise_applied")[0]["backend"] == "device"
    again = tp.ServerNoiser(spec, device_engine=DeviceAggEngine("cpu")).apply(avg, 4)
    assert same_dicts(out, again)
    diff = np.concatenate([(out[k] - avg[k]).ravel() for k in sorted(avg)
                           if avg[k].dtype == np.float32])
    assert 0.3 < diff.std() < 0.7  # std = 2.0 * 1.0 / 4


# ---- the server under dp="server" against the JAX server ----------------------

def _drive(server, base, rounds, journal=False):
    """Feed ``rounds`` (lists of per-client snapshots) through the server's
    admission gate, strategy, journal (with ``journal``) and ledger, in the
    round engine's order; returns the aggregates."""
    for c in (1, 2):
        server.federation.connect_vocab(c, ("a",), 4.0)
        server.federation.connect_ready(c, f"localhost:{c}")
    recs = server.federation.get_clients()
    server.last_average = base
    out = []
    for it, snaps in enumerate(rounds):
        replies = [(rec, pb.StepReply(client_id=rec.client_id, loss=1.0, nr_samples=4.0 + c,
                                      shared=codec.flatdict_to_bundle(s)))
                   for c, (rec, s) in enumerate(zip(recs, snaps))]
        if isinstance(server, JServer):
            replies = [(rec, jpb.StepReply.FromString(r.SerializeToString()))
                       for rec, r in replies]
        admitted = server._collect_snapshots(replies, it)
        avg = server.aggregator.aggregate(admitted, current_global=server._current_global())
        server.last_average = avg
        if journal:
            server._journal_round(it)
        server.global_iterations = it + 1
        server._privacy_tick(it)
        out.append(avg)
    return out


def test_server_mode_dp_matches_the_jax_server():
    kw = dict(min_clients=2, family="avitm", model_kwargs=MODEL_KWARGS, dp="server",
              dp_budget=20.0, **DP)
    port = FederatedServer(device="cpu", metrics=MetricsLogger(keep_records=True), **kw)
    jax_ = JServer(metrics=MetricsLogger(keep_records=True), **kw)
    port.template = build_template_model("avitm", V, MODEL_KWARGS, device="cpu")
    jax_.template = j_build_template_model("avitm", V, MODEL_KWARGS)
    base = port._shared_template()
    rng = np.random.default_rng(3)
    rounds = [[{k: (v + rng.normal(0, 0.05, v.shape)).astype(v.dtype) if v.dtype == np.float32
                else v for k, v in base.items()} for _c in range(2)] for _r in range(4)]
    got = _drive(port, base, rounds)
    want = _drive(jax_, base, rounds)
    assert port._agg_backend_resolved == jax_._agg_backend_resolved == "numpy"
    assert port.update_gate.max_update_norm == jax_.update_gate.max_update_norm == 1.0
    for a, b in zip(got, want):
        assert same_dicts(a, b)
    events = [m.events(name) for m in (port.metrics, jax_.metrics)
              for name in ("dp_noise_applied", "privacy_budget", "updates_clipped")]
    strip = [[{k: v for k, v in r.items() if k not in ("time", "node")} for r in rows]
             for rows in events]
    assert strip[:3] == strip[3:]
    assert port.privacy_accountant.state_dict() == jax_.privacy_accountant.state_dict()
    assert port._status()["privacy"] == jax_._status()["privacy"]
    assert port.metrics.registry.counter("updates_clipped").value == 8


def test_dp_off_constructs_nothing():
    server = FederatedServer(min_clients=1, device="cpu")
    assert server.privacy_accountant is None and server._dp_noiser is None
    assert server.aggregator.noiser is None and server._status()["privacy"] is None
    client = Client(client_id=1, corpus=RawCorpus(documents=["a b"]),
                    server_address="localhost:1", device="cpu")
    assert client._dp_sanitizer is None


def test_server_mode_without_sanitize_warns_and_keeps_the_gate_open(caplog):
    server = FederatedServer(min_clients=1, device="cpu", dp="server", sanitize=False, **DP)
    assert server.update_gate.max_update_norm is None
    assert "not enforcing the DP clip" in caplog.text


# ---- client-mode DP over the wire -----------------------------------------------

def _documents(n_clients=2, docs=18, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"word{i:03d}" for i in range(90)]
    return [[" ".join(rng.choice(words[20 * c:20 * c + 60], size=25))
             for _ in range(docs + 22 * c)] for c in range(n_clients)]


def _capturing(client):
    """Record every (params, reference, round, index) the client's sanitizer
    sees, and what it returns."""
    sanitizer = client._dp_sanitizer
    apply = sanitizer.apply
    client.captured = []

    def record(params, reference, round_index):
        index = sanitizer.applications
        out = apply(params, reference, round_index)
        client.captured.append(({k: np.array(v, copy=True) for k, v in params.items()},
                                {k: np.array(v, copy=True) for k, v in reference.items()},
                                round_index, index, out))
        return out

    sanitizer.apply = record
    return client


def _federate(tmp_path, server_side, client_side, server_dp="client"):
    kw = dict(min_clients=2, family="avitm", model_kwargs=MODEL_KWARGS, max_iters=200,
              save_dir=str(tmp_path / "server"), metrics=MetricsLogger(keep_records=True),
              dp=server_dp, **DP)
    server = JServer(**kw) if server_side == "jax" else FederatedServer(device="cpu", **kw)
    wire = []
    collect = server._collect_snapshots

    def keep(replies, iteration, *args, **kwargs):
        wire.extend((rec.client_id, r.shared.SerializeToString()) for rec, r in replies)
        return collect(replies, iteration, *args, **kwargs)

    server._collect_snapshots = keep
    addr = server.start("[::]:0")
    logs = [MetricsLogger(keep_records=True) for _ in range(2)]
    clients = []
    for c, docs in enumerate(_documents()):
        common = dict(client_id=c + 1, server_address=addr, max_features=80, metrics=logs[c],
                      dp="client", **DP)
        clients.append(_capturing(
            Client(corpus=RawCorpus(documents=docs), device="cpu", **common)
            if client_side == "port" else JClient(corpus=JRawCorpus(documents=docs), **common)))
    threads = [threading.Thread(target=cl.run, daemon=True) for cl in clients]
    try:
        for t in threads:
            t.start()
        assert server.wait_done(timeout=120.0), "federated training did not finish"
        for t in threads:
            t.join(timeout=30.0)
        assert all(not t.is_alive() for t in threads)
    finally:
        server.stop(grace=0.2, join_timeout=10.0)
        for cl in clients:
            cl.shutdown(grace=0.2)
    return server, clients, logs, wire


@pytest.mark.parametrize("server_side,client_side", [("jax", "port"), ("port", "jax")])
def test_client_mode_dp_across_the_packages(tmp_path, server_side, client_side):
    server, clients, logs, wire = _federate(tmp_path, server_side, client_side)
    other = jp if client_side == "port" else tp
    for cl, log in zip(clients, logs):
        events = log.events("dp_noise_applied")
        assert [r["index"] for r in events] == list(range(len(cl.captured))) and events
        assert all(r["mode"] == "client" and r["std"] == 0.8 for r in events)
        sent = [bundle for cid, bundle in wire if cid == cl.client_id]
        assert len(sent) == len(cl.captured)
        # The other package's sanitizer on the captured inputs gives bitwise
        # the tensors that went on the wire.
        for (params, ref, rnd, index, _out), bundle in zip(cl.captured, sent):
            replay = other.ClientSanitizer(other.parse_dp("client", clip=1.0, sigma=0.8, seed=7),
                                           client_id=cl.client_id)
            replay.applications = index
            on_wire = codec.bundle_to_flatdict(pb.TensorBundle.FromString(bundle))
            assert same_dicts(replay.apply(params, ref, rnd), on_wire)
        # The reference is the replicated init, then the last applied aggregate.
        assert cl.captured[0][2] == 0 and cl.captured[1][2] == 1
    ledger = server.metrics.events("privacy_budget")
    assert [r["steps"] for r in ledger] == list(range(1, server.global_iterations + 1))
    assert all(r["q"] == 1.0 and r["mode"] == "client" for r in ledger)
    assert not server.metrics.events("dp_noise_applied")
    assert np.isfinite(server.global_betas).all()


# ---- recovery of the ledger ---------------------------------------------------

def _dp_server(cls, tmp_path, **kw):
    extra = dict(device="cpu") if cls is FederatedServer else {}
    return cls(min_clients=2, family="avitm", model_kwargs=MODEL_KWARGS, dp="server",
               save_dir=str(tmp_path), metrics=MetricsLogger(keep_records=True), **DP, **extra,
               **kw)


def test_abandoned_server_resumes_its_ledger_and_noise_index(tmp_path):
    """A port server journals three noised rounds (each journal write before
    its round's ledger tick, as the engine orders them) and is abandoned (its
    process state lost, as a kill loses it); a fresh server of either package
    on the same save_dir resumes epsilon with one catch-up step, and the
    noise index after it."""
    server = _dp_server(FederatedServer, tmp_path)
    server.template = build_template_model("avitm", V, MODEL_KWARGS, device="cpu")
    server.global_vocab = type("Vocab", (), {"tokens": tuple(f"w{i}" for i in range(V))})()
    base = server._shared_template()
    rng = np.random.default_rng(0)
    rounds = [[{k: (v + rng.normal(0, 0.01, v.shape)).astype(v.dtype) if v.dtype == np.float32
                else v for k, v in base.items()} for _c in range(2)] for _r in range(3)]
    _drive(server, base, rounds, journal=True)
    assert server._dp_noiser.applications == server.privacy_accountant.steps == 3

    for cls in (FederatedServer, JServer):
        again = _dp_server(cls, tmp_path)
        assert again.maybe_autorecover() == 3
        # The journal of round 2 holds the ledger of two rounds: one
        # catch-up step charges the third, which may have left the server.
        assert again.privacy_accountant.state_dict() == server.privacy_accountant.state_dict()
        assert again._dp_noiser.applications == 3
    # The port server's next noised round draws index 3, a new draw.
    again = _dp_server(FederatedServer, tmp_path)
    again.maybe_autorecover()
    again._dp_noiser.apply(again.last_average, 2)
    assert again.metrics.events("dp_noise_applied")[-1]["index"] == 3
    assert [r["index"] for r in server.metrics.events("dp_noise_applied")] == [0, 1, 2]
    assert again.privacy_accountant.epsilon() == server.privacy_accountant.epsilon()


@pytest.mark.parametrize("writer", [JRoundJournal, RoundJournal])
def test_port_server_resumes_a_ledger_from_either_journal(tmp_path, writer):
    acct = jp.PrivacyAccountant(sigma=0.8, delta=1e-5, mode="server")
    for _ in range(6):
        acct.step()
    template = build_template_model("avitm", V, MODEL_KWARGS, device="cpu")
    from gfedntm_tpu_torch.federated.stepper import FederatedStepper

    average = FederatedStepper(template).get_gradients()
    writer(str(tmp_path / "checkpoints")).record(
        5, average, [{"client_id": 1, "nr_samples": 8.0, "current_mb": 1, "current_epoch": 0,
                      "finished": False, "status": "active", "session_token": "ab" * 16}],
        vocab=[f"w{i}" for i in range(V)],
        extra={"family": "avitm", "aggregator": "fedavg", "wire_codec": "none",
               "model_kwargs": dict(MODEL_KWARGS), "privacy": acct.state_dict()})
    server = _dp_server(FederatedServer, tmp_path)
    assert server.maybe_autorecover() == 6
    acct.step()
    assert server.privacy_accountant.state_dict() == acct.state_dict()
    assert server._dp_noiser.applications == 7
    assert server._state_extra()["privacy"] == acct.state_dict()
    # A server that now runs dp="off" carries no ledger, loudly.
    off = FederatedServer(min_clients=2, model_kwargs=MODEL_KWARGS, save_dir=str(tmp_path),
                          device="cpu")
    off.maybe_autorecover()
    assert off.privacy_accountant is None and "privacy" not in off._state_extra()


def test_jax_server_resumes_a_port_servers_ledger(tmp_path):
    server = _dp_server(FederatedServer, tmp_path)
    server.template = build_template_model("avitm", V, MODEL_KWARGS, device="cpu")
    server.global_vocab = type("Vocab", (), {"tokens": tuple(f"w{i}" for i in range(V))})()
    base = server._shared_template()
    _drive(server, base, [[base, base]] * 2, journal=True)
    jserver = _dp_server(JServer, tmp_path)
    assert jserver.maybe_autorecover() == 2
    assert jserver.privacy_accountant.steps == 2
    assert jserver.privacy_accountant.state_dict() == server.privacy_accountant.state_dict()
