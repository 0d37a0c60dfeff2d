"""The port's relay tier (``gfedntm_tpu_torch/federation/relay.py``) against
the JAX package's, on the CPU.

- The relay's shared key set, shapes and dtypes are the JAX relay's
  ``_shared_flat`` for AVITM and for CombinedTM with labels, and its
  pseudo-update is bitwise the JAX relay's on the same member replies, with
  the summed weight.
- ``tests/test_hierarchy_survival.py::TestRelayJournalEdges`` against the
  port relay, and a shard journal adopted across the packages both ways.
- ``tests/test_fleet_telemetry.py``'s relay cases: the merged shard report
  equals the flat merge, and a respawned relay's first report is full.
- Federations over localhost gRPC (relay ids 101 and 102, member ids 1-4):
  a single shard; two relays x two clients against the flat federation
  (beta within 1e-4); a poisoned member screened at the relay; a push-paced
  root refused at the join; a port relay under a JAX root and a JAX relay
  under a port root; a relay killed and respawned from its journal.
- ``RelayNode`` with ``device=None`` raises without CUDA.
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from gfedntm_tpu.data.loaders import RawCorpus as JRawCorpus
from gfedntm_tpu.data.vocab import Vocabulary as JVocabulary
from gfedntm_tpu.federation import codec as j_codec
from gfedntm_tpu.federation.client import Client as JClient
from gfedntm_tpu.federation.protos import federated_pb2 as jpb
from gfedntm_tpu.federation.relay import RelayNode as JRelayNode
from gfedntm_tpu.federation.relay import _shared_flat as j_shared_flat
from gfedntm_tpu.federation.server import FederatedServer as JServer
from gfedntm_tpu.federation.server import build_template_model as j_build
from gfedntm_tpu.utils.observability import MetricsLogger as JMetricsLogger
from gfedntm_tpu_torch.data.loaders import RawCorpus
from gfedntm_tpu_torch.data.vocab import Vocabulary
from gfedntm_tpu_torch.federation import codec
from gfedntm_tpu_torch.federation.client import Client
from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb
from gfedntm_tpu_torch.federation.relay import RelayNode, shared_flat
from gfedntm_tpu_torch.federation.resilience import FaultInjector
from gfedntm_tpu_torch.federation.server import FederatedServer, build_template_model
from gfedntm_tpu_torch.models.params import SHARE_ALL
from gfedntm_tpu_torch.train.checkpoint import RoundJournal
from gfedntm_tpu_torch.utils.observability import (
    FleetRegistry,
    MetricsLogger,
    TelemetryShipper,
    merge_node_snapshots,
)

MODEL_KWARGS = dict(n_components=3, hidden_sizes=(8,), batch_size=8, num_epochs=2, seed=0)
V = 30
TEMPLATES = {
    "avitm": ("avitm", dict(n_components=4, hidden_sizes=(8, 8), batch_size=8, seed=0)),
    "combined_labels": ("ctm", dict(n_components=4, hidden_sizes=(8, 8), batch_size=8,
                                    contextual_size=6, label_size=3,
                                    inference_type="combined", seed=0)),
}
RELAY_IDS = (101, 102)  # disjoint from the member ids, as a re-homed member needs


def bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _documents(n, docs=16, seed=11):
    rng = np.random.default_rng(seed)
    words = [f"tok{i:02d}" for i in range(45)]
    return [[" ".join(rng.choice(words, size=12)) for _ in range(docs)] for _ in range(n)]


# ---- the template and the pre-reduction --------------------------------------

@pytest.mark.parametrize("model", sorted(TEMPLATES))
def test_shared_key_set_is_the_jax_relays(model):
    family, kw = TEMPLATES[model]
    port = shared_flat(build_template_model(family, V, kw, device="cpu"), SHARE_ALL)
    jax_ = j_shared_flat(j_build(family, V, kw), SHARE_ALL)
    assert sorted(port) == sorted(jax_)
    for key, value in jax_.items():
        assert port[key].shape == value.shape and port[key].dtype == value.dtype, key


class _Stub:
    def __init__(self, reply):
        self.reply = reply

    def TrainStep(self, request, timeout=None, **kw):
        return self.reply


def _pseudo_update(relay, proto, snaps, template):
    """One upstream round of ``relay`` whose members answer ``snaps``
    (identity codec), with ``template`` as the gate's."""
    relay._template_flat = template
    relay.update_gate.set_template(template)
    replies = {}
    for cid, (weight, snap) in snaps.items():
        relay.federation.connect_ready(cid, f"member{cid}")
        replies[cid] = proto.StepReply(
            client_id=cid, shared=proto.TensorBundle.FromString(
                codec.flatdict_to_bundle(snap).SerializeToString()),
            loss=0.5 + cid, nr_samples=weight, current_mb=cid, current_epoch=0)
    relay._member_stub = lambda rec: _Stub(replies[rec.client_id])
    return relay._train_round(proto.StepRequest(global_iter=0, local_steps=1, seq=7))


def test_pseudo_update_is_bitwise_the_jax_relays():
    """The same decoded member snapshots through the port relay and the JAX
    relay: the same pseudo-update bytes (the float64 mean cast back to the
    template's dtypes), the summed weight, the weighted loss."""
    template = shared_flat(build_template_model("avitm", V, MODEL_KWARGS, device="cpu"),
                           SHARE_ALL)
    rng = np.random.default_rng(3)
    snaps = {}
    for cid, weight in ((1, 8.0), (2, 5.0), (3, 8.0)):
        snaps[cid] = (weight, {
            k: (v + rng.normal(scale=0.1, size=v.shape)).astype(v.dtype)
            if v.dtype.kind == "f" else (v + cid).astype(v.dtype)
            for k, v in template.items()})
    port = _pseudo_update(RelayNode(relay_id=101, upstream_address="unused:0",
                                    min_members=3, device="cpu"), pb, snaps, template)
    jax_ = _pseudo_update(JRelayNode(relay_id=101, upstream_address="unused:0",
                                     min_members=3), jpb, snaps, template)
    assert port.nr_samples == jax_.nr_samples == 21.0
    assert port.loss == jax_.loss
    got = codec.bundle_to_flatdict(port.shared)
    want = j_codec.bundle_to_flatdict(jax_.shared)
    assert sorted(got) == sorted(want) == sorted(template)
    for key in template:
        assert bitwise(got[key], want[key]), key
        assert got[key].dtype == template[key].dtype, key


def test_relay_refuses_push_paced_root():
    relay = RelayNode(relay_id=101, upstream_address="unused:0", min_members=1,
                      device="cpu")
    relay.federation.connect_vocab(1, ("a", "b"), 4.0)

    class _Root:
        def OfferVocab(self, req, **kw):
            return pb.Ack(code=0)

        def GetGlobalSetup(self, req, timeout=None, **kw):
            return pb.GlobalSetup(vocab=["a", "b"], model_family="avitm",
                                  pacing_id="push:4", hyperparams_json="{}")

    relay._fed_stub = _Root()
    with pytest.raises(ValueError, match="push"):
        relay._upstream_setup()


def test_relay_entry_point_refuses_cpu_without_being_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RelayNode(relay_id=101, upstream_address="unused:0", min_members=1)
    assert RelayNode(relay_id=101, upstream_address="unused:0", min_members=1,
                     device="cpu").device == torch.device("cpu")


# ---- the shard journal -------------------------------------------------------

def _relay(tmp_path=None, **kw):
    kw.setdefault("relay_id", 101)
    kw.setdefault("upstream_address", "unused:0")
    kw.setdefault("min_members", 1)
    kw.setdefault("device", "cpu")
    if tmp_path is not None:
        kw.setdefault("save_dir", str(tmp_path))
    return RelayNode(**kw)


def _write_journal(save_dir: str, relay: int = 101) -> RoundJournal:
    journal = RoundJournal(f"{save_dir}/checkpoints")
    journal.record(0, {"w": np.zeros(2, np.float32)}, [], vocab=["a", "b"],
                   extra={"relay": relay, "upstream_session": "tok", "codec_id": "none",
                          "setup_base_b64": ""})
    return journal


class TestRelayJournalEdges:
    def test_fresh_start_without_journal(self, tmp_path):
        assert _relay(tmp_path).maybe_autorecover() is None

    def test_disabled_without_save_dir_or_journaling(self, tmp_path):
        assert _relay().maybe_autorecover() is None
        assert _relay(tmp_path, journal_every=0).maybe_autorecover() is None

    def test_finished_journal_starts_fresh(self, tmp_path):
        _write_journal(str(tmp_path)).mark_finished()
        assert _relay(tmp_path).maybe_autorecover() is None

    def test_foreign_shard_refused(self, tmp_path):
        _write_journal(str(tmp_path), relay=102)
        with pytest.raises(ValueError, match="refusing to adopt"):
            _relay(tmp_path).maybe_autorecover()

    def test_journal_write_failure_degrades_loudly(self, tmp_path):
        metrics = MetricsLogger(validate=True)
        relay = _relay(tmp_path, metrics=metrics)
        relay.global_vocab = Vocabulary(("a", "b"))
        with relay._setup_lock:
            relay._setup_base = pb.GlobalSetup()

        class _BrokenJournal:
            calls = 0

            def record(self, *a, **kw):
                self.calls += 1
                raise OSError(28, "No space left on device")

        broken = _BrokenJournal()
        relay._round_journal = broken
        relay._journal_shard()
        assert relay._journal_disabled
        events = metrics.events("journal_write_failed")
        assert len(events) == 1 and "No space left" in events[0]["error"]
        assert metrics.registry.snapshot()["journal_write_failures"]["value"] == 1.0
        relay._journal_shard()
        assert broken.calls == 1
        assert len(metrics.events("journal_write_failed")) == 1


def _setup_base():
    """A real downstream setup base: a port server's consensus reply for
    two members, relay-paced and token-less."""
    server = FederatedServer(min_clients=2, model_kwargs=MODEL_KWARGS, device="cpu")
    words = [f"tok{i:02d}" for i in range(V)]
    server.federation.connect_vocab(101, tuple(words[:20]), 16.0)
    server.federation.connect_vocab(102, tuple(words[10:]), 16.0)
    base = server._build_setup_reply()
    base.pacing_id = "sync"
    return base


def _journaled_shard(relay, proto, vocab_cls, base_bytes, flat_fn):
    """Give ``relay`` a restored-looking shard (round 4, two members with
    tokens, an average off the template) and journal it."""
    base = proto.GlobalSetup.FromString(base_bytes)
    relay.global_vocab = vocab_cls(tuple(base.vocab))
    relay._negotiate_codec("delta")
    relay._template_flat = flat_fn(base)
    relay._setup_base = base
    relay.session_token = "cd" * 16
    relay._applied_round = 4
    relay._current = {k: (v + np.float32(0.25)).astype(v.dtype) if v.dtype.kind == "f" else v
                      for k, v in relay._template_flat.items()}
    for cid in (1, 2):
        relay.federation.connect_vocab(cid, ("tok00",), 8.0 * cid)
        relay.federation.set_session_token(cid, f"{cid:032x}")
        relay.federation.connect_ready(cid, f"m{cid}")
    relay._journal_shard()
    return relay._current


def _port_flat(base):
    import json

    hyper = json.loads(base.hyperparams_json)
    return shared_flat(build_template_model(hyper["family"], len(base.vocab), hyper["kwargs"],
                                            device="cpu"), tuple(hyper["grads_to_share"]))


def _jax_flat(base):
    import json

    hyper = json.loads(base.hyperparams_json)
    return j_shared_flat(j_build(hyper["family"], len(base.vocab), hyper["kwargs"]),
                         tuple(hyper["grads_to_share"]))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shard_journal_adopted_across_the_packages(tmp_path, writer):
    """A shard journal written by one package's relay is adopted by the
    other's relay of the same id: the round, the average bitwise in the
    template's dtypes, the members with their tokens, the upstream session,
    the codec and the setup; a relay of another id refuses it."""
    base = _setup_base().SerializeToString()
    if writer == "jax":
        src = JRelayNode(relay_id=101, upstream_address="unused:0", min_members=2,
                         save_dir=str(tmp_path))
        average = _journaled_shard(src, jpb, JVocabulary, base, _jax_flat)
        dst = RelayNode(relay_id=101, upstream_address="unused:0", min_members=2,
                        save_dir=str(tmp_path), metrics=MetricsLogger(validate=True),
                        device="cpu")
    else:
        src = RelayNode(relay_id=101, upstream_address="unused:0", min_members=2,
                        save_dir=str(tmp_path), device="cpu")
        average = _journaled_shard(src, pb, Vocabulary, base, _port_flat)
        dst = JRelayNode(relay_id=101, upstream_address="unused:0", min_members=2,
                         save_dir=str(tmp_path), metrics=JMetricsLogger(validate=True))
    assert dst.maybe_autorecover() == 4
    assert dst._recovered and dst._resume_ready_needed == 1
    assert dst.session_token == "cd" * 16 and dst._codec.codec_id == "delta"
    assert dst._setup_base.SerializeToString() == base
    assert sorted(dst._current) == sorted(average)
    for key, value in average.items():
        assert bitwise(dst._current[key], value), key
    members = {c.client_id: c for c in dst.federation.get_clients()}
    assert sorted(members) == [1, 2]
    assert all(members[c].session_token == f"{c:032x}" for c in (1, 2))
    assert all(members[c].needs_codec_reset and not members[c].ready_for_training
               for c in (1, 2))
    assert len(dst.metrics.events("relay_recovered")) == 1
    with pytest.raises(ValueError, match="refusing to adopt"):
        _relay(tmp_path, relay_id=102).maybe_autorecover()


# ---- the shard's telemetry ---------------------------------------------------

def _observe_series(registry, values):
    h = registry.histogram("local_step_s")
    for v in values:
        h.observe(v)


def test_relay_merged_shard_report_equals_flat_merge():
    relay = RelayNode(relay_id=103, upstream_address="unused:0", min_members=2, device="cpu")
    members = {}
    for cid in (1, 2):
        m = MetricsLogger(node=f"client{cid}")
        _observe_series(m.registry, [0.001 * (cid + k) for k in range(4)])
        m.registry.counter("steps").inc(4)
        members[cid] = m
        relay.fleet.ingest_bytes(TelemetryShipper(registry=m.registry,
                                                  node=f"client{cid}").build())
    root = FleetRegistry()
    root.ingest_bytes(relay._shipper.build())
    assert set(root.node_snapshots()) == {"relay103:shard"}
    flat = merge_node_snapshots({f"client{cid}": m.registry.snapshot()
                                 for cid, m in members.items()})
    merged = root.merged()
    assert merged["steps"]["value"] == flat["steps"]["value"] == 8.0
    assert merged["local_step_s"] == flat["local_step_s"]


def test_respawned_relay_first_build_heals_root_view():
    root = FleetRegistry()
    members = {}
    for cid in (1, 2):
        m = MetricsLogger(node=f"client{cid}")
        _observe_series(m.registry, [0.001 * (cid + k) for k in range(3)])
        m.registry.counter("steps").inc(3)
        members[cid] = m
    relay = RelayNode(relay_id=107, upstream_address="unused:0", min_members=2, device="cpu")
    for cid, m in members.items():
        relay.fleet.ingest_bytes(TelemetryShipper(registry=m.registry,
                                                  node=f"client{cid}").build())
    root.ingest_bytes(relay._shipper.build())  # full
    for cid, m in members.items():
        _observe_series(m.registry, [0.01 * cid])
        m.registry.counter("steps").inc(1)
        relay.fleet.ingest_bytes(TelemetryShipper(registry=m.registry,
                                                  node=f"client{cid}").build())
    root.ingest_bytes(relay._shipper.build())
    # The kill: the respawn holds a fresh shipper, and the members re-ship
    # full reports on their token reconnects.
    relay2 = RelayNode(relay_id=107, upstream_address="unused:0", min_members=2, device="cpu")
    for cid, m in members.items():
        _observe_series(m.registry, [0.02 * cid, 0.03])
        m.registry.counter("steps").inc(2)
        relay2.fleet.ingest_bytes(TelemetryShipper(registry=m.registry,
                                                   node=f"client{cid}").build())
    root.ingest_bytes(relay2._shipper.build())  # a fresh shipper's first build is full
    assert set(root.node_snapshots()) == {"relay107:shard"}
    flat = merge_node_snapshots({f"client{cid}": m.registry.snapshot()
                                 for cid, m in members.items()})
    merged = root.merged()
    assert merged["steps"]["value"] == flat["steps"]["value"] == 12.0
    assert merged["local_step_s"] == flat["local_step_s"]


# ---- federations over localhost gRPC -----------------------------------------

def _port_client(cid, docs, address, tmp_path, tag, **kw):
    return Client(client_id=cid, corpus=RawCorpus(documents=docs), server_address=address,
                  listen_address="127.0.0.1:0", advertise_host="127.0.0.1", max_features=45,
                  save_dir=str(tmp_path / f"{tag}-c{cid}"), device="cpu", **kw)


def _run(clients, servers, relays, timeout=120.0):
    """Run ``clients`` in threads until the root (``servers[0]``) is done;
    then stop everything. A client that raises fails the test."""
    errors = []

    def run(client):
        try:
            client.run()
        except BaseException as err:  # reported below
            errors.append(f"client {client.client_id}: {err!r}")

    threads = [threading.Thread(target=run, args=(c,), daemon=True) for c in clients]
    try:
        for t in threads:
            t.start()
        assert servers[0].wait_done(timeout=timeout), "the federation did not finish"
        for t in threads:
            t.join(timeout=60)
        for r in relays:
            assert r.wait_done(timeout=30), f"relay {r.relay_id} did not stop"
        assert not errors, errors
    finally:
        for s in servers:
            s.stop()
        for r in relays:
            r.shutdown()
        for c in clients:
            c.shutdown()


def run_flat(tmp_path, corpora, tag, **server_kw):
    server = FederatedServer(min_clients=len(corpora), model_kwargs=MODEL_KWARGS,
                             max_iters=60, save_dir=str(tmp_path / f"{tag}-server"),
                             checkpoint_every=0, round_backoff_s=0.05, device="cpu",
                             **server_kw)
    address = server.start("127.0.0.1:0")
    clients = [_port_client(c + 1, docs, address, tmp_path, tag)
               for c, docs in enumerate(corpora)]
    _run(clients, [server], [])
    return server, clients


def run_hier(tmp_path, corpora, tag, n_relays=2, metrics=None, relay_kw=None,
             root_kw=None, client_kw=None):
    per_shard = len(corpora) // n_relays
    root = FederatedServer(min_clients=n_relays, model_kwargs=MODEL_KWARGS, max_iters=60,
                           save_dir=str(tmp_path / f"{tag}-root"), metrics=metrics,
                           checkpoint_every=0, round_backoff_s=0.05, device="cpu",
                           **(root_kw or {}))
    root_addr = root.start("127.0.0.1:0")
    relays = [RelayNode(relay_id=RELAY_IDS[r], upstream_address=root_addr,
                        min_members=per_shard, listen_address="127.0.0.1:0",
                        advertise_host="127.0.0.1", metrics=metrics, device="cpu",
                        **(relay_kw or {}))
              for r in range(n_relays)]
    relay_addrs = [r.start() for r in relays]
    clients = [_port_client(c + 1, docs, relay_addrs[c // per_shard], tmp_path, tag,
                            **(client_kw or {}))
               for c, docs in enumerate(corpora)]
    _run(clients, [root], relays)
    return root, relays, clients


def test_relay_single_shard_e2e(tmp_path):
    metrics = MetricsLogger(validate=True, keep_records=True)
    root, relays, clients = run_hier(tmp_path, _documents(2), "single", n_relays=1,
                                     metrics=metrics)
    assert root.global_betas is not None and np.isfinite(root.global_betas).all()
    for c in clients:
        assert c.stepper.finished and c.results is not None
    assert [c.client_id for c in root.federation.get_clients()] == [101]
    pre = metrics.events("relay_preaggregated")
    assert len(pre) == root.global_iterations and all(e["relay"] == 101 for e in pre)
    assert all(e["admitted"] == 2 and e["members"] == 2 for e in pre)
    joined = metrics.events("relay_joined")
    assert len(joined) == 1 and joined[0]["members"] == 2 and joined[0]["weight"] == 32.0


def test_two_relays_match_the_flat_federation(tmp_path):
    """2 relays x 2 clients reach betas within 1e-4 of the flat 4-client
    port federation on the same corpora: the mean of shard means with
    summed weights is the flat FedAvg, up to float re-association."""
    corpora = _documents(4)
    flat, _ = run_flat(tmp_path, corpora, "flat")
    hier, relays, clients = run_hier(tmp_path, corpora, "hier", n_relays=2)
    assert sorted(c.client_id for c in hier.federation.get_clients()) == [101, 102]
    assert hier.global_iterations == flat.global_iterations
    delta = float(np.max(np.abs(flat.global_betas - hier.global_betas)))
    assert delta < 1e-4, f"flat vs hierarchical betas differ by {delta}"


def test_poisoned_member_screened_at_the_relay(tmp_path):
    metrics = MetricsLogger(validate=True, keep_records=True)
    injector = FaultInjector(seed=0, metrics=metrics)
    injector.script("TrainStep", kind="corrupt", payload="scale:100", times=64,
                    peer="client3")
    root, relays, clients = run_hier(tmp_path, _documents(3), "poison", n_relays=1,
                                     metrics=metrics,
                                     relay_kw=dict(fault_injector=injector, outlier_mad_k=6.0))
    assert root.global_betas is not None and np.isfinite(root.global_betas).all()
    rejections = metrics.events("update_rejected")
    assert rejections and all(e["client"] == 3 for e in rejections)
    for c in clients[:2]:
        assert c.stepper.finished


@pytest.mark.parametrize("root_side", ["jax", "port"])
def test_interop_relays_across_the_packages(tmp_path, root_side):
    """A port relay under a JAX root, and a JAX relay under a port root,
    each terminating one JAX and one port member: every member finishes,
    the relay pre-aggregates both in every root round, the root's betas are
    finite."""
    docs = _documents(2, seed=5)
    if root_side == "jax":
        root = JServer(min_clients=1, model_kwargs=MODEL_KWARGS, max_iters=60,
                       save_dir=str(tmp_path / "root"), checkpoint_every=0,
                       round_backoff_s=0.05)
        root_addr = root.start("[::]:0")
        log = MetricsLogger(validate=True, keep_records=True)
        relay = RelayNode(relay_id=101, upstream_address=root_addr, min_members=2,
                          listen_address="127.0.0.1:0", advertise_host="127.0.0.1",
                          metrics=log, device="cpu")
    else:
        root = FederatedServer(min_clients=1, model_kwargs=MODEL_KWARGS, max_iters=60,
                               save_dir=str(tmp_path / "root"), checkpoint_every=0,
                               round_backoff_s=0.05, device="cpu")
        root_addr = root.start("127.0.0.1:0")
        log = JMetricsLogger(validate=True, keep_records=True)
        relay = JRelayNode(relay_id=101, upstream_address=root_addr, min_members=2,
                           metrics=log)
    relay_addr = relay.start()
    clients = [JClient(client_id=1, corpus=JRawCorpus(documents=docs[0]),
                       server_address=relay_addr, max_features=45,
                       save_dir=str(tmp_path / "j1")),
               _port_client(2, docs[1], relay_addr, tmp_path, "p")]
    _run(clients, [root], [relay])
    for c in clients:
        assert c.stepper.finished and c.results is not None
    assert root.global_betas is not None and np.isfinite(root.global_betas).all()
    pre = log.events("relay_preaggregated")
    assert len(pre) == root.global_iterations > 0
    assert all(e["admitted"] == 2 for e in pre)


def test_relay_killed_and_respawned_from_its_journal(tmp_path):
    """A relay aborted after round 3 and respawned on the same address and
    save_dir: it recovers at a round >= killed - 2, both members come back
    by session token with Ack 3 codec resets (delta codec), the root sees
    its ready with ``recovered=True``, and the run finishes with no
    reference miss."""
    ready_flags = []
    root_log = MetricsLogger(validate=True, keep_records=True)
    root = FederatedServer(min_clients=1, model_kwargs=dict(MODEL_KWARGS, num_epochs=6),
                           max_iters=200, save_dir=str(tmp_path / "root"), checkpoint_every=0,
                           round_backoff_s=0.05, probation_rounds=60, wire_codec="delta",
                           metrics=root_log, device="cpu")
    ready = root.ReadyForTraining

    def recorded_ready(request, context):
        ready_flags.append((request.client_id, bool(request.recovered)))
        return ready(request, context)

    root.ReadyForTraining = recorded_ready
    root_addr = root.start("127.0.0.1:0")
    port = _free_port()
    relay_kw = dict(relay_id=101, upstream_address=root_addr, min_members=2,
                    listen_address=f"127.0.0.1:{port}", advertise_host="127.0.0.1",
                    save_dir=str(tmp_path / "relay"), device="cpu")
    relay = RelayNode(metrics=MetricsLogger(validate=True, keep_records=True), **relay_kw)
    address = relay.start()
    member_logs = [MetricsLogger(validate=True, keep_records=True) for _ in range(2)]
    clients = [_port_client(c + 1, docs, address, tmp_path, "kill", metrics=member_logs[c],
                            liveness_timeout=3.0, watchdog_poll_s=0.1, reconnect_window=60.0)
               for c, docs in enumerate(_documents(2, seed=7))]
    respawned = None
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
        while relay._applied_round < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert relay._applied_round >= 3, "the relay never applied round 3"
        relay.abort()
        killed = relay._applied_round
        log2 = MetricsLogger(validate=True, keep_records=True)
        respawned = RelayNode(metrics=log2, **relay_kw)
        resumed = respawned.maybe_autorecover()
        assert resumed is not None and resumed >= killed - 2
        respawned.start()
        assert root.wait_done(timeout=120), "the federation did not finish"
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
    finally:
        root.stop()
        for r in (relay, respawned):
            if r is not None:
                r.shutdown()
        for c in clients:
            c.shutdown()
    assert len(log2.events("session_restored")) == 2
    assert len(log2.events("relay_recovered")) == 1
    assert (101, True) in ready_flags
    for log in member_logs:
        assert log.registry.counter("client_reconnections").value >= 1
        assert log.registry.counter("codec_ref_miss").value == 0
    assert root_log.registry.counter("codec_ref_miss").value == 0
    assert log2.registry.counter("codec_ref_miss").value == 0
    for c in clients:
        assert c.stepper.finished
    assert np.isfinite(root.global_betas).all()
