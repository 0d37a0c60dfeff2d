"""Cohort, async and push pacing over real gRPC on localhost, the port's nodes
with each other and with the JAX package's (``device="cpu"``, tiny widths:
three clients of 16 documents at batch 8, 2 epochs, so 4 local steps each).

- Port-only federations under ``cohort:2`` (delta codec), ``async:2`` and
  ``push:2`` (``delta+topk:0.25``), with the assertions of the JAX
  package's ``tests/test_pacing.py`` and ``tests/test_scaleout.py`` e2e
  cases: every client finishes, finite betas, rotating rosters, no quorum
  skips, no reference misses, buffered aggregations.
- The JAX ``TestPushPacing`` servicer cases on the port's server: hold
  markers before training, stale tokens and poll pacing refused, the setup
  advertising the pacing, duplicate push seqs not buffered twice, and the
  reply-delivered codec reset after a recovery (with and without a
  pre-crash claim at or past the owed round).
- Interop: port clients under a JAX server at ``cohort:2``, ``async:2`` and
  ``push:2``; JAX clients under a port server at ``cohort:2`` and
  ``push:2``; the cohort rosters per round are the same in both directions
  and are the port sampler's replay.

Every federation waits at most ``TIMEOUT`` seconds: a hang fails its test.
"""

import threading
import time

import numpy as np
import pytest

from gfedntm_tpu.data.loaders import RawCorpus as JRawCorpus
from gfedntm_tpu.federation.client import Client as JClient
from gfedntm_tpu.federation.server import FederatedServer as JServer
from gfedntm_tpu.utils.observability import MetricsLogger as JMetricsLogger
from gfedntm_tpu_torch.data.loaders import RawCorpus
from gfedntm_tpu_torch.federation.client import Client
from gfedntm_tpu_torch.federation.pacing import parse_pacing
from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb
from gfedntm_tpu_torch.federation.server import FederatedServer
from gfedntm_tpu_torch.federation.simfleet import make_sim_fleet
from gfedntm_tpu_torch.utils.observability import MetricsLogger

MODEL_KWARGS = dict(n_components=3, hidden_sizes=(8,), batch_size=8, num_epochs=2, seed=0)
TIMEOUT = 120.0


def documents(n_clients, docs, seed):
    """``tests/test_pacing.py``'s ``_corpora`` documents."""
    rng = np.random.default_rng(seed)
    words = [f"tok{i:02d}" for i in range(45)]
    return [[" ".join(rng.choice(words, size=12)) for _ in range(docs)]
            for _ in range(n_clients)]


def federate(tmp_path, server_side, client_sides, seed=2, **server_kw):
    """Run one federation to its end over localhost gRPC; each side is
    ``"port"`` or ``"jax"``. Returns (server, clients, server metrics)."""
    common = dict(min_clients=len(client_sides), family="avitm", model_kwargs=MODEL_KWARGS,
                  max_iters=60, save_dir=str(tmp_path / "server"), checkpoint_every=0,
                  round_backoff_s=0.05, **server_kw)
    if server_side == "port":
        metrics = MetricsLogger(validate=True)
        server = FederatedServer(metrics=metrics, device="cpu", **common)
    else:
        metrics = JMetricsLogger(validate=True)
        server = JServer(metrics=metrics, **common)
    addr = server.start("[::]:0")
    clients = []
    for c, (side, docs) in enumerate(zip(client_sides, documents(len(client_sides), 16, seed))):
        kw = dict(client_id=c + 1, server_address=addr, max_features=45,
                  save_dir=str(tmp_path / f"c{c + 1}"))
        if side == "port":
            clients.append(Client(corpus=RawCorpus(documents=docs), device="cpu",
                                  metrics=MetricsLogger(validate=True), **kw))
        else:
            clients.append(JClient(corpus=JRawCorpus(documents=docs), **kw))
    errors = []

    def run(client):
        try:
            client.run()
        except BaseException as err:  # reported below
            errors.append(f"client {client.client_id}: {type(err).__name__}: {err}")

    threads = [threading.Thread(target=run, args=(cl,), daemon=True) for cl in clients]
    try:
        for t in threads:
            t.start()
        assert server.wait_done(timeout=TIMEOUT), "federated training did not finish"
        for t in threads:
            t.join(timeout=30.0)
        assert not errors, errors
        assert all(not t.is_alive() for t in threads)
    finally:
        server.stop(grace=0.2, join_timeout=10.0)
        for cl in clients:
            cl.shutdown(grace=0.2)
    return server, clients, metrics


def check_finished(server, clients):
    assert server.global_iterations > 0
    assert server.global_betas is not None and np.isfinite(server.global_betas).all()
    for cl in clients:
        assert cl.stepper.finished and cl.results is not None


def rosters(metrics):
    return [(e["round"], e["eligible"], tuple(e["cohort"]))
            for e in metrics.events("cohort_sampled")]


def replayed_rosters(sampled, seed, k, steps=4):
    """The port sampler replayed for each round's (seed, round, eligible
    set). The eligible set is every member still short of its ``steps``
    local steps, in client-id order: each sampled member steps once."""
    taken = {1: 0, 2: 0, 3: 0}
    out = []
    for round_idx, _eligible, ids in sampled:
        members = [c for c in sorted(taken) if taken[c] < steps]
        if k >= len(members):
            roster = tuple(members)
        else:
            rng = np.random.default_rng((seed, round_idx))
            picked = {members[int(i)] for i in rng.choice(len(members), size=k, replace=False)}
            roster = tuple(c for c in members if c in picked)
        out.append((round_idx, len(members), roster))
        for c in ids:
            taken[c] += 1
    return out


# ---- port-only federations ----------------------------------------------------

def test_cohort_federation_e2e_with_delta_codec(tmp_path):
    server, clients, metrics = federate(tmp_path, "port", ["port"] * 3,
                                        pacing_policy="cohort:2", pacing_seed=1,
                                        wire_codec="delta")
    check_finished(server, clients)
    sampled = metrics.events("cohort_sampled")
    assert sampled and all(e["k"] <= 2 for e in sampled)
    assert len({tuple(e["cohort"]) for e in sampled if e["eligible"] >= 3}) > 1
    assert metrics.registry.counter("codec_ref_miss").value == 0
    assert metrics.registry.counter("quorum_skipped_rounds").value == 0
    assert server._status()["pacing"]["policy"] == "cohort:2"


def test_async_federation_e2e(tmp_path):
    server, clients, metrics = federate(tmp_path, "port", ["port"] * 3, seed=3,
                                        pacing_policy="async:2", staleness_alpha=0.5)
    check_finished(server, clients)
    aggs = metrics.events("async_aggregated")
    assert aggs and all(e["buffered"] >= 1 for e in aggs)
    for event in metrics.events("update_stale_discounted"):
        assert event["factor"] == 1.0 / (1.0 + event["staleness"]) ** 0.5
    assert server._status()["pacing"]["policy"] == "async:2"


def test_push_federation_e2e_with_delta_codec(tmp_path):
    server, clients, metrics = federate(tmp_path, "port", ["port"] * 3,
                                        pacing_policy="push:2", wire_codec="delta+topk:0.25")
    check_finished(server, clients)
    aggs = metrics.events("push_aggregated")
    assert aggs and all(e["buffered"] >= 1 for e in aggs)
    assert metrics.registry.counter("codec_ref_miss").value == 0
    assert metrics.registry.counter("push_updates_received").value > 0
    status = server._status()["pacing"]
    assert status["policy"] == "push:2" and status["push"] is True
    # Each client pushed once per local step: 4 steps, 4 pushes.
    assert sum(cl.metrics.registry.counter("client_pushes").value for cl in clients) == 12
    assert metrics.registry.counter("push_updates_received").value == 12


# ---- the JAX TestPushPacing cases on the port's server ------------------------

def test_parse_push_spec():
    spec = parse_pacing("push:4")
    assert (spec.policy, spec.buffer_size, spec.spec_id) == ("push", 4, "push:4")
    with pytest.raises(ValueError):
        parse_pacing("push")


def _push_server(tmp_path, **kw):
    return FederatedServer(min_clients=2, family="avitm", model_kwargs=MODEL_KWARGS,
                           save_dir=str(tmp_path), device="cpu", **kw)


def test_push_update_holds_before_training_starts(tmp_path):
    server = _push_server(tmp_path, pacing_policy="push:2")
    server.federation.connect_vocab(1, (), 1.0)
    server.federation.set_session_token(1, "tok1")
    agg = server.PushUpdate(pb.StepReply(client_id=1, session_token="tok1"), None)
    assert agg.round == -1 and not agg.stop and not len(agg.shared.tensors)


def test_push_update_refuses_stale_token(tmp_path):
    m = MetricsLogger(validate=True)
    server = _push_server(tmp_path, pacing_policy="push:2", metrics=m)
    server.federation.connect_vocab(1, (), 1.0)
    server.federation.set_session_token(1, "current")
    agg = server.PushUpdate(pb.StepReply(client_id=1, session_token="stale"), None)
    assert agg.stop
    assert m.registry.counter("push_updates_refused").value == 1


def test_push_update_refused_under_poll_pacing(tmp_path):
    server = _push_server(tmp_path, pacing_policy="sync")
    assert server.PushUpdate(pb.StepReply(client_id=1), None).stop


def test_setup_advertises_pacing_and_local_steps(tmp_path):
    server = FederatedServer(min_clients=1, family="avitm", model_kwargs=MODEL_KWARGS,
                             pacing_policy="push:3", local_steps=2, save_dir=str(tmp_path),
                             device="cpu")
    server.federation.connect_vocab(1, ("tok",), 4.0)
    reply = server.GetGlobalSetup(pb.JoinRequest(client_id=1), None)
    assert reply.pacing_id == "push:3" and reply.local_steps == 2


def test_push_update_duplicate_seq_not_double_buffered(tmp_path):
    m = MetricsLogger(validate=True)
    server, servicers, template = make_sim_fleet(
        2, steps=10, pacing_policy="push:8", max_iters=5, save_dir=str(tmp_path),
        checkpoint_every=0, journal_every=0, metrics=m, device="cpu")
    try:
        update = servicers[1].build_update(template, seq=7)
        server.PushUpdate(update, None)
        server.PushUpdate(update, None)
        engine = server._engine
        assert engine.status()["buffer_depth"] == 1
        assert m.registry.counter("rpcs_deduplicated").value == 1
        server.PushUpdate(servicers[1].build_update(template, seq=8), None)
        assert engine.status()["buffer_depth"] == 2
    finally:
        server._stopping.set()
        server.stop()


def _recovered_posture(server, owed):
    """Adopt a crash-recovered process's wire posture in place: fresh codec
    sessions, no push acks or seqs, a reset owed to every unfinished
    member."""
    with server._codec_lock:
        server._uplink_dec.reset()
        server._downlink_enc.reset()
    with server._push_lock:
        server._push_acked.clear()
        server._push_sent.clear()
        server._reset_owed = {c.client_id: owed for c in server.federation.get_clients()
                              if not c.finished}
    server._push_seen.clear()


def _delta_push_fleet(tmp_path, m):
    server, servicers, template = make_sim_fleet(
        2, steps=60, pacing_policy="push:1", max_iters=200, wire_codec="delta",
        client_codec=True, save_dir=str(tmp_path), checkpoint_every=0, journal_every=0,
        metrics=m, device="cpu")
    seqs = {1: 0, 2: 0}

    def push(cid):
        seqs[cid] += 1
        agg = server.PushUpdate(servicers[cid].build_update(template, seq=seqs[cid]), None)
        servicers[cid].apply(agg)
        return agg

    def drive_until(cond, what, timeout=20.0):
        deadline = time.monotonic() + timeout
        while not cond():
            assert time.monotonic() < deadline, f"timed out: {what}"
            push(1)
            push(2)
            time.sleep(0.02)

    return server, servicers, push, drive_until


def test_fast_restart_push_server_heals_codec_without_reconnect(tmp_path):
    """A push server that recovers within its clients' stub retry window is
    never re-presented a token, and is never polled: the codec resets ride
    the PushUpdate replies (bare reset markers before the first
    post-recovery aggregation), and the federation heals."""
    m = MetricsLogger(validate=True)
    server, servicers, push, drive_until = _delta_push_fleet(tmp_path, m)
    try:
        drive_until(lambda: min(servicers[c]._applied_round for c in (1, 2)) >= 0,
                    "clients never applied a pre-crash broadcast")
        recovery_round = int(server.global_iterations)
        _recovered_posture(server, recovery_round)
        applied_before = servicers[1]._applied
        agg = push(1)
        assert agg.reset_session
        if not len(agg.shared.tensors):
            assert servicers[1]._applied is applied_before
        drive_until(lambda: min(servicers[c]._applied_round for c in (1, 2)) >= recovery_round
                    and not server._reset_owed,
                    "federation never healed past the recovery round")
        assert m.registry.counter("codec_ref_miss").value <= 4
    finally:
        server._stopping.set()
        server.stop()


def test_recovery_reset_not_cleared_by_pre_crash_claim(tmp_path):
    """Only ``acked`` (clamped to rounds THIS process sent) clears an owed
    reset: a surviving client's pre-crash claim at or past the owed round
    must not."""
    m = MetricsLogger(validate=True)
    server, servicers, push, drive_until = _delta_push_fleet(tmp_path, m)
    try:
        drive_until(lambda: min(servicers[c]._applied_round for c in (1, 2)) >= 1,
                    "fleet never warmed")
        _recovered_posture(server, int(servicers[1]._applied_round))
        assert push(1).reset_session, (
            "a pre-crash claim >= the owed round cleared the reset before this "
            "process delivered anything")
    finally:
        server._stopping.set()
        server.stop()


def test_recovered_push_server_owes_every_member_a_reset(tmp_path):
    """``restore_from_checkpoint`` on a push server under a non-identity
    codec owes every unfinished restored member a reply-delivered reset."""
    first = FederatedServer(min_clients=2, family="avitm", model_kwargs=MODEL_KWARGS,
                            save_dir=str(tmp_path), device="cpu", pacing_policy="push:2",
                            wire_codec="delta")
    first.federation.connect_vocab(1, ("tok1", "tok2"), 4.0)
    first.federation.connect_vocab(2, ("tok2", "tok3"), 4.0)
    for cid in (1, 2):
        first.GetGlobalSetup(pb.JoinRequest(client_id=cid), None)
    first.last_average = first._shared_template()
    first._journal_round(0)
    again = FederatedServer(min_clients=2, family="avitm", model_kwargs=MODEL_KWARGS,
                            save_dir=str(tmp_path), device="cpu", pacing_policy="push:2",
                            wire_codec="delta")
    assert again.maybe_autorecover() == 1
    assert again._reset_owed == {1: 1, 2: 1}


# ---- interop with the JAX package -------------------------------------------

def test_port_clients_under_a_jax_push_server(tmp_path):
    server, clients, metrics = federate(tmp_path, "jax", ["port"] * 3,
                                        pacing_policy="push:2", wire_codec="delta+topk:0.25")
    check_finished(server, clients)
    assert metrics.events("push_aggregated")
    assert metrics.registry.counter("codec_ref_miss").value == 0
    assert metrics.registry.counter("push_updates_received").value == 12


def test_jax_clients_under_a_port_push_server(tmp_path):
    server, clients, metrics = federate(tmp_path, "port", ["jax", "jax", "port"],
                                        pacing_policy="push:2", wire_codec="delta")
    check_finished(server, clients)
    assert metrics.events("push_aggregated")
    assert metrics.registry.counter("codec_ref_miss").value == 0
    assert metrics.registry.counter("push_updates_received").value == 12
    assert (tmp_path / "server" / "server_model.npz").exists()


def test_port_clients_under_a_jax_async_server(tmp_path):
    server, clients, metrics = federate(tmp_path, "jax", ["port"] * 3, seed=3,
                                        pacing_policy="async:2", staleness_alpha=0.5)
    check_finished(server, clients)
    assert metrics.events("async_aggregated")


@pytest.fixture(scope="module")
def cohort_runs(tmp_path_factory):
    """``cohort:2`` at seed 1 both ways: port clients under a JAX server,
    and JAX clients under a port server."""
    kw = dict(pacing_policy="cohort:2", pacing_seed=1, wire_codec="delta")
    return (federate(tmp_path_factory.mktemp("jax-server"), "jax", ["port"] * 3, **kw),
            federate(tmp_path_factory.mktemp("port-server"), "port", ["jax"] * 3, **kw))


def test_port_clients_under_a_jax_cohort_server(cohort_runs):
    server, clients, metrics = cohort_runs[0]
    check_finished(server, clients)
    assert metrics.registry.counter("codec_ref_miss").value == 0
    assert metrics.registry.counter("quorum_skipped_rounds").value == 0


def test_jax_clients_under_a_port_cohort_server(cohort_runs):
    server, clients, metrics = cohort_runs[1]
    check_finished(server, clients)
    assert metrics.registry.counter("codec_ref_miss").value == 0
    assert metrics.registry.counter("quorum_skipped_rounds").value == 0


def test_cohort_rosters_are_the_same_both_ways(cohort_runs):
    """Each round's roster under the port server is the JAX server's at the
    same seed, and both are the port sampler replayed for the round."""
    jax_side, port_side = (rosters(run[2]) for run in cohort_runs)
    assert jax_side == port_side
    assert len(jax_side) == cohort_runs[0][0].global_iterations
    assert any(eligible == 3 for _r, eligible, _ids in jax_side)
    assert port_side == replayed_rosters(port_side, seed=1, k=2)


# ---- the client's push half at the servicer --------------------------------

def _servicer(metrics=None, steps_per_epoch=3, epochs=1):
    import logging

    from gfedntm_tpu_torch.data.datasets import BowDataset
    from gfedntm_tpu_torch.federated.stepper import FederatedAVITM
    from gfedntm_tpu_torch.federation.client import FederatedClientServicer
    from gfedntm_tpu_torch.federation.server import build_template_model

    kw = dict(MODEL_KWARGS, num_epochs=epochs)
    stepper = FederatedAVITM(build_template_model("avitm", 30, kw, device="cpu"))
    rng = np.random.default_rng(0)
    stepper.pre_fit(BowDataset(X=rng.integers(0, 3, size=(8 * steps_per_epoch, 30))
                               .astype(np.float32)))
    return FederatedClientServicer(1, stepper, lambda: None, logging.getLogger("push"),
                                   metrics=metrics)


def test_each_push_round_advances_the_schedule_exactly_once():
    """``finish_push_round`` advances the stepper once per exchanged step
    whatever the reply (an empty marker, a reset order, an aggregate, no
    reply at all), and ``local_round`` marks the final scheduled step
    finished although the schedule advances only after it."""
    from gfedntm_tpu_torch.federation import codec

    servicer = _servicer(steps_per_epoch=4)
    st = servicer.stepper
    replies = [None, pb.Aggregate(round=0), pb.Aggregate(round=0, reset_session=True)]
    for step, agg in enumerate(replies):
        reply = servicer.local_round(1)
        assert st._pending_step and st.current_mb == step and not reply.finished
        servicer.finish_push_round(agg)
        assert not st._pending_step and st.current_mb == step + 1
    reply = servicer.local_round(1)
    assert reply.finished and not st.finished  # the last scheduled step, not yet advanced
    snap = codec.bundle_to_flatdict(reply.shared)
    servicer.finish_push_round(pb.Aggregate(shared=codec.flatdict_to_bundle(snap), round=0))
    assert st.finished and servicer._applied_round == 0 and not st._pending_step


def test_a_capture_token_on_a_push_reply_is_answered_on_the_next_push():
    from gfedntm_tpu_torch.utils import flightrec

    metrics = MetricsLogger(node="client1")
    metrics.recorder = flightrec.FlightRecorder(max_entries=64, registry=metrics.registry)
    servicer = _servicer(metrics=metrics)
    assert not servicer.local_round(1).flightrec
    servicer.finish_push_round(pb.Aggregate(round=0, capture_token="inc-7"))
    assert servicer._pending_capture_token == "inc-7"
    answered = servicer.local_round(1)
    assert answered.flightrec
    assert flightrec.decode_bundles(answered.flightrec)[0]["incident_id"] == "inc-7"
    # Once per token: the same token on the next reply is not answered again.
    servicer.finish_push_round(pb.Aggregate(round=0, capture_token="inc-7"))
    assert not servicer.local_round(1).flightrec
