"""The port's round engines against the JAX package's (``federation/pacing.py``).

- The pure pacing math (``inclusion_scale``, ``scale_update``,
  ``staleness_discount``, ``clamped_staleness``, ``_note_admitted_weights``,
  the sync hooks ``select_cohort`` and ``gate_staleness``) is bitwise the
  JAX functions' on seeded inputs, and the cohort sampler draws the JAX
  rosters for the same (seed, round, eligible set).
- The unit cases of ``tests/test_pacing.py`` run against the port's
  engines and server: the sampler, probation eligibility, the unbiased
  reweighting, staleness discounts and their clamp, the staleness-normalized
  gate, the quorum denominators, adaptive poll deadlines and the push-ack
  round tags.
- One ``_aggregate_once`` (async) and one ``_aggregate_push`` fed the same
  buffered replies in the port and JAX engines: the averages and the pushed
  bundles are bitwise equal on the numpy backend, and the port's device
  engine (on the CPU here) gives numpy's weighted mean bitwise.
- A ``cohort:2``-of-3 port server at ``dp="server"`` charges its ledger at
  q = 2/3, and its epsilon is the JAX accountant's at that q.
- The port's server takes every keyword of the JAX server at its default.
"""

import inspect
import itertools
import math

import numpy as np
import pytest

from gfedntm_tpu.federation import codec as j_codec
from gfedntm_tpu.federation import pacing as j_pacing
from gfedntm_tpu.federation.protos import federated_pb2 as jpb
from gfedntm_tpu.federation.registry import ClientRecord as JClientRecord
from gfedntm_tpu.federation.server import FederatedServer as JServer
from gfedntm_tpu.federation.server import build_template_model as j_build
from gfedntm_tpu.privacy import PrivacyAccountant as JAccountant
from gfedntm_tpu_torch.federated.aggregation import weighted_mean
from gfedntm_tpu_torch.federation import codec, pacing
from gfedntm_tpu_torch.federation.pacing import (
    POLL_DEADLINE_FLOOR_S,
    AsyncEngine,
    CohortEngine,
    PushEngine,
    SyncEngine,
    fallback_deadline,
    inclusion_scale,
    make_engine,
    scale_update,
    staleness_discount,
)
from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb
from gfedntm_tpu_torch.federation.registry import SUSPECT, ClientRecord
from gfedntm_tpu_torch.federation.sanitize import UpdateGate
from gfedntm_tpu_torch.federation.server import FederatedServer, build_template_model
from gfedntm_tpu_torch.federation.simfleet import make_sim_fleet
from gfedntm_tpu_torch.utils.observability import MetricsLogger

MODEL_KWARGS = dict(n_components=3, hidden_sizes=(8,), batch_size=8, num_epochs=2, seed=0)


def _server(**kw):
    base = dict(min_clients=1, family="avitm", model_kwargs=MODEL_KWARGS, device="cpu")
    base.update(kw)
    server = FederatedServer(**base)
    server.template = build_template_model("avitm", 30, MODEL_KWARGS, device="cpu")
    return server


def _populate(server, n, ready=True):
    for cid in range(1, n + 1):
        server.federation.connect_vocab(cid, (f"w{cid}",), 10.0 + cid)
        if ready:
            server.federation.connect_ready(cid, f"localhost:{cid}")


# ---- the pure pacing math, bitwise against the JAX functions ----------------

def test_inclusion_scale_is_the_jax_function():
    rng = np.random.default_rng(0)
    for _ in range(500):
        admitted, p, expected = (float(v) for v in rng.uniform(-0.5, 50.0, size=3))
        p = float(rng.choice([p / 50.0, 0.0, 1.0, rng.uniform()]))
        cap = float(rng.choice([np.inf, 1.0 / max(p, 1e-9), rng.uniform(0.5, 4.0)]))
        got = inclusion_scale(admitted, p, expected, max_scale=cap)
        want = j_pacing.inclusion_scale(admitted, p, expected, max_scale=cap)
        assert type(got) is type(want) and got == want


def _tree(rng):
    return {
        "a": rng.standard_normal((5, 7)).astype(np.float32),
        "b": rng.standard_normal(11).astype(np.float64),
        "c": rng.integers(0, 9, size=4).astype(np.int32),
        "d": np.float32(rng.standard_normal()),
    }


@pytest.mark.parametrize("scale", [1.0, 0.5, 1.7, 3.0, 0.123456789])
def test_scale_update_is_the_jax_function(scale):
    rng = np.random.default_rng(int(scale * 1000))
    average, current = _tree(rng), _tree(rng)
    got = scale_update(average, current, scale)
    want = j_pacing.scale_update(average, current, scale)
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
        assert np.asarray(got[key]).tobytes() == np.asarray(want[key]).tobytes(), key
    if scale == 1.0:
        assert got is average


def test_staleness_discount_is_the_jax_function():
    rng = np.random.default_rng(1)
    for s in range(-3, 60):
        for alpha in (0.0, 0.5, 1.0, float(rng.uniform(0, 3))):
            assert staleness_discount(s, alpha) == j_pacing.staleness_discount(s, alpha)


def test_clamped_staleness_and_admitted_weights_are_the_jax_engines():
    rng = np.random.default_rng(2)
    port, jax = _server(pacing_policy="async:2"), JServer(min_clients=1,
                                                          pacing_policy="async:2")
    acked = {int(c): int(rng.integers(0, 20)) for c in rng.choice(40, 25, replace=False)}
    for server in (port, jax):
        with server._push_lock:
            server._push_acked.update(acked)
    p_engine = make_engine(port, port.pacing)
    j_engine = j_pacing.make_engine(jax, jax.pacing)
    for iteration in (0, 3, 17, 40):
        replies = [(ClientRecord(c), pb.StepReply(client_id=c,
                                                   base_round=int(rng.integers(0, 45))))
                   for c in range(40)]
        j_replies = [(JClientRecord(c), jpb.StepReply(client_id=c, base_round=r.base_round))
                     for c, (_rec, r) in enumerate(replies)]
        assert p_engine.clamped_staleness(replies, iteration) == \
            j_engine.clamped_staleness(j_replies, iteration)
    accepted = [(int(c), float(rng.uniform(1, 50)), 0.0) for c in range(12)]
    port._round_accepted, jax._round_accepted = list(accepted), list(accepted)
    p_engine._note_admitted_weights()
    j_engine._note_admitted_weights()
    assert p_engine._round_weight == j_engine._round_weight


def test_sync_hooks_are_the_jax_engines():
    port, jax = _server(), JServer(min_clients=1)
    _populate(port, 5)
    _populate(jax, 5)
    p_engine, j_engine = make_engine(port, port.pacing), j_pacing.make_engine(jax, jax.pacing)
    assert type(p_engine) is SyncEngine
    active, j_active = port.federation.active_clients(0), jax.federation.active_clients(0)
    assert p_engine.select_cohort(3, active) is active
    assert j_engine.select_cohort(3, j_active) is j_active
    assert p_engine.gate_staleness([], 3) is None and j_engine.gate_staleness([], 3) is None


@pytest.mark.parametrize("n, k, seed", [(3, 2, 1), (10, 3, 7), (100, 8, 0), (57, 16, 3)])
def test_cohort_rosters_are_the_jax_samplers(n, k, seed):
    """Same (seed, round, eligible set) → the same roster, inclusion
    probability and expected population weight as the JAX engine, also
    with suspects in backoff and known round weights."""
    port = _server(pacing_policy=f"cohort:{k}", pacing_seed=seed)
    jax = JServer(min_clients=1, pacing_policy=f"cohort:{k}", pacing_seed=seed)
    for server in (port, jax):
        _populate(server, n)
        for cid in range(2, n + 1, 5):
            server.federation.mark_suspect(cid, f"localhost:{cid}", round_idx=0,
                                           probation_rounds=9)
    p_engine, j_engine = make_engine(port, port.pacing), j_pacing.make_engine(jax, jax.pacing)
    weights = {c: float(c % 4 + 1) for c in range(1, n + 1, 2)}
    p_engine._round_weight.update(weights)
    j_engine._round_weight.update(weights)
    for round_idx in range(12):
        p_active = port.federation.active_clients(round_idx)
        j_active = jax.federation.active_clients(round_idx)
        assert [r.client_id for r in p_active] == [r.client_id for r in j_active]
        got = [r.client_id for r in p_engine.select_cohort(round_idx, p_active)]
        want = [r.client_id for r in j_engine.select_cohort(round_idx, j_active)]
        assert got == want
        assert p_engine._inclusion_p == j_engine._inclusion_p
        assert p_engine._expected_weight == j_engine._expected_weight
        assert p_engine.inclusion_q() == j_engine.inclusion_q()


# ---- tests/test_pacing.py's unit cases on the port's engines ----------------

def test_make_engine_dispatch():
    server = FederatedServer(min_clients=1, device="cpu")
    assert type(make_engine(server, pacing.parse_pacing("sync"))) is SyncEngine
    assert type(make_engine(server, pacing.parse_pacing("cohort:2"))) is CohortEngine
    assert type(make_engine(server, pacing.parse_pacing("async:2"))) is AsyncEngine
    assert type(make_engine(server, pacing.parse_pacing("push:2"))) is PushEngine


def test_server_parses_pacing_eagerly():
    with pytest.raises(ValueError):
        FederatedServer(min_clients=1, pacing_policy="cohort", device="cpu")  # no K
    with pytest.raises(ValueError):
        FederatedServer(min_clients=1, pacing_policy="wat", device="cpu")
    server = FederatedServer(min_clients=1, pacing_policy="cohort", cohort_size=8,
                             device="cpu")
    assert server.pacing.spec_id == "cohort:8"
    assert server._status()["pacing"]["policy"] == "cohort:8"


def test_cohort_sampler_deterministic_and_seeded():
    server = _server(pacing_policy="cohort:3", pacing_seed=7)
    _populate(server, 10)
    engine = make_engine(server, server.pacing)
    active = server.federation.active_clients(0)
    roster_a = [r.client_id for r in engine.select_cohort(4, active)]
    roster_b = [r.client_id for r in engine.select_cohort(4, active)]
    assert roster_a == roster_b and len(roster_a) == 3
    others = {tuple(r.client_id for r in engine.select_cohort(i, active)) for i in range(12)}
    assert len(others) > 1
    small = active[:2]
    assert [r.client_id for r in engine.select_cohort(0, small)] == [
        r.client_id for r in small]
    assert engine._inclusion_p == 1.0


def test_cohort_sampler_respects_probation_backoff():
    server = _server(pacing_policy="cohort:4", pacing_seed=0)
    _populate(server, 6)
    server.federation.mark_suspect(3, "localhost:3", round_idx=0, probation_rounds=5)
    engine = make_engine(server, server.pacing)
    rec3 = {r.client_id: r for r in server.federation.get_clients()}[3]
    assert rec3.status == SUSPECT and rec3.next_retry_round == 1
    active = server.federation.active_clients(0)
    assert 3 not in {r.client_id for r in active}
    assert 3 not in {r.client_id for r in engine.select_cohort(0, active)}
    assert 3 in {r.client_id for r in server.federation.active_clients(1)}


def test_cohort_sampled_event_schema_registered():
    metrics = MetricsLogger(validate=True)
    server = _server(pacing_policy="cohort:2", metrics=metrics)
    _populate(server, 5)
    engine = make_engine(server, server.pacing)
    engine.select_cohort(0, server.federation.active_clients(0))
    events = metrics.events("cohort_sampled")
    assert events and events[0]["k"] == 2 and events[0]["eligible"] == 5
    assert len(events[0]["cohort"]) == 2


def test_inclusion_scale_unbiased_closed_form():
    """Enumerating every K-of-N cohort, the mean of the HT-corrected cohort
    aggregates equals the full-population weighted mean."""
    rng = np.random.default_rng(0)
    n, k = 4, 2
    weights = [1.0, 2.0, 3.0, 4.0]
    values = [rng.normal(size=(3, 5)).astype(np.float64) for _ in range(n)]
    g = {"x": np.zeros((3, 5))}
    acc = np.zeros((3, 5))
    subsets = list(itertools.combinations(range(n), k))
    for subset in subsets:
        est = weighted_mean([(weights[i], {"x": values[i]}) for i in subset])
        scale = inclusion_scale(sum(weights[i] for i in subset), k / n, sum(weights))
        acc += scale_update(est, g, scale)["x"]
    full = weighted_mean([(w, {"x": v}) for w, v in zip(weights, values)])
    np.testing.assert_allclose(acc / len(subsets), full["x"], atol=1e-12)


def test_inclusion_scale_neutral_and_capped():
    assert inclusion_scale(2.0, 0.5, 4.0) == 1.0
    assert inclusion_scale(0.0, 0.5, 4.0) == 1.0
    assert inclusion_scale(2.0, 0.0, 4.0) == 1.0
    assert inclusion_scale(2.0, 0.5, 0.0) == 1.0
    assert inclusion_scale(100.0, 0.25, 1.0, max_scale=4.0) == 4.0


def test_scale_update_identity_and_affine():
    g = {"x": np.ones(4, np.float32), "n": np.arange(4)}
    avg = {"x": np.full(4, 3.0, np.float32), "n": np.arange(4)}
    assert scale_update(avg, g, 1.0) is avg
    out = scale_update(avg, g, 0.5)
    np.testing.assert_allclose(out["x"], 2.0)
    assert out["x"].dtype == np.float32
    np.testing.assert_array_equal(out["n"], np.arange(4))


def test_cohort_combine_skips_reweight_for_robust_estimators():
    server = _server(pacing_policy="cohort:2", robust_aggregator="median")
    engine = make_engine(server, server.pacing)
    engine._inclusion_p = 0.5
    engine._expected_weight = 100.0
    server._round_accepted = [(1, 5.0, 1.0), (2, 5.0, 1.0)]
    snaps = [(5.0, {k: np.asarray(v) for k, v in server._shared_template().items()})
             for _ in range(2)]
    out = engine.combine(snaps, iteration=0)
    assert engine._last_scale == 1.0
    assert set(out) == set(server._shared_template())


def test_staleness_discount_closed_form():
    assert staleness_discount(0, 0.5) == 1.0
    assert staleness_discount(3, 0.0) == 1.0
    for s in range(5):
        np.testing.assert_allclose(staleness_discount(s, 0.5), 1.0 / (1.0 + s) ** 0.5)
    vals = [staleness_discount(s, 1.0) for s in range(6)]
    assert vals == sorted(vals, reverse=True)
    assert staleness_discount(-3, 1.0) == 1.0


def test_async_buffer_deterministic_under_arrival_order():
    server = _server(pacing_policy="async:3", staleness_alpha=0.5)
    engine = make_engine(server, server.pacing)

    def replies(order):
        for cid in order:
            engine.buffer_append(ClientRecord(cid, nr_samples=4.0),
                                 pb.StepReply(client_id=cid, nr_samples=4.0,
                                              base_round=cid % 3), 0.01 * cid)
        return engine.buffer_drain()

    a, b = replies([3, 1, 2]), replies([2, 3, 1])
    assert [rec.client_id for rec, _r, _l in a] == [1, 2, 3]
    assert [rec.client_id for rec, _r, _l in b] == [1, 2, 3]
    da, db = engine.discounts_for(a, iteration=5), engine.discounts_for(b, iteration=5)
    assert da == db
    np.testing.assert_allclose(da[1], 1.0 / (1.0 + (5 - 1)) ** 0.5)
    np.testing.assert_allclose(da[3], 1.0 / (1.0 + (5 - 0)) ** 0.5)


def test_stale_discount_scales_collect_weights_and_emits_event():
    metrics = MetricsLogger(validate=True)
    server = _server(metrics=metrics, pacing_policy="async:2")
    engine = make_engine(server, server.pacing)
    bundle = codec.flatdict_to_bundle(server._shared_template())
    rec1, rec2 = ClientRecord(1, nr_samples=100.0), ClientRecord(2, nr_samples=100.0)
    fresh = pb.StepReply(client_id=1, shared=bundle, nr_samples=8.0, base_round=4)
    stale = pb.StepReply(client_id=2, shared=bundle, nr_samples=8.0, base_round=1)
    discounts = engine.discounts_for([(rec1, fresh, 0.0), (rec2, stale, 0.0)], iteration=4)
    out = server._collect_snapshots([(rec1, fresh), (rec2, stale)], iteration=4,
                                    weight_scale=discounts)
    weights = [w for w, _snap in out]
    np.testing.assert_allclose(weights[0], 8.0)
    np.testing.assert_allclose(weights[1], 8.0 / (1.0 + 3) ** 0.5)
    events = metrics.events("update_stale_discounted")
    assert len(events) == 1 and events[0]["client"] == 2 and events[0]["staleness"] == 3


def test_staleness_claims_clamped_to_server_observation():
    server = _server(pacing_policy="cohort:2")
    engine = make_engine(server, server.pacing)
    rec = ClientRecord(1, nr_samples=4.0)
    with server._push_lock:
        server._push_acked[1] = 8
    assert engine.clamped_staleness([(rec, pb.StepReply(client_id=1, base_round=0))], 10)[1] == 1
    assert engine.clamped_staleness([(rec, pb.StepReply(client_id=1, base_round=10))],
                                    10)[1] == 0
    rec2 = ClientRecord(2, nr_samples=4.0)
    assert engine.clamped_staleness([(rec2, pb.StepReply(client_id=2, base_round=0))],
                                    10)[2] == 10


def test_gate_screen_normalizes_staleness():
    g = {"x": np.zeros(16, np.float32)}

    def gate():
        out = UpdateGate(mad_k=3.0, mad_rel_floor=0.1)
        out.set_template(g)
        return out

    def snap(scale):
        return {"x": np.full(16, scale, np.float32)}

    candidates = [(1, 1.0, snap(0.25)), (2, 1.0, snap(0.26)), (3, 1.0, snap(0.24)),
                  (4, 1.0, snap(1.0))]
    assert [r.client_id for r in gate().admit_round(candidates, g, 0).rejected] == [4]
    assert not gate().admit_round(candidates, g, 0, staleness={4: 3}).rejected
    poisoned = candidates[:3] + [(5, 1.0, snap(25.0))]
    bad = gate().admit_round(poisoned, g, 0, staleness={4: 3})
    assert [r.client_id for r in bad.rejected] == [5]


def test_quorum_denominates_over_cohort_not_membership():
    server = _server(pacing_policy="cohort:8", quorum_fraction=0.5)
    _populate(server, 100)
    engine = make_engine(server, server.pacing)
    cohort = engine.select_cohort(0, server.federation.active_clients(0))
    assert engine.quorum_denominator(cohort) == 8
    assert max(1, math.ceil(server.quorum_fraction * engine.quorum_denominator(cohort))) == 4
    sync_server = _server(quorum_fraction=0.5)
    _populate(sync_server, 100)
    sync_engine = make_engine(sync_server, sync_server.pacing)
    assert sync_engine.quorum_denominator(sync_server.federation.active_clients(0)[:8]) == 100


def test_poll_deadline_derived_from_ewmas_with_fallback():
    server = _server(local_steps=3)
    engine = make_engine(server, server.pacing)
    rec = ClientRecord(1, nr_samples=1.0)
    base = fallback_deadline(3)
    assert engine.poll_deadline(rec) == base
    server._poll_warmed.add(1)
    assert engine.poll_deadline(rec) == base
    for _ in range(3):
        server.straggler.observe_round({1: 0.02, 2: 0.03, 3: 0.025})
    assert engine.poll_deadline(rec) == POLL_DEADLINE_FLOOR_S
    for _ in range(6):
        server.straggler.observe_round({1: 3.0, 2: 2.0, 3: 2.5})
    dl = engine.poll_deadline(rec)
    assert POLL_DEADLINE_FLOOR_S < dl < base and dl >= 10.0 * 3.0
    for _ in range(8):
        server.straggler.observe_round({1: 50.0, 2: 40.0, 3: 45.0})
    assert engine.poll_deadline(rec) == base


def test_push_ack_round_tags_gate_delta_encoding():
    server = _server(wire_codec="delta")
    tmpl = server._shared_template()
    rec1, rec2, rec3 = ClientRecord(1), ClientRecord(2), ClientRecord(3)
    reply = pb.StepReply(client_id=1)
    aggs0 = server._encode_push(tmpl, 0, [(rec1, reply), (rec2, reply)])
    assert aggs0[1].shared.ref_round == 0 and aggs0[2].shared.ref_round == 0
    with server._push_lock:
        server._push_acked.update({1: 0, 2: 0})
    aggs1 = server._encode_push(tmpl, 1, [(rec1, reply), (rec2, reply)])
    assert aggs1[1].shared.ref_round == 1 and aggs1[1] is aggs1[2]
    with server._push_lock:
        server._push_acked.update({1: 1, 2: 1, 3: 0})
    aggs2 = server._encode_push(tmpl, 2, [(rec1, reply), (rec3, reply)])
    assert aggs2[1].shared.ref_round == 2
    assert aggs2[3].shared.ref_round == 1


# ---- one buffered aggregation in both packages -------------------------------

class _Stub:
    """A client stub that records each pushed Aggregate."""

    def __init__(self, sink):
        self.sink = sink

    def ApplyAggregate(self, agg, **_kw):
        self.sink.append(agg.SerializeToString())
        mod = jpb if isinstance(agg, jpb.Aggregate) else pb
        return mod.AggregateReply(client_id=0, finished=False)


def _buffered_replies(template, mod, codec_mod):
    """Five seeded updates from the template, with unequal sample counts and
    base rounds (so unequal staleness discounts)."""
    rng = np.random.default_rng(5)
    out = []
    for cid, base in zip((4, 2, 5, 1, 3), (3, 0, 1, 3, 2)):
        snap = {k: (np.asarray(v) + 1e-2 * rng.standard_normal(np.shape(v)).astype(
            np.asarray(v).dtype)) if np.asarray(v).dtype.kind == "f" else np.asarray(v)
            for k, v in template.items()}
        out.append((cid, mod.StepReply(client_id=cid, shared=codec_mod.flatdict_to_bundle(snap),
                                       nr_samples=float(3 + cid), loss=1.0 + cid,
                                       base_round=base)))
    return out


def _drive(server, engine, replies, kind):
    for cid, reply in replies:
        server.federation.connect_vocab(cid, (), 10.0)
        server.federation.connect_ready(cid, f"sim:{cid}")
    recs = {r.client_id: r for r in server.federation.get_clients()}
    with server._push_lock:
        server._push_acked.update({1: 2, 2: 0, 4: 1})
        server._push_sent.update({1: 2, 2: 0, 4: 1})
    sink: list = []
    stubs = {cid: (f"sim:{cid}", None, _Stub(sink)) for cid, _r in replies}
    for cid, reply in replies:
        engine.buffer_append(recs[cid], reply, 0.0)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        if kind == "async":
            out = engine._aggregate_once(stubs, pool, 3, 0, set())
        else:
            out = engine._aggregate_push(3, 0)
    return out, sink


@pytest.mark.parametrize("kind", ["async", "push"])
@pytest.mark.parametrize("wire", ["none", "delta"])
def test_one_buffered_aggregation_is_the_jax_engines(kind, wire):
    """The same five buffered replies through the port's and the JAX
    engine's drain (client-id order), staleness clamp, discounts, gate and
    FedAvg: the averages and the pushed bundles are bitwise equal; the
    port's device engine gives numpy's weighted mean bitwise."""
    spec = f"{kind}:5"
    jax = JServer(min_clients=1, family="avitm", model_kwargs=MODEL_KWARGS,
                  pacing_policy=spec, wire_codec=wire, staleness_alpha=0.7)
    jax.template = j_build("avitm", 30, MODEL_KWARGS)
    template = {k: np.asarray(v) for k, v in jax._shared_template().items()}
    runs = {}
    for backend in ("numpy", "device"):
        port = FederatedServer(min_clients=1, family="avitm", model_kwargs=MODEL_KWARGS,
                               pacing_policy=spec, wire_codec=wire, staleness_alpha=0.7,
                               aggregation_backend=backend, device="cpu")
        port.template = build_template_model("avitm", 30, MODEL_KWARGS, device="cpu")
        port._template_shared = dict(template)
        engine = make_engine(port, port.pacing)
        port._engine = engine
        runs[backend] = (port, _drive(port, engine, _buffered_replies(template, pb, codec),
                                      kind))
    j_engine = j_pacing.make_engine(jax, jax.pacing)
    jax._engine = j_engine
    j_out, j_sink = _drive(jax, j_engine, _buffered_replies(template, jpb, j_codec), kind)
    for backend, (port, (out, sink)) in runs.items():
        assert out == j_out == (4, 0), backend
        assert port._round_accepted == jax._round_accepted, backend
        assert sorted(port.last_average) == sorted(jax.last_average)
        for key, value in jax.last_average.items():
            got = np.asarray(port.last_average[key])
            assert got.dtype == np.asarray(value).dtype, (backend, key)
            assert got.tobytes() == np.asarray(value).tobytes(), (backend, key)
        assert sorted(sink) == sorted(j_sink), backend
        assert port._engine._last_cohort == j_engine._last_cohort == (1, 2, 3, 4, 5)
        if kind == "push":
            assert not sink
            if wire != "none":
                assert port._downlink_enc.last_round == jax._downlink_enc.last_round == 3
                assert port._downlink_enc.bundle_for(None).SerializeToString() == \
                    jax._downlink_enc.bundle_for(None).SerializeToString()
    assert runs["device"][0]._agg_backend_resolved == "device"
    assert runs["numpy"][0]._agg_backend_resolved == "numpy"


# ---- the privacy ledger under cohort pacing ----------------------------------

def test_cohort_server_dp_ledger_charges_the_sampled_q(tmp_path):
    """A ``cohort:2``-of-3 port server at ``dp="server"`` (sim clients on
    the loopback transport): every round with three eligible clients is
    charged at q = 2/3, and the ledger's epsilon after each round is the JAX
    accountant's stepped at the same q's."""
    metrics = MetricsLogger(validate=True)
    server, _servicers, _template = make_sim_fleet(
        3, steps=6, pacing_policy="cohort:2", pacing_seed=3, max_iters=6,
        save_dir=str(tmp_path), checkpoint_every=0, journal_every=0,
        round_backoff_s=0.01, dp="server", dp_sigma=0.8, dp_clip=1.0, dp_delta=1e-5,
        metrics=metrics, device="cpu",
    )
    try:
        assert server.wait_done(timeout=120.0), "the sim federation did not finish"
    finally:
        server.stop(grace=0.1)
    charged = metrics.events("privacy_budget")
    sampled = {e["round"]: e for e in metrics.events("cohort_sampled")}
    assert len(charged) == server.global_iterations == 6
    assert all(sampled[e["round"]]["eligible"] == 3 for e in charged)
    assert all(e["q"] == 2 / 3 for e in charged)
    ref = JAccountant(sigma=0.8, delta=1e-5, budget=0.0, mode="server")
    for event in charged:
        assert event["eps"] == ref.step(q=event["q"]), event["round"]
    assert server.privacy_accountant.epsilon() == ref.epsilon()
    assert server.privacy_accountant.steps == 6


# ---- the server's signature ---------------------------------------------------

def test_server_takes_every_jax_keyword_at_its_default(tmp_path):
    """Every keyword of the JAX server's ``__init__`` at its JAX default
    constructs the port's server (a caller passing ``staleness_alpha=0.5``,
    ``pacing_seed=0`` or ``codec_ref_cache_max=64`` explicitly is not
    refused), and the construction takes each value."""
    params = inspect.signature(JServer.__init__).parameters
    kwargs = {name: p.default for name, p in params.items()
              if name != "self" and p.default is not inspect.Parameter.empty}
    assert {"staleness_alpha", "pacing_seed", "codec_ref_cache_max", "pacing_policy",
            "cohort_size", "async_buffer", "relay_grace_rounds", "profiler"} <= set(kwargs)
    server = FederatedServer(min_clients=1, device="cpu", **kwargs)
    assert server.pacing.spec_id == "sync" and server.pacing.seed == 0
    assert server.pacing.staleness_alpha == 0.5
    assert server.codec_ref_cache_max == 64
    j_server = JServer(min_clients=1, **kwargs)
    for attr in ("max_iters", "local_steps", "quorum_fraction", "checkpoint_every",
                 "journal_every", "codec_ref_cache_max", "reconnect_grace_s"):
        assert getattr(server, attr) == getattr(j_server, attr), attr
    assert server.pacing == pacing.PacingSpec(**{
        f: getattr(j_server.pacing, f) for f in ("policy", "cohort_size", "buffer_size",
                                                 "staleness_alpha", "seed")})


def test_codec_caches_size_to_the_rotation_like_the_jax_server(tmp_path):
    for spec, n in (("cohort:2", 200), ("push:16", 1000), ("async:4", 30), ("sync", 50)):
        port = FederatedServer(min_clients=1, wire_codec="delta", pacing_policy=spec,
                               codec_ref_cache_max=48, device="cpu")
        jax = JServer(min_clients=1, wire_codec="delta", pacing_policy=spec,
                      codec_ref_cache_max=48)
        for server in (port, jax):
            for cid in range(1, n + 1):
                server.federation.connect_vocab(cid, (), 1.0)
            server._size_codec_caches()
        assert port._uplink_dec.max_refs == jax._uplink_dec.max_refs, spec
        assert port._downlink_enc.max_views == jax._downlink_enc.max_views, spec
