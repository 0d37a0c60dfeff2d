"""The federation server's data plane in the port, on the CPU: the update
admission gate, the robust mean stages and server optimizers, the
divergence guardian, the aggregation plane's engine and the round
checkpoints, each held to the JAX package's.

- Golden copies: the same inputs through ``gfedntm_tpu``'s numpy modules
  and the port's give the same guardian verdicts, the same gate decisions,
  norms and clipped snapshots, and the same estimates and server-optimizer
  steps, bit for bit, ``state_dict`` round trips included.
- The cases of ``tests/test_data_plane.py``'s estimator, gate and guardian
  classes, on the port.
- The engine (``DeviceAggEngine(device="cpu")``) against the port's numpy
  oracle, as ``tests/test_device_agg.py`` holds the JAX engine: the
  weighted mean bitwise, the other estimators and the gate's norms within
  2e-6, every admission decision identical.
- The round checkpoint's integrity contract, and the server's backend seam.
- Federations over localhost gRPC, port server and port clients: a
  poisoned client (NaN, then 100x-scaled updates) is rejected and dropped
  while the run matches the honest clients' run; a one-shot NaN with the
  gate off rolls the federation back to its last checkpoint once.
"""

import json
import threading

import numpy as np
import pytest
import torch

from gfedntm_tpu.federation import aggregation as j_agg
from gfedntm_tpu.federation import sanitize as j_san
from gfedntm_tpu.train.guardian import DivergenceGuardian as JGuardian
from gfedntm_tpu_torch.data.loaders import RawCorpus
from gfedntm_tpu_torch.federated import aggregation as agg
from gfedntm_tpu_torch.federated.aggregation import (
    FedAdam,
    FedAvg,
    Krum,
    Median,
    TrimmedMean,
    WeightedMean,
    krum_select,
    make_aggregator,
    make_estimator,
    weighted_mean,
)
from gfedntm_tpu_torch.federation import codec
from gfedntm_tpu_torch.federation.client import Client
from gfedntm_tpu_torch.federation.device_agg import (
    DeviceAggEngine,
    FlatPlane,
    StackedRound,
    stack_round,
)
from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb
from gfedntm_tpu_torch.federation.registry import DROPPED, SUSPECT, ClientRecord
from gfedntm_tpu_torch.federation.resilience import FaultInjector
from gfedntm_tpu_torch.federation.sanitize import UpdateGate, update_norm
from gfedntm_tpu_torch.federation.server import FederatedServer, build_template_model
from gfedntm_tpu_torch.train.checkpoint import (
    CheckpointIntegrityError,
    FederationCheckpointer,
)
from gfedntm_tpu_torch.train.guardian import DivergenceGuardian
from gfedntm_tpu_torch.utils.observability import MetricsLogger

MODEL_KWARGS = dict(n_components=3, hidden_sizes=(8,), batch_size=8, num_epochs=2, seed=0)


def bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def same_dicts(a, b):
    return set(a) == set(b) and all(bitwise(a[k], b[k]) for k in a)


def _snaps(*vecs, weight=1.0):
    return [(weight, {"x": np.asarray(v, np.float32)}) for v in vecs]


def random_round(rng, n, scale=1.0, around=None):
    """n (weight, snapshot) pairs of two float32 tensors and an int32
    counter, around ``around`` (zeros by default)."""
    base = around or {"a": np.zeros((4, 5), np.float32), "b": np.zeros(7, np.float32)}
    return [(float(rng.integers(1, 9)), {
        "a": (base["a"] + scale * rng.normal(size=(4, 5))).astype(np.float32),
        "b": (base["b"] + scale * rng.normal(size=7)).astype(np.float32),
        "n": np.int32(rng.integers(0, 5)),
    }) for _ in range(n)]


# ---- golden copies: the port's numpy modules against the JAX package's -----

ESTIMATORS = [None, "median", "trimmed_mean:0.25", "krum:1"]


@pytest.mark.parametrize("spec", ["fedavg", "fedavgm", "fedadam", "fedyogi"])
@pytest.mark.parametrize("robust", ESTIMATORS)
def test_aggregators_match_the_jax_package_bitwise(spec, robust):
    """Three rounds of each aggregator on the same snapshots, then a twin
    restored from the port's ``state_dict`` continues as the JAX one does."""
    rng = np.random.default_rng(hash((spec, robust)) % 2**32)
    kwargs = {} if spec == "fedavg" else {"server_lr": 0.5}
    port = make_aggregator(spec, robust=robust, **kwargs)
    jax_ = j_agg.make_aggregator(spec, robust=robust, **kwargs)
    assert port.name == jax_.name
    current = {k: v for k, v in random_round(rng, 1)[0][1].items() if k != "n"}
    for _ in range(3):
        snaps = [(w, {k: v for k, v in s.items() if k != "n"})
                 for w, s in random_round(rng, 5, around=current)]
        out, want = port.aggregate(snaps, current), jax_.aggregate(snaps, current)
        assert same_dicts(out, want)
        current = want
    state, j_state = port.state_dict(), jax_.state_dict()
    if j_state is None:
        assert state is None
        return
    assert same_dicts(state, j_state)
    twin = make_aggregator(spec, robust=robust, **kwargs)
    twin.load_state_dict(state)
    snaps = random_round(rng, 4, around=current)
    snaps = [(w, {k: v for k, v in s.items() if k != "n"}) for w, s in snaps]
    assert same_dicts(twin.aggregate(snaps, current), jax_.aggregate(snaps, current))
    assert same_dicts(twin.state_dict(), jax_.state_dict())


@pytest.mark.parametrize("robust", ["mean"] + ESTIMATORS[1:] + ["trimmed_mean:0.4", "krum:2"])
def test_estimators_match_the_jax_package_bitwise(robust):
    rng = np.random.default_rng(3)
    for n in (2, 3, 4, 6):
        pairs = random_round(rng, n)
        got = make_estimator(robust)(pairs)
        want = j_agg.make_estimator(robust)(pairs)
        assert same_dicts(got, want), (robust, n)


def test_contribution_stats_match_the_jax_package():
    rng = np.random.default_rng(4)
    pairs = random_round(rng, 4)
    snaps = [s for _w, s in pairs]
    glob = random_round(rng, 1)[0][1]
    avg = weighted_mean(pairs)
    got = agg.contribution_stats(snaps, glob, avg)
    want = j_agg.contribution_stats(snaps, glob, avg)
    for a, b in zip(got, want):
        assert bitwise(a, b)


def gate_inputs(seed):
    """A cohort around a global with a NaN, a skewed, an outlier and a
    far-but-clippable candidate."""
    rng = np.random.default_rng(seed)
    glob = {"a": rng.normal(size=(4, 5)).astype(np.float32),
            "b": rng.normal(size=7).astype(np.float32)}
    cands = [(c, 2.0 + c, {"a": (glob["a"] + 0.01 * rng.normal(size=(4, 5))).astype(np.float32),
                           "b": (glob["b"] + 0.01 * rng.normal(size=7)).astype(np.float32)})
             for c in range(6)]
    cands[1][2]["b"][2] = np.nan
    cands[2] = (2, 1.0, {"a": cands[2][2]["a"][:3], "b": cands[2][2]["b"]})
    cands[3][2]["a"] += np.float32(4.0)
    cands[4][2]["a"] += np.float32(0.03)
    return glob, cands


@pytest.mark.parametrize("kw", [dict(), dict(max_update_norm=0.05), dict(mad_k=0.0),
                                dict(check_finite=False, mad_k=0.0, max_update_norm=0.05),
                                dict(mad_k=2.0, max_update_norm=1.0)])
def test_update_gate_matches_the_jax_package_bitwise(kw):
    glob, cands = gate_inputs(7)
    gates = [UpdateGate(**kw), j_san.UpdateGate(**kw)]
    results = []
    for gate in gates:
        gate.set_template(glob)
        results.append([gate.admit_round([(c, w, dict(s)) for c, w, s in cands], glob, r)
                        for r in range(2)])
    for got, want in zip(*results):
        assert [(c, w) for c, w, _s in got.accepted] == [(c, w) for c, w, _s in want.accepted]
        for (_c, _w, s1), (_c2, _w2, s2) in zip(got.accepted, want.accepted):
            assert same_dicts(s1, s2)
        assert [(r.client_id, r.reason, r.detail) for r in got.rejected] == \
            [(r.client_id, r.reason, r.detail) for r in want.rejected]
        assert bitwise([r.norm for r in got.rejected], [r.norm for r in want.rejected])
        assert got.clipped == want.clipped
    assert gates[0].total_rejections == gates[1].total_rejections
    assert update_norm(cands[0][2], glob) == j_san.update_norm(cands[0][2], glob)


def test_guardian_verdicts_match_the_jax_package():
    rng = np.random.default_rng(11)
    guards = [DivergenceGuardian(patience=2), JGuardian(patience=2)]
    for r in range(60):
        loss = float(rng.normal(100.0, 5.0)) * (1e3 if r % 17 in (5, 6) else 1.0)
        scale = 1e3 if r % 23 == 9 else 1.0
        avg = {"x": (scale * rng.normal(size=6)).astype(np.float32)}
        if r == 40:
            avg["x"][0] = np.nan
        contributors = [(c, float(rng.integers(1, 9))) for c in range(3)]
        verdicts = [g.observe(r, [loss, loss + 1.0], avg, contributors) for g in guards]
        assert verdicts[0] == verdicts[1], r
        assert guards[0].healthy == guards[1].healthy
        assert guards[0].dominant_contributors() == guards[1].dominant_contributors()
        if verdicts[0] is not None:
            for g in guards:
                g.note_rollback()


# ---- the cases of tests/test_data_plane.py, on the port ---------------------

class TestEstimators:
    honest = ([1.0, 2.0], [1.1, 2.1], [0.9, 1.9])

    def test_median_ignores_scaled_attacker(self):
        est = Median()(_snaps(*self.honest, [100.0, 200.0]))
        np.testing.assert_allclose(est["x"], [1.05, 2.05], rtol=1e-5)

    def test_trimmed_mean_drops_extremes(self):
        est = TrimmedMean(0.25)(_snaps(*self.honest, [100.0, 200.0]))
        np.testing.assert_allclose(est["x"], [1.05, 2.05], rtol=1e-5)
        est = TrimmedMean(0.49)(_snaps(*self.honest))
        np.testing.assert_allclose(est["x"], [1.0, 2.0], rtol=1e-5)
        with pytest.raises(ValueError):
            TrimmedMean(0.5)

    def test_krum_selects_honest_cluster_and_never_nonfinite(self):
        est = Krum(1)(_snaps(*self.honest, [100.0, 200.0]))
        np.testing.assert_allclose(est["x"], [1.0, 2.0], rtol=1e-5)
        est = Krum(1)(_snaps(*self.honest, [np.nan, np.nan]))
        np.testing.assert_allclose(est["x"], [1.0, 2.0], rtol=1e-5)

    def test_krum_tiny_cohort_falls_back_to_median(self):
        est = Krum(2)(_snaps([1.0, 2.0], [3.0, 4.0]))
        np.testing.assert_allclose(est["x"], [2.0, 3.0])
        assert Median()(_snaps(*self.honest))["x"].dtype == np.float32

    def test_make_estimator_and_aggregator_specs(self):
        assert make_estimator(None).name == "mean"
        assert make_estimator("trimmed_mean:0.25").name == "trimmed_mean:0.25"
        assert make_estimator("krum:2").f == 2
        for bad in ("geometric_median", "median:0.5"):
            with pytest.raises(ValueError):
                make_estimator(bad)
        assert make_aggregator("fedadam", robust="median").name == "fedadam+median"
        assert make_aggregator("krum:1").name == "fedavg+krum:1"
        with pytest.raises(ValueError):
            make_aggregator("median", robust="krum:1")
        with pytest.raises(ValueError, match="server-optimizer"):
            make_aggregator("median", server_lr=0.5)

    def test_robust_estimate_feeds_server_optimizer(self):
        current = {"x": np.zeros(2, np.float32)}
        snaps = _snaps(*self.honest, [1000.0, 2000.0])
        robust = FedAdam(server_lr=0.5, estimator="median").aggregate(snaps, current)
        assert np.all(np.abs(robust["x"]) < np.abs(weighted_mean(snaps)["x"]))
        out = FedAvg(estimator="trimmed_mean:0.25").aggregate(
            _snaps(*self.honest, [100.0, 200.0]))
        np.testing.assert_allclose(out["x"], [1.05, 2.05], rtol=1e-5)

    def test_stateless_aggregator_refuses_state(self):
        with pytest.raises(ValueError):
            FedAvg().load_state_dict({"m::x": np.zeros(2)})
        with pytest.raises(ValueError, match="state key"):
            make_aggregator("fedadam").load_state_dict({"q::x": np.zeros(2)})


REF = {"a": np.zeros((2,), np.float32), "b": np.zeros((3,), np.float32)}


def _gate(**kw):
    kw.setdefault("metrics", MetricsLogger(validate=True))
    gate = UpdateGate(**kw)
    gate.set_template(REF)
    return gate


def _cand(client_id, a=(0.1, 0.1), b=(0.1, 0.1, 0.1), weight=1.0):
    return (client_id, weight,
            {"a": np.asarray(a, np.float32), "b": np.asarray(b, np.float32)})


class TestUpdateGate:
    def test_conformance_rejections(self):
        gate = _gate()
        res = gate.admit_round([
            _cand(4), (1, 1.0, {"a": np.zeros(2, np.float32)}),
            (2, 1.0, {"a": np.zeros(5, np.float32), "b": np.zeros(3, np.float32)}),
            (3, 1.0, {"a": np.zeros(2, np.float64), "b": np.zeros(3, np.float32)}),
        ], REF, round_idx=0)
        assert [c for c, _w, _s in res.accepted] == [4]
        assert {r.client_id: r.reason for r in res.rejected} == \
            {1: "key_skew", 2: "shape_skew", 3: "dtype_skew"}
        assert gate.metrics.registry.counter("key_skew_excluded").value == 3
        assert len(gate.metrics.events("update_rejected")) == 3

    def test_nonfinite_rejected_unless_disabled(self):
        res = _gate().admit_round([_cand(1), _cand(7, a=(np.nan, 0.0))], REF, round_idx=3)
        assert [(r.client_id, r.reason) for r in res.rejected] == [(7, "nonfinite")]
        assert "a" in res.rejected[0].detail
        res = _gate(check_finite=False, mad_k=0.0).admit_round(
            [_cand(1, a=(np.nan, 0.0))], REF, 0)
        assert len(res.accepted) == 1 and not res.rejected

    def test_norm_outlier_needs_cohort(self):
        gate = _gate(mad_k=4.0)
        huge = _cand(9, a=(1e4, 1e4), b=(1e4, 1e4, 1e4))
        assert not gate.admit_round([_cand(1), huge], REF, 0).rejected
        res = gate.admit_round([_cand(1), _cand(2), _cand(3), huge], REF, 1)
        assert [(r.client_id, r.reason) for r in res.rejected] == [(9, "norm_outlier")]
        assert res.rejected[0].norm > 1e4
        assert not _gate(mad_k=0.0).admit_round(
            [_cand(1), _cand(2), _cand(3), huge], REF, 0).rejected

    def test_hard_clip_bounds_influence(self):
        gate = _gate(mad_k=0.0, max_update_norm=0.5)
        res = gate.admit_round([_cand(5, a=(3.0, 4.0), b=(0.0, 0.0, 0.0))], REF, 0)
        assert res.clipped == [(5, pytest.approx(5.0), 0.5)] and not res.rejected
        snap = res.accepted[0][2]
        assert update_norm(snap, REF) == pytest.approx(0.5, rel=1e-6)
        np.testing.assert_allclose(snap["a"] / np.linalg.norm(snap["a"]), [0.6, 0.8],
                                   rtol=1e-5)
        assert gate.metrics.events("update_clipped")[0]["client"] == 5

    def test_consecutive_streak_resets_on_acceptance(self):
        gate = _gate()
        nan = _cand(7, a=(np.nan, 0.0))
        gate.admit_round([nan], REF, 0)
        gate.admit_round([nan], REF, 1)
        assert gate.consecutive(7) == 2 and gate.total_rejections[7] == 2
        gate.admit_round([_cand(7)], REF, 2)
        assert gate.consecutive(7) == 0 and gate.total_rejections[7] == 2
        with pytest.raises(ValueError):
            UpdateGate(max_update_norm=0.0)
        with pytest.raises(ValueError):
            UpdateGate(suspect_after=0)


class TestGuardian:
    avg = {"x": np.ones(2, np.float32)}

    def test_nonfinite_global_is_immediate(self):
        g = DivergenceGuardian(patience=5)
        assert g.observe(0, [1.0], {"x": np.array([1.0, np.nan], np.float32)}) \
            == "nonfinite_global"
        assert not g.healthy

    def test_loss_explosion_respects_patience_and_baseline(self):
        g = DivergenceGuardian(patience=2, loss_factor=4.0)
        for r in range(3):
            assert g.observe(r, [100.0], self.avg) is None
        assert g.observe(3, [1e5], self.avg, [(1, 1.0)]) is None and not g.healthy
        assert g.observe(4, [1e5], self.avg, [(1, 1.0)]) == "loss_explosion"
        g = DivergenceGuardian(patience=3, loss_factor=4.0)
        g.observe(0, [100.0], self.avg)
        g.observe(1, [1e5], self.avg)
        g.observe(2, [1e5], self.avg)
        assert g.observe(3, [1e5], self.avg) == "loss_explosion"

    def test_norm_explosion_and_dominance(self):
        g = DivergenceGuardian(patience=1, norm_factor=10.0)
        assert g.observe(0, [1.0], {"x": np.ones(4, np.float32)}) is None
        assert g.observe(1, [1.0], {"x": np.full(4, 1e3, np.float32)}) == "norm_explosion"
        g = DivergenceGuardian(patience=2, loss_factor=4.0, dominance_factor=2.0)
        g.observe(0, [1.0], self.avg)
        g.observe(1, [1e9], self.avg, [(1, 10.0), (2, 1.0), (3, 1.0)])
        assert g.dominant_contributors() == [1]
        g.note_rollback()
        assert g.healthy and g.dominant_contributors() == []

    def test_single_byzantine_loss_report_cannot_force_rollback(self):
        g = DivergenceGuardian(patience=1, loss_factor=4.0)
        for r in range(6):
            lie = np.nan if r % 2 else 1e30
            assert g.observe(r, [100.0, 101.0, 99.0, lie], self.avg) is None
        assert g.observe(9, [np.nan, np.nan, np.nan], self.avg) == "loss_explosion"
        with pytest.raises(ValueError):
            DivergenceGuardian(patience=0)
        with pytest.raises(ValueError):
            DivergenceGuardian(loss_factor=1.0)


# ---- the aggregation plane's engine against the numpy oracle ---------------

TEMPLATE = {
    "a": np.zeros((6, 9), np.float32),
    "b": np.zeros((17,), np.float32),
    "n": np.zeros((), np.int32),
}


@pytest.fixture(scope="module")
def engine():
    return DeviceAggEngine(device="cpu")


@pytest.fixture(scope="module")
def plane():
    return FlatPlane(TEMPLATE)


def _snap(rng, scale=1.0, around=None):
    base = around or {k: np.zeros_like(v) for k, v in TEMPLATE.items()}
    return {
        "a": (base["a"] + scale * rng.normal(size=(6, 9))).astype(np.float32),
        "b": (base["b"] + scale * rng.normal(size=(17,))).astype(np.float32),
        "n": np.int32(rng.integers(0, 7)),
    }


def _pairs(n=5, seed=0, weights=None):
    rng = np.random.default_rng(seed)
    weights = weights or [3.0, 1.0, 2.5, 4.0, 1.5, 2.0, 0.5, 6.0][:n]
    return [(float(w), _snap(rng)) for w in weights]


def _assert_estimates_equal(dev, ref, *, bitwise_f32=False):
    assert set(dev) == set(ref)
    for k in ref:
        r, d = np.asarray(ref[k]), np.asarray(dev[k])
        assert r.dtype == d.dtype and r.shape == d.shape, (k, r.dtype, d.dtype)
        if bitwise_f32 and r.dtype == np.float32:
            assert np.array_equal(r.view(np.uint32), d.view(np.uint32)), k
        else:
            np.testing.assert_allclose(d.astype(np.float64), r.astype(np.float64),
                                       rtol=2e-6, atol=2e-6, err_msg=k)


class TestEngineParity:
    def test_plane_layout_and_roundtrip(self, engine, plane):
        assert plane.keys == sorted(TEMPLATE) and plane.dim == 6 * 9 + 17 + 1
        assert plane.non_f32_keys == ["n"]
        snap = _snap(np.random.default_rng(3))
        back = plane.unflatten(plane.flatten(snap))
        for k in TEMPLATE:
            assert back[k].dtype == np.asarray(snap[k]).dtype
            np.testing.assert_array_equal(back[k], snap[k])
        mat = engine.stack(plane, [s for _w, s in _pairs(3)])
        assert mat.shape == (3, plane.dim) and mat.device == torch.device("cpu")

    @pytest.mark.parametrize("seed,weights", [(0, None), (9, [10.0, 0.25, 7.5, 1.0, 3.0, 0.5]),
                                              (5, [1.0, 1.0, 1.0])])
    def test_weighted_mean_bitwise_f32(self, engine, plane, seed, weights):
        pairs = _pairs(len(weights or [0] * 5), seed=seed, weights=weights)
        dev, ref = WeightedMean()(stack_round(engine, plane, pairs)), weighted_mean(pairs)
        _assert_estimates_equal(dev, ref, bitwise_f32=True)
        assert np.asarray(dev["n"]).dtype == np.float64  # int keys average as numpy does

    def test_weighted_mean_keeps_numpys_signed_zero(self, engine):
        """Python's sum starts from 0, so numpy's mean of -0.0 rows is +0.0."""
        flat = FlatPlane({"x": np.zeros(3, np.float32)})
        pairs = [(2.0, {"x": np.array([-0.0, 1.0, -0.0], np.float32)}),
                 (3.0, {"x": np.array([-0.0, 2.0, 0.0], np.float32)})]
        dev = WeightedMean()(stack_round(engine, flat, pairs))
        _assert_estimates_equal(dev, weighted_mean(pairs), bitwise_f32=True)

    @pytest.mark.parametrize("n,frac", [(4, 0.25), (5, 0.2), (8, 0.3), (3, 0.0)])
    def test_trimmed_mean_parity(self, engine, plane, n, frac):
        pairs = _pairs(n, seed=n)
        est = TrimmedMean(frac)
        _assert_estimates_equal(est(stack_round(engine, plane, pairs)), est(pairs))

    @pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
    def test_median_parity_and_even_cohorts_average_the_middles(self, engine, plane, n):
        pairs = _pairs(n, seed=10 + n)
        dev = Median()(stack_round(engine, plane, pairs))
        _assert_estimates_equal(dev, Median()(pairs))
        if n % 2 == 0:
            s = np.sort(np.stack([p[1]["a"] for p in pairs]), axis=0)
            lower = s[n // 2 - 1]
            assert not np.array_equal(dev["a"], lower)  # not torch.median's lower middle
            np.testing.assert_allclose(dev["a"], (lower + s[n // 2]) / 2, rtol=1e-6)

    def test_median_of_a_nan_coordinate_is_nan(self, engine, plane):
        pairs = _pairs(4, seed=3)
        pairs[1][1]["a"][1, 2] = np.nan
        dev, ref = Median()(stack_round(engine, plane, pairs)), Median()(pairs)
        assert np.isnan(ref["a"][1, 2]) and np.isnan(dev["a"][1, 2])
        mask = ~np.isnan(ref["a"])
        np.testing.assert_allclose(dev["a"][mask], ref["a"][mask], rtol=2e-6)

    def test_krum_parity_and_neighbor_selection(self, engine, plane):
        rng = np.random.default_rng(7)
        pairs = [(2.0, _snap(rng, scale=0.1)) for _ in range(4)] + [(9.0, _snap(rng, 50.0))]
        sr = stack_round(engine, plane, pairs)
        _assert_estimates_equal(Krum(1)(sr), Krum(1)(pairs))
        flat = np.stack([plane.flatten(s) for _w, s in pairs])
        sq = np.einsum("ij,ij->i", flat, flat)
        d2_np = sq[:, None] + sq[None, :] - 2.0 * (flat @ flat.T)
        np.testing.assert_allclose(engine.krum_d2(sr), d2_np, rtol=1e-5,
                                   atol=1e-6 * float(sq.max()))
        chosen = krum_select(d2_np, 5, 1)
        # The same clients; their order follows scores equal up to rounding.
        np.testing.assert_array_equal(np.sort(chosen),
                                      np.sort(krum_select(engine.krum_d2(sr), 5, 1)))
        assert 4 not in chosen

    def test_krum_never_selects_nonfinite_row(self, engine, plane):
        rng = np.random.default_rng(8)
        pairs = [(1.0, _snap(rng, scale=0.1)) for _ in range(4)]
        bad = _snap(rng, scale=0.1)
        bad["a"][0, 0] = np.nan
        pairs.append((5.0, bad))
        sr = stack_round(engine, plane, pairs)
        _assert_estimates_equal(Krum(1)(sr), Krum(1)(pairs))
        assert 4 not in krum_select(engine.krum_d2(sr), 5, 1)

    def test_nonfinite_rows_in_coordinate_estimators(self, engine, plane):
        rng = np.random.default_rng(11)
        pairs = [(1.0, _snap(rng)) for _ in range(4)]
        bad = _snap(rng)
        bad["a"][2, 3] = np.inf
        pairs.append((1.0, bad))
        est = TrimmedMean(0.2)
        _assert_estimates_equal(est(stack_round(engine, plane, pairs)), est(pairs))

    def test_krum_tiny_cohort_and_subsets(self, engine, plane):
        pairs = _pairs(2, seed=1)
        sr = stack_round(engine, plane, pairs)
        _assert_estimates_equal(Krum(1)(sr), Median()(pairs))
        pairs = _pairs(5, seed=12)
        sub = stack_round(engine, plane, pairs).subset([0, 2, 4])
        assert len(sub) == 3 and sub.weights == [pairs[i][0] for i in (0, 2, 4)]
        _assert_estimates_equal(WeightedMean()(sub),
                                weighted_mean([pairs[0], pairs[2], pairs[4]]), bitwise_f32=True)

    def test_aggregators_compose_with_stacked_rounds(self, engine, plane):
        pairs = _pairs(5, seed=13)
        sr = stack_round(engine, plane, pairs)
        current = _snap(np.random.default_rng(14))
        for spec, robust in [("fedavg", None), ("fedavgm", None), ("fedadam", "median"),
                             ("fedyogi", "trimmed_mean:0.2"), ("fedavg", "krum:1")]:
            a_np = make_aggregator(spec, robust=robust).aggregate(pairs, current)
            a_dev = make_aggregator(spec, robust=robust).aggregate(sr, current)
            _assert_estimates_equal(a_dev, a_np,
                                    bitwise_f32=(spec, robust) == ("fedavg", None))

    def test_contribution_stats_parity(self, engine, plane):
        pairs = _pairs(4, seed=15)
        glob = _snap(np.random.default_rng(16))
        avg = weighted_mean(pairs)
        sr = stack_round(engine, plane, pairs, current_global=glob)
        got = engine.contribution_stats(sr, avg)
        want = agg.contribution_stats([s for _w, s in pairs], glob, avg)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
        with pytest.raises(ValueError, match="gvec"):
            engine.contribution_stats(stack_round(engine, plane, pairs), avg)

    def test_noise_is_reproducible_per_seed_and_index(self, engine, plane):
        a = engine.noise_vector(plane, std=1.0, seed=0, index=0)
        assert a.dtype == np.float32 and a.shape == (plane.dim,)
        assert np.array_equal(a, engine.noise_vector(plane, std=1.0, seed=0, index=0))
        assert not np.array_equal(a, engine.noise_vector(plane, std=1.0, seed=0, index=1))
        assert np.array_equal(engine.noise_vector(plane, std=2.0, seed=0, index=0),
                              a * np.float32(2.0))

    def test_engine_defaults_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DeviceAggEngine()


def _gate_pair(engine, **kw):
    base = dict(mad_k=4.0, min_cohort=3)
    base.update(kw)
    gates = [UpdateGate(**base), UpdateGate(**base)]
    for g in gates:
        g.set_template(TEMPLATE)
    gates[1].set_engine(engine)
    return gates


def _decisions(result):
    return ([c for c, _w, _s in result.accepted],
            [(r.client_id, r.reason) for r in result.rejected],
            [c for c, _n, _m in result.clipped])


class TestGateParity:
    def _cohort(self, seed=21):
        rng = np.random.default_rng(seed)
        glob = _snap(rng)
        cands = [(cid, 10.0 + cid, {
            "a": (glob["a"] + 0.01 * rng.normal(size=(6, 9))).astype(np.float32),
            "b": (glob["b"] + 0.01 * rng.normal(size=(17,))).astype(np.float32),
            "n": np.int32(2)}) for cid in range(5)]
        return glob, cands

    def _both(self, engine, cands, glob, **kw):
        g_np, g_dev = _gate_pair(engine, **kw)
        return (g_np.admit_round([(c, w, dict(s)) for c, w, s in cands], glob, 0),
                g_dev.admit_round([(c, w, dict(s)) for c, w, s in cands], glob, 0))

    def test_norm_parity_and_clean_cohort(self, engine, plane):
        glob, cands = self._cohort()
        counts, norms = engine.gate_stats(engine.stack(plane, [s for _c, _w, s in cands]),
                                          engine.put_vector(plane, glob))
        assert not counts.any()
        for i, (_c, _w, s) in enumerate(cands):
            ref = update_norm(s, glob)
            assert abs(norms[i] - ref) <= 1e-12 * max(ref, 1.0)
        r_np, r_dev = self._both(engine, cands, glob)
        assert _decisions(r_np) == _decisions(r_dev) and len(r_dev.accepted) == 5
        assert isinstance(r_dev.stacked, StackedRound) and len(r_dev.stacked) == 5
        assert r_np.stacked is None

    def test_mad_outlier_mask_parity(self, engine):
        glob, cands = self._cohort()
        rng = np.random.default_rng(31)
        for cid, scale in ((90, 5.0), (91, 0.05)):
            cands.append((cid, 1.0, {
                "a": (glob["a"] + scale * rng.normal(size=(6, 9))).astype(np.float32),
                "b": glob["b"].copy(), "n": np.int32(2)}))
        r_np, r_dev = self._both(engine, cands, glob)
        assert _decisions(r_np) == _decisions(r_dev)
        assert (90, "norm_outlier") in _decisions(r_dev)[1]
        for a, b in zip(r_np.rejected, r_dev.rejected):
            assert abs(a.norm - b.norm) <= 1e-6 * max(a.norm, 1.0)

    def test_nonfinite_and_conformance_parity(self, engine):
        glob, cands = self._cohort()
        cands[1][2]["b"][3] = np.nan
        skew = dict(cands[2][2])
        skew["a"] = skew["a"][:4]
        cands[2] = (cands[2][0], cands[2][1], skew)
        r_np, r_dev = self._both(engine, cands, glob)
        assert _decisions(r_np) == _decisions(r_dev)
        assert dict(_decisions(r_dev)[1]) == {1: "nonfinite", 2: "shape_skew"}
        detail = {r.client_id: r.detail for r in r_dev.rejected}[1]
        assert "b" in detail and "non-finite" in detail

    def test_clip_parity_and_unclipped_rows_verbatim(self, engine, plane):
        """Clipped rows match the numpy f64 clip to float tolerance (the
        factor divides by a norm summed in another order); rows with factor
        1 are the snapshots' bits, and the mean of the stacked round is the
        mean of its host dicts, bitwise."""
        glob, cands = self._cohort()
        norms = sorted(update_norm(s, glob) for _c, _w, s in cands)
        for cap in (float(np.median(norms) * 0.8), (norms[-2] + norms[-1]) / 2.0):
            r_np, r_dev = self._both(engine, cands, glob, max_update_norm=cap, mad_k=0.0)
            assert _decisions(r_np) == _decisions(r_dev) and r_np.clipped
            for (c1, _w1, s1), (c2, _w2, s2) in zip(r_np.accepted, r_dev.accepted):
                assert c1 == c2
                for k in s1:
                    np.testing.assert_allclose(np.asarray(s2[k], np.float64),
                                               np.asarray(s1[k], np.float64),
                                               rtol=1e-5, atol=1e-6)
            rows = r_dev.stacked.mat.numpy()
            clipped = {c for c, _n, _m in r_dev.clipped}
            assert clipped and len(clipped) < 5 or cap < norms[-2]
            for i, (cid, _w, _snap) in enumerate(r_dev.accepted):
                if cid not in clipped:
                    assert bitwise(rows[i], plane.flatten(cands[cid][2])), cid
            _assert_estimates_equal(WeightedMean()(r_dev.stacked),
                                    weighted_mean([(w, s) for _c, w, s in r_dev.accepted]),
                                    bitwise_f32=True)
            _assert_estimates_equal(WeightedMean()(r_dev.stacked),
                                    weighted_mean([(w, s) for _c, w, s in r_np.accepted]))

    def test_f32_norm_overflow_row_matches_oracle(self, engine):
        glob, cands = self._cohort()
        cands.append((77, 1.0, {"a": np.full((6, 9), 1e20, np.float32),
                                "b": glob["b"].copy(), "n": np.int32(2)}))
        r_np, r_dev = self._both(engine, cands, glob)
        assert _decisions(r_np) == _decisions(r_dev)
        assert (77, "norm_outlier") in _decisions(r_dev)[1]
        n_np = {r.client_id: r.norm for r in r_np.rejected}[77]
        n_dev = {r.client_id: r.norm for r in r_dev.rejected}[77]
        assert np.isfinite(n_dev) and abs(n_dev - n_np) <= 1e-6 * n_np
        r_np2, r_dev2 = self._both(engine, cands, glob, mad_k=0.0, max_update_norm=1.0)
        assert _decisions(r_np2) == _decisions(r_dev2)
        assert 77 in [c for c, _n, _m in r_dev2.clipped] and not r_dev2.rejected

    def test_check_finite_off_and_mad_zero_parity(self, engine):
        glob, cands = self._cohort()
        cands[0][2]["a"][0, 0] = np.nan
        r_np, r_dev = self._both(engine, cands, glob, check_finite=False, max_update_norm=1e-3)
        assert _decisions(r_np) == _decisions(r_dev)
        assert len(r_dev.accepted) == 5 and not r_dev.clipped
        glob, cands = self._cohort()
        cands.append((99, 1.0, {
            "a": (glob["a"] + 100.0 * np.random.default_rng(5).normal(size=(6, 9))
                  ).astype(np.float32), "b": glob["b"].copy(), "n": np.int32(2)}))
        r_np, r_dev = self._both(engine, cands, glob, mad_k=0.0)
        assert _decisions(r_np) == _decisions(r_dev) and len(r_dev.accepted) == 6

    def test_streak_accounting_parity(self, engine):
        glob, cands = self._cohort()
        bad_snap = {k: np.asarray(v).copy() for k, v in cands[0][2].items()}
        bad_snap["a"][0, 0] = np.nan
        bad = (cands[0][0], cands[0][1], bad_snap)
        g_np, g_dev = _gate_pair(engine)
        for r in range(2):
            g_np.admit_round([bad] + cands[1:], glob, r)
            g_dev.admit_round([bad] + cands[1:], glob, r)
            assert g_np.consecutive(0) == g_dev.consecutive(0) == r + 1
        g_np.admit_round(cands, glob, 2)
        g_dev.admit_round(cands, glob, 2)
        assert g_np.consecutive(0) == g_dev.consecutive(0) == 0
        assert g_np.total_rejections == g_dev.total_rejections


# ---- the server's backend seam and admission wiring -------------------------

class TestServerAdmission:
    def _server(self, **kw):
        base = dict(min_clients=1, family="avitm", model_kwargs=MODEL_KWARGS,
                    metrics=MetricsLogger(validate=True), device="cpu")
        base.update(kw)
        server = FederatedServer(**base)
        server.template = build_template_model("avitm", 30, MODEL_KWARGS, device="cpu")
        return server

    def _reply(self, client_id, snap, loss=1.0):
        return pb.StepReply(client_id=client_id, shared=codec.flatdict_to_bundle(snap),
                            loss=loss, nr_samples=4.0)

    def test_backend_resolution(self):
        with pytest.raises(ValueError):
            self._server(aggregation_backend="gpu")
        server = self._server()
        server._ensure_template()
        assert server._agg_backend_resolved == "numpy" and server.update_gate._engine is None
        server = self._server(aggregation_backend="device")
        server._ensure_template()
        assert server._agg_backend_resolved == "device"
        assert server.metrics.registry.gauge("agg_backend_device").value == 1.0

    def test_cuda_server_resolves_auto_to_the_device(self, monkeypatch):
        server = self._server()
        monkeypatch.setattr(server, "device", torch.device("cuda", 0))
        made = []
        monkeypatch.setattr(
            "gfedntm_tpu_torch.federation.server.DeviceAggEngine",
            lambda device: made.append(device) or DeviceAggEngine("cpu"))
        server._ensure_template()
        assert server._agg_backend_resolved == "device" and made == [server.device]

    def test_engine_failure_raises_instead_of_numpy(self, monkeypatch):
        server = self._server(aggregation_backend="device")

        def broken(device):
            raise RuntimeError("no engine")

        monkeypatch.setattr("gfedntm_tpu_torch.federation.server.DeviceAggEngine", broken)
        with pytest.raises(RuntimeError, match="no engine"):
            server._ensure_template()

    @pytest.mark.parametrize("backend", ["numpy", "device"])
    def test_nan_reply_rejected_then_probation_then_drop(self, backend):
        server = self._server(probation_rounds=2, aggregation_backend=backend)
        server.federation.connect_vocab(1, ("a",), 4.0)
        server.federation.connect_ready(1, "localhost:1")
        rec = server.federation.get_clients()[0]
        tmpl = server._shared_template()
        poisoned = {k: np.full_like(v, np.nan) if v.dtype.kind == "f" else v
                    for k, v in tmpl.items()}
        good = ClientRecord(2, nr_samples=4.0)
        for it, status in enumerate(["active", SUSPECT, DROPPED]):
            out = server._collect_snapshots(
                [(rec, self._reply(1, poisoned)), (good, self._reply(2, tmpl))], iteration=it)
            assert len(out) == 1 and rec.status == status
            assert isinstance(out, StackedRound) == (backend == "device")
        assert rec.suspect_reason == "poisoned"
        assert server.metrics.registry.counter("updates_rejected").value == 3
        assert server._round_accepted == [(2, 4.0, 1.0)]
        avg = server.aggregator.aggregate(out, current_global=server._current_global())
        _assert_estimates_equal(avg, weighted_mean([(4.0, tmpl)]), bitwise_f32=True)

    def test_recovery_is_admission_scoped(self):
        server = self._server()
        server.federation.connect_vocab(1, ("a",), 4.0)
        server.federation.connect_ready(1, "localhost:1")
        rec = server.federation.get_clients()[0]
        server.federation.mark_suspect(1, "localhost:1", 0, reason="poisoned")
        tmpl = server._shared_template()
        poisoned = {k: np.full_like(v, np.nan) if v.dtype.kind == "f" else v
                    for k, v in tmpl.items()}
        server._collect_snapshots([(rec, self._reply(1, poisoned))], iteration=1,
                                  was_suspect=frozenset({1}))
        assert rec.status == SUSPECT
        server._collect_snapshots([(rec, self._reply(1, tmpl))], iteration=2,
                                  was_suspect=frozenset({1}))
        assert rec.status == "active"
        assert server.metrics.events("client_recovered")[0]["round"] == 2


# ---- round checkpoint integrity ---------------------------------------------

class TestCheckpointIntegrity:
    def _saved(self, tmp_path):
        ckpt = FederationCheckpointer(str(tmp_path))
        ckpt.save_round(4, {"a": np.ones(2, np.float32)}, [], vocab=["x"])
        return ckpt

    def test_corrupt_sidecar_and_missing_keys_fail_actionably(self, tmp_path):
        ckpt = self._saved(tmp_path)
        with open(ckpt.meta_path, "w") as fh:
            fh.write('{"round": 4, "average_keys": ["a"')
        with pytest.raises(CheckpointIntegrityError, match="truncated"):
            ckpt.load_meta()
        with open(ckpt.meta_path, "w") as fh:
            json.dump({"vocab": ["x"]}, fh)
        with pytest.raises(CheckpointIntegrityError, match="average_keys"):
            ckpt.load_meta()

    def test_round_mismatch_with_no_matching_round_fails(self, tmp_path):
        ckpt = self._saved(tmp_path)
        meta = ckpt.load_meta()
        meta["round"] = 2
        with open(ckpt.meta_path, "w") as fh:
            json.dump(meta, fh)
        with pytest.raises(CheckpointIntegrityError, match="mismatch"):
            ckpt.restore_round({"a": np.zeros(2, np.float32)})

    def test_stale_sidecar_falls_back_to_its_own_round(self, tmp_path):
        ckpt = FederationCheckpointer(str(tmp_path))
        ckpt.save_round(4, {"a": np.full(2, 4.0, np.float32)}, [], vocab=["x"])
        stale = open(ckpt.meta_path).read()
        ckpt.save_round(6, {"a": np.full(2, 6.0, np.float32)}, [], vocab=["x"])
        ckpt.save_round(6, {"a": np.full(2, 7.0, np.float32)}, [], vocab=["x"])  # idempotent
        with open(ckpt.meta_path, "w") as fh:
            fh.write(stale)
        step, restored = ckpt.restore_round({"a": np.zeros(2, np.float32)})
        assert step == 4 and restored["a"].dtype == np.float32
        np.testing.assert_array_equal(restored["a"], 4.0)

    def test_aggregator_state_roundtrip_and_corruption(self, tmp_path):
        ckpt = FederationCheckpointer(str(tmp_path))
        state = {"m::a": np.arange(3, dtype=np.float32)}
        ckpt.save_round(2, {"a": np.ones(3, np.float32)}, [], vocab=["x"],
                        aggregator_state=state)
        rnd, arrays = ckpt.load_aggregator_state()
        assert rnd == 2 and same_dicts(arrays, state)
        ckpt.save_round(3, {"a": np.ones(3, np.float32)}, [], vocab=["x"])
        assert ckpt.load_aggregator_state() is None  # stateless now: stale file removed
        with open(ckpt.aggregator_path, "wb") as fh:
            fh.write(b"not an npz")
        with pytest.raises(CheckpointIntegrityError, match="aggregator"):
            ckpt.load_aggregator_state()

    def test_sidecar_and_aggregator_state_are_the_jax_format(self, tmp_path):
        from gfedntm_tpu.train.checkpoint import FederationCheckpointer as JCheckpointer

        avg = {"p/a": np.arange(4, dtype=np.float32), "p/n": np.int32(3)}
        membership = [{"client_id": 1, "session_token": "t"}]
        state = {"m::p/a": np.ones(4, np.float32)}
        for cls, sub in ((FederationCheckpointer, "port"), (JCheckpointer, "jax")):
            ck = cls(str(tmp_path / sub))
            ck.save_round(5, avg, membership, vocab=["a", "b"], extra={"family": "avitm"},
                          aggregator_state=state)
            ck.close()
        for name in ("federation.json", "aggregator_state.npz"):
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "jax" / name).read_bytes(), name

    def test_server_resume_emits_checkpoint_invalid_event(self, tmp_path):
        from gfedntm_tpu_torch.data.vocab import Vocabulary

        crashed = FederatedServer(min_clients=1, model_kwargs=MODEL_KWARGS,
                                  save_dir=str(tmp_path), device="cpu", journal_every=0)
        crashed.global_vocab = Vocabulary(tuple(f"tok{i:02d}" for i in range(30)))
        crashed.template = build_template_model("avitm", 30, MODEL_KWARGS, device="cpu")
        crashed.last_average = dict(crashed._shared_template())
        crashed.global_iterations = 3
        crashed._save_round_checkpoint()
        with open(crashed._checkpointer().meta_path, "w") as fh:
            fh.write("{broken")
        m = MetricsLogger(validate=True)
        resumed = FederatedServer(min_clients=1, model_kwargs=MODEL_KWARGS,
                                  save_dir=str(tmp_path), metrics=m, device="cpu")
        with pytest.raises(CheckpointIntegrityError):
            resumed.restore_from_checkpoint()
        assert m.registry.counter("checkpoint_invalid").value == 1
        assert m.events("checkpoint_invalid")[0]["reason"]


# ---- federations over localhost gRPC ----------------------------------------

def _corpora(n_clients, docs, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"tok{i:02d}" for i in range(45)]
    return [RawCorpus(documents=[" ".join(rng.choice(words, size=12)) for _ in range(docs)])
            for _ in range(n_clients)]


def _run_federation(tmp_path, corpora, tag, *, metrics=None, faults=(), **server_kw):
    """One in-process federation of port nodes on the CPU, to its end.
    ``faults`` are ``(peer, payload, times, skip)`` payload corruptions of
    that client's TrainStep replies, consumed in order."""
    injector = None
    if faults:
        injector = FaultInjector(seed=0, metrics=metrics)
        for peer, payload, times, skip in faults:
            injector.script("TrainStep", kind="corrupt", payload=payload, times=times,
                            peer=peer, skip=skip)
    base = dict(min_clients=len(corpora), family="avitm", model_kwargs=MODEL_KWARGS,
                max_iters=40, save_dir=str(tmp_path / f"{tag}-server"), metrics=metrics,
                fault_injector=injector, checkpoint_every=0, round_backoff_s=0.05,
                device="cpu")
    base.update(server_kw)
    server = FederatedServer(**base)
    addr = server.start("127.0.0.1:0")
    clients = [Client(client_id=c + 1, corpus=corpus, server_address=addr, max_features=45,
                      listen_address="127.0.0.1:0", advertise_host="127.0.0.1",
                      save_dir=str(tmp_path / f"{tag}-c{c + 1}"), metrics=metrics, device="cpu")
               for c, corpus in enumerate(corpora)]
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    try:
        assert server.wait_done(timeout=120), f"{tag}: did not finish"
        for t in threads:
            t.join(timeout=60)
    finally:
        server.stop()
        for c in clients:
            c.shutdown()
    return server, clients


@pytest.fixture(scope="module")
def honest_runs(tmp_path_factory):
    """The two honest clients alone, under each robust aggregator."""
    corpora = _corpora(3, docs=24, seed=5)
    return {robust: _run_federation(tmp_path_factory.mktemp("honest"), corpora[:2], "base",
                                    robust_aggregator=robust)[0].global_betas
            for robust in ("median", "trimmed_mean:0.25")}


@pytest.mark.parametrize("robust", ["median", "trimmed_mean:0.25"])
def test_i_poisoned_client_rejected_and_run_matches_honest_baseline(tmp_path, honest_runs,
                                                                    robust):
    """Client 3 of 3 sends NaN updates twice, then 100x-scaled ones: each is
    rejected (nonfinite, then norm_outlier), the client lands in probation
    and is dropped, and the honest clients' run is the baseline's."""
    corpora = _corpora(3, docs=24, seed=5)
    metrics = MetricsLogger(validate=True)
    server, clients = _run_federation(
        tmp_path, corpora, "poison", metrics=metrics, robust_aggregator=robust,
        faults=[("client3", "nan", 2, 0), ("client3", "scale:100", 64, 0)])
    base = honest_runs[robust]
    assert base is not None and np.isfinite(base).all()
    np.testing.assert_allclose(server.global_betas, base, rtol=1e-4, atol=1e-5)
    rejections = metrics.events("update_rejected")
    assert all(e["client"] == 3 for e in rejections)
    reasons = [e["reason"] for e in rejections]
    assert reasons[:2] == ["nonfinite", "nonfinite"] and "norm_outlier" in reasons[2:]
    rec = server.federation.get(3)
    assert rec.status in (SUSPECT, DROPPED) and rec.suspect_reason == "poisoned"
    assert all(s["reason"] == "poisoned" for s in metrics.events("client_suspect"))
    assert all(c.stepper.finished for c in clients[:2])
    assert metrics.registry.counter("divergence_rollbacks").value == 0


def test_j_one_shot_nan_with_the_gate_off_rolls_back_once(tmp_path):
    """The gate off, one NaN reply at round 4 reaches the aggregate: exactly
    one rollback to the round-4 checkpoint; the re-broadcast resets the
    delta sessions on the server (2) and on every client (3 x 2), nothing
    mis-decodes, and the run finishes finite with checkpoints after it."""
    metrics = MetricsLogger(validate=True)
    server, clients = _run_federation(
        tmp_path, _corpora(3, docs=24, seed=9), "rollback", metrics=metrics,
        faults=[("client1", "nan", 1, 4)], model_kwargs=dict(MODEL_KWARGS, num_epochs=3),
        sanitize=False, checkpoint_every=2, wire_codec="delta")
    rollbacks = metrics.events("divergence_rollback")
    assert [(r["reason"], r["round"], r["restored_round"]) for r in rollbacks] == \
        [("nonfinite_global", 4, 4)]
    assert metrics.registry.counter("divergence_rollbacks").value == 1
    assert metrics.registry.counter("codec_resets").value == 2 + 3 * 2
    assert metrics.registry.counter("codec_ref_miss").value == 0
    assert server.global_iterations == 9
    assert np.isfinite(server.global_betas).all()
    assert all(c.stepper.finished and c.results is not None for c in clients)
    assert server._checkpointer().latest_round() > 4
