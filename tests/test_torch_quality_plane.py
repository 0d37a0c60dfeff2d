"""The model-quality plane in the port, on the CPU, held to the JAX package's.

- The copies (``eval/monitor.py``, ``data/synthetic.load_reference_npz``)
  are the originals' sources but for their imports.
- Bitwise on the same averages: the topic monitor's records (NPMI,
  diversity, inverted RBO, drift and matching, the guard's streak), the
  contribution tracker's EWMAs and pairwise summary, the pieces
  (``topics_from_beta``, ``match_topics``, ``js_divergence_rows``) and the
  reference corpus readers.
- The server's quality step on the numpy and the device backend (the
  cases of ``tests/test_quality_plane.py``'s server seam), and a gRPC
  federation with ``quality_every=1`` on both backends, whose NPMI series
  the JAX monitor reproduces from the same betas.
- The guard routes a ``coherence_collapse`` verdict through the rollback:
  the checkpointed round is restored and the next push orders every
  recipient's codec session reset.
"""

import ast
import threading
from pathlib import Path

import numpy as np
import pytest

from gfedntm_tpu.data.synthetic import generate_synthetic_corpus as j_generate
from gfedntm_tpu.data.synthetic import load_reference_npz as j_load_reference_npz
from gfedntm_tpu.data.synthetic import save_reference_npz
from gfedntm_tpu.eval import monitor as jm
from gfedntm_tpu.federation.aggregation import contribution_stats as j_contribution_stats
from gfedntm_tpu_torch.data.loaders import RawCorpus
from gfedntm_tpu_torch.data.synthetic import load_reference_npz
from gfedntm_tpu_torch.data.vocab import Vocabulary
from gfedntm_tpu_torch.eval import monitor as tm
from gfedntm_tpu_torch.federated.aggregation import contribution_stats, weighted_mean
from gfedntm_tpu_torch.federation.client import Client
from gfedntm_tpu_torch.federation.device_agg import DeviceAggEngine, FlatPlane, stack_round
from gfedntm_tpu_torch.federation.server import FederatedServer, build_template_model
from gfedntm_tpu_torch.utils.observability import MetricRegistry, MetricsLogger

REPO = Path(__file__).resolve().parents[1]
MODEL_KWARGS = dict(n_components=3, hidden_sizes=(8, 8), batch_size=8, num_epochs=2, seed=0)
#: Three disjoint 8-word blocks, as in ``tests/test_quality_plane.py``:
#: block-pure topics are coherent, cross-block pairs never co-occur.
BLOCKS = [[f"b{b}w{i:02d}" for i in range(8)] for b in range(3)]
VOCAB = [w for block in BLOCKS for w in block]
ID2TOKEN = dict(enumerate(VOCAB))


def _block_docs(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(BLOCKS[i % 3], size=8)) for i in range(n)]


def _ref_corpus(n=60, seed=0):
    return [d.split() for d in _block_docs(n, seed)]


def _block_beta(noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    beta = np.full((3, 24), -2.0)
    for k in range(3):
        beta[k, 8 * k:8 * (k + 1)] = 2.0
    return beta + noise * rng.normal(size=beta.shape)


def _mixed_beta(seed=0):
    return np.random.default_rng(seed).normal(size=(3, 24))


def _body(path: Path, package: str, names=None) -> str:
    """The module's code (or its top-level ``names``) without docstrings,
    ``package`` imports renamed to the JAX package's."""
    tree = ast.parse(path.read_text().replace(f"{package}.", "gfedntm_tpu."))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    if names is not None:
        tree.body = [n for n in tree.body if getattr(n, "name", None) in names]
        assert len(tree.body) == len(names)
    return ast.dump(tree)


@pytest.mark.parametrize("module,names", [
    ("eval/monitor.py", None),
    ("data/synthetic.py", ("load_reference_npz", "_bow_from_wd_docs",
                           "generate_synthetic_corpus")),
])
def test_copies_are_the_originals(module, names):
    assert _body(REPO / "gfedntm_tpu_torch" / module, "gfedntm_tpu_torch", names) == _body(
        REPO / "gfedntm_tpu" / module, "gfedntm_tpu", names)


# ---- the monitor, bitwise ------------------------------------------------------

BETA_SEQUENCES = {
    "training": [_block_beta(noise=0.5 - 0.1 * r, seed=r) for r in range(5)],
    "collapse": [_block_beta(), _block_beta(noise=0.05), _mixed_beta(1), _mixed_beta(2),
                 _block_beta()],
    "permuted": [_block_beta(noise=0.1), _block_beta(noise=0.1)[[2, 0, 1]], _mixed_beta(3)],
}


@pytest.mark.parametrize("sequence", sorted(BETA_SEQUENCES))
@pytest.mark.parametrize("kw", [dict(match="hungarian"), dict(match="greedy", noise_floor=0.05),
                                dict(guard_patience=1, guard_drop=0.25, guard_floor=0.05)])
def test_monitor_records_are_the_jax_monitors(sequence, kw):
    logs = [MetricsLogger(keep_records=True) for _ in range(2)]
    mons = [mod.TopicQualityMonitor(every=1, id2token=ID2TOKEN, ref_tokens=_ref_corpus(),
                                    topn=6, history=3, metrics=log, **kw)
            for mod, log in zip((tm, jm), logs)]
    for r, beta in enumerate(BETA_SEQUENCES[sequence]):
        avg = {"params/beta": beta.astype(np.float32), "params/other": np.ones(2, np.float32)}
        records = [mon.observe(r, avg) for mon in mons]
        assert records[0] == records[1]
        assert mons[0].collapsed == mons[1].collapsed
        if mons[0].collapsed:
            for mon in mons:
                mon.note_rollback()
    assert mons[0].status() == mons[1].status()
    strip = [[{k: v for k, v in rec.items() if k != "time"} for rec in log.records]
             for log in logs]
    assert strip[0] == strip[1]
    assert logs[0].registry.snapshot() == logs[1].registry.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pieces_are_the_jax_ones(seed):
    rng = np.random.default_rng(seed)
    cur, prev = rng.normal(size=(7, 30)), rng.normal(size=(7, 30))
    id2token = {i: f"w{i}" for i in range(30)}
    assert tm.topics_from_beta(cur, id2token, 5) == jm.topics_from_beta(cur, id2token, 5)
    assert np.array_equal(tm.softmax_rows(cur), jm.softmax_rows(cur))
    p, q = tm.softmax_rows(cur), tm.softmax_rows(prev)
    assert np.array_equal(tm.js_divergence_rows(p, q), jm.js_divergence_rows(p, q))
    for method in ("hungarian", "greedy"):
        assert tm.match_topics(p, q, method) == jm.match_topics(p, q, method)
    assert tm.find_beta_key({"x/beta": 1, "params/w": 2}) == "x/beta"
    with pytest.raises(KeyError):
        tm.find_beta_key({"params/w": 1})


@pytest.mark.parametrize("alpha", [0.3, 1.0])
def test_tracker_is_the_jax_tracker(alpha):
    regs = [MetricRegistry(), MetricRegistry()]
    trackers = [mod.ContributionTracker(registry=reg, alpha=alpha) for mod, reg in zip((tm, jm),
                                                                                       regs)]
    rng = np.random.default_rng(0)
    glob = {"params/beta": rng.normal(size=(3, 12)).astype(np.float32)}
    for r in range(4):
        snaps = [{"params/beta": (glob["params/beta"]
                                  + rng.normal(0, 0.1 + c, (3, 12))).astype(np.float32)}
                 for c in range(3)]
        avg = weighted_mean([(1.0 + c, s) for c, s in enumerate(snaps)])
        stats = contribution_stats(snaps, glob, avg)
        want = j_contribution_stats(snaps, glob, avg)
        assert all(np.array_equal(a, b) for a, b in zip(stats, want))
        for tr in trackers:
            tr.observe_round(r, [1, 2, 3 + r % 2], *stats)
    trackers[0].forget(2)
    trackers[1].forget(2)
    assert trackers[0].status() == trackers[1].status()
    assert trackers[0].summary(top_k=2) == trackers[1].summary(top_k=2)
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].get("client_contribution_cos/client2") is None


def test_reference_corpora_are_the_jax_ones(tmp_path):
    corpus = j_generate(n_nodes=2, n_docs=5, n_topics=2, vocab_size=30, nwords=(6, 10), seed=0)
    npz = tmp_path / "ref.npz"
    save_reference_npz(corpus, str(npz), note="x")
    got, want = load_reference_npz(str(npz)), j_load_reference_npz(str(npz))
    assert np.array_equal(got.topic_vectors, want.topic_vectors)
    assert got.vocab_tokens == want.vocab_tokens
    for a, b in zip(got.nodes, want.nodes):
        assert np.array_equal(a.bow, b.bow) and a.documents == b.documents
        assert np.array_equal(a.doc_topics, b.doc_topics)
    text = tmp_path / "ref.txt"
    text.write_text("b0w00 b0w01\n\nb1w02 b1w03 B1W03\n")
    for path in (npz, text):
        assert tm.load_reference_corpus(str(path)) == jm.load_reference_corpus(str(path))
    (tmp_path / "empty.txt").write_text("\n")
    with pytest.raises(ValueError):
        tm.load_reference_corpus(str(tmp_path / "empty.txt"))


# ---- the server's quality step -------------------------------------------------

def _server(**kw):
    base = dict(min_clients=1, family="avitm", model_kwargs=MODEL_KWARGS,
                metrics=MetricsLogger(validate=True, keep_records=True), device="cpu")
    base.update(kw)
    return FederatedServer(**base)


def _snapshots(backend, pairs, current):
    if backend == "numpy":
        return pairs
    engine = DeviceAggEngine("cpu")
    return stack_round(engine, FlatPlane(current), pairs, current_global=current)


def test_quality_off_by_default_is_inert():
    server = _server()
    avg = {"params/beta": np.ones((3, 4), np.float32)}
    assert server._quality_step(0, [], avg) is avg
    assert server._status()["model_quality"] is None
    assert not server.metrics.events("quality_computed")
    assert server.metrics.registry.get("quality_npmi") is None
    with pytest.raises(ValueError):
        _server(quality_every=-1)


@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_contributions_measure_the_accepted_aggregate_not_the_rollback(backend):
    server = _server(quality_every=1)
    server.global_vocab = Vocabulary(tuple(VOCAB))
    zero = {"params/beta": np.zeros((3, 24), np.float32)}
    server.last_average = zero
    server._round_accepted = [(1, 1.0, 0.5)]
    up = np.ones((3, 24), np.float32)
    snapshots = _snapshots(backend, [(1.0, {"params/beta": up})], zero)
    accepted = {"params/beta": up.copy()}
    restored = {"params/beta": -up}
    server._quality_step(0, snapshots, restored, accepted)
    cos = server.metrics.registry.get("client_contribution_cos/client1").value
    assert cos == pytest.approx(1.0, abs=1e-9)
    assert server._status(full=True)["model_quality"]["contributions"]["clients"]["1"]["rounds"] == 1


@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_quality_step_on_both_backends(backend):
    """Three rounds of a three-client cohort: the monitor's records and the
    contribution EWMAs of either backend equal the JAX plane's on the same
    averages."""
    server = _server(quality_every=1, quality_topn=6)
    server.global_vocab = Vocabulary(tuple(VOCAB))
    server.quality_ref = None
    mon = server._ensure_quality_monitor()
    mon.ref_tokens = _ref_corpus()
    jmon = jm.TopicQualityMonitor(every=1, id2token=ID2TOKEN, ref_tokens=_ref_corpus(), topn=6)
    jtr = jm.ContributionTracker()
    rng = np.random.default_rng(4)
    current = {"params/beta": _block_beta(noise=0.3).astype(np.float32)}
    for r in range(3):
        server.last_average = current
        snaps = [{"params/beta": (current["params/beta"] + rng.normal(0, 0.2, (3, 24)))
                  .astype(np.float32)} for _ in range(3)]
        pairs = [(2.0 + c, s) for c, s in enumerate(snaps)]
        avg = weighted_mean(pairs)
        server._round_accepted = [(c + 1, w, 1.0) for c, (w, _s) in enumerate(pairs)]
        assert server._quality_step(r, _snapshots(backend, pairs, current), avg) is avg
        want = jmon.observe(r, avg)
        jtr.observe_round(r, [1, 2, 3], *j_contribution_stats(snaps, current, avg))
        assert server.metrics.events("quality_computed")[-1]["npmi"] == want["npmi"]
        current = avg
    assert mon.status() == jmon.status()
    got, ref = server.contributions.status(), jtr.status()
    for cid in ("1", "2", "3"):
        for field in ("cos_ewma", "share_ewma"):
            assert got["clients"][cid][field] == pytest.approx(ref["clients"][cid][field],
                                                               abs=1e-12 if backend == "numpy"
                                                               else 1e-6)
    assert server.metrics.registry.counter("quality_errors").value == 0


def test_guard_without_checkpoint_keeps_firing():
    server = _server(checkpoint_every=0, divergence_patience=0, quality_every=1,
                     quality_guard=True,
                     quality_monitor_kwargs=dict(guard_patience=1, guard_drop=0.25,
                                                 guard_floor=0.05))
    server.global_vocab = Vocabulary(tuple(VOCAB))
    mon = server._ensure_quality_monitor()
    mon.ref_tokens = _ref_corpus()
    server._round_accepted = []
    good = {"params/beta": _block_beta().astype(np.float32)}
    bad = {"params/beta": _mixed_beta().astype(np.float32)}
    server._quality_step(0, [], good)
    assert server._quality_step(1, [], bad) is bad
    assert mon.collapsed
    server._quality_step(2, [], bad)
    assert mon.collapsed


@pytest.mark.parametrize("dp", ["off", "server"])
def test_guard_noise_floor_under_dp(dp):
    kw = dict(dp_sigma=1.0) if dp != "off" else {}
    server = _server(quality_every=1, dp=dp, **kw)
    server.global_vocab = Vocabulary(tuple(VOCAB))
    assert server._ensure_quality_monitor().noise_floor == (0.05 if dp != "off" else 0.0)


def test_unreadable_reference_degrades_loudly(tmp_path):
    server = _server(quality_every=1, quality_ref=str(tmp_path / "missing.txt"))
    server.global_vocab = Vocabulary(tuple(VOCAB))
    server._round_accepted = [(1, 1.0, 0.5)]
    avg = {"params/beta": _block_beta().astype(np.float32)}
    server.last_average = avg
    assert server._quality_step(0, [(1.0, dict(avg))], avg) is avg
    assert server.metrics.registry.get("quality_errors").value >= 1
    server._quality_step(1, [(1.0, dict(avg))], avg)
    assert server.metrics.events("quality_computed")[0]["npmi"] is None


@pytest.mark.parametrize("wire_codec", ["delta", "delta+topk:0.25"])
def test_coherence_collapse_rolls_back_and_orders_codec_resets(tmp_path, wire_codec):
    """A collapsed coherence with a checkpoint to return to: the quality
    step returns the checkpointed average, the rollback is the
    ``coherence_collapse`` one, and the next push orders every recipient's
    codec session reset with a self-contained bundle."""
    server = _server(save_dir=str(tmp_path), wire_codec=wire_codec, divergence_patience=0,
                     quality_every=1, quality_guard=True,
                     quality_monitor_kwargs=dict(guard_patience=1, guard_drop=0.25,
                                                 guard_floor=0.05))
    server.global_vocab = Vocabulary(tuple(VOCAB))
    server.template = build_template_model("avitm", len(VOCAB), MODEL_KWARGS, device="cpu")
    shared = server._shared_template()
    good = dict(shared, **{"params/beta": _block_beta().astype(np.float32)})
    bad = dict(shared, **{"params/beta": _mixed_beta().astype(np.float32)})
    server.last_average, server.global_iterations = good, 1
    server._save_round_checkpoint()
    mon = server._ensure_quality_monitor()
    mon.ref_tokens = _ref_corpus()
    server._round_accepted = []
    assert server._quality_step(0, [], good) is good
    # The push chain holds a round before the collapse.
    replies = [(type("Rec", (), {"client_id": c})(), None) for c in (1, 2)]
    server._encode_push(good, 0, replies)
    restored = server._quality_step(1, [], bad)
    assert restored is not bad and np.array_equal(restored["params/beta"], good["params/beta"])
    (event,) = server.metrics.events("divergence_rollback")
    assert event["reason"] == tm.COHERENCE_COLLAPSE and event["restored_round"] == 1
    assert not mon.collapsed  # re-anchored on the restored state
    aggs = server._encode_push(restored, 1, replies)
    assert all(aggs[c].reset_session for c in (1, 2))
    assert server._status()["data_plane"]["divergence_rollbacks"] == 1


# ---- a federation with the plane on ---------------------------------------------

def _federation(tmp_path, backend):
    corpora = [RawCorpus(documents=_block_docs(24, s)) for s in range(2)]
    tmp_path.mkdir()
    ref = tmp_path / "ref.txt"
    ref.write_text("\n".join(d for c in corpora for d in c.documents) + "\n")
    server = FederatedServer(min_clients=2, family="avitm", model_kwargs=MODEL_KWARGS,
                             max_iters=40, save_dir=str(tmp_path / "server"),
                             metrics=MetricsLogger(keep_records=True), device="cpu",
                             aggregation_backend=backend, quality_every=1,
                             quality_ref=str(ref), quality_topn=6)
    betas = []
    step = server._quality_step

    def keep(iteration, snapshots, average, accepted_average=None):
        betas.append(np.array(average["params/beta"], copy=True))
        return step(iteration, snapshots, average, accepted_average)

    server._quality_step = keep
    addr = server.start("[::]:0")
    clients = [Client(client_id=c + 1, corpus=corpus, server_address=addr, max_features=45,
                      device="cpu") for c, corpus in enumerate(corpora)]
    threads = [threading.Thread(target=cl.run, daemon=True) for cl in clients]
    try:
        for t in threads:
            t.start()
        assert server.wait_done(timeout=120.0)
        for t in threads:
            t.join(timeout=30.0)
    finally:
        server.stop(grace=0.2, join_timeout=10.0)
        for cl in clients:
            cl.shutdown(grace=0.2)
    return server, betas, str(ref)


def test_federation_quality_series_on_both_backends_match_the_jax_monitor(tmp_path):
    runs = {b: _federation(tmp_path / b, b) for b in ("numpy", "device")}
    series = {b: [(r["round"], r["npmi"], r["diversity"], r["irbo"])
                  for r in s.metrics.events("quality_computed")]
              for b, (s, _betas, _ref) in runs.items()}
    server, betas, ref = runs["numpy"]
    assert len(series["numpy"]) == server.global_iterations == len(betas) > 2
    # The device backend's mean is numpy's, bit for bit: the same run.
    assert series["device"] == series["numpy"]
    for b in runs:
        assert runs[b][0].metrics.registry.counter("quality_errors").value == 0
    # The JAX monitor on the same betas gives the port's NPMI series.
    jmon = jm.TopicQualityMonitor(every=1, id2token=server.global_vocab.id2token,
                                  ref_tokens=jm.load_reference_corpus(ref), topn=6)
    assert [jmon.observe(r, {"params/beta": beta})["npmi"] for r, beta in enumerate(betas)] \
        == [npmi for _r, npmi, _d, _i in series["numpy"]]
    contrib = server._status(full=True)["model_quality"]["contributions"]
    assert set(contrib["clients"]) == {"1", "2"}
    # The journal carries the quality verdict of its round.
    assert server._state_extra()["quality"]["flagged"] is False
