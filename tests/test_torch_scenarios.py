"""The scenario matrix in the port, on the CPU, held to the JAX package's
(the twin of ``tests/test_scenarios.py``).

- Bitwise: ``dominant_topics`` and ``apply_vocabulary_skew`` on seeded
  corpora; ``build_corpora`` (documents, and the embeddings of ctm cells)
  for every cell of ``default_matrix()`` and its ``shrink()``; the persona
  parsers and ``fault_specs_for`` for every cell, refusals included; the
  copied definitions of ``personas.py``, ``contracts.py`` and ``runner.py``
  are the originals' sources but for their imports and docstrings.
- Equal values: ``default_matrix()`` field for field, ``baseline_of`` and
  ``policy_key``; ``evaluate_contracts`` on ``TestContracts``' evidence;
  ``collect_cell_evidence`` on the JSONL streams of one JAX fast-cell run;
  ``cell_bench_row`` and ``emit_artifact`` (but ``generated_by``).
- End to end: ``iid-sync-fedavg``'s fast cell through the port's
  ``run_cell`` on the CPU (contracts, lifecycle events, schema row, a rerun
  into the same workdir), and against the JAX run of the same cell: the
  same contract names, all green, the same rounds (sync pacing makes them a
  function of the schedule), and the final NPMI within the cell's
  ``npmi_tol`` of the JAX run's (the two packages draw their initial
  states from different generators).
- The command line: ``--list`` byte for byte the JAX subcommand's, the same
  unknown-cell exit, one fast cell written to a valid artifact, and the
  refusal without CUDA.
- Slow-marked, as in the JAX file: the ctm-cohort and crash-persona cells.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import io
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gfedntm_tpu import cli as jcli
from gfedntm_tpu import scenarios as jsc
from gfedntm_tpu.data import synthetic as jsyn
from gfedntm_tpu.scenarios import contracts as jcontracts
from gfedntm_tpu.scenarios import personas as jpersonas
from gfedntm_tpu.utils.observability import MetricsLogger as JMetricsLogger
from gfedntm_tpu.utils.observability import read_metrics as jread_metrics
from gfedntm_tpu_torch import cli
from gfedntm_tpu_torch import scenarios as tsc
from gfedntm_tpu_torch.data import synthetic as tsyn
from gfedntm_tpu_torch.scenarios import contracts as tcontracts
from gfedntm_tpu_torch.scenarios import personas as tpersonas
from gfedntm_tpu_torch.utils.observability import MetricsLogger

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import bench_schema  # noqa: E402

CELLS = [c.name for c in jsc.default_matrix()]


def _jcell(cell):
    """The JAX package's twin of a port ``ScenarioCell``."""
    return jsc.ScenarioCell(**dataclasses.asdict(cell))


def _tcell(cell):
    return tsc.ScenarioCell(**dataclasses.asdict(cell))


def _by_name(module, name, fast):
    cell = {c.name: c for c in module.default_matrix()}[name]
    return cell.shrink() if fast else cell


def _e2e_cell(module):
    """``test_cell_e2e_fast_iid_sync``'s cell: the fast twin, one epoch of
    36 documents."""
    return dataclasses.replace(_by_name(module, "iid-sync-fedavg", True), num_epochs=1,
                               total_docs=36)


# ---------------------------------------------------------------------------
# copies: the port's definitions are the originals'
# ---------------------------------------------------------------------------

def _strip(tree):
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return tree


def _defs(path: Path, package: str) -> dict:
    """Top-level statements of a module by name (``package`` renamed to the
    JAX package's, docstrings stripped), as AST dumps."""
    tree = _strip(ast.parse(path.read_text().replace(f"{package}.", "gfedntm_tpu.")))
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out[ast.unparse(targets[0])] = ast.dump(node)
    return out


@pytest.mark.parametrize("module", ["personas", "contracts"])
def test_module_copies_are_the_originals(module):
    port = _strip(ast.parse((REPO / f"gfedntm_tpu_torch/scenarios/{module}.py").read_text()
                            .replace("gfedntm_tpu_torch.", "gfedntm_tpu.")))
    jax_ = _strip(ast.parse((REPO / f"gfedntm_tpu/scenarios/{module}.py").read_text()))
    assert ast.dump(port) == ast.dump(jax_)


RUNNER_COPIES = ("N_RELAYS", "RELAY_ID_BASE", "__all__", "_LOG", "default_matrix",
                 "baseline_of", "CellResult", "_free_port", "_model_kwargs",
                 "_server_kwargs", "_await_round", "collect_cell_evidence", "_bench_schema",
                 "cell_bench_row")


@pytest.mark.parametrize("name", RUNNER_COPIES)
def test_runner_copies_are_the_originals(name):
    port = _defs(REPO / "gfedntm_tpu_torch/scenarios/runner.py", "gfedntm_tpu_torch")
    jax_ = _defs(REPO / "gfedntm_tpu/scenarios/runner.py", "gfedntm_tpu")
    assert port[name] == jax_[name]


def test_synthetic_helpers_are_the_originals():
    port = _defs(REPO / "gfedntm_tpu_torch/data/synthetic.py", "gfedntm_tpu_torch")
    jax_ = _defs(REPO / "gfedntm_tpu/data/synthetic.py", "gfedntm_tpu")
    for name in ("dominant_topics", "apply_vocabulary_skew"):
        assert port[name] == jax_[name], name


def test_package_exports_are_the_jax_ones():
    assert tsc.__all__ == jsc.__all__
    for name in tsc.__all__:
        assert hasattr(tsc, name), name


# ---------------------------------------------------------------------------
# bitwise: the data helpers and the corpora of every cell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_dominant_topics_are_the_jax_ones(seed):
    kw = dict(vocab_size=50, n_topics=4, n_docs=30, n_nodes=1, frozen_topics=4, seed=seed,
              materialize_docs=False)
    t = tsyn.dominant_topics(tsyn.generate_synthetic_corpus(**kw).nodes[0])
    j = jsyn.dominant_topics(jsyn.generate_synthetic_corpus(**kw).nodes[0])
    assert t.dtype == j.dtype and t.shape == (30,)
    assert np.array_equal(t, j)


SKEW_DOCS = ["wd1 wd2 wd3 wd1", "wd2 wd4", "wd1 wd5 wd5"]


@pytest.mark.parametrize("client_id,frac,seed", [(1, 0.0, 0), (2, 1.0, 0), (1, 0.5, 3),
                                                 (9, 0.5, 3), (3, 0.6, 11)])
def test_vocabulary_skew_is_the_jax_ones(client_id, frac, seed):
    corpus = jsyn.generate_synthetic_corpus(vocab_size=60, n_topics=4, n_docs=20, n_nodes=1,
                                            frozen_topics=4, seed=seed)
    for docs in (SKEW_DOCS, corpus.nodes[0].documents):
        assert (tsyn.apply_vocabulary_skew(docs, client_id, frac, seed=seed)
                == jsyn.apply_vocabulary_skew(docs, client_id, frac, seed=seed))


@pytest.mark.parametrize("frac", [1.5, -0.1])
def test_vocabulary_skew_refuses_as_jax(frac):
    with pytest.raises(ValueError) as t_err:
        tsyn.apply_vocabulary_skew(SKEW_DOCS, 1, frac)
    with pytest.raises(ValueError) as j_err:
        jsyn.apply_vocabulary_skew(SKEW_DOCS, 1, frac)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("fast", [False, True], ids=["full", "shrink"])
@pytest.mark.parametrize("name", CELLS)
def test_build_corpora_is_the_jax_ones(name, fast):
    tcell, jcell = _by_name(tsc, name, fast), _by_name(jsc, name, fast)
    t_corpora, t_ref = tsc.build_corpora(tcell)
    j_corpora, j_ref = jsc.build_corpora(jcell)
    assert t_ref == j_ref
    assert len(t_corpora) == len(j_corpora) == tcell.n_clients
    for t, j in zip(t_corpora, j_corpora):
        assert t.documents == j.documents
        assert (t.embeddings is None) == (j.embeddings is None) == (tcell.workload != "ctm")
        if t.embeddings is not None:
            assert t.embeddings.dtype == j.embeddings.dtype
            assert np.array_equal(t.embeddings, j.embeddings)
        assert t.labels is None and j.labels is None


@pytest.mark.parametrize("name", CELLS)
def test_personas_and_fault_specs_are_the_jax_ones(name):
    tcell, jcell = _by_name(tsc, name, False), _by_name(jsc, name, False)
    assert (dataclasses.asdict(tpersonas.parse_data_persona(tcell.data))
            == dataclasses.asdict(jpersonas.parse_data_persona(jcell.data)))
    tf, jf = tpersonas.parse_fault_persona(tcell.fault), jpersonas.parse_fault_persona(jcell.fault)
    assert dataclasses.asdict(tf) == dataclasses.asdict(jf)
    assert tf.crash_round == jf.crash_round
    for n in (3, tcell.n_clients):
        assert tsc.fault_specs_for(tf, n) == jsc.fault_specs_for(jf, n)
    assert tcontracts.quorum_floor(tcell) == jcontracts.quorum_floor(jcell)


@pytest.mark.parametrize("parser,spec", [
    ("parse_data_persona", s) for s in ("dirchlet:0.1", "dirichlet:0", "imbalance:0.5",
                                        "vocabskew:2", "dirichlet:x", "dirichlet")
] + [
    ("parse_fault_persona", s) for s in ("crashy:1", "crash", "crash:0", "crash:1.5", "slow:-1",
                                         "flap:2.5")
])
def test_persona_refusals_are_the_jax_ones(parser, spec):
    with pytest.raises(ValueError) as t_err:
        getattr(tpersonas, parser)(spec)
    with pytest.raises(ValueError) as j_err:
        getattr(jpersonas, parser)(spec)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("kw", [dict(workload="lda"), dict(data="dirchlet:1"),
                                dict(fault="crashy:1"), dict(dp="server"),
                                dict(slo=({"name": "x"},))])
def test_cell_refusals_are_the_jax_ones(kw):
    with pytest.raises((ValueError, TypeError, KeyError)) as t_err:
        tsc.ScenarioCell("x", **kw)
    with pytest.raises((ValueError, TypeError, KeyError)) as j_err:
        jsc.ScenarioCell("x", **kw)
    assert type(t_err.value) is type(j_err.value)
    assert str(t_err.value) == str(j_err.value)


# ---------------------------------------------------------------------------
# equal values: the matrix, its twins, the contracts, the evidence
# ---------------------------------------------------------------------------

def test_default_matrix_is_the_jax_one_field_for_field():
    t, j = tsc.default_matrix(), jsc.default_matrix()
    assert [dataclasses.asdict(c) for c in t] == [dataclasses.asdict(c) for c in j]
    for tc, jc in zip(t, j):
        assert tc.policy_key() == jc.policy_key()
        assert dataclasses.asdict(tc.shrink()) == dataclasses.asdict(jc.shrink())
        tb, jb = tsc.baseline_of(tc), jsc.baseline_of(jc)
        assert (tb is None) == (jb is None)
        if tb is not None:
            assert dataclasses.asdict(tb) == dataclasses.asdict(jb)
            assert tb.policy_key() == tc.policy_key()
            assert tsc.baseline_of(tb) is None


def _evidence(**over):
    """``tests/test_scenarios.py``'s evidence."""
    base = dict(
        finished=True,
        betas_finite=True,
        rounds=8,
        averaged_push_clients=[3, 3, 2, 2, 1],
        quorum_skips=1,
        counters={"codec_ref_miss": 0.0, "rpcs_deduplicated": 0.0},
        npmi_final=-0.30,
        quality_rounds=8,
        recovery=None,
    )
    base.update(over)
    return base


CELL_KW = dict(quorum_fraction=0.5, npmi_tol=0.1)
CONTRACT_CASES = {
    "all green": (CELL_KW, _evidence(), None),
    "unfinished": (CELL_KW, _evidence(finished=False), None),
    "non-finite": (CELL_KW, _evidence(betas_finite=False), None),
    "degenerate quorum": (CELL_KW, _evidence(averaged_push_clients=[1, 1, 1, 3]), None),
    "no averaged round": (CELL_KW, _evidence(averaged_push_clients=[]), None),
    "counter drift": (CELL_KW, _evidence(counters={"codec_ref_miss": 2.0,
                                                   "rpcs_deduplicated": 0.0}), _evidence()),
    "npmi outside": (CELL_KW, _evidence(npmi_final=-0.40), _evidence(npmi_final=-0.25)),
    "npmi inside": (CELL_KW, _evidence(npmi_final=-0.30), _evidence(npmi_final=-0.25)),
    "npmi missing": (CELL_KW, _evidence(npmi_final=None), None),
    "crash recovered": (dict(fault="crash:3"), _evidence(recovery={
        "recovered": True, "resumed_round": 3, "killed_round": 3}), None),
    "crash no recovery": (dict(fault="crash:3"), _evidence(recovery=None), None),
    "crash not recovered": (dict(fault="crash:3"), _evidence(recovery={
        "recovered": False, "resumed_round": None, "killed_round": 3}), None),
    "crash resumed early": (dict(fault="crash:3"), _evidence(recovery={
        "recovered": True, "resumed_round": 1, "killed_round": 4}), None),
    "relaycrash": (dict(fault="relaycrash:3", n_clients=4), _evidence(
        recovery={"recovered": True, "resumed_round": 1, "killed_round": 3},
        relay_recovered_events=1), None),
    "relayloss": (dict(fault="relayloss:2", n_clients=4),
                  _evidence(member_rehomed_events=0), None),
    "slo fired": (dict(slo=({"name": "r", "metric": "recovery_time_s", "agg": "value",
                             "op": "<=", "threshold": 1.0},)),
                  _evidence(slo={"fired": ["r"], "alerts": []}), None),
    "dp ledger fell": (dict(dp="server", dp_sigma=0.5),
                       _evidence(privacy_eps=[0.1, 0.3, 0.2]), None),
    "dp ledger grows": (dict(dp="server", dp_sigma=0.5),
                        _evidence(privacy_eps=[0.1, 0.2, 0.3]), None),
}


@pytest.mark.parametrize("case", sorted(CONTRACT_CASES))
def test_contracts_are_the_jax_ones(case):
    cell_kw, evidence, baseline = CONTRACT_CASES[case]
    t = tsc.evaluate_contracts(tsc.ScenarioCell("t", **cell_kw), evidence, baseline)
    j = jsc.evaluate_contracts(jsc.ScenarioCell("t", **cell_kw), evidence, baseline)
    assert t == j
    green = ("all green", "npmi inside", "crash recovered", "relaycrash", "dp ledger grows")
    assert all(v["ok"] for v in t.values()) == (case in green)


def test_collect_evidence_on_hand_made_streams_is_the_jax_ones():
    """``TestCollectEvidence``'s records, with a second snapshot."""
    t0 = 1000.0
    server = [
        {"event": "span", "time": t0, "node": "server", "name": "push", "span_id": "a",
         "parent_id": None, "seconds": 0.1, "clients": 3},
        {"event": "span", "time": t0, "node": "server", "name": "poll", "span_id": "c",
         "parent_id": None, "seconds": 0.1, "clients": 9},
        {"event": "quorum_skip", "time": t0, "node": "server", "round": 2, "got": 1,
         "needed": 2},
        {"event": "quality_computed", "time": t0, "node": "server", "round": 1,
         "npmi": -0.4, "diversity": 0.8},
        {"event": "server_recovered", "time": t0, "node": "server", "round": 2,
         "source": "journal"},
        {"event": "privacy_budget", "time": t0, "node": "server", "eps": 0.5},
        {"event": "metrics_snapshot", "time": t0, "node": "server", "metrics": {
            "codec_ref_miss": {"type": "counter", "value": 1.0}}},
        {"event": "metrics_snapshot", "time": t0 + 1, "node": "server", "metrics": {
            "codec_ref_miss": {"type": "counter", "value": 4.0}}},
    ]
    client = [{"event": "metrics_snapshot", "time": t0, "node": "client1", "metrics": {
        "rpcs_deduplicated": {"type": "counter", "value": 2.0}}}]
    kw = dict(finished=True, betas_finite=True, rounds=4,
              recovery={"recovered": True, "resumed_round": 2, "killed_round": 2})
    assert (tsc.collect_cell_evidence([server, client], **kw)
            == jsc.collect_cell_evidence([server, client], **kw))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX fast-cell run: its result, its lifecycle events and its
    per-node streams."""
    root = tmp_path_factory.mktemp("jax_cell")
    metrics = JMetricsLogger(str(root / "harness.jsonl"), node="scenarios", validate=True,
                             keep_records=True)
    cell = _e2e_cell(jsc)
    res = jsc.run_cell(cell, str(root / cell.name), metrics=metrics)
    metrics.close()
    return res, metrics


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The same cell through the port's ``run_cell`` on the CPU, then rerun
    into the same workdir."""
    root = tmp_path_factory.mktemp("port_cell")
    metrics = MetricsLogger(str(root / "harness.jsonl"), node="scenarios", validate=True,
                            keep_records=True)
    cell = _e2e_cell(tsc)
    res = tsc.run_cell(cell, str(root / cell.name), metrics=metrics, device="cpu")
    metrics.close()
    rerun = tsc.run_cell(cell, str(root / cell.name), device="cpu")
    return res, metrics, rerun


def _streams(workdir: str) -> list:
    """A cell's node streams in the runner's order: server, clients."""
    paths = [os.path.join(workdir, "server", "metrics.jsonl")] + sorted(
        os.path.join(workdir, d, "metrics.jsonl") for d in os.listdir(workdir)
        if d.startswith("client"))
    return [jread_metrics(p) for p in paths]


def test_collect_evidence_on_a_jax_cell_is_the_jax_ones(jax_run):
    res, _metrics = jax_run
    streams = _streams(res.workdir)
    assert len(streams) == 1 + res.cell.n_clients and all(streams)
    kw = dict(finished=True, betas_finite=True, rounds=res.evidence["rounds"])
    t = tsc.collect_cell_evidence(streams, **kw)
    assert t == jsc.collect_cell_evidence(streams, **kw)
    assert t["averaged_push_clients"] == res.evidence["averaged_push_clients"]
    assert t["npmi_final"] == res.evidence["npmi_final"]
    assert t["counters"] == res.evidence["counters"]


def _twin_results(res):
    """A port ``CellResult`` and its JAX twin with the same fields."""
    fields = dict(ok=res.ok, contracts=res.contracts, evidence=res.evidence,
                  baseline_name=res.baseline_name, seconds=res.seconds, workdir=res.workdir)
    return (tsc.CellResult(cell=_tcell(res.cell), **fields),
            jsc.CellResult(cell=_jcell(res.cell), **fields))


def test_bench_row_and_artifact_are_the_jax_ones(port_run):
    res, _metrics, _rerun = port_run
    crashed = dataclasses.replace(res, cell=_tcell(_by_name(tsc, "dir01-crash-cohort", True)),
                                  baseline_name="dir01-cohort-delta")
    pairs = [_twin_results(r) for r in (res, crashed)]
    for t, j in pairs:
        assert tsc.cell_bench_row(t) == jsc.cell_bench_row(j)
    t_art = tsc.emit_artifact([t for t, _j in pairs], rev="r07")
    j_art = jsc.emit_artifact([j for _t, j in pairs], rev="r07")
    assert t_art.pop("generated_by") == (
        "python -m gfedntm_tpu_torch scenarios --out BENCH_SCENARIO_rNN.json")
    j_art.pop("generated_by")
    assert t_art == j_art
    assert t_art["acceptance"]["headline_cell"] == "dir01-crash-cohort"
    assert bench_schema.validate(tsc.emit_artifact([pairs[0][0]]), "scenario_bench") == []


# ---------------------------------------------------------------------------
# end to end (a real in-process federation over gRPC, on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_cell_e2e_fast_iid_sync(port_run):
    """One fast cell end to end through the port: every contract green, the
    lifecycle events on the harness stream, the bench row valid, and a
    rerun into the same workdir covering that run alone."""
    res, metrics, rerun = port_run
    assert res.ok, res.contracts
    assert res.evidence["npmi_final"] is not None
    assert res.evidence["quality_rounds"] >= 1
    assert bench_schema.validate(tsc.cell_bench_row(res), "scenario") == []
    started = metrics.events("scenario_cell_started")
    finished = metrics.events("scenario_cell_finished")
    contracts = metrics.events("scenario_contract")
    assert len(started) == 1 and len(finished) == 1
    assert finished[0]["ok"] is True
    assert {c["contract"] for c in contracts} == set(res.contracts)
    assert rerun.ok, rerun.contracts
    assert len(rerun.evidence["averaged_push_clients"]) == len(
        res.evidence["averaged_push_clients"])


@pytest.mark.chaos
def test_fast_iid_sync_against_the_jax_run(port_run, jax_run):
    """The port's run of the cell against the JAX package's: the same
    contracts, all green, the same lifecycle events, the same rounds and
    contributors per round, the same counters, and the final NPMI within
    the cell's ``npmi_tol``."""
    res, metrics, _rerun = port_run
    jres, jmetrics = jax_run
    assert jres.ok, jres.contracts
    assert set(res.contracts) == set(jres.contracts)
    assert all(v["ok"] for v in res.contracts.values())
    assert ([(e["contract"], e["ok"]) for e in metrics.events("scenario_contract")]
            == [(e["contract"], e["ok"]) for e in jmetrics.events("scenario_contract")])
    for key in ("rounds", "averaged_push_clients", "quorum_skips", "counters",
                "quality_rounds", "recovery", "finished", "betas_finite"):
        assert res.evidence[key] == jres.evidence[key], key
    delta = abs(res.evidence["npmi_final"] - jres.evidence["npmi_final"])
    assert delta <= res.cell.npmi_tol, (res.evidence["npmi_final"], jres.evidence["npmi_final"])


def _run_named_cell(name, tmp_path):
    return tsc.run_cell(_by_name(tsc, name, True), str(tmp_path / name), device="cpu")


@pytest.mark.slow
@pytest.mark.chaos
def test_cell_e2e_ctm_cohort_quality(tmp_path):
    """CTM as a federated scenario under cohort pacing with the quality
    plane on: finite betas and a rendered quality report."""
    from gfedntm_tpu_torch.utils.observability import (
        format_quality_report,
        read_metrics,
        summarize_model_quality,
    )

    res = _run_named_cell("ctm-dir01-cohort", tmp_path)
    assert res.ok, res.contracts
    assert res.evidence["betas_finite"]
    records = read_metrics(os.path.join(res.workdir, "server", "metrics.jsonl"))
    summary = summarize_model_quality(records)
    assert summary["quality"], "no quality rounds recorded"
    report = format_quality_report(summary)
    assert "npmi" in report.lower() or "coherence" in report.lower()


@pytest.mark.slow
@pytest.mark.chaos
def test_cell_e2e_crash_persona_autorecovers(tmp_path):
    """The crash persona inside the port's engine: a mid-run server kill, a
    replacement that autorecovers from the journal, clients riding their
    session tokens, every contract green, recovery included."""
    res = _run_named_cell("iid-crash-sync", tmp_path)
    assert res.ok, res.contracts
    rec = res.evidence["recovery"]
    assert rec["recovered"] and rec["source"] == "journal"
    assert res.evidence["server_recovered_events"] >= 1
    assert res.evidence["counters"]["codec_ref_miss"] == 0.0


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def test_scenarios_cli_list_is_the_jax_ones():
    t, j = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(t):
        assert cli.main(["scenarios", "--list"]) == 0
    with contextlib.redirect_stdout(j):
        assert jcli.run_scenarios(["--list"]) == 0
    assert t.getvalue() == j.getvalue()
    assert "dir01-crash-cohort" in t.getvalue()


def test_scenarios_cli_unknown_cell_is_the_jax_exit(tmp_path):
    argv = ["--cells", "no-such-cell,iid-sync-fedavg", "--workdir", str(tmp_path)]
    with pytest.raises(SystemExit, match="unknown cell") as t_err:
        cli.run_scenarios(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as j_err:
        jcli.run_scenarios(argv)
    assert str(t_err.value) == str(j_err.value)


def test_scenarios_cli_refuses_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device: CUDA is not available"):
        cli.run_scenarios(["--cells", "iid-sync-fedavg", "--fast", "--workdir",
                           str(tmp_path)])
    assert not (tmp_path / "iid-sync-fedavg").exists()


@pytest.mark.chaos
def test_scenarios_cli_fast_cell_writes_a_valid_artifact(tmp_path, capsys):
    out = tmp_path / "art" / "BENCH_SCENARIO_r99.json"
    code = cli.main(["scenarios", "--cells", "iid-sync-fedavg", "--fast", "--device", "cpu",
                     "--workdir", str(tmp_path / "work"), "--out", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert code == 0, lines
    row = json.loads(lines[0])
    assert row["cell"] == "iid-sync-fedavg" and row["ok"] is True
    assert bench_schema.validate(row, "scenario") == []
    assert lines[-1] == f"wrote {out}: 1 cells, all_contracts_green=True"
    artifact = json.loads(out.read_text())
    assert bench_schema.validate(artifact, "scenario_bench") == []
    assert artifact["rev"] == "r99"
    assert artifact["generated_by"].startswith("python -m gfedntm_tpu_torch scenarios")
    harness = [json.loads(line)["event"]
               for line in (tmp_path / "work" / "metrics.jsonl").read_text().splitlines()]
    assert harness.count("scenario_cell_started") == harness.count(
        "scenario_cell_finished") == 1
