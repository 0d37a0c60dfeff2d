"""Scenario runner: drive one cell's real federation, collect evidence
from its JSONL telemetry, assert contracts, and emit bench lines.

The counterpart of ``gfedntm_tpu/scenarios/runner.py`` over the port's
nodes. ``run_cell`` builds the same servers, relays and clients with the
same keywords, and one more, ``device``, which every node of the cell
takes (``None`` is the GPU, and a host without CUDA raises). The rest of
the module is a copy; the artifact's ``generated_by`` names the port's
command line.

Every cell runs the REAL in-process federation — a
:class:`~gfedntm_tpu_torch.federation.server.FederatedServer` plus N
:class:`~gfedntm_tpu_torch.federation.client.Client` threads over real gRPC
sockets on localhost (the chaos-harness regime), with the quality
plane on (``quality_every=1`` against the cell's reference corpus) so
per-round NPMI/diversity/drift land in the stream. The crash persona
is the in-process SIGKILL-equivalent: ``server.abort()`` mid-round, then a
REPLACEMENT server constructed with the same knobs auto-recovers from
the round journal with zero flags while the clients ride their durable
session tokens through reconnect.

Cell evidence is collected by reading the JSONL streams back
(:func:`collect_cell_evidence`), not from live object state — the same
records ``summarize``/``report`` consume, which is what makes the
BENCH_SCENARIO artifact reproducible from JSONL alone.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
from dataclasses import dataclass, replace
from typing import Any

import numpy as np

from gfedntm_tpu_torch.scenarios.contracts import CLEAN_COUNTERS, evaluate_contracts
from gfedntm_tpu_torch.scenarios.personas import (
    RELAY_KINDS,
    ScenarioCell,
    build_corpora,
    fault_specs_for,
)

#: Hierarchical cells (relaycrash/relayloss personas): how many relays
#: the root terminates, and the relay-id base — DISJOINT from member ids
#: (members keep 1..N upstream ids; a re-homed member presenting id 1 to
#: a root that knows relay 1 would otherwise corrupt the relay's
#: registration — the README trust note).
N_RELAYS = 2
RELAY_ID_BASE = 100

__all__ = [
    "CellResult",
    "baseline_of",
    "collect_cell_evidence",
    "default_matrix",
    "emit_artifact",
    "run_cell",
    "run_matrix",
]

_LOG = logging.getLogger("scenarios")


# ---- the default matrix -----------------------------------------------------

def default_matrix() -> list[ScenarioCell]:
    """The shipped scenario matrix (README "Scenario matrix"): every
    fault persona composed with non-IID data and a spread of policy
    axes, plus the no-fault twins the degradation contracts compare
    against. The headline cell — ``dir01-crash-cohort`` — composes
    Dirichlet-α non-IID data, a mid-run server kill, and cohort pacing
    over the delta wire codec."""
    D = "dirichlet:0.1"
    return [
        # -- no-fault cells (each is its own baseline) --------------------
        ScenarioCell("iid-sync-fedavg"),
        ScenarioCell("dir01-sync-fedavg", data=D),
        ScenarioCell("dir01-sync-fedadam", data=D, aggregator="fedadam"),
        ScenarioCell("dir01-cohort-fedyogi", data=D, pacing="cohort:2",
                     aggregator="fedyogi"),
        ScenarioCell("vocabskew-sync-median", data="vocabskew:0.5",
                     robust="median"),
        ScenarioCell("imbalance20-cohort-fedavg", data="imbalance:20",
                     pacing="cohort:2", total_docs=160),
        ScenarioCell("dir01-imbalance100-sync",
                     data="dirichlet:0.1+imbalance:100", total_docs=200),
        ScenarioCell("ctm-iid-sync", workload="ctm", num_epochs=2),
        ScenarioCell("ctm-dir01-cohort", workload="ctm", data=D,
                     pacing="cohort:2", num_epochs=2),
        # baselines for the faulted cells below
        ScenarioCell("iid-cohort-delta", pacing="cohort:2",
                     wire_codec="delta"),
        ScenarioCell("iid-sync-delta", wire_codec="delta"),
        ScenarioCell("dir01-async-fedavg", data=D, pacing="async:2"),
        ScenarioCell("dir01-cohort-delta", data=D, pacing="cohort:2",
                     wire_codec="delta"),
        # -- faulted cells ------------------------------------------------
        ScenarioCell("dir01-slow-sync", data=D, fault="slow:0.5"),
        ScenarioCell("iid-partition-cohort", pacing="cohort:2",
                     wire_codec="delta", fault="partition:3"),
        ScenarioCell("dir01-flap-async", data=D, pacing="async:2",
                     fault="flap:4"),
        ScenarioCell("iid-crash-sync", wire_codec="delta", fault="crash:3"),
        # HEADLINE: Dirichlet-α non-IID x mid-run server kill x cohort
        # pacing x delta codec — the headline composition.
        ScenarioCell("dir01-crash-cohort", data=D, pacing="cohort:2",
                     wire_codec="delta", fault="crash:3"),
        # -- hierarchical survivability (root + 2 relays; the runner
        # splits the members between the shards). relaycrash: one relay
        # SIGKILLed mid-run and respawned with identical argv (shard
        # journal autorecovery, Ack-3 member reconnects); relayloss: the
        # relay never returns and its members re-home to the root. Both
        # compose non-IID data with the delta codec; the NPMI baseline
        # twin is the same policy run FLAT (two-tier FedAvg reproduces
        # the flat trajectory). The relaycrash cell also bounds
        # time-to-quorum after the kill via the recovery_time SLO,
        # replayed through the offline `slo` engine.
        ScenarioCell("dir01-relaycrash-sync", data=D, wire_codec="delta",
                     fault="relaycrash:3", n_clients=4, total_docs=160,
                     slo=(
                         {"name": "recovery_time",
                          "metric": "recovery_time_s", "agg": "value",
                          "op": "<=", "threshold": 120.0},
                     )),
        # The relayloss cell kills early and stretches the surviving
        # shard's runway (long epochs, one minibatch per poll) so the
        # root is still mid-run when the orphaned members' failover
        # lands — re-homing must RACE completion to be observable at
        # all.
        ScenarioCell("dir01-relayloss-sync", data=D, wire_codec="delta",
                     fault="relayloss:2", n_clients=4, total_docs=160,
                     num_epochs=24, local_steps=1, max_iters=400,
                     extra_server_kwargs={"round_backoff_s": 1.0}),
        # -- privacy cells (README "Differential privacy & posterior
        # sampling"): each dp cell's baseline twin is the same policy
        # run noiseless — the npmi_tolerance contract bounds what the
        # noise costs, budget_monotone asserts the (eps, delta) ledger
        # never resets. Sigma/clip are sized for these tiny synthetic
        # federations: server noise std = sigma*clip/n_contributors.
        ScenarioCell("dp-server-sync-dir01", data=D,
                     dp="server", dp_clip=0.5, dp_sigma=0.6),
        ScenarioCell("dp-server-cohort-dir01", data=D, pacing="cohort:2",
                     dp="server", dp_clip=0.5, dp_sigma=0.6),
        ScenarioCell("dp-client-sync-dir01", data=D,
                     dp="client", dp_clip=0.3, dp_sigma=0.3),
        ScenarioCell("dp-client-cohort-dir01", data=D, pacing="cohort:2",
                     dp="client", dp_clip=0.3, dp_sigma=0.3),
        # DP x crash: the ledger must survive the kill — the replacement
        # server resumes epsilon from the journal (plus one conservative
        # catch-up step), so the merged privacy_budget stream stays
        # monotone through the recovery seam.
        ScenarioCell("dp-server-crash-cohort", data=D, pacing="cohort:2",
                     wire_codec="delta", fault="crash:3",
                     dp="server", dp_clip=0.5, dp_sigma=0.6),
    ]


def baseline_of(cell: ScenarioCell) -> "ScenarioCell | None":
    """The clean twin a faulted/dp cell's comparative contracts need —
    same policy axes, no fault AND no noise (None when the cell is its
    own baseline)."""
    if cell.fault_persona.kind == "none" and cell.dp == "off":
        return None
    return replace(
        cell, name=f"{cell.name}-baseline", fault="none", dp="off",
        dp_sigma=0.0,
    )


# ---- one cell ---------------------------------------------------------------

@dataclass
class CellResult:
    cell: ScenarioCell
    ok: bool
    contracts: dict[str, dict[str, Any]]
    evidence: dict[str, Any]
    baseline_name: str | None
    seconds: float
    workdir: str


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _model_kwargs(cell: ScenarioCell) -> dict[str, Any]:
    kwargs: dict[str, Any] = dict(
        n_components=cell.n_components,
        hidden_sizes=tuple(cell.hidden_sizes),
        batch_size=cell.batch_size,
        num_epochs=cell.num_epochs,
        seed=cell.seed,
    )
    if cell.workload == "ctm":
        kwargs.update(contextual_size=12, inference_type="zeroshot")
    return kwargs


def _server_kwargs(cell: ScenarioCell, save_dir: str,
                   ref_path: str) -> dict[str, Any]:
    kwargs = dict(
        min_clients=cell.n_clients,
        family=cell.workload,
        model_kwargs=_model_kwargs(cell),
        max_iters=cell.max_iters,
        save_dir=save_dir,
        local_steps=cell.local_steps,
        quorum_fraction=cell.quorum_fraction,
        aggregator=cell.aggregator,
        robust_aggregator=cell.robust,
        wire_codec=cell.wire_codec,
        pacing_policy=cell.pacing,
        pacing_seed=cell.seed,
        # Quality plane ON for every cell: per-round NPMI vs the cell's
        # reference corpus is what the npmi_tolerance contract reads.
        quality_every=1,
        quality_ref=ref_path,
        quality_topn=6,
        # The journal (not periodic checkpoints) carries crash recovery.
        checkpoint_every=0,
        journal_every=1,
        round_backoff_s=0.2,
    )
    if cell.slo:
        # The live engine runs the same specs the offline contract
        # replays — alert_* events land in the cell's server stream.
        kwargs["slo_specs"] = list(cell.slo)
    if cell.dp != "off":
        # Both dp modes hand the spec to the server: "server" constructs
        # the FedLD noiser, "client" only the (conservative) accountant
        # — the mechanism itself runs in the clients.
        kwargs.update(
            dp=cell.dp, dp_clip=cell.dp_clip, dp_sigma=cell.dp_sigma,
            dp_budget=cell.dp_budget, dp_seed=cell.seed,
        )
    kwargs.update(cell.extra_server_kwargs)
    return kwargs


def _await_round(server, round_idx: int, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if server.global_iterations >= round_idx:
            return
        if server.training_done.is_set():
            return  # finished before the target round: kill what's there
        time.sleep(0.05)
    raise TimeoutError(
        f"federation never reached round {round_idx} within {timeout:g}s"
    )


def run_cell(
    cell: ScenarioCell,
    workdir: str,
    baseline_evidence: "dict[str, Any] | None" = None,
    baseline_name: str | None = None,
    metrics=None,
    device=None,
) -> CellResult:
    """Run one cell end to end and evaluate its contracts.

    ``metrics`` is the harness-level logger the scenario lifecycle
    events (``scenario_cell_started`` / ``scenario_contract`` /
    ``scenario_cell_finished``) land on. ``device`` is every node's torch
    device (``None``: the GPU; without CUDA this raises before the cell
    starts).
    """
    from gfedntm_tpu_torch.device import resolve_device
    from gfedntm_tpu_torch.federation.client import Client
    from gfedntm_tpu_torch.federation.resilience import build_fault_injector
    from gfedntm_tpu_torch.federation.server import FederatedServer
    from gfedntm_tpu_torch.utils.observability import MetricsLogger, read_metrics

    device = resolve_device(device)
    # The per-cell dir is runner-owned output: start from a CLEAN slate.
    # A rerun into the same --workdir would otherwise append to the
    # previous run's metrics.jsonl streams (contaminating the evidence
    # the contracts evaluate — stale healthy spans can outvote a fresh
    # regression) and leave its round journal where a crash cell's
    # replacement server would autorecover from the WRONG run.
    if os.path.isdir(workdir):
        import shutil

        shutil.rmtree(workdir)
    os.makedirs(workdir, exist_ok=True)
    if metrics is not None:
        metrics.log(
            "scenario_cell_started", cell=cell.name,
            workload=cell.workload, pacing=cell.pacing,
            data=cell.data, fault=cell.fault,
        )
    t0 = time.perf_counter()
    persona = cell.fault_persona
    corpora, ref_docs = build_corpora(cell)
    ref_path = os.path.join(workdir, "quality_ref.txt")
    with open(ref_path, "w") as fh:
        fh.write("\n".join(ref_docs) + "\n")

    port = _free_port()
    server_dir = os.path.join(workdir, "server")
    server_kwargs = _server_kwargs(cell, server_dir, ref_path)
    hier = persona.kind in RELAY_KINDS
    if hier:
        # Hierarchical topology: the root terminates RELAYS, not
        # members, and a lost shard must degrade the quorum after a
        # short grace, never stall the round loop.
        server_kwargs["min_clients"] = N_RELAYS
        server_kwargs.setdefault("relay_grace_rounds", 2)
    stream_paths = [os.path.join(server_dir, "metrics.jsonl")]
    m_server = MetricsLogger(stream_paths[0], node="server", validate=True)
    injector_specs = fault_specs_for(persona, cell.n_clients)
    injector = (
        build_fault_injector(injector_specs, seed=cell.seed,
                             metrics=m_server)
        if injector_specs else None
    )
    server = FederatedServer(
        metrics=m_server, fault_injector=injector, device=device,
        **server_kwargs
    )
    server.start(f"[::]:{port}")

    relays: list = []
    relay_metrics: list = []
    relay_ports: list[int] = []
    relay_kwargs: list[dict[str, Any]] = []
    shard_of = [
        c * N_RELAYS // max(1, len(corpora)) for c in range(len(corpora))
    ]
    # For relayloss the victim is the LIGHTEST-loaded shard: its
    # orphaned members must re-home while the survivors still hold
    # enough work to keep the root's round loop alive (non-IID splits
    # can make the shards very uneven).
    shard_load = [
        sum(len(corpora[c]) for c in range(len(corpora))
            if shard_of[c] == r)
        for r in range(N_RELAYS)
    ]
    victim_shard = (
        min(range(N_RELAYS), key=lambda r: shard_load[r])
        if persona.kind == "relayloss" else 0
    )
    if hier:
        from gfedntm_tpu_torch.federation.relay import RelayNode

        for r in range(N_RELAYS):
            relay_id = RELAY_ID_BASE + 1 + r
            rport = _free_port()
            rdir = os.path.join(workdir, f"relay{relay_id}")
            rpath = os.path.join(rdir, "metrics.jsonl")
            stream_paths.append(rpath)
            rm = MetricsLogger(
                rpath, node=f"relay{relay_id}", validate=True
            )
            kwargs = dict(
                relay_id=relay_id,
                upstream_address=f"localhost:{port}",
                min_members=shard_of.count(r),
                listen_address=f"[::]:{rport}",
                save_dir=rdir,
                journal_every=1,
                wire_codec="auto",
                liveness_timeout=60.0,
                watchdog_poll_s=0.2,
                reconnect_window=30.0,
            )
            relay = RelayNode(metrics=rm, device=device, **kwargs)
            relay.start()
            relays.append(relay)
            relay_metrics.append(rm)
            relay_ports.append(rport)
            relay_kwargs.append(kwargs)

    client_metrics = []
    clients = []
    for c, corpus in enumerate(corpora):
        cdir = os.path.join(workdir, f"client{c + 1}")
        path = os.path.join(cdir, "metrics.jsonl")
        stream_paths.append(path)
        cm = MetricsLogger(path, node=f"client{c + 1}", validate=True)
        client_metrics.append(cm)
        if hier:
            upstream = f"localhost:{relay_ports[shard_of[c]]}"
            # relayloss: the doomed shard's members carry the root as a
            # failover endpoint plus a TIGHT liveness window and
            # reconnect window, so they detect the dead relay and
            # re-home while the surviving shard is still training (the
            # race the rehoming contract asserts — detection is
            # idle-based, the tier polls its members). relaycrash
            # members ride the ordinary window so the respawned relay
            # (same port) re-admits them instead.
            doomed = (
                persona.kind == "relayloss"
                and shard_of[c] == victim_shard
            )
            failover = [f"localhost:{port}"] if doomed else []
            window = 1.0 if doomed else 180.0
            live = 1.2 if doomed else 60.0
        else:
            upstream, failover, window = f"localhost:{port}", [], 180.0
            live = 60.0
        dp_kwargs = (
            dict(dp="client", dp_clip=cell.dp_clip,
                 dp_sigma=cell.dp_sigma, dp_seed=cell.seed)
            if cell.dp == "client" else {}
        )
        clients.append(Client(
            client_id=c + 1,
            corpus=corpus,
            server_address=upstream,
            failover_addrs=failover,
            save_dir=cdir,
            metrics=cm,
            liveness_timeout=live,
            watchdog_poll_s=0.2,
            reconnect_window=window,
            wire_codec="auto",
            device=device,
            **dp_kwargs,
        ))
    threads = [
        threading.Thread(target=c.run, daemon=True, name=f"cell-client{i}")
        for i, c in enumerate(clients)
    ]
    for t in threads:
        t.start()

    recovery: dict[str, Any] | None = None
    finished = False
    error: str | None = None
    final_server = server
    try:
        if hier:
            _await_round(server, persona.crash_round,
                         timeout=cell.timeout_s / 2)
            # Kill the victim shard's relay with no stop fan-out — the
            # relay-tier SIGKILL-equivalent.
            victim = relays[victim_shard]
            victim.abort()
            killed_at = server.global_iterations
            relay_metrics[victim_shard].snapshot_registry()
            relay_metrics[victim_shard].close()
            if persona.kind == "relaycrash":
                # Identical-argv respawn: same id, same port, same
                # save_dir, ZERO recovery flags — maybe_autorecover
                # restores the shard from its journal on its own.
                rpath2 = os.path.join(
                    workdir, "relay_recovered", "metrics.jsonl"
                )
                stream_paths.append(rpath2)
                rm2 = MetricsLogger(
                    rpath2,
                    node=f"relay{RELAY_ID_BASE + 1 + victim_shard}",
                    validate=True,
                )
                from gfedntm_tpu_torch.federation.relay import RelayNode

                relay2 = RelayNode(
                    metrics=rm2, device=device, **relay_kwargs[victim_shard]
                )
                resumed = relay2.maybe_autorecover()
                relay2.start()
                relays[victim_shard] = relay2
                relay_metrics[victim_shard] = rm2
                recovery = {
                    "recovered": resumed is not None,
                    "resumed_round": resumed,
                    "killed_round": killed_at,
                    "source": "journal",
                }
            else:
                # relayloss: the relay never returns; its members must
                # re-home to the root via their failover endpoint.
                relays[victim_shard] = None
                relay_metrics[victim_shard] = None
                recovery = {
                    "recovered": False,
                    "resumed_round": None,
                    "killed_round": killed_at,
                    "source": None,
                }
        elif persona.kind == "crash":
            _await_round(server, persona.crash_round,
                         timeout=cell.timeout_s / 2)
            # SIGKILL-equivalent (the in-process recipe): abort without any
            # stop broadcast / finalize, join the abandoned training
            # thread so its last journal write can't race the
            # replacement server's recovery reads.
            server.abort()
            t = server._train_thread
            if t is not None:
                t.join(timeout=120.0)
            killed_at = server.global_iterations
            m_server.snapshot_registry()
            m_server.close()
            # Replacement process: same construction, ZERO recovery
            # flags — maybe_autorecover finds the journal on its own.
            path2 = os.path.join(workdir, "server_recovered",
                                 "metrics.jsonl")
            stream_paths.append(path2)
            m_server2 = MetricsLogger(path2, node="server", validate=True)
            server2 = FederatedServer(
                metrics=m_server2, device=device, **server_kwargs
            )
            resumed = server2.maybe_autorecover()
            server2.start(f"[::]:{port}")
            recovery = {
                "recovered": resumed is not None,
                "resumed_round": resumed,
                "killed_round": killed_at,
                "source": getattr(server2, "_recovered_source", None),
            }
            final_server, m_server = server2, m_server2
        finished = final_server.wait_done(timeout=cell.timeout_s)
        for t in threads:
            t.join(timeout=60.0)
    except Exception as err:  # noqa: BLE001 — a cell failure must not
        # kill the matrix; it becomes a red "completes" contract with
        # the error in the evidence.
        error = f"{type(err).__name__}: {err}"
        _LOG.exception("cell %s failed", cell.name)
    finally:
        try:
            final_server.stop()
        except Exception:
            _LOG.exception("cell %s: server stop failed", cell.name)
        for relay in relays:
            if relay is None:
                continue
            try:
                relay.shutdown()
            except Exception:
                _LOG.exception("cell %s: relay shutdown failed", cell.name)
        for rm in relay_metrics:
            if rm is not None:
                rm.snapshot_registry()
                rm.close()
        for c in clients:
            try:
                c.shutdown()
            except Exception:
                _LOG.exception("cell %s: client shutdown failed", cell.name)
        m_server.snapshot_registry()
        m_server.close()
        for cm in client_metrics:
            cm.snapshot_registry()
            cm.close()

    betas = getattr(final_server, "global_betas", None)
    betas_finite = bool(
        betas is not None and np.isfinite(np.asarray(betas)).all()
    )
    records_by_stream = []
    for path in stream_paths:
        try:
            records_by_stream.append(read_metrics(path))
        except FileNotFoundError:
            records_by_stream.append([])
    evidence = collect_cell_evidence(
        records_by_stream,
        finished=finished,
        betas_finite=betas_finite,
        rounds=int(getattr(final_server, "global_iterations", 0)),
        recovery=recovery,
        slo_specs=cell.slo or None,
    )
    if error is not None:
        evidence["error"] = error
    evidence["baseline_npmi"] = (
        baseline_evidence.get("npmi_final")
        if baseline_evidence is not None
        else evidence.get("npmi_final")
    )
    contracts = evaluate_contracts(cell, evidence, baseline_evidence)
    ok = all(c["ok"] for c in contracts.values())
    seconds = time.perf_counter() - t0
    if metrics is not None:
        for name, verdict in contracts.items():
            metrics.log(
                "scenario_contract", cell=cell.name, contract=name,
                ok=verdict["ok"], detail=verdict["detail"],
            )
        metrics.log(
            "scenario_cell_finished", cell=cell.name, ok=ok,
            seconds=seconds,
        )
    return CellResult(
        cell=cell, ok=ok, contracts=contracts, evidence=evidence,
        baseline_name=baseline_name, seconds=seconds, workdir=workdir,
    )


# ---- evidence collection (from JSONL alone) ---------------------------------

def collect_cell_evidence(
    records_by_stream: list[list[dict[str, Any]]],
    finished: bool = False,
    betas_finite: bool = False,
    rounds: int = 0,
    recovery: "dict[str, Any] | None" = None,
    slo_specs=None,
) -> dict[str, Any]:
    """Digest a cell's per-node JSONL streams into the evidence dict the
    contracts evaluate — push-span contributor counts, quorum skips,
    the clean-run counters, and the quality trajectory. Server streams
    are recognized by their ``node`` stamp; everything is derived from
    the records alone (the ``summarize``/``report`` reproducibility
    contract)."""
    from gfedntm_tpu_torch.utils.observability import summarize_model_quality

    server_records: list[dict[str, Any]] = []
    all_records: list[dict[str, Any]] = []
    for records in records_by_stream:
        all_records.extend(records)
        if any(r.get("node") == "server" for r in records[:50]):
            server_records.extend(records)

    push_clients = [
        int(r["clients"])
        for r in server_records
        if r.get("event") == "span" and r.get("name") == "push"
        and "clients" in r
    ]
    quorum_skips = sum(
        1 for r in server_records if r.get("event") == "quorum_skip"
    )
    # Clean-run counters: the LAST metrics_snapshot of each stream is
    # its cumulative state; sum across streams (both ends of the wire
    # count their own misses/dedups).
    counters = {name: 0.0 for name in CLEAN_COUNTERS}
    for records in records_by_stream:
        last = None
        for r in records:
            if r.get("event") == "metrics_snapshot":
                last = r
        if last is None:
            continue
        for name, snap in (last.get("metrics") or {}).items():
            if name in counters and snap.get("type") == "counter":
                counters[name] += float(snap.get("value") or 0.0)

    quality = summarize_model_quality(server_records)
    npmi_final = None
    for row in quality.get("quality", ()):
        if row.get("npmi") is not None:
            npmi_final = float(row["npmi"])
    slo: "dict[str, Any] | None" = None
    if slo_specs:
        # SLO contract evidence (README "Fleet telemetry & SLOs"): replay
        # the recorded snapshots through the offline evaluator — the same
        # FleetRegistry + SLOEngine the live planes run.
        from gfedntm_tpu_torch.utils.slo import evaluate_stream

        node_records: dict[str, list[dict[str, Any]]] = {}
        for i, records in enumerate(records_by_stream):
            for r in records:
                node_records.setdefault(
                    str(r.get("node") or f"stream{i}"), []
                ).append(r)
        engine = evaluate_stream(node_records, list(slo_specs))
        slo = {
            "fired": engine.ever_fired(),
            "alerts": engine.status()["alerts"],
        }
    # Privacy ledger evidence (README "Differential privacy & posterior
    # sampling"): the server stream's per-round eps trajectory, in
    # stream order (a crash cell's recovered-server stream extends the
    # killed one's — the budget_monotone contract asserts the seam).
    privacy_eps = [
        float(r.get("eps", 0.0)) for r in server_records
        if r.get("event") == "privacy_budget"
    ]
    return {
        "finished": bool(finished),
        "betas_finite": bool(betas_finite),
        "rounds": int(rounds),
        "averaged_push_clients": push_clients,
        "quorum_skips": quorum_skips,
        "counters": counters,
        "npmi_final": npmi_final,
        "quality_rounds": len(quality.get("quality", ())),
        "recovery": recovery,
        "slo": slo,
        "privacy_eps": privacy_eps,
        "privacy_exceeded_events": sum(
            1 for r in all_records
            if r.get("event") == "privacy_budget_exceeded"
        ),
        "server_recovered_events": sum(
            1 for r in all_records if r.get("event") == "server_recovered"
        ),
        "relay_recovered_events": sum(
            1 for r in all_records if r.get("event") == "relay_recovered"
        ),
        "member_rehomed_events": sum(
            1 for r in all_records if r.get("event") == "member_rehomed"
        ),
    }


# ---- the matrix -------------------------------------------------------------

def run_matrix(
    cells: list[ScenarioCell],
    workdir: str,
    fast: bool = False,
    metrics=None,
    device=None,
) -> list[CellResult]:
    """Run a list of cells, no-fault baselines first, wiring each
    faulted cell to its baseline twin's evidence. A faulted cell whose
    baseline twin is not in the list gets one synthesized
    (``<name>-baseline``) and run first — every comparison in the
    artifact is against a cell that actually ran in the same batch.
    ``device`` is every cell's (see :func:`run_cell`)."""
    if fast:
        cells = [c.shrink() for c in cells]
    names = [c.name for c in cells]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate cell names in matrix: {names}")

    def _clean(c: ScenarioCell) -> bool:
        return c.fault_persona.kind == "none" and c.dp == "off"

    baselines = [c for c in cells if _clean(c)]
    faulted = [c for c in cells if not _clean(c)]
    by_key: dict[tuple, ScenarioCell] = {}
    for c in baselines:
        by_key.setdefault(c.policy_key(), c)
    # Synthesize missing baseline twins (they become real cells).
    for c in faulted:
        if c.policy_key() not in by_key:
            twin = baseline_of(c)
            baselines.append(twin)
            by_key[twin.policy_key()] = twin

    results: list[CellResult] = []
    evidence_by_key: dict[tuple, CellResult] = {}
    for cell in baselines + faulted:
        base_res = evidence_by_key.get(cell.policy_key())
        is_baseline = _clean(cell)
        res = run_cell(
            cell,
            os.path.join(workdir, cell.name),
            baseline_evidence=None if is_baseline else (
                base_res.evidence if base_res is not None else None
            ),
            baseline_name=None if is_baseline or base_res is None
            else base_res.cell.name,
            metrics=metrics,
            device=device,
        )
        if is_baseline:
            evidence_by_key.setdefault(cell.policy_key(), res)
        results.append(res)
        _LOG.info(
            "cell %s: %s (%.1fs)", cell.name,
            "ok" if res.ok else "CONTRACT FAILURE", res.seconds,
        )
    return results


# ---- bench artifact ---------------------------------------------------------

def _bench_schema():
    """The shared artifact-shape validator (``scripts/bench_schema.py``
    — not a package; the scripts add their own dir to sys.path, the
    library does it here)."""
    try:
        import bench_schema
    except ImportError:
        import sys

        scripts = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)
            ))),
            "scripts",
        )
        if scripts not in sys.path:
            sys.path.insert(0, scripts)
        import bench_schema
    return bench_schema


def cell_bench_row(result: CellResult) -> dict[str, Any]:
    """One cell's standard bench JSON line (``bench_schema`` kind
    ``"scenario"``), validated at the emission site."""
    require = _bench_schema().require

    cell = result.cell
    row = {
        "metric": "scenario",
        "cell": cell.name,
        "workload": cell.workload,
        "data_persona": cell.data,
        "fault_persona": cell.fault,
        "pacing": cell.pacing,
        "aggregator": cell.aggregator
        + (f"+{cell.robust}" if cell.robust else ""),
        "wire_codec": cell.wire_codec,
        "n_clients": cell.n_clients,
        "dp": cell.dp,
        "dp_sigma": cell.dp_sigma,
        "privacy_final_eps": (
            (result.evidence.get("privacy_eps") or [None])[-1]
        ),
        "rounds": result.evidence.get("rounds"),
        "npmi": result.evidence.get("npmi_final"),
        "baseline_npmi": result.evidence.get("baseline_npmi"),
        "npmi_tol": cell.npmi_tol,
        "baseline": result.baseline_name,
        "counters": result.evidence.get("counters"),
        "quorum_skips": result.evidence.get("quorum_skips"),
        "contracts": dict(result.contracts),
        "ok": result.ok,
        "seconds": round(result.seconds, 2),
    }
    return require(row, "scenario")


def emit_artifact(
    results: list[CellResult], rev: str = "unknown"
) -> dict[str, Any]:
    """The BENCH_SCENARIO artifact object (``bench_schema`` kind
    ``"scenario_bench"``): every cell's bench line plus the acceptance
    flags the trajectory reviewer keys on."""
    require = _bench_schema().require

    rows = [cell_bench_row(r) for r in results]
    headline = None
    for r in results:
        cell = r.cell
        if (
            cell.fault_persona.kind == "crash"
            and cell.data_persona.alpha is not None
            and cell.pacing.startswith("cohort")
            and r.ok
        ):
            headline = cell.name
    artifact = {
        "bench": "scenario_matrix",
        "rev": rev,
        "generated_by": (
            "python -m gfedntm_tpu_torch scenarios --out "
            "BENCH_SCENARIO_rNN.json"
        ),
        "cells": rows,
        "acceptance": {
            "n_cells": len(rows),
            "min_cells": 12,
            "enough_cells": len(rows) >= 12,
            "all_contracts_green": all(r.ok for r in results),
            "headline_cell": headline,
            "headline_green": headline is not None,
        },
    }
    return require(artifact, "scenario_bench")
