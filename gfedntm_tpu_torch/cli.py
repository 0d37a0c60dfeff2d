"""Command line of the PyTorch port (the counterpart of ``gfedntm_tpu/cli.py``).

``python -m gfedntm_tpu_torch`` takes the JAX command line's flags, with
the same names, choices and defaults, and one more: ``--device`` (``None``
-> the GPU; a CUDA-less host is an error unless ``--device cpu`` asks for
the CPU, as the tests do). Roles, selected by ``--id`` exactly as the
reference does (``main.py:178-291``):

- ``--id 0``: the port's federation server (:func:`run_server`);
- ``--id N``: a port client on node ``N`` of the ``--source`` archive
  (:func:`run_client`), ``--server_addrs`` giving its failover ladder;
- ``--role relay``: a mid-tier :class:`RelayNode` (:func:`run_relay`);
- ``--role serve``: the :class:`ServingPlane` over a federation's
  ``save_dir`` (:func:`run_serve`);
- no ``--id``: the whole federation in this process through
  ``FederatedTrainer`` (:func:`run_simulate`), with ``global_model.npz``,
  ``client{c}/model.npz`` and one summary JSON line on stdout.

Six readers take a run's telemetry instead of producing it, and print what
the JAX CLI's print on the same streams: ``summarize``, ``report`` (with
``--assert-monotone-coherence``), ``trace``, ``slo``, ``privacy`` and
``incident``. ``scenarios`` runs the scenario matrix over the port's nodes
(:func:`run_scenarios`, with ``--device``). One input stays out, with exit
code 2: ``--mesh_devices`` above 1 (one client over several devices;
ROADMAP.md queue 1), which the JAX CLI meets by forcing virtual CPU
devices.

Data paths mirror ``main.py:138-152``: synthetic ``.npz`` archives (node
``id-1`` of a multi-node archive) or real ``.parquet`` filtered by ``--fos``.
Hyperparameters come from a reference-format INI (``--config``,
``config/dft_params.cf`` works verbatim) with CLI overrides.
"""

from __future__ import annotations

import argparse
import datetime as _dt
import json
import logging
import os
import re
import sys
from typing import Any

import numpy as np

from gfedntm_tpu_torch.config import GfedConfig, from_ini


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gfedntm-tpu-torch",
        description=(
            "Federated neural topic modeling, the PyTorch port. --id 0: "
            "federation server; --id N: network client; no --id: whole "
            "federation in one process."
        ),
        epilog=(
            "Subcommands: 'summarize <metrics.jsonl>' renders a telemetry "
            "report from a run's JSONL stream (see README 'Telemetry'); "
            "'trace <metrics.jsonl>...' merges per-node streams into one "
            "Chrome trace-event file (README 'Distributed tracing & ops "
            "endpoint'); 'report <metrics.jsonl>' renders the model-"
            "quality report — coherence/drift trajectory, per-client "
            "contributions (README 'Model-quality observability'); "
            "'slo', 'privacy' and 'incident' gate on SLO specs, the "
            "privacy ledger and incident bundles. 'scenarios' runs the "
            "scenario matrix — real federations under composed non-IID "
            "data + fault personas with per-cell graceful-degradation "
            "contracts (README 'Scenario matrix')."
        ),
    )
    p.add_argument("--id", type=int, default=None,
                   help="node id (0 = server, >=1 = client; omit to simulate)")
    p.add_argument("--role",
                   choices=("auto", "server", "client", "relay", "serve"),
                   default="auto",
                   help="process role (default auto: derived from --id). "
                        "'relay' runs a mid-tier aggregator (README "
                        "\"Hierarchical federation & wire efficiency\"): "
                        "it terminates --min_clients_federation members "
                        "with the full admission gate, pre-reduces them "
                        "into one pseudo-update, and joins the upstream "
                        "server at --server_address as ordinary client "
                        "--id. 'serve' runs the topic-inference serving "
                        "plane (README \"Serving\"): it watches save_dir "
                        "for journal/checkpoint-published rounds, "
                        "hot-swaps the newest un-flagged model, and "
                        "answers doc->theta queries over gRPC Infer and "
                        "the ops-HTTP /infer route")
    p.add_argument("--source", type=str, default=None,
                   help="data path (.npz synthetic archive or .parquet)")
    p.add_argument("--data_type", choices=("synthetic", "real"),
                   default="synthetic")
    p.add_argument("--fos", type=str, default=None,
                   help="parquet category filter; comma-list = one client "
                        "per category in simulate mode")
    p.add_argument("--min_clients_federation", type=int, default=1)
    p.add_argument("--model_type", choices=("avitm", "ctm"), default="avitm")
    p.add_argument("--max_iters", type=int, default=None,
                   help="global step cap (default: INI federation.max_iters, "
                        "else 25000)")
    p.add_argument("--config", type=str, default=None,
                   help="reference-format INI (config/dft_params.cf)")
    p.add_argument("--server_address", type=str, default="localhost:50051")
    p.add_argument("--server_addrs", type=str, default=None,
                   help="client mode: ordered comma-list of upstream "
                        "endpoints (first = primary); when the reconnect "
                        "window against the current endpoint expires the "
                        "client re-homes to the next one (a sibling relay "
                        "or the root) presenting the same session token — "
                        "overrides --server_address")
    p.add_argument("--listen_port", type=int, default=None,
                   help="serving port (default: 50051 for the server, "
                        "50051+id for clients — the reference scheme — "
                        "and 51051+id for relays, a distinct base so a "
                        "relay and a same-id member on one host don't "
                        "collide)")
    p.add_argument("--save_dir", type=str, default="output")
    p.add_argument("--n_clients", type=int, default=None,
                   help="simulate mode: partition a single corpus into N "
                        "IID shards (ignored for multi-node archives)")
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--n_components", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--local_steps", type=int, default=1,
                   help="minibatches per client between "
                        "FedAvg exchanges, simulate AND server modes (1 = the reference's "
                        "per-minibatch averaging; >1 = FedAvg proper, the "
                        "opt-in fix for its topic-diversity collapse)")
    # Fault tolerance (README "Fault tolerance"): round checkpoint/resume,
    # probation/quorum semantics, and the client liveness watchdog.
    p.add_argument("--resume", action="store_true",
                   help="server mode: restore round state from the latest "
                        "checkpoint under save_dir and continue from that "
                        "round while clients rejoin")
    p.add_argument("--checkpoint_every", type=int, default=25,
                   help="server mode: persist round state every K rounds "
                        "(0 disables)")
    p.add_argument("--probation_rounds", type=int, default=3,
                   help="server mode: consecutive failed rounds before a "
                        "suspect client is permanently dropped")
    p.add_argument("--quorum_fraction", type=float, default=0.5,
                   help="server mode: minimum fraction of unfinished "
                        "clients that must answer for a round's average "
                        "to count")
    p.add_argument("--relay_grace_rounds", type=int, default=0,
                   help="server mode, hierarchical fleets: a shard "
                        "(relay) that has missed this many consecutive "
                        "rounds is excluded from the quorum denominator "
                        "and HT population reweighting until it answers "
                        "again — graceful degradation instead of a stall "
                        "(0 = off, the flat-fleet semantics)")
    p.add_argument("--liveness_timeout", type=float, default=300.0,
                   help="client mode: treat the server as gone if no "
                        "activity arrives within this many seconds "
                        "(cold-start window; once polls flow the window "
                        "adapts to the observed cadence; 0 disables)")
    # Crash survival (README "Crash recovery & sessions"): durable client
    # sessions, the per-round recovery journal, and process-level chaos.
    p.add_argument("--reconnect_window", type=float, default=180.0,
                   help="client mode: when the server goes quiet, keep "
                        "re-presenting the session token for up to this "
                        "many seconds (RECONNECTING) before "
                        "self-finalizing (0 restores the legacy "
                        "watchdog-finalize behaviour)")
    p.add_argument("--journal_every", type=int, default=1,
                   help="server mode: journal the pushed round state "
                        "every K rounds for zero-flag crash "
                        "auto-recovery (default 1 — at most one in-"
                        "flight round replays after a kill; 0 disables "
                        "the journal AND auto-recovery)")
    p.add_argument("--no_autorecover", action="store_true",
                   help="server mode: do not auto-resume an interrupted "
                        "run from the journal/checkpoint at startup "
                        "(auto-recovery is otherwise on whenever "
                        "save_dir holds recovery state)")
    p.add_argument("--chaos", type=str, default=None,
                   help="server mode, chaos harness: JSON list of fault "
                        "specs injected into the server's client stubs, "
                        "e.g. '[{\"method\": \"*\", \"kind\": "
                        "\"partition\", \"peer\": \"client2\", "
                        "\"delay_s\": 5}]' (see resilience.FaultSpec)")
    # Round pacing (README "Federation pacing"): cohort sampling and
    # buffered async — the knobs that decouple round time from the
    # population size.
    p.add_argument("--pacing", type=str, default="sync",
                   help="server mode: round pacing policy — sync (the "
                        "all-clients barrier, default), cohort[:K] "
                        "(seeded K-of-N sampling with unbiased "
                        "reweighting), async[:B] (FedBuff-style buffered "
                        "aggregation with staleness discounting), "
                        "push[:B] (client-initiated rounds: clients "
                        "stream PushUpdate when local steps finish; "
                        "server work is O(updates received))")
    p.add_argument("--cohort_size", type=int, default=None,
                   help="server mode: K for --pacing cohort (alternative "
                        "to the inline cohort:<K> form)")
    p.add_argument("--async_buffer", type=int, default=None,
                   help="server mode: admitted updates per aggregation "
                        "for --pacing async (alternative to async:<B>)")
    p.add_argument("--staleness_alpha", type=float, default=0.5,
                   help="server mode, async pacing: staleness discount "
                        "exponent — each buffered update's weight is "
                        "scaled by 1/(1+s)^alpha (0 disables)")
    p.add_argument("--pacing_seed", type=int, default=0,
                   help="server mode: seed for the per-round cohort "
                        "sampler (rosters are deterministic per round)")
    # Aggregation strategy + wire compression (README "Aggregation
    # strategies & wire compression").
    p.add_argument("--aggregator", default="fedavg",
                   choices=("fedavg", "fedavgm", "fedadam", "fedyogi"),
                   help="server mode: aggregate-step strategy (fedavg = the "
                        "reference's sample-weighted average; fedavgm adds "
                        "server momentum; fedadam/fedyogi apply adaptive "
                        "server optimizers with state that survives "
                        "--resume)")
    p.add_argument("--server_lr", type=float, default=None,
                   help="server mode: server-optimizer learning rate for "
                        "fedavgm/fedadam/fedyogi (default: each "
                        "aggregator's own)")
    # Data-plane hardening (README "Robust aggregation & divergence
    # recovery"): byzantine-robust mean stage, update admission gate,
    # divergence rollback.
    p.add_argument("--robust_aggregator", type=str, default=None,
                   help="server mode: byzantine-robust mean stage "
                        "substituted for the sample-weighted average — "
                        "'trimmed_mean:<frac>' (coordinate-wise), 'median' "
                        "(coordinate-wise), or 'krum:<f>' (multi-Krum "
                        "tolerating f byzantine clients); composes with "
                        "any --aggregator (default: plain weighted mean)")
    p.add_argument("--agg_backend", default="auto",
                   choices=("auto", "device", "numpy"),
                   help="server mode: aggregation data-plane backend — "
                        "'device' stacks each round's client snapshots "
                        "into one sharded device array and runs the "
                        "admission gate statistics + robust mean stage "
                        "as torch programs on the server's device; "
                        "'numpy' is the host reference path; 'auto' picks "
                        "device exactly when the server runs on a CUDA "
                        "device (README \"Device-resident aggregation\")")
    p.add_argument("--max_update_norm", type=float, default=None,
                   help="server mode: hard L2 cap on each admitted client "
                        "update's distance from the current global model — "
                        "larger updates are norm-clipped, gradient-"
                        "clipping style (default: no cap)")
    p.add_argument("--outlier_mad_k", type=float, default=4.0,
                   help="server mode: reject a client update whose norm "
                        "exceeds the round cohort's median + k*MAD "
                        "(0 disables the outlier screen; finiteness and "
                        "shape conformance always apply)")
    p.add_argument("--divergence_patience", type=int, default=3,
                   help="server mode: consecutive unhealthy rounds (loss "
                        "or parameter-norm explosion vs their EWMAs) "
                        "before the server rolls the global model back to "
                        "the last good checkpoint; a non-finite aggregate "
                        "rolls back immediately (0 disables the guardian)")
    p.add_argument("--codec_ref_cache_max", type=int, default=64,
                   help="server mode: hard cap on the wire-codec "
                        "reference caches (uplink broadcast views, "
                        "downlink canonical views). The rotation-aware "
                        "auto-size ~4N/K is unbounded in N at fixed K; "
                        "past the cap a long-unsampled client degrades "
                        "to a self-contained push / loud "
                        "ReferenceMismatch heal instead of growing "
                        "server memory")
    p.add_argument("--wire_codec", type=str, default=None,
                   help="wire-compression spec, '+'-joined stages of "
                        "'delta', 'topk:<frac>', 'fp16'/'bf16' (e.g. "
                        "'delta+topk:0.1+fp16'). Server mode: the "
                        "federation-wide codec advertised at join time. "
                        "Client mode: default adopts the server's; an "
                        "explicit value must match it or the join fails")
    # Cross-process observability plane (README "Distributed tracing & ops
    # endpoint"): live ops endpoint + device profiler window.
    p.add_argument("--ops_port", type=int, default=None,
                   help="server mode: serve /metrics (Prometheus), "
                        "/healthz, and /status on this HTTP port "
                        "(0 = ephemeral; default: disabled, no thread)")
    p.add_argument("--slo", type=str, default=None,
                   help="SLO spec JSON (a file path or inline): declarative "
                        "objectives over any metric, evaluated live by the "
                        "server/serve roles (alerts at /alerts + alert_* "
                        "events; README 'Fleet telemetry & SLOs')")
    p.add_argument("--fleet_max_nodes", type=int, default=512,
                   help="server mode: FleetRegistry cardinality guard — "
                        "max telemetry-reporting nodes tracked")
    p.add_argument("--fleet_max_series", type=int, default=512,
                   help="server mode: max telemetry series kept per node")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="capture a torch.profiler trace into this directory "
                        "(server/client: around the --profile_rounds "
                        "window; simulate: around the federated fit)")
    p.add_argument("--profile_rounds", type=str, default="1:2",
                   help="half-open round window for --profile_dir, "
                        "'start:stop' or a single round (default '1:2' — "
                        "skips the compile-dominated round 0)")
    # Incident forensics (README "Incident forensics"): flight recorder +
    # trigger-driven postmortem bundles. Unset = nothing is constructed
    # and the telemetry stream stays bitwise identical.
    p.add_argument("--dump_dir", type=str, default=None,
                   help="arm the flight recorder: every alert, rollback, "
                        "quarantine, autorecovery, privacy-budget breach, "
                        "swap refusal, shed storm, or chaos injection "
                        "snapshots the node's bounded event ring (+ "
                        "/status, process self-metrics, thread stacks) "
                        "into an atomic incident bundle under this "
                        "directory; the server additionally solicits "
                        "flight-record snapshots from implicated clients "
                        "and relays on their next RPC exchange. Merge "
                        "bundles with the `incident` subcommand "
                        "(default: disabled — no recorder exists)")
    p.add_argument("--flightrec_entries", type=int, default=2048,
                   help="flight-ring entry cap (O(1) ring append; "
                        "default 2048)")
    p.add_argument("--flightrec_seconds", type=float, default=300.0,
                   help="flight-ring time horizon in seconds — older "
                        "records are pruned (default 300)")
    # Model-quality observability plane (README "Model-quality
    # observability"): live topic coherence / drift / per-client
    # contribution telemetry over the global model.
    p.add_argument("--quality_every", type=int, default=0,
                   help="server mode: compute topic quality (NPMI "
                        "coherence vs --quality_ref, diversity, "
                        "round-over-round drift) every K averaged rounds "
                        "and run per-client contribution analytics "
                        "(default 0 = the plane is off and the round "
                        "loop is untouched)")
    p.add_argument("--quality_ref", type=str, default=None,
                   help="server mode: server-held reference corpus for "
                        "NPMI co-occurrence (.npz synthetic archive, "
                        ".parquet, or plain text with one document per "
                        "line); without it coherence and the quality "
                        "guard are disabled, diversity/drift still run")
    p.add_argument("--quality_topn", type=int, default=10,
                   help="top words per topic for coherence/diversity/"
                        "drift (default 10)")
    p.add_argument("--quality_guard", action="store_true",
                   help="server mode: route a sustained relative topic-"
                        "coherence drop (vs its healthy-round EWMA) "
                        "through the divergence-rollback path, reason "
                        "'coherence_collapse' (needs --quality_every > 0 "
                        "and --quality_ref)")
    # Privacy plane (README "Differential privacy & posterior sampling"):
    # DP-SGD / FedLD noise mechanisms + the (eps, delta) accountant.
    p.add_argument("--dp", type=str, default="off",
                   choices=["off", "server", "client"],
                   help="differential-privacy mode: 'server' adds "
                        "FedLD-style calibrated Gaussian noise to each "
                        "aggregate (and tightens --max_update_norm to "
                        "--dp_clip so the clip ball is enforced at "
                        "admission); 'client' clips + noises each "
                        "client's outgoing update locally (local DP). "
                        "'off' (default) constructs no mechanism objects "
                        "— every existing trajectory is bitwise unchanged")
    p.add_argument("--dp_clip", type=float, default=1.0,
                   help="L2 sensitivity bound (the DP clip; default 1.0)")
    p.add_argument("--dp_sigma", type=float, default=0.0,
                   help="noise multiplier (noise std = sigma x "
                        "sensitivity; required > 0 when --dp is not off)")
    p.add_argument("--dp_delta", type=float, default=1e-5,
                   help="delta the (eps, delta) accountant reports at "
                        "(default 1e-5)")
    p.add_argument("--dp_budget", type=float, default=0.0,
                   help="declared epsilon budget: exceeding it logs "
                        "privacy_budget_exceeded (loud, training "
                        "continues); the offline `privacy` gate turns it "
                        "into rc=1 (default 0 = track only)")
    p.add_argument("--dp_seed", type=int, default=0,
                   help="mechanism seed — every noise draw is a pure "
                        "function of (seed, application index)")
    # Serving plane (README "Serving"): the `serve` role's knobs. The
    # model identity (family/kwargs/vocab) normally comes from the
    # journal itself (self-describing since the serving PR); --model_type
    # + --config are the fallback for older recovery state.
    p.add_argument("--serve_poll", type=float, default=1.0,
                   help="serve role: seconds between checks of save_dir "
                        "for a newer published round (default 1.0)")
    p.add_argument("--serve_max_batch", type=int, default=64,
                   help="serve role: micro-batch doc cap — requests "
                        "coalesce up to this many docs per compiled "
                        "bucket program (default 64)")
    p.add_argument("--serve_max_queue", type=int, default=0,
                   help="serve role: bound on PENDING DOCS in the "
                        "batcher queue (0 = unbounded). Under sustained "
                        "overload a full queue sheds each ARRIVING "
                        "request alone — gRPC RESOURCE_EXHAUSTED / HTTP "
                        "429, counted as serving_requests_shed — so "
                        "queue depth and p99 stay bounded while "
                        "accepted requests never fail")
    p.add_argument("--serve_linger_ms", type=float, default=2.0,
                   help="serve role: how long an idle batcher waits for "
                        "company before dispatching a lone request "
                        "(fuller buckets vs added latency; default 2 ms)")
    p.add_argument("--serve_duration", type=float, default=0.0,
                   help="serve role: exit after this many seconds "
                        "(0 = serve until interrupted — production mode)")
    p.add_argument("--no_quality_gate", action="store_true",
                   help="serve role: swap in every published round, even "
                        "ones the coherence guard flagged (the gate is ON "
                        "by default; see README \"Serving\")")
    p.add_argument("--mesh_devices", type=int, default=0,
                   help="multi-device local training: 0/1 = the "
                        "single-device path; above 1 is not ported yet "
                        "(ROADMAP.md queue 1 item 6) and exits with code 2")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of this process's node (default: "
                        "the GPU; without CUDA the command fails unless "
                        "--device cpu asks for the CPU)")
    return p


def _refuse_mesh_devices(args: argparse.Namespace) -> None:
    """``--mesh_devices`` above 1 asks for one client over several devices,
    which the port does not have yet: exit with code 2 rather than train on
    one device under a multi-device flag."""
    n = int(getattr(args, "mesh_devices", 0) or 0)
    if n > 1:
        print(
            f"--mesh_devices {n}: one client over several devices is not "
            "ported yet (ROADMAP.md queue 1 item 6)", file=sys.stderr,
        )
        raise SystemExit(2)


def _device(args: argparse.Namespace):
    """Resolve ``--device`` as every port entry point does: ``None`` is the
    GPU, and a host without CUDA is an error, never a quiet CPU run."""
    from gfedntm_tpu_torch.device import resolve_device

    try:
        return resolve_device(getattr(args, "device", None))
    except (RuntimeError, ValueError) as err:
        raise SystemExit(f"--device: {err}")


def load_config(args: argparse.Namespace) -> GfedConfig:
    import dataclasses

    cfg = from_ini(args.config) if args.config else GfedConfig()
    train_over = {
        k: getattr(args, k)
        for k in ("num_epochs", "batch_size", "seed")
        if getattr(args, k) is not None
    }
    if train_over:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train_over))
    if args.n_components is not None:
        cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, n_components=args.n_components)
        )
    if args.max_iters is not None:
        cfg = cfg.replace(
            federation=dataclasses.replace(
                cfg.federation, max_iters=args.max_iters
            )
        )
    return cfg


def model_kwargs_from_config(cfg: GfedConfig, family: str) -> dict[str, Any]:
    """Flatten the typed config into AVITM/CTM constructor kwargs (the
    hyperparameter set the reference protofies at ``server.py:241-267``)."""
    m, t = cfg.model, cfg.train
    kwargs: dict[str, Any] = dict(
        n_components=m.n_components,
        model_type=m.model_type,
        hidden_sizes=tuple(m.hidden_sizes),
        activation=m.activation,
        dropout=m.dropout,
        learn_priors=m.learn_priors,
        topic_prior_mean=m.topic_prior_mean,
        topic_prior_variance=m.topic_prior_variance,
        batch_size=t.batch_size,
        lr=t.lr,
        momentum=t.momentum,
        solver=t.solver,
        num_epochs=t.num_epochs,
        num_samples=t.num_samples,
        reduce_on_plateau=t.reduce_on_plateau,
        seed=t.seed,
    )
    if family == "ctm":
        kwargs.update(
            contextual_size=m.contextual_size,
            label_size=m.label_size,
            inference_type=m.inference_type("ctm"),
            loss_weights={"beta": m.loss_beta_weight},
        )
    return kwargs


def _load_corpora(args: argparse.Namespace):
    """Resolve ``--source``/``--data_type``/``--fos`` into per-client corpora
    (simulate) plus optional synthetic ground truth."""
    from gfedntm_tpu_torch.data.loaders import (
        RawCorpus,
        load_parquet_corpus,
        partition_corpus,
    )
    from gfedntm_tpu_torch.data.synthetic import load_reference_npz

    if args.data_type == "synthetic":
        if args.source is None:
            raise SystemExit("--source <archive.npz> required for synthetic data")
        corpus = load_reference_npz(args.source)
        corpora = [RawCorpus(documents=n.documents) for n in corpus.nodes]
        return corpora, corpus
    if args.source is None:
        raise SystemExit("--source <corpus.parquet> required for real data")
    if args.fos and "," in args.fos:
        corpora = [
            load_parquet_corpus(args.source, fos=f.strip())
            for f in args.fos.split(",")
        ]
    else:
        one = load_parquet_corpus(args.source, fos=args.fos)
        corpora = partition_corpus(one, args.n_clients or 1)
    return corpora, None


# ---- roles -----------------------------------------------------------------

def _slo_specs_from_args(args: argparse.Namespace):
    """Parse ``--slo`` (file path or inline JSON) into validated specs;
    a malformed spec is a startup usage error, never a silently inert
    alerting plane."""
    spec = getattr(args, "slo", None)
    if not spec:
        return None
    from gfedntm_tpu_torch.utils.slo import load_slo_specs

    try:
        return load_slo_specs(spec)
    except ValueError as err:
        raise SystemExit(f"--slo: {err}")


def run_server(args: argparse.Namespace, cfg: GfedConfig) -> int:
    """``--id 0``: network federation server (``main.py:27-95``)."""
    from gfedntm_tpu_torch.federation.server import FederatedServer
    from gfedntm_tpu_torch.utils.observability import MetricsLogger, RoundProfiler

    device = _device(args)
    metrics = MetricsLogger(
        os.path.join(args.save_dir, "metrics.jsonl"), node="server"
    )
    profiler = (
        RoundProfiler(args.profile_dir, args.profile_rounds, metrics=metrics)
        if getattr(args, "profile_dir", None) else None
    )
    aggregator_kwargs = {}
    if getattr(args, "server_lr", None) is not None:
        if getattr(args, "aggregator", "fedavg") not in (
            "fedavgm", "fedadam", "fedyogi"
        ):
            raise SystemExit("--server_lr needs a server-optimizer "
                             "aggregator (fedavgm/fedadam/fedyogi)")
        aggregator_kwargs["server_lr"] = args.server_lr
    fault_injector = None
    if getattr(args, "chaos", None):
        # Process-level chaos harness hook: scripted faults on the
        # server's client stubs (partition personas, drops, delays).
        # Validation is eager and shared with the scenario engine's
        # persona loader — a typo'd spec (unknown method/kind/field,
        # negative delay) is a startup usage error, never an inert
        # injector that silently fires nothing.
        from gfedntm_tpu_torch.federation.resilience import build_fault_injector

        try:
            fault_injector = build_fault_injector(
                args.chaos, seed=0, metrics=metrics
            )
        except ValueError as err:
            raise SystemExit(f"--chaos: bad fault spec ({err})")
    server = FederatedServer(
        min_clients=args.min_clients_federation,
        family=args.model_type,
        model_kwargs=model_kwargs_from_config(cfg, args.model_type),
        grads_to_share=cfg.federation.grads_to_share,
        max_iters=cfg.federation.max_iters,
        save_dir=args.save_dir,
        local_steps=getattr(args, "local_steps", 1),
        metrics=metrics,
        checkpoint_every=getattr(args, "checkpoint_every", 25),
        probation_rounds=getattr(args, "probation_rounds", 3),
        quorum_fraction=getattr(args, "quorum_fraction", 0.5),
        aggregator=getattr(args, "aggregator", "fedavg"),
        aggregator_kwargs=aggregator_kwargs,
        robust_aggregator=getattr(args, "robust_aggregator", None),
        aggregation_backend=getattr(args, "agg_backend", "auto"),
        max_update_norm=getattr(args, "max_update_norm", None),
        outlier_mad_k=getattr(args, "outlier_mad_k", 4.0),
        divergence_patience=getattr(args, "divergence_patience", 3),
        wire_codec=getattr(args, "wire_codec", None) or "none",
        codec_ref_cache_max=getattr(args, "codec_ref_cache_max", 64),
        pacing_policy=getattr(args, "pacing", "sync"),
        cohort_size=getattr(args, "cohort_size", None),
        async_buffer=getattr(args, "async_buffer", None),
        staleness_alpha=getattr(args, "staleness_alpha", 0.5),
        pacing_seed=getattr(args, "pacing_seed", 0),
        journal_every=getattr(args, "journal_every", 1),
        relay_grace_rounds=getattr(args, "relay_grace_rounds", 0),
        fault_injector=fault_injector,
        ops_port=getattr(args, "ops_port", None),
        slo_specs=_slo_specs_from_args(args),
        fleet_max_nodes=getattr(args, "fleet_max_nodes", 512),
        fleet_max_series=getattr(args, "fleet_max_series", 512),
        profiler=profiler,
        quality_every=getattr(args, "quality_every", 0),
        quality_ref=getattr(args, "quality_ref", None),
        quality_topn=getattr(args, "quality_topn", 10),
        quality_guard=getattr(args, "quality_guard", False),
        dp=getattr(args, "dp", "off"),
        dp_clip=getattr(args, "dp_clip", 1.0),
        dp_sigma=getattr(args, "dp_sigma", 0.0),
        dp_delta=getattr(args, "dp_delta", 1e-5),
        dp_budget=getattr(args, "dp_budget", 0.0),
        dp_seed=getattr(args, "dp_seed", 0),
        dump_dir=getattr(args, "dump_dir", None),
        flightrec_entries=getattr(args, "flightrec_entries", 2048),
        flightrec_seconds=getattr(args, "flightrec_seconds", 300.0),
        device=device,
    )
    if getattr(args, "resume", False):
        from gfedntm_tpu_torch.train.checkpoint import CheckpointIntegrityError

        try:
            round_idx = server.restore_from_checkpoint()
        except (FileNotFoundError, CheckpointIntegrityError) as err:
            raise SystemExit(f"--resume: {err}")
        logging.info("resuming federation from round %d", round_idx)
    elif not getattr(args, "no_autorecover", False):
        # Zero-flag crash recovery (README "Crash recovery & sessions"):
        # an interrupted run's journal/checkpoint under save_dir resumes
        # automatically — no operator intervention after a server kill.
        from gfedntm_tpu_torch.train.checkpoint import CheckpointIntegrityError

        try:
            round_idx = server.maybe_autorecover()
        except CheckpointIntegrityError as err:
            raise SystemExit(
                f"auto-recovery found corrupt state: {err} (start with "
                "--no_autorecover to ignore it and begin fresh)"
            )
        if round_idx is not None:
            logging.info(
                "auto-recovered federation from round %d", round_idx
            )
    port = args.listen_port if args.listen_port is not None else 50051
    server.start(f"[::]:{port}")
    logging.info("server on port %d; waiting for federation", port)
    server.wait_done()
    server.stop()
    metrics.close()
    return 0


def run_client(args: argparse.Namespace, cfg: GfedConfig) -> int:
    """``--id N``: network federation client (``main.py:98-175``)."""
    from gfedntm_tpu_torch.data.loaders import RawCorpus, load_parquet_corpus
    from gfedntm_tpu_torch.data.synthetic import load_reference_npz
    from gfedntm_tpu_torch.federation.client import Client

    if args.id is None or args.id < 1:
        raise SystemExit(
            "--role client needs --id >= 1 (client ids start at 1; "
            "0 is the server)"
        )
    _refuse_mesh_devices(args)
    device = _device(args)
    if args.source is None:
        raise SystemExit(
            "--source required (synthetic .npz archive or .parquet corpus)"
        )
    if args.data_type == "synthetic":
        archive = load_reference_npz(args.source)
        node = archive.nodes[(args.id - 1) % len(archive.nodes)]
        corpus = RawCorpus(documents=node.documents)
    else:
        corpus = load_parquet_corpus(args.source, fos=args.fos)

    port = (
        args.listen_port if args.listen_port is not None else 50051 + args.id
    )
    from gfedntm_tpu_torch.utils.observability import MetricsLogger, RoundProfiler

    save_dir = os.path.join(args.save_dir, f"client{args.id}")
    metrics = MetricsLogger(
        os.path.join(save_dir, "metrics.jsonl"), node=f"client{args.id}"
    )
    profiler = (
        RoundProfiler(args.profile_dir, args.profile_rounds, metrics=metrics)
        if getattr(args, "profile_dir", None) else None
    )
    # --server_addrs: ordered failover endpoints; the head is the
    # primary, the tail is tried in order once the reconnect window
    # against the current endpoint expires (member re-homing).
    addrs = [
        a.strip()
        for a in (getattr(args, "server_addrs", None) or "").split(",")
        if a.strip()
    ]
    primary = addrs[0] if addrs else args.server_address
    client = Client(
        client_id=args.id,
        corpus=corpus,
        server_address=primary,
        failover_addrs=addrs[1:],
        listen_address=f"[::]:{port}",
        max_features=cfg.data.max_features,
        stop_words=cfg.data.stop_words,
        save_dir=save_dir,
        metrics=metrics,
        liveness_timeout=getattr(args, "liveness_timeout", 300.0),
        reconnect_window=getattr(args, "reconnect_window", 180.0),
        wire_codec=getattr(args, "wire_codec", None) or "auto",
        profiler=profiler,
        mesh_devices=getattr(args, "mesh_devices", 0) or 0,
        dp=getattr(args, "dp", "off"),
        dp_clip=getattr(args, "dp_clip", 1.0),
        dp_sigma=getattr(args, "dp_sigma", 0.0),
        dp_delta=getattr(args, "dp_delta", 1e-5),
        dp_budget=getattr(args, "dp_budget", 0.0),
        dp_seed=getattr(args, "dp_seed", 0),
        dump_dir=getattr(args, "dump_dir", None),
        flightrec_entries=getattr(args, "flightrec_entries", 2048),
        flightrec_seconds=getattr(args, "flightrec_seconds", 300.0),
        device=device,
    )
    client.run()
    client.shutdown()
    metrics.close()
    return 0


def run_relay(args: argparse.Namespace, cfg: GfedConfig) -> int:
    """``--role relay``: mid-tier aggregator — terminates
    ``--min_clients_federation`` members, pre-reduces their admitted
    updates into one pseudo-update, and joins the upstream server as
    client ``--id`` (README "Hierarchical federation & wire
    efficiency")."""
    from gfedntm_tpu_torch.federation.relay import RelayNode
    from gfedntm_tpu_torch.utils.observability import MetricsLogger

    if args.id is None or args.id < 1:
        raise SystemExit(
            "--role relay needs --id >= 1 (the relay's upstream client "
            "identity)"
        )
    device = _device(args)
    save_dir = os.path.join(args.save_dir, f"relay{args.id}")
    metrics = MetricsLogger(
        os.path.join(save_dir, "metrics.jsonl"), node=f"relay{args.id}"
    )
    # Distinct default base from the client scheme (50051+id): a relay
    # and its shard's member ids share the 1..N space, so relay 1 and
    # client 1 on one host would otherwise race for the same port.
    port = (
        args.listen_port if args.listen_port is not None else 51051 + args.id
    )
    relay = RelayNode(
        relay_id=args.id,
        upstream_address=args.server_address,
        min_members=args.min_clients_federation,
        listen_address=f"[::]:{port}",
        metrics=metrics,
        outlier_mad_k=getattr(args, "outlier_mad_k", 4.0),
        max_update_norm=getattr(args, "max_update_norm", None),
        probation_rounds=getattr(args, "probation_rounds", 3),
        wire_codec=getattr(args, "wire_codec", None) or "auto",
        save_dir=save_dir,
        journal_every=getattr(args, "journal_every", 1),
        liveness_timeout=getattr(args, "liveness_timeout", 300.0),
        reconnect_window=getattr(args, "reconnect_window", 180.0),
        dump_dir=getattr(args, "dump_dir", None),
        flightrec_entries=getattr(args, "flightrec_entries", 2048),
        flightrec_seconds=getattr(args, "flightrec_seconds", 300.0),
        device=device,
    )
    if not getattr(args, "no_autorecover", False):
        # Zero-flag shard recovery: a respawned relay with identical
        # argv restores its registry/round/session from the shard
        # journal before serving, so member token-reconnects and the
        # upstream session re-present just work.
        from gfedntm_tpu_torch.train.checkpoint import CheckpointIntegrityError

        try:
            round_idx = relay.maybe_autorecover()
        except CheckpointIntegrityError as err:
            raise SystemExit(
                f"relay auto-recovery found corrupt state: {err} (start "
                "with --no_autorecover to ignore it and begin fresh)"
            )
        if round_idx is not None:
            logging.info(
                "auto-recovered relay %d shard from round %d",
                args.id, round_idx,
            )
    relay.start()
    logging.info("relay %d waiting for its shard + upstream", args.id)
    relay.wait_done()
    relay.shutdown()
    metrics.close()
    return 0


def run_serve(args: argparse.Namespace, cfg: GfedConfig) -> int:
    """``--role serve``: the topic-inference serving plane (README
    "Serving") — load the newest published round from ``save_dir``'s
    journal/checkpoint store, hot-swap as the federation publishes newer
    ones (refusing coherence-flagged candidates), and answer doc→θ
    queries over gRPC ``Infer`` plus the ops-HTTP ``/infer`` route."""
    from gfedntm_tpu_torch.serving import ServingPlane
    from gfedntm_tpu_torch.utils.observability import MetricsLogger

    device = _device(args)
    save_dir = os.path.join(args.save_dir, "serve")
    metrics = MetricsLogger(
        os.path.join(save_dir, "metrics.jsonl"), node="serve"
    )
    plane = ServingPlane(
        args.save_dir,
        family=args.model_type,
        model_kwargs=model_kwargs_from_config(cfg, args.model_type),
        max_batch=getattr(args, "serve_max_batch", 64),
        linger_s=getattr(args, "serve_linger_ms", 2.0) / 1e3,
        max_queue=getattr(args, "serve_max_queue", 0),
        poll_s=getattr(args, "serve_poll", 1.0),
        quality_gate=not getattr(args, "no_quality_gate", False),
        metrics=metrics,
        ops_port=getattr(args, "ops_port", None),
        slo_specs=_slo_specs_from_args(args),
        dump_dir=getattr(args, "dump_dir", None),
        flightrec_entries=getattr(args, "flightrec_entries", 2048),
        flightrec_seconds=getattr(args, "flightrec_seconds", 300.0),
        device=device,
    )
    # Distinct default base from the client (50051+id) and relay
    # (51051+id) schemes so a co-hosted serving plane never collides.
    port = args.listen_port if args.listen_port is not None else 52051
    plane.start(f"[::]:{port}")
    logging.info(
        "serving plane on gRPC port %d (ops %s); watching %s",
        plane.bound_port, plane.ops_actual_port, args.save_dir,
    )
    duration = getattr(args, "serve_duration", 0.0) or 0.0
    try:
        if duration > 0:
            import time

            time.sleep(duration)
        else:
            while not plane.wait(timeout=3600.0):
                pass
    except KeyboardInterrupt:
        logging.info("serving plane interrupted; draining")
    finally:
        plane.stop()
        metrics.snapshot_registry()
        metrics.close()
    return 0


def run_simulate(args: argparse.Namespace, cfg: GfedConfig) -> int:
    """No ``--id``: the whole federation in this process through
    ``FederatedTrainer`` on ``--device`` — no server process, no RPC
    (SURVEY.md §7.1)."""
    from gfedntm_tpu_torch.data.datasets import BowDataset
    from gfedntm_tpu_torch.eval.metrics import (
        convert_topic_word_to_init_size,
        topic_similarity_score,
    )
    from gfedntm_tpu_torch.federated.consensus import run_vocab_consensus
    from gfedntm_tpu_torch.federated.trainer import FederatedTrainer
    from gfedntm_tpu_torch.models.avitm import AVITM
    from gfedntm_tpu_torch.models.ctm import CTM
    from gfedntm_tpu_torch.utils.observability import (
        MetricsLogger,
        phase_timer,
        trace,
    )

    _refuse_mesh_devices(args)
    device = _device(args)
    corpora, synthetic = _load_corpora(args)
    if synthetic is not None and args.model_type == "ctm":
        raise SystemExit(
            "--model_type ctm needs contextual embeddings; synthetic .npz "
            "archives carry none (use --data_type real with an 'embeddings' "
            "parquet column, as the reference does)"
        )
    n_clients = len(corpora)
    metrics = MetricsLogger(
        os.path.join(args.save_dir, "metrics.jsonl"), node="simulate"
    )

    with phase_timer(metrics, "consensus"):
        if synthetic is not None:
            # fixed wd-token vocabulary: skip tokenization, reuse the BoW
            idx2token = dict(enumerate(synthetic.vocab_tokens))
            datasets = [
                BowDataset(X=n.bow, idx2token=idx2token)
                for n in synthetic.nodes
            ]
            vocab_size = len(synthetic.vocab_tokens)
        else:
            consensus = run_vocab_consensus(
                corpora,
                max_features=cfg.data.max_features,
                stop_words=cfg.data.stop_words,
                contextual=args.model_type == "ctm",
                label_size=cfg.model.label_size,
            )
            datasets = consensus.datasets
            vocab_size = len(consensus.global_vocab)

    kwargs = model_kwargs_from_config(cfg, args.model_type)
    kwargs["input_size"] = vocab_size
    kwargs["device"] = device
    template = (
        AVITM(**kwargs) if args.model_type == "avitm" else CTM(**kwargs)
    )
    trainer = FederatedTrainer(
        template,
        n_clients=n_clients,
        grads_to_share=cfg.federation.grads_to_share,
        max_iters=cfg.federation.max_iters,
        seed=cfg.train.seed,
        local_steps=getattr(args, "local_steps", 1),
        device=device,
    )
    with phase_timer(metrics, "federated_fit", n_clients=n_clients):
        # One process has no round loop to window — --profile_dir wraps
        # the whole federated fit in one torch.profiler capture.
        with trace(getattr(args, "profile_dir", None), device):
            result = trainer.fit(datasets, metrics=metrics)

    global_model = trainer.make_global_model(result)
    global_model.train_data = datasets[0]
    summary: dict[str, Any] = {
        "n_clients": n_clients,
        "vocab_size": vocab_size,
        "global_steps": int(result.losses.shape[0]),
        "final_mean_loss": float(result.losses[-1].mean()),
    }
    os.makedirs(args.save_dir, exist_ok=True)
    from gfedntm_tpu_torch.utils.serialization import save_model_as_npz

    save_model_as_npz(
        args.save_dir,
        betas=global_model.get_topic_word_distribution(),
        thetas=None,
        topics=global_model.get_topics(),
        n_components=template.n_components,
        name="global_model",
    )
    for c in range(n_clients):
        client_model = trainer.make_client_model(result, c, datasets[c])
        thetas = client_model.get_doc_topic_distribution(
            datasets[c], cfg.train.num_samples
        )
        thetas = np.where(thetas < cfg.train.thetas_thr, 0.0, thetas)
        norm = thetas.sum(axis=1, keepdims=True)
        thetas /= np.where(norm == 0, 1.0, norm)
        save_model_as_npz(
            os.path.join(args.save_dir, f"client{c + 1}"),
            betas=client_model.get_topic_word_distribution(),
            thetas=thetas,
            topics=client_model.get_topics(),
            n_components=template.n_components,
        )

    if synthetic is not None:
        betas = convert_topic_word_to_init_size(
            synthetic.topic_vectors.shape[1],
            global_model.get_topic_word_distribution(),
            dict(enumerate(synthetic.vocab_tokens)),
        )
        summary["tss"] = topic_similarity_score(
            betas, synthetic.topic_vectors
        )
    metrics.log("summary", **summary)
    metrics.snapshot_registry()
    metrics.close()
    print(json.dumps(summary))
    return 0


# ---- telemetry report (`summarize` subcommand) ------------------------------

def _read_node_records(
    paths: list[str],
) -> "tuple[dict[str, list[dict[str, Any]]], str]":
    """Read several per-node metrics.jsonl streams keyed by node name
    (the ``node`` field each logger stamps, falling back to the parent
    directory name) — shared by the summarize/report wire-tier view.
    Each stream is read exactly once; also returns the FIRST path's node
    name so callers can pull its records back out as the primary
    stream."""
    from gfedntm_tpu_torch.utils.observability import read_metrics

    node_records: dict[str, list[dict[str, Any]]] = {}
    first_node = ""
    for i, path in enumerate(paths):
        try:
            records = read_metrics(path)
        except FileNotFoundError:
            raise SystemExit(f"no such metrics file: {path}")
        node = _node_name_for(path, records)
        if i == 0:
            first_node = node
        node_records.setdefault(node, []).extend(records)
    return node_records, first_node


def run_summarize(argv: list[str]) -> int:
    """``summarize <metrics.jsonl>...``: render a run report from the
    telemetry stream (phase breakdown, p50/p95/p99 step time, bytes per
    round, slowest client); ``--json <path>`` also writes the aggregate
    dict. Extra paths (relay/client streams of a hierarchical run) add a
    per-tier wire-accounting table — bytes and compression ratio per
    relay vs root, reproducible from JSONL alone."""
    p = argparse.ArgumentParser(
        prog="gfedntm-tpu summarize",
        description="Render a run report from telemetry metrics.jsonl "
                    "streams (first = the primary report; all streams "
                    "feed the per-tier wire table).",
    )
    p.add_argument("paths", nargs="+",
                   help="per-node metrics.jsonl files (server first, "
                        "then relays/clients for per-tier wire "
                        "accounting)")
    p.add_argument("--json", dest="json_out", default=None,
                   help="also write the aggregated summary dict as JSON")
    args = p.parse_args(argv)

    from gfedntm_tpu_torch.utils.observability import (
        collect_wire_tiers,
        format_privacy_line,
        format_report,
        format_wire_tiers,
        summarize_metrics,
        summarize_privacy,
    )

    # One read per stream: the primary report comes from the FIRST
    # path's records, pulled back out of the same node map the tier
    # table uses (re-reading a large server stream would double the
    # cost).
    node_records, first_node = _read_node_records(args.paths)
    summary = summarize_metrics(node_records.get(first_node, []))
    tiers = collect_wire_tiers(node_records)
    summary["wire_tiers"] = tiers
    summary["privacy"] = summarize_privacy(
        node_records.get(first_node, [])
    )
    if args.json_out:
        os.makedirs(
            os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True
        )
        with open(args.json_out, "w") as fh:
            json.dump(summary, fh, indent=1, default=float)
    print(format_report(summary))
    if summary["privacy"]:
        print()
        print(format_privacy_line(summary["privacy"]))
    print()
    print(format_wire_tiers(tiers))
    return 0


# ---- model-health report (`report` subcommand) ------------------------------

def run_report(argv: list[str]) -> int:
    """``report <metrics.jsonl>``: render a round-by-round model-health
    report from the telemetry stream — coherence/diversity/drift
    trajectory, per-client contribution table, admission-gate rejections,
    rollbacks (README "Model-quality observability"). With
    ``--assert-monotone-coherence <tol>`` the command exits non-zero when
    NPMI ever falls more than ``tol`` below its running peak, so CI and
    the scenario harness can gate on model quality."""
    p = argparse.ArgumentParser(
        prog="gfedntm-tpu report",
        description="Render a model-quality report from a run's "
                    "metrics.jsonl (requires the run to have used "
                    "--quality_every > 0).",
    )
    p.add_argument("paths", nargs="+", metavar="path",
                   help="metrics.jsonl streams (quality events come from "
                        "the server's; extra relay/client streams feed "
                        "the per-tier wire table)")
    p.add_argument("--json", dest="json_out", default=None,
                   help="also write the aggregated quality dict as JSON")
    p.add_argument("--assert-monotone-coherence", dest="monotone_tol",
                   type=float, default=None, metavar="TOL",
                   help="fail (exit 1) if NPMI coherence ever drops more "
                        "than TOL below its running maximum")
    args = p.parse_args(argv)

    from gfedntm_tpu_torch.utils.observability import (
        check_monotone_coherence,
        collect_wire_tiers,
        format_quality_report,
        format_wire_tiers,
        summarize_model_quality,
        summarize_privacy,
    )

    node_records, _first = _read_node_records(args.paths)
    records = [r for recs in node_records.values() for r in recs]
    summary = summarize_model_quality(records)
    summary["privacy"] = summarize_privacy(records)
    tiers = collect_wire_tiers(node_records)
    summary["wire_tiers"] = tiers
    if args.json_out:
        os.makedirs(
            os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True
        )
        with open(args.json_out, "w") as fh:
            json.dump(summary, fh, indent=1, default=float)
    print(format_quality_report(summary))
    if len(args.paths) > 1:
        print()
        print(format_wire_tiers(tiers))
    if args.monotone_tol is not None:
        violations = check_monotone_coherence(summary, args.monotone_tol)
        if violations:
            for v in violations:
                print(f"coherence check FAILED: {v}", file=sys.stderr)
            return 1
        print(
            f"coherence check passed (tolerance {args.monotone_tol:g})"
        )
    return 0


# ---- scenario matrix (`scenarios` subcommand) -------------------------------

def run_scenarios(argv: list[str]) -> int:
    """``scenarios``: run the scenario matrix — real in-process
    federations under composed data personas (Dirichlet-α non-IID,
    vocabulary skew, client-size imbalance), fault personas (slow
    network, partition, flapping, server crash), policy axes (pacing ×
    aggregator × robust estimator), and workloads (AVITM, CTM) — and
    assert each cell's graceful-degradation contracts against its
    no-fault baseline twin (README "Scenario matrix"). Exits non-zero
    when any contract is red, so CI can gate on composition, not just
    on each resilience plane in isolation. The JAX subcommand's parser,
    output lines, revision label and exit codes, plus ``--device`` for
    every node of every cell (default the GPU; without CUDA the command
    fails unless ``--device cpu`` asks for the CPU)."""
    p = argparse.ArgumentParser(
        prog="gfedntm-tpu scenarios",
        description="Run the scenario matrix and assert per-cell "
                    "graceful-degradation contracts.",
    )
    p.add_argument("--cells", default=None,
                   help="comma-separated cell names to run (default: the "
                        "whole matrix); a faulted cell automatically "
                        "pulls in its no-fault baseline twin")
    p.add_argument("--list", action="store_true", dest="list_cells",
                   help="list the matrix cells and exit")
    p.add_argument("--workdir", default="output/scenarios",
                   help="per-cell save dirs + the harness metrics.jsonl "
                        "(default output/scenarios)")
    p.add_argument("--out", default=None,
                   help="write the BENCH_SCENARIO artifact JSON here "
                        "(schema kind 'scenario_bench')")
    p.add_argument("--fast", action="store_true",
                   help="shrink every cell (fewer docs/epochs) — the "
                        "check.sh SCENARIO=1 smoke regime")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of every node of every cell (default: "
                        "the GPU; without CUDA the command fails unless "
                        "--device cpu asks for the CPU)")
    args = p.parse_args(argv)

    from gfedntm_tpu_torch.scenarios import (
        cell_bench_row,
        default_matrix,
        emit_artifact,
        run_matrix,
    )

    cells = default_matrix()
    if args.list_cells:
        for c in cells:
            print(
                f"{c.name:28s} workload={c.workload:5s} data={c.data:24s} "
                f"fault={c.fault:12s} pacing={c.pacing:8s} "
                f"agg={c.aggregator}"
                + (f"+{c.robust}" if c.robust else "")
                + (f" codec={c.wire_codec}" if c.wire_codec != "none"
                   else "")
            )
        return 0
    if args.cells:
        wanted = [n.strip() for n in args.cells.split(",") if n.strip()]
        known = {c.name for c in cells}
        unknown = [n for n in wanted if n not in known]
        if unknown:
            raise SystemExit(
                f"unknown cell name(s) {unknown}; run with --list to see "
                "the matrix"
            )
        cells = [c for c in cells if c.name in wanted]
    device = _device(args)

    from gfedntm_tpu_torch.utils.observability import MetricsLogger

    os.makedirs(args.workdir, exist_ok=True)
    metrics = MetricsLogger(
        os.path.join(args.workdir, "metrics.jsonl"), node="scenarios",
        validate=True,
    )
    try:
        results = run_matrix(
            cells, args.workdir, fast=args.fast, metrics=metrics,
            device=device,
        )
    finally:
        metrics.snapshot_registry()
        metrics.close()

    for res in results:
        print(json.dumps(cell_bench_row(res), default=float))
    ok = all(r.ok for r in results)
    if args.out:
        # Artifact revision label, matching the BENCH_* convention
        # ("r01"): taken from the output filename's rNN suffix.
        m = re.search(r"_r(\d+)\.json$", os.path.basename(args.out))
        rev = f"r{m.group(1)}" if m else "r00"
        artifact = emit_artifact(results, rev=rev)
        out_dir = os.path.dirname(os.path.abspath(args.out))
        os.makedirs(out_dir, exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(artifact, fh, indent=1, default=float)
            fh.write("\n")
        print(f"wrote {args.out}: {len(results)} cells, "
              f"all_contracts_green={artifact['acceptance']['all_contracts_green']}")
    if not ok:
        for res in results:
            for name, verdict in res.contracts.items():
                if not verdict["ok"]:
                    print(
                        f"contract FAILED: {res.cell.name}.{name}: "
                        f"{verdict['detail']}",
                        file=sys.stderr,
                    )
        return 1
    return 0


# ---- cross-node trace merge (`trace` subcommand) ----------------------------

def _node_name_for(path: str, records: list[dict[str, Any]]) -> str:
    """A stream's node identity: the ``node`` field its logger stamped, or
    (pre-plane streams) the metrics file's parent directory name."""
    for r in records:
        node = r.get("node")
        if isinstance(node, str) and node:
            return node
    parent = os.path.basename(os.path.dirname(os.path.abspath(path)))
    return parent or os.path.splitext(os.path.basename(path))[0]


def run_trace(argv: list[str]) -> int:
    """``trace <metrics.jsonl>...``: merge per-node telemetry streams into
    one Chrome trace-event JSON (open in Perfetto / chrome://tracing),
    aligning each node's wall clock onto the reference node's via the
    paired RPC send/recv stamps (README "Distributed tracing & ops
    endpoint")."""
    p = argparse.ArgumentParser(
        prog="gfedntm-tpu trace",
        description="Merge per-node metrics.jsonl streams into one "
                    "Perfetto-loadable Chrome trace-event file.",
    )
    p.add_argument("paths", nargs="+",
                   help="per-node metrics.jsonl files (server + clients)")
    p.add_argument("-o", "--out", default="trace.json",
                   help="output Chrome trace-event JSON (default "
                        "trace.json)")
    p.add_argument("--reference", default=None,
                   help="node whose clock anchors the merge (default: the "
                        "node owning the 'round' spans)")
    args = p.parse_args(argv)

    from gfedntm_tpu_torch.utils.observability import merge_chrome_trace

    node_records, _first = _read_node_records(args.paths)
    try:
        trace = merge_chrome_trace(node_records, reference=args.reference)
    except ValueError as err:
        raise SystemExit(f"trace merge failed: {err}")
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(trace, fh, default=float)
    meta = trace["otherData"]
    n_spans = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")
    offsets = ", ".join(
        f"{node}{off:+.3f}s"
        for node, off in meta["clock_offsets_s"].items()
        if node != meta["reference"]
    )
    print(
        f"wrote {args.out}: {n_spans} spans from {len(node_records)} nodes "
        f"(reference {meta['reference']!r}"
        + (f"; clock offsets: {offsets}" if offsets else "")
        + ") — open in https://ui.perfetto.dev"
    )
    return 0


def run_slo(argv: list[str]) -> int:
    """``slo --slo <spec> <metrics.jsonl>...``: evaluate SLO specs
    offline against recorded telemetry — the per-node
    ``metrics_snapshot`` streams replay in global time order through the
    SAME FleetRegistry + SLOEngine the live planes run, so an objective
    that holds live holds here and vice versa. Exits 1 when any spec
    ever fired (the ``--assert-monotone-coherence`` CI-gate pattern,
    generalized to arbitrary declarative objectives)."""
    p = argparse.ArgumentParser(
        prog="gfedntm-tpu slo",
        description="Evaluate SLO specs offline from recorded "
                    "metrics.jsonl streams (exit 1 if any alert fired).",
    )
    p.add_argument("paths", nargs="+",
                   help="per-node metrics.jsonl files (server + relays + "
                        "clients; snapshots merge exactly like the live "
                        "fleet view)")
    p.add_argument("--slo", required=True,
                   help="SLO spec JSON: a file path or inline JSON (list "
                        "of specs, or {'slos': [...]})")
    p.add_argument("--json", dest="json_out", default=None,
                   help="also write the final alert states as JSON")
    args = p.parse_args(argv)

    from gfedntm_tpu_torch.utils.slo import evaluate_stream, load_slo_specs

    try:
        specs = load_slo_specs(args.slo)
    except ValueError as err:
        raise SystemExit(f"--slo: {err}")
    if not specs:
        raise SystemExit("--slo: no specs to evaluate")
    node_records, _first = _read_node_records(args.paths)
    engine = evaluate_stream(node_records, specs)
    status = engine.status()
    if args.json_out:
        os.makedirs(
            os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True
        )
        with open(args.json_out, "w") as fh:
            json.dump(status, fh, indent=1, default=float)
    fired = engine.ever_fired()
    for alert in status["alerts"]:
        verdict = "FIRED" if alert["alert"] in fired else "ok"
        value = alert["value"]
        shown = f"{value:.6g}" if isinstance(value, float) else value
        print(
            f"{verdict:>5}  {alert['alert']}: {alert['objective']} "
            f"(last value {shown}, final state {alert['state']})"
        )
    if fired:
        print(
            f"SLO check FAILED: {len(fired)} alert(s) fired "
            f"({', '.join(sorted(fired))})", file=sys.stderr,
        )
        return 1
    print(f"SLO check passed ({len(specs)} objective(s) held)")
    return 0


def run_privacy(argv: list[str]) -> int:
    """``privacy <metrics.jsonl>...``: replay a run's privacy ledger
    offline — the per-round ``privacy_budget`` events the server's
    accountant logged — and gate on it (the ``slo`` offline CI-gate
    pattern). Exits 1 when the declared (or ``--budget``-overridden)
    epsilon budget was exceeded, or when the ledger is non-monotone
    (an epsilon that ever DECREASES means the accountant state was
    reset mid-run — e.g. a recovery path that dropped the ledger —
    which silently under-reports the true privacy cost)."""
    p = argparse.ArgumentParser(
        prog="gfedntm-tpu privacy",
        description="Replay the (eps, delta) privacy ledger from "
                    "recorded metrics.jsonl streams (exit 1 if the "
                    "budget was exceeded or the ledger is non-monotone).",
    )
    p.add_argument("paths", nargs="+",
                   help="per-node metrics.jsonl files (the server's "
                        "stream carries the privacy_budget ledger)")
    p.add_argument("--budget", type=float, default=None,
                   help="epsilon budget to enforce (default: each "
                        "event's own declared budget field)")
    p.add_argument("--json", dest="json_out", default=None,
                   help="also write the final ledger state as JSON")
    args = p.parse_args(argv)

    node_records, _first = _read_node_records(args.paths)
    ledger = sorted(
        (r for recs in node_records.values() for r in recs
         if r.get("event") == "privacy_budget"),
        key=lambda r: (float(r.get("time", 0.0)), int(r.get("round", 0))),
    )
    exceeded_events = [
        r for recs in node_records.values() for r in recs
        if r.get("event") == "privacy_budget_exceeded"
    ]
    if not ledger:
        if args.budget is not None:
            print(
                "privacy check FAILED: --budget declared but the stream "
                "has no privacy_budget events (was the run --dp off?)",
                file=sys.stderr,
            )
            return 1
        print("no privacy_budget events — nothing to check")
        return 0

    failures: list[str] = []
    prev_eps = 0.0
    for r in ledger:
        eps = float(r.get("eps", 0.0))
        if eps + 1e-12 < prev_eps:
            failures.append(
                f"ledger not monotone: eps fell {prev_eps:.6g} -> "
                f"{eps:.6g} at round {r.get('round')} (accountant state "
                "was reset mid-run)"
            )
            break
        prev_eps = eps
    last = ledger[-1]
    final_eps = float(last.get("eps", 0.0))
    budget = (
        args.budget if args.budget is not None
        else float(last.get("budget", 0.0))
    )
    if budget > 0.0 and final_eps > budget:
        failures.append(
            f"budget exceeded: final eps {final_eps:.6g} > budget "
            f"{budget:.6g} (delta {last.get('delta')})"
        )
    elif args.budget is None and exceeded_events:
        failures.append(
            f"run logged {len(exceeded_events)} privacy_budget_exceeded "
            "event(s)"
        )
    state = {
        "rounds": len(ledger),
        "eps": final_eps,
        "delta": float(last.get("delta", 0.0)),
        "steps": int(last.get("steps", len(ledger))),
        "mode": last.get("mode"),
        "sigma": float(last.get("sigma", 0.0)),
        "budget": budget,
        "failures": failures,
    }
    if args.json_out:
        os.makedirs(
            os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True
        )
        with open(args.json_out, "w") as fh:
            json.dump(state, fh, indent=1, default=float)
    print(
        f"privacy ledger: {len(ledger)} round(s), mode "
        f"{state['mode']}, final eps {final_eps:.6g} at delta "
        f"{state['delta']:g} (sigma {state['sigma']:g}, budget "
        + (f"{budget:g})" if budget > 0 else "untracked)")
    )
    if failures:
        for f in failures:
            print(f"privacy check FAILED: {f}", file=sys.stderr)
        return 1
    print("privacy check passed")
    return 0


# ---- incident forensics (`incident` subcommand) -----------------------------

def _collect_bundle_paths(paths: list[str]) -> list[str]:
    """Expand the CLI's path arguments into bundle files: a directory
    contributes every ``inc-*.json`` inside it, a file contributes
    itself. Missing paths are loud — a postmortem run against a typo'd
    dump dir must not silently report 'no incidents'."""
    from gfedntm_tpu_torch.utils.flightrec import BUNDLE_PREFIX

    out: list[str] = []
    for path in paths:
        if os.path.isdir(path):
            out.extend(
                os.path.join(path, n)
                for n in sorted(os.listdir(path))
                if n.startswith(BUNDLE_PREFIX) and n.endswith(".json")
            )
        elif os.path.exists(path):
            out.append(path)
        else:
            raise SystemExit(f"no such bundle file or directory: {path}")
    return out


def _implicated_clients(records: list[dict]) -> dict[int, list[str]]:
    """Client ids the incident's merged record set implicates, with why:
    probation/quarantine transitions (logger events) and rejected/clipped
    gate verdicts (flight-ring notes the JSONL stream never carried)."""
    implicated: dict[int, set] = {}
    for r in records:
        if not isinstance(r, dict):
            continue
        client = r.get("client")
        if client is None:
            continue
        event = r.get("event")
        if event in ("client_suspect", "client_quarantined",
                     "client_dropped"):
            implicated.setdefault(int(client), set()).add(event)
        elif r.get("kind") == "gate_verdict" and r.get("verdict") in (
            "rejected", "clipped"
        ):
            why = r.get("reason") or r.get("verdict")
            implicated.setdefault(int(client), set()).add(
                f"gate:{why}"
            )
    return {cid: sorted(v) for cid, v in sorted(implicated.items())}


def _format_ring_record(r: dict) -> str:
    """One timeline line's payload: the event/kind label plus its fields,
    long values truncated, trace plumbing and bulk payloads elided."""
    label = r.get("event") or r.get("kind") or "?"
    skip = {"time", "event", "kind", "node", "span_id", "parent_id",
            "trace_id", "remote_parent_id", "metrics", "stacks"}
    parts = []
    for k, v in r.items():
        if k in skip:
            continue
        s = f"{v:.6g}" if isinstance(v, float) else str(v)
        if len(s) > 48:
            s = s[:45] + "..."
        parts.append(f"{k}={s}")
    return f"{label} " + " ".join(parts) if parts else label


def run_incident(argv: list[str]) -> int:
    """``incident <bundle-or-dump-dir>...``: merge the incident bundles
    the flight-recorder plane dumped (``--dump_dir``) into one causal,
    clock-aligned postmortem per incident id — the trigger, the
    implicated clients, each node's pre-trigger ring (gate verdicts,
    retry decisions, pacing math), NTP-style clock offsets from the ring
    spans' paired RPC stamps. ``--trace_out`` additionally renders the
    rings' spans as one Chrome trace. ``--assert-no-incidents`` is the
    CI-gate mode (the ``slo``/``privacy`` pattern): exit 1 the moment
    ANY bundle exists under the given paths."""
    p = argparse.ArgumentParser(
        prog="gfedntm-tpu incident",
        description="Merge flight-recorder incident bundles into "
                    "clock-aligned postmortem timelines.",
    )
    p.add_argument("paths", nargs="+",
                   help="incident bundle files and/or --dump_dir "
                        "directories (every node's bundles for an "
                        "incident — local + remotely captured — group "
                        "by incident id)")
    p.add_argument("--json", dest="json_out", default=None,
                   help="also write the merged incident report as JSON")
    p.add_argument("--trace_out", default=None,
                   help="also write the bundles' ring spans as one "
                        "merged Chrome trace-event JSON (Perfetto)")
    p.add_argument("--limit", type=int, default=40,
                   help="merged timeline records printed per incident "
                        "(default 40; the JSON report is never truncated)")
    p.add_argument("--assert-no-incidents", dest="assert_none",
                   action="store_true",
                   help="CI gate: exit 1 if any incident bundle exists "
                        "under the given paths (exit 0 on a clean dir)")
    args = p.parse_args(argv)

    from gfedntm_tpu_torch.utils.flightrec import BUNDLE_SCHEMA
    from gfedntm_tpu_torch.utils.observability import estimate_clock_offset

    bundle_paths = _collect_bundle_paths(args.paths)
    if args.assert_none:
        if bundle_paths:
            print(
                f"incident check FAILED: {len(bundle_paths)} incident "
                "bundle(s) present:", file=sys.stderr,
            )
            for path in bundle_paths:
                print(f"  {path}", file=sys.stderr)
            return 1
        print("incident check passed (no bundles)")
        return 0
    if not bundle_paths:
        print("no incident bundles found")
        return 0

    bundles: list[dict] = []
    for path in bundle_paths:
        try:
            with open(path) as fh:
                bundle = json.load(fh)
        except (OSError, json.JSONDecodeError) as err:
            raise SystemExit(f"unreadable bundle {path}: {err}")
        if not isinstance(bundle, dict):
            raise SystemExit(f"bundle {path} is not a JSON object")
        if int(bundle.get("schema", 0)) != BUNDLE_SCHEMA:
            print(
                f"skipping {path}: unknown bundle schema "
                f"{bundle.get('schema')!r} (this CLI knows "
                f"{BUNDLE_SCHEMA})", file=sys.stderr,
            )
            continue
        bundles.append(bundle)

    incidents: dict[str, list[dict]] = {}
    for b in bundles:
        incidents.setdefault(str(b.get("incident_id")), []).append(b)

    report: list[dict[str, Any]] = []
    for iid in sorted(incidents):
        group = incidents[iid]
        # The reporter is the node whose trigger dumped locally (remote
        # captures answer with reason="remote_capture"); its clock is
        # the alignment reference.
        reporter = next(
            (b for b in group if b.get("reason") != "remote_capture"),
            group[0],
        )
        ref = str(reporter.get("node"))
        node_rings: dict[str, list[dict]] = {}
        for b in group:
            node_rings.setdefault(str(b.get("node")), []).extend(
                r for r in (b.get("ring") or []) if isinstance(r, dict)
            )
        offsets = {
            node: (
                0.0 if node == ref
                else estimate_clock_offset(
                    recs, node_rings.get(ref, []), node, ref,
                )
            )
            for node, recs in node_rings.items()
        }
        merged = []
        for node, recs in node_rings.items():
            off = offsets[node]
            for r in recs:
                t = r.get("time")
                if t is None:
                    continue
                merged.append((float(t) - off, node, r))
        merged.sort(key=lambda x: x[0])
        trig_time = float(
            reporter.get("time") or (merged[-1][0] if merged else 0.0)
        )
        implicated = _implicated_clients(
            [r for _t, _n, r in merged]
            + [reporter.get("trigger") or {}]
        )
        entry = {
            "incident_id": iid,
            "reason": reporter.get("reason"),
            "node": ref,
            "time": trig_time,
            "trigger": reporter.get("trigger"),
            "nodes": {n: len(rs) for n, rs in sorted(node_rings.items())},
            "clock_offsets_s": offsets,
            "implicated_clients": {
                str(cid): why for cid, why in implicated.items()
            },
            "suppressed": reporter.get("suppressed") or {},
            "bundles": len(group),
        }
        report.append(entry)

        when = _dt.datetime.fromtimestamp(trig_time).isoformat(
            timespec="seconds"
        )
        print(f"incident {iid}")
        print(
            f"  reason: {entry['reason']}  node: {ref}  at {when}  "
            f"({len(group)} bundle(s), {len(merged)} merged records)"
        )
        trig = reporter.get("trigger")
        if trig:
            print(f"  trigger: {_format_ring_record(trig)}")
        off_line = ", ".join(
            f"{n}{o:+.4f}s" for n, o in sorted(offsets.items())
            if n != ref
        )
        if off_line:
            print(f"  clock offsets vs {ref}: {off_line}")
        if implicated:
            print("  implicated clients: " + ", ".join(
                f"{cid} ({'; '.join(why)})"
                for cid, why in implicated.items()
            ))
        shown = merged[-max(1, args.limit):]
        if len(merged) > len(shown):
            print(
                f"  timeline (last {len(shown)} of {len(merged)} "
                "records, seconds relative to the trigger):"
            )
        else:
            print("  timeline (seconds relative to the trigger):")
        for t, node, r in shown:
            mark = "  <-- TRIGGER" if (
                trig is not None and r is not trig
                and r.get("event") == trig.get("event")
                and r.get("time") == trig.get("time")
            ) else ""
            print(
                f"    {t - trig_time:+10.3f}s  {node:<12s} "
                f"{_format_ring_record(r)}{mark}"
            )
        print()

    if args.trace_out:
        from gfedntm_tpu_torch.utils.observability import merge_chrome_trace

        all_rings: dict[str, list[dict]] = {}
        for group in incidents.values():
            for b in group:
                all_rings.setdefault(str(b.get("node")), []).extend(
                    r for r in (b.get("ring") or [])
                    if isinstance(r, dict)
                )
        try:
            trace = merge_chrome_trace(
                all_rings, reference=str(report[0]["node"]),
            )
        except ValueError as err:
            raise SystemExit(f"--trace_out: trace merge failed: {err}")
        out_dir = os.path.dirname(os.path.abspath(args.trace_out))
        os.makedirs(out_dir, exist_ok=True)
        with open(args.trace_out, "w") as fh:
            json.dump(trace, fh, default=float)
        n_spans = sum(
            1 for e in trace["traceEvents"] if e.get("ph") == "X"
        )
        print(
            f"wrote {args.trace_out}: {n_spans} ring spans from "
            f"{len(all_rings)} nodes"
        )
    if args.json_out:
        os.makedirs(
            os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True
        )
        with open(args.json_out, "w") as fh:
            json.dump({"incidents": report}, fh, indent=1, default=float)
    print(
        f"{len(report)} incident(s) from {len(bundles)} bundle(s)"
    )
    return 0


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "summarize":
        return run_summarize(argv[1:])
    if argv and argv[0] == "trace":
        return run_trace(argv[1:])
    if argv and argv[0] == "report":
        return run_report(argv[1:])
    if argv and argv[0] == "scenarios":
        return run_scenarios(argv[1:])
    if argv and argv[0] == "slo":
        return run_slo(argv[1:])
    if argv and argv[0] == "incident":
        return run_incident(argv[1:])
    if argv and argv[0] == "privacy":
        return run_privacy(argv[1:])
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(name)s [%(threadName)s] %(levelname)s: %(message)s",
    )
    cfg = load_config(args)
    role = getattr(args, "role", "auto")
    if role == "serve":
        return run_serve(args, cfg)
    if role == "relay":
        return run_relay(args, cfg)
    if role == "server" or (role == "auto" and args.id == 0):
        return run_server(args, cfg)
    if role == "client" or (role == "auto" and args.id is not None):
        return run_client(args, cfg)
    return run_simulate(args, cfg)


if __name__ == "__main__":
    sys.exit(main())
