"""Graceful-degradation contracts: per-cell invariants, not just a sweep.

A copy of ``gfedntm_tpu/scenarios/contracts.py``: the same contracts over
the same evidence give the same verdicts.

A scenario cell is only green when the federation *degraded
gracefully* under its personas — the run completed with a finite
model, quorum semantics never degenerated into lone-straggler
averaging, crash recovery actually completed, the wire-codec /
idempotency counters stayed at their clean-run values, and the final
topic coherence landed within the cell's declared tolerance of its
no-fault baseline twin. Each contract evaluates from the cell's
collected JSONL evidence (see :func:`runner.collect_cell_evidence`),
so a failed contract names observable telemetry, not internal state.
"""

from __future__ import annotations

import math
from typing import Any

from gfedntm_tpu_torch.scenarios.personas import RELAY_KINDS, ScenarioCell

__all__ = ["evaluate_contracts", "quorum_floor"]

#: Counters that must sit at their clean-run (baseline) values in every
#: cell: a fault persona may slow or skip rounds, but it must never
#: corrupt the delta-reference discipline or double-count a reply.
CLEAN_COUNTERS = ("codec_ref_miss", "rpcs_deduplicated")


def quorum_floor(cell: ScenarioCell) -> int:
    """The per-round contributor floor the quorum contract holds the
    bulk of averaged rounds to: ``ceil(quorum_fraction x denominator)``
    where the denominator is the cohort size under cohort pacing and
    the full membership under sync. Async/push pacing aggregates
    whenever its buffer fills, so the floor is 1 by construction.
    Hierarchical relay cells also floor at 1: the root's contributors
    are pre-reduced shards, and surviving a relay kill on one shard
    (quorum over *live* shards) is the degradation being tested."""
    policy = cell.pacing.split(":", 1)[0]
    if policy in ("async", "push"):
        return 1
    if cell.fault_persona.kind in RELAY_KINDS:
        return 1
    denom = cell.n_clients
    if policy == "cohort" and ":" in cell.pacing:
        denom = min(denom, int(cell.pacing.split(":", 1)[1]))
    return max(1, math.ceil(cell.quorum_fraction * denom))


def _contract(ok: bool, detail: str) -> dict[str, Any]:
    return {"ok": bool(ok), "detail": detail}


def evaluate_contracts(
    cell: ScenarioCell,
    evidence: dict[str, Any],
    baseline: "dict[str, Any] | None" = None,
) -> dict[str, dict[str, Any]]:
    """Evaluate every degradation contract for one cell.

    ``evidence`` is the cell's own collected telemetry; ``baseline`` is
    the evidence of its no-fault twin (None for cells that ARE their
    own baseline — their comparative contracts reduce to clean-run
    checks). Returns ``{contract: {"ok": bool, "detail": str}}``.
    """
    out: dict[str, dict[str, Any]] = {}

    # 1. The run completed with a finite global model.
    out["completes"] = _contract(
        evidence.get("finished", False) and evidence.get("betas_finite",
                                                         False),
        f"finished={evidence.get('finished')} "
        f"betas_finite={evidence.get('betas_finite')} "
        f"rounds={evidence.get('rounds')}",
    )

    # 2. Quorum never degenerates: rounds averaged at all, no averaged
    # round had zero contributors, and the bulk (>= half) of averaged
    # rounds met the configured quorum floor — late rounds legitimately
    # shrink as clients finish their epochs, but a fault persona must
    # not turn the run into lone-straggler averaging.
    pushes = list(evidence.get("averaged_push_clients") or ())
    floor = quorum_floor(cell)
    if pushes:
        met = sum(1 for n in pushes if n >= floor)
        quorum_ok = min(pushes) >= 1 and met * 2 >= len(pushes)
        detail = (
            f"averaged_rounds={len(pushes)} min_contributors="
            f"{min(pushes)} floor={floor} met_floor={met}/{len(pushes)} "
            f"skipped={evidence.get('quorum_skips', 0)}"
        )
    else:
        quorum_ok = False
        detail = "no averaged rounds at all"
    out["quorum"] = _contract(quorum_ok, detail)

    # 3. Crash persona: zero-flag autorecovery completed — the
    # replacement process resumed at (or just behind, the in-flight
    # round) the kill point and the federation trained to completion.
    # A relay's journal records its last *applied* round, which can
    # trail the root's iteration counter by the in-flight round on each
    # side of the pre-reduction, hence the wider relaycrash slack.
    kind = cell.fault_persona.kind
    if kind in ("crash", "relaycrash"):
        rec = evidence.get("recovery") or {}
        resumed = rec.get("resumed_round")
        killed = rec.get("killed_round")
        slack = 2 if kind == "relaycrash" else 1
        rec_ok = (
            bool(rec.get("recovered"))
            and resumed is not None
            and killed is not None
            and resumed >= killed - slack
            and evidence.get("finished", False)
        )
        if kind == "relaycrash":
            # The respawned relay must have announced itself: the loud
            # relay_recovered event is the observable half of the
            # zero-flag autorecovery story.
            rec_ok = rec_ok and evidence.get("relay_recovered_events",
                                             0) >= 1
        out["recovery"] = _contract(
            rec_ok,
            f"recovered={rec.get('recovered')} resumed_round={resumed} "
            f"killed_round={killed} relay_recovered_events="
            f"{evidence.get('relay_recovered_events', 0)}",
        )

    # 3b. Relay-loss persona: the dead shard's members re-homed to
    # their failover endpoint (the root) — each re-homed member fires a
    # loud member_rehomed event at the adoptive tier — and the
    # federation still trained to completion. Double-counting is ruled
    # out by the counters_clean contract (rpcs_deduplicated).
    if kind == "relayloss":
        rehomed = evidence.get("member_rehomed_events", 0)
        out["rehoming"] = _contract(
            rehomed >= 1 and evidence.get("finished", False),
            f"member_rehomed_events={rehomed} "
            f"finished={evidence.get('finished')}",
        )

    # 4. Wire-codec / idempotency counters at clean-run values: faults
    # may cost time, never reference-chain integrity or double counting.
    base_counters = (baseline or {}).get("counters") or {}
    counters = evidence.get("counters") or {}
    mismatches = []
    for name in CLEAN_COUNTERS:
        want = float(base_counters.get(name, 0.0))
        got = float(counters.get(name, 0.0))
        if got != want:
            mismatches.append(f"{name}={got:g} (clean-run {want:g})")
    out["counters_clean"] = _contract(
        not mismatches,
        "; ".join(mismatches) if mismatches else ", ".join(
            f"{n}={float(counters.get(n, 0.0)):g}" for n in CLEAN_COUNTERS
        ),
    )

    # 5. Declared SLOs held: the cell's recorded telemetry, replayed
    # through the offline evaluator (the `slo` CLI's engine), never
    # drove any of the cell's objectives to firing. Only present when
    # the cell declares specs — an SLO-less cell has no such contract.
    if cell.slo:
        slo_ev = evidence.get("slo") or {}
        fired = list(slo_ev.get("fired") or ())
        alerts = slo_ev.get("alerts") or []
        out["slo"] = _contract(
            bool(alerts) and not fired,
            (
                f"fired={fired}" if fired
                else "; ".join(
                    f"{a['alert']}: {a['objective']} ({a['state']})"
                    for a in alerts
                ) or "no SLO evidence collected"
            ),
        )

    # 6. Final NPMI within the declared tolerance of the no-fault
    # baseline: the fault persona may slow convergence, but the model
    # the federation lands on must stay comparably coherent.
    npmi = evidence.get("npmi_final")
    base_npmi = (
        (baseline or {}).get("npmi_final")
        if baseline is not None
        else npmi
    )
    if npmi is None or base_npmi is None:
        out["npmi_tolerance"] = _contract(
            False,
            f"npmi={npmi} baseline={base_npmi} — coherence was never "
            "measured (quality plane off?)",
        )
    else:
        delta = abs(npmi - base_npmi)
        out["npmi_tolerance"] = _contract(
            delta <= cell.npmi_tol,
            f"npmi={npmi:.4f} baseline={base_npmi:.4f} "
            f"delta={delta:.4f} tol={cell.npmi_tol:g}",
        )

    # 7. DP cells: the (ε, δ) ledger exists, only ever grows, and ends
    # positive — in stream order across a crash cell's recovery seam
    # (the replacement server resumes the journaled ledger; an ε that
    # ever FALLS means the accountant was reset mid-run and the true
    # privacy cost is under-reported).
    if cell.dp != "off":
        eps = [float(e) for e in (evidence.get("privacy_eps") or ())]
        drops = [
            (i, eps[i - 1], eps[i]) for i in range(1, len(eps))
            if eps[i] + 1e-12 < eps[i - 1]
        ]
        out["budget_monotone"] = _contract(
            bool(eps) and not drops and eps[-1] > 0.0,
            (
                f"{len(eps)} ledger rounds, final eps="
                f"{eps[-1]:.4f}" if eps and not drops
                else (
                    f"eps fell {drops[0][1]:.4f} -> {drops[0][2]:.4f} "
                    f"at ledger row {drops[0][0]}" if drops
                    else "no privacy_budget events at all (dp plane "
                         "silently off?)"
                )
            ),
        )
    return out
