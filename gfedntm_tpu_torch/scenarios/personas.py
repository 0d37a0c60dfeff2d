"""Scenario axes: data personas, fault personas, and the cell spec.

A copy of ``gfedntm_tpu/scenarios/personas.py`` over the port's modules
(``data.loaders``, ``data.synthetic``, ``privacy.mechanisms``,
``utils.slo``): for the same cell it builds the same corpora, personas
and fault specs.

A *data persona* shapes WHAT each client holds (heterogeneity), a
*fault persona* shapes HOW the network/processes misbehave, and the
policy axes (pacing, aggregator, robust estimator) shape how the
federation responds. Personas are compact ``'+'``-composable spec
strings so a cell is one line and the CLI/README table stays readable:

- data:  ``iid`` | ``dirichlet:<alpha>`` | ``imbalance:<ratio>`` |
  ``vocabskew:<frac>`` — composable, e.g.
  ``dirichlet:0.1+imbalance:20``.
- fault: ``none`` | ``slow:<delay_s>`` | ``partition:<window_s>`` |
  ``flap:<times>`` | ``crash:<round>`` | ``relaycrash:<round>`` |
  ``relayloss:<round>``.

The two ``relay*`` personas imply a HIERARCHICAL topology (root + two
relays splitting the cell's members): ``relaycrash`` kills one relay
after the given round and respawns it with identical argv (shard
journal autorecovery), ``relayloss`` kills it for good (members
re-home to the root via their ``--server_addrs`` fallback list).

Fault personas (except the process-lifecycle kinds ``crash`` /
``relaycrash`` / ``relayloss``, which the runner drives) lower into
the SAME validated fault-spec dicts the ``--chaos`` CLI flag takes
(:func:`gfedntm_tpu_torch.federation.resilience.validate_fault_spec`), so a
typo'd persona fails at parse time, never as an inert injector.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np

from gfedntm_tpu_torch.data.loaders import RawCorpus, heterogeneous_partition
from gfedntm_tpu_torch.data.synthetic import (
    apply_vocabulary_skew,
    dominant_topics,
    generate_synthetic_corpus,
)

__all__ = [
    "DataPersona",
    "FaultPersona",
    "LIFECYCLE_KINDS",
    "RELAY_KINDS",
    "ScenarioCell",
    "build_corpora",
    "fault_specs_for",
    "parse_data_persona",
    "parse_fault_persona",
]


# ---- data personas ----------------------------------------------------------

@dataclass(frozen=True)
class DataPersona:
    """Parsed data-heterogeneity axis (see module docstring)."""

    spec: str = "iid"
    alpha: float | None = None  # Dirichlet-α label skew (None = no skew)
    size_ratio: float | None = None  # largest/smallest client size
    vocab_skew: float = 0.0  # fraction of per-client private vocab types


def parse_data_persona(spec: str) -> DataPersona:
    """Parse a ``'+'``-composed data-persona spec; raises ``ValueError``
    on unknown stage names or out-of-domain values (fail-fast, same
    policy as the fault specs)."""
    spec = (spec or "iid").strip()
    alpha: float | None = None
    size_ratio: float | None = None
    vocab_skew = 0.0
    for stage in spec.split("+"):
        stage = stage.strip()
        if stage in ("", "iid"):
            continue
        name, _, arg = stage.partition(":")
        try:
            value = float(arg)
        except ValueError:
            raise ValueError(
                f"data persona stage {stage!r} needs a numeric argument"
            )
        if name == "dirichlet":
            if value <= 0:
                raise ValueError(f"dirichlet alpha must be > 0: {stage!r}")
            alpha = value
        elif name == "imbalance":
            if value < 1:
                raise ValueError(
                    f"imbalance ratio must be >= 1: {stage!r}"
                )
            size_ratio = value
        elif name == "vocabskew":
            if not 0.0 <= value <= 1.0:
                raise ValueError(
                    f"vocabskew fraction must be in [0, 1]: {stage!r}"
                )
            vocab_skew = value
        else:
            raise ValueError(
                f"unknown data persona stage {name!r} (known: dirichlet, "
                "imbalance, vocabskew, iid)"
            )
    return DataPersona(
        spec=spec, alpha=alpha, size_ratio=size_ratio,
        vocab_skew=vocab_skew,
    )


# ---- fault personas ---------------------------------------------------------

#: Fault-persona kinds the engine understands. ``crash`` (root kill +
#: zero-flag autorecovery, the in-process SIGKILL-equivalent),
#: ``relaycrash`` (relay kill + identical-argv respawn) and
#: ``relayloss`` (relay kill, never returns — members re-home) are
#: driven by the runner as process-lifecycle events; everything else
#: lowers to FaultInjector specs.
FAULT_KINDS = (
    "none", "slow", "partition", "flap", "crash", "relaycrash",
    "relayloss",
)

#: The runner-driven process-lifecycle kinds (no FaultInjector specs).
LIFECYCLE_KINDS = ("crash", "relaycrash", "relayloss")

#: The kinds that imply a hierarchical (root + relays) topology.
RELAY_KINDS = ("relaycrash", "relayloss")


@dataclass(frozen=True)
class FaultPersona:
    """Parsed fault axis: ``kind`` + its single numeric knob."""

    spec: str = "none"
    kind: str = "none"
    value: float = 0.0

    @property
    def crash_round(self) -> int:
        """The round the crash/relaycrash/relayloss persona kills its
        target process after."""
        return int(self.value)


def parse_fault_persona(spec: str) -> FaultPersona:
    """Parse a fault-persona spec; raises ``ValueError`` on unknown
    kinds or out-of-domain values."""
    spec = (spec or "none").strip()
    if spec in ("", "none"):
        return FaultPersona(spec="none")
    name, _, arg = spec.partition(":")
    if name not in FAULT_KINDS:
        raise ValueError(
            f"unknown fault persona {name!r} (known: "
            f"{', '.join(FAULT_KINDS)})"
        )
    try:
        value = float(arg)
    except ValueError:
        raise ValueError(
            f"fault persona {spec!r} needs a numeric argument "
            "(slow:<delay_s>, partition:<window_s>, flap:<times>, "
            "crash:<round>)"
        )
    if value <= 0:
        raise ValueError(
            f"fault persona {spec!r} needs a positive argument"
        )
    if name in ("flap",) + LIFECYCLE_KINDS and value != int(value):
        raise ValueError(f"fault persona {spec!r} needs an integer count")
    return FaultPersona(spec=spec, kind=name, value=value)


def fault_specs_for(
    persona: FaultPersona, n_clients: int
) -> list[dict[str, Any]]:
    """Lower a fault persona into ``--chaos``-shaped fault-spec dicts
    for the server's client stubs. Validated downstream by
    :func:`~gfedntm_tpu_torch.federation.resilience.build_fault_injector`.

    - ``slow:<delay_s>``: every client's next few ``TrainStep`` polls
      are delayed — the slow-network persona (stresses poll deadlines
      and straggler EWMAs).
    - ``partition:<window_s>``: ``client1``'s whole link is blackholed
      for a wall-clock window after a short warm-up — the network
      partition persona (stresses probation + quorum + recovery).
    - ``flap:<times>``: ``times`` isolated connection drops on
      ``TrainStep``, two clean calls apart — the flapping-link persona
      (stresses the retry policy and probation recovery).
    """
    if persona.kind == "none" or persona.kind in LIFECYCLE_KINDS:
        return []
    if persona.kind == "slow":
        return [{
            "method": "TrainStep", "kind": "delay",
            "delay_s": float(persona.value), "times": 2 * n_clients,
        }]
    if persona.kind == "partition":
        return [{
            "method": "*", "kind": "partition", "peer": "client1",
            "delay_s": float(persona.value), "skip": 4,
        }]
    if persona.kind == "flap":
        return [
            {"method": "TrainStep", "kind": "drop", "times": 1, "skip": 2}
            for _ in range(int(persona.value))
        ]
    raise ValueError(f"unhandled fault persona {persona.spec!r}")


# ---- the cell ---------------------------------------------------------------

@dataclass(frozen=True)
class ScenarioCell:
    """One runnable cell of the scenario matrix: data persona × fault
    persona × policy axes × workload, plus its degradation-contract
    tolerance. Sized for CPU-cheap runs — a cell is an end-to-end gRPC
    federation, and the matrix runs a dozen-plus of them."""

    name: str
    workload: str = "avitm"  # avitm | ctm
    data: str = "iid"
    fault: str = "none"
    pacing: str = "sync"
    aggregator: str = "fedavg"
    robust: str | None = None
    wire_codec: str = "none"
    n_clients: int = 3
    total_docs: int = 120
    vocab_size: int = 100
    n_topics: int = 6
    n_components: int = 4
    hidden_sizes: tuple[int, ...] = (16,)
    batch_size: int = 8
    num_epochs: int = 3
    local_steps: int = 2
    max_iters: int = 60
    quorum_fraction: float = 0.5
    npmi_tol: float = 0.35
    seed: int = 0
    timeout_s: float = 420.0
    extra_server_kwargs: dict = field(default_factory=dict)
    # SLO contract (README "Fleet telemetry & SLOs"): declarative
    # objectives (SLOSpec dicts) the cell's recorded telemetry must hold
    # — evaluated offline from the cell's JSONL evidence through the same
    # engine the live planes run; any spec that ever fires is a red
    # "slo" contract.
    slo: tuple = ()
    # DP axis (README "Differential privacy & posterior sampling"):
    # "server" = FedLD noise on each aggregate, "client" = local DP-SGD
    # on each outgoing update. Like the fault axis, dp is EXCLUDED from
    # policy_key(): a dp cell's baseline twin is the same policy run
    # noiseless (fault none AND dp off), and the npmi_tolerance contract
    # bounds the coherence the noise may cost. dp != "off" also adds the
    # budget_monotone contract over the server's privacy_budget ledger.
    dp: str = "off"
    dp_clip: float = 1.0
    dp_sigma: float = 0.0
    dp_budget: float = 0.0

    def __post_init__(self):
        if self.workload not in ("avitm", "ctm"):
            raise ValueError(f"unknown workload {self.workload!r}")
        # Parse eagerly: a typo'd persona fails at matrix build time.
        parse_data_persona(self.data)
        parse_fault_persona(self.fault)
        from gfedntm_tpu_torch.privacy.mechanisms import parse_dp

        parse_dp(self.dp, clip=self.dp_clip, sigma=self.dp_sigma,
                 budget=self.dp_budget)
        if self.slo:
            from gfedntm_tpu_torch.utils.slo import SLOSpec

            for spec in self.slo:
                if not isinstance(spec, SLOSpec):
                    SLOSpec.from_dict(dict(spec))

    @property
    def data_persona(self) -> DataPersona:
        return parse_data_persona(self.data)

    @property
    def fault_persona(self) -> FaultPersona:
        return parse_fault_persona(self.fault)

    def shrink(self, factor: float = 0.5) -> "ScenarioCell":
        """A faster twin for smoke runs (``scenarios --fast``): fewer
        docs and epochs, same axes — the composition is what the smoke
        stage checks, not the statistics. A crash persona's kill round
        is pulled in so the shorter run still dies mid-flight."""
        fault = self.fault
        persona = parse_fault_persona(fault)
        if persona.kind in LIFECYCLE_KINDS:
            fault = f"{persona.kind}:{min(persona.crash_round, 2)}"
        return replace(
            self,
            fault=fault,
            total_docs=max(self.n_clients * 12,
                           int(self.total_docs * factor)),
            num_epochs=max(1, self.num_epochs - 1),
        )

    def policy_key(self) -> tuple:
        """Everything that must match between a faulted cell and its
        no-fault baseline twin for the NPMI/counter comparison to be
        apples-to-apples — i.e. every axis EXCEPT the fault."""
        return (
            self.workload, self.data, self.pacing, self.aggregator,
            self.robust, self.wire_codec, self.n_clients,
            self.total_docs, self.vocab_size, self.n_topics,
            self.n_components, self.hidden_sizes, self.batch_size,
            self.num_epochs, self.local_steps, self.max_iters,
            self.quorum_fraction, self.seed,
        )


# ---- corpus construction ----------------------------------------------------

def build_corpora(
    cell: ScenarioCell, min_docs: int = 6
) -> tuple[list[RawCorpus], list[str]]:
    """Materialize the cell's data persona: a pooled synthetic LDA
    corpus partitioned per the persona's heterogeneity axes.

    Returns ``(per-client corpora, reference documents)`` — the
    reference docs (the pooled pre-skew corpus) feed the quality
    plane's NPMI co-occurrence statistics, so every cell's coherence is
    measured against the same ground-truth co-occurrence structure.
    CTM cells get seeded per-doc contextual embeddings (synthetic
    archives carry none; the federated CTM path only needs them to be
    deterministic and doc-aligned).
    """
    persona = cell.data_persona
    pooled = generate_synthetic_corpus(
        vocab_size=cell.vocab_size,
        n_topics=cell.n_topics,
        n_docs=cell.total_docs,
        nwords=(15, 30),
        n_nodes=1,
        frozen_topics=cell.n_topics,  # plain LDA: all topics shared
        seed=cell.seed,
    )
    node = pooled.nodes[0]
    labels = dominant_topics(node)
    shards = heterogeneous_partition(
        labels,
        cell.total_docs,
        cell.n_clients,
        alpha=persona.alpha,
        size_ratio=persona.size_ratio,
        seed=cell.seed,
        min_docs=min_docs,
    )
    rng = np.random.default_rng(cell.seed + 7)
    corpora = []
    for c, shard in enumerate(shards):
        docs = [node.documents[i] for i in shard]
        if persona.vocab_skew > 0:
            docs = apply_vocabulary_skew(
                docs, c + 1, persona.vocab_skew, seed=cell.seed
            )
        embeddings = None
        if cell.workload == "ctm":
            embeddings = rng.normal(size=(len(docs), 12)).astype(np.float32)
        corpora.append(RawCorpus(documents=docs, embeddings=embeddings))
    return corpora, list(node.documents)
