"""Scenario matrix engine of the PyTorch port (README "The port's scenario
matrix"), the counterpart of ``gfedntm_tpu/scenarios/`` with the same
``__all__``.

Composes orthogonal adversity axes — data personas (Dirichlet-α
non-IID, vocabulary skew, client-size imbalance), fault personas
(slow network, partition, connection flapping, server crash), policy
axes (pacing × aggregator × robust estimator), and workloads (AVITM,
CTM) — into runnable cells. Each cell drives the REAL in-process
federation over gRPC, emits the standard bench JSON line (kind
``"scenario"``) plus the model-quality telemetry, and asserts its
graceful-degradation contracts against a no-fault baseline twin.
"""

from gfedntm_tpu_torch.scenarios.personas import (
    DataPersona,
    FaultPersona,
    ScenarioCell,
    build_corpora,
    fault_specs_for,
    parse_data_persona,
    parse_fault_persona,
)
from gfedntm_tpu_torch.scenarios.contracts import evaluate_contracts
from gfedntm_tpu_torch.scenarios.runner import (
    CellResult,
    baseline_of,
    cell_bench_row,
    collect_cell_evidence,
    default_matrix,
    emit_artifact,
    run_cell,
    run_matrix,
)

__all__ = [
    "DataPersona",
    "FaultPersona",
    "ScenarioCell",
    "CellResult",
    "baseline_of",
    "build_corpora",
    "cell_bench_row",
    "collect_cell_evidence",
    "default_matrix",
    "emit_artifact",
    "evaluate_contracts",
    "fault_specs_for",
    "parse_data_persona",
    "parse_fault_persona",
    "run_cell",
    "run_matrix",
]
