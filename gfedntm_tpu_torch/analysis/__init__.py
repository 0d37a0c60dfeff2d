"""graftlint over the PyTorch port: the port's static-analysis gate.

The counterpart of ``gfedntm_tpu/analysis/``: the same framework, rule ids,
names and order, each rule with the meaning it has for the port's code:

====== ==================== ===============================================
id     rule                 invariant
====== ==================== ===============================================
GL001  telemetry-contract   events registered <=> emitted; span call
                            sites; the required-event reverse-lint
GL002  precision-pin        gram-path torch products run in float64 or
                            with TF32 off; no literal TF32/bf16-reduction
                            switch anywhere in the port
GL003  donation-safety      donated buffers never referenced after the
                            donating call (guards against the JAX idiom)
GL004  lock-discipline      '# guarded-by: <lock>' attributes mutate only
                            under 'with self.<lock>:'
GL005  exception-hygiene    broad excepts in the planes log/count/
                            delegate/re-raise — never silent
GL006  rng-discipline       noise paths draw from explicit generators,
                            never numpy's or torch's global stream
====== ==================== ===============================================

Run it::

    python -m gfedntm_tpu_torch.analysis            # the port, with baseline
    python -m gfedntm_tpu_torch.analysis --list-rules

Suppress one finding inline (justification is free text for review)::

    except Exception:  # graftlint: disable=exception-hygiene -- probe
        ...

Accept a finding into the baseline
(``gfedntm_tpu_torch/analysis/lint_baseline.json``)::

    python -m gfedntm_tpu_torch.analysis --update-baseline
    # then FILL IN the empty "justification" fields — the gate fails
    # on baselined findings without one.
"""

from __future__ import annotations

from gfedntm_tpu_torch.analysis.core import (
    Finding,
    LintContext,
    Rule,
    SourceFile,
    collect_default_files,
    load_source,
    run_rules,
)
from gfedntm_tpu_torch.analysis.runner import LintResult, run_lint

__all__ = [
    "Finding",
    "LintContext",
    "LintResult",
    "Rule",
    "SourceFile",
    "collect_default_files",
    "load_source",
    "run_lint",
    "run_rules",
]
