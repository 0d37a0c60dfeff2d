"""graftlint rule registry of the port: the six JAX rules, in the JAX order,
each with the meaning it has for the port's code.

Adding an analyzer: implement a :class:`~gfedntm_tpu_torch.analysis.core.Rule`
subclass in a module here, then register an instance in
:func:`make_default_rules` — the single list every execution path (the
CLI, ``chip_smoke.py``'s phase 19, ``run_lint``) draws from. See
README "Static analysis in the port", and
``tests/test_torch_analysis.py`` for the fixture pattern every rule ships
with: at least one seeded violation it catches and one negative fixture
it stays quiet on.
"""

from __future__ import annotations

from gfedntm_tpu_torch.analysis.rules.donation import DonationSafetyRule
from gfedntm_tpu_torch.analysis.rules.exceptions import ExceptionHygieneRule
from gfedntm_tpu_torch.analysis.rules.locks import LockDisciplineRule
from gfedntm_tpu_torch.analysis.rules.precision import PrecisionPinRule
from gfedntm_tpu_torch.analysis.rules.rng import RngDisciplineRule
from gfedntm_tpu_torch.analysis.rules.telemetry import TelemetryContractRule

__all__ = [
    "make_default_rules",
    "DonationSafetyRule",
    "ExceptionHygieneRule",
    "LockDisciplineRule",
    "PrecisionPinRule",
    "RngDisciplineRule",
    "TelemetryContractRule",
]


def make_default_rules() -> list:
    """Fresh instances of every registered rule, in the JAX order (rules
    are stateless, but fresh instances keep test re-scoping from
    leaking)."""
    return [
        TelemetryContractRule(),
        PrecisionPinRule(),
        DonationSafetyRule(),
        LockDisciplineRule(),
        ExceptionHygieneRule(),
        RngDisciplineRule(),
    ]
