"""GL005 exception-hygiene: no silent ``except Exception`` in the planes.

A copy of the JAX rule, its scope mapped onto the port: the same planes,
plus ``federated/aggregation.py`` (where the port keeps the JAX
``federation/aggregation.py``) and ``tests/test_torch_chaos.py`` (the twin
of ``tests/chaos``).

The federation round loop and the telemetry planes contain ``except
Exception`` blocks by design — telemetry must never kill the round loop,
checkpoints are the recovery path, not the workload. The discipline: every
such handler must make the failure *observable*:
log it (``logger.exception``/``error``/``warning``), bump a counter /
emit a telemetry event (``.inc()``/``.log()``), re-raise, or hand the
exception object on to a helper that does (``self._note_client_failure(
..., exc, ...)``). A handler that does none of those converts a failure
into silence — the bug class where the bench shipped CPU numbers for
three rounds because the accelerator path swallowed its timeout.

A finding anchors at the ``except`` line. Intentionally-silent probes
(e.g. device memory-stats feature detection, where the absence of stats
IS the answer) carry an inline ``# graftlint: disable=exception-hygiene``
with a justification, or a baseline entry.
"""

from __future__ import annotations

import ast

from gfedntm_tpu_torch.analysis.core import (
    Finding,
    LintContext,
    Rule,
    SourceFile,
)

#: Calls that make a failure observable when they appear in the handler.
OBSERVING_ATTRS = frozenset({
    "log", "inc", "observe",                      # telemetry emission
    "exception", "error", "warning", "critical",  # logging
})

BROAD = frozenset({"Exception", "BaseException"})


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:  # bare except:
        return True
    names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
    for n in names:
        if isinstance(n, ast.Name) and n.id in BROAD:
            return True
        if isinstance(n, ast.Attribute) and n.attr in BROAD:
            return True
    return False


def _observes(handler: ast.ExceptHandler) -> bool:
    exc_name = handler.name
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if not isinstance(node, ast.Call):
            continue
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in OBSERVING_ATTRS
        ):
            return True
    if exc_name is not None:
        # Delegation/surfacing: the bound exception object is USED —
        # handed to a callee that owns the accounting
        # (self._note_client_failure(..., exc, ...)), written to stderr,
        # formatted into an HTTP 500 body, banked into a summary field.
        # Silence means catching and never looking at the failure.
        for node in ast.walk(handler):
            if (
                isinstance(node, ast.Name)
                and isinstance(node.ctx, ast.Load)
                and node.id == exc_name
            ):
                return True
    return False


class ExceptionHygieneRule(Rule):
    id = "GL005"
    name = "exception-hygiene"
    description = (
        "except Exception in federation/telemetry code must log an "
        "event, bump a counter, delegate the exception, or re-raise"
    )
    default_paths = (
        "gfedntm_tpu_torch/federation/",
        # The port keeps the JAX federation/aggregation.py here.
        "gfedntm_tpu_torch/federated/aggregation.py",
        # The serving plane answers live user traffic: a swallowed model-
        # load or request-path failure is an outage nobody can see.
        "gfedntm_tpu_torch/serving/",
        "gfedntm_tpu_torch/utils/observability.py",
        "gfedntm_tpu_torch/train/guardian.py",
        "gfedntm_tpu_torch/train/checkpoint.py",
        "gfedntm_tpu_torch/eval/monitor.py",
        # The chaos harness manages subprocess lifecycles with the same
        # stakes: a reconnect/supervision loop that swallows its failure
        # reports a green kill-test that proved nothing.
        "tests/test_torch_chaos.py",
    )

    HINT = (
        "log it (logger.exception/.warning), bump a counter "
        "(registry.counter(...).inc()), emit a telemetry event "
        "(metrics.log(...)), pass the exception to a handler helper, or "
        "re-raise; genuinely-intentional silence takes an inline "
        "'# graftlint: disable=exception-hygiene' with a justification"
    )

    def check_file(self, src: SourceFile, ctx: LintContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Try):
                continue
            for handler in node.handlers:
                if not _is_broad(handler):
                    continue
                if _observes(handler):
                    continue
                out.append(self.finding(
                    src, handler.lineno,
                    "broad except swallows the failure silently (no "
                    "log, no counter, no re-raise)",
                    hint=self.HINT,
                ))
        return out
