"""GL001 telemetry-contract: the telemetry schema is machine-checked.

A copy of the JAX rule over the port: the contract is read from the port's
``gfedntm_tpu_torch/utils/observability.py`` (which registers the JAX
events, event groups and span names), and the scan covers the port's
package and ``chip_smoke.py``. Four sub-checks:

- every ``<logger>.log("<event>", ...)`` call site names an event
  registered in ``observability.EVENT_SCHEMAS`` — an unregistered event
  passes silently in un-validated production loggers and explodes the
  first time a test constructs ``MetricsLogger(validate=True)``;
- reverse-lint: every DATA_PLANE_EVENTS + MODEL_QUALITY_EVENTS +
  SCALEOUT_EVENTS + SERVING_EVENTS + SCENARIO_EVENTS + FLEET_EVENTS +
  SURVIVAL_EVENTS + PRIVACY_EVENTS + INCIDENT_EVENTS entry keeps BOTH
  a schema registration and at least
  one emission site — a refactor that disconnects the admission-gate/
  guardian/quality/scale-plane/serving/scenario/fleet-alerting/
  crash-recovery/privacy/incident-forensics telemetry must not pass
  silently;
- every ``observability.TRACE_PLANE_SPANS`` name keeps a ``span(...)``
  call site — the ``trace`` CLI merges and parents by these names;
- scanner self-checks: zero ``.log(``/``span(`` sites at all means the
  regexes rotted, which is itself a finding.
"""

from __future__ import annotations

import re

from gfedntm_tpu_torch.analysis.core import (
    Finding,
    LintContext,
    Rule,
    SourceFile,
)

#: An emission is `<expr>.log(` followed by a string-literal event name;
#: the codebase's MetricsLogger handles are `metrics`, `m`,
#: `logger.metrics`, `self.metrics`. Python `logging` handles use level
#: methods (.info/.warning) and never pass a string literal to .log, so
#: a quoted first argument marks a telemetry emission. (Spelled without
#: a literal example here — this module is inside its own scan scope.)
LOG_CALL = re.compile(r"""\.log\(\s*\n?\s*["']([a-z][a-z0-9_]*)["']""")

#: `span(` call sites with a logger expression and a string-literal
#: span name — the vocabulary the trace-merge CLI keys on.
SPAN_CALL = re.compile(
    r"""\bspan\(\s*\n?\s*[\w.()\[\]]+\s*,\s*\n?\s*["']([a-z][a-z0-9_]*)["']"""
)

#: Where the schema constants live (findings about the *registry* side
#: anchor on the constant's definition line in this module).
SCHEMA_MODULE = "gfedntm_tpu_torch/utils/observability.py"


def _call_sites(
    files: list[SourceFile], pattern: "re.Pattern"
) -> dict[str, list[tuple[str, int]]]:
    """Map of matched name -> [(rel_path, line)] across the file set."""
    sites: dict[str, list[tuple[str, int]]] = {}
    for src in files:
        for m in pattern.finditer(src.text):
            line = src.text.count("\n", 0, m.start()) + 1
            sites.setdefault(m.group(1), []).append((src.rel, line))
    return sites


class TelemetryContractRule(Rule):
    id = "GL001"
    name = "telemetry-contract"
    description = (
        "events registered in EVENT_SCHEMAS <=> emitted; trace-plane "
        "span call sites exist; data-plane/model-quality reverse-lint"
    )
    # The port's package and its card smoke (the chaos tests ride along
    # in the scan set for GL005 only).
    default_paths = ("gfedntm_tpu_torch/", "chip_smoke.py")

    def _contract(self, ctx: LintContext) -> dict:
        """The schema contract: event names, required reverse-lint
        groups, span vocabulary. Tests override via
        ``ctx.options["telemetry"]``; the default imports the live
        registry."""
        override = ctx.options.get("telemetry")
        if override is not None:
            return override
        from gfedntm_tpu_torch.utils.observability import (
            DATA_PLANE_EVENTS,
            EVENT_SCHEMAS,
            FLEET_EVENTS,
            INCIDENT_EVENTS,
            MODEL_QUALITY_EVENTS,
            PRIVACY_EVENTS,
            SCALEOUT_EVENTS,
            SCENARIO_EVENTS,
            SERVING_EVENTS,
            SURVIVAL_EVENTS,
            TRACE_PLANE_SPANS,
        )

        return {
            "events": EVENT_SCHEMAS,
            "required": {
                "DATA_PLANE_EVENTS": tuple(DATA_PLANE_EVENTS),
                "MODEL_QUALITY_EVENTS": tuple(MODEL_QUALITY_EVENTS),
                "SCALEOUT_EVENTS": tuple(SCALEOUT_EVENTS),
                "SERVING_EVENTS": tuple(SERVING_EVENTS),
                "SCENARIO_EVENTS": tuple(SCENARIO_EVENTS),
                "FLEET_EVENTS": tuple(FLEET_EVENTS),
                "SURVIVAL_EVENTS": tuple(SURVIVAL_EVENTS),
                "PRIVACY_EVENTS": tuple(PRIVACY_EVENTS),
                "INCIDENT_EVENTS": tuple(INCIDENT_EVENTS),
            },
            "spans": tuple(TRACE_PLANE_SPANS),
            "schema_module": SCHEMA_MODULE,
        }

    def _covers_default_scan(
        self, files: list[SourceFile], ctx: LintContext
    ) -> bool:
        import os

        from gfedntm_tpu_torch.analysis.core import collect_default_files

        rels = {f.rel for f in files}
        root = os.path.abspath(ctx.root)
        for path in collect_default_files(root):
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            if self.applies_to(rel) and rel not in rels:
                return False
        return True

    def _anchor(self, files: list[SourceFile], module: str,
                symbol: str) -> tuple[str, int]:
        """Anchor registry-side findings at the constant's definition."""
        for src in files:
            if src.rel == module:
                for i, text in enumerate(src.lines, start=1):
                    if text.startswith(symbol):
                        return (src.rel, i)
                return (src.rel, 1)
        return (module, 1)

    def check_repo(
        self, files: list[SourceFile], ctx: LintContext
    ) -> list[Finding]:
        if not files:  # nothing in this rule's scope was scanned
            return []
        contract = self._contract(ctx)
        schemas = contract["events"]
        module = contract.get("schema_module", SCHEMA_MODULE)
        out: list[Finding] = []

        # The reverse-lints ("this event is emitted NOWHERE", "zero call
        # sites at all") are whole-repo statements — meaningless on an
        # explicit file subset, INCLUDING a subset that happens to
        # contain the schema module (the emission sites live elsewhere).
        # They run only when the scanned set covers the rule's whole
        # default scope, or under a test-fixture contract.
        full_scan = (
            ctx.options.get("telemetry") is not None
            or self._covers_default_scan(files, ctx)
        )

        log_sites = _call_sites(files, LOG_CALL)
        if full_scan and not log_sites:
            rel, line = self._anchor(files, module, "EVENT_SCHEMAS")
            out.append(self.finding(
                rel, line,
                "found no .log() call sites anywhere — the telemetry "
                "scanner regex is probably broken",
                hint="fix LOG_CALL in analysis/rules/telemetry.py",
            ))
            return out

        for event, sites in sorted(log_sites.items()):
            if event in schemas:
                continue
            for rel, line in sites:
                out.append(self.finding(
                    rel, line,
                    f"event {event!r} is emitted here but not registered "
                    "in observability.EVENT_SCHEMAS",
                    hint=(
                        "add the event (with its field set) to "
                        "EVENT_SCHEMAS, or rename the emission to a "
                        "registered event"
                    ),
                ))

        if not full_scan:
            return out

        for group, events in contract.get("required", {}).items():
            rel, line = self._anchor(files, module, group)
            for event in events:
                if event not in schemas:
                    out.append(self.finding(
                        rel, line,
                        f"required {group} event {event!r} is missing "
                        "from EVENT_SCHEMAS",
                        hint="re-register the event — this group is the "
                             "data-plane/quality defense contract",
                    ))
                if event not in log_sites:
                    out.append(self.finding(
                        rel, line,
                        f"required {group} event {event!r} has no "
                        ".log() emission site left",
                        hint="the defense telemetry was disconnected by a "
                             "refactor; restore the emission",
                    ))

        spans = contract.get("spans", ())
        if spans:
            span_sites = _call_sites(files, SPAN_CALL)
            if not span_sites:
                rel, line = self._anchor(files, module, "TRACE_PLANE_SPANS")
                out.append(self.finding(
                    rel, line,
                    "found no span() call sites anywhere — the span "
                    "scanner regex is probably broken",
                    hint="fix SPAN_CALL in analysis/rules/telemetry.py",
                ))
            else:
                for name in spans:
                    if name not in span_sites:
                        rel, line = self._anchor(
                            files, module, "TRACE_PLANE_SPANS"
                        )
                        out.append(self.finding(
                            rel, line,
                            f"trace-plane span {name!r} has no span() "
                            "call site — the trace CLI merges and "
                            "parents by this name",
                            hint="restore the span or update "
                                 "TRACE_PLANE_SPANS",
                        ))
        return out
