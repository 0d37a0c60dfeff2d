"""graftlint runner: files + rules + baseline -> verdict.

Programmatic entry point (:func:`run_lint`) shared by the CLI
(``python -m gfedntm_tpu_torch.analysis``) and the self-run test. The
port's gate has its own root and its own baseline,
``gfedntm_tpu_torch/analysis/lint_baseline.json``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from gfedntm_tpu_torch.analysis import baseline as bl
from gfedntm_tpu_torch.analysis.core import (
    Finding,
    LintContext,
    Rule,
    SourceFile,
    collect_default_files,
    load_source,
    run_rules,
)

__all__ = ["LintResult", "run_lint", "default_baseline_path", "repo_root"]


def repo_root() -> str:
    """The repo checkout this package lives in (two levels up from
    ``gfedntm_tpu_torch/analysis/``)."""
    return os.path.abspath(
        os.path.join(os.path.dirname(__file__), os.pardir, os.pardir)
    )


def default_baseline_path(root: str) -> str:
    return os.path.join(
        root, "gfedntm_tpu_torch", "analysis", "lint_baseline.json"
    )


@dataclass
class LintResult:
    findings: list[Finding] = field(default_factory=list)   # all surviving
    new: list[Finding] = field(default_factory=list)        # not baselined
    baselined: list = field(default_factory=list)           # (finding, entry)
    stale: list = field(default_factory=list)               # BaselineEntry
    unjustified: list = field(default_factory=list)         # BaselineEntry
    files: int = 0

    @property
    def ok(self) -> bool:
        """Gate verdict: new findings and unjustified baseline entries
        fail; stale entries only warn (they mean something got FIXED —
        prune with --update-baseline)."""
        return not self.new and not self.unjustified


def run_lint(
    root: str | None = None,
    paths: list[str] | None = None,
    rules: list[Rule] | None = None,
    baseline_path: str | None = None,
    use_baseline: bool = True,
    update_baseline: bool = False,
    options: dict | None = None,
) -> LintResult:
    """Run the rule set and reconcile against the baseline.

    ``paths`` restricts the scan to explicit files (fixture tests);
    default is the port's full scan set. ``update_baseline=True`` rewrites
    the baseline from the current findings (preserving justifications of
    entries that survive) instead of judging against it.
    """
    root = os.path.abspath(root or repo_root())
    if rules is None:
        from gfedntm_tpu_torch.analysis.rules import make_default_rules

        rules = make_default_rules()
    ctx = LintContext(root=root, options=dict(options or {}))
    file_paths = (
        [os.path.abspath(p) for p in paths]
        if paths is not None else collect_default_files(root)
    )
    files: list[SourceFile] = [load_source(p, root) for p in file_paths]
    by_rel = {f.rel: f for f in files}

    result = LintResult(files=len(files))
    result.findings = run_rules(rules, files, ctx)

    if not use_baseline:
        result.new = list(result.findings)
        return result

    bpath = baseline_path or default_baseline_path(root)
    entries = bl.load_baseline(bpath)
    # A subset run (explicit paths and/or a rule filter) makes no
    # statement about entries outside its scope: they are neither
    # matched nor stale, and --update-baseline must carry them (and
    # their human-authored justifications) through untouched.
    rule_names = {r.name for r in rules}
    scanned = {f.rel for f in files}
    in_scope, out_of_scope = [], []
    for e in entries:
        (in_scope if e.rule in rule_names and e.path in scanned
         else out_of_scope).append(e)
    if update_baseline:
        rebuilt = bl.build_baseline(result.findings, in_scope, by_rel)
        bl.save_baseline(bpath, rebuilt + out_of_scope)
        result.baselined = [(f, e) for f, e in zip(result.findings, rebuilt)]
        result.unjustified = [e for e in rebuilt if not e.justification.strip()]
        return result

    result.new, result.baselined, result.stale = bl.split_by_baseline(
        result.findings, in_scope, by_rel
    )
    result.unjustified = [
        e for _f, e in result.baselined if not e.justification.strip()
    ]
    return result
