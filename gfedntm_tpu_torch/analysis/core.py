"""graftlint core: parse/walk infrastructure shared by every analyzer.

A copy of ``gfedntm_tpu/analysis/core.py`` with the port's scan set.

The framework is deliberately small: a :class:`SourceFile` wraps one
parsed module (text, AST, per-line ``# graftlint: disable=...``
suppressions), a :class:`Rule` contributes :class:`Finding`\\ s over a
list of source files, and :func:`run_rules` drives the set and filters
suppressed findings. Baseline handling (so the gate fails only on *new*
findings) lives in :mod:`gfedntm_tpu_torch.analysis.baseline`; the CLI in
``__main__``.

Rules are registered in
:func:`gfedntm_tpu_torch.analysis.rules.make_default_rules` — adding an
analyzer is: subclass :class:`Rule`, give it a unique ``id``/``name``,
implement :meth:`Rule.check_file` (or :meth:`Rule.check_repo` for
cross-file contracts), and add an instance to that list (see README
"Static analysis in the port").
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator

__all__ = [
    "Finding",
    "SourceFile",
    "Rule",
    "LintContext",
    "collect_default_files",
    "load_source",
    "run_rules",
]

#: Inline suppression: ``# graftlint: disable=<rule-name>[,<rule-name>...]``
#: (or ``disable=all``). Applies to findings anchored on the same physical
#: line, or — when the comment is the whole line — to the next
#: non-comment, non-blank line. Anything after the rule list (e.g. an
#: ``-- why`` justification) is free text for the reader.
_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable=([\w\-]+(?:\s*,\s*[\w\-]+)*)"
)

#: Default scan set relative to the repo root: the port's package and its
#: card smoke. tests/test_torch_chaos.py (the port's twin of tests/chaos)
#: rides along for GL005 only (its path scope): the chaos harness's
#: supervision loops must not swallow failures silently — a green
#: kill-test that hid its errors proved nothing. The rest of tests/ stays
#: out of scope.
DEFAULT_SCAN_ROOTS = (
    "gfedntm_tpu_torch", "chip_smoke.py", "tests/test_torch_chaos.py",
)


@dataclass(frozen=True)
class Finding:
    """One ``file:line``-anchored diagnostic."""

    rule_id: str     # stable short id, e.g. "GL002"
    rule_name: str   # human name, e.g. "precision-pin"
    path: str        # repo-relative, forward slashes
    line: int        # 1-based anchor line
    message: str
    hint: str = ""   # how to fix (or legitimately suppress) it

    def render(self) -> str:
        out = (
            f"{self.path}:{self.line}: "
            f"[{self.rule_name} {self.rule_id}] {self.message}"
        )
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


class SourceFile:
    """One parsed module: text, line table, AST, and suppressions.

    ``path`` is the absolute filesystem path; ``rel`` the repo-relative
    path every finding and baseline entry uses. A file that fails to
    parse keeps ``tree=None`` and carries the syntax error in
    ``parse_error`` — the runner turns that into a finding rather than
    crashing the whole lint.
    """

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree: ast.AST | None = None
        self.parse_error: SyntaxError | None = None
        try:
            self.tree = ast.parse(text, filename=rel)
        except SyntaxError as err:
            self.parse_error = err
        self._suppressed = self._parse_suppressions()

    def _parse_suppressions(self) -> dict[int, frozenset[str]]:
        """Map of 1-based line -> set of suppressed rule names ('all'
        suppresses everything on that line)."""
        out: dict[int, set[str]] = {}
        pending: set[str] | None = None
        for i, raw in enumerate(self.lines, start=1):
            stripped = raw.strip()
            m = _SUPPRESS_RE.search(raw)
            names: set[str] | None = None
            if m:
                names = {
                    n.strip() for n in m.group(1).split(",") if n.strip()
                }
            if names and stripped.startswith("#"):
                # Comment-only line: the suppression targets the next
                # code line (accumulate across stacked comments).
                pending = (pending or set()) | names
                continue
            here: set[str] = set(names or ())
            if pending and stripped and not stripped.startswith("#"):
                here |= pending
                pending = None
            if here:
                out[i] = here
        return {k: frozenset(v) for k, v in out.items()}

    def is_suppressed(self, rule_name: str, line: int) -> bool:
        names = self._suppressed.get(line)
        if not names:
            return False
        return "all" in names or rule_name in names

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""


@dataclass
class LintContext:
    """Shared run state handed to every rule: the repo root (for
    anchoring cross-file findings) and per-rule option overrides —
    tests use ``options`` to point the telemetry rule at a fixture
    schema instead of importing the live one."""

    root: str
    options: dict[str, Any] = field(default_factory=dict)


class Rule:
    """Base analyzer. Subclasses set ``id``/``name``/``description`` and
    implement :meth:`check_file` (per-module rules) or :meth:`check_repo`
    (cross-file contracts like the telemetry schema). ``paths`` scopes the
    rule to repo-relative path prefixes; ``None`` means every scanned
    file. Constructor kwargs override the class defaults so tests can
    re-scope a rule onto fixture files."""

    id: str = "GL000"
    name: str = "base"
    description: str = ""
    #: repo-relative path prefixes this rule applies to (None = all).
    default_paths: tuple[str, ...] | None = None

    def __init__(self, paths: tuple[str, ...] | None = None):
        self.paths = paths if paths is not None else self.default_paths

    def applies_to(self, rel: str) -> bool:
        if self.paths is None:
            return True
        return any(rel == p or rel.startswith(p) for p in self.paths)

    def check_file(self, src: SourceFile, ctx: LintContext) -> Iterable[Finding]:
        return ()

    def check_repo(
        self, files: list[SourceFile], ctx: LintContext
    ) -> Iterable[Finding]:
        return ()

    # -- shared helpers ------------------------------------------------
    def finding(
        self, src_or_rel, line: int, message: str, hint: str = ""
    ) -> Finding:
        rel = src_or_rel.rel if isinstance(src_or_rel, SourceFile) else src_or_rel
        return Finding(self.id, self.name, rel, int(line), message, hint)


def load_source(path: str, root: str) -> SourceFile:
    rel = os.path.relpath(os.path.abspath(path), os.path.abspath(root))
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    return SourceFile(os.path.abspath(path), rel, text)


def collect_default_files(root: str) -> list[str]:
    """The default scan set: every ``.py`` under ``gfedntm_tpu_torch/``
    (the analysis package lints itself too) plus ``chip_smoke.py`` and the
    chaos tests."""
    paths: list[str] = []
    for entry in DEFAULT_SCAN_ROOTS:
        full = os.path.join(root, entry)
        if os.path.isfile(full):
            paths.append(full)
            continue
        for dirpath, dirs, files in os.walk(full):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            paths.extend(
                os.path.join(dirpath, f) for f in files if f.endswith(".py")
            )
    return sorted(paths)


def run_rules(
    rules: Iterable[Rule],
    files: list[SourceFile],
    ctx: LintContext,
) -> list[Finding]:
    """Run every rule over its in-scope files and return the surviving
    (non-suppressed) findings sorted by location. Unparseable files
    surface as one finding each (the compileall gate catches them too,
    but the lint must not crash on them)."""
    findings: list[Finding] = []
    by_rel = {f.rel: f for f in files}
    for src in files:
        if src.parse_error is not None:
            findings.append(Finding(
                "GL000", "parse", src.rel,
                src.parse_error.lineno or 1,
                f"file does not parse: {src.parse_error.msg}",
            ))
    for rule in rules:
        scoped = [
            f for f in files
            if rule.applies_to(f.rel) and f.parse_error is None
        ]
        findings.extend(rule.check_repo(scoped, ctx))
        for src in scoped:
            findings.extend(rule.check_file(src, ctx))
    kept = []
    for f in findings:
        src = by_rel.get(f.path)
        if src is not None and src.is_suppressed(f.rule_name, f.line):
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.rule_id, f.message))
    return kept


def iter_scopes(tree: ast.AST) -> Iterator[tuple[ast.AST, list]]:
    """Yield ``(scope_node, body)`` for the module and every (possibly
    nested) function — each function body EXCLUDES statements that belong
    to functions nested inside it, so per-scope analyses (taint tracking,
    donation liveness) don't leak across closure boundaries. Lambdas are
    scopes too (their body is a single expression): an unpinned gram
    matmul hiding in a lambda must not be invisible."""
    yield tree, _own_body(tree)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, _own_body(node)
        elif isinstance(node, ast.Lambda):
            yield node, [node.body]


def _own_body(scope: ast.AST) -> list[ast.stmt]:
    return list(getattr(scope, "body", []))


def walk_scope(scope_body: list) -> Iterator[ast.AST]:
    """``ast.walk`` over a scope's statements (or a lambda's body
    expression), pruning nested function bodies (their *signatures* —
    decorators/defaults — still belong to the enclosing scope and are
    yielded)."""
    stack: list[ast.AST] = list(scope_body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # A nested def's BODY belongs to its own scope; only its
            # signature parts evaluate in the enclosing one. (The prune
            # applies whether the def arrived as a body statement or as
            # a child — both land on this stack.)
            stack.extend(node.decorator_list)
            stack.extend(node.args.defaults)
            stack.extend(
                d for d in (node.args.kw_defaults or []) if d is not None
            )
            continue
        if isinstance(node, ast.Lambda):
            continue
        stack.extend(ast.iter_child_nodes(node))


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a pure Name/Attribute chain (``torch.cuda.manual_seed``
    -> ``"torch.cuda.manual_seed"``); None for anything else (a call, a
    subscript)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def expr_roots(node: ast.AST) -> set[str]:
    """Every root Name loaded anywhere inside an expression."""
    roots: set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
            roots.add(n.id)
    return roots
