"""graftlint baseline: fail only on *new* findings (a copy of
``gfedntm_tpu/analysis/baseline.py``).

A baseline entry pins one accepted finding by ``(rule, path, the
stripped source text of its anchor line, ordinal)`` — content-keyed, so
unrelated edits that shift line numbers don't invalidate it, while
editing the offending line itself (or fixing it) does. Every entry MUST
carry a non-empty ``justification``: a baseline is a reviewed decision,
not a mute button. Entries whose finding disappeared are *stale* — the
run reports them (exit stays 0) and ``--update-baseline`` prunes them.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from gfedntm_tpu_torch.analysis.core import Finding, SourceFile

__all__ = [
    "BaselineEntry",
    "BaselineError",
    "load_baseline",
    "save_baseline",
    "split_by_baseline",
    "build_baseline",
]

VERSION = 1


class BaselineError(ValueError):
    """Malformed baseline file (bad JSON, wrong version, missing keys)."""


@dataclass(frozen=True)
class BaselineEntry:
    rule: str        # rule *name* (stable across id renumbering)
    path: str        # repo-relative
    line_text: str   # stripped anchor-line source at baseline time
    index: int       # ordinal among findings sharing (rule, path, line_text)
    justification: str

    @property
    def key(self) -> tuple[str, str, str, int]:
        return (self.rule, self.path, self.line_text, self.index)


def load_baseline(path: str) -> list[BaselineEntry]:
    if not os.path.exists(path):
        return []
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, json.JSONDecodeError) as err:
        raise BaselineError(f"unreadable baseline {path}: {err}") from err
    if not isinstance(doc, dict) or doc.get("version") != VERSION:
        raise BaselineError(
            f"baseline {path} has version {doc.get('version')!r}, "
            f"expected {VERSION}"
        )
    entries = []
    for i, raw in enumerate(doc.get("entries", ())):
        try:
            entries.append(BaselineEntry(
                rule=raw["rule"], path=raw["path"],
                line_text=raw["line_text"], index=int(raw.get("index", 0)),
                justification=str(raw.get("justification", "")),
            ))
        except (KeyError, TypeError, ValueError) as err:
            raise BaselineError(
                f"baseline {path} entry {i} is malformed: {err}"
            ) from err
    return entries


def save_baseline(path: str, entries: list[BaselineEntry]) -> None:
    doc = {
        "version": VERSION,
        "entries": [
            {
                "rule": e.rule, "path": e.path, "line_text": e.line_text,
                "index": e.index, "justification": e.justification,
            }
            for e in sorted(
                entries, key=lambda e: (e.path, e.rule, e.line_text, e.index)
            )
        ],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2)
        fh.write("\n")


def _finding_keys(
    findings: list[Finding], files_by_rel: dict[str, SourceFile]
) -> list[tuple[Finding, tuple[str, str, str, int]]]:
    """Content keys for current findings, with per-(rule, path, text)
    ordinals assigned in line order."""
    counters: dict[tuple[str, str, str], int] = {}
    keyed = []
    for f in sorted(findings, key=lambda f: (f.path, f.line)):
        src = files_by_rel.get(f.path)
        text = src.line_text(f.line) if src is not None else ""
        base = (f.rule_name, f.path, text)
        idx = counters.get(base, 0)
        counters[base] = idx + 1
        keyed.append((f, base + (idx,)))
    return keyed


def split_by_baseline(
    findings: list[Finding],
    entries: list[BaselineEntry],
    files_by_rel: dict[str, SourceFile],
) -> tuple[list[Finding], list[tuple[Finding, BaselineEntry]], list[BaselineEntry]]:
    """Partition current findings against the baseline: returns
    ``(new, baselined, stale_entries)``."""
    remaining: dict[tuple, BaselineEntry] = {e.key: e for e in entries}
    new: list[Finding] = []
    baselined: list[tuple[Finding, BaselineEntry]] = []
    for f, key in _finding_keys(findings, files_by_rel):
        entry = remaining.pop(key, None)
        if entry is None:
            new.append(f)
        else:
            baselined.append((f, entry))
    stale = sorted(
        remaining.values(), key=lambda e: (e.path, e.rule, e.index)
    )
    return new, baselined, stale


def build_baseline(
    findings: list[Finding],
    previous: list[BaselineEntry],
    files_by_rel: dict[str, SourceFile],
) -> list[BaselineEntry]:
    """Baseline entries for the current findings, carrying forward the
    justification of any previous entry with the same key (new entries
    get an empty justification the operator must fill in before the
    gate passes)."""
    prev = {e.key: e for e in previous}
    out = []
    for _f, key in _finding_keys(findings, files_by_rel):
        old = prev.get(key)
        out.append(BaselineEntry(
            rule=key[0], path=key[1], line_text=key[2], index=key[3],
            justification=old.justification if old is not None else "",
        ))
    return out
