"""graftlint CLI over the port: ``python -m gfedntm_tpu_torch.analysis``.

The flags and exit codes are those of ``python -m gfedntm_tpu.analysis``.

Exit codes: 0 = clean (baselined-with-justification and stale-baseline
warnings allowed), 1 = new findings or unjustified baseline entries,
2 = usage/internal error.
"""

from __future__ import annotations

import argparse
import sys

from gfedntm_tpu_torch.analysis.baseline import BaselineError
from gfedntm_tpu_torch.analysis.runner import (
    default_baseline_path,
    repo_root,
    run_lint,
)
from gfedntm_tpu_torch.analysis.rules import make_default_rules


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graftlint",
        description=(
            "static analysis of the PyTorch port: telemetry contract, "
            "precision pins, donation safety, lock discipline, exception "
            "hygiene, rng discipline"
        ),
    )
    p.add_argument(
        "paths", nargs="*",
        help="explicit files to lint (default: the port's whole scan set)",
    )
    p.add_argument("--root", default=None, help="repo root (default: auto)")
    p.add_argument(
        "--baseline", default=None,
        help=(
            "baseline file (default: "
            "<root>/gfedntm_tpu_torch/analysis/lint_baseline.json)"
        ),
    )
    p.add_argument(
        "--no-baseline", action="store_true",
        help="judge every finding as new (ignore the baseline)",
    )
    p.add_argument(
        "--update-baseline", action="store_true",
        help=(
            "rewrite the baseline from the current findings, preserving "
            "justifications of surviving entries; new entries get an "
            "empty justification you MUST fill in"
        ),
    )
    p.add_argument(
        "--rules", default=None,
        help="comma-separated rule names to run (default: all)",
    )
    p.add_argument(
        "--list-rules", action="store_true",
        help="print the rule table and exit",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    if args.no_baseline and args.update_baseline:
        print(
            "graftlint: --no-baseline and --update-baseline conflict "
            "(there is no baseline to rewrite without baseline mode)",
            file=sys.stderr,
        )
        return 2
    rules = make_default_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.id}  {r.name:20s} {r.description}")
        return 0
    if args.rules:
        wanted = {n.strip() for n in args.rules.split(",") if n.strip()}
        unknown = wanted - {r.name for r in rules}
        if unknown:
            print(
                f"graftlint: unknown rule(s) {sorted(unknown)} "
                f"(want {sorted(r.name for r in rules)})",
                file=sys.stderr,
            )
            return 2
        rules = [r for r in rules if r.name in wanted]

    root = args.root
    try:
        result = run_lint(
            root=root,
            paths=args.paths or None,
            rules=rules,
            baseline_path=args.baseline,
            use_baseline=not args.no_baseline,
            update_baseline=args.update_baseline,
        )
    except BaselineError as err:
        print(f"graftlint: {err}", file=sys.stderr)
        return 2

    bpath = args.baseline or default_baseline_path(root or repo_root())
    if args.update_baseline:
        print(
            f"graftlint: baseline rewritten with "
            f"{len(result.findings)} finding(s) -> {bpath}"
        )
        if result.unjustified:
            print(
                f"graftlint: {len(result.unjustified)} entr"
                f"{'y' if len(result.unjustified) == 1 else 'ies'} carry "
                "an empty justification — fill them in before the gate "
                "passes:", file=sys.stderr,
            )
            for e in result.unjustified:
                print(f"  {e.path}: [{e.rule}] {e.line_text}",
                      file=sys.stderr)
        return 0

    for f in result.new:
        print(f.render(), file=sys.stderr)
    for e in result.stale:
        print(
            f"graftlint: stale baseline entry (finding fixed?) "
            f"{e.path}: [{e.rule}] {e.line_text!r} — prune with "
            "--update-baseline",
            file=sys.stderr,
        )
    for e in result.unjustified:
        print(
            f"graftlint: baselined finding WITHOUT justification "
            f"{e.path}: [{e.rule}] {e.line_text!r} — edit {bpath}",
            file=sys.stderr,
        )
    n_rules = len(rules)
    print(
        f"graftlint: {result.files} files, {n_rules} rules -> "
        f"{len(result.new)} new finding(s), "
        f"{len(result.baselined)} baselined, {len(result.stale)} stale "
        "baseline entr" + ("y" if len(result.stale) == 1 else "ies")
    )
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
