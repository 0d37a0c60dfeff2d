"""Rebuild a sweep's ``results.json`` (+ ``results.pickle``) from its
banked per-iteration checkpoints, without training anything.

A copy of ``experiments_scripts/aggregate_banked_envelope.py`` (numpy
only; pandas, if installed, for the pickle): it reads the checkpoints that
``gfedntm_tpu_torch.experiments.dss_tss`` banks exactly as the JAX tool
reads the JAX package's, and touches no device.

Why: ``run_simulation`` writes the aggregated ``results.json`` only when
the WHOLE sweep reaches its target depth; a deepening run that is killed
mid-sweep leaves the aggregate at its old depth even though later points
are fully banked on disk. This tool re-aggregates whatever is banked —
per-point sample counts land in ``meta.stat_counts`` and ``meta.iters``
records the MINIMUM depth across points, so a mixed-depth artifact says
exactly how deep each column is.

The digest directory is chosen as the most recently modified one under
``<results_dir>/iters`` (the one the active deepening run writes to),
then VERIFIED against the prior artifact's regime via its
``config_stamp.json`` (frozen_topics and corpus geometry must match —
the stamp exists precisely so wrong-regime checkpoints can never be
aggregated under the right-regime label, ``dss_tss.py:356-370``); the
digest is recorded in ``meta.checkpoint_digest``.

Column alignment matches ``run_simulation``: every column keeps one
entry per index point, with ``None`` for stats a point's banked files do
not carry (pre-refmap checkpoints, never-reached points).

Run: python -m gfedntm_tpu_torch.experiments_scripts.aggregate_banked_envelope
[results_dir ...] (default ``results_torch/dss_tss_eta001``). It rewrites
each directory's ``results.json`` in place.
"""

from __future__ import annotations

import collections
import json
import pickle
import sys
from pathlib import Path

import numpy as np

#: The default results directory: the port's eta sweep
#: (``run_dss_tss_envelope``'s ``out_dir``).
DEFAULT_DIR = "results_torch/dss_tss_eta001"


def _check_regime(ckpt_dir: Path, prior_meta: dict) -> None:
    """Refuse to aggregate a digest whose config stamp contradicts the
    prior artifact's recorded regime."""
    stamp_path = ckpt_dir / "config_stamp.json"
    regime = prior_meta.get("regime", {})
    if not stamp_path.exists() or not regime:
        return
    with open(stamp_path, encoding="utf8") as f:
        stamp = json.load(f)
    for key in ("frozen_topics", "vocab_size", "n_topics", "n_nodes"):
        want = regime.get(key)
        # Sweep-variable regimes record a list (e.g. the frozen sweep's
        # frozen_topics [40, 5]); the stamp carries only the base config
        # value there, so the comparison is meaningless — skip it.
        if want is None or isinstance(want, list) or key not in stamp:
            continue
        if stamp[key] != repr(want):
            raise SystemExit(
                f"digest {ckpt_dir.name} regime mismatch on {key}: "
                f"stamp={stamp[key]} vs results.json regime={want!r} — "
                "refusing to aggregate wrong-regime checkpoints"
            )


def aggregate(results_dir: str) -> dict:
    rd = Path(results_dir)
    with open(rd / "results.json", encoding="utf8") as f:
        prior = json.load(f)
    index = prior["index"]
    index_name = prior.get("index_name")
    digests = sorted(
        (p for p in (rd / "iters").iterdir() if p.is_dir()),
        key=lambda p: p.stat().st_mtime,
    )
    if not digests:
        raise SystemExit(f"no checkpoint digests under {rd}/iters")
    ckpt_dir = digests[-1]
    _check_regime(ckpt_dir, prior.get("meta", {}))

    # First pass: the union of (arm, stat) across every banked file, so
    # every column stays len(index)-aligned (None where a point lacks the
    # stat — mirroring run_simulation's placeholder behavior).
    all_stats: set[tuple[str, str]] = set()
    point_files: dict = {}
    for point in index:
        files = sorted(
            ckpt_dir.glob(f"point{point}_it*.json"),
            key=lambda p: int(p.stem.rsplit("_it", 1)[1]),
        )
        loaded = []
        for path in files:
            with open(path, encoding="utf8") as f:
                loaded.append(json.load(f))
        point_files[point] = loaded
        for res in loaded:
            for arm, stats in res.items():
                if arm.startswith("_"):
                    continue
                all_stats.update((arm, stat) for stat in stats)

    columns: dict[str, list] = collections.defaultdict(list)
    stat_counts: dict[str, list] = collections.defaultdict(list)
    iter_backends: list[str] = []
    depths: list[int] = []
    for point in index:
        loaded = point_files[point]
        depths.append(len(loaded))
        per_iter: dict[tuple[str, str], list] = collections.defaultdict(list)
        for res in loaded:
            iter_backends.append(res.get("_backend", "unknown"))
            for arm, stats in res.items():
                if arm.startswith("_"):
                    continue
                for stat, val in stats.items():
                    per_iter[(arm, stat)].append(val)
        for arm, stat in sorted(all_stats):
            vals = np.asarray(per_iter.get((arm, stat), []), dtype=float)
            columns[f"{arm}_{stat}_mean"].append(
                float(vals.mean()) if vals.size else None
            )
            columns[f"{arm}_{stat}_std"].append(
                float(vals.std()) if vals.size else None
            )
            stat_counts[f"{arm}_{stat}"].append(int(vals.size))

    meta = dict(prior.get("meta", {}))
    meta.update(
        {
            "backend": "checkpoint-aggregate",
            "iter_backends": iter_backends,
            "stat_counts": dict(stat_counts),
            "iters": min(depths) if depths else 0,
            "iters_per_point": dict(zip(map(str, index), depths)),
            "aggregated_from_checkpoints": True,
            "checkpoint_digest": ckpt_dir.name,
            # Aggregation itself is ~instant; keep the prior run's compute
            # cost if recorded (the banked iterations are what cost hours).
            "elapsed_s": meta.get("elapsed_s") or 0.1,
        }
    )
    out = {
        "index": index,
        "index_name": index_name,
        "columns": dict(columns),
        "meta": meta,
    }
    # Atomic replace: results.json is also this tool's own input — a crash
    # mid-write must not brick re-runs (same tmp+rename as dss_tss.py).
    tmp = rd / "results.json.tmp"
    with open(tmp, "w", encoding="utf8") as f:
        json.dump(out, f, indent=2)
    tmp.rename(rd / "results.json")
    try:
        import pandas as pd

        df = pd.DataFrame(
            out["columns"], index=pd.Index(index, name=index_name)
        )
        with open(rd / "results.pickle", "wb") as f:
            pickle.dump(df, f)
    except ImportError:
        pass
    return out


def main(argv: list[str] | None = None) -> int:
    for results_dir in (sys.argv[1:] if argv is None else argv) or [DEFAULT_DIR]:
        out = aggregate(results_dir)
        print(
            json.dumps(
                {
                    "dir": results_dir,
                    "digest": out["meta"]["checkpoint_digest"],
                    "iters_per_point": out["meta"]["iters_per_point"],
                }
            )
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
