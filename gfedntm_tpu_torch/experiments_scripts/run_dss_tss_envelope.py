"""Reproduce the BASELINE.md quality envelope (reference regime) over the
port.

The twin of ``experiments_scripts/run_dss_tss_envelope.py``: the same two
sweeps of :func:`gfedntm_tpu_torch.experiments.run_simulation` at the
reference's published evaluation point, eta=0.01, V=5000, K=50, 5 nodes,
10k train + 1k inference docs/node
(``experiments/dss_tss/config/eta_variable/config.json``), whose published
envelope is centralized TSS 8.679 +/- 0.042 vs non-collaborative 7.571 vs
random 3.564 (BASELINE.md). On the GPU every training step of every arm
runs the fused decoder's kernels K1-K3.

The frozen sweep first (frozen topics 40 and 5; published at 40:
centralized 8.664 +/- 0.037 vs non-collaborative 8.475 +/- 0.046), then
the eta sweep (0.01, 0.02, 0.03, 0.04, 0.08, 1.0; the eta sweep's
frozen_topics_list[1] = 10 is applied inside ``run_simulation``). Each
writes ``results.json`` (+ ``results.pickle`` when pandas is installed).

Run: python -m gfedntm_tpu_torch.experiments_scripts.run_dss_tss_envelope
[iters_eta] [iters_frozen] [out_dir] [frozen_dir] [--device cpu|cuda]
(defaults 5, 10, ``results_torch/dss_tss_eta001``,
``results_torch/dss_tss_frozen40``).
"""

from __future__ import annotations

import logging
import sys
import time

from gfedntm_tpu_torch.device import device_parser, resolve_device
from gfedntm_tpu_torch.experiments_scripts import RESULTS


def run(iters_eta: int = 5, iters_frozen: int = 10, out_dir: str | None = None,
        frozen_dir: str | None = None, device=None, **overrides) -> dict:
    """Both sweeps; returns ``{"frozen": ..., "eta": ...}``, each
    ``run_simulation``'s output with its ``seconds``. ``overrides`` are
    ``SimulationConfig`` fields applied to both sweeps (smaller corpora for
    a smoke run)."""
    from gfedntm_tpu_torch.experiments.dss_tss import SimulationConfig, run_simulation

    dev = resolve_device(device)
    out_dir = out_dir or str(RESULTS / "dss_tss_eta001")
    frozen_dir = frozen_dir or str(RESULTS / "dss_tss_frozen40")
    logging.basicConfig(level=logging.INFO, force=True)

    fcfg = SimulationConfig(**{"experiment": 0, "frozen_topics_list": (40, 5),
                               "iters": iters_frozen, "seed": 0, **overrides})
    t0 = time.perf_counter()
    fout = run_simulation(fcfg, results_dir=frozen_dir, device=dev)
    frozen_s = time.perf_counter() - t0
    fcols = fout["columns"]
    print(
        f"frozen sweep done in {frozen_s:.0f}s\n"
        f"frozen={fcfg.frozen_topics_list[0]} centralized TSS "
        f"{fcols['centralized_betas_mean'][0]:.3f} +/- {fcols['centralized_betas_std'][0]:.3f} "
        f"(refmap {fcols['centralized_betas_refmap_mean'][0]}, ref-published 8.664+/-0.037)\n"
        f"frozen={fcfg.frozen_topics_list[0]} non-collab  TSS "
        f"{fcols['non_colab_betas_mean'][0]:.3f} +/- {fcols['non_colab_betas_std'][0]:.3f} "
        f"(refmap {fcols['non_colab_betas_refmap_mean'][0]}, ref-published 8.475+/-0.046)",
        flush=True,
    )

    cfg = SimulationConfig(**{"experiment": 1,
                              "eta_list": (0.01, 0.02, 0.03, 0.04, 0.08, 1.0),
                              "iters": iters_eta, "seed": 0, **overrides})
    t0 = time.perf_counter()
    out = run_simulation(cfg, results_dir=out_dir, device=dev)
    eta_s = time.perf_counter() - t0
    cols = out["columns"]
    print(
        f"backend={dev.type} iters={iters_eta} elapsed={eta_s:.0f}s\n"
        f"centralized TSS {cols['centralized_betas_mean'][0]:.3f} "
        f"+/- {cols['centralized_betas_std'][0]:.3f} "
        f"(refmap {cols['centralized_betas_refmap_mean'][0]}, ref-published 8.679+/-0.042)\n"
        f"non-collab  TSS {cols['non_colab_betas_mean'][0]:.3f} "
        f"+/- {cols['non_colab_betas_std'][0]:.3f} "
        f"(refmap {cols['non_colab_betas_refmap_mean'][0]}, ref-published 7.571+/-0.048)\n"
        f"random      TSS {cols['baseline_betas_mean'][0]:.3f} "
        f"+/- {cols['baseline_betas_std'][0]:.3f} (ref 3.564+/-0.098)\n"
        f"centralized DSS {cols['centralized_thetas_mean'][0]:.1f} (ref 2555.5)\n"
        f"non-collab  DSS {cols['non_colab_thetas_mean'][0]:.1f} (ref 3066.7)",
        flush=True,
    )
    return {"frozen": {**fout, "seconds": frozen_s}, "eta": {**out, "seconds": eta_s}}


def main(argv: list[str] | None = None) -> int:
    p = device_parser(__doc__)
    p.add_argument("iters_eta", nargs="?", type=int, default=5)
    p.add_argument("iters_frozen", nargs="?", type=int, default=10)
    p.add_argument("out_dir", nargs="?", default=None)
    p.add_argument("frozen_dir", nargs="?", default=None)
    args = p.parse_args(argv)
    run(args.iters_eta, args.iters_frozen, args.out_dir, args.frozen_dir, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
