#!/usr/bin/env python3
"""Push-pacing round-length probe for the PyTorch port on one GPU.

Runs ``chip_smoke.py``'s phase 12(c) federation (a port server at
``push:2`` under the delta codec and three port clients on the card, V from
phase 7(b)'s corpora plus a third client) once per ``E/EPOCHS`` argument,
each with ``local_steps=E`` (the length of a push client's own round) and
``num_epochs=EPOCHS``, and prints each run's aggregations, the updates each
drain took, its local steps and seconds, then phase 12(d) (the simulated
fleet):

    python3 scripts/torch_push_probe.py 8/24 16/40 32/64

Run from the repository root on a machine with CUDA. A drain far above
B=2 means the clients push faster than the server decodes.
"""

import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main(argv: list[str]) -> int:
    from gfedntm_tpu_torch.device import resolve_device
    from gfedntm_tpu_torch.ops import _build

    card = cs.card_line()
    print(card, flush=True)
    resolve_device(None)
    _build.build()
    try:
        probe(card, argv)
    finally:
        shutil.rmtree(cs.CORPORA, ignore_errors=True)
        shutil.rmtree(cs.SCRATCH, ignore_errors=True)
    return 0


def probe(card: str, argv: list[str]) -> None:
    raw = cs.pacing_corpora(card)
    for arg in argv:
        steps, epochs = (int(v) for v in arg.split("/"))
        t0 = time.perf_counter()
        try:
            server, clients, log, times = cs.pacing_federation(
                card, {"stats": "", "loss": "", "grads": ""}, raw, f"c-E{steps}",
                num_epochs=epochs, pacing_policy="push:2", wire_codec="delta",
                local_steps=steps)
        except cs.SmokeFailure as err:
            print(f"probe E={steps} epochs={epochs}: failed: {err}", flush=True)
            continue
        drains = [e["buffered"] for e in log.events("push_aggregated")]
        print(f"probe E={steps} epochs={epochs}: {len(drains)} aggregations of {drains} "
              f"updates, {sum(len(c.steps) for c in clients)} local steps, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        cs.pacing_times(card, f"c-E{steps}", server, clients, log, times)
    cs.sim_fleet_phase(card)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
