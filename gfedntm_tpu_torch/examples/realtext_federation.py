"""Real-text federation over the port, on the offline docstring corpus,
with the local-steps FedAvg fix, scaled down to a smoke run.

The twin of ``examples/realtext_federation.py`` (the flow of
``results/realtext_federated/``): the port's
:func:`~gfedntm_tpu_torch.presets.realtext_docstrings_5client` at
``scale=0.1`` (300 documents a client, 10 epochs), ``n_components=10`` and
``local_steps=10``. The corpus needs no download: it is the installed
Python packages' docstrings, one client per package family (math, deep
learning, cloud RPC, NLP, data analysis), a non-IID split in the sense of
the reference's fieldsOfStudy partitioning (``docker-compose.yaml:21-149``).
``local_steps`` is the FedAvg exchange period: 1 is the reference's
per-minibatch averaging, a few local epochs between exchanges recover
centralized-level coherence. On the GPU each client step runs the fused
decoder's kernels K1-K3.

Run: python -m gfedntm_tpu_torch.examples.realtext_federation [--device cpu|cuda]
"""

from __future__ import annotations

import sys

from gfedntm_tpu_torch.device import device_parser, resolve_device
from gfedntm_tpu_torch.examples import report

NOTE = (
    "\nNOTE: scale=0.1 is a smoke demo (300 docs/client, 10 epochs) — "
    "coherence needs the full corpus. Full-scale evidence: "
    "results/realtext_federated/metrics.json (federated local_steps "
    "NPMI +0.21, centralized +0.20)."
)


def run(scale: float = 0.1, n_components: int = 10, local_steps: int = 10, seed: int = 0,
        device=None) -> dict:
    """The script's flow; returns its printed values and the global model
    (``models["global"]``, its ``train_data`` client 0's dataset)."""
    from gfedntm_tpu_torch.presets import realtext_docstrings_5client

    device = resolve_device(device)
    # scale=0.1 -> 300 docs/client, 10 epochs; local_steps = 2 local epochs
    # between exchanges (at 300 docs and batch 64 that is 2 * 5 steps).
    res = realtext_docstrings_5client(scale=scale, seed=seed, n_components=n_components,
                                      local_steps=local_steps, device=device)
    consensus = res.extras["consensus"]
    return {
        "device": str(device),
        "n_clients": res.summary["n_clients"],
        "vocab_size": res.summary["vocab_size"],
        "global_steps": res.summary["global_steps"],
        "client_steps": int(res.result.losses.size),
        "final_mean_loss": res.summary["final_mean_loss"],
        "losses": res.result.losses,
        "corpus_info": res.summary["corpus_info"],
        "metrics": res.summary["metrics"],
        "topics": res.extras["topics"][:5],
        "models": {"global": res.trainer.make_global_model(res.result,
                                                           dataset=consensus.datasets[0])},
    }


def lines(out: dict) -> list[str]:
    """The JAX script's printed lines."""
    return ([f"clients: {out['n_clients']} vocab: {out['vocab_size']} steps: "
             f"{out['global_steps']}",
             f"metrics: {out['metrics']}"]
            + [f"topic {i}: {' '.join(topic)}" for i, topic in enumerate(out["topics"])]
            + [NOTE])


def main(argv: list[str] | None = None) -> int:
    return report(run, lines, device_parser(__doc__).parse_args(argv).device)


if __name__ == "__main__":
    sys.exit(main())
