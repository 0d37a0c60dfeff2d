"""Full federated fit at production vocabulary (V=50k/100k) over the port,
with the fused decoder's CUDA kernels on every client step.

The twin of ``experiments_scripts/run_full_v100k.py``. The reference's
preprocessing targets vocabularies up to 100k (``text_preproc.py:49``
keep_n); that regime is what the fused decode + loss kernels K1-K3 are
for. A 5-client federated ProdLDA fit end to end (synthetic corpus,
``FederatedTrainer``) at V in {50k, 100k}, float32 and bf16 storage
(``compute_dtype="bfloat16"``), 20 epochs, B=64, H=(50, 50): throughput,
quality (ground-truth TSS) and the in-fit HBM share.

Corpus sizing keeps the dense BoW ~1.3 GB (640 docs/node at V=100k, 1280
at V=50k): the per-step math is the production regime ([64, V] batches
against a [50, V] beta), corpus depth only bounds how many distinct steps
exist. As in the JAX script a warm fit (staging, first launches) precedes
the timed one, both full fits of the same corpus.

Three things differ from the JAX script: the JAX tile (``resolve_tile_v``,
XLA's) has no meaning here, so each case records the K1-K3 launches of its
timed fit and the kernels' route instead; the HBM share is taken against
the card's memory rate (``utils.flops.CARD_PEAKS``, which
``chip_smoke.kernel_bound`` reads too: 3.35 TB/s on the H100 SXM), not the
v5e's 819 GB/s; and a failing case raises, where the JAX script records it
and goes on.

Run: python -m gfedntm_tpu_torch.experiments_scripts.run_full_v100k
[out_json] [--device cpu|cuda]; writes ``results_torch/full_largev/metrics.json``
by default. ``LARGEV_SMOKE=1`` (or ``run(cases=)``) runs V=2048 with 128
docs/node instead.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from gfedntm_tpu_torch.device import device_parser, resolve_device
from gfedntm_tpu_torch.experiments_scripts import (
    RESULTS,
    card,
    storage_kernels,
    synchronize,
    tss_of,
)
from gfedntm_tpu_torch.ops.fused_decoder import launch_counts, launches_since
from gfedntm_tpu_torch.utils.flops import card_peaks

N_NODES, K, BATCH = 5, 50, 64
EPOCHS = 20
SEED = 0
CASES = ((50_000, 1280), (100_000, 640))
SMOKE_CASES = ((2048, 128),)


def make_corpus(V: int, docs_per_node: int):
    from gfedntm_tpu_torch.data.synthetic import generate_synthetic_corpus

    return generate_synthetic_corpus(
        vocab_size=V, n_topics=K, n_docs=docs_per_node, nwords=(150, 250),
        n_nodes=N_NODES, frozen_topics=5, seed=SEED, materialize_docs=False,
    )


def kernel_route(dev, compute_dtype: str) -> dict:
    """Each of K1-K3's route at (B, K) and the storage, on the card; the
    plain versions on the CPU."""
    if dev.type != "cuda":
        return dict.fromkeys(("stats", "loss", "grads"), "plain PyTorch (CPU tensors)")
    from gfedntm_tpu_torch.ops import _build
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    lib = _build.load()
    return {kind: fd.ROUTE_NAMES[fd._route(lib, kind, BATCH, K, compute_dtype)]
            for kind in ("stats", "loss", "grads")}


def run_case(V: int, docs_per_node: int, compute_dtype: str, epochs: int = EPOCHS,
             corpus=None, device=None) -> dict:
    """One case: a warm fit, then the timed fit, of 5 clients at ``V``;
    ``corpus`` (from :func:`make_corpus`) saves generating it again."""
    from gfedntm_tpu_torch.data.datasets import BowDataset
    from gfedntm_tpu_torch.federated.trainer import FederatedTrainer
    from gfedntm_tpu_torch.models.avitm import AVITM

    dev = resolve_device(device)
    t0 = time.perf_counter()
    if corpus is None:
        corpus = make_corpus(V, docs_per_node)
    idx2token = {i: f"wd{i}" for i in range(V)}
    datasets = [BowDataset(X=node.bow, idx2token=idx2token) for node in corpus.nodes]
    gen_s = time.perf_counter() - t0

    template = AVITM(
        input_size=V, n_components=K, hidden_sizes=(50, 50), batch_size=BATCH,
        num_epochs=epochs, lr=2e-3, momentum=0.99, seed=SEED, fused_decoder="auto",
        compute_dtype=compute_dtype, device=dev,
    )
    trainer = FederatedTrainer(template, n_clients=N_NODES, device=dev)
    counters = storage_kernels(compute_dtype)

    # Warm fit: stages the corpus and pays the first launches; the timed
    # fit below repeats it.
    before = launch_counts(counters)
    synchronize(dev)
    t0 = time.perf_counter()
    trainer.fit(datasets)
    synchronize(dev)
    compile_s = time.perf_counter() - t0
    warm_launches = launches_since(before)

    before = launch_counts(counters)
    t0 = time.perf_counter()
    result = trainer.fit(datasets)
    synchronize(dev)
    steady_s = time.perf_counter() - t0
    launches = launches_since(before)

    steps = int(result.losses.shape[0])
    docs_per_s = steps * N_NODES * BATCH / steady_s
    step_ms = steady_s / steps * 1e3
    # In-fit HBM share (analytic, loss path only, the JAX script's count):
    # per client step the fused loss streams beta 3x and x 2x at storage
    # width plus one f32 g_beta write; the encoder adds ~3 reads of its
    # [V, 50] weights and grads (f32).
    sb = 2.0 if compute_dtype == "bfloat16" else 4.0
    loss_bytes = sb * (3 * K * V + 2 * BATCH * V) + 4.0 * K * V
    enc_bytes = 3 * 4.0 * (V * 50) + 2 * sb * BATCH * V
    bytes_per_step = (loss_bytes + enc_bytes) * trainer.c_pad
    hbm_gbs = bytes_per_step / (step_ms / 1e3) / 1e9
    peak_bytes_s = card_peaks(card(dev)["name"])[0]

    gm = trainer.make_global_model(result, dataset=datasets[0])
    tss = tss_of(gm.model.beta.detach().float().cpu().numpy(), corpus.topic_vectors, idx2token)
    from gfedntm_tpu_torch.eval.metrics import topic_similarity_score

    rand_floor = float(topic_similarity_score(
        np.random.default_rng(SEED + 9).dirichlet(np.full(V, 0.01), K), corpus.topic_vectors))
    return {
        "vocab": V,
        "docs_per_node": docs_per_node,
        "compute_dtype": compute_dtype,
        "fused_decoder_engaged": bool(template.fused_decoder),
        "launches": launches,
        "warm_launches": warm_launches,
        "client_steps": int(result.losses.size),
        "kernel_route": kernel_route(dev, compute_dtype),
        "global_steps": steps,
        "steady_fit_s": round(steady_s, 2),
        "step_ms": round(step_ms, 3),
        "docs_per_s": round(docs_per_s, 1),
        "compile_and_first_fit_s": round(compile_s, 1),
        "corpus_gen_s": round(gen_s, 1),
        "staged_corpus_gb": round(trainer.c_pad * docs_per_node * V * 4 / 1e9, 2),
        "in_fit_hbm_gb_per_s_analytic": round(hbm_gbs, 1),
        "in_fit_hbm_util_analytic": round(hbm_gbs * 1e9 / peak_bytes_s, 3),
        "final_mean_loss": float(np.asarray(result.losses)[-1].mean()),
        "tss_vs_ground_truth": round(tss, 3),
        "tss_max": K,
        "tss_random_floor": round(rand_floor, 3),
    }


def run(out_path: str | None = None, cases=None, epochs: int = EPOCHS, device=None) -> dict:
    """Every case, float32 and bf16 on one corpus per V; returns the report,
    written to ``out_path`` (default ``results_torch/full_largev/metrics.json``)."""
    dev = resolve_device(device)
    if cases is None:
        cases = SMOKE_CASES if os.environ.get("LARGEV_SMOKE") else CASES
    report: dict = {"backend": dev.type, "device": card(dev), "epochs": epochs, "cases": {}}
    for V, docs in cases:
        t0 = time.perf_counter()
        corpus = make_corpus(V, docs)
        gen_s = time.perf_counter() - t0
        for dtype in ("float32", "bfloat16"):
            key = f"V{V}_{dtype}"
            report["cases"][key] = run_case(V, docs, dtype, epochs, corpus=corpus, device=dev)
            # One corpus serves both storages: its generation, once.
            report["cases"][key]["corpus_gen_s"] = round(gen_s, 1)
            print(f"{key}: {json.dumps(report['cases'][key])[:300]}", flush=True)
        del corpus
    out_path = out_path or str(RESULTS / "full_largev" / "metrics.json")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report


def main(argv: list[str] | None = None) -> int:
    p = device_parser(__doc__)
    p.add_argument("out_json", nargs="?", default=None)
    args = p.parse_args(argv)
    run(out_path=args.out_json, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
