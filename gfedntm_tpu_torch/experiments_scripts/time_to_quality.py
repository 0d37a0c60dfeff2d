"""North-star time to quality on one device: wall-clock to a TSS target of
the port's federated path against plain PyTorch, on the same corpus.

The twin of ``experiments_scripts/time_to_quality.py``. BASELINE.json's
metric is "5-client federated ProdLDA reaches PyTorch-GPU NPMI in <= 1/4
the wall-clock"; on the card both sides of it run on the same GPU. The
corpus is the JAX script's: the reference's evaluation regime, V=5,000,
K=50, 5 nodes x 2,000 documents, eta 0.01, alpha 0.1, 5 frozen topics
(``experiments/dss_tss/config/eta_variable/config.json`` cut to 2,000
documents a node), bitwise the JAX package's corpus. Quality is TSS
against the generator's topics (one softmax, the correct word mapping).

Arms (same corpus, same scorer, 100 epochs, B=64, H=(100, 100), Adam lr
2e-3, beta1 0.99):

- **torch centralized**: :class:`~gfedntm_tpu_torch.experiments_scripts.
  torch_baseline._LocalTorchAVITM` (plain PyTorch, cuBLAS) trained on the
  union BoW, one epoch a snapshot. The JAX script trains the reference's
  AVITM on its ``prepare_dataset``'s vocabulary; neither is in this
  repository, so the local reference-equivalent model takes the union BoW
  (the same words, in generator order).
- **torch federated**: the same model, one per client; each global step
  every client takes one minibatch step, then every floating state-dict
  entry is averaged and written back (``federated_avitm.py:51-83``,
  ``server.py:476-487``): the reference's compute floor.
- **the port, federated**: ``FederatedTrainer.fit(segment_callback=)``,
  client 0's beta snapshotted after each epoch's segment, after one untimed
  warm fit of one epoch; on the GPU every client step launches K1-K3.
- **two local-steps arms**: the port's trainer with ``local_steps`` E = one
  epoch (32) and five (160).

Every arm gets one untimed warm step (or fit) first: the CUDA context,
cuBLAS handles and the allocator are paid there. A snapshot's time is
taken after its copy to the host, which synchronises. TF32 stays off for
every arm (``resolve_device``); the artifact records it.

Then, as the JAX script: final NPMI and top-10 diversity per arm, the
ladder of TSS targets at 80/90/95/99% of the way from the random baseline
to the joint federated plateau, the headline ``torch_federated_s /
gfedntm_tpu_s`` at 95% (target >= 4.0), the reference's shipped-stack
floor, and the cold start: the warm fit's seconds added to the port's
time, and a fresh process (the kernel library already built in ``build/``)
timing corpus generation and a one-epoch fit.

Run: python -m gfedntm_tpu_torch.experiments_scripts.time_to_quality
[out_json] [--device cpu|cuda]; writes
``results_torch/time_to_quality/metrics.json`` by default. ``TTQ_EPOCHS``
(or ``run(epochs=)``) cuts the depth for smoke runs; ``TTQ_SKIP_COLDPROC``
(or ``run(coldproc=False)``) skips the fresh process.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from gfedntm_tpu_torch.device import device_parser, resolve_device
from gfedntm_tpu_torch.experiments_scripts import (
    K1_K3,
    REPO_ROOT,
    RESULTS,
    card,
    headline_speedup,
    ladder,
    shipped_floor_s,
    synchronize,
    tss_of,
)
from gfedntm_tpu_torch.experiments_scripts.torch_baseline import Batches, _LocalTorchAVITM
from gfedntm_tpu_torch.ops.fused_decoder import launch_counts, launches_since

N_NODES, VOCAB, K, DOCS_PER_NODE = 5, 5000, 50, 2000
ETA, ALPHA, FROZEN = 0.01, 0.1, 5
EPOCHS = 100
SEED = 0
BATCH, HIDDEN, LR, BETA1 = 64, (100, 100), 2e-3, 0.99
#: The two local-steps arms: exchange periods in epochs.
LOCAL_ARMS = (("E_1epoch", 1), ("E_5epoch", 5))
#: The artifact's default path.
OUT = RESULTS / "time_to_quality" / "metrics.json"


def make_corpus(vocab=VOCAB, k=K, docs_per_node=DOCS_PER_NODE, n_nodes=N_NODES,
                frozen=FROZEN, seed=SEED):
    from gfedntm_tpu_torch.data.synthetic import generate_synthetic_corpus

    return generate_synthetic_corpus(
        vocab_size=vocab, n_topics=k, beta=ETA, alpha=ALPHA, n_docs=docs_per_node,
        nwords=(150, 250), n_nodes=n_nodes, frozen_topics=frozen, seed=seed,
        materialize_docs=False,
    )


def _snapshot(beta: torch.Tensor, snaps: list, t_start: float) -> None:
    """Append (seconds since ``t_start``, beta on the host): the time taken
    after the copy, which waits for the device."""
    host = beta.detach().cpu().numpy().copy()
    snaps.append((time.perf_counter() - t_start, host))


def _curve(snaps: list, topic_vectors, id2token) -> list:
    return [{"wall_s": round(ts, 2), "tss": round(tss_of(beta, topic_vectors, id2token), 4)}
            for ts, beta in snaps]


def _warm_step(model: _LocalTorchAVITM, x: torch.Tensor) -> None:
    """One untimed step on a copy of ``model`` (the CUDA context, cuBLAS
    handles and the allocator are paid there)."""
    copy.deepcopy(model).step(x)
    synchronize(x.device)


def torch_centralized_arm(X: np.ndarray, k: int, epochs: int, seed: int, dev) -> dict:
    """The union BoW trained by one plain-PyTorch model; beta after every
    epoch."""
    model = _LocalTorchAVITM(X.shape[1], k, hidden_sizes=HIDDEN, lr=LR, beta1=BETA1,
                             device=dev, seed=seed)
    loader = Batches(torch.as_tensor(X, device=dev), BATCH, model.generator)
    _warm_step(model, loader.X[:BATCH])
    before = launch_counts(K1_K3)
    snaps: list = []
    t_start = time.perf_counter()
    for _ in range(epochs):
        model._train_epoch(loader)
        _snapshot(model.beta, snaps, t_start)
    steps = epochs * -(-X.shape[0] // BATCH)
    return {"snaps": snaps, "wall_s": snaps[-1][0], "steps": steps,
            "launches": launches_since(before)}


def torch_federated_arm(bows: list, k: int, epochs: int, seed: int, dev) -> dict:
    """The reference's per-minibatch FedAvg in plain PyTorch: each global
    step one minibatch step per client, then the mean of every floating
    state-dict entry written back into every client; client 0's beta after
    every epoch."""
    # Each client its own initial weights and draws (the JAX script builds
    # them one after another from the global generator); the first exchange
    # makes them equal. Even seeds initialise, odd ones draw.
    models = [_LocalTorchAVITM(bows[0].shape[1], k, hidden_sizes=HIDDEN, lr=LR,
                               beta1=BETA1, device=dev, seed=2 * (seed + 1 + c))
              for c in range(len(bows))]
    loaders = [Batches(torch.as_tensor(b, device=dev), BATCH, m.generator)
               for b, m in zip(bows, models)]
    _warm_step(models[0], loaders[0].X[:BATCH])
    iters = [iter(loader) for loader in loaders]
    steps_per_epoch = -(-bows[0].shape[0] // BATCH)
    total = epochs * steps_per_epoch
    before = launch_counts(K1_K3)
    snaps: list = []
    t_start = time.perf_counter()
    for m in models:
        m.model.train()
    for step in range(total):
        for c, m in enumerate(models):
            try:
                x = next(iters[c])
            except StopIteration:
                iters[c] = iter(loaders[c])
                x = next(iters[c])
            m.step(x)
        sds = [m.model.state_dict() for m in models]
        avg = {
            key: (torch.stack([sd[key].float() for sd in sds]).mean(0)
                  if torch.is_floating_point(sds[0][key]) else sds[0][key])
            for key in sds[0]
        }
        for m in models:
            m.model.load_state_dict(avg)
        if (step + 1) % steps_per_epoch == 0:
            _snapshot(models[0].beta, snaps, t_start)
    return {"snaps": snaps, "wall_s": snaps[-1][0], "steps": total,
            "launches": launches_since(before)}


def port_arm(datasets: list, k: int, epochs: int, seed: int, dev, local_steps: int = 1,
             init_state: dict | None = None) -> dict:
    """The port's ``FederatedTrainer`` (``local_steps`` E), client 0's beta
    after every epoch's segment, after an untimed warm fit of one epoch.
    ``init_state`` (a state dict) replaces the template's initial weights."""
    from gfedntm_tpu_torch.federated.trainer import FederatedTrainer
    from gfedntm_tpu_torch.models.avitm import AVITM

    template = AVITM(input_size=datasets[0].X.shape[1], n_components=k, hidden_sizes=HIDDEN,
                     batch_size=BATCH, num_epochs=1, lr=LR, momentum=BETA1, seed=seed,
                     device=dev)
    if init_state is not None:
        template.model.load_state_dict(init_state)
    trainer = FederatedTrainer(template, n_clients=len(datasets), local_steps=local_steps,
                               device=dev)
    steps_per_epoch = max(1, -(-max(len(d) for d in datasets) // BATCH))

    # Warm fit (one epoch): stages the corpus and pays the first launches.
    before = launch_counts(K1_K3)
    synchronize(dev)
    t0 = time.perf_counter()
    warm = trainer.fit(datasets)
    synchronize(dev)
    warm_s = time.perf_counter() - t0
    warm_launches = launches_since(before)

    template.num_epochs = epochs
    snaps: list = []
    before = launch_counts(K1_K3)
    synchronize(dev)
    t_start = time.perf_counter()
    result = trainer.fit(
        datasets, checkpoint_every=steps_per_epoch,
        segment_callback=lambda step, params, stats: _snapshot(params[0]["beta"], snaps,
                                                               t_start))
    return {"snaps": snaps, "wall_s": snaps[-1][0], "steps": int(result.losses.shape[0]),
            "client_steps": int(result.losses.size), "launches": launches_since(before),
            "warm_s": warm_s, "warm_launches": warm_launches,
            "warm_client_steps": int(warm.losses.size), "local_steps": local_steps,
            "losses": result.losses}


def measure_cold_process(device, vocab=VOCAB, k=K, docs_per_node=DOCS_PER_NODE,
                         n_nodes=N_NODES, frozen=FROZEN, seed=SEED) -> dict:
    """A cold process's corpus generation and (stage + first launches + one
    epoch's fit) at this regime: called in a fresh process
    (``--coldproc-measure``), where the kernel library is already built."""
    from gfedntm_tpu_torch.data.datasets import BowDataset
    from gfedntm_tpu_torch.federated.trainer import FederatedTrainer
    from gfedntm_tpu_torch.models.avitm import AVITM
    from gfedntm_tpu_torch.ops import _build

    dev = resolve_device(device)
    prebuilt = _build.LIBRARY.exists()
    t0 = time.perf_counter()
    corpus = make_corpus(vocab, k, docs_per_node, n_nodes, frozen, seed)
    gen_s = time.perf_counter() - t0
    i2t = {i: f"wd{i}" for i in range(vocab)}
    datasets = [BowDataset(X=n.bow, idx2token=i2t) for n in corpus.nodes]
    template = AVITM(input_size=vocab, n_components=k, hidden_sizes=HIDDEN, batch_size=BATCH,
                     num_epochs=1, lr=LR, momentum=BETA1, seed=seed, device=dev)
    trainer = FederatedTrainer(template, n_clients=n_nodes, device=dev)
    t0 = time.perf_counter()
    trainer.fit(datasets)
    synchronize(dev)
    fit_s = time.perf_counter() - t0
    return {
        "backend": dev.type,
        "corpus_gen_s": round(gen_s, 1),
        "stage_compile_and_one_epoch_fit_s": round(fit_s, 1),
        "compile_cache_dir": str(_build.BUILD_DIR) if prebuilt else None,
    }


def _cold_process(dev, regime: dict) -> dict:
    """:func:`measure_cold_process` in a fresh interpreter."""
    args = [sys.executable, "-m", "gfedntm_tpu_torch.experiments_scripts.time_to_quality",
            "--coldproc-measure", "--device", dev.type,
            "--regime", json.dumps(regime)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    try:
        proc = subprocess.run(args, capture_output=True, text=True, timeout=1200, env=env,
                              cwd=str(REPO_ROOT))
        line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("COLDPROC "))
        return json.loads(line[len("COLDPROC "):])
    except (StopIteration, OSError, ValueError, subprocess.TimeoutExpired) as err:
        return {"error": repr(err)[:300]}


def run(out_path: str | None = None, epochs: int | None = None, vocab: int = VOCAB,
        k: int = K, docs_per_node: int = DOCS_PER_NODE, n_nodes: int = N_NODES,
        frozen: int = FROZEN, seed: int = SEED, coldproc: bool | None = None,
        device=None) -> dict:
    """Every arm on one corpus, the ladder and the artifact (the JAX
    ``main``); returns the artifact, written to ``out_path`` (default
    :data:`OUT`)."""
    from gfedntm_tpu_torch.data.datasets import BowDataset
    from gfedntm_tpu_torch.eval.metrics import (
        npmi_coherence,
        topic_diversity,
        topic_similarity_score,
    )
    from gfedntm_tpu_torch.ops import _build

    dev = resolve_device(device)
    if epochs is None:
        epochs = int(os.environ.get("TTQ_EPOCHS", str(EPOCHS)))
    if coldproc is None:
        coldproc = not os.environ.get("TTQ_SKIP_COLDPROC")
    build_s = None
    if dev.type == "cuda":
        # Built before any timing, so the warm fit pays no nvcc.
        t0 = time.perf_counter()
        _build.load()
        build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    corpus = make_corpus(vocab, k, docs_per_node, n_nodes, frozen, seed)
    topic_vectors = corpus.topic_vectors
    gen_s = time.perf_counter() - t0
    idx2token = {i: f"wd{i}" for i in range(vocab)}
    bows = [node.bow for node in corpus.nodes]
    # Token sets of the union's documents, for NPMI (document-level
    # co-occurrence: a document's distinct words).
    union_docs = [[f"wd{i}" for i in np.flatnonzero(row)] for b in bows for row in b]

    arms = {}
    arms["torch_centralized"] = torch_centralized_arm(np.concatenate(bows), k, epochs, seed,
                                                      dev)
    print(f"torch arm: {epochs} epochs in {arms['torch_centralized']['wall_s']:.2f} s",
          flush=True)
    arms["torch_federated"] = torch_federated_arm(bows, k, epochs, seed, dev)
    print(f"torch federated arm: {epochs} epochs in {arms['torch_federated']['wall_s']:.2f} s",
          flush=True)
    datasets = [BowDataset(X=b, idx2token=idx2token) for b in bows]
    steps_per_epoch = max(1, -(-docs_per_node // BATCH))
    arms["gfedntm_tpu_federated"] = port_arm(datasets, k, epochs, seed, dev)
    print(f"port arm ({dev}): {epochs} epochs in "
          f"{arms['gfedntm_tpu_federated']['wall_s']:.2f} s", flush=True)
    for name, period in LOCAL_ARMS:
        arms[f"gfedntm_tpu_local_steps_{name}"] = port_arm(
            datasets, k, epochs, seed, dev, local_steps=period * steps_per_epoch)
        print(f"local-steps arm {name}: {epochs} epochs in "
              f"{arms[f'gfedntm_tpu_local_steps_{name}']['wall_s']:.2f} s", flush=True)

    curves = {name: _curve(arm["snaps"], topic_vectors, idx2token) for name, arm in arms.items()}
    final_topic_quality = {}
    for name, arm in arms.items():
        top = np.argsort(-arm["snaps"][-1][1], axis=1)[:, :10]
        tops = [[idx2token[int(i)] for i in row] for row in top]
        final_topic_quality[name] = {
            "topic_diversity_top10": round(topic_diversity(tops, 10), 4),
            "npmi": round(npmi_coherence(tops, union_docs), 4),
        }
    print("final topic quality:", json.dumps(final_topic_quality), flush=True)

    local_keys = [f"gfedntm_tpu_local_steps_{name}" for name, _ in LOCAL_ARMS]
    plateau = min(curves["torch_federated"][-1]["tss"],
                  curves["gfedntm_tpu_federated"][-1]["tss"])
    baseline_tss = float(topic_similarity_score(
        np.random.default_rng(seed + 9).dirichlet(np.full(vocab, ETA), k), topic_vectors))
    targets = ladder(baseline_tss, plateau, {
        "torch_federated_s": curves["torch_federated"],
        "torch_centralized_s": curves["torch_centralized"],
        "gfedntm_tpu_s": curves["gfedntm_tpu_federated"],
        **{f"{key}_s": curves[key] for key in local_keys},
    })
    head = targets["95pct"]
    compile_s = arms["gfedntm_tpu_federated"]["warm_s"]
    cold_95 = (None if head["gfedntm_tpu_s"] is None
               else round(compile_s + head["gfedntm_tpu_s"], 2))
    regime = {"vocab": vocab, "k": k, "docs_per_node": docs_per_node, "n_nodes": n_nodes,
              "frozen": frozen, "seed": seed}
    cold_process = (_cold_process(dev, regime) if coldproc
                    else {"skipped": "run(coldproc=False) or TTQ_SKIP_COLDPROC"})

    out = {
        "metric": "wall_clock_to_tss_target",
        "headline_speedup_at_95pct": headline_speedup(targets),
        "headline_definition": (
            "torch_federated_s / gfedntm_tpu_s at the 95%-of-joint-federated-plateau TSS "
            "target (both arms run the reference's FedAvg algorithm on the same corpus, on "
            "the same device)"
        ),
        "north_star_target": ">= 4.0 (BASELINE.json: quality in <= 1/4 the wall-clock)",
        "reference_shipped_stack_floor_s_at_95pct": shipped_floor_s(
            head["torch_federated_s"], curves["torch_federated"],
            arms["torch_federated"]["steps"], n_nodes),
        "backend": dev.type,
        "device": card(dev),
        "torch_impl": {
            "torch_version": torch.__version__, "cuda": torch.version.cuda,
            "torch_arms": ("local torch AVITM (reference-equivalent architecture, plain "
                           "PyTorch and cuBLAS, no kernel of the port)"),
            "port_arms": ("gfedntm_tpu_torch FederatedTrainer; on the GPU the fused "
                          "decoder's CUDA kernels K1-K3"),
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "warm_up": ("every arm takes one untimed warm step (torch arms, on a copy) or a "
                        "one-epoch warm fit (port arms) before its timed run; each "
                        "snapshot is timed after its copy to the host"),
            "kernel_build_s": None if build_s is None else round(build_s, 2),
        },
        "regime": {
            "n_nodes": n_nodes, "vocab": vocab, "k": k, "docs_per_node": docs_per_node,
            "eta": ETA, "alpha": ALPHA, "frozen_topics": frozen, "epochs": epochs,
            "seed": seed,
            "substitute_for": "20Newsgroups (no offline snapshot; no egress) - reference "
                              "eval regime instead",
            "corpus_gen_s": round(gen_s, 1),
        },
        "quality_metric": (
            "TSS vs ground-truth topic_vectors, single softmax, correct word mapping "
            f"(max={k})"
        ),
        "baseline_tss_random": round(baseline_tss, 4),
        "joint_plateau_tss": round(plateau, 4),
        "final_topic_quality": final_topic_quality,
        "targets": targets,
        "torch_note": (
            "centralized fit = the reference's compute-only best case; its shipped federated "
            "path adds >=3 s sleep x N clients per global step on top (server.py:417-420,472)"
        ),
        "gfedntm_compile_and_stage_s": round(compile_s, 1),
        "compilation_cache_dir": str(_build.BUILD_DIR) if dev.type == "cuda" else None,
        "cold_start": {
            "gfedntm_cold_s_at_95pct": cold_95,
            "headline_speedup_at_95pct_cold": headline_speedup(targets, port_s=cold_95),
            "note": (
                "cold = the warm fit (staging, first launches, one epoch) paid up front; the "
                "headline above amortizes it"
            ),
            "cold_process_warm_cache": cold_process,
        },
        "local_steps_fix": {
            "definition": (
                "opt-in FederatedTrainer(local_steps=E): clients run E local minibatches "
                "between FedAvg exchanges; parity default E=1 unchanged"
            ),
            "arms": {
                key.rsplit("local_steps_", 1)[1]: {
                    "E": arms[key]["local_steps"], "final_tss": curves[key][-1]["tss"]}
                for key in local_keys
            },
        },
        "ms_per_global_step": {name: round(arm["wall_s"] / arm["steps"] * 1e3, 4)
                               for name, arm in arms.items()},
        "global_steps": {name: arm["steps"] for name, arm in arms.items()},
        "client_steps": {name: arm.get("client_steps", 0) for name, arm in arms.items()},
        "k1_k3_launches": {name: arm["launches"] for name, arm in arms.items()},
        "warm_fit": {name: {"seconds": round(arm["warm_s"], 3),
                            "launches": arm["warm_launches"],
                            "client_steps": arm["warm_client_steps"]}
                     for name, arm in arms.items() if "warm_s" in arm},
        "torch_federated_curve": curves["torch_federated"],
        "torch_curve": curves["torch_centralized"],
        "gfedntm_curve": curves["gfedntm_tpu_federated"],
        "gfedntm_local_steps_curves": {key.rsplit("local_steps_", 1)[1]: curves[key]
                                       for key in local_keys},
    }
    out_path = out_path or str(OUT)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w", encoding="utf8") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({key: v for key, v in out.items() if not key.endswith("_curve")
                      and not key.endswith("_curves")}, indent=2))
    return out


def main(argv: list[str] | None = None) -> int:
    p = device_parser(__doc__)
    p.add_argument("out_json", nargs="?", default=None)
    p.add_argument("--coldproc-measure", action="store_true",
                   help="time a cold process's corpus and one-epoch fit (internal)")
    p.add_argument("--regime", default="{}", help="the regime of --coldproc-measure, JSON")
    args = p.parse_args(argv)
    if args.coldproc_measure:
        print("COLDPROC " + json.dumps(measure_cold_process(args.device,
                                                            **json.loads(args.regime))),
              flush=True)
        return 0
    run(out_path=args.out_json, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
