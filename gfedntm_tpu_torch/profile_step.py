#!/usr/bin/env python3
"""Where a steady federated ProdLDA step of the PyTorch port spends its time
on the GPU.

    python3 -m gfedntm_tpu_torch.profile_step [--out build/port_profile.json]
    python3 -m gfedntm_tpu_torch.profile_step --sharded-mp 2
    python3 -m gfedntm_tpu_torch.profile_step --compute-dtype bfloat16 [--sharded-mp 2]

Runs the configuration of ``chip_smoke.py``'s main path (V=100,000, K=50,
H=(100, 100), B=256, 2 clients): a warm fit; the steady wall time per
global step without the profiler (a 24-step fit minus an 8-step fit, as
``chip_smoke.py`` measures it); then a 24-step fit under ``torch.profiler``.
Prints the device time per step by group — the fused decoder's kernels,
GEMMs, optimizer, gather, other — with the fit's host-to-device corpus upload
apart as set-up, the device busy share (device time per step over the
steady wall time per step) and the top device events. Needs a CUDA device; exits 2 without one. Run it from the repository root.

``--sharded-mp N`` profiles the V-sharded path instead: one model (V=100,000,
K=50, H=(100, 100), B=256, 2,048 synthetic documents) split over N spawned
ranks (``gfedntm_tpu_torch.parallel.programs.profile_steps``), NCCL with one
GPU per rank when there are N GPUs, else gloo with every rank on ``cuda:0``;
each rank reports its own steady wall ms per step and device ms by group.

``--compute-dtype bfloat16`` profiles either path with a bf16-compute model;
the cast and pad of beta and x into bf16 storage (the kernels' launches
inside ``fused_decoder.store``'s profiler range) is reported as a group of
its own.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("fused_decoder", ("stats_kernel", "loss_kernel", "grads_kernel",
                       "merge_softmax_kernel", "fold_rows_kernel", "sum_partials_kernel")),
    ("gemm", ("gemm", "gemv", "cutlass", "sm90_xmma", "ampere_", "splitk", "dot_kernel")),
    ("optimizer", ("multi_tensor", "foreach", "adam")),
    ("gather", ("index", "gather")),
    ("upload (set-up)", ("memcpy htod",)),
)


def group_of(name: str, groups=GROUPS) -> str:
    low = name.lower()
    for group, keys in groups:
        if any(k in low for k in keys):
            return group
    return "other"


CAST_GROUP = "bf16 cast and pad"


def _device_ms(evt, total: bool) -> float:
    """An averaged event's device time in us: its own kernels', or with its
    children's (``total``)."""
    if total:
        return float(getattr(evt, "device_time_total", 0.0)
                     or getattr(evt, "cuda_time_total", 0.0))
    return float(getattr(evt, "self_device_time_total", 0.0)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def device_times(prof, steps: int, groups=GROUPS):
    """A ``torch.profiler`` run's device ms per step by group (``groups``,
    as :data:`GROUPS`; the bf16 cast and pad, whose copy kernels are
    elementwise, taken out of "other" into :data:`CAST_GROUP`) and its 15
    longest device events."""
    from torch.autograd import DeviceType

    from gfedntm_tpu_torch.ops.fused_decoder import STORE_RANGE

    by_group: dict[str, float] = {}
    events = []
    averages = prof.key_averages()
    cast = sum(_device_ms(e, True) for e in averages if e.key == STORE_RANGE) / steps / 1e3
    if cast:
        by_group[CAST_GROUP] = cast
        by_group["other"] = -cast
    for evt in averages:
        # Host ops and annotated ranges (e.g. "Optimizer.step#Adam.step")
        # repeat the time of the kernels they contain.
        if (evt.device_type != DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False) or "#" in evt.key):
            continue
        ms = _device_ms(evt, False) / steps / 1e3
        group = group_of(evt.key, groups)
        by_group[group] = by_group.get(group, 0.0) + ms
        events.append((ms, evt.count, evt.key))
    events.sort(reverse=True)
    return dict(sorted(by_group.items())), [
        {"name": name[:120], "ms_per_step": ms, "calls": count}
        for ms, count, name in events[:15]
    ]


def sharded(mp: int, out: Path, compute_dtype: str) -> int:
    """The V-sharded step over ``mp`` ranks; see the module docstring."""
    import torch

    from gfedntm_tpu_torch import generate_synthetic_corpus
    from gfedntm_tpu_torch.parallel import programs
    from gfedntm_tpu_torch.parallel.launch import gpu_layout, run_ranks

    V, K, B = 100_000, 50, 256
    X = generate_synthetic_corpus(vocab_size=V, n_topics=K, n_docs=2048, n_nodes=1,
                                  materialize_docs=False, seed=0).nodes[0].bow
    kw = dict(input_size=V, n_components=K, hidden_sizes=(100, 100), batch_size=B,
              dropout=0.0, seed=0, compute_dtype=compute_dtype)
    backend, devices = gpu_layout(mp)
    reports = run_ranks(programs.profile_steps, mp, backend, devices, 900,
                        args=(mp, kw, X, 24))
    print(f"profile: {torch.cuda.get_device_name(0)}; V-sharded step, mp={mp}, {backend} "
          f"on {devices}, B={B}, compute {compute_dtype}")
    for rep in reports:
        print(f"profile: rank {rep['rank']}: steady wall {rep['wall_ms_per_step']:.3f} "
              f"ms/step (unprofiled), device {rep['device_ms_per_step']:.3f} ms/step, "
              f"busy share {rep['device_busy_share']:.3f}")
        for g, ms in rep["ms_per_step_by_group"].items():
            print(f"profile: rank {rep['rank']}: group {g}: {ms:.4f} ms/step")
    for row in reports[0]["top_device_events"]:
        print(f"profile: rank 0: {row['ms_per_step']:.4f} ms/step x{row['calls']} {row['name']}")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": torch.cuda.get_device_name(0), "backend": backend,
                               "devices": devices, "compute_dtype": compute_dtype,
                               "ranks": reports}, indent=2))
    if min(rep["device_ms_per_step"] for rep in reports) <= 0:
        print("profile_step: the profiler recorded no device time", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="build/port_profile.json")
    parser.add_argument("--sharded-mp", type=int, default=0,
                        help="profile the V-sharded path over this many ranks")
    parser.add_argument("--compute-dtype", default="float32", choices=("float32", "bfloat16"),
                        help="the model's compute dtype (AVITM compute_dtype)")
    args = parser.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_step: CUDA is not available", file=sys.stderr)
        return 2
    from gfedntm_tpu_torch import AVITM, BowDataset, FederatedTrainer, generate_synthetic_corpus

    if args.sharded_mp:
        return sharded(args.sharded_mp, Path(args.out), args.compute_dtype)
    V, K, B, C = 100_000, 50, 256, 2
    corpus = generate_synthetic_corpus(vocab_size=V, n_topics=K, n_docs=1024, n_nodes=C,
                                       materialize_docs=False, seed=0)
    datasets = [BowDataset(X=n.bow) for n in corpus.nodes]

    def fit(num_epochs):
        template = AVITM(input_size=V, n_components=K, hidden_sizes=(100, 100),
                         batch_size=B, num_epochs=num_epochs, compute_dtype=args.compute_dtype)
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = FederatedTrainer(template, n_clients=C).fit(datasets)
        torch.cuda.synchronize()
        return result, time.perf_counter() - start

    fit(2)
    secs8 = min(fit(2)[1], fit(2)[1])
    secs24 = min(fit(6)[1], fit(6)[1])
    steady_ms = (secs24 - secs8) / 16 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result, _ = fit(6)
    steps = result.losses.shape[0]

    by_group, top = device_times(prof, steps)
    step_ms = sum(ms for g, ms in by_group.items() if g != "upload (set-up)")
    report = {
        "device": torch.cuda.get_device_name(0),
        "compute_dtype": args.compute_dtype,
        "steps": steps,
        "steady_wall_ms_per_step": steady_ms,
        "device_ms_per_step": step_ms,
        "device_busy_share": step_ms / steady_ms,
        "ms_per_step_by_group": by_group,
        "top_device_events": top,
    }
    print(f"profile: {torch.cuda.get_device_name(0)}; compute {args.compute_dtype}; {steps} "
          f"global steps of {C} clients: steady wall {steady_ms:.3f} ms/step (unprofiled), device "
          f"{report['device_ms_per_step']:.3f} ms/step without set-up, busy share "
          f"{report['device_busy_share']:.3f}")
    for g, ms in report["ms_per_step_by_group"].items():
        print(f"profile: group {g}: {ms:.4f} ms/step")
    for row in report["top_device_events"]:
        print(f"profile: {row['ms_per_step']:.4f} ms/step x{row['calls']} {row['name']}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    if step_ms <= 0:
        print("profile_step: the profiler recorded no device time", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
