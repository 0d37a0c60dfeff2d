#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``gfedntm_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Three phases, each fatal on failure (exit code 1; 2 when there is no CUDA
device or no port next to this script):

1. build — compile the fused decoder's CUDA kernels from
   ``gfedntm_tpu_torch/ops/csrc/`` with nvcc for sm_90a;
2. kernels — run K1 (stats), K2 (loss) and K3 (grads) at the slice's shapes
   (B=256, K=50, V=100,000) and at B=64 / B=200 with V=3001, in training and
   eval, with masked rows, an all-zero document row and an all-masked batch,
   and hold each against its plain PyTorch version on the card; time both;
   check the autograd function against the unfused oracle on a small input;
3. main path — federated ProdLDA through the user entry points
   (``AVITM`` -> ``FederatedTrainer.fit`` -> ``make_global_model`` ->
   ``get_topics``) at V=100,000, K=50, H=(100, 100), B=256, 2 clients,
   2 epochs (8 global steps), with the launch counters reset just before
   ``fit`` and read just after.

Output: the card's name and power limit first; one line per kernel (launch
count, max error and its tolerance, kernel, plain and bound ms); a
``{"kernels": [...]}`` JSON line before the last; and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# Published peaks by card (NVIDIA data sheets; dense, no sparsity): memory
# bytes/s and FP32 FLOP/s on the CUDA cores. Keys are matched against the
# nvidia-smi name; the SXM part is the default.
_PEAKS = (
    ("H100 NVL", 3.9e12, 60e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H200", 4.8e12, 67e12),
    ("H100", 3.35e12, 67e12),
)
RTOL, ATOL = 1e-4, 1e-5  # kernel vs plain: |err| <= ATOL + RTOL * max|plain|


class SmokeFailure(Exception):
    pass


def check(ok: bool, message: str) -> None:
    if not ok:
        raise SmokeFailure(message)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=False,
    )
    return (out.stdout.strip().splitlines() or [f"nvidia-smi failed: {out.stderr.strip()}"])[0]


def peaks(name: str) -> tuple[float, float, str]:
    for key, bw, flops in _PEAKS:
        if key in name:
            return bw, flops, key
    return _PEAKS[-1][1], _PEAKS[-1][2], "H100 (assumed)"


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def make_inputs(b, k, v, seed, mask_kind):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    theta = torch.softmax(torch.randn(b, k, generator=gen, device=dev), dim=1)
    beta = torch.randn(k, v, generator=gen, device=dev)
    x = torch.randint(0, 4, (b, v), generator=gen, device=dev).float()
    run_mean = 0.1 * torch.randn(v, generator=gen, device=dev)
    run_var = 0.5 + 1.5 * torch.rand(v, generator=gen, device=dev)
    mask = torch.ones(b, device=dev)
    if mask_kind == "partial":
        mask[::7] = 0.0  # some masked rows
        x[1].zero_()  # an all-zero document
    elif mask_kind == "all":
        mask.zero_()
    g_rl = torch.linspace(0.1, 2.0, b, device=dev)
    return dict(theta=theta, beta=beta, x=x, run_mean=run_mean, run_var=run_var,
                mask=mask, g=(g_rl * mask).contiguous())


def compare(name, got, want, case):
    """Max |kernel - plain| over the outputs named in ``name``; fails above
    ATOL + RTOL * max|plain|. Softmax-max sentinels (-1e30, fully-masked
    rows) must match exactly and are left out of the scale."""
    import torch

    torch.cuda.synchronize()
    worst = 0.0
    for label, a, b in zip(name.split(","), got, want):
        check(bool(torch.isfinite(a).all()), f"{case}: {label} not finite")
        sentinel = b.abs() >= 1e29
        check(torch.equal(a[sentinel], b[sentinel]), f"{case}: {label} sentinel rows differ")
        a, b = a[~sentinel], b[~sentinel]
        if b.numel() == 0:
            continue
        err = float((a - b).detach().abs().max())
        tol = ATOL + RTOL * float(b.detach().abs().max())
        check(err <= tol, f"{case}: {label} max |err| {err:.3e} > tol {tol:.3e}")
        worst = max(worst, err)
    return worst


def kernel_phase(card: str) -> dict:
    import torch

    from gfedntm_tpu_torch.ops import fused_decoder as fd

    bw, flops_peak, peak_key = peaks(card)
    cases = [
        (256, 50, 100_000, "partial", True), (256, 50, 100_000, "partial", False),
        (64, 50, 3001, "partial", True), (64, 50, 3001, "partial", False),
        (64, 50, 3001, "all", True), (64, 50, 3001, "all", False),
        (200, 50, 3001, "partial", True), (200, 50, 3001, "none", False),
    ]
    worst = {"stats": 0.0, "loss": 0.0, "grads": 0.0}
    for i, (b, k, v, mask_kind, training) in enumerate(cases):
        t = make_inputs(b, k, v, seed=i, mask_kind=mask_kind)
        case = f"B={b} K={k} V={v} mask={mask_kind} {'train' if training else 'eval'}"
        st_args = (t["theta"], t["beta"], t["mask"], t["run_mean"], t["run_var"], training)
        ref_stats = fd.stats_reference(*st_args)
        worst["stats"] = max(worst["stats"], compare(
            "mean,var,m,s", fd.stats(*st_args), ref_stats, case))
        mean, var, m, s = ref_stats
        lo_args = (t["theta"], t["beta"], t["x"], mean, var, m, s)
        ref_loss = fd.loss_reference(*lo_args)
        worst["loss"] = max(worst["loss"], compare(
            "loss,rd", fd.loss(*lo_args), ref_loss, case))
        gr_args = lo_args + (ref_loss[1], t["g"], t["mask"], training)
        worst["grads"] = max(worst["grads"], compare(
            "g_theta,g_beta", fd.grads(*gr_args), fd.grads_reference(*gr_args), case))
        print(f"kernels ok: {case}", flush=True)

    # The autograd function against the unfused oracle (gradients by
    # autograd through plain ops), on a small input.
    t = make_inputs(64, 50, 3001, seed=99, mask_kind="partial")
    w = torch.linspace(0.1, 2.0, 64, device="cuda")
    outs = []
    for fn in (fd.prodlda_recon_loss, fd.prodlda_recon_loss_reference):
        th = t["theta"].clone().requires_grad_(True)
        be = t["beta"].clone().requires_grad_(True)
        rl, mean, var = fn(th, be, t["x"], t["run_mean"], t["run_var"], t["mask"], True)
        (rl * t["mask"] * w).sum().backward()
        outs.append((rl * t["mask"], mean, var, th.grad, be.grad))
    compare("rl,mean,var,g_theta,g_beta", outs[0], outs[1], "autograd vs oracle")
    print("kernels ok: autograd function vs unfused oracle", flush=True)

    # Timing at the slice's shapes (training, as the main path runs them).
    b, k, v = 256, 50, 100_000
    t = make_inputs(b, k, v, seed=0, mask_kind="partial")
    st_args = (t["theta"], t["beta"], t["mask"], t["run_mean"], t["run_var"], True)
    mean, var, m, s = fd.stats_reference(*st_args)
    lo_args = (t["theta"], t["beta"], t["x"], mean, var, m, s)
    rd = fd.loss_reference(*lo_args)[1]
    gr_args = lo_args + (rd, t["g"], t["mask"], True)
    f4 = 4.0
    bk, kv, bv = b * k, k * v, b * v
    work = {  # (bytes: each input read once, each output written once; FLOPs)
        "stats": (f4 * (bk + kv + b + 2 * v + 2 * b), 2.0 * b * k * v),
        "loss": (f4 * (bk + kv + bv + 2 * v + 2 * b + 2 * b), 2.0 * b * k * v),
        "grads": (f4 * (bk + kv + bv + 2 * v + 5 * b + bk + kv), 6.0 * b * k * v),
    }
    fns = {
        "stats": (lambda: fd.stats(*st_args), lambda: fd.stats_reference(*st_args)),
        "loss": (lambda: fd.loss(*lo_args), lambda: fd.loss_reference(*lo_args)),
        "grads": (lambda: fd.grads(*gr_args), lambda: fd.grads_reference(*gr_args)),
    }
    replaces = {
        "stats": "gfedntm_tpu/ops/fused_decoder.py:189",
        "loss": "gfedntm_tpu/ops/fused_decoder.py:266",
        "grads": "gfedntm_tpu/ops/fused_decoder.py:612",
    }
    rows, notes = {}, {}
    for name, (kernel_fn, plain_fn) in fns.items():
        # plain, kernel, kernel, plain: compare within one call, in turns.
        p1 = time_ms(plain_fn)
        k1 = time_ms(kernel_fn)
        k2 = time_ms(kernel_fn)
        p2 = time_ms(plain_fn)
        nbytes, nflops = work[name]
        t_bytes, t_flops = nbytes / bw * 1e3, nflops / flops_peak * 1e3
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "gfedntm_tpu_torch/ops/csrc/fused_decoder.cu",
            "replaces": replaces[name], "launches": 0,
            "max_abs_err": worst[name],
            "ms": min(k1, k2), "plain_ms": min(p1, p2),
            "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "library_ms": None,
        }
        notes[name] = (
            f"tol {ATOL:g} + {RTOL:g}*max|plain| per output; ms {k1:.4f}/{k2:.4f} "
            f"plain_ms {p1:.4f}/{p2:.4f}; bound {rows[name]['bound_by']} ({peak_key} "
            f"peaks: {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, {nflops / 1e9:.2f} GFLOP "
            f"-> {t_flops:.4f} ms)"
        )
    return rows, notes


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------
def main_path_phase(rows: dict) -> None:
    import numpy as np
    import torch

    from gfedntm_tpu_torch import AVITM, BowDataset, FederatedTrainer, generate_synthetic_corpus
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    V, K, B, C = 100_000, 50, 256, 2
    t0 = time.perf_counter()
    corpus = generate_synthetic_corpus(
        vocab_size=V, n_topics=K, n_docs=1024, n_nodes=C, materialize_docs=False, seed=0,
    )
    idx2token = {i: f"wd{i}" for i in range(V)}
    datasets = [BowDataset(X=node.bow, idx2token=idx2token) for node in corpus.nodes]
    print(f"main path: synthetic corpus {C} x {datasets[0].X.shape} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def run(num_epochs):
        template = AVITM(input_size=V, n_components=K, hidden_sizes=(100, 100),
                         batch_size=B, num_epochs=num_epochs)
        trainer = FederatedTrainer(template, n_clients=C)
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = trainer.fit(datasets)
        torch.cuda.synchronize()
        return trainer, result, time.perf_counter() - start

    for key in fd.LAUNCHES:
        fd.LAUNCHES[key] = 0
    trainer, result, secs = run(num_epochs=2)
    launches = dict(fd.LAUNCHES)
    steps = result.losses.shape[0]
    print(f"main path: fit {steps} global steps x {C} clients in {secs:.3f} s; "
          f"launches {launches}; epoch losses {result.epoch_losses}", flush=True)

    check(result.losses.shape == (8, C), f"losses shape {result.losses.shape} != (8, {C})")
    check(bool(np.isfinite(result.losses).all()), "non-finite federated losses")
    for name, want in (("stats", 16), ("loss", 16), ("grads", 16)):
        check(launches[name] == want, f"{name} launched {launches[name]} times, want {want}")
    for tree in (result.client_params, result.client_batch_stats):
        for key, val in tree[0].items():
            for other in tree[1:]:
                check(torch.equal(val, other[key]), f"{key} differs across clients")
    model = trainer.make_global_model(result, datasets[0])
    topics = model.get_topics(10)
    check(len(topics) == K and all(len(t) == 10 for t in topics),
          "get_topics did not return 50 lists of 10")
    print(f"main path: topic 0 {topics[0]}", flush=True)
    for name in rows:
        rows[name]["launches"] = launches[name]

    # Steady state: after one more warm fit, a 24-step fit minus an 8-step
    # fit cancels the per-fit set-up (client copies, corpus upload) and
    # leaves 16 steady steps; each fit is timed twice and the faster kept.
    run(num_epochs=2)
    secs8 = min(run(num_epochs=2)[2], run(num_epochs=2)[2])
    secs24 = min(run(num_epochs=6)[2], run(num_epochs=6)[2])
    docs_per_step = C * B
    ms_step = (secs24 - secs8) / 16 * 1e3
    check(ms_step > 0, f"steady-state step time {ms_step:.3f} ms is not positive")
    print(f"main path: steady {ms_step:.3f} ms per global step, "
          f"{docs_per_step / ms_step * 1e3:.1f} docs/s ({C} clients x B={B}); "
          f"warm 8-step fit {secs8 * 1e3:.1f} ms, 24-step fit {secs24 * 1e3:.1f} ms; "
          f"first 8-step fit {secs * 1e3:.1f} ms", flush=True)


def main() -> int:
    try:
        import torch
    except ImportError as err:
        print(f"chip_smoke: {err}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from gfedntm_tpu_torch.device import resolve_device
        from gfedntm_tpu_torch.ops import _build
    except ImportError as err:
        print(f"chip_smoke: the port is not next to this script ({err})", file=sys.stderr)
        return 2

    card = card_line()
    print(card, flush=True)
    resolve_device(None)
    try:
        t0 = time.perf_counter()
        lib = _build.build()
        print(f"build: {lib} in {time.perf_counter() - t0:.1f} s", flush=True)
        for line in _build.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"build: {line.strip()}", flush=True)
        rows, notes = kernel_phase(card)
        main_path_phase(rows)
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1
    for name, row in rows.items():
        print(f"kernel {name}: launches {row['launches']} max_abs_err {row['max_abs_err']:.3e} "
              f"ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
              f"bound_ms {row['bound_ms']:.4f}; {notes[name]}", flush=True)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
