#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``gfedntm_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # phases 1 and 2: iterate on the kernels
    python3 chip_smoke.py --kernels-only --against DIR  # and K1-K3 bitwise vs DIR's build
    python3 chip_smoke.py --data-parallel-only  # phases 1 and 6
    python3 chip_smoke.py --phase-7-only  # phases 1 and 7
    python3 chip_smoke.py --ctm-only      # phases 1 and 8
    python3 chip_smoke.py --federation-only  # phases 1 and 9

Nine phases, each fatal on failure (exit code 1; 2 when there is no CUDA
device or no port next to this script):

1. build — compile the fused decoder's CUDA kernels from
   ``gfedntm_tpu_torch/ops/csrc/`` with nvcc for sm_90a; print ptxas'
   registers and spills per kernel (a spill in a tensor-core kernel fails)
   and, from ``cuobjdump -sass``, the tensor-core instructions (HMMA/HGMMA)
   in each ``stats_kernel``, ``loss_kernel`` and ``grads_kernel``
   instantiation, FP32 and bf16 storage, none of which may have 0;
2. kernels — run K1 (stats), K2 (loss) and K3 (grads) at the slice's shapes
   (B=256, K=50, V=100,000), at B=320 (16-column tiles), at V=99,999 (the
   4-byte cp.async ring at full width), at V=66,001 (phase 7(b)'s shape,
   V % 4 = 1, training and eval), at B=64 / B=200 with V=3001 and at
   B=1100, K=8 (K1 and K2 on their CUDA-core route; K3 refuses that batch),
   in training and eval, with masked rows, an all-zero document row and an
   all-masked batch, and hold each against its plain PyTorch version on the
   card; print each case's routes; time kernel and plain version on both
   ring variants; print each kernel's and each plain version's error against
   a float64 plain run at the slice's shapes; check the autograd function
   against the unfused oracle on a small input. ``--against DIR`` also
   builds the fused decoder source of the checkout in DIR and requires its
   FP32 K1, K2 and K3 outputs to be bitwise equal to this build's in every
   case. Then the bf16-storage instantiations (:data:`BF16_CASES`: the
   slice's shape, V=99,999 at a padded pitch, eval, all rows masked, both
   tile widths, K2's tensor-core route past FP32's, the CUDA-core route at
   B=512 and B=1100) against their plain versions on the bf16-rounded beta
   and x, and their times beside the FP32 kernels' and the cast and pad's;
3. main path — federated ProdLDA through the user entry points
   (``AVITM`` -> ``FederatedTrainer.fit`` -> ``make_global_model`` ->
   ``get_topics``) at V=100,000, K=50, H=(100, 100), B=256, 2 clients,
   2 epochs (8 global steps), with the launch counters reset just before
   ``fit`` and read just after; then the same with ``compute_dtype=
   "bfloat16"`` (16 launches of each bf16 instantiation, float32 state
   equal across clients, step losses within 2% of the float32 run's and
   corr(beta_bf16, beta_f32) > 0.98); steady ms per step of both;
4. sharded — V-sharded (model-parallel) training in spawned ranks
   (``gfedntm_tpu_torch.parallel``): NCCL with one GPU per rank when there
   are enough GPUs, else gloo with every rank on ``cuda:0`` (the line says
   which). (a) K5 ``prodlda_recon_loss_vsharded`` at B=256, K=50, V=100,000
   over mp=2 and at B=64, V=3002 over mp=2 and dp=2 x mp=2, training and
   eval, masked rows and an all-masked batch, held against the full-V
   kernels and its plain version; (b) ``fit_sharded`` at V=100,000, K=50,
   H=(100, 100), B=256, 2,048 documents, 2 epochs (16 steps), dp=1 x mp=2,
   with each rank's launch counters reset just before and read just after,
   against an unsharded ``AVITM.fit`` on the card (first-step gradients,
   step losses, and beta against the spread that reduction order alone
   gives: an unsharded fit through the unfused decode); (c) teacher-forced
   steps: at steps 1, 4, 8 and 16 of the unsharded split-encoder fit, that
   fit's state, batch and noise go through both the mp=2 ranks and an
   unsharded model, and each leaf's worst gradient error is printed;
   (d) per-rank op time and steady ms per step of the sharded fit;
   (f) ``fit_sharded`` of a bf16 model, 1 epoch (8 steps), each rank's
   bf16 launches counted, against the unsharded bf16 fit (first-step
   gradients within 1e-2 of the largest gradient, each leaf's error over its
   own max|grad| printed; step losses within 1e-2 relative); K5 on bf16
   storage is among (a)'s cases;
5. persistence and validation, at V=100,000, K=50, H=(100, 100), B=256
   (checkpoints under ``build/chip_smoke``, removed afterwards): (a)
   ``AVITM.fit`` of 1,024 documents with 256 validation documents and a
   ``save_dir``, 3 epochs: finite validation losses, ``epoch_*.npz``/``.json``
   on every improvement, and a fresh ``AVITM.load`` of each saved epoch
   bitwise equal to the model as saved (state, topic-word matrix, eval loss
   with injected noise); the validation epoch's ms beside the training
   epoch's; (b) ``FederatedTrainer.fit`` of 2 clients x 1,024 documents, 8
   steps, ``checkpoint_every=4``, interrupted by its segment callback at step
   8 and resumed from step 4 in a fresh trainer, bitwise equal to the
   uninterrupted run, in float32 and bf16, with the checkpoint's size and
   write/restore ms; the uninterrupted float32 run bitwise equal to phase
   3's plain one; (c) that run's metrics records, all valid, and
   ``docs_per_s``; (d) ``fit_sharded`` with 256 validation documents at dp=1
   x mp=2 as in phase 4, 2 epochs: per rank, eval-mode K1 and K2 launches
   through K5 and K3's count left to the training steps; every validation
   loss within 1e-4 of the unsharded unfused eval teacher-forced from the
   same state, generator state and schedule; the same decisions on both
   ranks; rank 0's checkpoints loading into an unsharded ``AVITM`` equal to
   the gathered state. Then eval-mode K1 and K2 at one rank's shard
   (B=256, K=50, V=50,000) against their plain versions, timed beside their
   bounds (rows ``stats_eval`` and ``loss_eval``, launches from (d));
6. data parallel, four gloo ranks on the card (NCCL on four cards), V=100,000,
   K=50, H=(100, 100), B=256, 2,048 documents, dropout 0.2 with live noise:
   (a) ``fit_sharded`` at dp=2 x mp=2, one epoch (8 steps) and its
   validation on 256 documents: per rank K3 0 launches (training takes K5's
   rows-sharded branch, 8 calls), K1, K2 and K5 one eval-mode launch each;
   against the unsharded fused fit on the card: first-step gradients within
   1e-3 of each leaf's max|grad|, step losses within 1e-3, beta within 1.5x
   an unsharded unfused witness's spread (or 4 lr), validation within 1e-4
   of the teacher-forced unsharded eval, the state bitwise equal on all four
   ranks; (b) ``fit_data_sharded`` at dp=2, unfused, 8 steps, against the
   unsharded unfused fit: first-step gradients within 1e-3 of each leaf's
   max|grad|, step losses within 1e-4 relative, beta within 1e-4 but for no
   more entries than an unsharded witness (the fused fit against the
   unfused one) has beyond 1e-4, times 1.5;
   each with its steady ms per step per rank and the bytes per step of its
   batch gather and gradient sum, beside the card's name and power limit;
7. the unfused and LDA decodes at mp > 1, and the flow from raw text:
   (a) ``fit_sharded`` of unfused prodLDA at dp=1 x mp=2 and of LDA at
   dp=1 x mp=2 and dp=2 x mp=2 (gloo ranks on the card, NCCL on enough
   cards), phase 6's corpus and widths, dropout 0, one epoch (8 steps) and
   its validation on 256 documents, each against the unsharded fit of its
   model type on the card: first-step gradients within 1e-3 of each leaf's
   max|grad| (the leaves that cancel in exact arithmetic within 1e-5 of the
   largest, or twice an unsharded split-encoder witness's distance), step
   losses within 1e-4 relative, beta within 1e-4 but for no
   more entries than 1.5x an unsharded split-encoder witness has beyond
   1e-4 (+ 1e-4) and none further than 1.5x its largest (or 4 lr),
   validation within 1e-4 of the teacher-forced unsharded eval, the state
   bitwise equal on every rank, no kernel launched (K1-K3, K5, eval and
   rows-sharded counts all 0, printed), steady ms per step per rank, and
   where a rank group's seconds go (start-up, each fit's set-up, first
   step, fit and timed steps, teardown); the ranks map the corpus from a ``.npy`` file
   (``shared``; phases 4 to 6 too) rather than each receiving a pickled
   copy;
   (b) ``generate_synthetic_corpus(vocab_size=100,000, n_topics=50,
   n_docs=1024, n_nodes=2, materialize_docs=True)``'s token-string documents
   as ``RawCorpus`` clients -> ``run_vocab_consensus(max_features=None)``
   (the native BoW library built; V must be 66,001 and each client's BoW
   the synthetic BoW's columns in the vocabulary's order); K1-K3 on the
   first client's first batch at V=66,001 (theta from an initial model's
   encoder) against their plain versions -> ``AVITM``
   (K=50, H=(100, 100), B=256) -> ``FederatedTrainer.fit``, 2 epochs, with
   the launch counters reset just before and read just after (16 launches
   of each of K1-K3, K2 and K3 on the 4-byte ring since V % 4 = 1) ->
   ``make_global_model`` -> ``get_topics(10)`` -> ``npmi_coherence`` and
   ``topic_diversity`` over the clients' tokenised documents (finite, in
   [-1, 1] and [0, 1]); consensus s, vectorize s, steady ms per global step
   and docs/s, beside the card's name and power limit;
8. the CTM family and the externally-stepped clients (every check fatal):
   (a) 7(b)'s two raw-text clients (V=66,001) with 768-d
   ``hashing_embedder`` embeddings and seeded one-hot labels (L=5) ->
   ``CombinedTM`` (K=50, H=(100, 100), B=256) -> ``FederatedTrainer.fit``,
   8 steps, in float32 and in bf16, the launch counters reset just before
   and read just after (16 launches of each of K1-K3), K1-K3 on the path's
   first batch against their plain versions, shared state bitwise equal
   across clients, the global model's topics, NPMI and diversity, a
   bitwise ``save``/``load`` round trip, steady ms per global step and
   docs/s (24-step fit minus 8-step fit); (b) ``ZeroShotTM`` without labels
   on the same clients, 8 steps: 16 launches of each of K1-K3, finite epoch
   losses that fall; (c) ``fit_sharded`` of CombinedTM with labels on phase
   4's corpus (V=100,000, 2,048 documents, seeded normal embeddings),
   8 steps, at dp=1 x mp=2 (K5: 8 launches of K1-K3 and K5 per rank) and
   dp=2 x mp=2 (K5's rows-sharded branch, 8 calls, no kernel): first-step
   gradients within 1e-3 of each leaf's max|grad| of the unsharded
   CombinedTM's, step losses within 1e-3, the state bitwise equal on every
   rank, steady ms per step per rank; (d) two ``FederatedCTM`` steppers on
   (a)'s model and data, then two ``FederatedAVITM`` steppers on phase 3's
   data, 8 exchanged steps each through ``weighted_mean``: the
   ``StepStatus`` sequences, shared state bitwise equal after every
   ``delta_update_fit``, 16 launches of each of K1-K3, and ms per exchanged
   step split into step, snapshot (with its device-to-host bytes), mean and
   set.
9. the gRPC federation (every check fatal): a port ``FederatedServer`` and
   two port ``Client``s over localhost gRPC in this process, on the card,
   on 7(b)'s raw-text clients (each client's own vocabulary offered to the
   server's consensus: V=66,001), K=50, H=(100, 100), B=256, 2 epochs (8
   global steps), the launch counters reset just before the clients start
   and read after they stop (16 launches of each of K1-K3); K1-K3 on the
   first client's first batch against their plain versions; the shared
   state bitwise equal across clients after every aggregate; every step
   loss, StepStatus and state bitwise equal to the same two
   ``FederatedAVITM`` steppers driven in process through
   ``weighted_mean``; ``server_model.npz`` written; ms per global step
   split into client step, snapshot and encode, transfer and decode, mean,
   and push and set (median over steps 2-8), and the bytes each way per
   step and client.

Output: the card's name and power limit first; one line per kernel (launch
count, max error and its tolerance, kernel, plain and bound ms); a
``{"kernels": [...]}`` JSON line before the last; and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

# Published peaks by card (NVIDIA data sheets; dense, no sparsity: half the
# sheets' sparse tensor-core figures): memory bytes/s, FP32 FLOP/s on the
# CUDA cores, and TF32 FLOP/s on the tensor cores. Keys are matched against
# the nvidia-smi name; the SXM part is the default.
_PEAKS = (
    ("H100 NVL", 3.9e12, 60e12, 417.5e12),
    ("H100 PCIe", 2.0e12, 51e12, 378e12),
    ("H200", 4.8e12, 67e12, 495e12),
    ("H100", 3.35e12, 67e12, 495e12),
)
# An FP32-accurate product on the tensor cores is three TF32 products
# (3xTF32: a_lo*b_hi + a_hi*b_lo + a_hi*b_hi).
TF32_PASSES = 3
# TF32 products per FP32-accurate FLOP of each kernel, by storage. A bf16
# operand is exact in TF32 (its lo half is zero), so a product with beta
# takes two: K1's z and K2's z take two, K3's z and g_theta two each and its
# g_beta = theta^T gz three, 7 of its 3 GEMMs' 9.
TF32_PRODUCTS = {
    "float32": {"stats": 3, "loss": 3, "grads": 3},
    "bfloat16": {"stats": 2, "loss": 2, "grads": 7 / 3},
}
RTOL, ATOL = 1e-4, 1e-5  # kernel vs plain: |err| <= ATOL + RTOL * max|plain|
# Gradients that are zero in exact arithmetic (BatchNorm removes a bias; the
# batch mean of the normalized mu is zero): both sides see rounding noise.
DEGENERATE = ("inf_net.f_mu.bias", "inf_net.f_sigma.bias", "prior_mean")


class SmokeFailure(Exception):
    pass


def check(ok: bool, message: str) -> None:
    if not ok:
        raise SmokeFailure(message)


def check_same_state(res: list, label: str) -> None:
    """The gathered state of a ``programs.fit`` is bitwise equal on every
    rank: world rank 0's state is the one its digest names, and every
    rank's digest equals rank 0's."""
    from gfedntm_tpu_torch.parallel import programs

    want = res[0]["state_digest"]
    check(programs.state_digest(res[0]["state"]) == want,
          f"{label}: rank 0's state is not the one its digest names")
    for rank, r in enumerate(res[1:], 1):
        for key in sorted(set(want) | set(r["state_digest"])):
            check(r["state_digest"].get(key) == want.get(key),
                  f"{label}: {key} differs between rank 0 and rank {rank} after the fit")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=False,
    )
    return (out.stdout.strip().splitlines() or [f"nvidia-smi failed: {out.stderr.strip()}"])[0]


def peaks(name: str) -> tuple[float, float, float, str]:
    """(bytes/s, FP32 FLOP/s, TF32 FLOP/s, matched key) of the card."""
    for key, bw, simt, tf32 in _PEAKS:
        if key in name:
            return bw, simt, tf32, key
    return (*_PEAKS[-1][1:], "H100 (assumed)")


def kernel_bound(nbytes: float, nflops: float, card: str,
                 passes: float = TF32_PASSES) -> dict:
    """The least time the card could take for a function that moves
    ``nbytes`` and does ``nflops`` FP32-accurate FLOPs: the larger of the
    bytes over the memory rate and the FLOPs as ``passes`` TF32 products
    each (3xTF32; fewer on bf16 operands, :data:`TF32_PRODUCTS`) over the
    tensor cores' dense TF32 rate; and, for the record, the FP32 SIMT bound
    (FLOPs over the CUDA cores' FP32 rate instead)."""
    bw, simt, tf32, key = peaks(card)
    t_bytes = nbytes / bw * 1e3
    t_ops = passes * nflops / tf32 * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes, "ops_ms": t_ops,
        "simt_bound_ms": max(t_bytes, nflops / simt * 1e3), "peaks": key,
    }


@functools.lru_cache(maxsize=None)
def synthetic_bow(vocab_size: int, n_topics: int, n_docs: int, seed: int):
    """One node's BoW of ``generate_synthetic_corpus`` (no documents), made
    once per script run: phases 4 to 7 train on the same corpora."""
    from gfedntm_tpu_torch import generate_synthetic_corpus

    return generate_synthetic_corpus(vocab_size=vocab_size, n_topics=n_topics, n_docs=n_docs,
                                     n_nodes=1, materialize_docs=False, seed=seed).nodes[0].bow


CORPORA = Path(__file__).resolve().parent / "build" / "chip_smoke_corpora"
_SHARED: dict[int, tuple[object, str]] = {}


def shared(X) -> str:
    """The path of a ``.npy`` copy of ``X`` under :data:`CORPORA`, written
    once per array: spawned ranks map it (``programs.corpus``) instead of
    each receiving a pickled copy through its spawn pipe, which the parent
    fills one rank at a time. ``main`` removes the directory."""
    import numpy as np

    if id(X) not in _SHARED:
        CORPORA.mkdir(parents=True, exist_ok=True)
        path = CORPORA / f"corpus_{len(_SHARED)}.npy"
        np.save(path, X)
        _SHARED[id(X)] = (X, str(path))  # the reference keeps id(X) unique
    return _SHARED[id(X)][1]


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
# Phase 1: what the build made
# ---------------------------------------------------------------------------
def _kernel_name(mangled: str) -> str:
    """``stats_kernel<32, 16B>``, ``stats_kernel<bf16, 32, 16B>`` etc. from a
    mangled name (the CUDA-core ``simt_stats_kernel``, ``<bf16>`` for its bf16
    instantiation, and the fold kernels as they are)."""
    found = re.search(r"((?:simt_)?(?:stats|loss)_kernel|grads_kernel|merge_softmax_kernel|"
                      r"fold_rows_kernel|sum_partials_kernel)"
                      r"(?:I(f|13__nv_bfloat16)?(?:Li(\d+)ELb([01])E)?E)?", mangled)
    if not found:
        return mangled
    name, storage, width, vec16 = found.groups()
    args = ["bf16"] if storage == "13__nv_bfloat16" else []
    if width:
        args += [width, "16B" if vec16 == "1" else "4B"]
    return f"{name}<{', '.join(args)}>" if args else name


TENSOR_CORE_FAMILIES = ("stats_kernel", "loss_kernel", "grads_kernel")


def check_tensor_core_counts(counts: dict) -> None:
    """Every instantiation of each tensor-core kernel family has at least one
    HMMA/HGMMA instruction, and each family has an FP32 and a bf16-storage
    instantiation."""
    for family in TENSOR_CORE_FAMILIES:
        for storage, want in (("FP32", False), ("bf16", True)):
            check(any(name.startswith(family + "<") and name.startswith(family + "<bf16") == want
                      for name in counts),
                  f"cuobjdump found no {storage} {family} instantiation among {sorted(counts)}")
    for name, n in counts.items():
        check(n > 0, f"{name}: no HMMA/HGMMA instruction in its SASS")


def ptxas_report(build_log: str) -> tuple[list[str], dict]:
    """ptxas' register and spill lines per kernel, and the spilled bytes
    (stores + loads) per kernel."""
    lines, spills, current = [], {}, None
    for line in build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            current = _kernel_name(entry.group(1))
        elif current and ("registers" in line or "spill" in line):
            lines.append(f"ptxas {current}: {line.strip().removeprefix('ptxas info    : ')}")
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill:
                spills[current] = spills.get(current, 0) + int(spill[1]) + int(spill[2])
    return lines, spills


def build_report(lib: Path, build_log: str) -> list[str]:
    """Prints ptxas' registers and spills per kernel (when this process built
    the library; a tensor-core kernel that spills then fails), and returns
    the line of tensor-core instructions (HMMA, HGMMA) that ``cuobjdump
    -sass`` finds in each instantiation of K1, K2 and K3
    (:func:`check_tensor_core_counts`). Fails when there is no cuobjdump to
    look."""
    lines, spills = ptxas_report(build_log)
    if not build_log:
        lines.append("ptxas: library up to date, not rebuilt in this process")
    for line in lines:  # before any check, so that a failing build shows them all
        print(f"build: {line}", flush=True)
    for name, nbytes in spills.items():
        check(nbytes == 0 or not name.startswith(TENSOR_CORE_FAMILIES),
              f"{name}: ptxas reports {nbytes} bytes of spill stores and loads")
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    check(Path(tool).exists(), f"cuobjdump not found ({tool}): cannot count tensor-core "
          "instructions")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=False)
    check(sass.returncode == 0, f"cuobjdump -sass failed: {sass.stderr.strip()}")
    counts, current = {}, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            name = _kernel_name(line.split("Function :")[1].strip())
            current = name if name.startswith(TENSOR_CORE_FAMILIES) else None
            if current:
                counts[current] = 0
        elif current and re.search(r"\bH(G)?MMA\b", line):
            counts[current] += 1
    check_tensor_core_counts(counts)
    return ["tensor-core instructions (HMMA/HGMMA in cuobjdump -sass): " + ", ".join(
        f"{name} {n}" for name, n in sorted(counts.items()))]


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


def kernel_work(b, k, v, storage="float32") -> dict:
    """Per kernel: (bytes, each input read once and each output written
    once; FP32-accurate FLOPs). ``storage="bfloat16"``: beta and x read as
    2 bytes a value (at V, not at the padded pitch); everything else 4."""
    f4, fs = 4.0, 2.0 if storage == "bfloat16" else 4.0
    bk, kv, bv = b * k, k * v, b * v
    return {
        "stats": (f4 * (bk + b + 2 * v + 2 * b) + fs * kv, 2.0 * b * k * v),
        "loss": (f4 * (bk + 2 * v + 2 * b + 2 * b) + fs * (kv + bv), 2.0 * b * k * v),
        "grads": (f4 * (bk + 2 * v + 5 * b + bk + kv) + fs * (kv + bv), 6.0 * b * k * v),
    }


def vsharded_work(b, k, v, mp, storage="float32") -> tuple[float, float, float]:
    """K5 per rank: (bytes, FLOPs, the collectives' share of the bytes) —
    one rank's K1 + K2 + K3 on V/mp, plus what its collectives move (the
    softmax merge and the loss/row-dot sum, [mp, 2, B] each, and the g_theta
    sum, [mp, B, K])."""
    work = kernel_work(b, k, v // mp, storage)
    coll = 4.0 * (mp * 2 * b + mp * 2 * b + mp * b * k)
    return (sum(w[0] for w in work.values()) + coll, sum(w[1] for w in work.values()), coll)


def vsharded_passes(storage="float32") -> float:
    """K5's TF32 products per FP32-accurate FLOP: its kernels' FLOPs
    (2 : 2 : 6) weighted by :data:`TF32_PRODUCTS`."""
    p = TF32_PRODUCTS[storage]
    return (2 * p["stats"] + 2 * p["loss"] + 6 * p["grads"]) / 10


ROUTE_NAMES = {32: "tensor cores, 32-column tiles", 16: "tensor cores, 16-column tiles",
               0: "CUDA cores", -1: "refused"}


def against_library(root: Path):
    """The fused decoder built from the checkout at ``root`` (another commit,
    to compare two builds on one card), loaded beside this one."""
    import ctypes

    from gfedntm_tpu_torch.ops import _build

    source = root / "gfedntm_tpu_torch" / "ops" / "csrc" / "fused_decoder.cu"
    check(source.exists(), f"--against {root}: no {source}")
    library = _build.build(source, _build.BUILD_DIR.parent / "against" / "libfused_decoder.so")
    return _build.declare(ctypes.CDLL(str(library)))


def accuracy_line(st_args, lo_args, gr_args) -> str:
    """Each kernel's and each plain version's max |error| against the plain
    version run in float64 on the same float32 inputs (K2 and K3 take the
    float32 plain statistics, as the comparison above does)."""
    import torch

    from gfedntm_tpu_torch.ops import fused_decoder as fd

    def f64(args):
        return tuple(a.double() if torch.is_tensor(a) else a for a in args)

    parts = []
    for name, labels, kernel, plain, args in (
        ("stats", "mean,var,m,s", fd.stats, fd.stats_reference, st_args),
        ("loss", "loss,rd", fd.loss, fd.loss_reference, lo_args),
        ("grads", "g_theta,g_beta", fd.grads, fd.grads_reference, gr_args),
    ):
        got, ref, exact = kernel(*args), plain(*args), plain(*f64(args))
        torch.cuda.synchronize()
        for label, a, b, e in zip(labels.split(","), got, ref, exact):
            keep = e.abs() < 1e29  # softmax-max sentinels, compared exactly elsewhere
            scale = float(e[keep].abs().max())
            errs = [float((x.double() - e)[keep].abs().max()) for x in (a, b)]
            parts.append(f"{name} {label} {errs[0]:.3e} / {errs[1]:.3e} (max|x| {scale:.3e})")
    return "; ".join(parts)


def kernel_phase(card: str, against: Path | None = None) -> tuple[dict, dict]:
    import torch

    from gfedntm_tpu_torch.ops import _build
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    lib = _build.load()
    other = against_library(against) if against else None
    cases = [
        (256, 50, 100_000, "partial", True), (256, 50, 100_000, "partial", False),
        (320, 50, 100_000, "partial", True), (256, 50, 99_999, "partial", True),
        (256, 50, 66_001, "partial", True), (256, 50, 66_001, "partial", False),
        (64, 50, 3001, "partial", True), (64, 50, 3001, "partial", False),
        (64, 50, 3001, "all", True), (64, 50, 3001, "all", False),
        (200, 50, 3001, "partial", True), (200, 50, 3001, "none", False),
        (1100, 8, 3001, "partial", True),
    ]
    worst = {"stats": 0.0, "loss": 0.0, "grads": 0.0}
    seen = {"stats": set(), "loss": set()}
    bitwise = 0
    for i, (b, k, v, mask_kind, training) in enumerate(cases):
        t = make_inputs(b, k, v, seed=i, mask_kind=mask_kind)
        case = f"B={b} K={k} V={v} mask={mask_kind} {'train' if training else 'eval'}"
        routes = {name: fd._route(lib, name, b, k) for name in worst}
        st_args = (t["theta"], t["beta"], t["mask"], t["run_mean"], t["run_var"], training)
        ref_stats = fd.stats_reference(*st_args)
        got_stats = fd.stats(*st_args)
        worst["stats"] = max(worst["stats"], compare(
            "mean,var,m,s", got_stats, ref_stats, case))
        mean, var, m, s = ref_stats
        lo_args = (t["theta"], t["beta"], t["x"], mean, var, m, s)
        ref_loss = fd.loss_reference(*lo_args)
        got_loss = fd.loss(*lo_args)
        worst["loss"] = max(worst["loss"], compare("loss,rd", got_loss, ref_loss, case))
        if other is not None:
            for name, got, theirs in (
                    ("K1", got_stats, fd._launch_stats(other, *st_args, 1e-5)),
                    ("K2", got_loss, fd._launch_loss(other, *lo_args, 1e-5, 1e-10))):
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, theirs)),
                      f"{case}: {name} differs from the build of {against}")
        for name in seen:
            seen[name].add(routes[name])
        if routes["grads"] >= 0:
            gr_args = lo_args + (ref_loss[1], t["g"], t["mask"], training)
            got = fd.grads(*gr_args)
            worst["grads"] = max(worst["grads"], compare(
                "g_theta,g_beta", got, fd.grads_reference(*gr_args), case))
            if other is not None:
                theirs = fd._launch_grads(other, *gr_args, 1e-5, 1e-10)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, theirs)),
                      f"{case}: K3 differs from the build of {against}")
                bitwise += 1
        print(f"kernels ok: {case}; routes: " + ", ".join(
            f"{name} {ROUTE_NAMES[r]}" for name, r in routes.items()), flush=True)
    for name, routes in seen.items():
        check({32, 16, 0} <= routes, f"{name}: the smoke cases took only the routes "
              f"{sorted(routes)}")
    if other is not None:
        print(f"kernels ok: K1 and K2 bitwise equal to the build of {against} in "
              f"{len(cases)} cases, K3 in {bitwise}", flush=True)

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

    # Timing at the slice's shapes (training, as the main path runs them):
    # V=100,000 takes the 16-byte cp.async ring, V=99,999 the 4-byte one.
    b, k = 256, 50
    rows, notes = {}, {}
    for v in (100_000, 99_999):
        t = make_inputs(b, k, v, seed=0, mask_kind="partial")
        st_args = (t["theta"], t["beta"], t["mask"], t["run_mean"], t["run_var"], True)
        mean, var, m, s = fd.stats_reference(*st_args)
        lo_args = (t["theta"], t["beta"], t["x"], mean, var, m, s)
        gr_args = lo_args + (fd.loss_reference(*lo_args)[1], t["g"], t["mask"], True)
        fns = {
            "stats": (lambda: fd.stats(*st_args), lambda: fd.stats_reference(*st_args)),
            "loss": (lambda: fd.loss(*lo_args), lambda: fd.loss_reference(*lo_args)),
            "grads": (lambda: fd.grads(*gr_args), lambda: fd.grads_reference(*gr_args)),
        }
        if v != 100_000:
            for name, (kernel_fn, _) in fns.items():
                ms = [time_ms(kernel_fn) for _ in range(2)]
                notes[name] += f"; at V={v} (4-byte cp.async ring) ms {ms[0]:.4f}/{ms[1]:.4f}"
            continue
        work = kernel_work(b, k, v)
        for name, (kernel_fn, plain_fn) in fns.items():
            # plain, kernel, kernel, plain: compare within one call, in turns.
            p1 = time_ms(plain_fn)
            k1 = time_ms(kernel_fn)
            k2 = time_ms(kernel_fn)
            p2 = time_ms(plain_fn)
            nbytes, nflops = work[name]
            bound = kernel_bound(nbytes, nflops, card)
            rows[name] = {
                "name": name, "route": "cuda",
                "source": "gfedntm_tpu_torch/ops/csrc/fused_decoder.cu",
                "replaces": REPLACES[name], "launches": 0,
                "max_abs_err": worst[name],
                "ms": min(k1, k2), "plain_ms": min(p1, p2),
                "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                "library_ms": None,
            }
            notes[name] = (
                f"tol {ATOL:g} + {RTOL:g}*max|plain| per output; ms {k1:.4f}/{k2:.4f} "
                f"plain_ms {p1:.4f}/{p2:.4f}; bound {bound['bound_by']} ({bound['peaks']} "
                f"peaks: {nbytes / 1e6:.1f} MB -> {bound['bytes_ms']:.4f} ms, "
                f"{nflops / 1e9:.2f} GFLOP as 3xTF32 -> {bound['ops_ms']:.4f} ms); FP32 SIMT "
                f"bound {bound['simt_bound_ms']:.4f} ms"
            )
        print(f"accuracy at B={b} K={k} V={v} train, max |err| against the plain version in "
              f"float64 (kernel / float32 plain): {accuracy_line(st_args, lo_args, gr_args)}",
              flush=True)
    bf16_kernel_phase(card, lib, rows, notes)
    return rows, notes


# (B, K, V, mask kind, training): the main path's shape, its padded pitch
# (V=99,999), the CTM flow's shape (V=66,001: 7 pad columns), eval, all rows
# masked, 16-column tiles (B=320), K2's tensor-core route past where FP32
# leaves it (B=360: half-size x stages), and the CUDA-core route (B=512, past
# the FP32 route boundary; B=1100).
BF16_CASES = [
    (256, 50, 100_000, "partial", True), (256, 50, 100_000, "partial", False),
    (256, 50, 99_999, "partial", True), (256, 50, 99_999, "none", False),
    (256, 50, 66_001, "partial", True), (256, 50, 66_001, "partial", False),
    (320, 50, 100_000, "partial", True), (360, 50, 20_001, "partial", True),
    (360, 50, 20_001, "partial", False), (512, 50, 20_000, "partial", True),
    (64, 50, 3001, "all", True), (64, 50, 3001, "all", False),
    (1100, 8, 3001, "partial", True),
]
REPLACES = {
    "stats": "gfedntm_tpu/ops/fused_decoder.py:189",
    "loss": "gfedntm_tpu/ops/fused_decoder.py:266",
    "grads": "gfedntm_tpu/ops/fused_decoder.py:612",
}


def bf16_kernel_phase(card: str, lib, rows: dict, notes: dict) -> None:
    """The bf16-storage instantiations of K1, K2 and K3 against their plain
    versions (the FP32 plain versions on the bf16-rounded beta and x) in
    :data:`BF16_CASES`; whether they equal the FP32 kernels on the same
    rounded values bit for bit where both take the same route; their times
    at the main path's shape beside the FP32 kernels' (``rows``) from this
    call; and the wrapper's cast-and-pad of beta and x."""
    import torch

    from gfedntm_tpu_torch.ops import fused_decoder as fd

    bf = "bfloat16"
    worst = {"stats": 0.0, "loss": 0.0, "grads": 0.0}
    seen = {"stats": set(), "loss": set()}
    same_bits, same_route = 0, 0
    for i, (b, k, v, mask_kind, training) in enumerate(BF16_CASES):
        t = make_inputs(b, k, v, seed=200 + i, mask_kind=mask_kind)
        case = f"bf16 B={b} K={k} V={v} mask={mask_kind} {'train' if training else 'eval'}"
        routes = {name: fd._route(lib, name, b, k, bf) for name in worst}
        routes32 = {name: fd._route(lib, name, b, k) for name in worst}
        beta_s, x_s = fd.store(t["beta"], bf), fd.store(t["x"], bf)
        beta_r, x_r = beta_s.float(), x_s.float()  # the values the kernels read
        st = (t["theta"], beta_s, t["mask"], t["run_mean"], t["run_var"], training)
        st_plain = (t["theta"], beta_r) + st[2:]
        ref_stats = fd.stats_reference(*st_plain)
        got = {"stats": fd.stats(*st, storage_dtype=bf)}
        worst["stats"] = max(worst["stats"], compare("mean,var,m,s", got["stats"], ref_stats,
                                                     case))
        mean, var, m, s = ref_stats
        lo_plain = (t["theta"], beta_r, x_r, mean, var, m, s)
        ref_loss = fd.loss_reference(*lo_plain)
        got["loss"] = fd.loss(t["theta"], beta_s, x_s, mean, var, m, s, storage_dtype=bf)
        worst["loss"] = max(worst["loss"], compare("loss,rd", got["loss"], ref_loss, case))
        for name in seen:
            seen[name].add(routes[name])
        gr_rest = (mean, var, m, s, ref_loss[1], t["g"], t["mask"], training)
        if routes["grads"] >= 0:
            got["grads"] = fd.grads(t["theta"], beta_s, x_s, *gr_rest, storage_dtype=bf)
            worst["grads"] = max(worst["grads"], compare(
                "g_theta,g_beta", got["grads"], fd.grads_reference(*lo_plain[:3], *gr_rest),
                case))
        # The FP32 kernels on the same rounded values, uncounted.
        fp32 = {
            "stats": lambda: fd._launch_stats(lib, *st_plain, 1e-5),
            "loss": lambda: fd._launch_loss(lib, *lo_plain, 1e-5, 1e-10),
            "grads": lambda: fd._launch_grads(lib, *lo_plain[:3], *gr_rest, 1e-5, 1e-10),
        }
        for name, out in got.items():
            if routes[name] == routes32[name]:
                theirs = fp32[name]()
                torch.cuda.synchronize()
                same_route += 1
                same_bits += all(torch.equal(a, c) for a, c in zip(out, theirs))
        print(f"kernels ok: {case}; routes: " + ", ".join(
            f"{name} {ROUTE_NAMES[r]}" for name, r in routes.items()), flush=True)
    for name, routes in seen.items():
        check({32, 16, 0} <= routes, f"bf16 {name}: the smoke cases took only the routes "
              f"{sorted(routes)}")
    print(f"kernels: bf16 outputs bitwise equal to the FP32 kernels' on the bf16-rounded "
          f"inputs in {same_bits} of {same_route} launches on the same route", flush=True)

    # Times at the main path's shape, training, with beta and x stored as the
    # main path stores them; plain, kernel, kernel, plain.
    b, k, v = 256, 50, 100_000
    t = make_inputs(b, k, v, seed=0, mask_kind="partial")
    beta_s, x_s = fd.store(t["beta"], bf), fd.store(t["x"], bf)
    st = (t["theta"], beta_s, t["mask"], t["run_mean"], t["run_var"], True)
    mean, var, m, s = fd.stats_reference(t["theta"], beta_s.float(), *st[2:])
    lo = (t["theta"], beta_s, x_s, mean, var, m, s)
    rd = fd.loss_reference(t["theta"], beta_s.float(), x_s.float(), mean, var, m, s)[1]
    gr_rest = (mean, var, m, s, rd, t["g"], t["mask"], True)
    fns = {
        "stats": (lambda: fd.stats(*st, storage_dtype=bf),
                  lambda: fd.stats_reference(t["theta"], beta_s.float(), *st[2:])),
        "loss": (lambda: fd.loss(*lo, storage_dtype=bf),
                 lambda: fd.loss_reference(t["theta"], beta_s.float(), x_s.float(),
                                           *lo[3:])),
        "grads": (lambda: fd.grads(*lo[:3], *gr_rest, storage_dtype=bf),
                  lambda: fd.grads_reference(t["theta"], beta_s.float(), x_s.float(),
                                             *gr_rest)),
    }
    work = kernel_work(b, k, v, bf)
    for name, (kernel_fn, plain_fn) in fns.items():
        p1, k1, k2, p2 = (time_ms(fn) for fn in (plain_fn, kernel_fn, kernel_fn, plain_fn))
        nbytes, nflops = work[name]
        bound = kernel_bound(nbytes, nflops, card, TF32_PRODUCTS[bf][name])
        rows[name + "_bf16"] = {
            "name": name + "_bf16", "route": "cuda",
            "source": "gfedntm_tpu_torch/ops/csrc/fused_decoder.cu",
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": worst[name],
            "ms": min(k1, k2), "plain_ms": min(p1, p2),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "library_ms": None,
        }
        notes[name + "_bf16"] = (
            f"bf16 beta and x; tol {ATOL:g} + {RTOL:g}*max|plain| per output; ms "
            f"{k1:.4f}/{k2:.4f} (FP32 kernel in this call {rows[name]['ms']:.4f}) plain_ms "
            f"{p1:.4f}/{p2:.4f}; bound {bound['bound_by']} ({bound['peaks']} peaks: "
            f"{nbytes / 1e6:.1f} MB -> {bound['bytes_ms']:.4f} ms, {nflops / 1e9:.2f} GFLOP as "
            f"{TF32_PRODUCTS[bf][name]:.3g} TF32 products -> {bound['ops_ms']:.4f} ms)"
        )
    # The wrapper's cast and pad, once per step: beta [K, V] and x [B, V]
    # from float32 to bf16 at the padded pitch.
    cast_ms = [time_ms(lambda: (fd.store(t["beta"], bf), fd.store(t["x"], bf)))
               for _ in range(2)]
    print(f"kernels: bf16 cast and pad of beta [{k}, {v}] and x [{b}, {v}] per step: "
          f"ms {cast_ms[0]:.4f}/{cast_ms[1]:.4f}", flush=True)


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------
def main_path_datasets() -> list:
    """Phase 3's two client datasets: ``generate_synthetic_corpus``
    (V=100,000, K=50, 1,024 documents per client, seed 0) as BoW."""
    from gfedntm_tpu_torch import BowDataset, generate_synthetic_corpus

    V, K, C = 100_000, 50, 2
    t0 = time.perf_counter()
    corpus = generate_synthetic_corpus(
        vocab_size=V, n_topics=K, n_docs=1024, n_nodes=C, materialize_docs=False, seed=0,
    )
    idx2token = {i: f"wd{i}" for i in range(V)}
    datasets = [BowDataset(X=node.bow, idx2token=idx2token) for node in corpus.nodes]
    print(f"main path: synthetic corpus {C} x {datasets[0].X.shape} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return datasets


def main_path_phase(rows: dict) -> tuple[list, object]:
    """Phase 3; returns the client datasets and the float32 fit's result."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch import AVITM, FederatedTrainer
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    V, K, B, C = 100_000, 50, 256, 2
    datasets = main_path_datasets()

    def run(num_epochs, compute_dtype="float32"):
        template = AVITM(input_size=V, n_components=K, hidden_sizes=(100, 100),
                         batch_size=B, num_epochs=num_epochs, compute_dtype=compute_dtype)
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
    for name in ("stats", "loss", "grads"):
        rows[name]["launches"] = launches[name]

    # bf16 compute from the same seed, read just after its own fit: the
    # main path through the bf16 instantiations, held to float32 state and
    # against the float32 run above.
    for key in fd.LAUNCHES:
        fd.LAUNCHES[key] = 0
    _, result16, secs16 = run(num_epochs=2, compute_dtype="bfloat16")
    launches16 = dict(fd.LAUNCHES)
    print(f"main path bf16: fit {result16.losses.shape[0]} global steps x {C} clients in "
          f"{secs16:.3f} s; launches {launches16}; epoch losses {result16.epoch_losses}",
          flush=True)
    check(result16.losses.shape == (8, C), f"bf16 losses shape {result16.losses.shape}")
    check(bool(np.isfinite(result16.losses).all()), "non-finite bf16 federated losses")
    for name in ("stats", "loss", "grads"):
        check(launches16[name + "_bf16"] == 16 and launches16[name] == 0,
              f"bf16 main path: {name} launched {launches16[name + '_bf16']} times in bf16 "
              f"(want 16) and {launches16[name]} in float32 (want 0)")
        rows[name + "_bf16"]["launches"] = launches16[name + "_bf16"]
    for tree in (result16.client_params, result16.client_batch_stats):
        for key, val in tree[0].items():
            check(val.dtype in (torch.float32, torch.long), f"bf16 run: {key} is {val.dtype}")
            for other in tree[1:]:
                check(torch.equal(val, other[key]), f"bf16 run: {key} differs across clients")
    rel = float(np.max(np.abs(result16.losses - result.losses) / np.abs(result.losses)))
    betas = [r.client_params[0]["beta"].cpu().numpy().ravel() for r in (result16, result)]
    corr = float(np.corrcoef(*betas)[0, 1])
    print(f"main path bf16 vs float32, same seed: max relative step-loss difference {rel:.3e} "
          f"(limit 2e-2); corr(beta_bf16, beta_f32) {corr:.6f} (limit 0.98)", flush=True)
    check(rel <= 2e-2, f"bf16 step losses differ from float32 by {rel:.3e} (limit 2e-2)")
    check(corr > 0.98, f"corr(beta_bf16, beta_f32) {corr:.6f} <= 0.98")

    # Steady state: after one more warm fit, a 24-step fit minus an 8-step
    # fit cancels the per-fit set-up (client copies, corpus upload) and
    # leaves 16 steady steps; each fit is timed twice and the faster kept.
    for dtype in ("float32", "bfloat16"):
        run(2, dtype)
        secs8 = min(run(2, dtype)[2], run(2, dtype)[2])
        secs24 = min(run(6, dtype)[2], run(6, dtype)[2])
        docs_per_step = C * B
        ms_step = (secs24 - secs8) / 16 * 1e3
        check(ms_step > 0, f"steady-state step time {ms_step:.3f} ms is not positive")
        print(f"main path {dtype}: steady {ms_step:.3f} ms per global step, "
              f"{docs_per_step / ms_step * 1e3:.1f} docs/s ({C} clients x B={B}); "
              f"warm 8-step fit {secs8 * 1e3:.1f} ms, 24-step fit {secs24 * 1e3:.1f} ms; "
              f"first 8-step fit {(secs if dtype == 'float32' else secs16) * 1e3:.1f} ms",
              flush=True)
    return datasets, result


# ---------------------------------------------------------------------------
# Phase 4: V-sharded training in spawned ranks
# ---------------------------------------------------------------------------
def split_input_layer(model, parts: int) -> None:
    """Make ``model``'s encoder input layer sum its ``parts`` column blocks,
    each one contiguous GEMM, in block order, and then add the bias: the
    reduction order that V-sharding over ``parts`` ranks gives the encoder,
    without sharding."""
    import types

    import torch.nn.functional as F

    layer = model.model.inf_net.input_layer
    v = layer.weight.shape[1]
    cuts = [i * v // parts for i in range(parts + 1)]

    def forward(self, x):
        blocks = [F.linear(x[:, a:b].contiguous(), self.weight[:, a:b].contiguous())
                  for a, b in zip(cuts[:-1], cuts[1:])]
        out = blocks[0]
        for block in blocks[1:]:
            out = out + block
        return out + self.bias

    layer.forward = types.MethodType(forward, layer)


def sharded_op_phase() -> tuple[dict, dict, str]:
    """(a): K5 against the full-V kernels and its plain version, on float32
    and on bf16 storage. Returns, by storage, the worst |K5 - full kernel|
    and rank 0's op times; and the backend."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch.ops import fused_decoder as fd
    from gfedntm_tpu_torch.parallel import programs
    from gfedntm_tpu_torch.parallel.launch import gpu_layout, run_ranks

    f32, bf = "float32", "bfloat16"
    layouts = {  # (dp, mp): [(B, V, mask kind, training, timing reps, storage)]
        (1, 2): [(256, 100_000, "partial", True, 10, f32), (256, 100_000, "partial", False, 0, f32),
                 (64, 3002, "partial", True, 0, f32), (64, 3002, "partial", False, 0, f32),
                 (64, 3002, "all", True, 0, f32), (64, 3002, "all", False, 0, f32),
                 (256, 100_000, "partial", True, 10, bf), (64, 3002, "partial", False, 0, bf),
                 (64, 3002, "all", True, 0, bf)],
        (2, 2): [(64, 3002, "partial", True, 0, f32), (64, 3002, "partial", False, 0, f32),
                 (64, 3002, "all", True, 0, f32), (64, 3002, "all", False, 0, f32)],
    }
    worst, times, outputs = {f32: 0.0, bf: 0.0}, {}, "rl,mean,var,g_theta,g_beta"
    for (dp, mp), specs in layouts.items():
        backend, devices = gpu_layout(dp * mp)
        cases, full = [], []
        for i, (b, v, mask_kind, training, reps, storage) in enumerate(specs):
            t = make_inputs(b, 50, v, seed=100 + i, mask_kind=mask_kind)
            cases.append({**{k: t[k].cpu().numpy() for k in (
                "theta", "beta", "x", "run_mean", "run_var", "mask", "g")},
                "training": training, "reps": reps, "storage": storage})
            th = t["theta"].clone().requires_grad_(True)
            be = t["beta"].clone().requires_grad_(True)
            rl, mean, var = fd.prodlda_recon_loss(th, be, t["x"], t["run_mean"],
                                                  t["run_var"], t["mask"], training,
                                                  storage_dtype=storage)
            (rl * t["g"]).sum().backward()
            _, _, m, s = fd.stats(t["theta"], fd.store(t["beta"], storage), t["mask"],
                                  t["run_mean"], t["run_var"], training, storage_dtype=storage)
            full.append(((rl, mean, var, th.grad, be.grad), (m, s)))
        t0 = time.perf_counter()
        res = run_ranks(programs.vsharded_op, dp * mp, backend, devices, 600,
                        args=(dp, mp, cases))
        print(f"sharded op: {backend}, dp={dp} x mp={mp} on {devices}, "
              f"{len(specs)} cases in {time.perf_counter() - t0:.1f} s", flush=True)
        for i, (b, v, mask_kind, training, reps, storage) in enumerate(specs):
            case = (f"K5 dp={dp} mp={mp} B={b} V={v} mask={mask_kind} "
                    f"{'train' if training else 'eval'} {storage}")
            per_rank = [r[i] for r in res]

            def cuda(path, names):
                return [torch.from_numpy(programs.assemble(per_rank, dp, mp, n, path)).cuda()
                        for n in names.split(",")]

            kern = cuda("kernel", outputs)
            worst[storage] = max(worst[storage], compare(outputs, kern, full[i][0],
                                                         case + " vs full-V kernel"))
            compare(outputs, kern, cuda("plain", outputs), case + " vs plain")
            if "m" in per_rank[0]:
                compare("m,l", cuda(None, "m,l"), full[i][1], case + " merged softmax")
            for d in range(dp):
                for m in range(1, mp):
                    for name in ("rl", "g_theta"):
                        check(np.array_equal(per_rank[d * mp + m]["kernel"][name],
                                             per_rank[d * mp]["kernel"][name]),
                              f"{case}: {name} differs across model ranks")
            if reps:
                times[storage] = {"backend": backend, "per_rank": [r["ms"] for r in per_rank]}
            print(f"sharded op ok: {case}", flush=True)
    return worst, times, backend


def forced_phase(kw: dict, X, mp: int, split_losses: list) -> None:
    """(c) Teacher-forced steps: at steps 1, 4, 8 and 16 of the unsharded
    split-encoder fit, its state, that step's batch and its noise go through
    the mp ranks and an unsharded model. Prints each step's worst relative
    gradient error over the leaves (error over the leaf's max|grad|) and the
    cancelling leaves' error over the largest gradient; fails past 1e-3 and
    1e-5 of those. ``split_losses``: the split-encoder fit's step losses,
    which the trajectory's replay must repeat."""
    import numpy as np

    from gfedntm_tpu_torch import AVITM
    from gfedntm_tpu_torch.parallel import programs
    from gfedntm_tpu_torch.parallel.launch import gpu_layout, run_ranks

    witness = AVITM(**kw)
    split_input_layer(witness, mp)
    records, losses = programs.trajectory(witness, X, (0, 3, 7, 15))
    backend, devices = gpu_layout(mp)
    sharded = run_ranks(programs.forced_steps, mp, backend, devices, 600,
                        args=(1, mp, kw, shared(X), records))[0]
    parts = []
    for rec, (loss, grads) in zip(records, sharded):
        ref_loss, ref = programs.step_gradients(AVITM(**kw), X, state=rec["state"],
                                                step=rec["step"], noise=rec["noise"])
        scale = max(float(np.abs(g).max()) for g in ref.values())
        rel = {n: float(np.abs(grads[n] - g).max()) / float(np.abs(g).max())
               for n, g in ref.items() if n not in DEGENERATE}
        cancel = max(float(np.abs(grads[n] - ref[n]).max()) for n in DEGENERATE) / scale
        leaf = max(rel, key=rel.get)
        parts.append(f"step {rec['step'] + 1}: loss {abs(loss - ref_loss) / abs(ref_loss):.2e}, "
                     f"worst leaf {leaf} {rel[leaf]:.3e}, cancelling leaves {cancel:.2e}")
        check(rel[leaf] <= 1e-3, f"forced step {rec['step'] + 1}: {leaf} gradient differs by "
              f"{rel[leaf]:.3e} of its max|grad| (limit 1e-3)")
        check(cancel <= 1e-5, f"forced step {rec['step'] + 1}: {', '.join(DEGENERATE)} differ "
              f"by {cancel:.3e} of the largest gradient (limit 1e-5)")
    print(f"sharded vs unsharded, teacher-forced from the split-encoder fit's trajectory "
          f"(its replay's step losses equal its fit's: {losses == list(split_losses)[:16]}): "
          + "; ".join(parts), flush=True)


def sharded_fit_phase(card: str, rows: dict, notes: dict):
    """(a) through (d): the op checks, then ``fit_sharded`` at full width
    against an unsharded ``AVITM.fit``, its timing, and the ``vsharded``
    row of the kernels line. Returns the fit's corpus and its settings."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch import AVITM, BowDataset
    from gfedntm_tpu_torch.parallel import programs
    from gfedntm_tpu_torch.parallel.launch import gpu_layout, run_ranks

    worst, op_times, op_backend = sharded_op_phase()

    V, K, B, N, mp = 100_000, 50, 256, 2048, 2
    X = synthetic_bow(V, K, N, 0)
    kw = dict(input_size=V, n_components=K, hidden_sizes=(100, 100), batch_size=B,
              num_epochs=2, dropout=0.0, seed=0)
    backend, devices = gpu_layout(mp)
    t0 = time.perf_counter()
    res = run_ranks(programs.fit, mp, backend, devices, 900,
                    args=(1, mp, kw, shared(X), None, 1, 24))
    print(f"sharded fit: {backend}, dp=1 x mp={mp} on {devices}, {N} docs, V={V}, "
          f"ranks done in {time.perf_counter() - t0:.1f} s; launches per rank "
          f"{[r['launches'] for r in res]}; epoch losses {res[0]['epoch_losses']}", flush=True)
    for rank, r in enumerate(res):
        for name in ("stats", "loss", "grads", "vsharded"):
            check(r["launches"][name] == 16,
                  f"rank {rank}: {name} launched {r['launches'][name]} times, want 16")
        check(len(r["step_losses"]) == 16 and bool(np.isfinite(r["step_losses"]).all()),
              f"rank {rank}: step losses {r['step_losses']}")
    check_same_state(res, "sharded fit")
    topics = res[0]["topics"]
    check(len(topics) == K and all(len(t) == 10 for t in topics),
          "get_topics did not return 50 lists of 10")
    print(f"sharded fit: topic 0 {topics[0]}", flush=True)

    # The same first step and fit unsharded on the card: same seed, schedule
    # and noise.
    ref = AVITM(**kw)
    ref_loss, ref_grads = programs.step_gradients(AVITM(**kw), X)
    loss1, grads1 = res[0]["first_step"]
    scale = max(float(np.abs(g).max()) for g in ref_grads.values())
    worst_grad = 0.0
    for name, g_ref in ref_grads.items():
        err = float(np.abs(grads1[name] - g_ref).max())
        if name in DEGENERATE:  # zero in exact arithmetic: rounding noise
            bound = 1e-5 * scale
            check(float(np.abs(grads1[name]).max()) <= bound, f"first-step grad {name} "
                  f"{float(np.abs(grads1[name]).max()):.3e} > {bound:.3e}")
            continue
        tol = 1e-3 * float(np.abs(g_ref).max())
        check(err <= tol, f"first-step grad {name}: max |err| {err:.3e} > {tol:.3e}")
        worst_grad = max(worst_grad, err / float(np.abs(g_ref).max()))
    check(abs(loss1 - ref_loss) <= 1e-3 * abs(ref_loss),
          f"first-step loss {loss1} vs unsharded {ref_loss}")
    ref.fit(BowDataset(X=X), n_samples=1)
    # Witnesses without sharding, for beta after 16 Adam steps: the same
    # unsharded fit with the encoder input layer summed over its mp column
    # blocks (the reduction order sharding gives the encoder), and through
    # the unfused decode (other reduction orders in the decoder).
    split = AVITM(**kw)
    split_input_layer(split, mp)
    unfused = AVITM(**kw, fused_decoder=False)
    for model in (split, unfused):
        model.fit(BowDataset(X=X), n_samples=1)
    steps_ref = np.asarray(ref.step_losses)

    def step_err(losses):
        return float(np.max(np.abs(np.asarray(losses) - steps_ref) / np.abs(steps_ref)))

    def spread(beta, beta_ref):
        diff = np.abs(beta - beta_ref)
        return float(diff.max()), float((diff > beta_tol).mean())

    betas = {"plain": ref.model.beta.detach().cpu().numpy(), "sharded": res[0]["state"]["beta"],
             "split": split.model.beta.detach().cpu().numpy(),
             "unfused": unfused.model.beta.detach().cpu().numpy()}
    beta_tol = 1e-3 * float(np.abs(betas["plain"]).max())
    pairs = {(a, b): spread(betas[a], betas[b]) for a, b in (
        ("sharded", "plain"), ("split", "plain"), ("unfused", "plain"), ("sharded", "split"))}
    lr = ref.lr
    max_limit = max(4.0 * lr, 1.5 * pairs["split", "plain"][0])
    frac_limit = 1.5 * pairs["split", "plain"][1] + 1e-4
    print(f"sharded vs unsharded: first step: every gradient within 1e-3 * its max|grad| "
          f"(worst {worst_grad:.3e} relative), {', '.join(DEGENERATE)} within 1e-5 * "
          f"{scale:.3e}; fit: max relative step-loss error {step_err(res[0]['step_losses']):.3e} "
          f"(limit 1e-3); witnesses: split encoder {step_err(split.step_losses):.3e}, unfused "
          f"decode {step_err(unfused.step_losses):.3e}", flush=True)
    print(f"beta after 16 Adam steps (lr {lr:g}), max |diff| and fraction of entries beyond "
          f"1e-3 * max|beta| = {beta_tol:.3e}: " + "; ".join(
              f"{a} vs {b} {m:.3e} ({m / lr:.2f} lr), {f:.5f}" for (a, b), (m, f) in pairs.items())
          + f"; limits for sharded vs plain: max <= max(4 lr, 1.5 x split) = {max_limit:.3e}, "
          f"fraction <= 1.5 x split + 1e-4 = {frac_limit:.5f}; sharded vs split fraction <= "
          f"split vs plain", flush=True)
    check(step_err(res[0]["step_losses"]) <= 1e-3,
          f"step losses differ from the unsharded fit by {step_err(res[0]['step_losses']):.3e}")
    check(pairs["sharded", "plain"][0] <= max_limit,
          f"sharded beta max |diff| {pairs['sharded', 'plain'][0]:.3e} > {max_limit:.3e}")
    check(pairs["sharded", "plain"][1] <= frac_limit,
          f"sharded beta: {pairs['sharded', 'plain'][1]:.5f} of entries beyond {beta_tol:.3e}, "
          f"limit {frac_limit:.5f}")
    check(pairs["sharded", "split"][1] <= pairs["split", "plain"][1],
          f"sharded beta is further from the split-encoder fit ({pairs['sharded', 'split'][1]:.5f}"
          f") than that is from the plain fit ({pairs['split', 'plain'][1]:.5f})")

    forced_phase(kw, X, mp, split.step_losses)

    ms_step = max(r["step_ms"] for r in res)
    print(f"sharded fit ({backend}, {devices}): steady {ms_step:.3f} ms per step, "
          f"{B / ms_step * 1e3:.1f} docs/s (B={B}, mp={mp}; 24 warm steps of fit_sharded's "
          f"step between barriers, per rank {[round(r['step_ms'], 3) for r in res]} ms)",
          flush=True)

    # (f) bf16 compute: fit_sharded of a bf16 model for one epoch (8 steps)
    # against the unsharded bf16 fit, the launches read per rank.
    kw16 = {**kw, "num_epochs": 1, "compute_dtype": "bfloat16"}
    t0 = time.perf_counter()
    res16 = run_ranks(programs.fit, mp, backend, devices, 900,
                      args=(1, mp, kw16, shared(X), None, 1, 0))
    steps16 = N // B
    print(f"sharded fit bf16: {backend}, dp=1 x mp={mp}, ranks done in "
          f"{time.perf_counter() - t0:.1f} s; launches per rank "
          f"{[r['launches'] for r in res16]}; step losses {res16[0]['step_losses']}", flush=True)
    for rank, r in enumerate(res16):
        for name in ("stats", "loss", "grads", "vsharded"):
            check(r["launches"][name + "_bf16"] == steps16 and r["launches"][name] == 0,
                  f"bf16 rank {rank}: {name} launched {r['launches'][name + '_bf16']} times in "
                  f"bf16 (want {steps16}) and {r['launches'][name]} in float32 (want 0)")
        check(bool(np.isfinite(r["step_losses"]).all()), f"bf16 rank {rank}: non-finite loss")
    for key, val in res16[0]["state"].items():
        check(val.dtype in (np.float32, np.int64), f"bf16 sharded fit: {key} is {val.dtype}")
    check_same_state(res16, "bf16")
    ref16 = AVITM(**kw16)
    ref_loss16, ref_grads16 = programs.step_gradients(AVITM(**kw16), X)
    ref16.fit(BowDataset(X=X), n_samples=1)
    loss16, grads16 = res16[0]["first_step"]
    scale16 = max(float(np.abs(g).max()) for g in ref_grads16.values())
    # Each leaf's max |diff| over its own max|grad| (printed) and over the
    # largest gradient of any leaf (checked). In bf16, g_theta reaches the
    # encoder rounded to bf16, and K5 sums its per-rank float32 partials in
    # another order than the full-V K3, so now and then an entry rounds to
    # the neighbouring bf16 value; in a leaf whose gradient is a sum that
    # cancels over the batch, one such entry is about a percent of the
    # leaf's own max. The float32 phase above holds the same code's
    # conventions to 1e-3 of each leaf's own max.
    own, whole = {}, {}
    for name, g_ref in ref_grads16.items():
        diff = float(np.abs(grads16[name] - g_ref).max())
        own[name] = diff / float(np.abs(g_ref).max())
        whole[name] = diff / scale16
    leaf, leaf_all = max(own, key=own.get), max(whole, key=whole.get)
    steps_ref16 = np.asarray(ref16.step_losses)
    loss_err16 = float(np.max(np.abs(np.asarray(res16[0]["step_losses"]) - steps_ref16)
                              / np.abs(steps_ref16)))
    print(f"sharded vs unsharded bf16: first-step loss {abs(loss16 - ref_loss16) / abs(ref_loss16):.3e}"
          f" relative; worst first-step gradient leaf {leaf_all} {whole[leaf_all]:.3e} of the "
          f"largest gradient {scale16:.3e} (limit 1e-2); against each leaf's own max|grad| the "
          f"worst is {leaf} {own[leaf]:.3e}; max relative step-loss error over {steps16} steps "
          f"{loss_err16:.3e} (limit 1e-2)", flush=True)
    check(whole[leaf_all] <= 1e-2, f"bf16 first-step gradient {leaf_all} differs by "
          f"{whole[leaf_all]:.3e} of the largest gradient (limit 1e-2)")
    check(loss_err16 <= 1e-2, f"bf16 sharded step losses differ by {loss_err16:.3e}")

    # (e) The vsharded rows: rank 0's op times at mp=2; the bound is one
    # rank's K1-K3 on V/mp plus the bytes its collectives move.
    for storage, name, launches in (("float32", "vsharded", res[0]["launches"]["vsharded"]),
                                    ("bfloat16", "vsharded_bf16",
                                     res16[0]["launches"]["vsharded_bf16"])):
        nbytes, nflops, coll_bytes = vsharded_work(B, K, V, mp, storage)
        passes = vsharded_passes(storage)
        bound = kernel_bound(nbytes, nflops, card, passes)
        per_rank = op_times[storage]["per_rank"]
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "gfedntm_tpu_torch/ops/fused_decoder.py",
            "replaces": "gfedntm_tpu/ops/fused_decoder.py:824",
            "launches": launches, "max_abs_err": worst[storage],
            "ms": min(per_rank[0]["kernel"]), "plain_ms": min(per_rank[0]["plain"]),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": None,
        }
        notes[name] = (
            f"{storage} storage; per rank at B={B} K={K} V={V} mp={mp}, forward + backward, "
            f"backend {op_backend}; ms per rank {[r['kernel'] for r in per_rank]} plain_ms "
            f"{[r['plain'] for r in per_rank]}; bound {bound['bound_by']} "
            f"({bound['peaks']} peaks: {nbytes / 1e6:.1f} MB incl. {coll_bytes / 1e3:.1f} kB of "
            f"collectives -> {bound['bytes_ms']:.4f} ms, {nflops / 1e9:.2f} GFLOP as {passes:.3g} "
            f"TF32 products -> {bound['ops_ms']:.4f} ms); FP32 SIMT bound "
            f"{bound['simt_bound_ms']:.4f} ms; max |err| vs the full-V kernels, tol {ATOL:g} + "
            f"{RTOL:g}*max|plain|"
        )
    return X, kw


# ---------------------------------------------------------------------------
# Phase 5: validation, persistence and federated checkpoint/resume
# ---------------------------------------------------------------------------
#: Where phase 5 writes its checkpoints (inside the checkout; ``build/`` is
#: ignored by git). Emptied before and after the phase.
SCRATCH = Path(__file__).resolve().parent / "build" / "chip_smoke"


def eval_kernel_work(b, k, v, storage="float32") -> dict:
    """K1 and K2 in eval mode: (bytes, FLOPs) as :func:`kernel_work` counts
    them. K1's eval branch has no column-statistics pass: it reads the
    running mean and variance and writes them out as its statistics, and
    computes z = theta beta for the softmax only. K2 is the training kernel."""
    f4, fs = 4.0, 2.0 if storage == "bfloat16" else 4.0
    return {
        "stats": (f4 * (b * k + b + 4 * v + 2 * b) + fs * k * v, 2.0 * b * k * v),
        "loss": kernel_work(b, k, v, storage)["loss"],
    }


def saved_epochs(val_losses: list, patience: int, delta: float) -> list[int]:
    """The epochs at which ``EarlyStopping`` saves, for these losses."""
    from gfedntm_tpu_torch.train.early_stopping import EarlyStopping

    saved, epoch = [], [0]
    stopper = EarlyStopping(patience, delta, checkpoint_fn=lambda: saved.append(epoch[0]))
    for epoch[0], value in enumerate(val_losses):
        stopper(value)
        if stopper.early_stop:
            break
    return saved


def eval_kernel_rows(card: str, rows: dict, notes: dict) -> None:
    """K1 and K2 in eval mode at one rank's shard of the sharded validation
    (B=256, K=50, V=50,000) against their plain versions, with masked rows,
    no masked row and all rows masked, then timed: plain, kernel, kernel,
    plain. Adds the ``stats_eval`` and ``loss_eval`` rows (launches: the
    sharded validation's, set by the caller)."""
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    b, k, v = 256, 50, 50_000
    worst = {"stats": 0.0, "loss": 0.0}
    for i, mask_kind in enumerate(("partial", "none", "all")):
        t = make_inputs(b, k, v, seed=300 + i, mask_kind=mask_kind)
        case = f"eval B={b} K={k} V={v} mask={mask_kind}"
        st_args = (t["theta"], t["beta"], t["mask"], t["run_mean"], t["run_var"], False)
        ref = fd.stats_reference(*st_args)
        worst["stats"] = max(worst["stats"], compare("mean,var,m,s", fd.stats(*st_args), ref,
                                                     case))
        lo_args = (t["theta"], t["beta"], t["x"], *ref)
        worst["loss"] = max(worst["loss"], compare("loss,rd", fd.loss(*lo_args),
                                                   fd.loss_reference(*lo_args), case))
        print(f"eval kernels ok: {case}", flush=True)
    t = make_inputs(b, k, v, seed=300, mask_kind="partial")
    st_args = (t["theta"], t["beta"], t["mask"], t["run_mean"], t["run_var"], False)
    lo_args = (t["theta"], t["beta"], t["x"], *fd.stats_reference(*st_args))
    work = eval_kernel_work(b, k, v)
    for name, kernel_fn, plain_fn in (
            ("stats", lambda: fd.stats(*st_args), lambda: fd.stats_reference(*st_args)),
            ("loss", lambda: fd.loss(*lo_args), lambda: fd.loss_reference(*lo_args))):
        p1, k1, k2, p2 = (time_ms(fn) for fn in (plain_fn, kernel_fn, kernel_fn, plain_fn))
        nbytes, nflops = work[name]
        bound = kernel_bound(nbytes, nflops, card)
        rows[name + "_eval"] = {
            "name": name + "_eval", "route": "cuda",
            "source": "gfedntm_tpu_torch/ops/csrc/fused_decoder.cu",
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": worst[name],
            "ms": min(k1, k2), "plain_ms": min(p1, p2),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "library_ms": None,
        }
        notes[name + "_eval"] = (
            f"eval mode (the sharded validation's route, K5 training=False) at one rank's "
            f"shard B={b} K={k} V={v}; tol {ATOL:g} + {RTOL:g}*max|plain| per output; ms "
            f"{k1:.4f}/{k2:.4f} plain_ms {p1:.4f}/{p2:.4f}; bound {bound['bound_by']} "
            f"({bound['peaks']} peaks: {nbytes / 1e6:.1f} MB -> {bound['bytes_ms']:.4f} ms, "
            f"{nflops / 1e9:.2f} GFLOP as 3xTF32 -> {bound['ops_ms']:.4f} ms)")


def validation_fit_phase(datasets: list) -> None:
    """(a) ``AVITM.fit`` with validation and ``save_dir``; a fresh model's
    ``load`` of every saved epoch against the model as it was saved."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch import AVITM, BowDataset
    from gfedntm_tpu_torch.data.datasets import make_epoch_schedule
    from gfedntm_tpu_torch.train.steps import eval_epoch, grad_step, take

    V, K, B = 100_000, 50, 256
    kw = dict(input_size=V, n_components=K, hidden_sizes=(100, 100), batch_size=B,
              num_epochs=3)
    train = datasets[0]
    val = BowDataset(X=datasets[1].X[:256], idx2token=datasets[1].idx2token)
    save_dir = SCRATCH / "avitm"
    model = AVITM(**kw)
    snapshots = {}
    save = model.save

    def save_and_snapshot(models_dir):
        save(models_dir)
        snapshots[model.nn_epoch] = {k: v.detach().clone()
                                     for k, v in model.model.state_dict().items()}

    model.save = save_and_snapshot
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(train, val, save_dir=str(save_dir), n_samples=1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    losses = model.validation_losses
    want = saved_epochs(losses, 5, 0.0)
    files = sorted(p.name for p in save_dir.iterdir())
    print(f"validation fit: {len(train)} training and {len(val)} validation documents, "
          f"{len(model.epoch_losses)} epochs in {secs:.3f} s; train losses {model.epoch_losses}; "
          f"validation losses {losses}; saved epochs {want}: {files}", flush=True)
    check(len(losses) == len(model.epoch_losses) == 3 and bool(np.isfinite(losses).all()),
          f"validation losses {losses}")
    check(files == sorted(f"epoch_{e}.{x}" for e in want for x in ("json", "npz")),
          f"saved files {files}, want epochs {want}")
    check(sorted(snapshots) == want, f"saves at epochs {sorted(snapshots)}, want {want}")

    rng = np.random.default_rng(0)
    x_val = model._device_data(val)
    vsched = make_epoch_schedule(len(val), B, rng)
    vidx = torch.as_tensor(vsched.indices, device=model.device, dtype=torch.long)
    vmask = torch.as_tensor(vsched.mask, device=model.device, dtype=torch.float32)
    noise = torch.as_tensor(rng.normal(size=(len(vidx), B, K)).astype(np.float32),
                            device=model.device)
    for epoch, state in snapshots.items():
        fresh, saved = AVITM(**kw), AVITM(**kw)
        fresh.load(str(save_dir), epoch)
        saved.model.load_state_dict(state)
        for key, value in state.items():
            check(torch.equal(fresh.model.state_dict()[key], value),
                  f"load(epoch {epoch}): {key} differs from the saved state")
        check(np.array_equal(fresh.get_topic_word_matrix(), saved.get_topic_word_matrix()),
              f"load(epoch {epoch}): topic-word matrix differs")
        losses_fresh, losses_saved = (eval_epoch(m.model, x_val, vidx, vmask, noise=noise)
                                      for m in (fresh, saved))
        check(torch.equal(losses_fresh, losses_saved),
              f"load(epoch {epoch}): eval loss {losses_fresh} != {losses_saved}")
    print(f"validation fit: load of epochs {sorted(snapshots)} bitwise equal to the saved "
          f"state, topic-word matrix and eval loss with injected noise "
          f"({float(losses_saved.sum()):.6f})", flush=True)

    x_train = model._device_data(train)
    sched = make_epoch_schedule(len(train), B, rng)
    idx = torch.as_tensor(sched.indices, device=model.device, dtype=torch.long)
    mask = torch.as_tensor(sched.mask, device=model.device, dtype=torch.float32)

    def train_epoch():
        for i in range(len(idx)):
            grad_step(model.model, model.optimizer, take(x_train, idx[i]), mask[i], True,
                      generator=model.generator)

    train_ms = time_ms(train_epoch, reps=5, warmup=1)
    val_ms = time_ms(lambda: eval_epoch(model.model, x_val, vidx, vmask,
                                        generator=model.generator), reps=5, warmup=1)
    print(f"validation fit: validation epoch ({len(vidx)} step of B={B}, unfused eval decode) "
          f"{val_ms:.3f} ms; training epoch ({len(idx)} steps) {train_ms:.3f} ms "
          f"({train_ms / len(idx):.3f} ms per step)", flush=True)


def resume_phase(datasets: list, result) -> None:
    """(b) federated checkpoint/resume, bitwise, in float32 and bf16, with
    the checkpoint's size and write/restore times; (c) the metrics run."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch import AVITM, FederatedTrainer
    from gfedntm_tpu_torch.train import checkpoint as ckpt
    from gfedntm_tpu_torch.utils.observability import MetricsLogger

    V, K, B, C = 100_000, 50, 256, 2

    def trainer(dtype):
        return FederatedTrainer(AVITM(input_size=V, n_components=K, hidden_sizes=(100, 100),
                                      batch_size=B, num_epochs=2, compute_dtype=dtype),
                                n_clients=C)

    def same_run(a, b) -> list[str]:
        bad = [] if np.array_equal(a.losses, b.losses) else ["losses"]
        for c in range(C):
            for tree in ("client_params", "client_batch_stats"):
                bad += [f"client {c} {k}" for k, v in getattr(b, tree)[c].items()
                        if not torch.equal(getattr(a, tree)[c][k], v)]
        return bad

    class Interrupt(Exception):
        pass

    def interrupt_at_8(step, params, batch_stats):
        if step == 8:
            raise Interrupt

    times = {"save": [], "restore": []}
    originals = {name: getattr(ckpt.CheckpointManager, name) for name in times}

    def timed(name):
        def run(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = originals[name](self, *args, **kwargs)
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    for dtype in ("float32", "bfloat16"):
        root = SCRATCH / f"federated_{dtype}"
        logger = MetricsLogger(validate=True) if dtype == "float32" else None
        full = trainer(dtype).fit(datasets, checkpoint_dir=str(root / "full"),
                                  checkpoint_every=4, metrics=logger)
        if dtype == "float32":
            diff = same_run(full, result)
            check(not diff, f"the checkpointed run with metrics differs from the main path's "
                  f"plain run in {diff[:5]}")
        for name in times:
            setattr(ckpt.CheckpointManager, name, timed(name))
            times[name].clear()
        try:
            try:
                trainer(dtype).fit(datasets, checkpoint_dir=str(root / "run"),
                                   checkpoint_every=4, segment_callback=interrupt_at_8)
                check(False, "the segment callback did not interrupt the run")
            except Interrupt:
                pass
            manager = ckpt.CheckpointManager(str(root / "run"))
            check(manager.all_steps() == [4], f"checkpoints {manager.all_steps()}, want [4]")
            size = (root / "run" / "step_4.pt").stat().st_size
            resumed = trainer(dtype).fit(datasets, checkpoint_dir=str(root / "run"),
                                         checkpoint_every=4, resume=True)
        finally:
            for name, original in originals.items():
                setattr(ckpt.CheckpointManager, name, original)
        diff = same_run(resumed, full)
        print(f"federated resume {dtype}: interrupted by the segment callback at step 8, "
              f"resumed from step 4 in a fresh trainer; losses and every client's state "
              f"bitwise equal to the uninterrupted run: {not diff} {diff[:5]}; checkpoint "
              f"{size / 1e6:.1f} MB ({C} clients' networks and Adam state), write ms "
              f"{[round(t, 1) for t in times['save']]}, restore ms "
              f"{[round(t, 1) for t in times['restore']]}", flush=True)
        check(not diff, f"{dtype}: the resumed run differs from the uninterrupted one in "
              f"{diff[:5]}")
        if logger is not None:
            print(metrics_report(logger), flush=True)


def metrics_report(logger) -> str:
    """(c) The line on a two-segment federated run's metrics: every record
    valid, two ``federated_segment`` records, one step-time observation (the
    first segment holds the warm-up) and a positive ``docs_per_s``; fails
    otherwise."""
    from gfedntm_tpu_torch.utils.observability import validate_record

    for record in logger.records:
        validate_record(record)
    events = [r["event"] for r in logger.records]
    snap = logger.registry.snapshot()
    hist = snap.get("trainer_step_s", {"count": 0, "sum": 0.0})
    docs = snap.get("docs_per_s", {}).get("value")
    check(events.count("federated_segment") == 2 and hist["count"] == 1 and bool(docs),
          f"metrics records {events}, registry {sorted(snap)}")
    return (f"metrics: {len(events)} records, all valid ({', '.join(sorted(set(events)))}); "
            f"docs_per_s {docs:.1f} over the second segment (the first holds the warm-up); "
            f"trainer_step_s {hist['count']} observation, {hist['sum'] * 1e3:.3f} ms per step; "
            f"federated_mesh_devices {snap['federated_mesh_devices']['value']:g}")


def sharded_validation_phase(X, kw: dict) -> dict:
    """(d) ``fit_sharded`` with validation at dp=1 x mp=2 in spawned ranks:
    per-rank launch counts (eval-mode K1 and K2 through K5, K3 untouched by
    the validation), each validation against the unsharded eval
    teacher-forced from the same state, generator state and schedule, the
    same early-stopping decisions on both ranks, and rank 0's checkpoints
    against the gathered state. Returns rank 0's eval-mode launches."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch import AVITM
    from gfedntm_tpu_torch.parallel import programs
    from gfedntm_tpu_torch.parallel.launch import gpu_layout, run_ranks

    V, K, B, mp = kw["input_size"], kw["n_components"], kw["batch_size"], 2
    Xv = synthetic_bow(V, K, 256, 1)
    save_dir = SCRATCH / "sharded"
    backend, devices = gpu_layout(mp)
    t0 = time.perf_counter()
    res = run_ranks(programs.fit, mp, backend, devices, 900,
                    args=(1, mp, kw, shared(X), None, 1, 0, shared(Xv), str(save_dir), 5,
                          0.0))
    n_epochs = res[0]["last_epoch"] + 1
    n_train, n_val = len(X) // B * n_epochs, len(Xv) // B * n_epochs
    print(f"sharded validation: {backend}, dp=1 x mp={mp}, {len(X)} + {len(Xv)} docs, ranks "
          f"done in {time.perf_counter() - t0:.1f} s; launches per rank "
          f"{[r['launches'] for r in res]}; eval-mode {[r['eval_launches'] for r in res]}; "
          f"validation losses {res[0]['validation_losses']}", flush=True)
    for rank, r in enumerate(res):
        got, ev = r["launches"], r["eval_launches"]
        check(got["grads"] == n_train, f"rank {rank}: K3 launched {got['grads']} times, want "
              f"{n_train} (the training steps alone)")
        for name in ("stats", "loss", "vsharded"):
            check(got[name] == n_train + n_val, f"rank {rank}: {name} launched {got[name]} "
                  f"times, want {n_train} training + {n_val} validation")
        check(ev["stats"] == ev["vsharded"] == n_val,
              f"rank {rank}: eval-mode launches {ev}, want {n_val} of K1 and of K5")
        check(r["validation_losses"] == res[0]["validation_losses"]
              and r["last_epoch"] == res[0]["last_epoch"],
              f"rank {rank} decided otherwise than rank 0")
        check(bool(np.isfinite(r["validation_losses"]).all()), "non-finite validation loss")
    errs = []
    for record in res[0]["validations"]:
        replay = programs.replay_validation(AVITM(**kw), Xv, record)
        errs.append(abs(replay - record["val_loss"]) / abs(replay))
    want = saved_epochs(res[0]["validation_losses"], 5, 0.0)
    files = sorted(p.name for p in save_dir.iterdir())
    check(files == sorted(f"epoch_{e}.{x}" for e in want for x in ("json", "npz")),
          f"rank 0 saved {files}, want epochs {want}")
    for epoch in want:
        model = AVITM(**kw)
        model.load(str(save_dir), epoch)
        gathered = res[0]["validations"][epoch]["state"]
        for key, value in model.model.state_dict().items():
            check(np.array_equal(value.cpu().numpy(), gathered[key]),
                  f"rank 0's epoch_{epoch}.npz: {key} differs from the gathered state")
    print(f"sharded validation: K5 eval vs the unsharded unfused eval teacher-forced from the "
          f"same state and noise, relative error per epoch {[f'{e:.2e}' for e in errs]} "
          f"(limit 1e-4); both ranks stopped after epoch {res[0]['last_epoch']}; rank 0 saved "
          f"epochs {want}, each loading into an unsharded AVITM equal to the gathered state",
          flush=True)
    check(max(errs) <= 1e-4, f"sharded validation loss differs by {max(errs):.3e}")
    return res[0]["eval_launches"]


def persistence_phase(card: str, rows: dict, notes: dict, datasets: list, result, X,
                      kw: dict) -> None:
    """Phase 5, (a) to (d), and the eval-mode rows of the kernels line."""
    shutil.rmtree(SCRATCH, ignore_errors=True)
    try:
        validation_fit_phase(datasets)
        resume_phase(datasets, result)
        eval_launches = sharded_validation_phase(X, kw)
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    eval_kernel_rows(card, rows, notes)
    rows["stats_eval"]["launches"] = eval_launches["stats"]
    rows["loss_eval"]["launches"] = eval_launches["vsharded"]  # one K2 per eval K5 forward
    notes["vsharded"] += (f"; phase 5's sharded validation: {eval_launches['vsharded']} "
                          f"eval-mode forwards per rank")


# ---------------------------------------------------------------------------
# Phase 6: data-parallel training in spawned ranks
# ---------------------------------------------------------------------------
def beta_spread(beta, beta_ref, tol: float) -> tuple[float, float]:
    """Max |beta - beta_ref| and the fraction of entries beyond ``tol``."""
    import numpy as np

    diff = np.abs(beta - beta_ref)
    return float(diff.max()), float((diff > tol).mean())


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def first_step_errors(first, ref) -> tuple[float, float, float]:
    """(relative loss error, worst gradient error over its leaf's max|grad|,
    worst cancelling-leaf error over the largest gradient) of a sharded
    first step against the unsharded one."""
    import numpy as np

    (loss, grads), (ref_loss, ref_grads) = first, ref
    scale = max(float(np.abs(g).max()) for g in ref_grads.values())
    rel = [float(np.abs(grads[n] - g).max()) / float(np.abs(g).max())
           for n, g in ref_grads.items() if n not in DEGENERATE]
    cancel = [float(np.abs(grads[n] - ref_grads[n]).max()) / scale for n in DEGENERATE]
    return abs(loss - ref_loss) / abs(ref_loss), max(rel), max(cancel)


def step_line(card: str, label: str, ranks: list, backend: str, devices: list, steps: int) -> str:
    return (f"data parallel steady step, {card}: {label} ({backend} on {devices}): "
            f"{[round(r['step_ms'], 3) for r in ranks]} ms per step per rank ({steps} warm "
            f"steps between barriers, batch gather included); bytes per step through each data "
            f"group's all_reduce: batch gather {ranks[0]['step_bytes']['batch_gather'] / 1e6:.1f}"
            f" MB, gradient sum {ranks[0]['step_bytes']['gradient_sum'] / 1e6:.1f} MB")


def data_parallel_phase(card: str, notes: dict) -> dict:
    """Phase 6: (a) ``fit_sharded`` at dp=2 x mp=2 with validation and (b)
    ``fit_data_sharded`` at dp=2, each against the unsharded fit on the
    card, with per-rank launch counts, steady ms per step and the bytes its
    data-group collectives move per step. Returns rank 0's result of (a)."""
    import numpy as np

    from gfedntm_tpu_torch import AVITM, BowDataset
    from gfedntm_tpu_torch.parallel import programs
    from gfedntm_tpu_torch.parallel.launch import gpu_layout, run_ranks

    t_phase = time.perf_counter()
    V, K, B, N, dp, mp, steps = 100_000, 50, 256, 2048, 2, 2, 8
    X, Xv = synthetic_bow(V, K, N, 0), synthetic_bow(V, K, 256, 1)
    kw = dict(input_size=V, n_components=K, hidden_sizes=(100, 100), batch_size=B,
              num_epochs=1, dropout=0.2, seed=0)
    kwu = {**kw, "fused_decoder": False}

    # (a) fit_sharded at dp x mp, one epoch and its validation.
    backend, devices = gpu_layout(dp * mp)
    t0 = time.perf_counter()
    res = run_ranks(programs.fit, dp * mp, backend, devices, 900,
                    args=(dp, mp, kw, shared(X), None, 1, steps, shared(Xv), None, 5, 0.0))
    n_val = len(Xv) // B
    print(f"data parallel (a): fit_sharded {backend}, dp={dp} x mp={mp} on {devices}, {N} + "
          f"{len(Xv)} docs, V={V}, dropout {kw['dropout']}, ranks done in "
          f"{time.perf_counter() - t0:.1f} s; per rank, launches "
          f"{[nonzero(r['launches']) for r in res]}, eval-mode of them "
          f"{[nonzero(r['eval_launches']) for r in res]}, rows-sharded K5 calls "
          f"{[r['rows_calls']['vsharded_rows'] for r in res]}; step losses "
          f"{res[0]['step_losses']}", flush=True)
    print(step_line(card, f"fit_sharded dp={dp} x mp={mp}", res, backend, devices, steps),
          flush=True)
    for rank, r in enumerate(res):
        got, ev = r["launches"], r["eval_launches"]
        check(got["grads"] == 0, f"rank {rank}: K3 launched {got['grads']} times in dp > 1 "
              f"training, want 0 (K5's rows-sharded branch)")
        for name in ("stats", "loss", "vsharded"):
            check(got[name] == n_val, f"rank {rank}: {name} launched {got[name]} times, want "
                  f"{n_val} (the validation's eval forward)")
        check(ev["stats"] == ev["vsharded"] == n_val, f"rank {rank}: eval-mode launches {ev}")
        check(r["rows_calls"]["vsharded_rows"] == steps,
              f"rank {rank}: {r['rows_calls']} rows-sharded calls, want {steps}")
        check(len(r["step_losses"]) == steps and bool(np.isfinite(r["step_losses"]).all()),
              f"rank {rank}: step losses {r['step_losses']}")
        check(r["validation_losses"] == res[0]["validation_losses"],
              f"rank {rank}: validation losses differ from rank 0's")
    check_same_state(res, f"dp={dp} x mp={mp}")

    # The unsharded fits on the card, fused and unfused: the same seed,
    # schedule and draws. Their beta spread is what reduction order alone
    # gives after Adam (the witness for both parts).
    ref, unfused = AVITM(**kw), AVITM(**kwu)
    for model in (ref, unfused):
        model.fit(BowDataset(X=X), n_samples=1)
    beta_ref, beta_unfused = (m.model.beta.detach().cpu().numpy() for m in (ref, unfused))
    tol = 1e-3 * float(np.abs(beta_ref).max())
    witness = beta_spread(beta_unfused, beta_ref, tol)
    witness_1e4 = beta_spread(beta_unfused, beta_ref, 1e-4)[1]
    max_limit = max(4.0 * ref.lr, 1.5 * witness[0])

    def step_err(losses, model):
        want = np.asarray(model.step_losses)
        return float(np.max(np.abs(np.asarray(losses) - want) / np.abs(want)))

    loss_a, grad_a, cancel_a = first_step_errors(res[0]["first_step"],
                                                 programs.step_gradients(AVITM(**kw), X))
    steps_a = step_err(res[0]["step_losses"], ref)
    sharded = beta_spread(res[0]["state"]["beta"], beta_ref, tol)
    frac_limit = 1.5 * witness[1] + 1e-4
    errs = [abs(programs.replay_validation(AVITM(**kw), Xv, rec) - rec["val_loss"])
            / abs(rec["val_loss"]) for rec in res[0]["validations"]]
    print(f"data parallel (a) vs the unsharded fused fit: first-step loss {loss_a:.3e} "
          f"relative, gradients within {grad_a:.3e} of each leaf's max|grad| (limit 1e-3), "
          f"{', '.join(DEGENERATE)} within {cancel_a:.3e} of the largest (limit 1e-5); step "
          f"losses {steps_a:.3e} (limit 1e-3); beta max |diff| {sharded[0]:.3e}, "
          f"{sharded[1]:.6f} of entries beyond {tol:.3e}; the unfused witness {witness[0]:.3e}, "
          f"{witness[1]:.6f} (limits {max_limit:.3e}, {frac_limit:.6f}); validation vs the "
          f"teacher-forced unsharded eval {[f'{e:.2e}' for e in errs]} (limit 1e-4)", flush=True)
    check(loss_a <= 1e-3 and grad_a <= 1e-3 and cancel_a <= 1e-5,
          f"first step: loss {loss_a:.3e}, gradients {grad_a:.3e}, cancelling {cancel_a:.3e}")
    check(steps_a <= 1e-3, f"step losses differ from the unsharded fit by {steps_a:.3e}")
    check(sharded[0] <= max_limit, f"beta max |diff| {sharded[0]:.3e} > {max_limit:.3e}")
    check(sharded[1] <= frac_limit, f"beta: {sharded[1]:.6f} of entries beyond {tol:.3e}")
    check(max(errs) <= 1e-4, f"validation loss differs by {max(errs):.3e}")

    # (b) fit_data_sharded at dp, unfused, one epoch.
    backend_b, devices_b = gpu_layout(dp)
    t0 = time.perf_counter()
    resd = run_ranks(programs.fit_data, dp, backend_b, devices_b, 900,
                     args=(dp, kwu, shared(X), None, 1, None, None, 5, 0.0, steps))
    print(f"data parallel (b): fit_data_sharded {backend_b}, dp={dp} on {devices_b}, ranks done "
          f"in {time.perf_counter() - t0:.1f} s; summary {resd[0]['summary']}", flush=True)
    print(step_line(card, f"fit_data_sharded dp={dp}", resd, backend_b, devices_b, steps),
          flush=True)
    for rank, r in enumerate(resd):
        for key, val in r["state"].items():
            check(np.array_equal(val, resd[0]["state"][key]),
                  f"fit_data_sharded: {key} differs between rank 0 and rank {rank}")
    loss_b, grad_b, cancel_b = first_step_errors(resd[0]["first_step"],
                                                 programs.step_gradients(AVITM(**kwu), X))
    steps_b = step_err(resd[0]["step_losses"], unfused)
    data_b = beta_spread(resd[0]["state"]["beta"], beta_unfused, 1e-4)
    frac_b = 1.5 * witness_1e4 + 1e-4
    # beta within 1e-4 of the unsharded unfused fit, but for the entries
    # that reduction order alone moves by up to a few lr after Adam: no more
    # of them than the witness has beyond 1e-4 (times 1.5), and none
    # further than the witness's largest (times 1.5, or 4 lr).
    print(f"data parallel (b) vs the unsharded unfused fit: first-step loss {loss_b:.3e} "
          f"relative, gradients within {grad_b:.3e} of each leaf's max|grad| (limit 1e-3), "
          f"{', '.join(DEGENERATE)} within {cancel_b:.3e} (limit 1e-5); step losses "
          f"{steps_b:.3e} relative (limit 1e-4); beta max |diff| {data_b[0]:.3e}, "
          f"{data_b[1]:.6f} of entries beyond 1e-4; the witness (fused vs unfused unsharded) "
          f"{witness[0]:.3e}, {witness_1e4:.6f} beyond 1e-4 (limits {max_limit:.3e}, "
          f"{frac_b:.6f})", flush=True)
    check(loss_b <= 1e-3 and grad_b <= 1e-3 and cancel_b <= 1e-5,
          f"fit_data_sharded first step: loss {loss_b:.3e}, gradients {grad_b:.3e}, "
          f"cancelling {cancel_b:.3e}")
    check(steps_b <= 1e-4, f"fit_data_sharded step losses differ by {steps_b:.3e}")
    check(data_b[0] <= max_limit, f"fit_data_sharded beta max |diff| {data_b[0]:.3e}")
    check(data_b[1] <= frac_b, f"fit_data_sharded beta: {data_b[1]:.6f} of entries beyond "
          f"1e-4, limit {frac_b:.6f}")

    seconds = time.perf_counter() - t_phase
    print(f"data parallel: phase 6 took {seconds:.1f} s ({card})", flush=True)
    notes["vsharded"] += (f"; phase 6 (dp={dp} x mp={mp}): {res[0]['rows_calls']['vsharded_rows']}"
                          f" rows-sharded training calls (plain tensor ops, no kernel) and "
                          f"{res[0]['eval_launches']['vsharded']} eval-mode forward(s) per rank")
    return res[0]


# ---------------------------------------------------------------------------
# Phase 7: the unfused and LDA decodes at mp > 1; the raw-text flow
# ---------------------------------------------------------------------------
DECODE_CASES = (("prodLDA", 1, 2), ("LDA", 1, 2), ("LDA", 2, 2))


def sharded_decodes_phase(card: str) -> None:
    """Phase 7(a): ``fit_sharded`` of the unfused prodLDA and the LDA decodes
    at mp > 1 (:data:`DECODE_CASES`), each against the unsharded unfused fit
    of its model type on the card."""
    import numpy as np

    from gfedntm_tpu_torch import AVITM, BowDataset
    from gfedntm_tpu_torch.parallel import programs
    from gfedntm_tpu_torch.parallel.launch import gpu_layout, run_ranks

    V, K, B, N, steps = 100_000, 50, 256, 2048, 8
    X, Xv = synthetic_bow(V, K, N, 0), synthetic_bow(V, K, 256, 1)
    base = dict(input_size=V, n_components=K, hidden_sizes=(100, 100), batch_size=B,
                num_epochs=1, dropout=0.0, seed=0, fused_decoder=False)
    layouts = {}
    for model_type, dp, mp in DECODE_CASES:
        layouts.setdefault((dp, mp), []).append(model_type)
    results = {}
    for (dp, mp), model_types in layouts.items():
        backend, devices = gpu_layout(dp * mp)
        t0, launched = time.perf_counter(), time.time()
        runs = [({**base, "model_type": mt}, shared(X), None, 1, steps, shared(Xv), None, 5,
                 0.0) for mt in model_types]
        ranks = run_ranks(programs.fit_each, dp * mp, backend, devices, 900,
                          args=(dp, mp, runs))
        # Where a rank group's seconds go: from the launch to the last rank
        # entering its program (the corpus file written, spawn, imports),
        # then rank 0's fits, then from the last rank leaving its program to
        # the results in hand (the results sent back, the processes ended).
        print(f"sharded decodes: {', '.join(model_types)} at dp={dp} x mp={mp}, {backend} on "
              f"{devices}, ranks done in {time.perf_counter() - t0:.1f} s: start-up "
              f"{max(r[0]['entered_at'] for r in ranks) - launched:.1f} s, then rank 0's "
              + "; ".join(f"{mt} " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                                r["seconds"].items())
                          for mt, r in zip(model_types, ranks[0]))
              + f"; teardown {time.time() - max(r[-1]['left_at'] for r in ranks):.1f} s",
              flush=True)
        for i, mt in enumerate(model_types):
            results[mt, dp, mp] = ([r[i] for r in ranks], backend, devices)

    for model_type in dict.fromkeys(mt for mt, _, _ in DECODE_CASES):
        t0 = time.perf_counter()
        kw = {**base, "model_type": model_type}
        # The unsharded fit on the card, and a witness of what reduction
        # order alone does to beta after Adam: the same fit with the encoder
        # input layer summed over its two column blocks.
        ref, split = AVITM(**kw), AVITM(**kw)
        split_input_layer(split, 2)
        for model in (ref, split):
            model.fit(BowDataset(X=X), n_samples=1)
        ref_step = programs.step_gradients(AVITM(**kw), X)
        split_step = AVITM(**kw)
        split_input_layer(split_step, 2)
        # The cancelling leaves are rounding noise on both sides: held to
        # 1e-5 of the largest gradient, or to twice the witness's own noise.
        cancel_limit = max(1e-5, 2.0 * first_step_errors(
            programs.step_gradients(split_step, X), ref_step)[2])
        beta_ref = ref.model.beta.detach().cpu().numpy()
        witness = beta_spread(split.model.beta.detach().cpu().numpy(), beta_ref, 1e-4)
        max_limit = max(4.0 * ref.lr, 1.5 * witness[0])
        frac_limit = 1.5 * witness[1] + 1e-4
        want = np.asarray(ref.step_losses)
        print(f"sharded decodes: the unsharded {model_type} fit, its split-encoder witness "
              f"and their first steps took {time.perf_counter() - t0:.1f} s", flush=True)
        for (mt, dp, mp), (res, backend, devices) in results.items():
            if mt != model_type:
                continue
            label = f"{mt} dp={dp} x mp={mp}"
            r0 = res[0]
            loss_e, grad_e, cancel_e = first_step_errors(r0["first_step"], ref_step)
            steps_e = float(np.max(np.abs(np.asarray(r0["step_losses"]) - want) / np.abs(want)))
            beta = beta_spread(r0["state"]["beta"], beta_ref, 1e-4)
            val_e = [abs(programs.replay_validation(AVITM(**kw), Xv, rec) - rec["val_loss"])
                     / abs(rec["val_loss"]) for rec in r0["validations"]]
            launches = [{**r["launches"], **{f"eval_{k}": v for k, v in
                                             r["eval_launches"].items()},
                         **r["rows_calls"]} for r in res]
            print(f"sharded decodes, {label}: launches per rank (K1 stats, K2 loss, K3 grads, "
                  f"K5 vsharded, their bf16 and eval counts, K5 rows-sharded calls) "
                  f"{[nonzero(c) or 'all 0' for c in launches]}; step losses "
                  f"{r0['step_losses']}; validation {r0['validation_losses']}", flush=True)
            print(f"sharded decodes, {label} vs the unsharded {mt} fit: first-step loss "
                  f"{loss_e:.3e} relative, gradients within {grad_e:.3e} of each leaf's "
                  f"max|grad| (limit 1e-3), {', '.join(DEGENERATE)} within {cancel_e:.3e} of the "
                  f"largest (limit {cancel_limit:.3e}: 1e-5 or twice the split-encoder witness's "
                  f"first step); step losses {steps_e:.3e} (limit 1e-4); beta max "
                  f"|diff| {beta[0]:.3e}, {beta[1]:.6f} of entries beyond 1e-4; the "
                  f"split-encoder witness {witness[0]:.3e}, {witness[1]:.6f} (limits "
                  f"{max_limit:.3e}, {frac_limit:.6f}); validation vs the teacher-forced "
                  f"unsharded eval {[f'{e:.2e}' for e in val_e]} (limit 1e-4)", flush=True)
            print(f"sharded decodes steady step, {card}: {label} ({backend} on {devices}): "
                  f"{[round(r['step_ms'], 3) for r in res]} ms per step per rank ({steps} warm "
                  f"steps between barriers)", flush=True)
            for rank, (r, counts) in enumerate(zip(res, launches)):
                check(set(counts.values()) == {0},
                      f"{label}: rank {rank} launched or called a kernel: {nonzero(counts)}")
                check(len(r["step_losses"]) == steps
                      and bool(np.isfinite(r["step_losses"]).all())
                      and bool(np.isfinite(r["validation_losses"]).all()),
                      f"{label}: rank {rank} step losses {r['step_losses']}, validation "
                      f"{r['validation_losses']}")
                check(r["validation_losses"] == r0["validation_losses"],
                      f"{label}: rank {rank}'s validation losses differ from rank 0's")
            check_same_state(res, label)
            check(loss_e <= 1e-3 and grad_e <= 1e-3 and cancel_e <= cancel_limit,
                  f"{label} first step: loss {loss_e:.3e}, gradients {grad_e:.3e}, "
                  f"cancelling {cancel_e:.3e}")
            check(steps_e <= 1e-4, f"{label}: step losses differ by {steps_e:.3e}")
            check(beta[0] <= max_limit, f"{label}: beta max |diff| {beta[0]:.3e}")
            check(beta[1] <= frac_limit, f"{label}: beta: {beta[1]:.6f} of entries beyond "
                  f"1e-4, limit {frac_limit:.6f}")
            check(len(val_e) == 1 and max(val_e) <= 1e-4,
                  f"{label}: validation differs from the teacher-forced eval by {val_e}")


def raw_text_corpora(card: str):
    """Phase 7(b)'s clients from raw text: ``generate_synthetic_corpus``'s
    token-string documents as ``RawCorpus`` clients, through
    ``run_vocab_consensus`` (checked: V = 66,001, each client's BoW the
    synthetic BoW's columns, ``vectorize`` equal). Returns ``(clients,
    consensus)``."""
    import numpy as np

    from gfedntm_tpu_torch import (
        RawCorpus,
        generate_synthetic_corpus,
        native,
        run_vocab_consensus,
    )
    from gfedntm_tpu_torch.data.vocab import vectorize

    V_FULL, K, C = 100_000, 50, 2
    t0 = time.perf_counter()
    corpus = generate_synthetic_corpus(vocab_size=V_FULL, n_topics=K, n_docs=1024, n_nodes=C,
                                       materialize_docs=True, seed=0)
    clients = [RawCorpus(documents=node.documents) for node in corpus.nodes]
    n_tokens = sum(len(d.split()) for c in clients for d in c.documents)
    print(f"raw text: {C} clients x {len(clients[0])} documents, {n_tokens} tokens, made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    check(native.available(), "the native BoW library did not build")
    t0 = time.perf_counter()
    consensus = run_vocab_consensus(clients, max_features=None)
    consensus_s = time.perf_counter() - t0
    vocab = consensus.global_vocab
    V = len(vocab)
    t0 = time.perf_counter()
    again = [vectorize(c.documents, vocab) for c in clients]
    vectorize_s = time.perf_counter() - t0
    cols = np.array([int(t[2:]) for t in vocab.tokens])
    print(f"raw text, {card}: run_vocab_consensus(max_features=None) {consensus_s:.3f} s "
          f"(local vocabularies {[len(v) for v in consensus.local_vocabs]}, global V={V}); "
          f"vectorizing both clients against the global vocabulary {vectorize_s:.3f} s",
          flush=True)
    check(V == 66_001, f"global vocabulary of {V} words, want 66,001")
    for c, (node, ds) in enumerate(zip(corpus.nodes, consensus.datasets)):
        check(np.array_equal(ds.X, node.bow[:, cols]),
              f"client {c}: BoW differs from the synthetic BoW's columns")
        check(np.array_equal(again[c], ds.X), f"client {c}: vectorize differs from consensus")
    return clients, consensus


def raw_text_phase(card: str, notes: dict):
    """Phase 7(b): the user flow from raw text through the port: vocabulary
    consensus with the native BoW library, the federated fit through
    K1-K3, the global model's topics and their metrics. Returns
    :func:`raw_text_corpora`'s clients and consensus."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch import AVITM, FederatedTrainer, npmi_coherence, topic_diversity
    from gfedntm_tpu_torch.ops import _build
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    K, B, C = 50, 256, 2
    clients, consensus = raw_text_corpora(card)
    V = len(consensus.global_vocab)

    def run(num_epochs):
        template = AVITM(input_size=V, n_components=K, hidden_sizes=(100, 100), batch_size=B,
                         num_epochs=num_epochs)
        trainer = FederatedTrainer(template, n_clients=C)
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = trainer.fit(consensus.datasets)
        torch.cuda.synchronize()
        return trainer, result, time.perf_counter() - start

    # K1-K3 on this flow's own shapes and data against their plain versions
    # (V % 4 = 1: the 4-byte cp.async ring): the first client's first B
    # documents, theta from an initial model's encoder on them, its beta and
    # BatchNorm statistics. Phase 2 holds the same shape on random inputs.
    net = AVITM(input_size=V, n_components=K, hidden_sizes=(100, 100), batch_size=B)
    x = torch.as_tensor(consensus.datasets[0].X[:B], device="cuda")
    mask = torch.ones(B, device="cuda")
    with torch.no_grad():
        theta = net.model.encode_theta(x, mask=mask, generator=net.generator).theta
    bn = net.model.beta_batchnorm
    case = f"the raw-text flow's first batch, B={B} K={K} V={V}"
    st_args = (theta, net.model.beta.detach(), mask, bn.running_mean, bn.running_var, True)
    mean, var, m, s = fd.stats_reference(*st_args)
    lo_args = (theta, net.model.beta.detach(), x, mean, var, m, s)
    ref_loss = fd.loss_reference(*lo_args)
    gr_args = lo_args + (ref_loss[1], mask / B, mask, True)
    errs = [compare("mean,var,m,s", fd.stats(*st_args), (mean, var, m, s), case),
            compare("loss,rd", fd.loss(*lo_args), ref_loss, case),
            compare("g_theta,g_beta", fd.grads(*gr_args), fd.grads_reference(*gr_args), case)]
    route = ROUTE_NAMES[fd._route(_build.load(), "grads", B, K)]
    print(f"raw text: K1, K2, K3 on {case} ({route}) within "
          f"{', '.join(f'{e:.3e}' for e in errs)} of their plain versions (tol {ATOL:g} + "
          f"{RTOL:g}*max|plain| per output)", flush=True)

    fd.reset_launches()
    trainer, result, secs = run(2)
    launches = dict(fd.LAUNCHES)
    print(f"raw text: fit {result.losses.shape[0]} global steps x {C} clients at V={V} in "
          f"{secs:.3f} s; launches {nonzero(launches)}; epoch losses {result.epoch_losses}",
          flush=True)
    check(result.losses.shape == (8, C), f"losses shape {result.losses.shape} != (8, {C})")
    check(bool(np.isfinite(result.losses).all()), "non-finite federated losses")
    for name in ("stats", "loss", "grads"):
        check(launches[name] == 16, f"raw text: {name} launched {launches[name]} times, "
              f"want 16")
        notes[name] += (f"; phase 7 raw-text flow (V={V}, {4 if V % 4 else 16}-byte cp.async "
                        f"ring): {launches[name]} launches")
    model = trainer.make_global_model(result, consensus.datasets[0])
    topics = model.get_topics(10)
    check(len(topics) == K and all(len(t) == 10 and t[0].startswith("wd") for t in topics),
          "get_topics did not return 50 lists of 10 words")
    t0 = time.perf_counter()
    tokens = [d.split() for c in clients for d in c.documents]
    npmi = npmi_coherence(topics, tokens)
    diversity = topic_diversity(topics)
    print(f"raw text: topic 0 {topics[0]}; NPMI {npmi:.4f}, topic diversity {diversity:.4f} "
          f"over {len(tokens)} documents in {time.perf_counter() - t0:.2f} s", flush=True)
    check(np.isfinite(npmi) and -1.0 <= npmi <= 1.0, f"NPMI {npmi}")
    check(np.isfinite(diversity) and 0.0 <= diversity <= 1.0, f"topic diversity {diversity}")

    # Steady state as in phase 3: a 24-step fit minus an 8-step fit.
    run(2)
    secs8 = min(run(2)[2], run(2)[2])
    secs24 = min(run(6)[2], run(6)[2])
    ms_step = (secs24 - secs8) / 16 * 1e3
    check(ms_step > 0, f"steady-state step time {ms_step:.3f} ms is not positive")
    print(f"raw text steady step, {card}: {ms_step:.3f} ms per global step, "
          f"{C * B / ms_step * 1e3:.1f} docs/s ({C} clients x B={B}, V={V}); warm 8-step fit "
          f"{secs8 * 1e3:.1f} ms, 24-step fit {secs24 * 1e3:.1f} ms", flush=True)
    return clients, consensus


def decodes_and_text_phase(card: str, notes: dict):
    """Phase 7: (a) then (b), timed; (b) adds its launches to the K1-K3
    rows' ``notes``. Returns (b)'s clients and consensus."""
    t_phase = time.perf_counter()
    sharded_decodes_phase(card)
    raw = raw_text_phase(card, notes)
    print(f"phase 7 took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return raw


# ---------------------------------------------------------------------------
# Phase 8: the CTM family and the externally-stepped clients
# ---------------------------------------------------------------------------
CTM_LABELS = 5  # one-hot label classes of the CTM phases
CTM_CONTEXT = 768  # contextual embedding width (SBERT's)


def onehot_labels(n: int, seed: int):
    """``n`` seeded one-hot labels over :data:`CTM_LABELS` classes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return np.eye(CTM_LABELS, dtype=np.float32)[rng.integers(0, CTM_LABELS, n)]


def ctm_federated_phase(card: str, notes: dict, raw) -> list:
    """Phase 8 (a) and (b): federated CombinedTM with labels, float32 and
    bf16, and federated ZeroShotTM without labels, on phase 7(b)'s raw-text
    clients with ``hashing_embedder`` embeddings. Returns (a)'s datasets."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch import (
        CombinedTM,
        CTMDataset,
        FederatedTrainer,
        ZeroShotTM,
        hashing_embedder,
        npmi_coherence,
        topic_diversity,
    )
    from gfedntm_tpu_torch.ops import _build
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    clients, consensus = raw
    V, K, B, C = len(consensus.global_vocab), 50, 256, 2
    t0 = time.perf_counter()
    embed = hashing_embedder(CTM_CONTEXT)
    contexts = [embed(c.documents) for c in clients]
    print(f"ctm: hashing_embedder({CTM_CONTEXT}) of {C} x {len(clients[0])} documents in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    datasets = [CTMDataset(X=ds.X, X_ctx=contexts[c], labels=onehot_labels(len(ds), c),
                           idx2token=ds.idx2token) for c, ds in enumerate(consensus.datasets)]
    kw = dict(input_size=V, contextual_size=CTM_CONTEXT, n_components=K,
              hidden_sizes=(100, 100), batch_size=B)

    def run(num_epochs, dtype="float32", cls=CombinedTM, data=datasets,
            label_size=CTM_LABELS):
        template = cls(**kw, num_epochs=num_epochs, label_size=label_size,
                       compute_dtype=dtype)
        trainer = FederatedTrainer(template, n_clients=C)
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = trainer.fit(data)
        torch.cuda.synchronize()
        return trainer, result, time.perf_counter() - start

    # K1-K3 on this path's first batch against their plain versions, in
    # float32 and in bf16: theta from an initial CombinedTM's encoder on the
    # first client's first B documents, their embeddings and labels. The
    # bf16 kernels read beta and x rounded to bf16 at the padded pitch (7
    # pad columns at V=66,001), as the fit stores them; their plain versions
    # take the float32 values of the same rounded arrays.
    for dtype in ("float32", "bfloat16"):
        net = CombinedTM(**kw, label_size=CTM_LABELS, compute_dtype=dtype)
        first = {key: value[:B] for key, value in net._device_data(datasets[0]).items()}
        x, mask = first["x_bow"], torch.ones(B, device=net.device)
        with torch.no_grad():
            theta = net.model.encode_theta(x, first["x_ctx"], first["labels"], mask=mask,
                                           generator=net.generator).theta.float()
        beta_s, x_s = fd.store(net.model.beta.detach(), dtype), fd.store(x, dtype)
        beta_r, x_r = beta_s.float(), x_s.float()
        bn = net.model.beta_batchnorm
        case = f"the CombinedTM flow's first batch, {dtype}, B={B} K={K} V={V}"
        rest = (mask, bn.running_mean, bn.running_var, True)
        mean, var, m, s = fd.stats_reference(theta, beta_r, *rest)
        ref_loss = fd.loss_reference(theta, beta_r, x_r, mean, var, m, s)
        gr_rest = (mean, var, m, s, ref_loss[1], mask / B, mask, True)
        errs = [compare("mean,var,m,s", fd.stats(theta, beta_s, *rest, storage_dtype=dtype),
                        (mean, var, m, s), case),
                compare("loss,rd", fd.loss(theta, beta_s, x_s, mean, var, m, s,
                                           storage_dtype=dtype), ref_loss, case),
                compare("g_theta,g_beta", fd.grads(theta, beta_s, x_s, *gr_rest,
                                                   storage_dtype=dtype),
                        fd.grads_reference(theta, beta_r, x_r, *gr_rest), case)]
        route = ROUTE_NAMES[fd._route(_build.load(), "grads", B, K, dtype)]
        print(f"ctm: K1, K2, K3 on {case} ({route}) within "
              f"{', '.join(f'{e:.3e}' for e in errs)} of their plain versions (tol {ATOL:g} + "
              f"{RTOL:g}*max|plain| per output)", flush=True)

    for dtype, suffix in (("float32", ""), ("bfloat16", "_bf16")):
        fd.reset_launches()
        trainer, result, secs = run(2, dtype)
        launches = dict(fd.LAUNCHES)
        print(f"ctm (a) CombinedTM + labels, {dtype}: fit {result.losses.shape[0]} global "
              f"steps x {C} clients at V={V} in {secs:.3f} s; launches {nonzero(launches)}; "
              f"epoch losses {result.epoch_losses}", flush=True)
        check(result.losses.shape == (8, C), f"ctm {dtype}: losses shape {result.losses.shape}")
        check(bool(np.isfinite(result.losses).all()), f"ctm {dtype}: non-finite losses")
        for name in ("stats", "loss", "grads"):
            got = launches[name + suffix]
            check(got == 16 and sum(launches.values()) == 48,
                  f"ctm {dtype}: {name + suffix} launched {got} times (want 16), all "
                  f"{launches}")
            notes[name + suffix] += f"; phase 8(a) CombinedTM {dtype}: {got} launches"
        for tree in (result.client_params, result.client_batch_stats):
            for key, val in tree[0].items():
                check(val.dtype in (torch.float32, torch.long),
                      f"ctm {dtype}: {key} is {val.dtype}")
                for other in tree[1:]:
                    check(torch.equal(val, other[key]), f"ctm {dtype}: {key} differs across "
                          "clients")
        if dtype == "float32":
            model = trainer.make_global_model(result, datasets[0])
            check(isinstance(model, CombinedTM), f"global model is a {type(model).__name__}")
            topics = model.get_topics(10)
            check(len(topics) == K and all(len(t) == 10 for t in topics),
                  "get_topics did not return 50 lists of 10")
            tokens = [d.split() for c in clients for d in c.documents]
            npmi, diversity = npmi_coherence(topics, tokens), topic_diversity(topics)
            print(f"ctm (a): topic 0 {topics[0]}; NPMI {npmi:.4f}, topic diversity "
                  f"{diversity:.4f}", flush=True)
            check(np.isfinite(npmi) and -1.0 <= npmi <= 1.0, f"NPMI {npmi}")
            check(np.isfinite(diversity) and 0.0 <= diversity <= 1.0, f"diversity {diversity}")
            save_dir = SCRATCH / "ctm"
            model.nn_epoch = 1
            t0 = time.perf_counter()
            model.save(str(save_dir))
            fresh = CombinedTM(**kw, label_size=CTM_LABELS)
            fresh.load(str(save_dir), 1)
            for key, val in model.model.state_dict().items():
                check(torch.equal(fresh.model.state_dict()[key], val),
                      f"CombinedTM load: {key} differs from the saved state")
            print(f"ctm (a): save + load of the global CombinedTM bitwise equal "
                  f"({time.perf_counter() - t0:.2f} s)", flush=True)
            shutil.rmtree(save_dir, ignore_errors=True)
        # Steady state as in phase 3: a 24-step fit minus an 8-step fit.
        secs8 = min(run(2, dtype)[2], run(2, dtype)[2])
        secs24 = min(run(6, dtype)[2], run(6, dtype)[2])
        ms_step = (secs24 - secs8) / 16 * 1e3
        check(ms_step > 0, f"ctm steady step time {ms_step:.3f} ms is not positive")
        print(f"ctm (a) steady step, {card}: CombinedTM + labels {dtype}: {ms_step:.3f} ms per "
              f"global step, {C * B / ms_step * 1e3:.1f} docs/s ({C} clients x B={B}, V={V}); "
              f"8-step fit {secs8 * 1e3:.1f} ms, 24-step fit {secs24 * 1e3:.1f} ms", flush=True)

    plain = [CTMDataset(X=d.X, X_ctx=d.X_ctx, idx2token=d.idx2token) for d in datasets]
    fd.reset_launches()
    _, result, secs = run(2, cls=ZeroShotTM, data=plain, label_size=0)
    launches = dict(fd.LAUNCHES)
    print(f"ctm (b) ZeroShotTM, no labels: fit {result.losses.shape[0]} global steps x {C} "
          f"clients in {secs:.3f} s; launches {nonzero(launches)}; epoch losses "
          f"{result.epoch_losses}", flush=True)
    check(bool(np.isfinite(result.losses).all()), "ZeroShotTM: non-finite losses")
    for name in ("stats", "loss", "grads"):
        check(launches[name] == 16, f"ZeroShotTM: {name} launched {launches[name]} times")
        notes[name] += f"; phase 8(b) ZeroShotTM: {launches[name]} launches"
    for c, losses in enumerate(result.epoch_losses):
        check(losses[1] < losses[0],
              f"ZeroShotTM client {c}: epoch losses {losses} do not fall")
    return datasets


def ctm_sharded_phase(card: str) -> None:
    """Phase 8 (c): ``fit_sharded`` of CombinedTM with labels on phase 4's
    corpus at dp=1 x mp=2 and dp=2 x mp=2 against the unsharded fit."""
    import numpy as np

    from gfedntm_tpu_torch import CTM, CTMDataset
    from gfedntm_tpu_torch.parallel import programs
    from gfedntm_tpu_torch.parallel.launch import gpu_layout, run_ranks

    V, K, B, N = 100_000, 50, 256, 2048
    X = synthetic_bow(V, K, N, 0)
    X_ctx = np.random.default_rng(1).standard_normal((N, CTM_CONTEXT), dtype=np.float32)
    labels = onehot_labels(N, 2)
    kw = dict(input_size=X.shape[1], contextual_size=CTM_CONTEXT, n_components=K,
              hidden_sizes=(100, 100), batch_size=B, num_epochs=1, dropout=0.0, seed=0,
              inference_type="combined", label_size=CTM_LABELS)
    ref = CTM(**kw)
    ref_step = programs.step_gradients(CTM(**kw), {"X": X, "X_ctx": X_ctx, "labels": labels})
    ref.fit(CTMDataset(X=X, X_ctx=X_ctx, labels=labels), n_samples=1)
    steps_ref = np.asarray(ref.step_losses)
    corpus = {"X": shared(X), "X_ctx": shared(X_ctx), "labels": shared(labels)}
    for dp, mp in ((1, 2), (2, 2)):
        backend, devices = gpu_layout(dp * mp)
        t0, launched = time.perf_counter(), time.time()
        res = run_ranks(programs.fit, dp * mp, backend, devices, 900,
                        args=(dp, mp, kw, corpus, None, 1, 4))
        secs = time.perf_counter() - t0
        # Where the rank group's seconds go, as in phase 7(a).
        print(f"ctm (c) dp={dp} x mp={mp}: start-up "
              f"{max(r['entered_at'] for r in res) - launched:.1f} s, then rank 0's "
              + ", ".join(f"{k} {v:.1f} s" for k, v in res[0]["seconds"].items())
              + f"; teardown {time.time() - max(r['left_at'] for r in res):.1f} s", flush=True)
        steps = len(steps_ref)
        for rank, r in enumerate(res):
            got = nonzero(r["launches"])
            want = ({"stats": steps, "loss": steps, "grads": steps, "vsharded": steps}
                    if dp == 1 else {})
            check(got == want, f"ctm {dp} x {mp} rank {rank}: launches {got}, want {want}")
            rows = r["rows_calls"]["vsharded_rows"]
            check(rows == (steps if dp > 1 else 0),
                  f"ctm {dp} x {mp} rank {rank}: {rows} rows-sharded K5 calls")
        check_same_state(res, f"ctm {dp} x {mp}")
        loss_e, grad_e, cancel_e = first_step_errors(res[0]["first_step"], ref_step)
        step_e = float(np.max(np.abs(np.asarray(res[0]["step_losses"]) - steps_ref)
                              / np.abs(steps_ref)))
        print(f"ctm (c) fit_sharded CombinedTM + labels, {backend} dp={dp} x mp={mp} on "
              f"{devices}: ranks done in {secs:.1f} s; launches per rank "
              f"{[nonzero(r['launches']) for r in res]}, rows-sharded K5 calls "
              f"{[r['rows_calls']['vsharded_rows'] for r in res]}; first step: loss "
              f"{loss_e:.3e} relative, gradients within {grad_e:.3e} of each leaf's max|grad| "
              f"(limit 1e-3), {', '.join(DEGENERATE)} within {cancel_e:.3e} of the largest "
              f"(limit 1e-5); step losses {step_e:.3e} (limit 1e-3); state bitwise equal on "
              f"{dp * mp} ranks", flush=True)
        print(f"ctm (c) steady step, {card}: dp={dp} x mp={mp} ({backend}): "
              f"{[round(r['step_ms'], 3) for r in res]} ms per step per rank (4 warm steps "
              f"between barriers); bytes per step through each data group's all_reduce: batch "
              f"gather {res[0]['step_bytes']['batch_gather'] / 1e6:.1f} MB, gradient sum "
              f"{res[0]['step_bytes']['gradient_sum'] / 1e6:.1f} MB", flush=True)
        check(loss_e <= 1e-3 and grad_e <= 1e-3 and cancel_e <= 1e-5,
              f"ctm {dp} x {mp} first step: {loss_e:.3e}, {grad_e:.3e}, {cancel_e:.3e}")
        check(step_e <= 1e-3, f"ctm {dp} x {mp} step losses differ by {step_e:.3e}")


def stepper_phase(card: str, ctm_datasets: list, avitm_datasets: list) -> None:
    """Phase 8 (d): two ``FederatedCTM`` steppers on (a)'s model and data,
    then two ``FederatedAVITM`` steppers on phase 3's, each driven in
    process for 8 exchanged steps through ``weighted_mean``."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch import (
        AVITM,
        CombinedTM,
        FederatedAVITM,
        FederatedCTM,
        weighted_mean,
    )
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    K, B = 50, 256
    ctm_kw = dict(input_size=ctm_datasets[0].vocab_size, contextual_size=CTM_CONTEXT,
                  n_components=K, hidden_sizes=(100, 100), batch_size=B, num_epochs=2,
                  label_size=CTM_LABELS)
    avitm_kw = dict(input_size=avitm_datasets[0].vocab_size, n_components=K,
                    hidden_sizes=(100, 100), batch_size=B, num_epochs=2)
    for label, build, datasets in (
            ("FederatedCTM (CombinedTM + labels)",
             lambda c: FederatedCTM(CombinedTM(**ctm_kw, seed=c)), ctm_datasets),
            ("FederatedAVITM", lambda c: FederatedAVITM(AVITM(**avitm_kw, seed=c)),
             avitm_datasets)):
        steppers = [build(c) for c in range(len(datasets))]
        for stepper, data in zip(steppers, datasets):
            stepper.pre_fit(data)
        weights = [float(len(d)) for d in datasets]
        ms = {"step": [], "snapshot": [], "mean": [], "set": []}
        statuses = [[] for _ in steppers]
        fd.reset_launches()
        for _ in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for stepper in steppers:
                stepper.train_mb_delta(snapshot=False)  # its loss's read syncs
            t1 = time.perf_counter()
            snaps = [stepper.get_gradients() for stepper in steppers]
            t2 = time.perf_counter()
            avg = weighted_mean(list(zip(weights, snaps)))
            t3 = time.perf_counter()
            for c, stepper in enumerate(steppers):
                statuses[c].append(stepper.delta_update_fit(avg))
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            for key, start, end in (("step", t0, t1), ("snapshot", t1, t2), ("mean", t2, t3),
                                    ("set", t3, t4)):
                ms[key].append((end - start) * 1e3)
            first = steppers[0].model.model.state_dict()
            for stepper in steppers[1:]:
                for key, val in stepper.model.model.state_dict().items():
                    check(torch.equal(val, first[key]),
                          f"{label}: {key} differs across clients after delta_update_fit")
        launches = dict(fd.LAUNCHES)
        nbytes = sum(v.nbytes for v in snaps[0].values())
        seq = [(s.current_mb, s.current_epoch, s.epoch_ended, s.finished) for s in statuses[0]]
        print(f"stepper (d) {label}: launches {nonzero(launches)}; client 0's StepStatus "
              f"(current_mb, current_epoch, epoch_ended, finished) {seq}; epoch losses "
              f"{[s.epoch_losses for s in steppers]}", flush=True)
        steady = {k: float(np.median(v[1:])) for k, v in ms.items()}
        print(f"stepper (d) steady exchanged step, {card}: {label}, {len(steppers)} clients: "
              f"median ms over steps 2-8: step {steady['step']:.3f}, snapshot "
              f"{steady['snapshot']:.3f} ({nbytes / 1e6:.1f} MB device to host per client), "
              f"mean {steady['mean']:.3f}, set {steady['set']:.3f}; total "
              f"{sum(steady.values()):.3f}", flush=True)
        for name in ("stats", "loss", "grads"):
            check(launches[name] == 16, f"{label}: {name} launched {launches[name]} times")
        want = [(1, 0, False, False), (2, 0, False, False), (3, 0, False, False),
                (4, 1, True, False), (5, 1, False, False), (6, 1, False, False),
                (7, 1, False, False), (8, 2, True, True)]
        for c in range(len(steppers)):
            got = [(s.current_mb, s.current_epoch, s.epoch_ended, s.finished)
                   for s in statuses[c]]
            check(got == want, f"{label} client {c}: StepStatus sequence {got}")
            check(all(np.isfinite(steppers[c].epoch_losses)), f"{label}: non-finite epoch loss")


def ctm_phase(card: str, notes: dict, raw=None, avitm_datasets=None) -> None:
    """Phase 8: (a) and (b) on phase 7(b)'s clients (``raw``, made here when
    not given), (c), then (d) on (a)'s datasets and phase 3's
    (``avitm_datasets``, made here when not given); timed."""
    t_phase = time.perf_counter()
    ctm_datasets = ctm_federated_phase(card, notes, raw or raw_text_corpora(card))
    ctm_sharded_phase(card)
    stepper_phase(card, ctm_datasets, avitm_datasets or main_path_datasets())
    print(f"phase 8 took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)


# ---------------------------------------------------------------------------
# Phase 9: the gRPC federation
# ---------------------------------------------------------------------------
FED_STEPS = 8  # global steps of phase 9: 1,024 documents per client, B=256, 2 epochs


def _timed(obj, name: str, sink: list) -> None:
    """Replace ``obj.name`` by a wrapper that appends each call's
    ``(start, end)`` perf-counter pair to ``sink``."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            sink.append((t0, time.perf_counter()))

    setattr(obj, name, wrapper)


def _seconds(pairs) -> list:
    return [end - start for start, end in pairs]


def federation_phase(card: str, notes: dict, raw=None) -> None:
    """Phase 9: a port ``FederatedServer`` and two port ``Client``s over
    localhost gRPC on the card, in one process, on phase 7(b)'s raw-text
    clients (consensus V=66,001), K=50, H=(100, 100), B=256, 8 global steps;
    checked against the same two ``FederatedAVITM`` steppers driven in
    process."""
    import threading

    import numpy as np
    import torch

    from gfedntm_tpu_torch.federated.aggregation import weighted_mean
    from gfedntm_tpu_torch.federated.stepper import FederatedAVITM
    from gfedntm_tpu_torch.federation.client import Client, load_global_setup
    from gfedntm_tpu_torch.federation.server import FederatedServer, build_template_model
    from gfedntm_tpu_torch.ops import _build
    from gfedntm_tpu_torch.ops import fused_decoder as fd
    from gfedntm_tpu_torch.utils.observability import MetricsLogger

    t_phase = time.perf_counter()
    clients_raw = (raw or raw_text_corpora(card))[0]
    K, B, C = 50, 256, len(clients_raw)
    kw = dict(n_components=K, hidden_sizes=(100, 100), batch_size=B, num_epochs=2, seed=0)
    save_dir = SCRATCH / "federation"

    class Recorded(Client):
        """A client whose stepper records, per step, its step and snapshot
        times, loss, StepStatus and a copy of its state on the card."""

        def join_federation(self):
            t0 = time.perf_counter()
            super().join_federation()
            self.join_s = time.perf_counter() - t0
            st = self.stepper
            self.first_batch = (st._schedule.indices[0].copy(), st._schedule.mask[0].copy())
            self.steps, self.snaps, self.sets = [], [], []
            self.losses, self.statuses, self.states = [], [], []
            _timed(st, "get_gradients", self.snaps)
            _timed(st, "train_mb_delta", self.steps)
            update = st.delta_update_fit

            def delta_update_fit(averaged):
                t0 = time.perf_counter()
                status = update(averaged)
                self.sets.append((t0, time.perf_counter()))
                self.losses.append(st.loss)
                self.statuses.append(status)
                self.states.append({k: v.clone() for k, v in st.model.model.state_dict().items()})
                return status

            st.delta_update_fit = delta_update_fit

    server_log = MetricsLogger(node="server", keep_records=True)
    server = FederatedServer(min_clients=C, family="avitm", model_kwargs=kw, max_iters=100,
                             save_dir=str(save_dir), metrics=server_log)
    check(server.device.type == "cuda", f"the server's template is on {server.device}")
    decode, mean, encode = [], [], []
    _timed(server, "_collect_snapshots", decode)
    _timed(server.aggregator, "aggregate", mean)
    _timed(server, "_encode_push", encode)
    address = server.start("127.0.0.1:0")
    logs = [MetricsLogger(node=f"client{c + 1}", keep_records=True) for c in range(C)]
    clients = [Recorded(client_id=c + 1, corpus=clients_raw[c], server_address=address,
                        listen_address="127.0.0.1:0", advertise_host="127.0.0.1",
                        max_features=None, metrics=logs[c]) for c in range(C)]
    errors: list = []

    def run(client):
        try:
            client.run()
        except BaseException as err:  # reported below: the phase fails
            errors.append(f"client {client.client_id}: {type(err).__name__}: {err}")

    threads = [threading.Thread(target=run, args=(cl,), daemon=True) for cl in clients]
    try:
        fd.reset_launches()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        while not server.wait_done(timeout=1.0):
            check(not errors, f"phase 9: {errors}")
            check(time.perf_counter() - t0 < 600, "phase 9: the federation did not finish "
                  "in 600 s")
        for t in threads:
            t.join(timeout=60)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(fd.LAUNCHES)
        check(not errors, f"phase 9: {errors}")
        check(all(not t.is_alive() for t in threads), "phase 9: a client did not stop")
    finally:
        server.stop(grace=0.5, join_timeout=30)
        for cl in clients:
            cl.shutdown(grace=0.5)
    V = len(server.global_vocab)
    print(f"federation: {C} port clients joined a port server over gRPC on {server.device} "
          f"(global V={V}) in {[round(cl.join_s, 2) for cl in clients]} s; {server.global_iterations} "
          f"global steps; the run took {run_s:.2f} s; launches {nonzero(launches)}", flush=True)
    check(V == 66_001, f"phase 9: global vocabulary of {V} words, want 66,001")
    check(server.global_iterations == FED_STEPS,
          f"phase 9: {server.global_iterations} global steps, want {FED_STEPS}")
    for name in ("stats", "loss", "grads"):
        check(launches[name] == C * FED_STEPS,
              f"phase 9: {name} launched {launches[name]} times, want {C * FED_STEPS}")
        notes[name] += f"; phase 9 gRPC federation: {launches[name]} launches"
    check((save_dir / "server_model.npz").exists(), "phase 9: no server_model.npz")
    check(bool(np.isfinite(server.global_betas).all()), "phase 9: non-finite server betas")
    for cl in clients:
        check(cl.stepper.model.device.type == "cuda", f"client {cl.client_id} not on the card")
        check(len(cl.states) == FED_STEPS, f"client {cl.client_id}: {len(cl.states)} aggregates")
    for step in range(FED_STEPS):
        for key, value in clients[0].states[step].items():
            check(torch.equal(value, clients[1].states[step][key]),
                  f"phase 9: {key} differs across clients after aggregate {step + 1}")

    # K1-K3 on the first client's first batch against their plain versions:
    # the server's initial state, theta from its encoder.
    net = build_template_model("avitm", V, kw)
    load_global_setup(net, server._setup_reply)
    idx, mask_np = clients[0].first_batch
    x = torch.as_tensor(clients[0].dataset.X[idx], device=net.device)
    mask = torch.as_tensor(mask_np, device=net.device, dtype=torch.float32)
    with torch.no_grad():
        theta = net.model.encode_theta(
            x, mask=mask, generator=torch.Generator(device=net.device).manual_seed(0)).theta
    bn = net.model.beta_batchnorm
    case = f"phase 9's first batch, B={B} K={K} V={V}"
    st_args = (theta, net.model.beta.detach(), mask, bn.running_mean, bn.running_var, True)
    mean_, var_, m, s = fd.stats_reference(*st_args)
    lo_args = (theta, net.model.beta.detach(), x, mean_, var_, m, s)
    ref_loss = fd.loss_reference(*lo_args)
    gr_args = lo_args + (ref_loss[1], mask / B, mask, True)
    errs = [compare("mean,var,m,s", fd.stats(*st_args), (mean_, var_, m, s), case),
            compare("loss,rd", fd.loss(*lo_args), ref_loss, case),
            compare("g_theta,g_beta", fd.grads(*gr_args), fd.grads_reference(*gr_args), case)]
    route = ROUTE_NAMES[fd._route(_build.load(), "grads", B, K)]
    print(f"federation: K1, K2, K3 on {case} ({route}) within "
          f"{', '.join(f'{e:.3e}' for e in errs)} of their plain versions", flush=True)

    # The same two steppers in process from the server's initial state.
    steppers = []
    for cl in clients:
        model = build_template_model("avitm", V, kw)
        load_global_setup(model, server._setup_reply)
        stepper = FederatedAVITM(model)
        stepper.pre_fit(cl.dataset)
        steppers.append(stepper)
    for step in range(FED_STEPS):
        snaps = []
        for st in steppers:
            snap = st.train_mb_delta()
            snaps.append((st._last_batch_size, snap))
        avg = weighted_mean(snaps)
        for c, (cl, st) in enumerate(zip(clients, steppers)):
            status = st.delta_update_fit(avg)
            check(st.loss == cl.losses[step], f"phase 9 client {c + 1} step {step + 1}: loss "
                  f"{cl.losses[step]!r} over the wire, {st.loss!r} in process")
            check(status == cl.statuses[step],
                  f"phase 9 client {c + 1} step {step + 1}: StepStatus differs")
            for key, value in st.model.model.state_dict().items():
                check(torch.equal(value, cl.states[step][key]),
                      f"phase 9 client {c + 1} step {step + 1}: {key} differs from the "
                      "in-process stepper's")
    check(np.array_equal(server.global_betas, steppers[0].get_topics_in_server()),
          "phase 9: the server's betas differ from the in-process steppers'")

    # Where a global step's time goes: median over steps 2-8.
    rounds = {r["span_id"]: r for r in server_log.events("span") if r["name"] == "round"}
    order = sorted(rounds.values(), key=lambda r: r["round"])
    child = {(r["parent_id"], r["name"]): r["seconds"] for r in server_log.events("span")
             if r["name"] in ("poll", "average", "push")}
    serve = [{(r.get("round"), r["method"]): r["seconds"] for r in log.events("span")
              if r["name"] == "serve"} for log in logs]
    split = {k: [] for k in ("round", "client step", "snapshot and encode",
                             "transfer and decode", "mean", "push and set")}
    for i, rnd in enumerate(order[1:], 1):
        sid = rnd["span_id"]
        poll, average, push = (child[(sid, n)] for n in ("poll", "average", "push"))
        steps = [b - a for cl in clients for a, b in [cl.steps[i]]]
        snapshot = [g for cl in clients for g in _seconds(cl.snaps[i:i + 1])]
        train = [sv[(i, "FederationClient.TrainStep")] for sv in serve]
        step_only = [t - g for t, g in zip(steps, snapshot)]
        split["round"].append(rnd["seconds"])
        split["client step"].append(float(np.mean(step_only)))
        split["snapshot and encode"].append(float(np.mean(
            [tr - so for tr, so in zip(train, step_only)])))
        split["transfer and decode"].append(poll - max(train) + _seconds(decode)[i])
        split["mean"].append(_seconds(mean)[i])
        split["push and set"].append(average - _seconds(decode)[i] - _seconds(mean)[i] + push)
    steady = {k: float(np.median(v)) * 1e3 for k, v in split.items()}
    pulled = [r["bytes_pulled"] / C for r in order]
    pushed = [r["bytes_pushed"] / C for r in order]
    print(f"federation steady global step, {card}: median ms over steps 2-{FED_STEPS}: "
          f"{steady['round']:.3f} per global step ({C * B / steady['round'] * 1e3:.1f} docs/s), "
          f"split: client step {steady['client step']:.3f}, snapshot and encode "
          f"{steady['snapshot and encode']:.3f}, transfer and decode "
          f"{steady['transfer and decode']:.3f}, mean {steady['mean']:.3f}, push and set "
          f"{steady['push and set']:.3f}", flush=True)
    print(f"federation bytes per step and client, {card}: up (StepReply.shared) "
          f"{float(np.median(pulled)) / 1e6:.3f} MB, down (Aggregate) "
          f"{float(np.median(pushed)) / 1e6:.3f} MB; GlobalSetup "
          f"{server._setup_reply.ByteSize() / 1e6:.3f} MB", flush=True)
    print(f"federation first global step {order[0]['seconds'] * 1e3:.1f} ms; outside the "
          f"steps (the joins, the stop broadcast, the clients' results, server_model.npz) "
          f"{run_s - sum(r['seconds'] for r in order):.2f} s of the run", flush=True)

    # The same host work for one client with no other node in the process:
    # the wire's per-byte cost without contention for the interpreter.
    from gfedntm_tpu_torch.federation import codec as wire
    from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb

    st = steppers[0]
    alone = {k: [] for k in ("snapshot", "encode", "serialize", "parse", "decode", "mean",
                             "set")}
    for _ in range(5):
        t0 = time.perf_counter()
        snap = st.get_gradients()
        t1 = time.perf_counter()
        reply = pb.StepReply(client_id=1, shared=wire.flatdict_to_bundle(snap))
        t2 = time.perf_counter()
        data = reply.SerializeToString()
        t3 = time.perf_counter()
        parsed = pb.StepReply.FromString(data)
        t4 = time.perf_counter()
        back = wire.bundle_to_flatdict(parsed.shared)
        t5 = time.perf_counter()
        avg = weighted_mean([(256.0, back), (256.0, snap)])
        t6 = time.perf_counter()
        st.set_gradients(avg)
        torch.cuda.synchronize()
        t7 = time.perf_counter()
        for key, a, b in zip(alone, (t0, t1, t2, t3, t4, t5, t6), (t1, t2, t3, t4, t5, t6, t7)):
            alone[key].append((b - a) * 1e3)
    print(f"federation host work of one client alone, {card}: median ms over 5 of "
          + ", ".join(f"{k} {float(np.median(v)):.3f}" for k, v in alone.items())
          + f" ({len(data) / 1e6:.3f} MB StepReply)", flush=True)
    print(f"phase 9 took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)


def main(argv: list[str]) -> int:
    kernels_only = "--kernels-only" in argv
    dp_only = "--data-parallel-only" in argv
    p7_only = "--phase-7-only" in argv
    ctm_only = "--ctm-only" in argv
    fed_only = "--federation-only" in argv
    rest = [a for a in argv if a not in ("--kernels-only", "--data-parallel-only",
                                         "--phase-7-only", "--ctm-only", "--federation-only")]
    usage_ok = not rest or (rest[0] == "--against" and len(rest) == 2)
    against = Path(rest[1]).resolve() if rest and usage_ok else None
    only = dp_only or p7_only or ctm_only or fed_only
    if (not usage_ok or kernels_only + dp_only + p7_only + ctm_only + fed_only > 1
            or (only and against)):
        print("usage: chip_smoke.py [--kernels-only [--against DIR] | --data-parallel-only | "
              "--phase-7-only | --ctm-only | --federation-only]", file=sys.stderr)
        return 2
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
        for line in build_report(lib, _build.build_log):
            print(f"build: {line}", flush=True)
        if dp_only:
            data_parallel_phase(card, {"vsharded": ""})
            return 0
        if p7_only:
            decodes_and_text_phase(card, {"stats": "", "loss": "", "grads": ""})
            return 0
        if ctm_only:
            ctm_phase(card, {name + dt: "" for name in ("stats", "loss", "grads")
                             for dt in ("", "_bf16")})
            return 0
        if fed_only:
            federation_phase(card, {"stats": "", "loss": "", "grads": ""})
            return 0
        rows, notes = kernel_phase(card, against)
        if not kernels_only:
            datasets, result = main_path_phase(rows)
            X, kw = sharded_fit_phase(card, rows, notes)
            persistence_phase(card, rows, notes, datasets, result, X, kw)
            data_parallel_phase(card, notes)
            raw = decodes_and_text_phase(card, notes)
            ctm_phase(card, notes, raw, datasets)
            federation_phase(card, notes, raw)
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(CORPORA, ignore_errors=True)
        shutil.rmtree(SCRATCH, ignore_errors=True)
    for name, row in rows.items():
        print(f"kernel {name}: launches {row['launches']} max_abs_err {row['max_abs_err']:.3e} "
              f"ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
              f"bound_ms {row['bound_ms']:.4f}; {notes[name]}", flush=True)
    if kernels_only:
        return 0
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
