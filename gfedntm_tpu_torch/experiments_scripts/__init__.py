"""The experiment scripts of ``experiments_scripts/`` over the port.

One module per JAX script that has a torch meaning, under the same name:
``torch_baseline``, ``time_to_quality``, ``aggregate_banked_envelope``,
``run_dss_tss_envelope``, ``run_full_v100k``, ``run_presets_24``,
``run_realtext_federated`` and ``analyze_trace``. A script that trains has
``run(..., device=None) -> dict`` (``None`` is the GPU, raising without
CUDA; the CPU only when the caller passes ``device="cpu"``) and a
``main(argv)`` behind ``python -m gfedntm_tpu_torch.experiments_scripts.<name>``
with the JAX script's positional arguments plus ``--device cpu|cuda``. The
JAX scripts' ``FORCE_CPU`` is ``--device cpu`` here. The two scripts that
only read files (``aggregate_banked_envelope``, ``analyze_trace``) touch no
device and take no ``--device``. Artifacts go under ``results_torch/`` by
default, never into the committed ``results/``.

This module holds what the scripts share: the card's name and power limit
(:func:`card`), the topic similarity score of a beta (``tss_of``), the
time-to-target ladder of ``time_to_quality`` (``time_to``, :func:`ladder`,
:func:`headline_speedup`, :func:`shipped_floor_s`), the K1-K3 launch
counters (:data:`K1_K3`, read with ``fused_decoder.launch_counts`` and
``launches_since``) and :func:`synchronize`. The ``--device`` parser is
``gfedntm_tpu_torch.device.device_parser``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

#: The repository root; the scripts' default artifacts live under
#: ``RESULTS`` there (listed in ``.gitignore``).
REPO_ROOT = Path(__file__).resolve().parents[2]
RESULTS = REPO_ROOT / "results_torch"

#: The ladder's fractions of the way from the random baseline's TSS to the
#: joint federated plateau (``time_to_quality.py:351-396``).
LADDER_FRACTIONS = (0.80, 0.90, 0.95, 0.99)


def card(device) -> dict:
    """``{"name", "power_limit"}`` of the card ``device`` runs on, as
    ``gfedntm_tpu_torch.device.card_line`` reads them from nvidia-smi;
    ``{"name": "cpu", "power_limit": None}`` for the CPU."""
    import torch

    from gfedntm_tpu_torch.device import card_line

    device = torch.device(device)
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    index = torch.cuda.current_device() if device.index is None else device.index
    name, comma, limit = card_line(index).rpartition(",")
    if not comma:
        return {"name": torch.cuda.get_device_name(index), "power_limit": "not read"}
    return {"name": name.strip(), "power_limit": limit.strip()}


def synchronize(device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU), so that a
    host clock read after it times the work."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def storage_kernels(compute_dtype: str = "float32") -> tuple:
    """The launch counters of K1-K3 for a model's compute dtype: their
    float32 instantiations, or the ``_bf16`` ones."""
    from gfedntm_tpu_torch.ops.fused_decoder import KERNELS

    return KERNELS if compute_dtype == "float32" else tuple(f"{k}_bf16" for k in KERNELS)


#: K1-K3's counters, float32 and bf16.
K1_K3 = storage_kernels("float32") + storage_kernels("bfloat16")


def softmax_rows(a):
    e = np.exp(a - a.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def tss_of(beta_logits, topic_vectors, id2token: dict | None = None) -> float:
    """TSS of a beta (logits, one softmax) against the generator's topics,
    its columns mapped onto the full vocabulary by ``id2token`` (the
    identity when ``None``)."""
    from gfedntm_tpu_torch.eval.metrics import (
        convert_topic_word_to_init_size,
        topic_similarity_score,
    )

    beta = softmax_rows(np.asarray(beta_logits, dtype=np.float64))
    if id2token is not None:
        beta = convert_topic_word_to_init_size(topic_vectors.shape[1], beta, id2token)
    return topic_similarity_score(beta, topic_vectors)


def time_to(curve: list, target: float):
    """Seconds of the first point of ``curve`` at or above ``target``;
    ``None`` if it never gets there."""
    for p in curve:
        if p["tss"] >= target:
            return p["wall_s"]
    return None


def ladder(baseline_tss: float, plateau: float, curves: dict) -> dict:
    """Per fraction of :data:`LADDER_FRACTIONS`, the absolute TSS target
    between the random baseline and the plateau, and ``time_to`` it of each
    curve, keyed as ``curves`` is."""
    out = {}
    for frac in LADDER_FRACTIONS:
        target = baseline_tss + frac * (plateau - baseline_tss)
        out[f"{int(frac * 100)}pct"] = {
            "target_tss": round(target, 4),
            **{key: time_to(curve, target) for key, curve in curves.items()},
        }
    return out


def headline_speedup(targets: dict, torch_key: str = "torch_federated_s",
                     port_key: str = "gfedntm_tpu_s", port_s: float | None = None):
    """``torch_federated_s / gfedntm_tpu_s`` at the 95% target, two decimals
    (``port_s`` in place of the port's time, for the cold start)."""
    head = targets["95pct"]
    port = head[port_key] if port_s is None else port_s
    return round(head[torch_key] / port, 2) if head[torch_key] and port else None


def shipped_floor_s(torch_federated_s, torch_federated_curve: list, total_steps: int,
                    n_nodes: int, sleep_s: float = 3.0):
    """The reference's shipped federated stack at the 95% target: the global
    steps the torch federated arm took to reach it, times ``sleep_s`` per
    client per step of orchestration sleeps (``server.py:417-420``)."""
    if torch_federated_s is None:
        return None
    step_s = max(torch_federated_curve[-1]["wall_s"] / total_steps, 1e-9)
    return round(int(round(torch_federated_s / step_s)) * sleep_s * n_nodes)
