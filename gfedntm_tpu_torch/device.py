"""Device resolution for the port's entry points.

``None`` means the GPU. Without CUDA that is an error: the port never falls
back to the CPU on its own, so a CPU run is always the caller's explicit
``device="cpu"`` (as the tests pass it).

Resolving a device also pins the matmul precision of the reference: no TF32
in float32 matmuls and convolutions, and float32 accumulation in bf16
matmuls (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
= False``), as the TPU's bf16 dot accumulates.
"""

from __future__ import annotations

import argparse
import subprocess

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve ``device`` (``None`` -> ``"cuda"``) and pin the matmul
    precision the reference computes with.

    TF32 is switched off for matmuls and cuDNN here, once, so the encoder's
    float32 ``nn.Linear`` layers compute in full float32 as the reference
    does; and bf16 matmuls (``compute_dtype="bfloat16"``) may not reduce in
    bf16 inside cuBLAS, so they accumulate in float32 and round once, as the
    TPU's bf16 dot does."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev


def device_parser(doc: str) -> argparse.ArgumentParser:
    """An entry point's argument parser, described by the first line of
    ``doc``, with ``--device cpu|cuda`` (default: the GPU)."""
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("--device", default=None, choices=("cpu", "cuda"),
                   help="where the models train (default: the GPU)")
    return p


def card_line(index: int | None = None) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (of card
    ``index``; the first card's when ``None``), or why nvidia-smi gave none."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    if index is not None:
        cmd.insert(1, f"--id={index}")
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60, check=False)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi failed: {err}"
    return (out.stdout.strip().splitlines() or [f"nvidia-smi failed: {out.stderr.strip()}"])[0]
