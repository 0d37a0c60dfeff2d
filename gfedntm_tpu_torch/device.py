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
