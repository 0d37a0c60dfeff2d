"""Device resolution for the port's entry points.

``None`` means the GPU. Without CUDA that is an error: the port never falls
back to the CPU on its own, so a CPU run is always the caller's explicit
``device="cpu"`` (as the tests pass it).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve ``device`` (``None`` -> ``"cuda"``) and pin full-float32 math.

    TF32 is switched off for matmuls and cuDNN here, once, so the encoder's
    float32 ``nn.Linear`` layers compute in full float32 as the reference
    does."""
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
    return dev
