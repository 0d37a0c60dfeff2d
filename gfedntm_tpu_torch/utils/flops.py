"""FLOP and MFU accounting for the port's training paths.

Counterpart of ``gfedntm_tpu/utils/flops.py``. :func:`mfu` and
:func:`resolve_peak_flops_per_device` are the JAX module's, with the device
named by a :class:`torch.device` instead of a JAX backend string.

The work side differs: the JAX module reads XLA's cost analysis of the
lowered program, and eager PyTorch has no program. :func:`measure_step_flops`
runs one step under :class:`torch.utils.flop_counter.FlopCounterMode`, which
counts every GEMM the step dispatches. The fused decoder's CUDA kernels
launch through ctypes, where no counter sees them, so
:class:`~gfedntm_tpu_torch.ops.fused_decoder.ProdLDAReconLoss` reports its
model FLOPs itself through :func:`add_model_flops` (2·B·K·V for the
forward's ``theta @ beta``, 4·B·K·V for the backward's two products) and
counts nothing inside: the kernels' recomputation is not model work, and on
the CPU its plain versions would otherwise add their own GEMMs. A step
therefore counts the same on the CPU and on the card, fused or unfused. The
count is the model's GEMM FLOPs; XLA's also holds elementwise work, so the
JAX number for the same step is larger (about 1.18x at V=2,000, K=20,
H=(64, 64), B=64).

The peak side is the card's published dense BF16 tensor-core rate
(:data:`NOMINAL_PEAK_FLOPS`, keyed on the card's name as :data:`CARD_PEAKS`
is), since the JAX module divides by its chip's bf16 peak too;
on any other card and on the CPU, a live float32 ``torch.matmul`` probe.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

#: Dense (no sparsity) BF16 tensor-core peaks by card, FLOP/s (NVIDIA data
#: sheets: half their sparse figures). Keys are matched against the card's
#: name in this order, so the SXM part ("H100") is the fallback of its kind.
NOMINAL_PEAK_FLOPS: dict[str, float] = {
    "H100 NVL": 835.5e12,
    "H100 PCIe": 756.5e12,
    "H200": 989.4e12,
    "H100": 989.4e12,
}

#: Published peaks by card (NVIDIA data sheets; dense, no sparsity: half the
#: sheets' sparse tensor-core figures): memory bytes/s, FP32 FLOP/s on the
#: CUDA cores, and TF32 FLOP/s on the tensor cores. Keys are matched against
#: the nvidia-smi name in this order; the SXM part is the default.
CARD_PEAKS = (
    ("H100 NVL", 3.9e12, 60e12, 417.5e12),
    ("H100 PCIe", 2.0e12, 51e12, 378e12),
    ("H200", 4.8e12, 67e12, 495e12),
    ("H100", 3.35e12, 67e12, 495e12),
)


def card_peaks(name: str) -> tuple[float, float, float, str]:
    """(bytes/s, FP32 FLOP/s, TF32 FLOP/s, matched key) of the card named
    ``name`` in :data:`CARD_PEAKS`; the H100 SXM's for any other name."""
    for key, bw, simt, tf32 in CARD_PEAKS:
        if key in name:
            return bw, simt, tf32, key
    return (*CARD_PEAKS[-1][1:], "H100 (assumed)")


_peak_cache: dict[str, float] = {}
_active = threading.local()


def add_model_flops(n: float) -> None:
    """Add ``n`` FLOPs to the measurement running on this thread, if any:
    the hook of work that no dispatch counter sees (the fused decoder's
    kernels)."""
    extra = getattr(_active, "extra", None)
    if extra is not None:
        extra[0] += float(n)


def counting() -> bool:
    """True while :func:`measure_step_flops` runs on this thread."""
    return getattr(_active, "extra", None) is not None


@contextlib.contextmanager
def uncounted():
    """Suspend the dispatch counter inside a body whose FLOPs are reported
    through :func:`add_model_flops` instead. Outside a measurement it does
    nothing."""
    if not counting():
        yield
        return
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        yield


def measure_step_flops(step_fn, *args, **kwargs) -> float:
    """FLOPs of one call of ``step_fn(*args, **kwargs)``: every GEMM it
    dispatches (:class:`~torch.utils.flop_counter.FlopCounterMode`) plus
    what :func:`add_model_flops` reports. The call runs for real, so pass
    it state it may change (a replica of the model)."""
    from torch.utils.flop_counter import FlopCounterMode

    _active.extra = [0.0]
    try:
        with FlopCounterMode(display=False) as counter:
            step_fn(*args, **kwargs)
        return float(counter.get_total_flops()) + _active.extra[0]
    finally:
        _active.extra = None


def measure_peak_flops_per_device(device: torch.device, n: int = 1024,
                                  repeats: int = 3) -> float | None:
    """Live float32 matmul peak of ``device`` (FLOP/s): the best of
    ``repeats`` timed ``[n, n] @ [n, n]`` products, TF32 off. Cached per
    device."""
    key = str(device)
    if key in _peak_cache:
        return _peak_cache[key]
    cuda = device.type == "cuda"
    allow = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        a = torch.ones((n, n), dtype=torch.float32, device=device)
        torch.matmul(a, a)  # warm-up (and cuBLAS handle creation)
        best = float("inf")
        for _ in range(repeats):
            if cuda:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            torch.matmul(a, a)
            if cuda:
                torch.cuda.synchronize(device)
            best = min(best, time.perf_counter() - t0)
        peak = 2.0 * n * n * n / best
    except RuntimeError:  # no usable device: the MFU is reported unavailable
        return None
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    _peak_cache[key] = peak
    return peak


def resolve_peak_flops_per_device(device) -> tuple[float | None, str]:
    """(peak FLOP/s per device, source) for an MFU denominator: the
    published nominal peak of a known card (``"nominal-spec"``), else a
    live matmul probe (``"measured-matmul-probe"``), else ``(None,
    "unavailable")``."""
    device = torch.device(device)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        for key, peak in NOMINAL_PEAK_FLOPS.items():
            if key in name:
                return peak, "nominal-spec"
    peak = measure_peak_flops_per_device(device)
    if peak is not None:
        return peak, "measured-matmul-probe"
    return None, "unavailable"


def mfu(
    flops_per_call: float | None,
    seconds_per_call: float,
    n_devices: int,
    peak_per_device: float | None,
) -> float | None:
    """Model FLOPs utilization: achieved FLOP/s per device over the peak.

    ``flops_per_call`` is the whole call's work over all devices, so the
    per-device rate is ``flops / seconds / n_devices``."""
    if (
        flops_per_call is None
        or peak_per_device is None
        or seconds_per_call <= 0.0
        or n_devices < 1
    ):
        return None
    return flops_per_call / seconds_per_call / n_devices / peak_per_device
