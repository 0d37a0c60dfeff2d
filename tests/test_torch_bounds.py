"""The bounds ``chip_smoke.py`` reports beside each kernel's time.

A kernel's bound is the least time the card could take for its work: the
larger of the bytes it must move over the memory rate and its FP32-accurate
FLOPs as three TF32 products (3xTF32) over the tensor cores' dense TF32
rate. The FP32 SIMT bound (the FLOPs over the CUDA cores' FP32 rate) stays in
the notes; a tensor-core kernel may run under it, never under the bound.
With bf16 storage beta and x are read as 2 bytes a value, and a product
with beta (exact in TF32) takes two TF32 products: K1 2, K2 2, K3 7 of its
three GEMMs' 9.
Figures: H100 SXM data sheet (3.35 TB/s, 67 TFLOP/s FP32, 495 TFLOP/s dense
TF32). The script is imported by path; it imports torch only inside the
functions that run on the card.
"""

import importlib.util
from pathlib import Path

import pytest

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# (B, K, V): {kernel: (bytes, FLOPs, bound ms, bound by, FP32 SIMT bound ms)}
PINNED = {
    (256, 50, 100_000): {
        "stats": (20_854_272, 2.56e9, 0.0155152, "operations", 0.0382090),
        "loss": (123_255_296, 2.56e9, 0.0367926, "bytes", 0.0382090),
        "grads": (143_307_520, 7.68e9, 0.0465455, "operations", 0.1146269),
    },
    (17, 9, 3001): {  # ragged: nothing divides
        "stats": (132_860, 918_306, 3.96597e-5, "bytes", 3.96597e-5),
        "loss": (336_996, 918_306, 1.005958e-4, "bytes", 1.005958e-4),
        "grads": (445_712, 2_754_918, 1.330484e-4, "bytes", 1.330484e-4),
    },
}


@pytest.mark.parametrize("shape", sorted(PINNED), ids=lambda s: "x".join(map(str, s)))
def test_kernel_work_and_bounds_are_pinned(smoke, shape):
    work = smoke.kernel_work(*shape)
    assert sorted(work) == sorted(PINNED[shape])
    for name, (nbytes, nflops, bound_ms, by, simt_ms) in PINNED[shape].items():
        assert work[name] == (nbytes, nflops), name
        bound = smoke.kernel_bound(*work[name], H100)
        assert bound["bound_ms"] == pytest.approx(bound_ms, rel=1e-5), name
        assert bound["bound_by"] == by, name
        assert bound["simt_bound_ms"] == pytest.approx(simt_ms, rel=1e-5), name


def test_k3_bound_at_the_main_path_is_its_3xtf32_operations(smoke):
    bound = smoke.kernel_bound(*smoke.kernel_work(256, 50, 100_000)["grads"], H100)
    assert bound["bytes_ms"] == pytest.approx(0.0428, abs=1e-4)
    assert bound["ops_ms"] == pytest.approx(0.0465, abs=1e-4)
    assert bound["simt_bound_ms"] == pytest.approx(0.1146, abs=1e-4)


def test_k5_bound_per_rank(smoke):
    nbytes, nflops, coll = smoke.vsharded_work(256, 50, 100_000, 2)
    assert (nbytes, nflops, coll) == (143_927_680, 6.4e9, 110_592)
    bound = smoke.kernel_bound(nbytes, nflops, H100)
    assert bound["bound_by"] == "bytes"
    assert bound["bound_ms"] == pytest.approx(0.0429635, rel=1e-5)
    assert bound["simt_bound_ms"] == pytest.approx(0.0955224, rel=1e-5)


@pytest.mark.parametrize("card", [H100, "NVIDIA H100 NVL", "NVIDIA H100 PCIe",
                                  "NVIDIA H200", "an unknown card"])
@pytest.mark.parametrize("shape", [(256, 50, 100_000), (17, 9, 3001), (320, 50, 99_999),
                                   (1, 1392, 7)])
def test_every_bound_is_at_most_the_fp32_simt_bound(smoke, card, shape):
    works = list(smoke.kernel_work(*shape).values()) + [smoke.vsharded_work(*shape, 1)[:2]]
    for nbytes, nflops in works:
        bound = smoke.kernel_bound(nbytes, nflops, card)
        assert bound["bound_ms"] <= bound["simt_bound_ms"]
        assert bound["bound_ms"] == max(bound["bytes_ms"], bound["ops_ms"])


def test_peaks_follow_the_card_name(smoke):
    assert smoke.peaks(H100) == (3.35e12, 67e12, 495e12, "H100")
    assert smoke.peaks("NVIDIA H100 NVL")[2] == 417.5e12
    assert smoke.peaks("NVIDIA H100 PCIe")[2] == 378e12
    assert smoke.peaks("something else")[3] == "H100 (assumed)"


# bf16 storage, (B, K, V) = (256, 50, 100,000): {kernel: (bytes, bound ms, bound by)}
PINNED_BF16 = {
    "stats": (10_854_272, 0.0103434, "operations"),
    "loss": (62_055_296, 0.0185240, "bytes"),
    "grads": (82_107_520, 0.0362020, "operations"),
}


@pytest.mark.parametrize("name", sorted(PINNED_BF16))
def test_bf16_kernel_work_and_bounds_are_pinned(smoke, name):
    nbytes, bound_ms, by = PINNED_BF16[name]
    work = smoke.kernel_work(256, 50, 100_000, "bfloat16")
    assert work[name] == (nbytes, smoke.kernel_work(256, 50, 100_000)[name][1])
    bound = smoke.kernel_bound(*work[name], H100, smoke.TF32_PRODUCTS["bfloat16"][name])
    assert bound["bound_ms"] == pytest.approx(bound_ms, rel=1e-5)
    assert bound["bound_by"] == by


def test_tf32_products_per_kernel_are_pinned(smoke):
    """The products the bounds charge: 3xTF32 for FP32 storage; with bf16
    beta, two for K1's and K2's z and, for K3, two for z = theta beta and
    two for g_theta = gz beta^T beside three for g_beta = theta^T gz."""
    assert smoke.TF32_PRODUCTS["float32"] == {"stats": 3, "loss": 3, "grads": 3}
    bf16 = smoke.TF32_PRODUCTS["bfloat16"]
    assert (bf16["stats"], bf16["loss"]) == (2, 2)
    assert bf16["grads"] == pytest.approx(7 / 3) and bf16["grads"] == (2 + 2 + 3) / 3


def test_bf16_storage_halves_the_stored_operands_bytes(smoke):
    f32, bf16 = (smoke.kernel_work(17, 9, 3001, s) for s in ("float32", "bfloat16"))
    kv, bv = 9 * 3001, 17 * 3001
    assert f32["stats"][0] - bf16["stats"][0] == 2 * kv
    assert f32["loss"][0] - bf16["loss"][0] == 2 * (kv + bv)
    assert f32["grads"][0] - bf16["grads"][0] == 2 * (kv + bv)  # g_beta stays float32


def test_k5_bf16_bound_per_rank(smoke):
    nbytes, nflops, coll = smoke.vsharded_work(256, 50, 100_000, 2, "bfloat16")
    assert (nbytes, nflops, coll) == (77_727_680, 6.4e9, 110_592)
    assert smoke.vsharded_passes("bfloat16") == pytest.approx(2.2)
    assert smoke.vsharded_passes("float32") == 3
    bound = smoke.kernel_bound(nbytes, nflops, H100, smoke.vsharded_passes("bfloat16"))
    assert bound["bound_by"] == "operations"
    assert bound["bound_ms"] == pytest.approx(0.0284444, rel=1e-5)
