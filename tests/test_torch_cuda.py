"""The port on the GPU: the CUDA kernels against their plain versions, a
small federated fit through them, and the persistence and validation layer
(bitwise resume, save/load, the sharded validation through K5 in eval
mode). Marked ``cuda``; each test skips where no
CUDA device is present (run them on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -q --noconftest``; K1 and K2
alone with ``-k "stats or loss"``, K3 alone with ``-k grads``).

Tolerance: |kernel - plain| <= 1e-5 + 1e-4 * max|plain| per output (both
float32; the plain version's products run through cuBLAS in another order).
The bf16-storage kernels (``-k bf16``) are held to the same tolerance
against the float32 plain versions on the bf16-rounded beta and x, and to
bitwise equality with the float32 kernels on those rounded values where both
take the same route.
"""

import ctypes

import numpy as np
import pytest
import torch

from gfedntm_tpu_torch import AVITM, BowDataset, FederatedTrainer, generate_synthetic_corpus
from gfedntm_tpu_torch.ops import fused_decoder as fd
from gfedntm_tpu_torch.parallel import programs
from gfedntm_tpu_torch.parallel.launch import run_ranks

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def inputs(b, k, v, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    t = dict(
        theta=torch.softmax(torch.randn(b, k, generator=gen), 1),
        beta=torch.randn(k, v, generator=gen),
        x=torch.randint(0, 4, (b, v), generator=gen).float(),
        run_mean=0.1 * torch.randn(v, generator=gen),
        run_var=0.5 + 1.5 * torch.rand(v, generator=gen),
        mask=(torch.arange(b) % 7 != 0).float(),
    )
    return {n: a.to(device) for n, a in t.items()}


def close(got, want):
    for a, b in zip(got, want):
        tol = 1e-5 + 1e-4 * float(b.abs().max())
        assert float((a - b).abs().max()) <= tol


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("b,v", [(64, 3001), (200, 515)])
def test_kernels_match_plain_versions(cuda, b, v, training):
    t = inputs(b, 8, v, cuda)
    st = (t["theta"], t["beta"], t["mask"], t["run_mean"], t["run_var"], training)
    mean, var, m, s = fd.stats_reference(*st)
    close(fd.stats(*st), (mean, var, m, s))
    lo = (t["theta"], t["beta"], t["x"], mean, var, m, s)
    rl, rd = fd.loss_reference(*lo)
    close(fd.loss(*lo), (rl, rd))
    gr = lo + (rd, torch.linspace(0.1, 2.0, b, device=cuda) * t["mask"], t["mask"], training)
    close(fd.grads(*gr), fd.grads_reference(*gr))
    torch.cuda.synchronize()


def grads_case(b, k, v, device, mask_kind="partial", seed=0):
    """K3's inputs: the plain statistics, row-dot and row cotangent of a
    random batch (``mask_kind``: "partial", or "all" rows masked)."""
    t = inputs(b, k, v, device, seed)
    if mask_kind == "all":
        t["mask"].zero_()
    mean, var, m, s = fd.stats_reference(t["theta"], t["beta"], t["mask"], t["run_mean"],
                                         t["run_var"], True)
    rd = fd.loss_reference(t["theta"], t["beta"], t["x"], mean, var, m, s)[1]
    g = torch.linspace(0.1, 2.0, b, device=device) * t["mask"]
    return t, (t["theta"], t["beta"], t["x"], mean, var, m, s, rd, g, t["mask"])


@pytest.mark.parametrize("k", [8, 50])
@pytest.mark.parametrize("b", [1, 17, 256, 320])
@pytest.mark.parametrize("v_mod", [0, 1, 2, 3])
def test_grads_kernels_match_plain_version(cuda, b, k, v_mod):
    """K3 in both ring variants (16-byte cp.async at V % 4 == 0, else 4-byte
    cp.async), both tile widths (B=320, K=50 takes 16 columns), ragged B and
    K, several tiles per block; training and eval."""
    v = 20_000 + v_mod
    _, args = grads_case(b, k, v, cuda, seed=b + k + v_mod)
    for training in (True, False):
        close(fd.grads(*args, training), fd.grads_reference(*args, training))
    torch.cuda.synchronize()


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_grads_kernels_all_masked_batch(cuda, training):
    _, args = grads_case(64, 50, 3001, cuda, mask_kind="all")
    got = fd.grads(*args, training)
    close(got, fd.grads_reference(*args, training))
    assert all(float(t.abs().max()) == 0.0 for t in got)


@pytest.mark.parametrize("v", [100_000, 99_999])
def test_grads_kernels_are_bitwise_repeatable(cuda, v):
    _, args = grads_case(256, 50, v, cuda)
    first = fd.grads(*args, True)
    second = fd.grads(*args, True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _old_grads_smem_floats(b, k):
    """Shared memory, in floats, of the CUDA-core K3 this kernel replaced
    (4-row and 4-topic padding, 32-column strips): every (B, K) it fitted
    must still be accepted."""
    bp, kp = -(-b // 4) * 4, -(-k // 4) * 4
    return 2 * bp * kp + kp * 33 + 2 * bp * 32 + 5 * b + 4 * 32 + 2 * 8 * 32 + 1


def test_grads_kernels_accept_every_batch_the_old_kernel_took(cuda):
    from gfedntm_tpu_torch.ops import _build

    lib = _build.load()
    grid, smem, limit = ctypes.c_int(0), ctypes.c_longlong(0), ctypes.c_longlong(0)
    assert lib.fd_plan(2, 1, 1, 1, ctypes.byref(grid), ctypes.byref(smem),
                       ctypes.byref(limit)) == 0
    limit = limit.value // 4
    for k in (1, 8, 9, 25, 50, 64, 100, 241, 500, 1000):
        b_max = max(b for b in range(1, 2000) if _old_grads_smem_floats(b, k) <= limit)
        for b in (1, b_max // 2, b_max):
            assert fd._plan(lib, "grads", b, k, 100_000) > 0, (b, k)
    assert fd._plan(lib, "grads", 320, 50, 100_000) > 0
    refused = next(b for b in range(320, 2000)
                   if _grads_refused(lib, b, 50))
    _, args = grads_case(refused, 50, 300, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fd.grads(*args, True)


def _grads_refused(lib, b, k):
    try:
        fd._plan(lib, "grads", b, k, 300)
    except ValueError:
        return True
    return False


def close_stats(got, want):
    """``close`` with the softmax-max sentinels (-1e30, fully-masked rows)
    exact and left out of the scale."""
    for a, b in zip(got, want):
        sentinel = b.abs() >= 1e29
        assert torch.equal(a[sentinel], b[sentinel])
        if (~sentinel).any():
            close([a[~sentinel]], [b[~sentinel]])


def check_stats_and_loss(t, training):
    """K1 and K2 against their plain versions; K2 takes the plain statistics."""
    st = (t["theta"], t["beta"], t["mask"], t["run_mean"], t["run_var"], training)
    want = fd.stats_reference(*st)
    got = fd.stats(*st)
    close_stats(got, want)
    lo = (t["theta"], t["beta"], t["x"]) + tuple(want)
    got_loss = fd.loss(*lo)
    close(got_loss, fd.loss_reference(*lo))
    torch.cuda.synchronize()
    return got, got_loss


@pytest.mark.parametrize("k", [8, 50])
@pytest.mark.parametrize("b", [1, 17, 256, 320])
@pytest.mark.parametrize("v_mod", [0, 1, 2, 3])
def test_stats_and_loss_kernels_match_plain_versions(cuda, b, k, v_mod):
    """K1 and K2 in both ring variants (16-byte cp.async at V % 4 == 0, else
    4-byte cp.async), both tile widths (B=320 takes 16 columns), ragged B and
    K, several tiles per block; training and eval."""
    t = inputs(b, k, 20_000 + v_mod, cuda, seed=b + k + v_mod)
    for training in (True, False):
        check_stats_and_loss(t, training)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_stats_and_loss_kernels_all_masked_batch(cuda, training):
    t = inputs(64, 50, 3001, cuda)
    t["mask"].zero_()
    (mean, var, m, s), (rl, rd) = check_stats_and_loss(t, training)
    assert bool((m == -1e30).all()) and bool((s == 0).all())
    assert bool((rl == 0).all()) and bool(torch.isfinite(rd).all())


@pytest.mark.parametrize("v", [100_000, 99_999])
def test_stats_and_loss_kernels_are_bitwise_repeatable(cuda, v):
    t = inputs(256, 50, v, cuda)
    st = (t["theta"], t["beta"], t["mask"], t["run_mean"], t["run_var"], True)
    first, second = fd.stats(*st), fd.stats(*st)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    lo = (t["theta"], t["beta"], t["x"]) + tuple(first)
    assert all(torch.equal(a, b) for a, b in zip(fd.loss(*lo), fd.loss(*lo)))


def _old_fwd_smem_floats(kind, b, k):
    """Shared memory, in floats, of the CUDA-core K1 and K2 of the first port
    (4-row and 4-topic padding, 32-column strips), which still take the
    batches the tensor-core layouts do not: every (B, K) they fitted must
    still be accepted."""
    bp, kp = -(-b // 4) * 4, -(-k // 4) * 4
    if kind == "stats":
        return bp * kp + kp * 33 + bp * 32 + 3 * b + 8 * 32 + 2 * 32 + 1
    return bp * kp + kp * 33 + 5 * b + 2 * 32


TOPICS = (1, 8, 9, 25, 50, 64, 100, 241, 500, 1000)


def test_stats_and_loss_kernels_accept_every_batch_the_old_kernels_took(cuda):
    from gfedntm_tpu_torch.ops import _build

    lib = _build.load()
    grid, smem, limit = ctypes.c_int(0), ctypes.c_longlong(0), ctypes.c_longlong(0)
    assert lib.fd_plan(0, 1, 1, 1, ctypes.byref(grid), ctypes.byref(smem),
                       ctypes.byref(limit)) == 0
    limit = limit.value // 4
    for kind in ("stats", "loss"):
        for k in TOPICS:
            b_max = max(b for b in range(1, 8000) if _old_fwd_smem_floats(kind, b, k) <= limit)
            for b in (1, b_max // 2, b_max):
                assert fd._route(lib, kind, b, k) >= 0, (kind, b, k)
                assert fd._plan(lib, kind, b, k, 100_000) > 0, (kind, b, k)


def test_stats_and_loss_tensor_core_routes_cover_every_batch_k3_takes(cuda):
    from gfedntm_tpu_torch.ops import _build

    lib = _build.load()
    for k in TOPICS:
        for b in range(1, 1100):
            if fd._route(lib, "grads", b, k) < 0:
                continue
            for kind in ("stats", "loss"):
                assert fd._route(lib, kind, b, k) in (16, 32), (kind, b, k)


@pytest.mark.parametrize("kind,k", [("stats", 8), ("loss", 8), ("loss", 50)])
def test_stats_and_loss_kernels_on_the_cuda_core_route(cuda, kind, k):
    """The first batch past the tensor-core layouts takes the CUDA-core
    kernel, chosen by shape alone, and matches the plain version."""
    from gfedntm_tpu_torch.ops import _build

    lib = _build.load()
    b = next(b for b in range(1, 8000) if fd._route(lib, kind, b, k) == 0)
    assert fd._route(lib, kind, b - 1, k) in (16, 32)
    t = inputs(b, k, 3001, cuda)
    for training in (True, False):
        check_stats_and_loss(t, training)


def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    t = inputs(16, 4, 300, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fd.loss(t["theta"], t["beta"], t["x"].T.contiguous().T, t["run_mean"],
                t["run_var"], t["mask"], t["mask"])
    with pytest.raises(ValueError, match="shared memory"):
        big = inputs(4096, 64, 300, cuda)
        fd.stats(big["theta"], big["beta"], big["mask"], big["run_mean"],
                 big["run_var"], True)


def test_federated_fit_runs_through_the_kernels(cuda):
    corpus = generate_synthetic_corpus(vocab_size=500, n_topics=6, n_docs=48, n_nodes=2,
                                       nwords=(30, 60), seed=0, materialize_docs=False)
    datasets = [BowDataset(X=n.bow) for n in corpus.nodes]
    template = AVITM(input_size=500, n_components=6, hidden_sizes=(17, 13),
                     batch_size=16, num_epochs=2)
    assert template.device.type == "cuda"
    trainer = FederatedTrainer(template, n_clients=2)
    before = dict(fd.LAUNCHES)
    result = trainer.fit(datasets)
    assert {k: fd.LAUNCHES[k] - before[k] for k in before} == {
        "stats": 12, "loss": 12, "grads": 12, "vsharded": 0,
        "stats_bf16": 0, "loss_bf16": 0, "grads_bf16": 0, "vsharded_bf16": 0}
    assert np.isfinite(result.losses).all()
    for key, value in result.client_params[0].items():
        assert torch.equal(value, result.client_params[1][key]), key


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_vsharded_op_matches_full_kernels(cuda, training):
    """K5 over mp=2 gloo ranks on the first card against the single-device
    kernels on the full tensors."""
    b, v = 64, 3002
    t = inputs(b, 8, v, cuda)
    g = torch.linspace(0.1, 2.0, b, device=cuda) * t["mask"]
    theta = t["theta"].clone().requires_grad_(True)
    beta = t["beta"].clone().requires_grad_(True)
    rl, mean, var = fd.prodlda_recon_loss(theta, beta, t["x"], t["run_mean"], t["run_var"],
                                          t["mask"], training)
    (rl * g).sum().backward()
    case = {**{n: a.cpu().numpy() for n, a in t.items()}, "g": g.cpu().numpy(),
            "training": training}
    res = run_ranks(programs.vsharded_op, 2, "gloo", ["cuda:0", "cuda:0"], 300,
                    args=(1, 2, [case]))
    ranks = [r[0]["kernel"] for r in res]
    got = [torch.from_numpy(a).to(cuda) for a in (
        ranks[0]["rl"], np.concatenate([r["mean"] for r in ranks]),
        np.concatenate([r["var"] for r in ranks]), ranks[0]["g_theta"],
        np.concatenate([r["g_beta"] for r in ranks], axis=1))]
    close(got, (rl, mean, var, theta.grad, beta.grad))


# ---------------------------------------------------------------------------
# bf16 storage
# ---------------------------------------------------------------------------
BF = "bfloat16"


def check_bf16(t, training, lib, kinds=("stats", "loss", "grads")):
    """``kinds`` of K1, K2 and K3 on bf16 beta and x against the plain
    versions on the rounded values (K2 and K3 take the plain statistics),
    and bitwise against the FP32 kernels on those values where both take
    the same route."""
    b, k = t["theta"].shape
    beta_r, x_r = t["beta"].to(torch.bfloat16).float(), t["x"].to(torch.bfloat16).float()
    beta_b, x_b = t["beta"].to(torch.bfloat16), t["x"].to(torch.bfloat16)
    st = (t["theta"], beta_r, t["mask"], t["run_mean"], t["run_var"], training)
    want = fd.stats_reference(*st)
    lo = (t["theta"], beta_r, x_r) + tuple(want)
    rl, rd = fd.loss_reference(*lo)
    rest = tuple(want) + (rd, torch.linspace(0.1, 2.0, b, device=rd.device) * t["mask"],
                          t["mask"], training)
    runs = {
        "stats": (lambda: fd.stats(t["theta"], beta_b, *st[2:], storage_dtype=BF),
                  lambda: fd.stats(*st), close_stats, want),
        "loss": (lambda: fd.loss(t["theta"], beta_b, x_b, *want, storage_dtype=BF),
                 lambda: fd.loss(*lo), close, (rl, rd)),
        "grads": (lambda: fd.grads(t["theta"], beta_b, x_b, *rest, storage_dtype=BF),
                  lambda: fd.grads(*lo[:3], *rest), close,
                  fd.grads_reference(*lo[:3], *rest)),
    }
    got = {}
    for name in kinds:
        kernel, fp32, compare, plain = runs[name]
        got[name] = kernel()
        compare(got[name], plain)
        if fd._route(lib, name, b, k, BF) == fd._route(lib, name, b, k):
            assert all(torch.equal(a, c) for a, c in zip(got[name], fp32())), name
    torch.cuda.synchronize()
    return got


@pytest.fixture
def lib(cuda):
    from gfedntm_tpu_torch.ops import _build

    return _build.load()


@pytest.mark.parametrize("k", [8, 50])
@pytest.mark.parametrize("b", [1, 17, 256, 320])
@pytest.mark.parametrize("v_mod", [0, 1, 3, 7])
def test_bf16_kernels_match_plain_versions(cuda, lib, b, k, v_mod):
    """K1-K3 on bf16 beta and x at ragged B and K, V % 8 from 0 to 7 (the
    wrapper pads the pitch), both tile widths; training and eval."""
    t = inputs(b, k, 20_000 + v_mod, cuda, seed=b + k + v_mod)
    for training in (True, False):
        check_bf16(t, training, lib)


@pytest.mark.parametrize("kind", ["stats", "loss", "grads"])
@pytest.mark.parametrize("k", [8, 50])
def test_bf16_route_boundaries(cuda, lib, kind, k):
    """Both sides of every bf16 route boundary of each kernel (64 -> 16
    columns for K1 and K2, 32 -> 16 for K3, then 16 -> CUDA cores, or
    refused for K3), chosen by shape."""
    seen = []
    prev = fd._route(lib, kind, 1, k, BF)
    for b in range(2, 1200):
        r = fd._route(lib, kind, b, k, BF)
        if r != prev:
            seen.append((b, prev, r))
            prev = r
    first = (32, 16) if kind == "grads" else (64, 16)
    assert seen and seen[0][1:] == first, seen
    for b, before, after in seen:
        for bb, route in ((b - 1, before), (b, after)):
            if route < 0:
                with pytest.raises(ValueError, match="shared memory"):
                    check_bf16(inputs(bb, k, 300, cuda), True, lib, (kind,))
                continue
            t = inputs(bb, k, 3001, cuda, seed=bb)
            for training in (True, False):
                check_bf16(t, training, lib, (kind,))


@pytest.mark.parametrize("b,k,routes", [
    (256, 50, (64, 64)), (256, 80, (64, 64)), (256, 88, (64, 16)), (256, 144, (64, 0)),
    (200, 57, (64, 64)), (1, 3, (64, 64)), (257, 50, (16, 16)), (64, 160, (32, 32)),
])
def test_bf16_wide_tiles_at_their_boundaries(cuda, lib, b, k, routes):
    """bf16 K1 and K2 on 64-column tiles (B <= 256 where the layout fits:
    K2 to K=80 at B=256, K1 to K=144) and just past them, against the plain
    versions in training and eval, V % 64 != 0; K1's mean on 64-column tiles
    bitwise the FP32 K1's on the rounded beta where that takes 32 columns
    (z and the column sums' order kept)."""
    assert (fd._route(lib, "stats", b, k, BF), fd._route(lib, "loss", b, k, BF)) == routes
    t = inputs(b, k, 3001 if k > 100 else 20_001, cuda, seed=b + k)
    for training in (True, False):
        got = check_bf16(t, training, lib, ("stats", "loss"))
        if training and routes[0] == 64 and fd._route(lib, "stats", b, k) == 32:
            beta_r = t["beta"].to(torch.bfloat16).float()
            fp32 = fd.stats(t["theta"], beta_r, t["mask"], t["run_mean"], t["run_var"], True)
            assert torch.equal(got["stats"][0], fp32[0])


def test_bf16_wide_loss_on_sparse_documents(cuda, lib):
    """K2 on 64-column tiles over a batch of 0.2%-dense counts (the main
    path's documents), with rows and whole eight-column groups of zeros,
    against the plain version; and the same counts at 0, 1 and 8 nonzero
    columns a row."""
    gen = torch.Generator().manual_seed(5)
    for density in (0.002, 0.0):
        t = inputs(256, 50, 20_001, cuda, seed=11)
        keep = (torch.rand(256, 20_001, generator=gen) < density).to(cuda)
        t["x"] = t["x"] * keep
        t["x"][3, 17] = 2.0  # one count alone in its row
        t["x"][4, 64:72] = 1.0  # a whole eight-column group
        check_bf16(t, True, lib, ("stats", "loss"))


def test_bf16_loss_tensor_cores_hold_batches_past_fp32(cuda, lib):
    """Half-size x stages: bf16 K2 keeps the tensor cores at K=50 for
    batches where FP32 K2 takes the CUDA cores."""
    b = next(b for b in range(256, 1100) if fd._route(lib, "loss", b, 50) == 0)
    assert fd._route(lib, "loss", b, 50, BF) == 16
    check_bf16(inputs(b, 50, 3001, cuda), True, lib, ("loss",))


@pytest.mark.parametrize("v", [100_000, 99_999])
def test_bf16_kernels_at_the_main_path_shape(cuda, lib, v):
    """B=256, K=50 at V=100,000 and V=99,999 (padded pitch): plain, bitwise
    FP32 on the rounded values, repeatable, and the same outputs from a
    pitched view as from a plain contiguous bf16 tensor."""
    t = inputs(256, 50, v, cuda)
    first = check_bf16(t, True, lib)
    again = check_bf16(t, True, lib)
    for name in first:
        assert all(torch.equal(a, c) for a, c in zip(first[name], again[name])), name
    pitched = fd.store(t["beta"], BF)
    assert pitched.stride(0) % 8 == 0 and pitched.stride(0) >= v
    got = fd.stats(t["theta"], pitched, t["mask"], t["run_mean"], t["run_var"], True,
                   storage_dtype=BF)
    assert all(torch.equal(a, c) for a, c in zip(got, first["stats"]))


def test_bf16_wrappers_refuse_float32_operands(cuda):
    t = inputs(16, 4, 300, cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        fd.stats(t["theta"], t["beta"], t["mask"], t["run_mean"], t["run_var"], True,
                 storage_dtype=BF)


def test_bf16_federated_fit_runs_through_the_bf16_kernels(cuda):
    corpus = generate_synthetic_corpus(vocab_size=501, n_topics=6, n_docs=48, n_nodes=2,
                                       nwords=(30, 60), seed=0, materialize_docs=False)
    datasets = [BowDataset(X=n.bow) for n in corpus.nodes]
    template = AVITM(input_size=501, n_components=6, hidden_sizes=(17, 13),
                     batch_size=16, num_epochs=2, compute_dtype=BF)
    trainer = FederatedTrainer(template, n_clients=2)
    before = dict(fd.LAUNCHES)
    result = trainer.fit(datasets)
    assert {k: fd.LAUNCHES[k] - before[k] for k in before} == {
        "stats": 0, "loss": 0, "grads": 0, "vsharded": 0,
        "stats_bf16": 12, "loss_bf16": 12, "grads_bf16": 12, "vsharded_bf16": 0}
    assert np.isfinite(result.losses).all()
    for key, value in result.client_params[0].items():
        assert value.dtype == torch.float32
        assert torch.equal(value, result.client_params[1][key]), key


# ---------------------------------------------------------------------------
# Persistence and validation
# ---------------------------------------------------------------------------
def small_corpus(n_docs, n_nodes, seed=0):
    corpus = generate_synthetic_corpus(vocab_size=500, n_topics=6, n_docs=n_docs,
                                       n_nodes=n_nodes, nwords=(30, 60), seed=seed,
                                       materialize_docs=False)
    return [BowDataset(X=n.bow) for n in corpus.nodes]


class Interrupt(Exception):
    pass


@pytest.mark.parametrize("compute_dtype", ["float32", BF])
def test_federated_resume_is_bitwise_on_the_card(cuda, tmp_path, compute_dtype):
    datasets = small_corpus(48, 2)

    def trainer():
        return FederatedTrainer(AVITM(input_size=500, n_components=6, hidden_sizes=(17, 13),
                                      batch_size=16, num_epochs=2,
                                      compute_dtype=compute_dtype), n_clients=2)

    full = trainer().fit(datasets)

    def interrupt(step, params, batch_stats):
        if step == 2:
            raise Interrupt

    with pytest.raises(Interrupt):
        trainer().fit(datasets, checkpoint_dir=str(tmp_path), checkpoint_every=1,
                      segment_callback=interrupt)
    resumed = trainer().fit(datasets, checkpoint_dir=str(tmp_path), checkpoint_every=1,
                            resume=True)
    np.testing.assert_array_equal(resumed.losses, full.losses)
    for c in range(2):
        for key, value in full.client_params[c].items():
            assert resumed.client_params[c][key].device.type == "cuda"
            assert torch.equal(resumed.client_params[c][key], value), key


def test_save_and_load_round_trip_on_the_card(cuda, tmp_path):
    train, val = small_corpus(64, 2)
    model = AVITM(input_size=500, n_components=6, hidden_sizes=(17, 13), batch_size=16,
                  num_epochs=2)
    model.fit(train, val, n_samples=2)
    assert len(model.validation_losses) == 2 and np.isfinite(model.validation_losses).all()
    model.save(str(tmp_path))
    fresh = AVITM(input_size=500, n_components=6, hidden_sizes=(17, 13), batch_size=16)
    fresh.load(str(tmp_path), model.nn_epoch)
    for key, value in model.model.state_dict().items():
        got = fresh.model.state_dict()[key]
        assert got.device.type == "cuda" and torch.equal(got, value), key
    np.testing.assert_array_equal(fresh.get_topic_word_matrix(), model.get_topic_word_matrix())


def test_sharded_validation_runs_k5_in_eval_mode(cuda, tmp_path):
    """fit_sharded with validation over mp=2 gloo ranks on the first card:
    one eval-mode K1 and K5 launch per validation step, K3 only for the
    training steps, and each validation loss equal to the unsharded eval
    teacher-forced from the same state, generator state and schedule."""
    X = small_corpus(64, 1)[0].X
    Xv = small_corpus(16, 1, seed=1)[0].X
    kw = dict(input_size=500, n_components=6, hidden_sizes=(17, 13), batch_size=16,
              num_epochs=2, dropout=0.0)
    res = run_ranks(programs.fit, 2, "gloo", ["cuda:0", "cuda:0"], 300,
                    args=(1, 2, kw, X, None, 1, 0, Xv, str(tmp_path), 5, 0.0))
    for r in res:
        assert r["launches"]["grads"] == 8
        assert r["launches"]["stats"] == r["launches"]["vsharded"] == 8 + 2
        assert r["eval_launches"]["stats"] == r["eval_launches"]["vsharded"] == 2
        assert r["validation_losses"] == res[0]["validation_losses"]
    for record in res[0]["validations"]:
        replay = programs.replay_validation(AVITM(**kw), Xv, record)
        assert replay == pytest.approx(record["val_loss"], rel=1e-5)
