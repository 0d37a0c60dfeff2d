"""The port on the GPU: the CUDA kernels against their plain versions, and a
small federated fit through them. Marked ``cuda``; each test skips where no
CUDA device is present (run them on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -q``).

Tolerance: |kernel - plain| <= 1e-5 + 1e-4 * max|plain| per output (both
float32; the plain version's products run through cuBLAS in another order).
"""

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
        "stats": 12, "loss": 12, "grads": 12, "vsharded": 0}
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
