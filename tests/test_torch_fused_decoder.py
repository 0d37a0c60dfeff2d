"""The port's fused ProdLDA decode + loss on the CPU — the autograd function
over the kernels' plain versions, and the plain versions themselves —
against the JAX package's Pallas ``prodlda_recon_loss`` (interpret mode)
and its unfused reference, on the cases ``tests/test_ops.py`` pins:
multi-tile, masked rows, all-masked rows, V not a multiple of the tile, a
weighted cotangent, training and eval.

Tolerance: rtol 1e-4, and atol 1e-5 scaled by max(1, max|expected|)
(float32 on both sides; the sums over V and B run in different orders, and
an entry near zero that sums terms as large as the largest entry keeps
their absolute error, not a relative one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfedntm_tpu.ops.fused_decoder import prodlda_recon_loss as j_fused
from gfedntm_tpu.ops.fused_decoder import prodlda_recon_loss_reference as j_reference
from gfedntm_tpu_torch.ops import fused_decoder as fd

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture
def multi_tile(monkeypatch):
    """JAX kernels on 128-wide V tiles, so every V here spans several."""
    monkeypatch.setenv("GFEDNTM_FUSED_TILE_V", "128")


def make_inputs(b, k, v, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, k))
    theta = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return dict(
        theta=theta.astype(np.float32),
        beta=rng.normal(size=(k, v)).astype(np.float32),
        x=rng.integers(0, 4, size=(b, v)).astype(np.float32),
        run_mean=(rng.normal(size=(v,)) * 0.1).astype(np.float32),
        run_var=rng.uniform(0.5, 2.0, size=(v,)).astype(np.float32),
    )


def close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale, err_msg=err_msg)


def run_port(fn, t, mask, training, weight):
    theta = torch.from_numpy(t["theta"]).requires_grad_(True)
    beta = torch.from_numpy(t["beta"]).requires_grad_(True)
    mask_t = None if mask is None else torch.from_numpy(mask)
    rl, mean, var = fn(theta, beta, torch.from_numpy(t["x"]),
                       torch.from_numpy(t["run_mean"]), torch.from_numpy(t["run_var"]),
                       mask_t, training)
    m = torch.ones_like(rl) if mask_t is None else mask_t
    (rl * m * torch.from_numpy(weight)).sum().backward()
    return rl, mean, var, theta.grad, beta.grad


def run_jax(fn, t, mask, training, weight, **kw):
    x = jnp.asarray(t["x"])
    rm, rv = jnp.asarray(t["run_mean"]), jnp.asarray(t["run_var"])
    mask_j = None if mask is None else jnp.asarray(mask)
    m = 1.0 if mask is None else jnp.asarray(mask)

    def total(th, be):
        rl, _, _ = fn(th, be, x, rm, rv, mask_j, training, **kw)
        return jnp.sum(rl * m * jnp.asarray(weight))

    rl, mean, var = fn(jnp.asarray(t["theta"]), jnp.asarray(t["beta"]), x, rm, rv,
                       mask_j, training, **kw)
    g_theta, g_beta = jax.grad(total, argnums=(0, 1))(
        jnp.asarray(t["theta"]), jnp.asarray(t["beta"]))
    return rl, mean, var, g_theta, g_beta


def assert_parity(port, want, real_rows=None):
    rows = slice(None) if real_rows is None else real_rows
    close(port[0][rows], np.asarray(want[0])[rows], err_msg="rl")
    for got, exp, name in zip(port[1:], want[1:], ("mean", "var", "g_theta", "g_beta")):
        close(got, exp, err_msg=name)


CASES = {  # (b, k, v, mask, weighted)
    "plain": (12, 7, 300, None, False),
    "k8": (8, 8, 128, None, False),
    "ragged_v": (5, 3, 515, None, False),
    "wide": (16, 8, 1000, None, False),
    "masked": (10, 5, 260, np.array([1, 1, 1, 0, 1, 1, 0, 1, 1, 1], np.float32), False),
    "weighted": (10, 6, 300, None, True),
    "all_masked": (8, 4, 140, np.zeros(8, np.float32), False),
    "b64_v3001": (64, 8, 3001, (np.arange(64) % 7 != 0).astype(np.float32), True),
}


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_autograd_function_matches_pallas_interpret(case, training, multi_tile):
    b, k, v, mask, weighted = CASES[case]
    t = make_inputs(b, k, v, seed=len(case))
    weight = (np.linspace(0.1, 2.0, b) if weighted else np.ones(b)).astype(np.float32)
    port = run_port(fd.prodlda_recon_loss, t, mask, training, weight)
    want = run_jax(j_fused, t, mask, training, weight, interpret=True)
    assert_parity(port, want)
    assert np.isfinite(port[0].detach().numpy()).all()


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", ["plain", "ragged_v", "masked", "weighted", "b64_v3001"])
def test_autograd_function_matches_jax_reference(case, training):
    b, k, v, mask, weighted = CASES[case]
    t = make_inputs(b, k, v, seed=len(case))
    weight = (np.linspace(0.1, 2.0, b) if weighted else np.ones(b)).astype(np.float32)
    port = run_port(fd.prodlda_recon_loss, t, mask, training, weight)
    want = run_jax(j_reference, t, mask, training, weight)
    # The reference's rl on masked rows is a real loss; the fused path's is
    # a finite placeholder that callers zero.
    assert_parity(port, want, None if mask is None else mask > 0)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", ["plain", "masked", "weighted"])
def test_port_reference_matches_jax_reference(case, training):
    b, k, v, mask, weighted = CASES[case]
    t = make_inputs(b, k, v, seed=len(case))
    weight = (np.linspace(0.1, 2.0, b) if weighted else np.ones(b)).astype(np.float32)
    port = run_port(fd.prodlda_recon_loss_reference, t, mask, training, weight)
    assert_parity(port, run_jax(j_reference, t, mask, training, weight))


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_plain_versions_step_by_step(training):
    """stats -> loss -> grads by hand equals the autograd function, and the
    softmax stats are the row max and denominator over valid rows."""
    b, k, v = 9, 5, 200
    t = {n: torch.from_numpy(a) for n, a in make_inputs(b, k, v, seed=7).items()}
    mask = torch.tensor([1, 1, 0, 1, 1, 1, 0, 1, 1], dtype=torch.float32)
    mean, var, m, s = fd.stats_reference(t["theta"], t["beta"], mask, t["run_mean"],
                                         t["run_var"], training)
    n = (t["theta"] @ t["beta"] - mean) * torch.rsqrt(var + 1e-5)
    real = mask > 0
    close(m[real], n[real].max(1).values.numpy())
    close(torch.log(s[real]) + m[real], torch.logsumexp(n[real], 1).numpy())
    assert torch.all(m[~real] == -1e30) and torch.all(s[~real] == 0)
    if not training:
        assert torch.equal(mean, t["run_mean"]) and mean is not t["run_mean"]
    rl, rd = fd.loss_reference(t["theta"], t["beta"], t["x"], mean, var, m, s)
    assert torch.all(rl[~real] == 0)
    g = torch.linspace(0.5, 1.5, b) * mask
    g_theta, g_beta = fd.grads_reference(t["theta"], t["beta"], t["x"], mean, var, m, s,
                                         rd, g, mask, training)
    theta = t["theta"].clone().requires_grad_(True)
    beta = t["beta"].clone().requires_grad_(True)
    rl2, _, _ = fd.prodlda_recon_loss(theta, beta, t["x"], t["run_mean"], t["run_var"],
                                      mask, training)
    (rl2 * g).sum().backward()
    close(rl2, rl.numpy(), rtol=0, atol=0)
    close(theta.grad, g_theta.numpy(), rtol=0, atol=0)
    close(beta.grad, g_beta.numpy(), rtol=0, atol=0)


def test_stats_outputs_carry_no_gradient():
    t = {n: torch.from_numpy(a) for n, a in make_inputs(8, 4, 130).items()}
    theta = t["theta"].clone().requires_grad_(True)
    _, mean, var = fd.prodlda_recon_loss(theta, t["beta"], t["x"], t["run_mean"],
                                         t["run_var"])
    assert not mean.requires_grad and not var.requires_grad


def test_wrappers_check_shapes_before_launch():
    t = {n: torch.from_numpy(a) for n, a in make_inputs(4, 3, 20).items()}
    with pytest.raises(ValueError, match="x must be"):
        fd._check_inputs("loss", t["theta"], t["beta"], x=t["x"][:, :10])
    with pytest.raises(TypeError, match="float32"):
        fd._check_inputs("stats", t["theta"].double(), t["beta"])
    with pytest.raises(ValueError, match="contiguous"):
        fd._check_inputs("grads", t["theta"], t["beta"], x=t["x"].T.contiguous().T)
