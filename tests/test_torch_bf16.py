"""bf16 compute (``compute_dtype="bfloat16"``) on the CPU: the port against
the JAX package on the same numpy-seeded inputs, through the plain versions
of the bf16 kernels (the float32 plain versions on bf16-rounded beta and x).

Tolerances, each with its reason:

- fused loss, port vs JAX ``prodlda_recon_loss(..., storage_dtype="bfloat16",
  interpret=True)``: both compute in float32 on the same bf16-rounded beta
  and x and differ only in summation order, so ``tests/test_ops.py``'s bf16
  tolerances hold: rl rtol 2e-5 / atol 2e-4, statistics 1e-5 / 1e-6,
  gradients rtol and atol 1e-4;
- layers and activations in bf16: one bf16 rounding step (2^-8 relative)
  where the two frameworks round a float32 intermediate on either side of a
  tie or in another order: rtol 2^-7, atol 2^-7 x max|JAX output|;
- a teacher-forced AVITM step (same bridged weights, the same noise,
  dropout 0): loss within 1e-2 relative; each gradient leaf's port-JAX
  difference in bf16 within twice the larger of the two frameworks' own
  bf16-float32 differences, and in float32 within 1e-4 x its max|grad| (the
  leaves whose gradient cancels in exact arithmetic, the biases before the
  encoder's BatchNorms and ``prior_mean``, against the largest gradient of
  any leaf); why, in the test's docstring;
- K5 over two gloo ranks vs the full-V bf16 loss: float32 on the same
  rounded values, other summation orders: rtol 1e-4, atol 1e-5 x max|want|.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfedntm_tpu.models import activations as jact
from gfedntm_tpu.models.avitm import AVITM as JAVITM
from gfedntm_tpu.models.layers import MaskedBatchNorm as JMaskedBatchNorm
from gfedntm_tpu.models.layers import TorchDense
from gfedntm_tpu.models.losses import avitm_loss as j_avitm_loss
from gfedntm_tpu.models.losses import gaussian_kl as j_gaussian_kl
from gfedntm_tpu.ops.fused_decoder import prodlda_recon_loss as j_fused
from gfedntm_tpu.train.steps import BF16_EXACT_COUNT_MAX as J_COUNT_MAX
from gfedntm_tpu.train.steps import check_bf16_bow_counts as j_check_counts
from gfedntm_tpu_torch import interop
from gfedntm_tpu_torch.data.datasets import BowDataset
from gfedntm_tpu_torch.federated.trainer import FederatedTrainer
from gfedntm_tpu_torch.models import activations as tact
from gfedntm_tpu_torch.models.avitm import AVITM
from gfedntm_tpu_torch.models.layers import Linear, MaskedBatchNorm
from gfedntm_tpu_torch.models.losses import avitm_loss, gaussian_kl
from gfedntm_tpu_torch.ops import fused_decoder as fd
from gfedntm_tpu_torch.parallel import programs
from gfedntm_tpu_torch.parallel.launch import run_ranks
from gfedntm_tpu_torch.train import steps
from gfedntm_tpu_torch.train.steps import batch_loss, fused_batch_loss

BF = "bfloat16"
ULP = 2.0 ** -7
DEGENERATE = ("inf_net.f_mu.bias", "inf_net.f_sigma.bias", "prior_mean")
TIMEOUT_S = 240


def np32(t):
    return t.detach().float().cpu().numpy()


def make_inputs(b, k, v, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, k))
    return dict(
        theta=(np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32),
        beta=rng.normal(size=(k, v)).astype(np.float32),
        x=rng.integers(0, 4, size=(b, v)).astype(np.float32),
        run_mean=(rng.normal(size=(v,)) * 0.1).astype(np.float32),
        run_var=rng.uniform(0.5, 2.0, size=(v,)).astype(np.float32),
    )


# ---------------------------------------------------------------------------
# The fused loss on bf16 storage
# ---------------------------------------------------------------------------
FUSED_CASES = {  # (b, k, v, masked)
    "12x7x300": (12, 7, 300, False),
    "5x3x515": (5, 3, 515, False),
    "10x6x257": (10, 6, 257, False),
    "masked_10x6x257": (10, 6, 257, True),
}


@pytest.fixture
def multi_tile(monkeypatch):
    """JAX kernels on 128-wide V tiles, so every V here spans several."""
    monkeypatch.setenv("GFEDNTM_FUSED_TILE_V", "128")


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_bf16_loss_and_gradients_match_jax(case, training, multi_tile):
    b, k, v, masked = FUSED_CASES[case]
    t = make_inputs(b, k, v, seed=len(case))
    mask = ((np.arange(b) % 4) != 2).astype(np.float32) if masked else np.ones(b, np.float32)
    weight = np.linspace(0.5, 1.5, b).astype(np.float32) * mask

    theta = torch.from_numpy(t["theta"]).requires_grad_(True)
    beta = torch.from_numpy(t["beta"]).requires_grad_(True)
    rl, mean, var = fd.prodlda_recon_loss(
        theta, beta, torch.from_numpy(t["x"]), torch.from_numpy(t["run_mean"]),
        torch.from_numpy(t["run_var"]), torch.from_numpy(mask), training, storage_dtype=BF)
    (rl * torch.from_numpy(weight)).sum().backward()

    args = [jnp.asarray(t[n]) for n in ("x", "run_mean", "run_var")]

    def total(th, be):
        out, _, _ = j_fused(th, be, args[0], args[1], args[2], jnp.asarray(mask), training,
                            1e-5, 1e-10, True, BF)
        return jnp.sum(out * jnp.asarray(weight))

    j_rl, j_mean, j_var = j_fused(jnp.asarray(t["theta"]), jnp.asarray(t["beta"]), *args,
                                  jnp.asarray(mask), training, 1e-5, 1e-10, True, BF)
    j_gt, j_gb = jax.grad(total, argnums=(0, 1))(jnp.asarray(t["theta"]),
                                                 jnp.asarray(t["beta"]))
    real = mask > 0
    np.testing.assert_allclose(np32(rl)[real], np.asarray(j_rl)[real], rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np32(mean), np.asarray(j_mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np32(var), np.asarray(j_var), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np32(theta.grad), np.asarray(j_gt), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np32(beta.grad), np.asarray(j_gb), rtol=1e-4, atol=1e-4)
    assert theta.grad.dtype == beta.grad.dtype == torch.float32


def test_fused_bf16_gradient_dtypes_follow_the_primals():
    """g_theta in theta's dtype (bf16 from a bf16 network), g_beta in
    beta's (float32), as the JAX VJP casts them (``_bwd``, :809-814)."""
    t = make_inputs(6, 4, 40)
    theta = torch.from_numpy(t["theta"]).to(torch.bfloat16).requires_grad_(True)
    beta = torch.from_numpy(t["beta"]).requires_grad_(True)
    rl, _, _ = fd.prodlda_recon_loss(theta, beta, torch.from_numpy(t["x"]),
                                     torch.from_numpy(t["run_mean"]),
                                     torch.from_numpy(t["run_var"]), storage_dtype=BF)
    assert rl.dtype == torch.float32
    rl.sum().backward()
    assert theta.grad.dtype == torch.bfloat16 and beta.grad.dtype == torch.float32


def test_store_pads_the_pitch_and_rounds_to_nearest():
    x = torch.randn(5, 13)
    s = fd.store(x, BF)
    assert s.dtype == torch.bfloat16 and s.shape == (5, 13) and s.stride() == (16, 1)
    assert torch.equal(s.float(), x.to(torch.bfloat16).float())
    assert fd.store(s, BF) is s  # already pitched: no copy
    assert fd.store(x, "float32") is x
    with pytest.raises(ValueError, match="storage_dtype"):
        fd.store(x, "float16")


# ---------------------------------------------------------------------------
# K5 on bf16 storage over two gloo ranks
# ---------------------------------------------------------------------------
def test_vsharded_bf16_over_two_ranks_matches_the_full_v_bf16_loss():
    b, k, v = 12, 5, 258
    cases = []
    for i, (training, masked) in enumerate([(True, True), (False, True), (True, False)]):
        t = make_inputs(b, k, v, seed=40 + i)
        mask = ((np.arange(b) % 5) != 1).astype(np.float32) if masked else np.ones(b, np.float32)
        cases.append({**t, "mask": mask, "g": np.linspace(0.1, 2.0, b).astype(np.float32) * mask,
                      "training": training, "storage": BF})
    res = run_ranks(programs.vsharded_op, 2, "gloo", ["cpu"] * 2, TIMEOUT_S,
                    args=(1, 2, cases))
    for i, case in enumerate(cases):
        per_rank = [r[i] for r in res]
        theta = torch.from_numpy(case["theta"]).requires_grad_(True)
        beta = torch.from_numpy(case["beta"]).requires_grad_(True)
        rl, mean, var = fd.prodlda_recon_loss(
            theta, beta, *(torch.from_numpy(case[n]) for n in ("x", "run_mean", "run_var",
                                                               "mask")),
            case["training"], storage_dtype=BF)
        (rl * torch.from_numpy(case["g"])).sum().backward()
        want = {"rl": rl, "mean": mean, "var": var, "g_theta": theta.grad, "g_beta": beta.grad}
        for name, w in want.items():
            got = programs.assemble(per_rank, 1, 2, name)
            w = np32(w)
            np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"case {i} {name}")
        assert np.array_equal(per_rank[0]["kernel"]["rl"], per_rank[1]["kernel"]["rl"])


def test_bf16_fit_sharded_over_two_ranks_matches_the_unsharded_bf16_fit():
    """fit_sharded (dp=1, mp=2, gloo) of a bf16 model against the unsharded
    bf16 fit from the same weights and schedule: float32 state equal on both
    ranks, step losses within 1e-2 relative, first-step gradients within
    1e-2 of the largest gradient (K5 sums g_theta's float32 partials in
    another order, and g_theta is rounded to bf16 on its way to the
    encoder)."""
    X = np.random.default_rng(1).integers(0, 3, size=(32, 96)).astype(np.float32)
    kw = dict(input_size=96, n_components=4, hidden_sizes=(16, 16), batch_size=8,
              num_epochs=1, dropout=0.0, seed=0, fused_decoder=True, compute_dtype=BF)
    res = run_ranks(programs.fit, 2, "gloo", ["cpu"] * 2, TIMEOUT_S,
                    args=(1, 2, kw, X, None, 1, 0))
    ref = AVITM(device="cpu", **kw)
    ref.fit(BowDataset(X=X), n_samples=1)
    _, ref_grads = programs.step_gradients(AVITM(device="cpu", **kw), X)
    assert all(v.dtype in (np.float32, np.int64) for v in res[0]["state"].values())
    assert programs.state_digest(res[0]["state"]) == res[0]["state_digest"]
    assert all(r["state_digest"] == res[0]["state_digest"] for r in res)
    np.testing.assert_allclose(res[0]["step_losses"], ref.step_losses, rtol=1e-2)
    scale = max(float(np.abs(g).max()) for g in ref_grads.values())
    for name, g in ref_grads.items():
        err = float(np.abs(res[0]["first_step"][1][name] - g).max())
        assert err <= 1e-2 * scale, (name, err, scale)


# ---------------------------------------------------------------------------
# Layers, activations, KL
# ---------------------------------------------------------------------------
def close_bf16(got, want, err_msg=""):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(np32(got), want, rtol=ULP,
                               atol=ULP * max(float(np.abs(want).max()), 1e-30),
                               err_msg=err_msg)


def test_linear_matches_torch_dense_in_bf16():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(9, 33)).astype(np.float32)
    dense = TorchDense(7, dtype=jnp.bfloat16)
    variables = dense.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = dense.apply(variables, jnp.asarray(x))
    layer = Linear(33, 7, torch.bfloat16)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.asarray(variables["params"]["kernel"]).T.copy()))
        layer.bias.copy_(torch.from_numpy(np.asarray(variables["params"]["bias"])))
    got = layer(torch.from_numpy(x))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert layer.weight.dtype == torch.float32
    close_bf16(got, want)
    got.float().sum().backward()
    assert layer.weight.grad.dtype == torch.float32


@pytest.mark.parametrize("masked", [False, True])
def test_masked_batchnorm_computes_in_float32_and_returns_bf16(masked):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(10, 6)).astype(np.float32) * 3 + 1
    x_bf = jnp.asarray(x, jnp.bfloat16)
    mask = (np.arange(10) % 3 != 0).astype(np.float32)
    bn = JMaskedBatchNorm(dtype=jnp.bfloat16)
    variables = bn.init(jax.random.PRNGKey(0), x_bf, use_running_average=False)
    want, mut = bn.apply(variables, x_bf, use_running_average=False,
                         mask=jnp.asarray(mask) if masked else None, mutable=["batch_stats"])
    tbn = MaskedBatchNorm(6)
    got = tbn(torch.from_numpy(x).to(torch.bfloat16),
              torch.from_numpy(mask) if masked else None)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    close_bf16(got, want)
    stats = mut["batch_stats"]
    for name in ("running_mean", "running_var"):
        buf = getattr(tbn, name)
        assert buf.dtype == torch.float32
        np.testing.assert_allclose(buf.numpy(), np.asarray(stats[name]), rtol=1e-6, atol=1e-7)
    tbn.eval()
    close_bf16(tbn(torch.from_numpy(x).to(torch.bfloat16)),
               bn.apply({"batch_stats": stats}, x_bf, use_running_average=True))


@pytest.mark.parametrize("name", sorted(tact.ACTIVATIONS))
def test_activations_keep_bf16(name):
    x = np.linspace(-4.0, 4.0, 97).astype(np.float32)
    got = tact.get_activation(name)(torch.from_numpy(x).to(torch.bfloat16))
    want = jact.get_activation(name)(jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    close_bf16(got, want, err_msg=name)


def test_kl_of_bf16_posteriors_against_float32_priors_is_float32():
    rng = np.random.default_rng(2)
    mu, logvar = (rng.normal(size=(8, 5)).astype(np.float32) for _ in range(2))
    pm, pv = np.zeros(5, np.float32), np.full(5, 0.8, np.float32)
    mu_b, lv_b = (torch.from_numpy(a).to(torch.bfloat16) for a in (mu, logvar))
    got = gaussian_kl(torch.from_numpy(pm), torch.from_numpy(pv), mu_b, torch.exp(lv_b), lv_b)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (mu, logvar)]
    want = j_gaussian_kl(jnp.asarray(pm), jnp.asarray(pv), jb[0], jnp.exp(jb[1]), jb[1])
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(np32(got), np.asarray(want), rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# A teacher-forced AVITM step against JAX
# ---------------------------------------------------------------------------
V, K, H, B = 160, 5, (16, 12), 12
DTYPES = {"float32": (jnp.float32, torch.float32), BF: (jnp.bfloat16, torch.bfloat16)}


def _jax_step_loss(module, batch_stats, x, mask, noise, fused, storage):
    def loss(params):
        variables = {"params": params, "batch_stats": batch_stats}
        if not fused:
            out, _ = module.apply(variables, x, train=True, mask=mask, noise=noise,
                                  mutable=["batch_stats"])
            return j_avitm_loss(x, out.word_dist, out.prior_mean, out.prior_variance,
                                out.posterior_mean, out.posterior_variance,
                                out.posterior_log_variance, sample_mask=mask)
        out, _ = module.apply(variables, x, train=True, mask=mask, noise=noise,
                              mutable=["batch_stats"], method="encode_theta")
        bn = batch_stats["beta_batchnorm"]
        rl, _, _ = j_fused(out.theta, params["beta"], x, bn["running_mean"], bn["running_var"],
                           mask, True, 1e-5, 1e-10, True, storage)
        kl = j_gaussian_kl(out.prior_mean, out.prior_variance, out.posterior_mean,
                           out.posterior_variance, out.posterior_log_variance)
        return jnp.sum((kl + rl) * mask)
    return loss


def _step(compute_dtype, model_type, fused, init, x, mask, noise):
    """(JAX loss, JAX gradients, port loss, port gradients) of one training
    step from the weights ``init`` on the batch ``x``, ``mask`` with the
    reparameterization noise rounded to the compute dtype, dropout 0."""
    params, batch_stats = init
    kw = dict(input_size=V, n_components=K, hidden_sizes=H, batch_size=B, dropout=0.0,
              model_type=model_type, compute_dtype=compute_dtype, fused_decoder=fused)
    j_dt, t_dt = DTYPES[compute_dtype]
    j_loss, j_grads = jax.value_and_grad(_jax_step_loss(
        JAVITM(**kw).module, batch_stats, jnp.asarray(x), jnp.asarray(mask),
        jnp.asarray(noise, j_dt), fused, compute_dtype))(jax.tree.map(jnp.asarray, params))
    net = AVITM(device="cpu", **kw).model
    net.load_state_dict(interop.state_dict_from_flax(params, batch_stats))
    net.train()
    args = (net, {"x_bow": torch.from_numpy(x)}, torch.from_numpy(mask))
    noise_t = torch.from_numpy(noise).to(t_dt)
    loss = fused_batch_loss(*args, noise=noise_t) if fused else batch_loss(*args, noise=noise_t)
    assert loss.dtype == torch.float32
    loss.backward()
    want = interop.state_dict_from_flax(jax.tree.map(np.asarray, j_grads), {})
    for name, p in net.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
    return (float(j_loss), {n: w.numpy() for n, w in want.items()}, float(loss.detach()),
            {n: np32(p.grad) for n, p in net.named_parameters()})


@pytest.mark.parametrize("model_type,fused", [("prodLDA", True), ("prodLDA", False),
                                              ("LDA", False)],
                         ids=["prodLDA-fused", "prodLDA-unfused", "LDA-unfused"])
def test_teacher_forced_bf16_step_matches_jax(model_type, fused):
    """Same bridged weights, batch and noise, dropout 0, in float32 and in
    bf16. The loss agrees within 1e-2 relative (measured 6e-5 to 8e-4).
    Gradients: at these random weights the encoder's BatchNorms normalise
    columns whose spread over the batch is small, so one bf16 rounding of
    their input moves the normalised output by up to ~10% and every
    gradient downstream with it; JAX's own bf16 gradients differ from its
    float32 ones by up to 17% of a leaf's max|grad|, the port's by 9%. So
    each leaf's port-JAX difference in bf16 is held to twice the larger of
    the two frameworks' own bf16-float32 differences (measured: at most
    1.5 times), and in float32 the two agree within 1e-4 x max|grad|."""
    jinit = JAVITM(input_size=V, n_components=K, hidden_sizes=H, model_type=model_type)
    init = (jax.tree.map(np.asarray, jinit.params), jax.tree.map(np.asarray, jinit.batch_stats))
    rng = np.random.default_rng(5)
    x = rng.integers(0, 4, size=(B, V)).astype(np.float32)
    mask = (np.arange(B) % 5 != 3).astype(np.float32)
    noise = rng.normal(size=(B, K)).astype(np.float32)
    j32, jg32, t32, tg32 = _step("float32", model_type, fused, init, x, mask, noise)
    jbf, jgbf, tbf, tgbf = _step(BF, model_type, fused, init, x, mask, noise)
    assert t32 == pytest.approx(j32, rel=1e-5)
    assert tbf == pytest.approx(jbf, rel=1e-2)
    scale = max(float(np.abs(g).max()) for g in jg32.values())
    for name, g32 in jg32.items():
        ref = scale if name in DEGENERATE else float(np.abs(g32).max())
        assert float(np.abs(tg32[name] - g32).max()) <= 1e-4 * ref, name
        spread = max(float(np.abs(tgbf[name] - tg32[name]).max()),
                     float(np.abs(jgbf[name] - g32).max()))
        assert float(np.abs(tgbf[name] - jgbf[name]).max()) <= 2.0 * spread, name


# ---------------------------------------------------------------------------
# Trainers, interop, the count screen
# ---------------------------------------------------------------------------
def test_two_client_bf16_federated_fit_keeps_float32_shared_state():
    rng = np.random.default_rng(3)
    datasets = [BowDataset(X=rng.integers(0, 3, size=(24, 90)).astype(np.float32))
                for _ in range(2)]
    template = AVITM(input_size=90, n_components=4, hidden_sizes=(8, 8), batch_size=8,
                     num_epochs=2, compute_dtype=BF, device="cpu")
    result = FederatedTrainer(template, n_clients=2, device="cpu").fit(datasets)
    assert np.isfinite(result.losses).all() and result.losses.shape == (6, 2)
    for tree in (result.client_params, result.client_batch_stats):
        for key, value in tree[0].items():
            assert value.dtype in (torch.float32, torch.long), key
            assert torch.equal(value, tree[1][key]), key
    model = FederatedTrainer(template, n_clients=2, device="cpu").make_global_model(result)
    theta = model.get_doc_topic_distribution(datasets[0], n_samples=2)
    assert theta.dtype == np.float32 and np.allclose(theta.sum(1), 1.0, atol=3e-2)


def test_bf16_model_state_bridges_both_ways_unchanged():
    jmodel = JAVITM(input_size=50, n_components=4, hidden_sizes=(8, 6), compute_dtype=BF)
    params = jax.tree.map(np.asarray, jmodel.params)
    batch_stats = jax.tree.map(np.asarray, jmodel.batch_stats)
    model = AVITM(input_size=50, n_components=4, hidden_sizes=(8, 6), compute_dtype=BF,
                  device="cpu")
    model.model.load_state_dict(interop.state_dict_from_flax(params, batch_stats))
    state = model.model.state_dict()
    assert all(v.dtype in (torch.float32, torch.long) for v in state.values())
    back_params, back_stats = interop.flax_from_state_dict(state)
    for got, want in ((back_params, params), (back_stats, batch_stats)):
        flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        assert flat_got.keys() == flat_want.keys()
        for path, value in flat_want.items():
            assert flat_got[path].dtype == value.dtype, path
            assert np.array_equal(flat_got[path], value), path


@pytest.mark.parametrize("top", [0.0, 3.0, 255.0, 256.0, 257.0, 1000.0])
def test_count_screen_matches_jax(top, caplog):
    x = np.zeros((3, 7), np.float32)
    x[1, 4] = top
    logger = logging.getLogger("bf16-screen")
    with caplog.at_level(logging.WARNING, logger="bf16-screen"):
        got = steps.check_bf16_bow_counts(x, logger)
        want = j_check_counts(x, logger)
    assert got == want == (top > 256)
    assert steps.BF16_EXACT_COUNT_MAX == J_COUNT_MAX == 256.0
    messages = [r.getMessage() for r in caplog.records]
    assert len(messages) == (2 if top > 256 else 0)
    assert len(set(messages)) <= 1
    assert steps.check_bf16_bow_counts(np.zeros((0, 4))) is False


def test_count_screen_runs_once_per_model_where_the_corpus_is_staged(caplog):
    model = AVITM(input_size=20, n_components=3, hidden_sizes=(4, 4), batch_size=4,
                  num_epochs=1, compute_dtype=BF, device="cpu")
    x = np.ones((6, 20), np.float32)
    x[0, 0] = 300.0
    with caplog.at_level(logging.WARNING):
        model.fit(BowDataset(X=x), n_samples=1)
        model.get_doc_topic_distribution(BowDataset(X=x), n_samples=1)
    assert sum("bfloat16" in r.getMessage() for r in caplog.records) == 1
