"""Two clients stepping in lockstep with FedAvg: the port's ``grad_step`` and
exchange against the JAX package's pieces composed by hand, from bridged
weights, on the same numpy schedules and the same injected reparameterization
noise, with dropout 0. Fused (kernels' plain versions vs Pallas interpret)
and unfused decode.

Tolerance: rtol 1e-4 on params, BatchNorm buffers and Adam moments, with
atol 1e-5 x max|expected| per tensor (float32 sums in another order). Three
leaves are held to a bound instead: ``inf_net.f_mu.bias``,
``inf_net.f_sigma.bias`` and ``prior_mean`` have a gradient that is exactly
zero in exact arithmetic (BatchNorm removes a bias; the batch mean of the
normalized mu is zero), so both sides see rounding noise, and Adam turns
noise of either sign into a step of up to ``lr``. Their |param - initial| is
bounded by ``steps * lr`` on both sides and their Adam moments must stay at
noise level; the running means of ``f_mu_batchnorm`` and
``f_sigma_batchnorm`` carry those biases, so they agree to within
``2 * steps * lr``. (Measured at 5 steps: every other leaf within 2e-6 of
its scale; the biases apart by up to 0.014.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gfedntm_tpu.data.datasets import make_run_schedule
from gfedntm_tpu.data.synthetic import generate_synthetic_corpus
from gfedntm_tpu.models.losses import avitm_loss as j_avitm_loss
from gfedntm_tpu.models.losses import gaussian_kl as j_gaussian_kl
from gfedntm_tpu.models.networks import DecoderNetwork as JDecoderNetwork
from gfedntm_tpu.ops.fused_decoder import prodlda_recon_loss as j_fused
from gfedntm_tpu_torch import interop
from gfedntm_tpu_torch.federated.trainer import FederatedTrainer
from gfedntm_tpu_torch.models.avitm import AVITM
from gfedntm_tpu_torch.models.networks import DecoderNetwork
from gfedntm_tpu_torch.train.optimizers import build_optimizer
from gfedntm_tpu_torch.train.steps import grad_step

V, K, H, B, C = 300, 6, (17, 13), 16, 2
LR = 2e-3
DEGENERATE = ("inf_net.f_mu.bias", "inf_net.f_sigma.bias", "prior_mean")
BIAS_CARRIERS = ("inf_net.f_mu_batchnorm.running_mean",
                 "inf_net.f_sigma_batchnorm.running_mean")


def close(got, want, err_msg):
    scale = max(1e-30, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale, err_msg=err_msg)


def corpus():
    c = generate_synthetic_corpus(vocab_size=V, n_topics=K, n_docs=40, n_nodes=C,
                                  nwords=(30, 60), seed=1, materialize_docs=False)
    return [c.nodes[0].bow, c.nodes[1].bow[:30]]  # unequal FedAvg weights


def jax_step(jnet, tx, params, bs, opt, x, mask, noise, fused):
    def loss_fn(p):
        variables = {"params": p, "batch_stats": bs}
        kw = dict(train=True, mask=mask, noise=noise, mutable=["batch_stats"],
                  rngs={"dropout": jax.random.PRNGKey(0)})
        if not fused:
            out, mut = jnet.apply(variables, x, **kw)
            loss = j_avitm_loss(x, out.word_dist, out.prior_mean, out.prior_variance,
                                out.posterior_mean, out.posterior_variance,
                                out.posterior_log_variance, sample_mask=mask)
            return loss, mut["batch_stats"]
        out, mut = jnet.apply(variables, x, method="encode_theta", **kw)
        bn = bs["beta_batchnorm"]
        rl, b_mean, b_var = j_fused(out.theta, p["beta"], x, bn["running_mean"],
                                    bn["running_var"], mask, True, 1e-5, 1e-10, True)
        kl = j_gaussian_kl(out.prior_mean, out.prior_variance, out.posterior_mean,
                           out.posterior_variance, out.posterior_log_variance)
        loss = jnp.sum((kl + rl) * mask)
        # The running-stat update of gfedntm_tpu/train/steps.py:236-246.
        cnt = jnp.maximum(jnp.sum(mask), 1.0)
        var_unbiased = b_var * (cnt / jnp.maximum(cnt - 1.0, 1.0))
        new_bs = dict(mut["batch_stats"])
        new_bs["beta_batchnorm"] = {
            "running_mean": 0.9 * bn["running_mean"] + 0.1 * b_mean,
            "running_var": 0.9 * bn["running_var"] + 0.1 * var_unbiased,
            "num_batches_tracked": bn["num_batches_tracked"] + 1,
        }
        return loss, new_bs

    (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, opt = tx.update(grads, opt, params)
    return optax.apply_updates(params, updates), new_bs, opt, loss


def jax_fedavg(trees, weights):
    def mix(*leaves):
        if not jnp.issubdtype(leaves[0].dtype, jnp.floating):
            return leaves
        avg = sum(w * leaf for w, leaf in zip(weights, leaves)) / float(sum(weights))
        return tuple(avg for _ in leaves)

    mixed = jax.tree.map(mix, *trees)
    return [jax.tree.map(lambda t, i=i: t[i], mixed,
                         is_leaf=lambda t: isinstance(t, tuple)) for i in range(len(trees))]


def run_both(steps, fused):
    data = corpus()
    weights = [float(len(d)) for d in data]
    scheds = [make_run_schedule(len(d), B, steps, seed=c) for c, d in enumerate(data)]
    noise = np.random.default_rng(9).normal(size=(steps, C, B, K)).astype(np.float32)

    jnet = JDecoderNetwork(input_size=V, n_components=K, hidden_sizes=H, dropout=0.0)
    init = jnet.init({n: jax.random.PRNGKey(i) for i, n in
                      enumerate(("params", "reparam", "dropout"))},
                     jnp.zeros((B, V)), train=True)
    params0 = jax.tree.map(np.asarray, dict(init["params"]))
    bs0 = jax.tree.map(np.asarray, dict(init["batch_stats"]))
    tx = optax.adam(LR, b1=0.99, b2=0.99, eps=1e-8)
    j_params = [jax.tree.map(jnp.asarray, params0) for _ in range(C)]
    j_bs = [jax.tree.map(jnp.asarray, bs0) for _ in range(C)]
    j_opt = [tx.init(p) for p in j_params]

    state0 = interop.state_dict_from_flax(params0, bs0)
    models, opts = [], []
    for _ in range(C):
        m = DecoderNetwork(V, K, hidden_sizes=H, dropout=0.0)
        m.load_state_dict(state0)
        models.append(m)
        opts.append(build_optimizer(m.parameters(), "adam", LR, 0.99))
    template = AVITM(input_size=V, n_components=K, hidden_sizes=H, batch_size=B,
                     dropout=0.0, device="cpu")
    trainer = FederatedTrainer(template, n_clients=C, device="cpu")

    for step in range(steps):
        for c in range(C):
            idx, mask = scheds[c].indices[step], scheds[c].mask[step].astype(np.float32)
            x = data[c][idx]
            j_params[c], j_bs[c], j_opt[c], _ = jax_step(
                jnet, tx, j_params[c], j_bs[c], j_opt[c], jnp.asarray(x),
                jnp.asarray(mask), jnp.asarray(noise[step, c]), fused)
            grad_step(models[c], opts[c], {"x_bow": torch.from_numpy(x)},
                      torch.from_numpy(mask),
                      fused, noise=torch.from_numpy(noise[step, c]))
        j_params = jax_fedavg(j_params, weights)
        j_bs = jax_fedavg(j_bs, weights)
        trainer._fedavg(models, torch.tensor(weights), sum(weights))
    return params0, j_params, j_bs, j_opt, models, opts


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("steps", [1, 5])
def test_two_clients_lockstep_with_fedavg(steps, fused):
    params0, j_params, j_bs, j_opt, models, opts = run_both(steps, fused)
    init = interop.state_dict_from_flax(params0, {})
    for c in range(C):
        want = interop.state_dict_from_flax(
            jax.tree.map(np.asarray, j_params[c]), jax.tree.map(np.asarray, j_bs[c]))
        adam = j_opt[c][0]
        mu = interop.state_dict_from_flax(jax.tree.map(np.asarray, adam.mu), {})
        nu = interop.state_dict_from_flax(jax.tree.map(np.asarray, adam.nu), {})
        state = models[c].state_dict()
        assert set(state) == set(want)
        for key, value in state.items():
            if key in DEGENERATE:
                for side in (value, want[key]):
                    assert float((side - init[key]).abs().max()) <= steps * LR * 1.001, key
            elif key in BIAS_CARRIERS:
                assert float((value - want[key]).abs().max()) <= 2 * steps * LR, key
            else:
                close(value.numpy(), want[key].numpy(), f"client {c} {key}")
        for name, p in models[c].named_parameters():
            st = opts[c].state[p]
            for got, exp, what in ((st["exp_avg"], mu[name], "m"),
                                   (st["exp_avg_sq"], nu[name], "v")):
                if name in DEGENERATE:
                    assert float(got.abs().max()) < 1e-3 and float(exp.abs().max()) < 1e-3
                else:
                    close(got.numpy(), exp.numpy(), f"client {c} Adam {what} {name}")
    # The exchange leaves every client with the same floating state.
    for key, value in models[0].state_dict().items():
        assert torch.equal(value, models[1].state_dict()[key]), key


# ---- the five solvers against the JAX package's optax solvers ---------------

SOLVERS = ("adam", "sgd", "adagrad", "adadelta", "rmsprop")


@pytest.mark.parametrize("inject_lr", [False, True], ids=["fixed_lr", "inject_lr"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_solver_steps_as_the_jax_build_optimizer(solver, inject_lr):
    """Three steps of each solver on 1,000 float32 parameters, gradients of
    scales 1, 0.3 and 1e-3, lr 2e-3 and momentum 0.99, against the JAX
    ``build_optimizer``; within 1e-6 after every step. With ``inject_lr`` the
    learning rate is halved before step 3 on both sides, as
    ``reduce_on_plateau`` does: an rmsprop that scales its momentum by the
    learning rate after the trace would part from optax's there."""
    from gfedntm_tpu.train.optimizers import build_optimizer as j_build_optimizer

    rng = np.random.default_rng(0)
    p0 = rng.normal(size=1000).astype(np.float32)
    grads = [(s * rng.normal(size=1000)).astype(np.float32) for s in (1.0, 0.3, 1e-3)]
    tx = j_build_optimizer(solver, lr=LR, momentum=0.99, inject_lr=inject_lr)
    jp = jnp.asarray(p0)
    j_state = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = build_optimizer([p], solver, LR, 0.99)
    for i, g in enumerate(grads):
        if inject_lr and i == 2:
            j_state.hyperparams["learning_rate"] = jnp.asarray(LR / 2, jnp.float32)
            for group in opt.param_groups:
                group["lr"] = LR / 2
        updates, j_state = tx.update(jnp.asarray(g), j_state, jp)
        jp = optax.apply_updates(jp, updates)
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        err = float(np.abs(p.detach().numpy() - np.asarray(jp)).max())
        assert err <= 1e-6, (solver, i + 1, err)
