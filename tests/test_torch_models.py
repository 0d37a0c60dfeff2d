"""Port model layers, networks, losses and share masks against the Flax
modules of the JAX package, on the same weights (bridged through
``gfedntm_tpu_torch.interop``) and the same injected noise.

Tolerance: atol 1e-5, rtol 1e-5 on float32 outputs of these small shapes
(V <= 300, K = 6, H = (17, 13), B = 12); both sides compute in float32 and
differ only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfedntm_tpu.config import SHARE_ALL as J_SHARE_ALL
from gfedntm_tpu.config import SHARE_MINIMAL as J_SHARE_MINIMAL
from gfedntm_tpu.models import activations as jact
from gfedntm_tpu.models.layers import MaskedBatchNorm as JMaskedBatchNorm
from gfedntm_tpu.models.losses import avitm_loss as j_avitm_loss
from gfedntm_tpu.models.networks import DecoderNetwork as JDecoderNetwork
from gfedntm_tpu.models.params import build_share_mask as j_build_share_mask
from gfedntm_tpu_torch import interop
from gfedntm_tpu_torch.models import activations as tact
from gfedntm_tpu_torch.models.initializers import init_linear_, xavier_uniform_2d_
from gfedntm_tpu_torch.models.layers import MaskedBatchNorm, dropout
from gfedntm_tpu_torch.models.losses import avitm_loss
from gfedntm_tpu_torch.models.networks import DecoderNetwork
from gfedntm_tpu_torch.models.params import SHARE_ALL, SHARE_MINIMAL, build_share_mask

ATOL = RTOL = 1e-5
V, K, H, B = 300, 6, (17, 13), 12
MASK = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 1, 0], np.float32)


def close(torch_value, jax_value, atol=ATOL, rtol=RTOL, err_msg=""):
    np.testing.assert_allclose(
        torch_value.detach().cpu().numpy(), np.asarray(jax_value),
        atol=atol, rtol=rtol, err_msg=err_msg,
    )


def jax_init(module, x):
    keys = {n: jax.random.PRNGKey(i) for i, n in enumerate(("params", "reparam", "dropout"))}
    variables = module.init(keys, jnp.asarray(x), train=True)
    return (jax.tree.map(np.asarray, dict(variables["params"])),
            jax.tree.map(np.asarray, dict(variables["batch_stats"])))


def bridged_pair(model_type="prodLDA", learn_priors=True):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, size=(B, V)).astype(np.float32)
    jnet = JDecoderNetwork(input_size=V, n_components=K, model_type=model_type,
                           hidden_sizes=H, dropout=0.0, learn_priors=learn_priors)
    params, batch_stats = jax_init(jnet, x)
    tnet = DecoderNetwork(V, K, model_type, H, dropout=0.0, learn_priors=learn_priors)
    tnet.load_state_dict(interop.state_dict_from_flax(params, batch_stats))
    return jnet, params, batch_stats, tnet, x


# ---------------------------------------------------------------------------
# MaskedBatchNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["unmasked", "masked", "all_masked"])
def test_masked_batchnorm_three_steps_then_eval(mode):
    rng = np.random.default_rng(1)
    jbn = JMaskedBatchNorm()
    xs = [rng.normal(size=(B, 5)).astype(np.float32) * (i + 1) for i in range(4)]
    mask = {"unmasked": None, "masked": MASK, "all_masked": np.zeros(B, np.float32)}[mode]
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), False)
    bs = variables["batch_stats"]
    tbn = MaskedBatchNorm(5).train()
    for x in xs[:3]:
        y_j, mut = jbn.apply(
            {"batch_stats": bs}, jnp.asarray(x), False,
            None if mask is None else jnp.asarray(mask), mutable=["batch_stats"],
        )
        bs = mut["batch_stats"]
        y_t = tbn(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
        close(y_t, y_j)
    close(tbn.running_mean, bs["running_mean"])
    close(tbn.running_var, bs["running_var"])
    assert int(tbn.num_batches_tracked) == int(bs["num_batches_tracked"]) == 3
    tbn.eval()
    y_j = jbn.apply({"batch_stats": bs}, jnp.asarray(xs[3]), True)
    close(tbn(torch.from_numpy(xs[3]), torch.from_numpy(MASK)), y_j)
    assert int(tbn.num_batches_tracked) == 3


# ---------------------------------------------------------------------------
# Networks and loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model_type", ["prodLDA", "LDA"])
@pytest.mark.parametrize("masked", [False, True])
def test_network_train_forward_and_loss(model_type, masked):
    jnet, params, bs, tnet, x = bridged_pair(model_type)
    noise = np.random.default_rng(2).normal(size=(B, K)).astype(np.float32)
    mask = MASK if masked else np.ones(B, np.float32)
    out_j, mut = jnet.apply(
        {"params": params, "batch_stats": bs}, jnp.asarray(x), train=True,
        mask=jnp.asarray(mask) if masked else None, noise=jnp.asarray(noise),
        mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(3)},
    )
    tnet.train()
    out_t = tnet(torch.from_numpy(x), mask=torch.from_numpy(mask) if masked else None,
                 noise=torch.from_numpy(noise))
    close(out_t.posterior_mean, out_j.posterior_mean, err_msg="mu")
    close(out_t.posterior_log_variance, out_j.posterior_log_variance, err_msg="log var")
    close(out_t.posterior_variance, out_j.posterior_variance, err_msg="var")
    close(out_t.theta, out_j.theta, err_msg="theta")
    close(out_t.word_dist, out_j.word_dist, atol=1e-7, err_msg="word_dist")
    loss_j = j_avitm_loss(
        jnp.asarray(x), out_j.word_dist, out_j.prior_mean, out_j.prior_variance,
        out_j.posterior_mean, out_j.posterior_variance, out_j.posterior_log_variance,
        sample_mask=jnp.asarray(mask),
    )
    loss_t = avitm_loss(
        torch.from_numpy(x), out_t.word_dist, out_t.prior_mean, out_t.prior_variance,
        out_t.posterior_mean, out_t.posterior_variance, out_t.posterior_log_variance,
        sample_mask=torch.from_numpy(mask),
    )
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=RTOL)
    # BatchNorm running stats moved identically.
    want = interop.state_dict_from_flax(params, mut["batch_stats"])
    for key, value in tnet.state_dict().items():
        if "running" in key or "num_batches" in key:
            close(value, want[key].numpy(), err_msg=key)


def test_network_eval_forward_and_get_theta():
    jnet, params, bs, tnet, x = bridged_pair()
    noise = np.random.default_rng(4).normal(size=(B, K)).astype(np.float32)
    variables = {"params": params, "batch_stats": bs}
    out_j = jnet.apply(variables, jnp.asarray(x), train=False, noise=jnp.asarray(noise))
    tnet.eval()
    out_t = tnet(torch.from_numpy(x), noise=torch.from_numpy(noise))
    close(out_t.theta, out_j.theta)
    close(out_t.word_dist, out_j.word_dist, atol=1e-7)
    tnet.train()
    for eps in (noise, 0.0):
        th_j = jnet.apply(variables, jnp.asarray(x), noise=jnp.asarray(eps),
                          method=JDecoderNetwork.get_theta)
        th_t = tnet.get_theta(torch.from_numpy(x),
                              noise=torch.as_tensor(eps, dtype=torch.float32))
        close(th_t, th_j)
    assert tnet.training  # get_theta restores the mode


def test_network_without_learned_priors_has_no_prior_entries():
    _, params, _, tnet, _ = bridged_pair(learn_priors=False)
    assert "prior_mean" not in params and "prior_mean" not in tnet.state_dict()
    close(tnet.prior_variance, np.full(K, 1.0 - 1.0 / K, np.float32))


def test_encode_theta_leaves_decoder_bn_untouched():
    _, _, _, tnet, x = bridged_pair()
    tnet.train()
    out = tnet.encode_theta(torch.from_numpy(x), noise=torch.zeros(B, K))
    assert out.word_dist is None
    assert int(tnet.beta_batchnorm.num_batches_tracked) == 0
    assert int(tnet.inf_net.f_mu_batchnorm.num_batches_tracked) == 1


def test_logvar_clamp():
    _, _, _, tnet, x = bridged_pair()
    with torch.no_grad():
        tnet.inf_net.f_sigma.weight.mul_(1e6)
    tnet.eval()
    out = tnet(torch.from_numpy(x), noise=torch.zeros(B, K))
    assert float(out.posterior_log_variance.detach().abs().max()) <= 80.0


# ---------------------------------------------------------------------------
# Weight bridge, share masks, activations, initializers
# ---------------------------------------------------------------------------
def test_interop_round_trip_and_key_grammar():
    _, params, bs, tnet, _ = bridged_pair()
    sd = tnet.state_dict()
    assert "inf_net.hiddens.l_0.0.weight" in sd
    assert tuple(sd["inf_net.input_layer.weight"].shape) == (H[0], V)
    assert sd["inf_net.f_mu_batchnorm.num_batches_tracked"].dtype == torch.long
    p2, bs2 = interop.flax_from_state_dict(sd)
    assert p2["inf_net"]["hiddens_l0"]["kernel"].shape == (H[0], H[1])
    assert bs2["inf_net"]["f_mu_batchnorm"]["num_batches_tracked"].dtype == np.int32
    for (pa, a), (pb, b) in zip(
        sorted(jax.tree_util.tree_leaves_with_path({"p": params, "b": bs}), key=str),
        sorted(jax.tree_util.tree_leaves_with_path({"p": p2, "b": bs2}), key=str),
    ):
        assert str(pa) == str(pb)
        np.testing.assert_array_equal(np.asarray(a), b)


def _jax_mask_by_torch_key(params, bs, grads_to_share):
    mask = j_build_share_mask({"params": params, "batch_stats": bs}, grads_to_share)
    out = {}
    for col in ("params", "batch_stats"):
        for path, flag in jax.tree_util.tree_leaves_with_path(mask[col]):
            out[interop.torch_key(tuple(str(p.key) for p in path))] = bool(flag)
    return out


@pytest.mark.parametrize("which", ["all", "minimal", "with_absent_adapt_bert"])
def test_share_mask_matches(which):
    _, params, bs, tnet, _ = bridged_pair()
    lists = {
        "all": (J_SHARE_ALL, SHARE_ALL),
        "minimal": (J_SHARE_MINIMAL, SHARE_MINIMAL),
        "with_absent_adapt_bert": ((
            "inf_net.adapt_bert.weight", "inf_net.adapt_bert.bias", "beta",
            "inf_net.hiddens.l_0.0.weight", "inf_net.f_mu_batchnorm.running_mean",
            "beta_batchnorm.num_batches_tracked",
        ),) * 2,
    }
    j_list, t_list = lists[which]
    assert tuple(j_list) == tuple(t_list)
    want = _jax_mask_by_torch_key(params, bs, j_list)
    got = build_share_mask(tnet.state_dict().keys(), t_list)
    assert got == want
    assert sum(got.values()) == {"all": len(got), "minimal": 3,
                                 "with_absent_adapt_bert": 4}[which]


@pytest.mark.parametrize("name", sorted(tact.ACTIVATIONS))
def test_activation_matches(name):
    x = np.linspace(-4, 4, 41, dtype=np.float32)
    close(tact.get_activation(name)(torch.from_numpy(x)),
          jact.get_activation(name)(jnp.asarray(x)), atol=1e-6, rtol=1e-6)


def test_unknown_activation_raises():
    with pytest.raises(ValueError):
        tact.get_activation("gelu")


def test_initializers_bounds_and_seeding():
    gen = torch.Generator().manual_seed(0)
    layer = torch.nn.Linear(100, 7)
    init_linear_(layer, gen)
    assert float(layer.weight.abs().max()) <= 0.1 and float(layer.bias.abs().max()) <= 0.1
    beta = torch.empty(6, 300)
    xavier_uniform_2d_(beta, torch.Generator().manual_seed(1))
    bound = np.sqrt(6.0 / 306)
    assert float(beta.abs().max()) <= bound and float(beta.abs().max()) > 0.9 * bound
    a = DecoderNetwork(V, K, hidden_sizes=H, generator=torch.Generator().manual_seed(3))
    b = DecoderNetwork(V, K, hidden_sizes=H, generator=torch.Generator().manual_seed(3))
    for key, value in a.state_dict().items():
        assert torch.equal(value, b.state_dict()[key]), key


def test_dropout_uses_the_generator():
    x = torch.ones(64, 32)
    a = dropout(x, 0.5, True, torch.Generator().manual_seed(0))
    b = dropout(x, 0.5, True, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and set(a.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(dropout(x, 0.5, False, None), x)
