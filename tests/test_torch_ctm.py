"""The CTM family (ZeroShotTM, CombinedTM, with and without labels) in the
port against the JAX package, on the same bridged weights (through
``gfedntm_tpu_torch.interop``), numpy-seeded inputs and injected
reparameterization noise, dropout 0. The JAX fused decode runs in Pallas
interpret mode, the port's through its kernels' plain versions.

Widths: V=96, K=6, H=(8, 8), B=16, contextual_size=12, L=3.

Tolerances:

- network outputs and losses on the same weights: atol and rtol 1e-5
  (``tests/test_torch_models.py``: float32 in another summation order);
- a first training step's gradients, and the lockstep federated states:
  rtol 1e-4 with atol 1e-5 x max|expected| per tensor
  (``tests/test_torch_train.py``). The leaves whose gradient is zero in
  exact arithmetic (the biases before the encoder's BatchNorms,
  ``prior_mean``) are held to 1e-5 of the largest gradient, and after Adam
  as ``tests/test_torch_train.py`` holds them;
- bf16: layer outputs within 2^-7 (one bf16 step, ``tests/test_torch_bf16.py``),
  the step's loss within 1e-2 relative and each gradient leaf's port-JAX
  difference within twice the larger of the two frameworks' own
  bf16-float32 differences (``test_teacher_forced_bf16_step_matches_jax``);
- save/load and the hashing embedder: bitwise.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gfedntm_tpu.data.datasets import make_run_schedule
from gfedntm_tpu.models.ctm import CTM as JCTM
from gfedntm_tpu.models.losses import cross_entropy_with_logits as j_ce
from gfedntm_tpu.models.losses import ctm_loss as j_ctm_loss
from gfedntm_tpu.models.losses import gaussian_kl as j_gaussian_kl
from gfedntm_tpu.ops.fused_decoder import prodlda_recon_loss as j_fused
from gfedntm_tpu.presets import hashing_embedder as j_hashing_embedder
from gfedntm_tpu_torch import interop
from gfedntm_tpu_torch.data.datasets import CTMDataset, make_epoch_schedule
from gfedntm_tpu_torch.data.embeddings import hashing_embedder
from gfedntm_tpu_torch.federated.trainer import FederatedTrainer
from gfedntm_tpu_torch.models.ctm import CTM, CombinedTM, ZeroShotTM
from gfedntm_tpu_torch.models.losses import cross_entropy_with_logits, ctm_loss
from gfedntm_tpu_torch.train.steps import batch_loss, eval_epoch, fused_batch_loss, grad_step

V, K, H, B, CTX, L = 96, 6, (8, 8), 16, 12, 3
LR = 2e-3
KINDS = ("zeroshot", "combined")
DEGENERATE = ("inf_net.f_mu.bias", "inf_net.f_sigma.bias", "prior_mean")
BIAS_CARRIERS = ("inf_net.f_mu_batchnorm.running_mean",
                 "inf_net.f_sigma_batchnorm.running_mean")
MASK = (np.arange(B) % 5 != 3).astype(np.float32)
ULP = 2.0 ** -7
CASES = [(kind, labels) for kind in KINDS for labels in (False, True)]
CASE_IDS = [f"{kind}-{'labels' if labels else 'nolabels'}" for kind, labels in CASES]


def np32(t):
    return t.detach().float().cpu().numpy()


def close(got, want, err_msg="", rtol=1e-4, atol_scale=1e-5):
    scale = max(1e-30, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * scale, err_msg=err_msg)


def kw(kind, labels, **over):
    return dict(input_size=V, contextual_size=CTX, n_components=K, hidden_sizes=H,
                batch_size=B, dropout=0.0, inference_type=kind,
                label_size=L if labels else 0, **over)


def data(n=B, seed=0, labels=True):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, size=(n, V)).astype(np.float32)
    ctx = rng.normal(size=(n, CTX)).astype(np.float32)
    lab = np.eye(L, dtype=np.float32)[rng.integers(0, L, n)] if labels else None
    return x, ctx, lab


def pair(kind, labels, **over):
    """A JAX CTM and a port CTM holding its weights."""
    j = JCTM(**kw(kind, labels, **over))
    params = jax.tree.map(np.asarray, j.params)
    stats = jax.tree.map(np.asarray, j.batch_stats)
    port = CTM(device="cpu", **kw(kind, labels, **over))
    port.model.load_state_dict(interop.state_dict_from_flax(params, stats))
    return j, params, stats, port


def t_batch(x, ctx, lab):
    batch = {"x_bow": torch.from_numpy(x), "x_ctx": torch.from_numpy(ctx)}
    if lab is not None:
        batch["labels"] = torch.from_numpy(lab)
    return batch


def j_args(x, ctx, lab):
    return jnp.asarray(x), jnp.asarray(ctx), None if lab is None else jnp.asarray(lab)


# ---------------------------------------------------------------------------
# Networks and losses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind, labels", CASES, ids=CASE_IDS)
def test_forward_and_losses_match_jax(kind, labels):
    j, params, stats, port = pair(kind, labels)
    x, ctx, lab = data(labels=labels)
    noise = np.random.default_rng(2).normal(size=(B, K)).astype(np.float32)
    out_j, _ = j.module.apply({"params": params, "batch_stats": stats}, *j_args(x, ctx, lab),
                              train=True, mask=jnp.asarray(MASK), noise=jnp.asarray(noise),
                              mutable=["batch_stats"])
    net = port.model.train()
    batch = t_batch(x, ctx, lab)
    out_t = net(batch["x_bow"], batch["x_ctx"], batch.get("labels"),
                mask=torch.from_numpy(MASK), noise=torch.from_numpy(noise))
    for name in ("posterior_mean", "posterior_log_variance", "theta", "word_dist"):
        np.testing.assert_allclose(np32(getattr(out_t, name)), np.asarray(getattr(out_j, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    assert (out_t.estimated_labels is None) == (not labels) == (out_j.estimated_labels is None)
    if labels:
        np.testing.assert_allclose(np32(out_t.estimated_labels),
                                   np.asarray(out_j.estimated_labels), atol=1e-5, rtol=1e-5)
        targets = np.argmax(lab, axis=1)
        for m in (None, MASK):
            want = j_ce(out_j.estimated_labels, jnp.asarray(targets),
                        None if m is None else jnp.asarray(m))
            got = cross_entropy_with_logits(out_t.estimated_labels, torch.from_numpy(targets),
                                            None if m is None else torch.from_numpy(m))
            assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-6)
    want = j_ctm_loss(jnp.asarray(x), out_j.word_dist, out_j.prior_mean, out_j.prior_variance,
                      out_j.posterior_mean, out_j.posterior_variance,
                      out_j.posterior_log_variance, beta_weight=0.7,
                      estimated_labels=out_j.estimated_labels,
                      labels_onehot=None if lab is None else jnp.asarray(lab),
                      sample_mask=jnp.asarray(MASK))
    got = ctm_loss(batch["x_bow"], out_t.word_dist, out_t.prior_mean, out_t.prior_variance,
                   out_t.posterior_mean, out_t.posterior_variance, out_t.posterior_log_variance,
                   beta_weight=0.7, estimated_labels=out_t.estimated_labels,
                   labels_onehot=batch.get("labels"), sample_mask=torch.from_numpy(MASK))
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_state_dict_keys_and_widths_are_the_references():
    port = CombinedTM(device="cpu", **{**kw("combined", True), "inference_type": "combined"})
    shapes = {k: tuple(v.shape) for k, v in port.model.state_dict().items()}
    assert shapes["inf_net.adapt_bert.weight"] == (V, CTX)
    assert shapes["inf_net.adapt_bert.bias"] == (V,)
    assert shapes["inf_net.input_layer.weight"] == (H[0], 2 * V + L)
    assert shapes["label_classification.weight"] == (L, K)
    zs = ZeroShotTM(device="cpu", **{**kw("zeroshot", True), "inference_type": "zeroshot"})
    assert tuple(zs.model.state_dict()["inf_net.input_layer.weight"].shape) == (H[0], CTX + L)
    assert "inf_net.adapt_bert.weight" not in zs.model.state_dict()
    assert "label_classification.weight" not in CTM(device="cpu", **kw("zeroshot", False)) \
        .model.state_dict()


@pytest.mark.parametrize("kind, labels", CASES, ids=CASE_IDS)
def test_interop_bridges_ctm_trees_both_ways(kind, labels):
    j, params, stats, port = pair(kind, labels)
    back_params, back_stats = interop.flax_from_state_dict(port.model.state_dict())
    for want, got in ((params, back_params), (stats, back_stats)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            assert flat_g[path].dtype == np.asarray(leaf).dtype, path
            np.testing.assert_array_equal(flat_g[path], np.asarray(leaf), err_msg=str(path))


def test_constructor_validation_and_device():
    with pytest.raises(ValueError, match="contextual_size"):
        CTM(device="cpu", **{**kw("zeroshot", False), "contextual_size": 0})
    with pytest.raises(ValueError, match="inference_type"):
        CTM(device="cpu", **{**kw("zeroshot", False), "inference_type": "bow"})
    assert CombinedTM(device="cpu", input_size=V, contextual_size=CTX).inference_type == \
        "combined"
    assert ZeroShotTM(device="cpu", input_size=V, contextual_size=CTX).family == "ctm"


def test_entry_points_refuse_cpu_without_being_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CombinedTM(input_size=V, contextual_size=CTX)
    template = CombinedTM(input_size=V, contextual_size=CTX, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FederatedTrainer(template, n_clients=2)


# ---------------------------------------------------------------------------
# One training step against JAX
# ---------------------------------------------------------------------------
def _jax_loss(module, stats, batch, mask, noise, fused, beta_weight, storage="float32"):
    """The JAX package's training loss (``_batch_loss``/``_fused_batch_loss``,
    CTM branch) with injected noise, composed from its pieces."""
    def loss(params):
        variables = {"params": params, "batch_stats": stats}
        args = (batch["x_bow"], batch.get("x_ctx"), batch.get("labels"))
        common = dict(train=True, mask=mask, noise=noise, mutable=["batch_stats"])
        if not fused:
            out, _ = module.apply(variables, *args, **common)
            return j_ctm_loss(batch["x_bow"], out.word_dist, out.prior_mean, out.prior_variance,
                              out.posterior_mean, out.posterior_variance,
                              out.posterior_log_variance, beta_weight=beta_weight,
                              estimated_labels=out.estimated_labels,
                              labels_onehot=batch.get("labels"), sample_mask=mask)
        out, _ = module.apply(variables, *args, method="encode_theta", **common)
        bn = stats["beta_batchnorm"]
        rl, _, _ = j_fused(out.theta, params["beta"], batch["x_bow"], bn["running_mean"],
                           bn["running_var"], mask, True, 1e-5, 1e-10, True, storage)
        kl = j_gaussian_kl(out.prior_mean, out.prior_variance, out.posterior_mean,
                           out.posterior_variance, out.posterior_log_variance)
        total = jnp.sum((beta_weight * kl + rl) * mask)
        if out.estimated_labels is not None:
            total = total + j_ce(out.estimated_labels, jnp.argmax(batch["labels"], axis=1),
                                 sample_mask=mask)
        return total
    return loss


def _step(kind, labels, fused, compute_dtype="float32", beta_weight=0.7):
    """(JAX loss, JAX gradients, port loss, port gradients) of one training
    step from the same weights, batch and noise."""
    j, params, stats, port = pair(kind, labels, fused_decoder=fused, compute_dtype=compute_dtype)
    x, ctx, lab = data(labels=labels, seed=4)
    noise = np.random.default_rng(5).normal(size=(B, K)).astype(np.float32)
    jdt = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    jb = dict(zip(("x_bow", "x_ctx", "labels"), j_args(x, ctx, lab)))
    if lab is None:
        del jb["labels"]
    j_loss, j_grads = jax.value_and_grad(_jax_loss(
        j.module, stats, jb, jnp.asarray(MASK), jnp.asarray(noise, jdt), fused, beta_weight,
        compute_dtype))(jax.tree.map(jnp.asarray, params))
    net = port.model.train()
    fn = fused_batch_loss if fused else batch_loss
    loss = fn(net, t_batch(x, ctx, lab), torch.from_numpy(MASK),
              noise=torch.from_numpy(noise).to(tdt), beta_weight=beta_weight)
    assert loss.dtype == torch.float32
    loss.backward()
    want = interop.state_dict_from_flax(jax.tree.map(np.asarray, j_grads), {})
    return (float(j_loss), {n: w.numpy() for n, w in want.items()}, float(loss.detach()),
            {n: np32(p.grad) for n, p in net.named_parameters()})


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("kind, labels", CASES, ids=CASE_IDS)
def test_first_step_gradients_match_jax(kind, labels, fused):
    j_loss, j_grads, t_loss, t_grads = _step(kind, labels, fused)
    assert t_loss == pytest.approx(j_loss, rel=1e-5)
    assert sorted(t_grads) == sorted(j_grads)
    scale = max(float(np.abs(g).max()) for g in j_grads.values())
    for name, want in j_grads.items():
        if name in DEGENERATE:
            assert float(np.abs(t_grads[name]).max()) <= 1e-5 * scale, name
            assert float(np.abs(want).max()) <= 1e-5 * scale, name
        else:
            close(t_grads[name], want, name)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_step_matches_jax(kind, fused):
    """The bf16 step against JAX's, with labels: see the module docstring
    and ``tests/test_torch_bf16.py::test_teacher_forced_bf16_step_matches_jax``
    for why the gradients are held to the frameworks' own bf16 spread."""
    j32, jg32, t32, tg32 = _step(kind, True, fused)
    jbf, jgbf, tbf, tgbf = _step(kind, True, fused, "bfloat16")
    assert tbf == pytest.approx(jbf, rel=1e-2)
    for name, g32 in jg32.items():
        spread = max(float(np.abs(tgbf[name] - tg32[name]).max()),
                     float(np.abs(jgbf[name] - g32).max()))
        assert float(np.abs(tgbf[name] - jgbf[name]).max()) <= 2.0 * spread, name


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_layers_match_jax_within_one_step(kind):
    """``adapt_bert``, the encoder's input layer and the label head in bf16,
    on the same inputs, within 2^-7 of JAX's (``capture_intermediates``)."""
    j, params, stats, port = pair(kind, True, compute_dtype="bfloat16")
    x, ctx, lab = data()
    noise = np.random.default_rng(2).normal(size=(B, K)).astype(np.float32)
    _, state = j.module.apply({"params": params, "batch_stats": stats}, *j_args(x, ctx, lab),
                              train=False, noise=jnp.asarray(noise, jnp.bfloat16),
                              capture_intermediates=True, mutable=["intermediates"])
    inter = state["intermediates"]
    seen = {}
    net = port.model.eval()
    layers = {"input_layer": net.inf_net.input_layer,
              "label_classification": net.label_classification}
    if kind == "combined":
        layers["adapt_bert"] = net.inf_net.adapt_bert
    for name, layer in layers.items():
        layer.register_forward_hook(lambda _m, _i, out, name=name: seen.__setitem__(name, out))
    batch = t_batch(x, ctx, lab)
    net(batch["x_bow"], batch["x_ctx"], batch["labels"],
        noise=torch.from_numpy(noise).to(torch.bfloat16))
    wants = {"input_layer": inter["inf_net"]["input_layer"]["__call__"][0],
             "label_classification": inter["label_classification"]["__call__"][0]}
    if kind == "combined":
        wants["adapt_bert"] = inter["inf_net"]["adapt_bert"]["__call__"][0]
    for name, want in wants.items():
        assert seen[name].dtype == torch.bfloat16, name
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(np32(seen[name]), want, rtol=ULP,
                                   atol=ULP * float(np.abs(want).max()), err_msg=name)


# ---------------------------------------------------------------------------
# Two clients in lockstep with FedAvg
# ---------------------------------------------------------------------------
def _jax_fedavg(trees, weights):
    def mix(*leaves):
        if not jnp.issubdtype(leaves[0].dtype, jnp.floating):
            return leaves
        avg = sum(w * leaf for w, leaf in zip(weights, leaves)) / float(sum(weights))
        return tuple(avg for _ in leaves)

    mixed = jax.tree.map(mix, *trees)
    return [jax.tree.map(lambda t, i=i: t[i], mixed,
                         is_leaf=lambda t: isinstance(t, tuple)) for i in range(len(trees))]


def _jax_step(module, tx, params, stats, opt, batch, mask, noise, fused, beta_weight):
    def loss_fn(p):
        variables = {"params": p, "batch_stats": stats}
        args = (batch["x_bow"], batch["x_ctx"], batch.get("labels"))
        common = dict(train=True, mask=mask, noise=noise, mutable=["batch_stats"])
        if not fused:
            out, mut = module.apply(variables, *args, **common)
            loss = j_ctm_loss(batch["x_bow"], out.word_dist, out.prior_mean,
                              out.prior_variance, out.posterior_mean, out.posterior_variance,
                              out.posterior_log_variance, beta_weight=beta_weight,
                              estimated_labels=out.estimated_labels,
                              labels_onehot=batch.get("labels"), sample_mask=mask)
            return loss, mut["batch_stats"]
        out, mut = module.apply(variables, *args, method="encode_theta", **common)
        bn = stats["beta_batchnorm"]
        rl, b_mean, b_var = j_fused(out.theta, p["beta"], batch["x_bow"], bn["running_mean"],
                                    bn["running_var"], mask, True, 1e-5, 1e-10, True)
        kl = j_gaussian_kl(out.prior_mean, out.prior_variance, out.posterior_mean,
                           out.posterior_variance, out.posterior_log_variance)
        loss = jnp.sum((beta_weight * kl + rl) * mask)
        if out.estimated_labels is not None:
            loss = loss + j_ce(out.estimated_labels, jnp.argmax(batch["labels"], axis=1),
                               sample_mask=mask)
        cnt = jnp.maximum(jnp.sum(mask), 1.0)
        new_bs = dict(mut["batch_stats"])
        new_bs["beta_batchnorm"] = {
            "running_mean": 0.9 * bn["running_mean"] + 0.1 * b_mean,
            "running_var": 0.9 * bn["running_var"]
            + 0.1 * b_var * (cnt / jnp.maximum(cnt - 1.0, 1.0)),
            "num_batches_tracked": bn["num_batches_tracked"] + 1,
        }
        return loss, new_bs

    (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, opt = tx.update(grads, opt, params)
    return optax.apply_updates(params, updates), new_bs, opt


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("kind", KINDS)
def test_two_clients_lockstep_with_fedavg(kind, fused, steps):
    """Two CTM clients with labels (unequal FedAvg weights), stepped in
    lockstep on the same numpy schedules and noise: the port's
    ``grad_step`` and ``FederatedTrainer._fedavg`` against JAX's loss,
    optax Adam and a weighted mean; then params, BatchNorm buffers and Adam
    moments are held as ``tests/test_torch_train.py`` holds them."""
    bw = 0.7
    j, params, stats, port = pair(kind, True, fused_decoder=fused,
                                  loss_weights={"beta": bw})
    corpora = [data(40, seed=1), data(30, seed=2)]
    weights = [40.0, 30.0]
    scheds = [make_run_schedule(len(d[0]), B, steps, seed=c) for c, d in enumerate(corpora)]
    noise = np.random.default_rng(9).normal(size=(steps, 2, B, K)).astype(np.float32)
    tx = optax.adam(LR, b1=0.99, b2=0.99, eps=1e-8)
    j_params = [jax.tree.map(jnp.asarray, params) for _ in range(2)]
    j_bs = [jax.tree.map(jnp.asarray, stats) for _ in range(2)]
    j_opt = [tx.init(p) for p in j_params]
    trainer = FederatedTrainer(port, n_clients=2, device="cpu")
    models = [copy.deepcopy(port.model) for _ in range(2)]
    opts = [port.build_optimizer(m) for m in models]
    for step in range(steps):
        for c in range(2):
            idx, mask = scheds[c].indices[step], scheds[c].mask[step].astype(np.float32)
            x, ctx, lab = (a[idx] for a in corpora[c])
            jb = {"x_bow": jnp.asarray(x), "x_ctx": jnp.asarray(ctx), "labels": jnp.asarray(lab)}
            j_params[c], j_bs[c], j_opt[c] = _jax_step(
                j.module, tx, j_params[c], j_bs[c], j_opt[c], jb, jnp.asarray(mask),
                jnp.asarray(noise[step, c]), fused, bw)
            grad_step(models[c], opts[c], t_batch(x, ctx, lab), torch.from_numpy(mask), fused,
                      noise=torch.from_numpy(noise[step, c]), beta_weight=port._beta_weight())
        j_params = _jax_fedavg(j_params, weights)
        j_bs = _jax_fedavg(j_bs, weights)
        trainer._fedavg(models, torch.tensor(weights), sum(weights))
    init = interop.state_dict_from_flax(params, {})
    for c in range(2):
        want = interop.state_dict_from_flax(jax.tree.map(np.asarray, j_params[c]),
                                            jax.tree.map(np.asarray, j_bs[c]))
        mu = interop.state_dict_from_flax(jax.tree.map(np.asarray, j_opt[c][0].mu), {})
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
            if name not in DEGENERATE:
                close(opts[c].state[p]["exp_avg"].numpy(), mu[name].numpy(),
                      f"client {c} Adam m {name}")
    for key, value in models[0].state_dict().items():
        assert torch.equal(value, models[1].state_dict()[key]), key


def test_federated_trainer_stages_ctm_data_and_returns_ctms():
    """``FederatedTrainer.fit`` of a CombinedTM template with labels: every
    step equals a replay through ``grad_step`` on the staged x_bow, x_ctx
    and labels with the trainer's generator, the clients' state is equal
    after each exchange, and the global and client models are CombinedTMs."""
    corpora = [CTMDataset(X=x, X_ctx=c, labels=lab)
               for x, c, lab in (data(40, seed=1), data(24, seed=2))]
    template = CombinedTM(device="cpu", **{**kw("combined", True), "num_epochs": 2,
                                           "dropout": 0.2, "loss_weights": {"beta": 0.5}})
    result = FederatedTrainer(template, n_clients=2, device="cpu", seed=3).fit(corpora)
    assert result.losses.shape == (6, 2) and np.isfinite(result.losses).all()
    for key, value in result.client_params[0].items():
        assert torch.equal(value, result.client_params[1][key]), key

    models = [copy.deepcopy(template.model) for _ in range(2)]
    opts = [template.build_optimizer(m) for m in models]
    gen = torch.Generator().manual_seed(3 + 17)
    scheds = [make_run_schedule(len(d), B, 6, seed=3000 + c) for c, d in enumerate(corpora)]
    staged = [template._device_data(d) for d in corpora]
    assert all(set(s) == {"x_bow", "x_ctx", "labels"} for s in staged)
    trainer = FederatedTrainer(template, n_clients=2, device="cpu")
    for s in range(6):
        for c in range(2):
            idx = torch.as_tensor(scheds[c].indices[s], dtype=torch.long)
            loss = grad_step(models[c], opts[c], {k: v[idx] for k, v in staged[c].items()},
                             torch.as_tensor(scheds[c].mask[s], dtype=torch.float32), True,
                             generator=gen, beta_weight=0.5)
            assert float(loss) == result.losses[s, c]
        trainer._fedavg(models, torch.tensor([40.0, 24.0]), 64.0)
    glob = FederatedTrainer(template, n_clients=2, device="cpu").make_global_model(
        result, corpora[0])
    assert isinstance(glob, CombinedTM)
    theta = glob.get_doc_topic_distribution(corpora[0], n_samples=3)
    assert theta.shape == (40, K) and np.allclose(theta.sum(1), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# fit with validation, persistence, inference
# ---------------------------------------------------------------------------
def test_fit_with_validation_and_the_eval_loss_match_jax(tmp_path):
    """``CTM.fit`` validates every epoch, stops early and saves on each
    improvement as ``AVITM.fit`` does; its eval loss (with labels, on a
    trained state, with injected noise) equals the JAX eval forward's
    ``ctm_loss`` within 1e-5."""
    x, ctx, lab = data(48, seed=7)
    xv, cv, lv = data(20, seed=8)
    train = CTMDataset(X=x, X_ctx=ctx, labels=lab)
    val = CTMDataset(X=xv, X_ctx=cv, labels=lv)
    model = CombinedTM(device="cpu", **{**kw("combined", True), "num_epochs": 3,
                                        "loss_weights": {"beta": 0.5}})
    model.fit(train, val, save_dir=str(tmp_path), patience=5)
    assert len(model.validation_losses) == len(model.epoch_losses) == 3
    assert np.isfinite(model.validation_losses).all()
    assert any(p.suffix == ".npz" for p in tmp_path.iterdir())
    assert model.training_doc_topic_distributions.shape == (48, K)

    params, stats = interop.flax_from_state_dict(model.model.state_dict())
    j = JCTM(**{**kw("combined", True), "loss_weights": {"beta": 0.5}})
    sched = make_epoch_schedule(20, B, np.random.default_rng(3))
    noise = np.random.default_rng(4).normal(size=(sched.steps_per_epoch, B, K)).astype(
        np.float32)
    got = eval_epoch(model.model, model._device_data(val), torch.as_tensor(sched.indices).long(),
                     torch.as_tensor(sched.mask, dtype=torch.float32),
                     noise=torch.from_numpy(noise), beta_weight=0.5)
    for i in range(sched.steps_per_epoch):
        idx, m = sched.indices[i], jnp.asarray(sched.mask[i], jnp.float32)
        out = j.module.apply({"params": params, "batch_stats": stats}, *j_args(xv[idx], cv[idx],
                                                                              lv[idx]),
                             train=False, noise=jnp.asarray(noise[i]))
        want = float(j_ctm_loss(jnp.asarray(xv[idx]), out.word_dist, out.prior_mean,
                                out.prior_variance, out.posterior_mean, out.posterior_variance,
                                out.posterior_log_variance, beta_weight=0.5,
                                estimated_labels=out.estimated_labels,
                                labels_onehot=jnp.asarray(lv[idx]), sample_mask=m))
        assert float(got[i]) == pytest.approx(want, rel=1e-5, abs=1e-5), i


@pytest.mark.parametrize("kind", KINDS)
def test_save_load_round_trips_bitwise_with_jax(kind, tmp_path):
    j, params, stats, port = pair(kind, True)
    x, ctx, lab = data(32, seed=3)
    port.fit(CTMDataset(X=x, X_ctx=ctx, labels=lab))
    port.save(str(tmp_path / "port"))
    j.load(str(tmp_path / "port"), port.nn_epoch)
    got = interop.state_dict_from_flax(jax.tree.map(np.asarray, j.params),
                                       jax.tree.map(np.asarray, j.batch_stats))
    for key, value in port.model.state_dict().items():
        assert torch.equal(got[key], value), key
    j.nn_epoch = 7
    j.save(str(tmp_path / "jax"))
    fresh = CTM(device="cpu", **kw(kind, True))
    fresh.load(str(tmp_path / "jax"), 7)
    for key, value in port.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[key], value), key
    np.testing.assert_array_equal(fresh.best_components, port.model.beta.detach().numpy())


@pytest.mark.parametrize("kind, labels", CASES, ids=CASE_IDS)
def test_doc_topic_distribution_reads_the_contextual_inputs(kind, labels):
    """``get_doc_topic_distribution`` averages ``get_theta`` draws on the
    dataset's embeddings (and labels), batch by batch; the deterministic
    theta (``noise=0``) equals JAX's ``get_theta``."""
    j, params, stats, port = pair(kind, labels)
    x, ctx, lab = data(20, seed=6, labels=labels)
    ds = CTMDataset(X=x, X_ctx=ctx, labels=lab)
    state = port.generator.get_state()
    got = port.get_doc_topic_distribution(ds, n_samples=4)
    assert got.shape == (20, K)
    port.generator.set_state(state)
    batch = t_batch(np.concatenate([x, x[:12]]), np.concatenate([ctx, ctx[:12]]),
                    None if lab is None else np.concatenate([lab, lab[:12]]))
    want = []
    for rows in (slice(0, 16), slice(16, 32)):
        draws = [port.model.get_theta(batch["x_bow"][rows], batch["x_ctx"][rows],
                                      None if lab is None else batch["labels"][rows],
                                      generator=port.generator) for _ in range(4)]
        want.append(torch.stack(draws).mean(0))
    np.testing.assert_array_equal(got, torch.cat(want).detach().numpy()[:20])
    with torch.no_grad():
        det = port.model.get_theta(batch["x_bow"][:20], batch["x_ctx"][:20],
                                   None if lab is None else batch["labels"][:20], noise=0.0)
    j_det = j.module.apply({"params": params, "batch_stats": stats}, *j_args(x, ctx, lab),
                           method="get_theta", noise=0.0)
    np.testing.assert_allclose(det.numpy(), np.asarray(j_det), atol=1e-5, rtol=1e-5)


def test_inspection_apis():
    x, ctx, lab = data(24, seed=9)
    ds = CTMDataset(X=x, X_ctx=ctx, labels=lab, idx2token={i: f"w{i}" for i in range(V)})
    model = CombinedTM(device="cpu", **{**kw("combined", True), "num_epochs": 1})
    model.fit(ds, n_samples=2)
    pairs = model.get_word_distribution_by_topic_id(1)
    assert len(pairs) == V and pairs[0][0].startswith("w")
    assert [p for _, p in pairs] == sorted((p for _, p in pairs), reverse=True)
    with pytest.raises(ValueError):
        model.get_word_distribution_by_topic_id(K)
    theta = model.training_doc_topic_distributions
    docs = [f"doc {i}" for i in range(24)]
    top = model.get_top_documents_per_topic_id(docs, theta, 2, k=3)
    assert [d for d, _ in top] == [docs[i] for i in np.argsort(-theta[:, 2])[:3]]
    vis = model.get_ldavis_data_format([f"w{i}" for i in range(V)], ds, n_samples=2)
    np.testing.assert_array_equal(vis["term_frequency"], x.sum(0))
    assert vis["doc_topic_dists"].shape == (24, K)


def test_count_screen_reads_the_bow_only(caplog):
    """bf16 compute screens the BoW counts once; real-valued embeddings
    beyond 256 do not trip it."""
    x, ctx, lab = data(8)
    model = CTM(device="cpu", **kw("zeroshot", True, compute_dtype="bfloat16"))
    with caplog.at_level("WARNING"):
        model._device_data(CTMDataset(X=x, X_ctx=ctx * 1e4, labels=lab))
    assert "bfloat16" not in caplog.text
    big = CTM(device="cpu", **kw("zeroshot", True, compute_dtype="bfloat16"))
    with caplog.at_level("WARNING"):
        big._device_data(CTMDataset(X=x * 100, X_ctx=ctx, labels=lab))
    assert "bfloat16" in caplog.text


@pytest.mark.parametrize("dim", [64, 768])
def test_hashing_embedder_is_the_jax_packages_bitwise(dim):
    texts = ["the quick brown fox", "", "a a a b", "résumé naïve café", "x " * 50,
             "topic model federated learning on accelerators"]
    got, want = hashing_embedder(dim)(texts), j_hashing_embedder(dim)(texts)
    assert got.dtype == want.dtype == np.float32 and got.shape == (len(texts), dim)
    np.testing.assert_array_equal(got, want)

