"""The CTM family under the port's sharded fits, on the CPU over spawned gloo
ranks: ``fit_sharded`` of ZeroShotTM and CombinedTM with labels (fused, so
the decode takes K5) at dp x mp in {1 x 2, 2 x 2}, validating every epoch,
and ``fit_data_sharded`` of both (unfused) at dp=2, against the port's
unsharded fit and the JAX package, from the same bridged weights and numpy
schedules.

On a rank of the model group CombinedTM's ``adapt_bert`` projects onto the
rank's columns, and its input layer sums the ranks' products of their BoW
and ``adapt_bert`` column blocks, adding the label columns' product and the
bias once; ZeroShotTM's encoder is replicated. The label cross-entropy is a
mean over the whole batch's real rows, so each data rank divides by that
count. Contextual embeddings and labels split over the data group only.

Tolerances (those of ``tests/test_torch_sharded_fit.py`` and
``tests/test_torch_data_parallel.py``):

- first-step gradients with injected noise: loss within 1e-6 relative of the
  unsharded port's, each gradient within 5e-4 x its max|grad|, the leaves
  whose gradient cancels in exact arithmetic within 1e-5 x the largest
  gradient; against JAX's gradient of the same batch and noise: loss within
  1e-5 relative, gradients as above;
- step losses within 1e-5 relative of the unsharded fit's, beta and the
  decoder BatchNorm's statistics within 1e-4;
- each validation loss within 1e-6 relative of the unsharded eval
  teacher-forced from the gathered state, generator state and schedule it
  validated with, and the validation losses within 1e-4 relative of the
  unsharded fit's;
- the replicated state bitwise equal on every rank;
- JAX's GSPMD ``fit_sharded`` (dp=2 x mp=2) draws other noise (Threefry, not
  Philox): its final epoch loss within the 5% envelope of
  ``tests/test_torch_data_parallel.py``.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfedntm_tpu.data.datasets import CTMDataset as JCTMDataset
from gfedntm_tpu.models.ctm import CTM as JCTM
from gfedntm_tpu.models.losses import cross_entropy_with_logits as j_ce
from gfedntm_tpu.models.losses import gaussian_kl as j_gaussian_kl
from gfedntm_tpu.ops.fused_decoder import prodlda_recon_loss as j_fused
from gfedntm_tpu.parallel.sharded import fit_sharded as j_fit_sharded
from gfedntm_tpu_torch import interop
from gfedntm_tpu_torch.data.datasets import CTMDataset
from gfedntm_tpu_torch.models.ctm import CTM
from gfedntm_tpu_torch.parallel import programs
from gfedntm_tpu_torch.parallel.launch import run_ranks
from gfedntm_tpu_torch.parallel.mesh import DpMpGroups
from gfedntm_tpu_torch.parallel.sharded import SPLITS, local_network, shard_state_dict

V, K, H, B, DOCS, VAL_DOCS, CTX, L, EPOCHS = 96, 6, (8, 8), 16, 48, 16, 12, 3, 2
KINDS = ("zeroshot", "combined")
LAYOUTS = ((1, 2), (2, 2))
DEGENERATE = ("inf_net.f_mu.bias", "inf_net.f_sigma.bias", "prior_mean")
ENVELOPE = 0.05
TIMEOUT_S = 300


def kw(kind, **over):
    return {**dict(input_size=V, contextual_size=CTX, n_components=K, hidden_sizes=H,
                   batch_size=B, num_epochs=EPOCHS, dropout=0.0, seed=0, fused_decoder=True,
                   inference_type=kind, label_size=L, loss_weights={"beta": 0.5}), **over}


def corpus(n: int = DOCS, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"X": rng.integers(0, 3, size=(n, V)).astype(np.float32),
            "X_ctx": rng.normal(size=(n, CTX)).astype(np.float32),
            "labels": np.eye(L, dtype=np.float32)[rng.integers(0, L, n)]}


def port_model(init, kind, **over):
    model = CTM(device="cpu", **kw(kind, **over))
    model.model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in init.items()})
    return model


def jax_first_step(j_model, batch, mask, noise):
    """Loss and gradients of the JAX fused CTM training loss (the CTM branch
    of ``_fused_batch_loss``) on one batch with injected noise, in torch's
    names and layouts."""
    module, params, bs = j_model.module, j_model.params, j_model.batch_stats

    def loss_fn(p):
        out, _ = module.apply({"params": p, "batch_stats": bs}, batch["x_bow"], batch["x_ctx"],
                              batch["labels"], train=True, mask=mask, noise=noise,
                              mutable=["batch_stats"], method="encode_theta")
        bn = bs["beta_batchnorm"]
        rl, _, _ = j_fused(out.theta, p["beta"], batch["x_bow"], bn["running_mean"],
                           bn["running_var"], mask, True, 1e-5, 1e-10, True)
        kl = j_gaussian_kl(out.prior_mean, out.prior_variance, out.posterior_mean,
                           out.posterior_variance, out.posterior_log_variance)
        return jnp.sum((0.5 * kl + rl) * mask) + j_ce(
            out.estimated_labels, jnp.argmax(batch["labels"], axis=1), sample_mask=mask)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    flat = interop.state_dict_from_flax(jax.tree.map(np.asarray, grads), {})
    return float(loss), {k: v.numpy() for k, v in flat.items()}


@pytest.fixture(scope="module")
def runs():
    X, Xv = corpus(), corpus(VAL_DOCS, 5)
    noise = np.random.default_rng(9).normal(size=(B, K)).astype(np.float32)
    out = {"X": X, "Xv": Xv, "noise": noise}
    jobs = {}
    for kind in KINDS:
        j_model = JCTM(**kw(kind))
        params = jax.tree.map(np.asarray, j_model.params)
        stats = jax.tree.map(np.asarray, j_model.batch_stats)
        init = {k: v.numpy() for k, v in interop.state_dict_from_flax(params, stats).items()}
        idx, mask = programs._batch(port_model(init, kind), DOCS, 0)
        j_grads = jax_first_step(j_model, {"x_bow": jnp.asarray(X["X"][idx]),
                                           "x_ctx": jnp.asarray(X["X_ctx"][idx]),
                                           "labels": jnp.asarray(X["labels"][idx])},
                                 jnp.asarray(mask, jnp.float32), jnp.asarray(noise))
        out[kind] = dict(init=init, jax=j_model, j_grads=j_grads)
        for dp, mp in LAYOUTS:
            jobs["fit", kind, dp, mp] = (programs.fit, dp * mp, (
                dp, mp, kw(kind), X, init, 2, 0, Xv, None, 5, 0.0, noise))
        jobs["data", kind] = (programs.fit_data, 2, (2, kw(kind, fused_decoder=False), X, init,
                                                    2))
    with ThreadPoolExecutor(3) as pool:
        futures = {key: pool.submit(run_ranks, fn, world, "gloo", ["cpu"] * world, TIMEOUT_S,
                                    args) for key, (fn, world, args) in jobs.items()}
        out["ranks"] = {key: future.result() for key, future in futures.items()}
    # JAX's GSPMD fit of the combined model on the virtual CPU devices.
    j_combined = out["combined"]["jax"]
    j_fit_sharded(j_combined, JCTMDataset(X=X["X"], X_ctx=X["X_ctx"], labels=X["labels"],
                                          idx2token={i: f"wd{i}" for i in range(V)}),
                  dp=2, mp=2)
    data = CTMDataset(X=X["X"], X_ctx=X["X_ctx"], labels=X["labels"])
    for kind in KINDS:
        init = out[kind]["init"]
        ref = port_model(init, kind)
        ref.fit(data, CTMDataset(X=Xv["X"], X_ctx=Xv["X_ctx"], labels=Xv["labels"]),
                n_samples=2)
        unfused = port_model(init, kind, fused_decoder=False)
        unfused.fit(data, n_samples=2)
        out[kind].update(
            ref=ref, unfused=unfused,
            ref_step=programs.step_gradients(port_model(init, kind), X, noise=noise),
            ref_step_unfused=programs.step_gradients(port_model(init, kind,
                                                                fused_decoder=False), X))
    return out


def assert_grads_match(step, ref, rel_loss=1e-6):
    (loss, grads), (ref_loss, ref_grads) = step, ref
    assert loss == pytest.approx(ref_loss, rel=rel_loss)
    assert sorted(grads) == sorted(ref_grads)
    scale = max(float(np.abs(g).max()) for g in ref_grads.values())
    for name, want in ref_grads.items():
        assert grads[name].shape == want.shape, name
        if name in DEGENERATE:
            assert float(np.abs(grads[name]).max()) <= 1e-5 * scale, name
        else:
            err = float(np.abs(grads[name] - want).max())
            assert err < 5e-4 * float(np.abs(want).max()), (name, err)


def assert_fit_matches(res, ref):
    np.testing.assert_allclose(res["step_losses"], ref.step_losses, rtol=1e-5)
    full = ref.model.state_dict()
    for name in ("beta", "beta_batchnorm.running_mean", "beta_batchnorm.running_var"):
        np.testing.assert_allclose(res["state"][name], full[name].numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)
    assert sorted(res["state"]) == sorted(full)


LAYOUT_CASES = [(kind, dp, mp) for kind in KINDS for dp, mp in LAYOUTS]


@pytest.mark.parametrize("kind, dp, mp", LAYOUT_CASES)
def test_fit_sharded_matches_the_unsharded_fit(runs, kind, dp, mp):
    res = runs["ranks"]["fit", kind, dp, mp][0]
    assert len(res["epoch_losses"]) == EPOCHS
    assert_fit_matches(res, runs[kind]["ref"])


@pytest.mark.parametrize("kind, dp, mp", LAYOUT_CASES)
def test_first_step_gradients_match_unsharded(runs, kind, dp, mp):
    assert_grads_match(runs["ranks"]["fit", kind, dp, mp][0]["first_step"],
                       runs[kind]["ref_step"])


@pytest.mark.parametrize("kind", KINDS)
def test_first_step_gradients_match_jax(runs, kind):
    assert_grads_match(runs["ranks"]["fit", kind, 2, 2][0]["first_step"],
                       runs[kind]["j_grads"], rel_loss=1e-5)


@pytest.mark.parametrize("kind, dp, mp", LAYOUT_CASES)
def test_replicated_state_bitwise_equal_on_every_rank(runs, kind, dp, mp):
    ranks = runs["ranks"]["fit", kind, dp, mp]
    assert len(ranks) == dp * mp
    assert programs.state_digest(ranks[0]["state"]) == ranks[0]["state_digest"]
    for r in ranks[1:]:
        assert r["state"] is None
        assert r["state_digest"] == ranks[0]["state_digest"]
        assert r["step_losses"] == ranks[0]["step_losses"]
        assert r["validation_losses"] == ranks[0]["validation_losses"]
        np.testing.assert_array_equal(r["theta"], ranks[0]["theta"])


@pytest.mark.parametrize("kind, dp, mp", LAYOUT_CASES)
def test_validation_matches_the_teacher_forced_unsharded_eval(runs, kind, dp, mp):
    """Each epoch's validation record holds the full state in the unsharded
    network's keys and shapes (CombinedTM's input layer and ``adapt_bert``
    gathered over both vocabulary blocks), and the unsharded eval from it
    gives the sharded validation loss."""
    res, init = runs["ranks"]["fit", kind, dp, mp][0], runs[kind]["init"]
    assert len(res["validations"]) == EPOCHS
    for record in res["validations"]:
        assert {k: v.shape for k, v in record["state"].items()} == \
            {k: np.shape(v) for k, v in init.items()}
        replay = programs.replay_validation(port_model(init, kind), runs["Xv"], record)
        assert replay == pytest.approx(record["val_loss"], rel=1e-6)
    np.testing.assert_allclose(res["validation_losses"], runs[kind]["ref"].validation_losses,
                               rtol=1e-4)


@pytest.mark.parametrize("kind, dp, mp", LAYOUT_CASES)
def test_ranks_hold_their_columns(runs, kind, dp, mp):
    """beta, its BatchNorm, and CombinedTM's ``adapt_bert`` and both V-wide
    blocks of its input layer hold V/mp columns; ZeroShotTM's encoder and
    the label head are whole."""
    for r in runs["ranks"]["fit", kind, dp, mp]:
        shapes = r["local_shapes"]
        assert shapes["beta"] == (K, V // mp)
        assert shapes["beta_batchnorm.running_var"] == (V // mp,)
        assert shapes["label_classification.weight"] == (L, K)
        if kind == "combined":
            assert shapes["inf_net.adapt_bert.weight"] == (V // mp, CTX)
            assert shapes["inf_net.adapt_bert.bias"] == (V // mp,)
            assert shapes["inf_net.input_layer.weight"] == (H[0], 2 * V // mp + L)
        else:
            assert shapes["inf_net.input_layer.weight"] == (H[0], CTX + L)


@pytest.mark.parametrize("kind", KINDS)
def test_fit_data_sharded_matches_the_unsharded_fit(runs, kind):
    ranks = runs["ranks"]["data", kind]
    assert_fit_matches(ranks[0], runs[kind]["unfused"])
    assert_grads_match(ranks[0]["first_step"], runs[kind]["ref_step_unfused"])
    for r in ranks[1:]:
        for key, value in r["state"].items():
            np.testing.assert_array_equal(value, ranks[0]["state"][key], err_msg=key)
    assert ranks[0]["summary"]["devices"] == 2


def test_final_loss_within_envelope_of_jax_fit_sharded(runs):
    port = runs["ranks"]["fit", "combined", 2, 2][0]["epoch_losses"][-1]
    jax_ = runs["combined"]["jax"].epoch_losses[-1]
    assert abs(port - jax_) / jax_ < ENVELOPE, (port, jax_)


@pytest.mark.parametrize("rank", range(2))
def test_combined_split_slices_both_vocabulary_blocks(runs, rank):
    """The rank's slice of the full combined state: its columns of each
    V-wide block of the input layer then the label columns whole, and its
    rows of ``adapt_bert``; the local network runs on it."""
    full = {k: torch.from_numpy(np.asarray(v)) for k, v in runs["combined"]["init"].items()}
    groups = DpMpGroups(1, 2, rank)
    local = shard_state_dict(full, groups, "combined")
    cols = groups.v_slice(V)
    w = full["inf_net.input_layer.weight"]
    want = torch.cat([w[:, cols], w[:, V + cols.start:V + cols.stop], w[:, 2 * V:]], dim=1)
    assert torch.equal(local["inf_net.input_layer.weight"], want)
    assert torch.equal(local["inf_net.adapt_bert.weight"], full["inf_net.adapt_bert.weight"][cols])
    assert torch.equal(local["label_classification.weight"], full["label_classification.weight"])
    assert set(SPLITS["zeroshot"]) == {"beta", "beta_batchnorm.running_mean",
                                       "beta_batchnorm.running_var"}
    net = local_network(port_model(runs["combined"]["init"], "combined").model,
                        DpMpGroups(1, 1, 0))
    assert net.inf_net.adapt_bert.out_features == V
