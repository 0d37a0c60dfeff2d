"""The unfused prodLDA and the LDA decodes under the port's ``fit_sharded``
at mp > 1, on the CPU over spawned gloo ranks, against the port's unsharded
``AVITM.fit`` and against the JAX package's GSPMD ``fit_sharded`` on the
virtual CPU devices, from the same bridged weights and numpy schedules.

On rank r the decode runs on its columns: prodLDA ``softmax(BN(theta
beta_r))`` and LDA ``theta softmax(BN(beta_r))``, each softmax over V merged
over the model group, theta's decode gradient summed over it, and the
reconstruction term summed over it (``gfedntm_tpu/models/networks.py:
275-294`` under ``gfedntm_tpu/parallel/sharded.py:114-250``).

- Port sharded vs unsharded, dp x mp in {1x2, 2x2}, dropout 0, live
  reparameterization noise in the fits (every draw is the unsharded run's):
  first-step gradients with injected noise within 1e-5 of each leaf's
  max|grad| (the leaves that cancel in exact arithmetic: of the largest), or
  within twice a witness's distance where that is larger: the unsharded
  network with only its encoder input layer summed over two column blocks
  (``chip_smoke.split_input_layer``, the reduction order sharding gives the
  encoder) already moves LDA's ``inf_net.hiddens.l_0.0.bias`` by 1.3e-5 of
  its max|grad| at random weights, float32 rounding that the encoder
  BatchNorms amplify; step losses within 1e-5 relative, beta and ``beta_batchnorm``'s running
  statistics within 1e-4, the state bitwise equal on every rank, no kernel
  launched and K5 never called.
- Validation at mp=2: each epoch's loss within 1e-6 relative of the
  unsharded eval teacher-forced from the same state, generator state and
  schedule, and within 1e-4 of the unsharded fit's.
- Against JAX (dp=2 x mp=2): with injected noise the first-step gradients
  within 1e-5 of each leaf's max|grad|, or within
  twice the unsharded port's own distance to JAX on that leaf where that is
  larger: float32 rounding alone puts the unsharded port up to 9.1e-6 from
  JAX on the encoder's biases at these random weights, and the sharded
  sums' order adds to it (measured up to 1.06e-5, LDA's
  ``inf_net.hiddens.l_0.0.bias``). Threefry and Philox draws never agree,
  so the final epoch loss is held within the 5% envelope of
  ``tests/test_torch_data_parallel.py``.
- bf16 at mp=2 against the unsharded bf16 fit, with the bounds of
  ``tests/test_torch_bf16.py``: step losses within 1e-2 relative,
  first-step gradients within 1e-2 of the largest gradient, float32 state
  bitwise equal on both ranks.
"""

import importlib.util
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfedntm_tpu.data.datasets import BowDataset as JBowDataset
from gfedntm_tpu.models.avitm import AVITM as JAVITM
from gfedntm_tpu.models.losses import avitm_loss as j_avitm_loss
from gfedntm_tpu.parallel.sharded import fit_sharded as j_fit_sharded
from gfedntm_tpu_torch import interop
from gfedntm_tpu_torch.data.datasets import BowDataset
from gfedntm_tpu_torch.models.avitm import AVITM
from gfedntm_tpu_torch.parallel import programs
from gfedntm_tpu_torch.parallel.launch import run_ranks
from gfedntm_tpu_torch.parallel.mesh import DpMpGroups
from gfedntm_tpu_torch.parallel.sharded import fit_sharded, local_network

V, K, H, B, DOCS, VAL_DOCS, EPOCHS = 96, 6, (8, 8), 16, 48, 16, 2
MODEL_TYPES = ("prodLDA", "LDA")
LAYOUTS = ((1, 2), (2, 2))
DEGENERATE = ("inf_net.f_mu.bias", "inf_net.f_sigma.bias", "prior_mean")
ENVELOPE = 0.05
TIMEOUT_S = 300
BF16_TOL = 1e-2


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_decodes_under_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kw(model_type, **over):
    return {**dict(input_size=V, n_components=K, hidden_sizes=H, batch_size=B,
                   num_epochs=EPOCHS, dropout=0.0, seed=0, fused_decoder=False,
                   model_type=model_type), **over}


def corpus(docs, seed):
    return np.random.default_rng(seed).integers(0, 3, size=(docs, V)).astype(np.float32)


def bridged_init(j_model) -> dict:
    params = jax.tree.map(np.asarray, j_model.params)
    stats = jax.tree.map(np.asarray, j_model.batch_stats)
    return {k: v.numpy() for k, v in interop.state_dict_from_flax(params, stats).items()}


def port_model(init, model_type, **over):
    model = AVITM(device="cpu", **kw(model_type, **over))
    model.model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in init.items()})
    return model


def jax_first_step_grads(j_model, x, mask, noise):
    """Loss and gradients of the JAX unfused training loss on one batch with
    injected noise, in torch's state-dict names and layouts."""
    module, params, bs = j_model.module, j_model.params, j_model.batch_stats

    def loss_fn(p):
        out, _ = module.apply({"params": p, "batch_stats": bs}, x, train=True, mask=mask,
                              noise=noise, mutable=["batch_stats"])
        return j_avitm_loss(x, out.word_dist, out.prior_mean, out.prior_variance,
                            out.posterior_mean, out.posterior_variance,
                            out.posterior_log_variance, sample_mask=mask)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    flat = interop.state_dict_from_flax(jax.tree.map(np.asarray, grads), {})
    return float(loss), {k: v.numpy() for k, v in flat.items()}


@pytest.fixture(scope="module")
def runs():
    X, Xv = corpus(DOCS, 0), corpus(VAL_DOCS, 5)
    noise = np.random.default_rng(9).normal(size=(B, K)).astype(np.float32)
    out = {"X": X, "Xv": Xv, "noise": noise}
    jobs = {}
    for mt in MODEL_TYPES:
        j_model = JAVITM(**kw(mt))
        init = bridged_init(j_model)
        idx, mask = programs._batch(port_model(init, mt), DOCS, 0)
        j_grads = jax_first_step_grads(j_model, jnp.asarray(X[idx]),
                                       jnp.asarray(mask, jnp.float32), jnp.asarray(noise))
        j_fit_sharded(j_model, JBowDataset(X=X, idx2token={i: f"wd{i}" for i in range(V)}),
                      dp=2, mp=2)
        out[mt] = dict(init=init, jax=j_model, j_grads=j_grads)
        for dp, mp in LAYOUTS:
            jobs["fit", mt, dp, mp] = (programs.fit, dp * mp, (
                dp, mp, kw(mt), X, init, 2, 0, Xv, None, 5, 0.0, noise))
        jobs["bf16", mt] = (programs.fit, 2, (1, 2, kw(mt, num_epochs=1,
                                                      compute_dtype="bfloat16"), X, init, 1, 0))
    with ThreadPoolExecutor(3) as pool:
        futures = {key: pool.submit(run_ranks, fn, world, "gloo", ["cpu"] * world, TIMEOUT_S,
                                    args) for key, (fn, world, args) in jobs.items()}
        out["ranks"] = {key: future.result() for key, future in futures.items()}

    split_input_layer = _chip_smoke().split_input_layer
    for mt in MODEL_TYPES:
        init = out[mt]["init"]
        split = port_model(init, mt)
        split_input_layer(split, 2)
        ref = port_model(init, mt)
        ref.fit(BowDataset(X=X), BowDataset(X=Xv), n_samples=2)
        ref_bf16 = port_model(init, mt, num_epochs=1, compute_dtype="bfloat16")
        ref_bf16.fit(BowDataset(X=X), n_samples=1)
        ref_step = programs.step_gradients(port_model(init, mt), X, noise=noise)
        out[mt].update(
            ref=ref, ref_bf16=ref_bf16, ref_step=ref_step,
            witness=grad_errors(programs.step_gradients(split, X, noise=noise)[1], ref_step[1]),
            ref_step_bf16=programs.step_gradients(
                port_model(init, mt, num_epochs=1, compute_dtype="bfloat16"), X))
    return out


def grad_errors(grads, ref_grads) -> dict:
    """Each leaf's max |diff| over its own max|grad|; the cancelling leaves'
    over the largest gradient."""
    scale = max(float(np.abs(g).max()) for g in ref_grads.values())
    return {name: float(np.abs(grads[name] - want).max())
            / (scale if name in DEGENERATE else float(np.abs(want).max()))
            for name, want in ref_grads.items()}


def assert_grads_match(grads, ref_grads, witness, rel=1e-5):
    """Each leaf within ``rel`` or twice the witness's error on it."""
    assert sorted(grads) == sorted(ref_grads)
    for name, err in grad_errors(grads, ref_grads).items():
        assert grads[name].shape == ref_grads[name].shape, name
        assert err <= max(rel, 2.0 * witness[name]), (name, err, witness[name])


LAYOUT_CASES = [(mt, dp, mp) for mt in MODEL_TYPES for dp, mp in LAYOUTS]


@pytest.mark.parametrize("mt, dp, mp", LAYOUT_CASES)
def test_fit_sharded_matches_the_unsharded_fit(runs, mt, dp, mp):
    ref = runs[mt]["ref"]
    res = runs["ranks"]["fit", mt, dp, mp][0]
    state = res["state"]
    assert len(res["epoch_losses"]) == EPOCHS
    np.testing.assert_allclose(res["step_losses"], ref.step_losses, rtol=1e-5)
    np.testing.assert_allclose(state["beta"], ref.model.beta.detach().numpy(), rtol=0,
                               atol=1e-4)
    for name in ("beta_batchnorm.running_mean", "beta_batchnorm.running_var"):
        np.testing.assert_allclose(state[name], ref.model.state_dict()[name].numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(state["beta_batchnorm.num_batches_tracked"],
                                  ref.model.beta_batchnorm.num_batches_tracked.numpy())


@pytest.mark.parametrize("mt, dp, mp", LAYOUT_CASES)
def test_first_step_gradients_with_injected_noise_match_unsharded(runs, mt, dp, mp):
    ref_loss, ref_grads = runs[mt]["ref_step"]
    loss, grads = runs["ranks"]["fit", mt, dp, mp][0]["first_step"]
    assert loss == pytest.approx(ref_loss, rel=1e-6)
    assert_grads_match(grads, ref_grads, runs[mt]["witness"])


@pytest.mark.parametrize("mt, dp, mp", LAYOUT_CASES)
def test_replicated_state_bitwise_equal_on_every_rank(runs, mt, dp, mp):
    ranks = runs["ranks"]["fit", mt, dp, mp]
    assert len(ranks) == dp * mp
    assert programs.state_digest(ranks[0]["state"]) == ranks[0]["state_digest"]
    for r in ranks[1:]:
        assert r["state"] is None
        assert r["state_digest"] == ranks[0]["state_digest"]
        assert r["step_losses"] == ranks[0]["step_losses"]
        assert r["validation_losses"] == ranks[0]["validation_losses"]
        np.testing.assert_array_equal(r["theta"], ranks[0]["theta"])


@pytest.mark.parametrize("mt, dp, mp", LAYOUT_CASES)
def test_ranks_hold_their_columns_and_take_no_kernel(runs, mt, dp, mp):
    """Each rank's network holds V/mp columns of beta, its BatchNorm and the
    encoder's input layer; nothing reaches the fused loss or K5 (its
    rows-sharded branch counts its calls on any device)."""
    for r in runs["ranks"]["fit", mt, dp, mp]:
        shapes = r["local_shapes"]
        assert shapes["beta"] == (K, V // mp)
        assert shapes["beta_batchnorm.running_var"] == (V // mp,)
        assert shapes["inf_net.input_layer.weight"] == (H[0], V // mp)
        assert set(r["launches"].values()) == {0}
        assert set(r["eval_launches"].values()) == {0}
        assert r["rows_calls"] == {"vsharded_rows": 0}


@pytest.mark.parametrize("mt, dp, mp", LAYOUT_CASES)
def test_validation_matches_the_teacher_forced_unsharded_eval(runs, mt, dp, mp):
    res = runs["ranks"]["fit", mt, dp, mp][0]
    assert len(res["validations"]) == EPOCHS
    for record in res["validations"]:
        replay = programs.replay_validation(port_model(runs[mt]["init"], mt), runs["Xv"],
                                            record)
        assert replay == pytest.approx(record["val_loss"], rel=1e-6)
    np.testing.assert_allclose(res["validation_losses"], runs[mt]["ref"].validation_losses,
                               rtol=1e-4)


@pytest.mark.parametrize("mt", MODEL_TYPES)
def test_first_step_gradients_with_injected_noise_match_jax(runs, mt):
    loss, grads = runs["ranks"]["fit", mt, 2, 2][0]["first_step"]
    j_loss, j_grads = runs[mt]["j_grads"]
    assert loss == pytest.approx(j_loss, rel=1e-5)
    assert_grads_match(grads, j_grads, grad_errors(runs[mt]["ref_step"][1], j_grads))


@pytest.mark.parametrize("mt", MODEL_TYPES)
def test_final_loss_within_envelope_of_jax_fit_sharded(runs, mt):
    port = runs["ranks"]["fit", mt, 2, 2][0]["epoch_losses"][-1]
    jax_ = runs[mt]["jax"].epoch_losses[-1]
    assert len(runs[mt]["jax"].epoch_losses) == EPOCHS
    assert abs(port - jax_) / jax_ < ENVELOPE, (port, jax_)


@pytest.mark.parametrize("mt", MODEL_TYPES)
def test_bf16_at_mp2_matches_the_unsharded_bf16_fit(runs, mt):
    res, ref = runs["ranks"]["bf16", mt], runs[mt]["ref_bf16"]
    assert all(v.dtype in (np.float32, np.int64) for v in res[0]["state"].values())
    assert programs.state_digest(res[0]["state"]) == res[0]["state_digest"]
    assert all(r["state_digest"] == res[0]["state_digest"] for r in res)
    np.testing.assert_allclose(res[0]["step_losses"], ref.step_losses, rtol=BF16_TOL)
    _, ref_grads = runs[mt]["ref_step_bf16"]
    scale = max(float(np.abs(g).max()) for g in ref_grads.values())
    for name, g in ref_grads.items():
        err = float(np.abs(res[0]["first_step"][1][name] - g).max())
        assert err <= BF16_TOL * scale, (name, err, scale)


@pytest.mark.parametrize("mt", MODEL_TYPES)
def test_beta_batchnorm_syncs_over_the_data_group_for_prodlda_only(runs, mt):
    """prodLDA's ``beta_batchnorm`` takes the batch statistics of z = theta
    beta, whose rows the data group splits; LDA's normalizes the replicated
    beta over its topic rows and stays local."""
    data_group = object()
    net = local_network(port_model(runs[mt]["init"], mt).model,
                        DpMpGroups(2, 1, 0, data_group=data_group))
    assert net.inf_net.f_mu_batchnorm.group is data_group
    assert net.inf_net.f_sigma_batchnorm.group is data_group
    assert net.beta_batchnorm.group is (data_group if mt == "prodLDA" else None)


def test_ctm_still_raises(runs):
    """A one-rank ``fit_sharded`` of an unfused ZeroShotTM equals its own
    ``fit`` bitwise (its multi-rank layouts:
    ``tests/test_torch_ctm_sharded.py``). The name is historical: CTM raised
    here before it was ported."""
    from gfedntm_tpu_torch.data.datasets import CTMDataset
    from gfedntm_tpu_torch.models.ctm import ZeroShotTM

    X = runs["X"]
    ctx = np.random.default_rng(6).normal(size=(len(X), 12)).astype(np.float32)
    data = CTMDataset(X=X, X_ctx=ctx)
    kw = dict(input_size=V, n_components=K, hidden_sizes=H, batch_size=B, num_epochs=1,
              dropout=0.0, fused_decoder=False, contextual_size=12)
    sharded, plain = ZeroShotTM(device="cpu", **kw), ZeroShotTM(device="cpu", **kw)
    fit_sharded(sharded, data, DpMpGroups(1, 1, 0), n_samples=2, device="cpu")
    plain.fit(data, n_samples=2)
    assert sharded.step_losses == plain.step_losses
    for key, value in plain.model.state_dict().items():
        assert torch.equal(sharded.model.state_dict()[key], value), key