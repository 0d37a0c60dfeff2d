"""Data-parallel training in the port on the CPU: ``fit_sharded`` with
dp > 1 (dp x mp ranks) and ``fit_data_sharded``, over spawned gloo ranks,
against the port's unsharded ``AVITM.fit`` and against the JAX package's
``fit_sharded`` / ``fit_data_sharded`` on the virtual CPU devices.

- The synced BatchNorm and its collective (sum forward, sum backward): the
  forward and input gradients on dp ranks equal an unsynced
  ``MaskedBatchNorm`` on the whole batch within 1e-6, with one shard all
  masked and with a batch padded to dp=3.
- ``fit_sharded`` at dp=2 x mp=2, dp=2 x mp=1 and dp=4 x mp=1, fused, with
  dropout 0.2 and live noise: every draw is made at the whole batch's shape,
  so the run follows the unsharded one up to reduction order: beta rtol and
  atol 2e-4, BatchNorm running mean rtol 2e-4 and atol 2e-5
  (``tests/test_sharded.py:50-61``), each parameter's first-step gradient
  within 5e-4 x its max|grad|, the state bitwise equal on every rank.
- Against the JAX package: threefry and Philox noise never agree, so the
  final epoch loss is held within 5%; with injected noise and dropout 0 the
  first-step gradients at dp=2 x mp=2 equal the JAX gradient of the same
  batch within 5e-4 x max|grad|.
- ``fit_data_sharded`` at dp=2 and dp=3 (batches of 8 padded to 9), and
  LDA at dp=2, against the unsharded unfused fit: beta within 1e-4, epoch
  losses rtol 1e-4 (``tests/test_multichip.py:165-187``); against JAX's
  ``fit_data_sharded(n_devices=2)`` within 5%.
- bf16 (fused ``fit_sharded`` at dp=2) against the unsharded bf16 fit with
  the bounds of ``tests/test_torch_bf16.py``; validation with early
  stopping at dp=2 x mp=2; the summary's keys and metrics records against
  JAX's.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfedntm_tpu.data.datasets import BowDataset as JBowDataset
from gfedntm_tpu.models.avitm import AVITM as JAVITM
from gfedntm_tpu.models.losses import gaussian_kl as j_gaussian_kl
from gfedntm_tpu.ops.fused_decoder import prodlda_recon_loss as j_fused
from gfedntm_tpu.parallel.mesh import make_param_mesh
from gfedntm_tpu.parallel.mesh import pad_to_multiple as j_pad_to_multiple
from gfedntm_tpu.parallel.sharded import fit_data_sharded as j_fit_data_sharded
from gfedntm_tpu.parallel.sharded import fit_sharded as j_fit_sharded
from gfedntm_tpu.train.steps import pad_batch_axis as j_pad_batch_axis
from gfedntm_tpu.utils.observability import validate_record as j_validate_record
from gfedntm_tpu_torch import interop
from gfedntm_tpu_torch.data.datasets import BowDataset
from gfedntm_tpu_torch.models.avitm import AVITM
from gfedntm_tpu_torch.models.layers import MaskedBatchNorm, Rows, draw, window
from gfedntm_tpu_torch.parallel import programs
from gfedntm_tpu_torch.parallel.launch import run_ranks
from gfedntm_tpu_torch.parallel.mesh import DpMpGroups, pad_to_multiple
from gfedntm_tpu_torch.parallel.sharded import DocShard, fit_data_sharded, fit_sharded
from gfedntm_tpu_torch.train.steps import pad_batch_axis
from gfedntm_tpu_torch.utils.serialization import load_variables

V, K, H, B, DOCS, EPOCHS = 96, 4, (16, 16), 8, 36, 2
KW = dict(input_size=V, n_components=K, hidden_sizes=H, batch_size=B, num_epochs=EPOCHS,
          dropout=0.2, seed=0, fused_decoder=True)
UNFUSED = {**KW, "fused_decoder": False}
BF16 = {**KW, "num_epochs": 1, "dropout": 0.0, "compute_dtype": "bfloat16"}
LDA = {**UNFUSED, "model_type": "LDA"}
LAYOUTS = ((2, 2), (2, 1), (4, 1))
DATA_DPS = (2, 3)
DEGENERATE = ("inf_net.f_mu.bias", "inf_net.f_sigma.bias", "prior_mean")
ENVELOPE = 0.05
TIMEOUT_S = 300
VAL_DOCS = 12
# patience 1 with delta 1.0: the second epoch's gain is no improvement, so
# every fit stops after it, far from the decision boundary.
PATIENCE, DELTA = 1, 1.0


def corpus(docs=DOCS, seed=0):
    return np.random.default_rng(seed).integers(0, 3, size=(docs, V)).astype(np.float32)


def bridged_init(j_model) -> dict:
    params = jax.tree.map(np.asarray, j_model.params)
    stats = jax.tree.map(np.asarray, j_model.batch_stats)
    return {k: v.numpy() for k, v in interop.state_dict_from_flax(params, stats).items()}


def port_model(init, **over):
    model = AVITM(device="cpu", **{**KW, **over})
    model.model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in init.items()})
    return model


def jax_data(X):
    return JBowDataset(X=X, idx2token={i: f"wd{i}" for i in range(V)})


def jax_first_step_grads(j_model, x, mask, noise):
    """Loss and gradients of the JAX fused training loss on one batch with
    injected noise (dropout 0), in torch's state-dict names and layouts."""
    module, params, bs = j_model.module, j_model.params, j_model.batch_stats

    def loss_fn(p):
        out, _ = module.apply({"params": p, "batch_stats": bs}, x, train=True, mask=mask,
                              noise=noise, mutable=["batch_stats"], method="encode_theta",
                              rngs={"dropout": jax.random.PRNGKey(0)})
        bn = bs["beta_batchnorm"]
        rl, _, _ = j_fused(out.theta, p["beta"], x, bn["running_mean"], bn["running_var"],
                           mask, True, 1e-5, 1e-10, True)
        kl = j_gaussian_kl(out.prior_mean, out.prior_variance, out.posterior_mean,
                           out.posterior_variance, out.posterior_log_variance)
        return jnp.sum((kl + rl) * mask)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    grads = jax.tree.map(np.asarray, grads)
    flat = interop.state_dict_from_flax(grads, {})
    return float(loss), {k: v.numpy() for k, v in flat.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    X = corpus()
    Xv = corpus(VAL_DOCS, seed=5)
    root = tmp_path_factory.mktemp("dp")
    j_model = JAVITM(**KW)
    init = bridged_init(j_model)
    j_fit_sharded(j_model, jax_data(X), dp=2, mp=2)
    j_data = JAVITM(**UNFUSED)
    j_summary = j_fit_data_sharded(j_data, jax_data(X), mesh=make_param_mesh(
        axis_name="data", n_devices=2))

    # Injected noise, dropout 0: the JAX gradient of the first batch.
    kw0 = {**KW, "dropout": 0.0}
    j0 = JAVITM(**kw0)
    init0 = bridged_init(j0)
    idx, mask = programs._batch(port_model(init0, dropout=0.0), DOCS, 0)
    noise = np.random.default_rng(9).normal(size=(B, K)).astype(np.float32)
    j_grads = jax_first_step_grads(j0, jnp.asarray(X[idx]), jnp.asarray(mask, jnp.float32),
                                   jnp.asarray(noise))

    jobs = {("fit", dp, mp): (programs.fit, dp * mp, (dp, mp, KW, X, init, 2))
            for dp, mp in LAYOUTS}
    jobs.update({("data", dp): (programs.fit_data, dp, (dp, UNFUSED, X, init, 2))
                 for dp in DATA_DPS})
    jobs["lda"] = (programs.fit_data, 2, (2, LDA, X, None, 2))
    jobs["bf16"] = (programs.fit, 2, (2, 1, BF16, X, init, 1))
    jobs["forced"] = (programs.forced_steps, 4, (2, 2, kw0, X, [
        {"step": 0, "state": init0, "noise": noise}]))
    jobs["val"] = (programs.fit, 4, (2, 2, {**KW, "num_epochs": 4}, X, init, 2, 0, Xv,
                                     str(root / "sharded"), PATIENCE, DELTA))
    start = time.monotonic()
    with ThreadPoolExecutor(3) as pool:
        futures = {key: pool.submit(run_ranks, fn, world, "gloo", ["cpu"] * world, TIMEOUT_S,
                                    args) for key, (fn, world, args) in jobs.items()}
        ranks = {key: future.result() for key, future in futures.items()}
    ranks_s = time.monotonic() - start

    ref = port_model(init)
    ref.fit(BowDataset(X=X), n_samples=2)
    ref_unfused = port_model(init, fused_decoder=False)
    ref_unfused.fit(BowDataset(X=X), n_samples=2)
    ref_lda = AVITM(device="cpu", **LDA)
    ref_lda.fit(BowDataset(X=X), n_samples=2)
    ref_bf16 = port_model(init, **BF16)
    ref_bf16.fit(BowDataset(X=X), n_samples=1)
    ref_val = port_model(init, num_epochs=4)
    ref_val.fit(BowDataset(X=X), BowDataset(X=Xv), save_dir=str(root / "ref"),
                patience=PATIENCE, delta=DELTA, n_samples=2)
    return dict(
        X=X, Xv=Xv, root=root, init=init, ranks=ranks, ranks_s=ranks_s, jax=j_model,
        j_data=j_data, j_summary=j_summary, j_grads=j_grads, ref=ref,
        ref_unfused=ref_unfused, ref_lda=ref_lda, ref_bf16=ref_bf16, ref_val=ref_val,
        ref_step=programs.step_gradients(port_model(init), X),
        ref_step_bf16=programs.step_gradients(port_model(init, **BF16), X),
    )


def grad_errors(grads, ref_grads):
    """Each leaf's max |diff| over its own max|grad|; the cancelling leaves'
    over the largest gradient."""
    scale = max(float(np.abs(g).max()) for g in ref_grads.values())
    out = {}
    for name, want in ref_grads.items():
        diff = float(np.abs(grads[name] - want).max())
        out[name] = diff / (scale if name in DEGENERATE else float(np.abs(want).max()))
    return out


def assert_grads_match(grads, ref_grads, rel=5e-4):
    assert sorted(grads) == sorted(ref_grads)
    for name, err in grad_errors(grads, ref_grads).items():
        assert grads[name].shape == ref_grads[name].shape, name
        assert err < (1e-5 if name in DEGENERATE else rel), (name, err)


# ---------------------------------------------------------------------------
# The synced BatchNorm and its collective
# ---------------------------------------------------------------------------
def bn_case(b, f, seed, mask_kind):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, f)).astype(np.float32) * 3 + 1
    g = rng.normal(size=(b, f)).astype(np.float32)
    mask = {"none": None, "partial": (rng.random(b) < 0.7).astype(np.float32),
            "second_half": np.r_[np.ones(b // 2), np.zeros(b - b // 2)].astype(np.float32),
            "all": np.ones(b, np.float32)}[mask_kind]
    if mask is not None:
        mask[0] = 1.0
    return {"x": x, "mask": mask, "g": g}


BN_CASES = {  # dp: [(B, mask kind)]
    2: [(8, "none"), (8, "partial"), (8, "second_half")],  # second_half: shard 1 all masked
    3: [(8, "all"), (8, "partial")],  # B=8 over 3 ranks: padded to 9
}


@pytest.fixture(scope="module")
def bn_runs():
    cases = {dp: [bn_case(b, 5, 10 * dp + i, kind) for i, (b, kind) in enumerate(specs)]
             for dp, specs in BN_CASES.items()}
    with ThreadPoolExecutor(len(cases)) as pool:
        futures = {dp: pool.submit(run_ranks, programs.synced_batchnorm, dp, "gloo",
                                   ["cpu"] * dp, TIMEOUT_S, (dp, cases[dp]))
                   for dp in cases}
        return {dp: (cases[dp], futures[dp].result()) for dp in cases}


@pytest.mark.parametrize("dp, i", [(dp, i) for dp, s in BN_CASES.items() for i in range(len(s))])
def test_synced_batchnorm_equals_the_whole_batch(bn_runs, dp, i):
    cases, ranks = bn_runs[dp]
    case = cases[i]
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    bn = MaskedBatchNorm(x.shape[1])
    mask = None if case["mask"] is None else torch.from_numpy(case["mask"])
    y = bn(x, mask)
    (y * torch.from_numpy(case["g"])).sum().backward()
    b = len(case["x"])
    out = np.concatenate([r[i]["out"] for r in ranks])[:b]
    grad = np.concatenate([r[i]["grad"] for r in ranks])[:b]
    per = pad_to_multiple(b, dp) // dp
    assert [r[i]["span"] for r in ranks] == [(d * per, (d + 1) * per) for d in range(dp)]
    np.testing.assert_allclose(out, y.detach().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(grad, x.grad.numpy(), rtol=1e-6, atol=1e-6)
    for r in ranks:
        np.testing.assert_allclose(r[i]["running_mean"], bn.running_mean.numpy(),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r[i]["running_var"], bn.running_var.numpy(),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(r[i]["running_var"], ranks[0][i]["running_var"])


@pytest.mark.parametrize("dp", sorted(BN_CASES))
def test_sum_forward_sum_backward_sums_the_gradient(bn_runs, dp):
    """Each rank's partial gets every rank's gradient of the sum: with rank
    r's loss (r + 1) * S, the sum 1 + ... + dp."""
    _, ranks = bn_runs[dp]
    for r in ranks:
        for case in r:
            np.testing.assert_array_equal(case["sum_grad"],
                                          np.full_like(case["sum_grad"], dp * (dp + 1) / 2))


# ---------------------------------------------------------------------------
# fit_sharded at dp > 1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dp, mp", LAYOUTS)
def test_fit_sharded_matches_the_unsharded_fit(runs, dp, mp):
    ref = runs["ref"]
    res = runs["ranks"]["fit", dp, mp]
    state = res[0]["state"]
    np.testing.assert_allclose(state["beta"], ref.model.beta.detach().numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(state["beta_batchnorm.running_mean"],
                               ref.model.beta_batchnorm.running_mean.numpy(),
                               rtol=2e-4, atol=2e-5)
    # The encoder BatchNorms' running means carry f_mu's and f_sigma's
    # biases, whose gradients are zero in exact arithmetic (DEGENERATE), so
    # Adam moves them by rounding noise; their variances are held.
    for name in ("inf_net.f_mu_batchnorm.running_var", "inf_net.f_sigma_batchnorm.running_var"):
        np.testing.assert_allclose(state[name], ref.model.state_dict()[name].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    np.testing.assert_allclose(res[0]["step_losses"], ref.step_losses, rtol=1e-5)
    assert len(res[0]["epoch_losses"]) == EPOCHS


@pytest.mark.parametrize("dp, mp", LAYOUTS)
def test_fit_sharded_first_step_gradients_match_unsharded(runs, dp, mp):
    ref_loss, ref_grads = runs["ref_step"]
    loss, grads = runs["ranks"]["fit", dp, mp][0]["first_step"]
    assert loss == pytest.approx(ref_loss, rel=1e-6)
    assert_grads_match(grads, ref_grads)


@pytest.mark.parametrize("dp, mp", LAYOUTS)
def test_replicated_state_bitwise_equal_on_every_rank(runs, dp, mp):
    ranks = runs["ranks"]["fit", dp, mp]
    assert len(ranks) == dp * mp
    assert programs.state_digest(ranks[0]["state"]) == ranks[0]["state_digest"]
    for r in ranks[1:]:
        assert r["state"] is None
        assert r["state_digest"] == ranks[0]["state_digest"]
        assert r["step_losses"] == ranks[0]["step_losses"]
        np.testing.assert_array_equal(r["theta"], ranks[0]["theta"])


@pytest.mark.parametrize("dp, mp", LAYOUTS)
def test_training_launches_no_kernel_on_the_cpu(runs, dp, mp):
    """The CPU takes the plain versions; K3 never runs in dp > 1 training
    (K5's rows-sharded branch is plain tensor ops on the card too)."""
    for r in runs["ranks"]["fit", dp, mp]:
        assert set(r["launches"].values()) == {0}


def test_fit_sharded_final_loss_within_envelope_of_jax(runs):
    port = runs["ranks"]["fit", 2, 2][0]["epoch_losses"][-1]
    jax_ = runs["jax"].epoch_losses[-1]
    assert abs(port - jax_) / jax_ < ENVELOPE, (port, jax_)


def test_first_step_gradients_with_injected_noise_match_jax(runs):
    (loss, grads), = runs["ranks"]["forced"][0]
    j_loss, j_grads = runs["j_grads"]
    assert loss == pytest.approx(j_loss, rel=1e-5)
    assert_grads_match(grads, j_grads)


# ---------------------------------------------------------------------------
# fit_data_sharded
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dp", DATA_DPS)
def test_fit_data_sharded_matches_the_unsharded_unfused_fit(runs, dp):
    ref = runs["ref_unfused"]
    ranks = runs["ranks"]["data", dp]
    for r in ranks:
        assert np.max(np.abs(r["state"]["beta"] - ref.model.beta.detach().numpy())) < 1e-4
        np.testing.assert_allclose(r["epoch_losses"], ref.epoch_losses, rtol=1e-4)
        for key, value in r["state"].items():
            np.testing.assert_array_equal(value, ranks[0]["state"][key], err_msg=key)
    summary = ranks[0]["summary"]
    assert summary["devices"] == dp and summary["epochs_run"] == EPOCHS
    assert summary["batch_pad"] == pad_to_multiple(B, dp) and summary["batch_pad"] % dp == 0
    assert summary["steps_per_epoch"] == -(-DOCS // B)
    assert summary["docs_per_s"] > 0
    assert summary["docs_per_s_per_device"] == pytest.approx(summary["docs_per_s"] / dp,
                                                             rel=0.01)


def test_fit_data_sharded_lda_matches_the_unsharded_fit(runs):
    """LDA's ``beta_batchnorm`` normalizes the replicated beta, so it stays
    local; only the encoder's BatchNorms sync."""
    ref = runs["ref_lda"]
    for r in runs["ranks"]["lda"]:
        assert np.max(np.abs(r["state"]["beta"] - ref.model.beta.detach().numpy())) < 1e-4
        np.testing.assert_allclose(r["state"]["beta_batchnorm.running_var"],
                                   ref.model.beta_batchnorm.running_var.numpy(), rtol=1e-5)
        np.testing.assert_allclose(r["epoch_losses"], ref.epoch_losses, rtol=1e-4)


def test_fit_data_sharded_final_loss_within_envelope_of_jax(runs):
    port = runs["ranks"]["data", 2][0]["epoch_losses"][-1]
    jax_ = runs["j_data"].epoch_losses[-1]
    assert abs(port - jax_) / jax_ < ENVELOPE, (port, jax_)


def test_fit_data_sharded_summary_keys_are_jax_s(runs):
    """The JAX summary's keys; no compile in eager PyTorch, and the FLOP
    count of one whole-batch step (``utils/flops.py``): the analytic GEMM
    count of these widths, whatever dp, with its epoch total and MFU."""
    widths = (V,) + H
    fwd = sum(a * c for a, c in zip(widths, widths[1:])) + 2 * H[-1] * K + K * V
    step = 3 * 2 * B * fwd - 2 * B * V * H[0]
    for dp in DATA_DPS:
        summary = runs["ranks"]["data", dp][0]["summary"]
        assert sorted(summary) == sorted(runs["j_summary"])
        assert summary["compile_s"] is None
        assert summary["flops_per_step"] == step
        assert summary["flops_per_epoch"] == step * summary["steps_per_epoch"]
        assert summary["mfu"] > 0
        assert summary["peak_flops_source"] == "measured-matmul-probe"


@pytest.mark.parametrize("dp", DATA_DPS)
def test_fit_data_sharded_records_are_valid_under_jax(runs, dp):
    r = runs["ranks"]["data", dp][0]
    for record in r["records"]:
        j_validate_record(record)
    events = [rec["event"] for rec in r["records"]]
    assert events == ["phase"] * EPOCHS + ["sharded_fit"]
    assert [rec["phase"] for rec in r["records"][:EPOCHS]] == ["sharded_epoch"] * EPOCHS
    assert [rec["epoch"] for rec in r["records"][:EPOCHS]] == list(range(EPOCHS))
    snap = r["snapshot"]
    assert snap["sharded_devices"]["value"] == dp
    assert snap["sharded_docs_per_s"]["value"] > 0
    assert snap["sharded_docs_per_s_per_device"]["value"] == pytest.approx(
        snap["sharded_docs_per_s"]["value"] / dp)


# ---------------------------------------------------------------------------
# bf16, validation, placement, refusals
# ---------------------------------------------------------------------------
def test_bf16_fit_sharded_at_dp2_matches_the_unsharded_bf16_fit(runs):
    """The bounds of ``test_torch_bf16.py``'s sharded case: step losses
    within 1e-2 relative, first-step gradients within 1e-2 of the largest
    gradient, float32 state bitwise equal on both ranks."""
    res, ref = runs["ranks"]["bf16"], runs["ref_bf16"]
    assert all(v.dtype in (np.float32, np.int64) for v in res[0]["state"].values())
    assert programs.state_digest(res[0]["state"]) == res[0]["state_digest"]
    assert all(r["state_digest"] == res[0]["state_digest"] for r in res)
    np.testing.assert_allclose(res[0]["step_losses"], ref.step_losses, rtol=1e-2)
    _, ref_grads = runs["ref_step_bf16"]
    scale = max(float(np.abs(g).max()) for g in ref_grads.values())
    for name, g in ref_grads.items():
        err = float(np.abs(res[0]["first_step"][1][name] - g).max())
        assert err <= 1e-2 * scale, (name, err, scale)


def test_validation_at_dp2_mp2_stops_alike_on_every_rank(runs):
    ref, ranks = runs["ref_val"], runs["ranks"]["val"]
    assert len(ref.validation_losses) == 2  # stopped after the second epoch
    for r in ranks:
        assert r["last_epoch"] == ref.nn_epoch == 1
        assert r["validation_losses"] == ranks[0]["validation_losses"]
        np.testing.assert_allclose(r["validation_losses"], ref.validation_losses, rtol=1e-4)


def test_validation_at_dp2_mp2_matches_the_teacher_forced_unsharded_eval(runs):
    records = runs["ranks"]["val"][0]["validations"]
    assert len(records) == 2
    for record in records:
        replay = programs.replay_validation(port_model(runs["init"]), runs["Xv"], record)
        assert replay == pytest.approx(record["val_loss"], rel=1e-5)


def test_world_rank_zero_checkpoint_loads_unsharded(runs):
    saved = runs["root"] / "sharded"
    assert sorted(p.name for p in saved.iterdir()) == ["epoch_0.json", "epoch_0.npz"]
    gathered = runs["ranks"]["val"][0]["validations"][0]["state"]
    variables = load_variables(str(saved / "epoch_0.npz"))
    on_disk = interop.state_dict_from_flax(variables["params"], variables["batch_stats"])
    for key, value in gathered.items():
        np.testing.assert_array_equal(on_disk[key].numpy(), value, err_msg=key)
    model = port_model(runs["init"])
    model.load(str(saved), 0)
    for key, value in model.model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), gathered[key], err_msg=key)


@pytest.mark.parametrize("docs, dp, mp", [(36, 2, 2), (37, 3, 1), (5, 4, 2), (8, 1, 4)])
def test_doc_shard_places_each_ranks_block(docs, dp, mp):
    """The blocks of every rank of a model column, in data-rank order, are
    the corpus zero-padded to a multiple of dp, on that column's V slice
    (``shard_docs`` with ``shard_data``'s ``P("data", "model")``)."""
    X = corpus(docs)
    n_pad = j_pad_to_multiple(docs, dp)
    padded = np.concatenate([X, np.zeros((n_pad - docs, V), np.float32)])
    for m in range(mp):
        blocks = []
        for d in range(dp):
            groups = DpMpGroups(dp, mp, d * mp + m)
            shard = DocShard.place({"x_bow": X}, groups, torch.as_tensor)
            assert shard.start == d * (n_pad // dp)
            blocks.append(shard.local["x_bow"].numpy())
        np.testing.assert_array_equal(np.concatenate(blocks),
                                      padded[:, groups.v_slice(V)])


@pytest.mark.parametrize("b, multiple", [(8, 1), (8, 2), (8, 3), (6, 4), (5, 8), (16, 8)])
def test_pad_batch_axis_is_jax_s(b, multiple):
    idx = np.arange(3 * b, dtype=np.int32).reshape(3, b)
    mask = np.ones((3, b), bool)
    mask[-1, b // 2:] = False
    got, want = pad_batch_axis(idx, mask, multiple), j_pad_batch_axis(idx, mask, multiple)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert pad_to_multiple(b, multiple) == j_pad_to_multiple(b, multiple)


@pytest.mark.parametrize("sample", [torch.rand, torch.randn])
@pytest.mark.parametrize("full, dp", [(8, 2), (8, 3), (5, 4)])
def test_draws_at_the_whole_batch_shape(sample, full, dp):
    """Every rank's window of a draw at the whole batch's shape is the
    single-device draw's rows (zero past ``full``), and every rank's
    generator ends in the same state."""
    whole = sample((full, 3), generator=torch.Generator().manual_seed(4))
    per = pad_to_multiple(full, dp) // dp
    parts, states = [], []
    for d in range(dp):
        gen = torch.Generator().manual_seed(4)
        rows = Rows(full, d * per, (d + 1) * per)
        part = draw(sample, (per, 3), rows, generator=gen)
        assert part.shape == (per, 3)
        parts.append(part)
        states.append(gen.get_state())
    np.testing.assert_array_equal(torch.cat(parts)[:full].numpy(), whole.numpy())
    assert float(torch.cat(parts)[full:].abs().sum()) == 0.0
    assert all(torch.equal(s, states[0]) for s in states)
    assert window(whole, None) is whole


def test_refusals(runs):
    data = BowDataset(X=runs["X"])
    with pytest.raises(ValueError, match="fused_decoder=False"):
        fit_data_sharded(port_model(runs["init"]), data, DpMpGroups(2, 1, 0), device="cpu")
    with pytest.raises(ValueError, match="mp must be 1"):
        fit_data_sharded(port_model(runs["init"], fused_decoder=False), data,
                         DpMpGroups(1, 2, 0), device="cpu")
    # A CTM meets the same refusals.
    from gfedntm_tpu_torch.data.datasets import CTMDataset
    from gfedntm_tpu_torch.models.ctm import CombinedTM

    ctm_data = CTMDataset(X=runs["X"], X_ctx=np.zeros((len(runs["X"]), 12), np.float32))
    ctm_kw = dict(KW, contextual_size=12)
    with pytest.raises(ValueError, match="fused_decoder=False"):
        fit_data_sharded(CombinedTM(device="cpu", **ctm_kw), ctm_data, DpMpGroups(2, 1, 0),
                         device="cpu")
    with pytest.raises(ValueError, match="mp must be 1"):
        fit_data_sharded(CombinedTM(device="cpu", **{**ctm_kw, "fused_decoder": False}),
                         ctm_data, DpMpGroups(1, 2, 0), device="cpu")


def test_no_fallback_to_the_cpu(runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit_data_sharded(port_model(runs["init"], fused_decoder=False),
                         BowDataset(X=runs["X"]), DpMpGroups(2, 1, 0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit_sharded(port_model(runs["init"]), BowDataset(X=runs["X"]), DpMpGroups(2, 2, 0))
