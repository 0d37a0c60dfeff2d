"""The slice as a whole on the CPU: the port's ``fit_sharded`` over spawned
gloo ranks (dp=1, mp=2 and mp=4) against the port's unsharded
``AVITM.fit``, and against the JAX package's ``fit_sharded(..., mp=2)`` on
the virtual CPU devices, all from the same bridged initial weights and the
same numpy schedules, with the fused loss (the port's kernels' plain
versions; JAX's Pallas kernels in interpret mode) and dropout 0.

- Port sharded vs unsharded: the same noise draws, so tight parity, with
  ``tests/test_sharded.py:50-61``'s tolerances (beta rtol and atol 2e-4;
  BatchNorm running mean rtol 2e-4, atol 2e-5), and every parameter's
  first-step gradient within 5e-4 x its max|grad|. Adam hides a gradient
  that is wrong by a constant factor; the one-step gradients do not.
- Port vs JAX: threefry and Philox noise never agree, so the final epoch
  loss is compared within 5%.
- With a validation set (mp=2): each epoch's validation loss (K5's forward
  in eval mode on the ranks; the plain versions here) within 1e-4 of the
  unsharded ``fit``'s, and within 1e-5 of the unsharded eval teacher-forced
  from the sharded run's state, generator state and schedule; the same
  epoch stopped at, the same on both ranks; rank 0's checkpoint bitwise
  equal to the gathered state and loadable by an unsharded ``AVITM``.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from gfedntm_tpu.data.datasets import BowDataset as JBowDataset
from gfedntm_tpu.models.avitm import AVITM as JAVITM
from gfedntm_tpu.parallel.sharded import _leaf_spec
from gfedntm_tpu.parallel.sharded import fit_sharded as j_fit_sharded
from gfedntm_tpu_torch import interop
from gfedntm_tpu_torch.data.datasets import BowDataset
from gfedntm_tpu_torch.models.avitm import AVITM
from gfedntm_tpu_torch.parallel import programs
from gfedntm_tpu_torch.parallel.launch import run_ranks
from gfedntm_tpu_torch.parallel.mesh import DpMpGroups
from gfedntm_tpu_torch.parallel.sharded import SPLITS, fit_sharded, shard_state_dict
from gfedntm_tpu_torch.utils.serialization import load_variables

V, K, H, B, DOCS, EPOCHS = 96, 4, (16, 16), 8, 32, 2
KW = dict(input_size=V, n_components=K, hidden_sizes=H, batch_size=B, num_epochs=EPOCHS,
          dropout=0.0, seed=0, fused_decoder=True)
MPS = (2, 4)
DEGENERATE = ("inf_net.f_mu.bias", "inf_net.f_sigma.bias", "prior_mean")
ENVELOPE = 0.05
TIMEOUT_S = 240


def corpus():
    rng = np.random.default_rng(0)
    return rng.integers(0, 3, size=(DOCS, V)).astype(np.float32)


def port_model(init, **over):
    model = AVITM(device="cpu", **{**KW, **over})
    model.model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in init.items()})
    return model


@pytest.fixture(scope="module")
def runs():
    X = corpus()
    j_model = JAVITM(**KW)
    j_params = jax.tree.map(np.asarray, j_model.params)
    j_stats = jax.tree.map(np.asarray, j_model.batch_stats)
    init = {k: v.numpy() for k, v in interop.state_dict_from_flax(j_params, j_stats).items()}
    j_fit_sharded(j_model, JBowDataset(X=X, idx2token={i: f"wd{i}" for i in range(V)}),
                  dp=1, mp=2)

    ref = port_model(init)
    ref.fit(BowDataset(X=X), n_samples=2)
    ref_step = programs.step_gradients(port_model(init), X)
    with ThreadPoolExecutor(len(MPS)) as pool:
        futures = {mp: pool.submit(run_ranks, programs.fit, mp, "gloo", ["cpu"] * mp,
                                   TIMEOUT_S, (1, mp, KW, X, init)) for mp in MPS}
        sharded = {mp: future.result() for mp, future in futures.items()}
    return dict(X=X, init=init, flax=(j_params, j_stats), jax=j_model, ref=ref,
                ref_step=ref_step, sharded=sharded)


@pytest.mark.parametrize("mp", MPS)
def test_matches_unsharded_fit(runs, mp):
    ref = runs["ref"]
    state = runs["sharded"][mp][0]["state"]
    np.testing.assert_allclose(state["beta"], ref.model.beta.detach().numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(state["beta_batchnorm.running_mean"],
                               ref.model.beta_batchnorm.running_mean.numpy(),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(runs["sharded"][mp][0]["step_losses"], ref.step_losses,
                               rtol=1e-5)
    assert len(runs["sharded"][mp][0]["epoch_losses"]) == EPOCHS


@pytest.mark.parametrize("mp", MPS)
def test_first_step_gradients_match_unsharded(runs, mp):
    ref_loss, ref_grads = runs["ref_step"]
    loss, grads = runs["sharded"][mp][0]["first_step"]
    assert loss == pytest.approx(ref_loss, rel=1e-6)
    scale = max(float(np.abs(g).max()) for g in ref_grads.values())
    assert sorted(grads) == sorted(ref_grads)
    for name, want in ref_grads.items():
        assert grads[name].shape == want.shape, name
        if name in DEGENERATE:  # zero in exact arithmetic: rounding noise on both sides
            assert float(np.abs(grads[name]).max()) <= 1e-5 * scale, name
            continue
        err = float(np.abs(grads[name] - want).max()) / float(np.abs(want).max())
        assert err < 5e-4, (name, err)


def test_final_epoch_loss_within_envelope_of_jax(runs):
    port = runs["sharded"][2][0]["epoch_losses"][-1]
    jax_ = runs["jax"].epoch_losses[-1]
    assert abs(port - jax_) / jax_ < ENVELOPE, (port, jax_)


@pytest.mark.parametrize("mp", MPS)
def test_replicated_state_bitwise_equal_across_model_ranks(runs, mp):
    ranks = runs["sharded"][mp]
    assert programs.state_digest(ranks[0]["state"]) == ranks[0]["state_digest"]
    for r in ranks[1:]:
        assert r["state"] is None
        assert r["state_digest"] == ranks[0]["state_digest"]
        assert r["epoch_losses"] == ranks[0]["epoch_losses"]


@pytest.mark.parametrize("mp", MPS)
def test_local_network_holds_its_columns(runs, mp):
    full = {k: v.shape for k, v in runs["init"].items()}
    for r in runs["sharded"][mp]:
        assert sorted(r["local_shapes"]) == sorted(full)
        for name, shape in r["local_shapes"].items():
            want = list(full[name])
            if name in SPLITS["bow"]:
                want[SPLITS["bow"][name][0]] = V // mp
            assert shape == tuple(want), name
        assert r["launches"] == {"stats": 0, "loss": 0, "grads": 0, "vsharded": 0,
                                 "stats_bf16": 0, "loss_bf16": 0, "grads_bf16": 0,
                                 "vsharded_bf16": 0}


@pytest.mark.parametrize("rank", range(4))
def test_leaf_placement_mirrors_jax_leaf_spec(runs, rank):
    """The rank-local slice of the bridged state dict holds, for every Flax
    leaf, the slice ``_leaf_spec`` gives it on model rank ``rank`` of mp=4
    (kernels transposed into torch's layout)."""
    params, stats = runs["flax"]
    local = shard_state_dict(interop.state_dict_from_flax(params, stats),
                             DpMpGroups(1, 4, rank), "bow")
    for collection in (params, stats):
        for path, leaf in jax.tree_util.tree_flatten_with_path(collection)[0]:
            names = tuple(p.key for p in path)
            spec = tuple(_leaf_spec(np.shape(leaf), V))
            want = np.asarray(leaf)
            if "model" in spec:
                axis = spec.index("model")
                want = np.split(want, 4, axis=axis)[rank]
            if names[-1] == "kernel":
                want = want.T
            got = local[interop.torch_key(names)]
            np.testing.assert_array_equal(got.numpy(), want, err_msg=str(names))


@pytest.mark.parametrize("mp", MPS)
def test_inference_and_topics_after_the_gather(runs, mp):
    ranks = runs["sharded"][mp]
    theta = ranks[0]["theta"]
    assert theta.shape == (DOCS, K) and np.isfinite(theta).all()
    np.testing.assert_allclose(theta.sum(1), 1.0, atol=1e-5)
    topics = ranks[0]["topics"]
    assert len(topics) == K and all(len(t) == 10 for t in topics)
    assert all(w.startswith("wd") for t in topics for w in t)
    assert all(r["topics"] == topics for r in ranks)
    model = port_model(runs["init"])
    model.model.load_state_dict({k: torch.from_numpy(v) for k, v in ranks[0]["state"].items()})
    model.best_components = ranks[0]["state"]["beta"]
    model.train_data = BowDataset(X=runs["X"], idx2token={i: f"wd{i}" for i in range(V)})
    assert model.get_topics(10) == topics


def test_one_rank_fit_sharded_matches_fit(runs):
    model = port_model(runs["init"])
    net = fit_sharded(model, BowDataset(X=runs["X"]), DpMpGroups(1, 1, 0), device="cpu")
    ref = runs["ref"]
    np.testing.assert_allclose(model.best_components, ref.model.beta.detach().numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(model.step_losses, ref.step_losses, rtol=1e-5)
    assert net.beta.shape == (K, V)
    beta_slot = [name for name, _ in model.model.named_parameters()].index("beta")
    assert model.optimizer.state_dict()["state"][beta_slot]["exp_avg"].shape == (K, V)


def test_later_slices_raise_not_implemented(runs):
    """A one-rank ``fit_sharded`` of a fused CombinedTM with labels equals
    its own ``fit`` bitwise (the multi-rank CTM layouts are in
    ``tests/test_torch_ctm_sharded.py``). The name is historical: CTM
    raised here before it was ported."""
    from gfedntm_tpu_torch.data.datasets import CTMDataset
    from gfedntm_tpu_torch.models.ctm import CombinedTM

    rng = np.random.default_rng(5)
    data = CTMDataset(X=runs["X"], X_ctx=rng.normal(size=(DOCS, 12)).astype(np.float32),
                      labels=np.eye(3, dtype=np.float32)[rng.integers(0, 3, DOCS)])
    kw = dict(KW, contextual_size=12, label_size=3)
    sharded, plain = CombinedTM(device="cpu", **kw), CombinedTM(device="cpu", **kw)
    fit_sharded(sharded, data, DpMpGroups(1, 1, 0), n_samples=2, device="cpu")
    plain.fit(data, n_samples=2)
    assert sharded.step_losses == plain.step_losses
    for key, value in plain.model.state_dict().items():
        assert torch.equal(sharded.model.state_dict()[key], value), key


def test_no_fallback_to_the_cpu(runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit_sharded(port_model(runs["init"]), BowDataset(X=runs["X"]), DpMpGroups(1, 1, 0))


def test_a_hung_rank_fails_within_its_timeout():
    start = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[.*\] did not finish within 10 s"):
        run_ranks(programs.collective_probe, 2, "gloo", ["cpu"] * 2, 10, args=(1, 600.0))
    assert time.monotonic() - start < 40


def test_collective_probe_counts_the_world():
    assert run_ranks(programs.collective_probe, 3, "gloo", ["cpu"] * 3, TIMEOUT_S) == [3.0] * 3


VAL_DOCS = 12
# patience 1 with delta 1.0: the second epoch's gain (about 0.4) is no
# improvement, so both fits stop after it, far from the decision boundary.
PATIENCE, DELTA = 1, 1.0


@pytest.fixture(scope="module")
def val_runs(runs, tmp_path_factory):
    X = runs["X"]
    Xv = np.random.default_rng(5).integers(0, 3, size=(VAL_DOCS, V)).astype(np.float32)
    root = tmp_path_factory.mktemp("val")
    ref = port_model(runs["init"], num_epochs=4)
    ref.fit(BowDataset(X=X), BowDataset(X=Xv), save_dir=str(root / "ref"), patience=PATIENCE,
            delta=DELTA, n_samples=2)
    ranks = run_ranks(programs.fit, 2, "gloo", ["cpu"] * 2, TIMEOUT_S,
                      (1, 2, {**KW, "num_epochs": 4}, X, runs["init"], 2, 0, Xv,
                       str(root / "sharded"), PATIENCE, DELTA))
    return dict(Xv=Xv, root=root, ref=ref, ranks=ranks)


def test_sharded_validation_matches_the_unsharded_fit(val_runs):
    ref, ranks = val_runs["ref"], val_runs["ranks"]
    assert len(ref.validation_losses) == 2  # stopped after the second epoch
    for r in ranks:
        assert r["last_epoch"] == ref.nn_epoch == 1
        assert len(r["epoch_losses"]) == len(ref.epoch_losses)
        np.testing.assert_allclose(r["validation_losses"], ref.validation_losses, rtol=1e-4)
        assert np.isfinite(r["validation_losses"]).all()
    assert ranks[1]["validation_losses"] == ranks[0]["validation_losses"]


def test_sharded_validation_matches_the_teacher_forced_unsharded_eval(runs, val_runs):
    records = val_runs["ranks"][0]["validations"]
    assert len(records) == 2
    for record in records:
        replay = programs.replay_validation(port_model(runs["init"]), val_runs["Xv"], record)
        assert replay == pytest.approx(record["val_loss"], rel=1e-5)


def test_rank_zero_checkpoint_is_the_gathered_state(runs, val_runs):
    saved = val_runs["root"] / "sharded"
    assert sorted(p.name for p in saved.iterdir()) == sorted(
        p.name for p in (val_runs["root"] / "ref").iterdir()) == ["epoch_0.json",
                                                                 "epoch_0.npz"]
    gathered = val_runs["ranks"][0]["validations"][0]["state"]
    variables = load_variables(str(saved / "epoch_0.npz"))
    on_disk = interop.state_dict_from_flax(variables["params"], variables["batch_stats"])
    assert sorted(on_disk) == sorted(gathered)
    for key, value in gathered.items():
        np.testing.assert_array_equal(on_disk[key].numpy(), value, err_msg=key)
    model = port_model(runs["init"])
    model.load(str(saved), 0)
    for key, value in model.model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), gathered[key], err_msg=key)


def test_one_rank_fit_sharded_validates_as_fit(runs, val_runs, tmp_path):
    """mp = 1: the unfused eval, as ``AVITM.fit`` runs it."""
    model = port_model(runs["init"], num_epochs=4)
    fit_sharded(model, BowDataset(X=runs["X"]), DpMpGroups(1, 1, 0),
                BowDataset(X=val_runs["Xv"]), str(tmp_path), PATIENCE, DELTA, n_samples=2,
                device="cpu")
    ref = val_runs["ref"]
    assert model.nn_epoch == ref.nn_epoch
    np.testing.assert_allclose(model.validation_losses, ref.validation_losses, rtol=1e-5)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["epoch_0.json", "epoch_0.npz"]
