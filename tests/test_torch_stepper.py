"""The externally-stepped federated models (``FederatedAVITM``,
``FederatedCTM``) of the port against the JAX package's, driven in process
the way a federation server drives them: every active client takes one
``train_mb_delta``, the snapshots are averaged by ``weighted_mean`` with
each client's minibatch sample count as its weight, and every client takes
the average through ``delta_update_fit``.

- The ``StepStatus`` sequences and sample counts equal the JAX steppers'
  exactly on the same seeds and datasets, with epoch rollover for clients
  of unequal size (the schedules come from each model's numpy generator
  in both packages).
- Snapshot keys, shapes and dtypes equal the JAX steppers' (Flax
  '/'-paths, [in, out] kernels, int32 counters); a JAX snapshot set into a
  torch stepper reads back bitwise.
- Every exchanged step equals a replay through the port's ``grad_step``,
  ``interop`` and ``weighted_mean``, bitwise, and leaves the shared state
  bitwise equal across clients.
- ``get_results_model`` on the same beta and theta as the JAX stepper's:
  thetas bitwise (the same float32 numpy arithmetic), betas within 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from gfedntm_tpu.data.datasets import BowDataset as JBowDataset
from gfedntm_tpu.data.datasets import CTMDataset as JCTMDataset
from gfedntm_tpu.federated.stepper import FederatedAVITM as JFederatedAVITM
from gfedntm_tpu.federated.stepper import FederatedCTM as JFederatedCTM
from gfedntm_tpu.federation.aggregation import weighted_mean as j_weighted_mean
from gfedntm_tpu.models.avitm import AVITM as JAVITM
from gfedntm_tpu.models.ctm import CTM as JCTM
from gfedntm_tpu_torch import interop
from gfedntm_tpu_torch.data.datasets import BowDataset, CTMDataset, make_epoch_schedule
from gfedntm_tpu_torch.federated.aggregation import weighted_mean
from gfedntm_tpu_torch.federated.stepper import (
    THETAS_THRESHOLD,
    FederatedAVITM,
    FederatedCTM,
    FederatedStepper,
)
from gfedntm_tpu_torch.models.avitm import AVITM
from gfedntm_tpu_torch.models.ctm import CTM
from gfedntm_tpu_torch.models.params import SHARE_MINIMAL
from gfedntm_tpu_torch.train.steps import grad_step, take

V, K, H, B, CTX, L = 96, 6, (8, 8), 16, 12, 3
SIZES = (40, 24)  # 3 and 2 steps per epoch: the clients roll over apart
FAMILIES = ("avitm", "ctm")


def kw(family, **over):
    base = dict(input_size=V, n_components=K, hidden_sizes=H, batch_size=B, num_epochs=2,
                dropout=0.2, **over)
    if family == "ctm":
        base.update(contextual_size=CTX, label_size=L, inference_type="combined",
                    loss_weights={"beta": 0.5})
    return base


def corpora(family):
    out = []
    for c, n in enumerate(SIZES):
        rng = np.random.default_rng(c)
        X = rng.integers(0, 3, size=(n, V)).astype(np.float32)
        if family == "avitm":
            out.append((X,))
        else:
            out.append((X, rng.normal(size=(n, CTX)).astype(np.float32),
                        np.eye(L, dtype=np.float32)[rng.integers(0, L, n)]))
    return out


def port_model(family, arrays, seed):
    """A fresh port model of ``family`` and its dataset."""
    if family == "avitm":
        return AVITM(device="cpu", seed=seed, **kw(family)), BowDataset(X=arrays[0])
    return (CTM(device="cpu", seed=seed, **kw(family)),
            CTMDataset(X=arrays[0], X_ctx=arrays[1], labels=arrays[2]))


def port_stepper(family, arrays, seed):
    model, data = port_model(family, arrays, seed)
    stepper = (FederatedAVITM if family == "avitm" else FederatedCTM)(model)
    stepper.pre_fit(data)
    return stepper


def jax_stepper(family, arrays, seed):
    if family == "avitm":
        stepper = JFederatedAVITM(JAVITM(seed=seed, **kw(family)))
        data = JBowDataset(X=arrays[0])
    else:
        stepper = JFederatedCTM(JCTM(seed=seed, **kw(family)))
        data = JCTMDataset(X=arrays[0], X_ctx=arrays[1], labels=arrays[2])
    stepper.pre_fit(data)
    return stepper


def drive(steppers, on_exchange=None):
    """Rounds until every client has finished; returns per client the list
    of (StepStatus without its loss, samples processed after the step)."""
    seen = [[] for _ in steppers]
    while not all(s.finished for s in steppers):
        active = [c for c, s in enumerate(steppers) if not s.finished]
        snaps = []
        for c in active:
            snap = steppers[c].train_mb_delta()
            snaps.append((steppers[c]._last_batch_size, snap))
        avg = weighted_mean(snaps)
        for c in active:
            status = steppers[c].delta_update_fit(avg)
            seen[c].append(((status.current_mb, status.current_epoch, status.epoch_ended,
                             status.finished, status.epoch_loss is None),
                            steppers[c].samples_processed))
        if on_exchange is not None:
            on_exchange(active, snaps, avg)
    return seen


@pytest.mark.parametrize("family", FAMILIES)
def test_status_sequences_and_sample_counts_match_jax(family):
    arrays = corpora(family)
    port = drive([port_stepper(family, a, seed=c) for c, a in enumerate(arrays)])
    jax_ = drive([jax_stepper(family, a, seed=c) for c, a in enumerate(arrays)])
    assert port == jax_
    assert [len(s) for s in port] == [2 * -(-n // B) for n in SIZES]


@pytest.mark.parametrize("family", FAMILIES)
def test_snapshot_keys_shapes_and_dtypes_are_the_jax_steppers(family):
    arrays = corpora(family)[0]
    got = port_stepper(family, arrays, 0).train_mb_delta()
    want = jax_stepper(family, arrays, 0).train_mb_delta()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].shape == value.shape and got[key].dtype == value.dtype, key


@pytest.mark.parametrize("family", FAMILIES)
def test_a_jax_snapshot_sets_into_a_torch_stepper_bitwise(family):
    arrays = corpora(family)[0]
    snap = jax_stepper(family, arrays, 0).train_mb_delta()
    port = port_stepper(family, arrays, 1)
    port.train_mb_delta()
    port.delta_update_fit(snap)
    back = port.get_gradients()
    assert sorted(back) == sorted(snap)
    for key, value in snap.items():
        assert back[key].dtype == value.dtype, key
        np.testing.assert_array_equal(back[key], value, err_msg=key)


@pytest.mark.parametrize("family", FAMILIES)
def test_each_exchanged_step_is_a_replay_of_grad_step_and_weighted_mean(family):
    arrays = corpora(family)
    steppers = [port_stepper(family, a, seed=c) for c, a in enumerate(arrays)]
    replay = []
    for c, a in enumerate(arrays):
        m, ds = port_model(family, a, seed=c)
        m.train_data = ds
        replay.append(m)
    data = [m._device_data(m.train_data) for m in replay]
    scheds = [None, None]
    step_in_epoch = [0, 0]

    def on_exchange(active, snaps, avg):
        mine = []
        for c in active:
            m = replay[c]
            if step_in_epoch[c] == 0:
                scheds[c] = make_epoch_schedule(len(m.train_data), B, m._np_rng)
            i = step_in_epoch[c]
            idx = torch.as_tensor(scheds[c].indices[i], dtype=torch.long)
            mask = torch.as_tensor(scheds[c].mask[i], dtype=torch.float32)
            grad_step(m.model, m.optimizer, take(data[c], idx), mask, m.fused_decoder,
                      generator=m.generator, beta_weight=m._beta_weight())
            step_in_epoch[c] = (i + 1) % scheds[c].steps_per_epoch
            snap = {"/".join((col, *path)): interop.to_flax(k, t)
                    for k, t in m.model.state_dict().items()
                    for col, path in [interop.flax_path(k)]}
            mine.append((float(scheds[c].mask[i].sum()), snap))
        for (w, snap), (w_ref, snap_ref) in zip(snaps, mine):
            assert w == w_ref
            for key, value in snap.items():
                np.testing.assert_array_equal(value, snap_ref[key], err_msg=key)
        want = weighted_mean(mine)
        for key, value in avg.items():
            np.testing.assert_array_equal(value, want[key], err_msg=key)
        for c in active:
            state = replay[c].model.state_dict()
            for key, t in state.items():
                collection, path = interop.flax_path(key)
                t.copy_(interop.from_flax(path, want["/".join((collection, *path))])
                        .to(t.dtype))
            for key, t in steppers[c].model.model.state_dict().items():
                assert torch.equal(t, state[key]), key
        first = steppers[active[0]].model.model.state_dict()
        for c in active[1:]:
            for key, t in steppers[c].model.model.state_dict().items():
                assert torch.equal(t, first[key]), key

    drive(steppers, on_exchange)


def test_weighted_mean_is_the_jax_packages_bitwise():
    rng = np.random.default_rng(0)
    snaps = [(float(w), {"a": rng.normal(size=(3, 4)).astype(np.float32),
                         "n": np.int32(rng.integers(0, 9))}) for w in (16, 7, 3)]
    got, want = weighted_mean(snaps), j_weighted_mean(snaps)
    for key in want:
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("family", FAMILIES)
def test_results_model_matches_jax_on_the_same_beta_and_theta(family, tmp_path):
    arrays = corpora(family)[0]
    j = jax_stepper(family, arrays, 0)
    port = port_stepper(family, arrays, 0)
    port.model.model.load_state_dict(interop.state_dict_from_flax(
        jax.tree.map(np.asarray, j.model.params), jax.tree.map(np.asarray, j.model.batch_stats)))
    theta = np.random.default_rng(3).dirichlet(np.full(K, 0.3), size=SIZES[0]).astype(
        np.float32)
    theta[0, :] = 1e-3  # a row below the threshold everywhere: renormalized from 0
    assert (theta < THETAS_THRESHOLD).any()
    for m in (j.model, port.model):
        m.get_doc_topic_distribution = lambda dataset, n_samples=20: theta.copy()
    got = port.get_results_model(save_dir=str(tmp_path / "port"))
    want = j.get_results_model(save_dir=str(tmp_path / "jax"))
    np.testing.assert_array_equal(got["thetas"], want["thetas"])
    np.testing.assert_allclose(got["betas"], want["betas"], rtol=1e-6, atol=1e-9)
    assert got["topics"] == want["topics"]
    a, b = np.load(tmp_path / "port" / "model.npz"), np.load(tmp_path / "jax" / "model.npz")
    assert sorted(a.files) == sorted(b.files)
    np.testing.assert_allclose(port.get_topics_in_server(), j.get_topics_in_server(),
                               rtol=1e-6, atol=1e-9)
    beta_gt = np.random.default_rng(4).dirichlet(np.ones(V), size=K)
    for m in (j.model, port.model):
        m.train_data.idx2token = {i: f"wd{(i * 7) % V}" for i in range(V)}
    got = port.evaluate_synthetic_model(beta_gt, vocab_size=V)
    want = j.evaluate_synthetic_model(beta_gt, vocab_size=V)
    assert got["tss"] == pytest.approx(want["tss"], rel=1e-5)


def test_protocol_order_budget_and_snapshots(tmp_path):
    arrays = corpora("avitm")[0]
    stepper = FederatedStepper(AVITM(device="cpu", **kw("avitm")),
                               grads_to_share=SHARE_MINIMAL,
                               epoch_snapshot_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="pre_fit"):
        stepper.train_mb_delta()
    stepper.pre_fit(BowDataset(X=arrays[0]))
    with pytest.raises(RuntimeError, match="train_mb_delta"):
        stepper.delta_update_fit({})
    assert stepper.steps_remaining == 6
    snap = stepper.train_mb_delta()
    assert sorted(snap) == ["params/beta", "params/prior_mean", "params/prior_variance"]
    with pytest.raises(KeyError):
        stepper.set_gradients({"params/nope": np.zeros(1)})
    assert stepper.train_mb_delta(snapshot=False) == {}
    status = stepper.advance_local()
    assert status.current_mb == 1 and stepper.steps_remaining == 5
    while not stepper.finished:
        stepper.train_mb_delta()
        stepper.advance_local()
    assert stepper.steps_remaining == 0 and len(stepper.epoch_losses) == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "epoch_0.json", "epoch_0.npz", "epoch_1.json", "epoch_1.npz"]
    assert stepper.best_components is not None
    # A data layout of one rank is accepted, and is the one-device stepper.
    from gfedntm_tpu_torch.parallel.mesh import data_layout

    one = FederatedStepper(AVITM(device="cpu", **kw("avitm")), mesh=data_layout(1, None, 0))
    assert one.mesh is None
