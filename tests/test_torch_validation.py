"""Validation, early stopping and plateau scheduling on the CPU, against the
JAX package.

- ``train.steps.eval_epoch`` against the JAX eval forward + loss
  (``module.apply(train=False, noise=...)``, then ``avitm_loss`` with the
  batch mask, as ``_batch_loss(train=False)`` computes it) on bridged
  weights, random running statistics and the same noise: prodLDA with the
  fused and the unfused training decode (validation always decodes
  unfused) and LDA, float32 and bf16. The port's loss on the JAX network's
  outputs is within 1e-5 + 1e-5 * |loss| of the JAX loss in both dtypes;
  the port's whole eval step is within that in float32, and within
  1e-5 + 2^-7 * |loss| in bf16, where the two frameworks' encoders round a
  few float32 intermediates to neighbouring bf16 values (one bf16 step,
  the tolerance ``tests/test_torch_bf16.py`` holds the layers to; measured
  about 2e-4 of the loss);
- ``EarlyStopping`` and ``ReduceLROnPlateau`` against the JAX classes on
  hypothesis-generated metric sequences with plateaus and ties at the
  threshold; torch's own plateau class, which the port does not use, parts
  from them where its ``eps`` stops a reduction;
- ``AVITM.fit`` with a validation set draws the same training and
  validation index arrays, epoch by epoch, as the JAX package's ``fit``,
  stops at the epoch where the JAX ``EarlyStopping`` stops on the port's
  own validation losses, saves on every improvement, and sets the LR the
  JAX scheduler gives for those losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import gfedntm_tpu.models.avitm as javitm_mod
from gfedntm_tpu.models.avitm import AVITM as JAVITM
from gfedntm_tpu.models.losses import avitm_loss as j_avitm_loss
from gfedntm_tpu.train.early_stopping import EarlyStopping as JEarlyStopping
from gfedntm_tpu.train.schedulers import ReduceLROnPlateau as JReduceLROnPlateau
import gfedntm_tpu_torch.models.avitm as tavitm_mod
from gfedntm_tpu_torch import interop
from gfedntm_tpu_torch.data.datasets import BowDataset, make_epoch_schedule
from gfedntm_tpu_torch.models.avitm import AVITM
from gfedntm_tpu_torch.models.losses import avitm_loss
from gfedntm_tpu_torch.train.early_stopping import EarlyStopping
from gfedntm_tpu_torch.train.schedulers import ReduceLROnPlateau, set_learning_rate
from gfedntm_tpu_torch.train.steps import eval_epoch

V, K, H, B = 64, 6, (8, 8), 8
N_VAL = 21  # three steps, the last one with 3 real rows


def kw(**over):
    return dict(input_size=V, n_components=K, hidden_sizes=H, batch_size=B, dropout=0.2,
                seed=1, **over)


def random_stats(batch_stats, seed):
    """Running statistics away from the initial (0, 1), so eval mode shows."""
    rng = np.random.default_rng(seed)

    def leaf(path, value):
        value = np.asarray(value)
        name = path[-1].key
        if name == "running_mean":
            return rng.normal(scale=0.3, size=value.shape).astype(value.dtype)
        if name == "running_var":
            return rng.uniform(0.5, 2.0, size=value.shape).astype(value.dtype)
        return value

    return jax.tree_util.tree_map_with_path(leaf, batch_stats)


def as_torch(a):
    """A JAX array as a torch tensor of the same dtype (bf16 stays bf16)."""
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


CASES = [(m, f, d) for d in ("float32", "bfloat16")
         for m, f in (("prodLDA", True), ("prodLDA", False), ("LDA", False))]


@pytest.mark.parametrize("model_type,fused,dtype", CASES)
def test_eval_epoch_matches_jax_eval(model_type, fused, dtype):
    args = kw(model_type=model_type, fused_decoder=fused, compute_dtype=dtype)
    j = JAVITM(**args)
    params = jax.tree.map(np.asarray, j.params)
    stats = random_stats(jax.tree.map(np.asarray, j.batch_stats), 7)
    port = AVITM(device="cpu", **args)
    port.model.load_state_dict(interop.state_dict_from_flax(params, stats))
    rng = np.random.default_rng(2)
    X = rng.integers(0, 4, size=(N_VAL, V)).astype(np.float32)
    sched = make_epoch_schedule(N_VAL, B, np.random.default_rng(3))
    noise = rng.normal(size=(sched.steps_per_epoch, B, K)).astype(np.float32)

    port.model.train()
    got = eval_epoch(port.model, {"x_bow": torch.from_numpy(X)},
                     torch.as_tensor(sched.indices).long(),
                     torch.as_tensor(sched.mask, dtype=torch.float32),
                     noise=torch.from_numpy(noise).to(port.model.compute_dtype))
    assert port.model.training  # the mode is restored
    for i in range(sched.steps_per_epoch):
        x = jnp.asarray(X[sched.indices[i]])
        out = j.module.apply({"params": params, "batch_stats": stats}, x, train=False,
                             noise=jnp.asarray(noise[i]).astype(j._module_dtype()))
        want = float(j_avitm_loss(x, out.word_dist, out.prior_mean, out.prior_variance,
                                  out.posterior_mean, out.posterior_variance,
                                  out.posterior_log_variance,
                                  sample_mask=jnp.asarray(sched.mask[i], jnp.float32)))
        cross = float(avitm_loss(*(as_torch(t) for t in (
            x, out.word_dist, out.prior_mean, out.prior_variance, out.posterior_mean,
            out.posterior_variance, out.posterior_log_variance)),
            sample_mask=torch.as_tensor(sched.mask[i], dtype=torch.float32)))
        assert abs(cross - want) <= 1e-5 + 1e-5 * abs(want), (i, cross, want)
        rtol = 1e-5 if dtype == "float32" else 2.0 ** -7
        assert abs(float(got[i]) - want) <= 1e-5 + rtol * abs(want), (i, float(got[i]), want)


def test_eval_epoch_leaves_state_and_running_stats_alone():
    port = AVITM(device="cpu", **kw())
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    X = torch.from_numpy(np.random.default_rng(0).integers(0, 3, size=(N_VAL, V))
                         .astype(np.float32))
    sched = make_epoch_schedule(N_VAL, B, np.random.default_rng(0))
    losses = eval_epoch(port.model, {"x_bow": X}, torch.as_tensor(sched.indices).long(),
                        torch.as_tensor(sched.mask, dtype=torch.float32),
                        generator=port.generator)
    assert losses.shape == (3,) and torch.isfinite(losses).all() and not losses.requires_grad
    for key, value in port.model.state_dict().items():
        assert torch.equal(value, before[key]), key


metric = st.one_of(st.floats(-5.0, 5.0, allow_nan=False), st.sampled_from([1.0, 0.9999, 2.0]))


def plateau_sequences():
    """Metrics with runs of repeats (plateaus) and values exactly at the
    relative threshold of the best so far (ties)."""
    def expand(parts):
        out = []
        for value, repeat, tie in parts:
            out.extend([value] * repeat)
            if tie and out:
                best = min(out)
                out.append(best * (1.0 - 1e-4))
        return out
    return st.lists(st.tuples(metric, st.integers(1, 6), st.booleans()),
                    min_size=1, max_size=25).map(expand)


@settings(max_examples=150, deadline=None)
@given(seq=plateau_sequences(), patience=st.integers(0, 4),
       delta=st.sampled_from([0.0, 1e-4, 0.5, -0.1]))
def test_early_stopping_matches_jax(seq, patience, delta):
    saves = {"port": 0, "jax": 0}
    port = EarlyStopping(patience, delta, checkpoint_fn=lambda: saves.__setitem__(
        "port", saves["port"] + 1))
    ref = JEarlyStopping(patience, delta, checkpoint_fn=lambda: saves.__setitem__(
        "jax", saves["jax"] + 1))
    for value in seq:
        port(value)
        ref(value)
        assert (port.counter, port.best_score, port.early_stop, port.val_loss_min) == (
            ref.counter, ref.best_score, ref.early_stop, ref.val_loss_min)
        assert saves["port"] == saves["jax"]


@settings(max_examples=150, deadline=None)
@given(seq=plateau_sequences(), patience=st.integers(0, 4),
       factor=st.sampled_from([0.1, 0.5]), min_lr=st.sampled_from([0.0, 1e-3]))
def test_plateau_scheduler_matches_jax(seq, patience, factor, min_lr):
    port = ReduceLROnPlateau(2e-3, factor=factor, patience=patience, min_lr=min_lr)
    ref = JReduceLROnPlateau(2e-3, factor=factor, patience=patience, min_lr=min_lr)
    for value in seq:
        assert port.step(value) == ref.step(value)
        assert (port.best, port.num_bad_epochs) == (ref.best, ref.num_bad_epochs)


def test_torch_plateau_class_stops_reducing_where_jax_goes_on():
    """Why the port copies the JAX class: on a flat metric with patience 0,
    torch's ReduceLROnPlateau skips reductions smaller than its eps (1e-8)."""
    param = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.Adam([param], lr=2e-3)
    torch_sched = torch.optim.lr_scheduler.ReduceLROnPlateau(opt, patience=0)
    ref = JReduceLROnPlateau(2e-3, patience=0)
    port = ReduceLROnPlateau(2e-3, patience=0)
    lrs = []
    for _ in range(10):
        torch_sched.step(1.0)
        lrs.append((opt.param_groups[0]["lr"], ref.step(1.0), port.step(1.0)))
    assert all(j == p for _, j, p in lrs)
    assert any(t != j for t, j, _ in lrs)


def test_set_learning_rate_writes_every_param_group():
    a, b = torch.nn.Parameter(torch.zeros(1)), torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.Adam([{"params": [a]}, {"params": [b], "lr": 1.0}], lr=2e-3)
    set_learning_rate(opt, 2e-5)
    assert [g["lr"] for g in opt.param_groups] == [2e-5, 2e-5]


def record_schedules(monkeypatch, module):
    drawn = []
    original = module.make_epoch_schedule

    def recording(n_docs, batch_size, rng, shuffle=True):
        sched = original(n_docs, batch_size, rng, shuffle)
        drawn.append((n_docs, sched.indices.copy(), sched.mask.copy()))
        return sched

    monkeypatch.setattr(module, "make_epoch_schedule", recording)
    return drawn


def corpora():
    rng = np.random.default_rng(4)
    return (rng.integers(0, 3, size=(20, V)).astype(np.float32),
            rng.integers(0, 3, size=(N_VAL, V)).astype(np.float32))


def test_fit_draws_the_jax_schedules_with_validation(monkeypatch, tmp_path):
    X, Xv = corpora()
    args = kw(num_epochs=3, fused_decoder=False)
    jdrawn = record_schedules(monkeypatch, javitm_mod)
    tdrawn = record_schedules(monkeypatch, tavitm_mod)
    JAVITM(**args).fit(javitm_mod.BowDataset(X=X), javitm_mod.BowDataset(X=Xv),
                       patience=10, n_samples=1)
    AVITM(device="cpu", **args).fit(BowDataset(X=X), BowDataset(X=Xv), patience=10,
                                    n_samples=1)
    assert [n for n, _, _ in tdrawn] == [20, N_VAL] * 3
    assert len(jdrawn) == len(tdrawn)
    for (nj, ij, mj), (nt, it, mt) in zip(jdrawn, tdrawn):
        assert nj == nt
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(mt, mj)


@pytest.mark.parametrize("delta", [0.0, 0.3, 1e9])
def test_fit_stops_where_jax_early_stopping_stops(tmp_path, delta):
    X, Xv = corpora()
    port = AVITM(device="cpu", **kw(num_epochs=8, reduce_on_plateau=True))
    port.fit(BowDataset(X=X), BowDataset(X=Xv), save_dir=str(tmp_path), patience=2,
             delta=delta, n_samples=1)
    losses = port.validation_losses
    assert len(losses) == len(port.epoch_losses) and np.isfinite(losses).all()
    ref, saved, ref_sched, lr = JEarlyStopping(2, delta), [], JReduceLROnPlateau(port.lr), port.lr
    for epoch, value in enumerate(losses):
        before = ref.best_score
        ref(value)
        if ref.best_score != before or before is None:
            saved.append(epoch)
        if ref.early_stop:
            break
        lr = ref_sched.step(value)
    assert port.nn_epoch == epoch and len(losses) == epoch + 1
    assert (epoch < 7) == ref.early_stop
    if delta == 1e9:
        assert epoch == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"epoch_{e}.{ext}" for e in saved for ext in ("json", "npz"))
    assert port.optimizer.param_groups[0]["lr"] == lr


def test_train_only_fit_saves_every_epoch(tmp_path):
    X, _ = corpora()
    port = AVITM(device="cpu", **kw(num_epochs=2))
    port.fit(BowDataset(X=X), save_dir=str(tmp_path), n_samples=1)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "epoch_0.json", "epoch_0.npz", "epoch_1.json", "epoch_1.npz"]
    assert port.validation_losses == []
