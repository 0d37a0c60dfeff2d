"""Teacher-forced gradient steps (``programs.trajectory``, ``step_gradients``
with a given state, step and noise, ``programs.forced_steps``) on the CPU.

A trajectory replays ``AVITM.fit`` step by step and records, at chosen
steps, the full state and the reparameterization noise that step draws; the
sharded ranks and an unsharded model then take that same step from that
state. Tolerance for sharded vs unsharded gradients: 5e-4 of each leaf's
max|grad| (float32, other reduction orders), as for the first step in
``test_torch_sharded_fit.py``. The leaves whose gradient is a sum that
cancels in exact arithmetic (the two biases before the encoder's BatchNorms,
and ``prior_mean``, a sum over the batch of the normalized mu, whose batch
mean is zero) are held to 1e-5 of the largest gradient of any leaf: their
rounding is that of their O(1) terms, not of their small result.
"""

import numpy as np
import pytest
import torch

from gfedntm_tpu_torch.data.datasets import BowDataset, make_epoch_schedule
from gfedntm_tpu_torch.models.avitm import AVITM
from gfedntm_tpu_torch.parallel import programs
from gfedntm_tpu_torch.parallel.launch import run_ranks

V, K, B, DOCS = 96, 4, 8, 28  # 4 steps per epoch, the last one ragged
KW = dict(input_size=V, n_components=K, hidden_sizes=(16, 16), batch_size=B, num_epochs=2,
          dropout=0.0, seed=0, fused_decoder=True)
STEPS = (0, 3, 5, 7)
DEGENERATE = ("inf_net.f_mu.bias", "inf_net.f_sigma.bias", "prior_mean")


def corpus():
    return np.random.default_rng(1).integers(0, 3, size=(DOCS, V)).astype(np.float32)


@pytest.fixture(scope="module")
def replay():
    X = corpus()
    fitted = AVITM(device="cpu", **KW)
    fitted.fit(BowDataset(X=X), n_samples=1)
    records, losses = programs.trajectory(AVITM(device="cpu", **KW), X, STEPS)
    return X, fitted, records, losses


def test_trajectory_replays_the_fit(replay):
    X, fitted, records, losses = replay
    assert losses == fitted.step_losses
    assert [r["step"] for r in records] == list(STEPS)
    init = AVITM(device="cpu", **KW).model.state_dict()
    assert all(np.array_equal(records[0]["state"][k], v.numpy()) for k, v in init.items())
    assert records[0]["noise"].shape == (B, K)


def test_a_forced_step_takes_its_own_batch_state_and_noise(replay):
    X, _, records, _ = replay
    plain = programs.step_gradients(AVITM(device="cpu", **KW), X)
    forced = programs.step_gradients(AVITM(device="cpu", **KW), X, state=records[0]["state"],
                                     step=0, noise=records[0]["noise"])
    assert forced[0] == plain[0]
    assert all(np.array_equal(forced[1][k], plain[1][k]) for k in plain[1])
    rng = np.random.default_rng(KW["seed"])
    epochs = [make_epoch_schedule(DOCS, B, rng) for _ in range(2)]
    indices, mask = programs._batch(AVITM(device="cpu", **KW), DOCS, 7)
    assert np.array_equal(indices, epochs[1].indices[3])
    assert np.array_equal(mask, epochs[1].mask[3]) and not mask.all()
    later = programs.step_gradients(AVITM(device="cpu", **KW), X, state=records[-1]["state"],
                                    step=7, noise=records[-1]["noise"])
    assert later[0] != plain[0]


def test_forced_sharded_steps_match_unsharded(replay):
    X, _, records, _ = replay
    sharded = run_ranks(programs.forced_steps, 2, "gloo", ["cpu"] * 2, 240,
                        args=(1, 2, KW, X, records))
    for rank_out in sharded[1:]:
        for (loss, grads), (loss0, grads0) in zip(rank_out, sharded[0]):
            assert loss == loss0
            assert all(np.array_equal(grads[k], grads0[k]) for k in grads0)
    for rec, (loss, grads) in zip(records, sharded[0]):
        want_loss, want = programs.step_gradients(
            AVITM(device="cpu", **KW), X, state=rec["state"], step=rec["step"],
            noise=rec["noise"])
        assert loss == pytest.approx(want_loss, rel=1e-6), rec["step"]
        scale = max(float(np.abs(g).max()) for g in want.values())
        for name, g in want.items():
            if name in DEGENERATE:
                diff = float(np.abs(grads[name] - g).max())
                assert diff <= 1e-5 * scale, (rec["step"], name, diff)
                continue
            err = float(np.abs(grads[name] - g).max()) / float(np.abs(g).max())
            assert err < 5e-4, (rec["step"], name, err)
