"""The port's K5, ``prodlda_recon_loss_vsharded``, on the CPU over spawned
gloo ranks, against the JAX package's ``prodlda_recon_loss_vsharded`` under
``shard_map`` on the virtual CPU devices (Pallas in interpret mode) and
against ``jax.grad`` of the JAX unfused reference, at mp=2, mp=4 and
dp=2 x mp=2 (the rows-sharded training branch), training and eval, with 20%
of the rows masked and with an all-masked batch.

Tolerances are the JAX package's own (``tests/test_ops.py:543-549`` and
``:595-599``): rl rtol 2e-5, atol 2e-3 on valid rows; mean rtol and atol
1e-5; var rtol 1e-4, atol 1e-5; gradients max|diff| / max|ref| < 5e-4.
"""

from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from gfedntm_tpu.ops.fused_decoder import prodlda_recon_loss_reference as j_reference
from gfedntm_tpu.ops.fused_decoder import prodlda_recon_loss_vsharded as j_vsharded
from gfedntm_tpu.parallel.mesh import shard_map_compat
from gfedntm_tpu_torch.ops import fused_decoder as fd
from gfedntm_tpu_torch.parallel import collectives, programs
from gfedntm_tpu_torch.parallel.launch import run_ranks
from gfedntm_tpu_torch.parallel.programs import assemble
from gfedntm_tpu_torch.parallel.mesh import DpMpGroups

B, K, V = 16, 5, 512
LAYOUTS = {"mp2": (1, 2), "mp4": (1, 4), "dp2_mp2": (2, 2)}
CASES = [("partial", True), ("partial", False), ("all", True), ("all", False)]
TIMEOUT_S = 240


def make_case(seed, mask_kind, training):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, K))
    mask = (rng.random(B) > 0.2) if mask_kind == "partial" else np.zeros(B, bool)
    mask = mask.astype(np.float32)
    return dict(
        theta=(np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32),
        beta=rng.normal(size=(K, V)).astype(np.float32),
        x=rng.integers(0, 4, size=(B, V)).astype(np.float32),
        run_mean=(rng.normal(size=(V,)) * 0.1).astype(np.float32),
        run_var=rng.uniform(0.5, 2.0, size=(V,)).astype(np.float32),
        mask=mask, g=(np.linspace(0.1, 2.0, B) * mask).astype(np.float32),
        training=training,
    )


@pytest.fixture(scope="module")
def cases():
    return [make_case(seed, kind, training) for seed, (kind, training) in enumerate(CASES)]


@pytest.fixture(scope="module")
def port(cases):
    """{layout: [case][rank] outputs} — one spawn of dp*mp ranks per layout,
    the layouts side by side."""
    def spawn(layout):
        dp, mp = LAYOUTS[layout]
        res = run_ranks(programs.vsharded_op, dp * mp, "gloo", ["cpu"] * (dp * mp),
                        TIMEOUT_S, args=(dp, mp, cases))
        return [[r[i] for r in res] for i in range(len(cases))]

    with ThreadPoolExecutor(len(LAYOUTS)) as pool:
        futures = {name: pool.submit(spawn, name) for name in LAYOUTS}
        return {name: future.result() for name, future in futures.items()}


def jax_vsharded(case, dp, mp):
    devs = np.array(jax.devices()[: dp * mp])
    data_axis = "data" if dp > 1 else None
    mesh = (Mesh(devs.reshape(dp, mp), ("data", "model")) if dp > 1
            else Mesh(devs, ("model",)))
    fn = jax.jit(shard_map_compat(
        partial(j_vsharded, model_axis="model", data_axis=data_axis,
                training=case["training"], interpret=True),
        mesh,
        in_specs=(P(data_axis, None), P(None, "model"), P(data_axis, "model"),
                  P("model"), P("model"), P(data_axis)),
        out_specs=(P(data_axis), P("model"), P("model")),
        check=False,
    ))
    return [np.asarray(a) for a in fn(*(jnp.asarray(case[k]) for k in (
        "theta", "beta", "x", "run_mean", "run_var", "mask")))]


def jax_reference_grads(case):
    x, rm, rv = (jnp.asarray(case[k]) for k in ("x", "run_mean", "run_var"))
    mask, g = jnp.asarray(case["mask"]), jnp.asarray(case["g"])

    def total(theta, beta):
        rl, _, _ = j_reference(theta, beta, x, rm, rv, mask, case["training"])
        return jnp.sum(rl * g)

    return [np.asarray(a) for a in jax.grad(total, argnums=(0, 1))(
        jnp.asarray(case["theta"]), jnp.asarray(case["beta"]))]


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_forward_matches_jax_vsharded(port, cases, layout, training):
    dp, mp = LAYOUTS[layout]
    i = CASES.index(("partial", training))
    rl_j, mean_j, var_j = jax_vsharded(cases[i], dp, mp)
    per_rank = port[layout][i]
    real = cases[i]["mask"] > 0
    np.testing.assert_allclose(assemble(per_rank, dp, mp, "rl")[real], rl_j[real],
                               rtol=2e-5, atol=2e-3)
    np.testing.assert_allclose(assemble(per_rank, dp, mp, "mean"), mean_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(assemble(per_rank, dp, mp, "var"), var_j, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_gradients_match_jax_reference(port, cases, layout, training):
    dp, mp = LAYOUTS[layout]
    i = CASES.index(("partial", training))
    for name, want in zip(("g_theta", "g_beta"), jax_reference_grads(cases[i])):
        got = assemble(port[layout][i], dp, mp, name)
        scale = float(np.abs(want).max()) + 1e-9
        assert float(np.abs(got - want).max()) / scale < 5e-4, name


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_all_masked_batch_keeps_its_sentinels(port, cases, layout, training):
    dp, mp = LAYOUTS[layout]
    i = CASES.index(("all", training))
    per_rank = port[layout][i]
    assert np.all(assemble(per_rank, dp, mp, "rl") == 0.0)
    assert np.all(assemble(per_rank, dp, mp, "g_theta") == 0.0)
    assert np.all(assemble(per_rank, dp, mp, "g_beta") == 0.0)
    _, mean_j, var_j = jax_vsharded(cases[i], dp, mp)
    np.testing.assert_allclose(assemble(per_rank, dp, mp, "mean"), mean_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(assemble(per_rank, dp, mp, "var"), var_j, rtol=1e-4, atol=1e-5)
    if "m" in per_rank[0]:  # rows replicated: the merged K1 partials
        assert np.all(assemble(per_rank, dp, mp, "m", None) == np.float32(-1e30))
        assert np.all(assemble(per_rank, dp, mp, "l", None) == 0.0)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_masked_rows_merge_to_the_sentinel(port, cases, layout):
    dp, mp = LAYOUTS[layout]
    i = CASES.index(("partial", False))
    m = assemble(port[layout][i], dp, mp, "m", None)
    masked = cases[i]["mask"] == 0
    assert masked.any() and np.all(m[masked] == np.float32(-1e30))
    assert np.all(m[~masked] > -1e29)


@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"{k}-{'train' if t else 'eval'}"
                                                         for k, t in CASES])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_reference_equals_the_op_on_cpu(port, layout, case):
    """On CPU tensors the kernel wrappers run their plain versions, so K5 and
    its plain version compute the same bits."""
    for r in port[layout][case]:
        for name, value in r["kernel"].items():
            np.testing.assert_array_equal(value, r["plain"][name], err_msg=name)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_replicated_outputs_bitwise_equal_across_ranks(port, layout):
    dp, mp = LAYOUTS[layout]
    for per_rank in port[layout]:
        for d in range(dp):
            for m in range(mp):
                r, first = per_rank[d * mp + m]["kernel"], per_rank[d * mp]["kernel"]
                np.testing.assert_array_equal(r["rl"], first["rl"])
                np.testing.assert_array_equal(r["g_theta"], first["g_theta"])
                column = per_rank[m]["kernel"]  # data rank 0, same model rank
                np.testing.assert_array_equal(r["mean"], column["mean"])
                np.testing.assert_array_equal(r["var"], column["var"])


def test_layout_places_ranks_like_the_jax_mesh():
    res = run_ranks(programs.describe_layout, 4, "gloo", ["cpu"] * 4, TIMEOUT_S,
                    args=(2, 2, V))
    for rank, r in enumerate(res):
        d, m = divmod(rank, 2)
        assert (r["data_rank"], r["model_rank"]) == (d, m)
        assert r["v_slice"] == (m * V // 2, (m + 1) * V // 2)
        assert r["model_members"] == [2 * d, 2 * d + 1]
        assert r["data_members"] == [m, 2 + m]


def test_layout_mismatch_fails_with_the_rank_traceback():
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        run_ranks(programs.describe_layout, 2, "gloo", ["cpu"] * 2, TIMEOUT_S,
                  args=(2, 2, V))


def test_uneven_vocabulary_split_raises():
    with pytest.raises(ValueError, match="does not split evenly"):
        DpMpGroups(dp=1, mp=3, rank=0).v_slice(V)
    assert DpMpGroups(dp=2, mp=2, rank=3).row_slice(B) == slice(8, 16)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_one_rank_equals_the_single_device_op(training):
    """With one rank the groups are empty and K5 is ``prodlda_recon_loss``."""
    case = make_case(7, "partial", training)
    outs = []
    for fn in (fd.prodlda_recon_loss,
               partial(fd.prodlda_recon_loss_vsharded, groups=DpMpGroups(1, 1, 0))):
        theta = torch.from_numpy(case["theta"]).requires_grad_(True)
        beta = torch.from_numpy(case["beta"]).requires_grad_(True)
        rl, mean, var = fn(theta, beta, *(torch.from_numpy(case[k]) for k in (
            "x", "run_mean", "run_var", "mask")), training=training)
        (rl * torch.from_numpy(case["g"])).sum().backward()
        outs.append([t.detach().numpy() for t in (rl, mean, var, theta.grad, beta.grad)])
    for got, want in zip(*outs):
        np.testing.assert_array_equal(got, want)


def test_single_rank_collectives():
    t = torch.tensor([1.0, -1e30, 3.0])
    assert torch.equal(collectives.gather_by_sum(t, None), t[None])
    assert torch.equal(collectives.sum_in_rank_order(t, None), t)
    m, l = collectives.merge_softmax(t, torch.tensor([2.0, 0.0, 5.0]), None)
    assert torch.equal(m, t) and torch.equal(l, torch.tensor([2.0, 0.0, 5.0]))
    x = torch.ones(3, requires_grad=True)
    (collectives.sum_forward_identity_backward(x, None) * torch.arange(3.0)).sum().backward()
    assert torch.equal(x.grad, torch.arange(3.0))


def test_bf16_storage_raises():
    """bf16 storage is accepted on one rank (the full-V bf16 loss); an
    unknown storage name raises, as ``_storage_jnp`` does."""
    case = {k: torch.from_numpy(v) for k, v in make_case(0, "partial", True).items()
            if k != "training"}
    args = (case["theta"], case["beta"], case["x"], case["run_mean"], case["run_var"],
            case["mask"])
    got = fd.prodlda_recon_loss_vsharded(*args, groups=DpMpGroups(1, 1, 0),
                                         storage_dtype="bfloat16")
    want = fd.prodlda_recon_loss(*args, storage_dtype="bfloat16")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="storage_dtype"):
        fd.prodlda_recon_loss_vsharded(*args, groups=DpMpGroups(1, 1, 0),
                                       storage_dtype="float16")
