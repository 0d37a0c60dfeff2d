"""The port's federation wire against the JAX package's, without a network.

- The schema copies (``federated.proto``, ``federated_pb2.py``) are byte for
  byte the JAX package's and resolve to the same message classes.
- The records and flat bundles serialize to the JAX codec's bytes for the
  same arrays, bf16 included; a bridged model's variable and Adam-state
  bundles carry the JAX ``tree_to_bundle``'s names, order, shapes and
  dtypes (AVITM, CombinedTM with labels, a ``reduce_on_plateau`` model),
  and a JAX template's bundles load into a port model and encode back to
  the same bytes. A mismatched name, count or shape raises.
- The Adam bridge: a JAX model's state after two steps, loaded into a port
  model, takes a third step with injected noise in both packages; the
  parameters and Adam moments agree within the float32 parity bounds of
  ``tests/test_torch_train.py``.
- The copied modules (``rpc``, ``resilience``, ``compression``,
  ``registry``, ``utils/flightrec``) are the originals' code with their
  imports rewritten (docstrings and comments aside); compression sessions, the registry and pacing give the JAX
  package's outputs on the same inputs.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from gfedntm_tpu.federation import codec as j_codec
from gfedntm_tpu.federation import compression as j_compression
from gfedntm_tpu.federation import pacing as j_pacing
from gfedntm_tpu.federation import registry as j_registry
from gfedntm_tpu.federation.protos import federated_pb2 as j_pb
from gfedntm_tpu.federation.server import build_template_model as j_build
from gfedntm_tpu.models.losses import avitm_loss as j_avitm_loss
from gfedntm_tpu_torch import interop
from gfedntm_tpu_torch.federated.aggregation import FedAvg, make_aggregator, weighted_mean
from gfedntm_tpu_torch.federation import codec, compression, pacing, registry
from gfedntm_tpu_torch.federation.client import load_global_setup
from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb
from gfedntm_tpu_torch.federation.server import (
    build_template_model,
    model_opt_state,
    model_variables,
)
from gfedntm_tpu_torch.train.steps import grad_step

REPO = Path(__file__).resolve().parents[1]
V = 30
MODELS = {
    "avitm": ("avitm", dict(n_components=4, hidden_sizes=(8, 8), batch_size=8, seed=0)),
    "combined_labels": ("ctm", dict(n_components=4, hidden_sizes=(8, 8), batch_size=8,
                                    contextual_size=6, label_size=3,
                                    inference_type="combined", seed=0)),
    "reduce_on_plateau": ("avitm", dict(n_components=4, hidden_sizes=(8, 8, 8), batch_size=8,
                                        reduce_on_plateau=True, seed=0)),
}


def names(bundle):
    return [(r.name, tuple(r.shape), r.dtype) for r in bundle.tensors]


def jax_setup(model):
    return pb.GlobalSetup(
        init_variables=j_codec.tree_to_bundle(
            {"params": model.params, "batch_stats": model.batch_stats}),
        init_opt_state=j_codec.tree_to_bundle(model.opt_state))


# ---- schema ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["federated_pb2.py", "federated.proto"])
def test_schema_files_are_byte_identical(name):
    port = (REPO / "gfedntm_tpu_torch/federation/protos" / name).read_bytes()
    assert port == (REPO / "gfedntm_tpu/federation/protos" / name).read_bytes()


def test_schema_resolves_to_the_jax_messages():
    assert pb.DESCRIPTOR.serialized_pb == j_pb.DESCRIPTOR.serialized_pb
    assert pb.DESCRIPTOR.package == "gfedntm"
    assert {s.full_name for s in pb.DESCRIPTOR.services_by_name.values()} >= {
        "gfedntm.Federation", "gfedntm.FederationClient"}
    for message in ("TensorRecord", "TensorBundle", "GlobalSetup", "StepRequest",
                    "StepReply", "Aggregate", "JoinRequest"):
        assert getattr(pb, message) is getattr(j_pb, message)


# ---- records and flat bundles ------------------------------------------------

ARRAYS = {
    "float32": np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32),
    "float64": np.random.default_rng(1).normal(size=(4,)),
    "bfloat16": np.random.default_rng(2).normal(size=(2, 3)).astype(ml_dtypes.bfloat16),
    "int32": np.array(7, np.int32),
    "int64": np.arange(6, dtype=np.int64).reshape(2, 3),
    "uint32": np.array([1, 2**31 + 5], np.uint32),
    "bool": np.array([True, False, True]),
    "empty": np.zeros((0, 4), np.float32),
}


@pytest.mark.parametrize("kind", sorted(ARRAYS))
def test_records_are_the_jax_codecs_bytes(kind):
    arr = ARRAYS[kind]
    rec = codec.array_to_record("params/x", arr)
    assert rec.SerializeToString() == j_codec.array_to_record("params/x", arr).SerializeToString()
    back = codec.record_to_array(rec)
    want = j_codec.record_to_array(rec)
    assert back.dtype == want.dtype == arr.dtype and back.shape == arr.shape
    assert back.tobytes() == want.tobytes() == np.ascontiguousarray(arr).tobytes()


def test_records_refuse_what_the_jax_codec_refuses():
    with pytest.raises(TypeError):
        codec.array_to_record("x", np.array(["a"], dtype=object))
    rec = codec.array_to_record("x", ARRAYS["float32"])
    rec.codec = "topk"
    with pytest.raises(ValueError, match="compressed"):
        codec.record_to_array(rec)
    rec.codec, rec.dtype = "", "float16"
    with pytest.raises(TypeError):
        codec.record_to_array(rec)


def test_flat_bundles_are_the_jax_codecs_bytes():
    snap = {"params/beta": ARRAYS["float32"], "params/prior_mean": np.zeros(4, np.float32),
            "batch_stats/beta_batchnorm/num_batches_tracked": np.array(3, np.int32)}
    bundle = codec.flatdict_to_bundle(snap)
    assert bundle.SerializeToString() == j_codec.flatdict_to_bundle(snap).SerializeToString()
    out = codec.bundle_to_flatdict(bundle)
    assert list(out) == sorted(snap)
    for key, value in snap.items():
        assert out[key].dtype == value.dtype and np.array_equal(out[key], value)


# ---- trees: a bridged model's bundles ----------------------------------------

@pytest.mark.parametrize("model", sorted(MODELS))
def test_bridged_bundles_have_the_jax_names_order_shapes_and_dtypes(model):
    family, kw = MODELS[model]
    jm = j_build(family, V, kw)
    pm = build_template_model(family, V, kw, device="cpu")
    assert names(codec.tree_to_bundle(model_variables(pm))) == names(
        j_codec.tree_to_bundle({"params": jm.params, "batch_stats": jm.batch_stats}))
    assert names(codec.tree_to_bundle(model_opt_state(pm))) == names(
        j_codec.tree_to_bundle(jm.opt_state))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_a_jax_template_loads_and_encodes_back_bitwise(model):
    """A joining port client's state equals the JAX template, bitwise: the
    template's bundles set into a port model encode back to the same
    bytes."""
    family, kw = MODELS[model]
    jm = j_build(family, V, kw)
    setup = jax_setup(jm)
    pm = build_template_model(family, V, dict(kw, seed=5), device="cpu")
    load_global_setup(pm, setup)
    assert (codec.tree_to_bundle(model_variables(pm)).SerializeToString()
            == setup.init_variables.SerializeToString())
    assert (codec.tree_to_bundle(model_opt_state(pm)).SerializeToString()
            == setup.init_opt_state.SerializeToString())


def test_tree_leaves_follow_the_jax_flatten_order():
    tree = {"b": {"z": np.ones(1), "hiddens_l10": np.ones(2), "hiddens_l2": np.ones(3)},
            "a": (codec.Fields(count=np.int32(1), mu={"k": np.ones(1)}), ())}
    jtree = {"b": tree["b"],
             "a": (optax.ScaleByAdamState(count=np.int32(1), mu={"k": np.ones(1)}, nu={}),
                   optax.EmptyState())}
    port = [n for n, _ in codec.leaves_with_names(tree)]
    assert port == [r.name for r in j_codec.tree_to_bundle(jtree).tensors]


def test_bundle_to_tree_detects_mismatch():
    bundle = codec.tree_to_bundle({"a": np.ones(2)})
    with pytest.raises(ValueError, match="path mismatch"):
        codec.bundle_to_tree({"b": np.ones(2)}, bundle)
    with pytest.raises(ValueError, match="shape mismatch"):
        codec.bundle_to_tree({"a": np.ones(3)}, bundle)
    with pytest.raises(ValueError, match="tensors"):
        codec.bundle_to_tree({"a": np.ones(2), "c": np.ones(1)}, bundle)


def test_a_mismatched_setup_does_not_load():
    jm = j_build("avitm", V, MODELS["avitm"][1])
    setup = jax_setup(jm)
    wider = build_template_model("avitm", V + 1, MODELS["avitm"][1], device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        load_global_setup(wider, setup)
    plateau = build_template_model("avitm", V, dict(MODELS["avitm"][1], reduce_on_plateau=True),
                                   device="cpu")
    with pytest.raises(ValueError):
        load_global_setup(plateau, setup)


def test_bridge_refuses_other_solvers():
    pm = build_template_model("avitm", V, dict(MODELS["avitm"][1], solver="sgd"), device="cpu")
    with pytest.raises(NotImplementedError, match="Adam"):
        model_opt_state(pm)


# ---- the Adam bridge: one step in both packages ------------------------------

LR = 2e-3
DEGENERATE = ("inf_net.f_mu.bias", "inf_net.f_sigma.bias", "prior_mean")
BIAS_CARRIERS = ("inf_net.f_mu_batchnorm.running_mean",
                 "inf_net.f_sigma_batchnorm.running_mean")


def close(got, want, err_msg):
    scale = max(1e-30, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale, err_msg=err_msg)


def jax_step(jm, x, mask, noise):
    """One unfused step of the JAX model's module and optimizer with
    injected noise (the pattern of ``tests/test_torch_train.py``)."""
    def loss_fn(p):
        out, mut = jm.module.apply(
            {"params": p, "batch_stats": jm.batch_stats}, x, train=True, mask=mask,
            noise=noise, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        loss = j_avitm_loss(x, out.word_dist, out.prior_mean, out.prior_variance,
                            out.posterior_mean, out.posterior_variance,
                            out.posterior_log_variance, sample_mask=mask)
        return loss, mut["batch_stats"]

    (_, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(jm.params)
    updates, jm.opt_state = jm.tx.update(grads, jm.opt_state, jm.params)
    jm.params = optax.apply_updates(jm.params, updates)
    jm.batch_stats = bs


@pytest.mark.parametrize("plateau", [False, True], ids=["adam", "inject_hyperparams"])
def test_adam_state_bridges_through_a_step(plateau):
    kw = dict(n_components=4, hidden_sizes=(8, 8), batch_size=8, dropout=0.0, seed=0,
              reduce_on_plateau=plateau, fused_decoder=False)
    jm = j_build("avitm", V, kw)
    rng = np.random.default_rng(3)
    xs = rng.integers(0, 4, size=(3, 8, V)).astype(np.float32)
    masks = np.ones((3, 8), np.float32)
    masks[2, 5:] = 0.0
    noise = rng.normal(size=(3, 8, 4)).astype(np.float32)
    for i in range(2):
        jax_step(jm, jnp.asarray(xs[i]), jnp.asarray(masks[i]), jnp.asarray(noise[i]))
    pm = build_template_model("avitm", V, dict(kw, seed=7), device="cpu")
    load_global_setup(pm, jax_setup(jm))
    assert all(int(pm.optimizer.state[p]["step"]) == 2 for p in pm.model.parameters())
    before = {k: v.clone() for k, v in pm.model.state_dict().items()}

    jax_step(jm, jnp.asarray(xs[2]), jnp.asarray(masks[2]), jnp.asarray(noise[2]))
    grad_step(pm.model, pm.optimizer, {"x_bow": torch.from_numpy(xs[2])},
              torch.from_numpy(masks[2]), False, noise=torch.from_numpy(noise[2]))

    want = interop.state_dict_from_flax(jax.tree.map(np.asarray, jm.params),
                                        jax.tree.map(np.asarray, jm.batch_stats))
    for key, value in pm.model.state_dict().items():
        if key in DEGENERATE:
            for side in (value, want[key]):
                assert float((side - before[key]).abs().max()) <= LR * 1.001, key
        elif key in BIAS_CARRIERS:
            assert float((value - want[key]).abs().max()) <= 2 * LR, key
        else:
            close(value.numpy(), want[key].numpy(), key)
    adam = jm.opt_state.inner_state[0] if plateau else jm.opt_state[0]
    assert int(adam.count) == 3
    mu = interop.state_dict_from_flax(jax.tree.map(np.asarray, adam.mu), {})
    nu = interop.state_dict_from_flax(jax.tree.map(np.asarray, adam.nu), {})
    for name, p in pm.model.named_parameters():
        st = pm.optimizer.state[p]
        assert int(st["step"]) == 3
        for got, exp, what in ((st["exp_avg"], mu[name], "m"), (st["exp_avg_sq"], nu[name], "v")):
            if name in DEGENERATE:
                assert float(got.abs().max()) < 1e-3 and float(exp.abs().max()) < 1e-3
            else:
                close(got.numpy(), exp.numpy(), f"Adam {what} {name}")
    # Bridged back, the port's state is the JAX state's layout.
    back = codec.tree_to_bundle(model_opt_state(pm))
    assert names(back) == names(j_codec.tree_to_bundle(jm.opt_state))


def test_injected_learning_rate_loads_where_it_differs():
    kw = dict(n_components=4, hidden_sizes=(8, 8), reduce_on_plateau=True, seed=0)
    pm = build_template_model("avitm", V, kw, device="cpu")
    state = model_opt_state(pm)
    assert state["hyperparams"]["learning_rate"].dtype == np.float32
    interop.load_optax_adam_state(pm.model, pm.optimizer, state)
    assert pm.optimizer.param_groups[0]["lr"] == 2e-3  # equal in float32: kept
    state["hyperparams"]["learning_rate"] = np.float32(2e-4)
    interop.load_optax_adam_state(pm.model, pm.optimizer, state)
    assert pm.optimizer.param_groups[0]["lr"] == float(np.float32(2e-4))


# ---- the copies --------------------------------------------------------------

def _body(path: Path, package: str) -> str:
    """The module's code: its AST without docstrings (the copies' prose names
    their source), with ``package`` imports renamed to the JAX package's."""
    tree = ast.parse(path.read_text().replace(f"{package}.", "gfedntm_tpu."))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("module", ["federation/rpc.py", "federation/resilience.py",
                                    "federation/compression.py", "federation/registry.py",
                                    "utils/flightrec.py"])
def test_copies_are_the_originals(module):
    assert _body(REPO / "gfedntm_tpu_torch" / module, "gfedntm_tpu_torch") == _body(
        REPO / "gfedntm_tpu" / module, "gfedntm_tpu")


@pytest.mark.parametrize("spec", ["none", "fp16", "bf16", "delta", "topk:0.25",
                                  "delta+topk:0.25+fp16", "delta+bf16"])
def test_compression_sessions_give_the_jax_bytes(spec):
    rng = np.random.default_rng(4)
    snaps = [{"params/beta": rng.normal(size=(4, 30)).astype(np.float32),
              "params/inf_net/f_mu/bias": rng.normal(size=(4,)).astype(np.float32),
              "batch_stats/beta_batchnorm/num_batches_tracked": np.array(i, np.int32)}
             for i in range(4)]
    for mod in (compression, j_compression):
        assert mod.WireCodec(spec).codec_id == j_compression.WireCodec(spec).codec_id
    sides = []
    for mod in (compression, j_compression):
        wc = mod.WireCodec(spec)
        up, down = mod.UplinkEncoder(wc), mod.DownlinkDecoder(wc)
        enc, dec = mod.DownlinkEncoder(wc), mod.UplinkDecoder(wc)
        wire = []
        for r, snap in enumerate(snaps):
            if wc.identity:
                bundle = mod.codec.flatdict_to_bundle(snap)
                wire.append(bundle.SerializeToString())
                continue
            bundle = up.encode(snap)
            wire.append(bundle.SerializeToString())
            got = dec.decode(bundle)
            aggs = mod.encode_push_for_recipients(enc, dec, got, r, [1], {1: r - 1} if r else {},
                                                  False)
            wire.append(aggs[1].SerializeToString())
            avg = down.decode(aggs[1].shared, round_idx=r)
            up.note_aggregate(avg, r)
            wire.extend(v.tobytes() for _, v in sorted(avg.items()))
        sides.append(wire)
    assert sides[0] == sides[1]


def _registry_trace(mod):
    fed = mod.Federation(min_clients=2)
    out = []
    fed.connect_vocab(1, ("a", "b"), 10.0)
    fed.connect_vocab(2, ("b", "c"), 30.0)
    out.append(fed.wait_vocab_quorum(timeout=1.0))
    fed.set_session_token(1, "a" * 32)
    fed.set_session_token(2, "b" * 32)
    out += [fed.classify_join(1, "a" * 32), fed.classify_join(1, "a" * 32),
            fed.classify_join(2, "c" * 32), fed.classify_join(3, "")]
    fed.connect_ready(1, "localhost:1")
    fed.connect_ready(2, "localhost:2")
    out.append(fed.total_weight())
    out.append(fed.mark_suspect(2, "localhost:2", 0, probation_rounds=2, reason="rpc"))
    out.append([c.client_id for c in fed.active_clients(0)])
    out.append([c.client_id for c in fed.active_clients(5)])
    out.append([c.client_id for c in fed.pending_suspects(0)])
    out.append(fed.mark_recovered(2))
    fed.update_progress(1, 4, 1, 0.5, finished=True)
    out.append([c.client_id for c in fed.active_clients()])
    out.append(fed.mark_suspect(2, "localhost:2", 1, probation_rounds=1, reason="rpc"))
    out.append([(c.client_id, c.status, c.finished, c.nr_samples, c.current_mb)
                for c in fed.get_clients()])
    out.append([mod.looks_like_session_token(t) for t in ("a" * 32, "xyz", "A" * 32)])
    return out


def test_registry_follows_the_jax_registry():
    assert _registry_trace(registry) == _registry_trace(j_registry)


SPECS = ["sync", None, "cohort:4", "async:3", "push:2", "COHORT:2"]


@pytest.mark.parametrize("spec", SPECS)
def test_pacing_specs_parse_as_the_jax_ones(spec):
    got, want = pacing.parse_pacing(spec), j_pacing.parse_pacing(spec)
    assert (got.policy, got.cohort_size, got.buffer_size, got.spec_id) == (
        want.policy, want.cohort_size, want.buffer_size, want.spec_id)


@pytest.mark.parametrize("spec, kw", [("bogus", {}), ("sync:2", {}), ("cohort", {}),
                                      ("cohort:2", {"cohort_size": 3}), ("async:0", {}),
                                      ("sync", {"staleness_alpha": -1.0})])
def test_pacing_specs_refuse_as_the_jax_ones(spec, kw):
    with pytest.raises(ValueError):
        j_pacing.parse_pacing(spec, **kw)
    with pytest.raises(ValueError):
        pacing.parse_pacing(spec, **kw)


class _StubServer:
    """What ``RoundEngine.poll_deadline`` reads of a server."""

    def __init__(self, straggler, warmed):
        self.local_steps = 3
        self._poll_warmed = warmed
        self.straggler = straggler


def test_poll_deadlines_are_the_jax_engines():
    from gfedntm_tpu.utils.observability import StragglerDetector as JStraggler
    from gfedntm_tpu_torch.utils.observability import StragglerDetector

    lat = [{1: 0.2, 2: 3.0}, {1: 0.3, 2: 2.5, 3: 0.1}]
    out = []
    for mod, det in ((pacing, StragglerDetector()), (j_pacing, JStraggler())):
        for r in lat:
            det.observe_round(r)
        engine = mod.SyncEngine(_StubServer(det, {1, 2, 4}), mod.parse_pacing("sync"))
        recs = [registry.ClientRecord(c) for c in (1, 2, 3, 4)]
        out.append([engine.poll_deadline(rec) for rec in recs])
    assert out[0] == out[1]
    assert pacing.fallback_deadline(5) == j_pacing.fallback_deadline(5) == 130.0


@pytest.mark.parametrize("spec", ["cohort:2", "async:2", "push:2"])
def test_other_pacings_are_queued(spec):
    with pytest.raises(NotImplementedError, match="pacing"):
        pacing.make_engine(None, pacing.parse_pacing(spec))


def test_fedavg_is_the_weighted_mean_and_others_are_queued():
    rng = np.random.default_rng(5)
    snaps = [(3.0, {"a": rng.normal(size=4).astype(np.float32)}),
             (5.0, {"a": rng.normal(size=4).astype(np.float32)})]
    agg = make_aggregator("fedavg")
    assert isinstance(agg, FedAvg)
    assert agg.aggregate(snaps)["a"].tobytes() == weighted_mean(snaps)["a"].tobytes()
    for name in ("fedadam", "fedavgm", "median", "krum:1"):
        with pytest.raises(NotImplementedError):
            make_aggregator(name)
    with pytest.raises(NotImplementedError):
        make_aggregator("fedavg", robust="median")
    with pytest.raises(ValueError, match="unknown"):
        make_aggregator("fedbogus")
