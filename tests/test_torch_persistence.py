"""Saving and loading across the two packages, on the CPU.

- ``gfedntm_tpu_torch.utils.serialization`` against
  ``gfedntm_tpu.utils.serialization``: the same '/'-joined npz keys, dtypes
  and values for the same tree, and the same flattening as
  ``flax.traverse_util``;
- a JAX ``AVITM.save`` loads in the port's ``AVITM.load`` and a port save
  loads in the JAX package's, every leaf bitwise equal (kernels transposed,
  ``num_batches_tracked`` int32 on disk), and both write the same config
  JSON;
- a bf16-compute model saves and loads float32 state; ``load`` builds a
  fresh optimizer; ``get_predicted_topics`` is the argmax of the topic
  mixtures; ``save_model_as_npz`` writes the JAX package's artifact.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict as flax_flatten
from flax.traverse_util import unflatten_dict as flax_unflatten

from gfedntm_tpu.models.avitm import AVITM as JAVITM
from gfedntm_tpu.utils import serialization as jser
from gfedntm_tpu_torch import interop
from gfedntm_tpu_torch.data.datasets import BowDataset
from gfedntm_tpu_torch.models.avitm import AVITM
from gfedntm_tpu_torch.utils import serialization as tser

V, K, H, B = 48, 5, (8, 8), 8
CONFIGS = [("prodLDA", True), ("LDA", True), ("prodLDA", False)]


def kw(model_type="prodLDA", learn_priors=True, **over):
    return dict(input_size=V, n_components=K, hidden_sizes=H, batch_size=B,
                model_type=model_type, learn_priors=learn_priors, num_epochs=2, seed=3,
                **over)


def perturbed(tree, seed):
    """A tree of the same structure with random positive values (so a
    transposed or mismatched leaf cannot pass by symmetry, and variances
    stay valid)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda leaf: (np.asarray(leaf) + rng.integers(1, 5)).astype(np.asarray(leaf).dtype)
        if np.asarray(leaf).dtype.kind == "i"
        else rng.uniform(0.1, 2.0, size=np.shape(leaf)).astype(np.asarray(leaf).dtype), tree)


def test_flatten_matches_flax():
    tree = {"params": {"inf_net": {"hiddens_l0": {"kernel": 1, "bias": 2}}, "beta": 3},
            "batch_stats": {"empty": {}, "bn": {"running_mean": 4}}}
    assert tser.flatten_dict(tree, sep="/") == flax_flatten(tree, sep="/")
    flat = flax_flatten(tree, sep="/")
    assert tser.unflatten_dict(flat, sep="/") == flax_unflatten(flat, sep="/")


@pytest.mark.parametrize("model_type,learn_priors", CONFIGS)
def test_save_variables_writes_the_jax_npz(tmp_path, model_type, learn_priors):
    j = JAVITM(**kw(model_type, learn_priors))
    tree = {"params": perturbed(j.params, 0), "batch_stats": perturbed(j.batch_stats, 1)}
    jser.save_variables(str(tmp_path / "j.npz"), tree)
    tser.save_variables(str(tmp_path / "t.npz"), tree)
    with np.load(tmp_path / "j.npz") as jz, np.load(tmp_path / "t.npz") as tz:
        assert jz.files == tz.files
        for key in jz.files:
            assert jz[key].dtype == tz[key].dtype, key
            np.testing.assert_array_equal(jz[key], tz[key], err_msg=key)
    loaded = tser.load_variables(str(tmp_path / "j.npz"))
    jloaded = jser.load_variables(str(tmp_path / "t.npz"))
    assert tser.flatten_dict(loaded).keys() == flax_flatten(jloaded, sep="/").keys()


@pytest.mark.parametrize("model_type,learn_priors", CONFIGS)
def test_jax_save_loads_in_the_port_bitwise(tmp_path, model_type, learn_priors):
    j = JAVITM(**kw(model_type, learn_priors))
    j.params = perturbed(j.params, 2)
    j.batch_stats = perturbed(j.batch_stats, 3)
    j.nn_epoch = 4
    j.save(str(tmp_path))
    port = AVITM(device="cpu", **kw(model_type, learn_priors))
    port.load(str(tmp_path), 4)
    want = interop.state_dict_from_flax(jax.tree.map(np.asarray, j.params),
                                        jax.tree.map(np.asarray, j.batch_stats))
    got = port.model.state_dict()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key
    assert port.nn_epoch == 4
    np.testing.assert_array_equal(port.best_components, np.asarray(j.params["beta"]))
    np.testing.assert_array_equal(port.get_topic_word_matrix(), j.get_topic_word_matrix())


@pytest.mark.parametrize("model_type,learn_priors", CONFIGS)
def test_port_save_loads_in_jax_bitwise(tmp_path, model_type, learn_priors):
    port = AVITM(device="cpu", **kw(model_type, learn_priors))
    params, stats = interop.flax_from_state_dict(port.model.state_dict())
    port.model.load_state_dict(interop.state_dict_from_flax(perturbed(params, 4),
                                                            perturbed(stats, 5)))
    port.nn_epoch = 7
    port.save(str(tmp_path))
    j = JAVITM(**kw(model_type, learn_priors))
    j.load(str(tmp_path), 7)
    params, stats = interop.flax_from_state_dict(port.model.state_dict())
    for want, got in ((params, j.params), (stats, j.batch_stats)):
        flat_w, flat_g = tser.flatten_dict(want), flax_flatten(jax.tree.map(np.asarray, got),
                                                               sep="/")
        assert flat_w.keys() == flat_g.keys()
        for key, value in flat_w.items():
            assert flat_g[key].dtype == value.dtype, key
            np.testing.assert_array_equal(flat_g[key], value, err_msg=key)
    with np.load(tmp_path / "epoch_7.npz") as z:
        nbt = [k for k in z.files if k.endswith("num_batches_tracked")]
        assert nbt and all(z[k].dtype == np.int32 for k in nbt)
    np.testing.assert_array_equal(j.get_topic_word_matrix(), port.get_topic_word_matrix())


@pytest.mark.parametrize("topic_prior_variance", [None, 0.5])
def test_both_write_the_same_config_json(tmp_path, topic_prior_variance):
    args = kw(topic_prior_variance=topic_prior_variance)
    j, port = JAVITM(**args), AVITM(device="cpu", **args)
    j.nn_epoch = port.nn_epoch = 2
    j.save(str(tmp_path / "jax"))
    port.save(str(tmp_path / "port"))
    texts = [(tmp_path / d / "epoch_2.json").read_text() for d in ("jax", "port")]
    assert texts[0] == texts[1]
    assert json.loads(texts[1])["nn_epoch"] == 2


def test_save_without_a_directory_writes_nothing(tmp_path, monkeypatch):
    port = AVITM(device="cpu", **kw())
    port.nn_epoch = 0
    monkeypatch.chdir(tmp_path)
    port.save(None)
    assert os.listdir(tmp_path) == []


def test_bf16_model_saves_and_loads_float32_state(tmp_path):
    port = AVITM(device="cpu", compute_dtype="bfloat16", **kw())
    X = np.random.default_rng(0).integers(0, 3, size=(16, V)).astype(np.float32)
    port.fit(BowDataset(X=X), n_samples=1)
    port.save(str(tmp_path))
    with np.load(tmp_path / f"epoch_{port.nn_epoch}.npz") as z:
        assert {z[k].dtype for k in z.files} == {np.dtype(np.float32), np.dtype(np.int32)}
    fresh = AVITM(device="cpu", compute_dtype="bfloat16", **kw())
    fresh.load(str(tmp_path), port.nn_epoch)
    for key, value in port.model.state_dict().items():
        got = fresh.model.state_dict()[key]
        assert got.dtype == value.dtype and torch.equal(got, value), key
    assert all(p.dtype == torch.float32 for p in fresh.model.parameters())
    assert fresh.model.compute_dtype == torch.bfloat16


def test_load_builds_a_fresh_optimizer(tmp_path):
    port = AVITM(device="cpu", **kw())
    port.fit(BowDataset(X=np.ones((16, V), np.float32)), n_samples=1)
    port.save(str(tmp_path))
    assert port.optimizer.state_dict()["state"]
    port.load(str(tmp_path), port.nn_epoch)
    assert port.optimizer.state_dict()["state"] == {}
    assert [p for g in port.optimizer.param_groups for p in g["params"]] == list(
        port.model.parameters())


def test_get_predicted_topics_is_the_argmax_of_theta():
    port = AVITM(device="cpu", **kw())
    data = BowDataset(X=np.random.default_rng(1).integers(0, 3, size=(11, V)).astype(np.float32))
    port.generator.manual_seed(5)
    theta = port.get_doc_topic_distribution(data, n_samples=3)
    port.generator.manual_seed(5)
    topics = port.get_predicted_topics(data, n_samples=3)
    assert topics == np.argmax(theta, axis=1).tolist()
    assert len(topics) == 11 and all(isinstance(t, int) for t in topics)


def test_save_model_as_npz_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    betas, thetas = rng.normal(size=(K, V)), rng.random(size=(4, K))
    topics = [["a", "b"], ["c", "d"]]
    paths = [mod.save_model_as_npz(str(tmp_path / name), betas, thetas, topics, K)
             for name, mod in (("jax", jser), ("port", tser))]
    assert [os.path.relpath(p, tmp_path) for p in paths] == ["jax/model.npz", "port/model.npz"]
    with np.load(paths[0]) as jz, np.load(paths[1]) as tz:
        assert jz.files == tz.files
        for key in jz.files:
            np.testing.assert_array_equal(jz[key], tz[key])
