"""The experiment harnesses of the port (``gfedntm_tpu_torch/experiments``:
DSS/TSS simulations, ``TMWrapper``, the collaborative experiment, WMD) on
the CPU at tiny shapes: ``tests/test_experiments.py``'s cases on the port,
and checks against the JAX functions on the same inputs.

- Bitwise: the node corpora a simulation generates, ``refmap_project``,
  the scores of the same betas and thetas (``_score_model``), the baseline
  arm, ``SimulationConfig.from_json`` and the WMD functions.
- Equal: the artifact's keys (``index``, ``index_name``, ``columns``,
  ``meta`` and ``meta["regime"]``) and ``results.json``'s; ``meta["backend"]``
  names the torch device's type.
- The trained arms (the port's models against the JAX package's: their
  generators never agree) by ordering and envelope: on the same corpus and
  seed each arm's TSS lies within 0.05 of the JAX arm's (of at most K = 4)
  and each DSS within 5% of it, and the centralized arm's TSS is above the
  baseline's in both. Measured on this configuration: TSS 2e-4 apart, DSS
  1.2%.

``TestEnvelopeArtifacts`` of the JAX tests reads committed JAX artifacts
and has no counterpart here.
"""

import json

import numpy as np
import pytest

import gfedntm_tpu.experiments.dss_tss as jdss
from gfedntm_tpu.experiments import wmd as jwmd
from gfedntm_tpu_torch.data.embeddings import hashing_embedder
from gfedntm_tpu_torch.data.synthetic import generate_synthetic_corpus
import gfedntm_tpu_torch.experiments.dss_tss as dss
from gfedntm_tpu_torch.experiments import (
    CollabExperimentConfig,
    SimulationConfig,
    TMWrapper,
    run_collab_experiment,
    run_iter_simulation,
    run_simulation,
    topic_set_wmd_matrix,
    wmd_centralized_vs_nodes,
)
from gfedntm_tpu_torch.experiments.wmd import relaxed_wmd

#: Trained arms against the JAX arms (see the module docstring).
TSS_ENVELOPE, DSS_ENVELOPE = 0.05, 0.05


def tiny(**overrides) -> dict:
    base = dict(
        vocab_size=120, n_topics=4, beta=0.05, alpha=0.25, n_docs=40, n_docs_global_inf=8,
        n_nodes=2, frozen_topics=2, nwords=(20, 30), experiment=1, eta_list=(0.05,),
        frozen_topics_list=(2,), iters=1, hidden_sizes=(16, 16), num_epochs=2, batch_size=8,
    )
    base.update(overrides)
    return base


def tiny_sim_config(**overrides) -> SimulationConfig:
    return SimulationConfig(**tiny(**overrides))


def synthetic_docs(n_docs=30, vocab=80, seed=0):
    corpus = generate_synthetic_corpus(vocab_size=vocab, n_topics=3, n_docs=n_docs,
                                       nwords=(15, 25), n_nodes=1, frozen_topics=1, seed=seed)
    return corpus.nodes[0].documents


def _untrained(module, monkeypatch, scores=(1.5, 400.0, 1.25)):
    """Skip every arm's training in ``module``: the baseline arm alone is
    computed; the trained arms score ``scores``."""
    monkeypatch.setattr(module, "_train_avitm", lambda *a, **k: (None, None, None))
    monkeypatch.setattr(module, "_score_model", lambda *a, **k: scores)


@pytest.fixture(scope="module")
def trained():
    """One iteration of both packages on the same tiny config and seed."""
    return (run_iter_simulation(tiny_sim_config(), seed=0, device="cpu"),
            jdss.run_iter_simulation(jdss.SimulationConfig(**tiny()), seed=0))


class TestDssTssSimulation:
    def test_run_iter_has_all_arms_and_finite_scores(self, trained):
        res, _ = trained
        assert set(res) == {"centralized", "non_colab", "baseline"}
        for arm in res.values():
            assert np.isfinite(arm["betas"]) and np.isfinite(arm["thetas"])
            assert 0.0 < arm["betas"] <= 4.0 + 1e-6

    def test_trained_arms_within_the_envelope_of_the_jax_arms(self, trained):
        res, jres = trained
        assert set(res) == set(jres)
        for arm in ("centralized", "non_colab"):
            for stat in ("betas", "betas_refmap"):
                assert abs(res[arm][stat] - jres[arm][stat]) < TSS_ENVELOPE, (arm, stat)
            rel = abs(res[arm]["thetas"] - jres[arm]["thetas"]) / jres[arm]["thetas"]
            assert rel < DSS_ENVELOPE, (arm, res[arm]["thetas"], jres[arm]["thetas"])
        for r in (res, jres):
            assert r["centralized"]["betas"] > r["baseline"]["betas"]

    def test_baseline_arm_is_the_jax_arm_bitwise(self, trained):
        res, jres = trained
        assert res["baseline"] == jres["baseline"]

    def test_refmap_project_replicates_reference_shift(self):
        beta = np.array([[0.5, 0.3, 0.2]])
        id2token = {0: "wd0", 1: "wd1", 2: "wd3"}
        out = dss.refmap_project(beta, id2token, vocab_size=4)
        assert out.shape == (1, 4)
        np.testing.assert_allclose(out[0], [0.6, 0.0, 0.4, 0.0])

    def test_refmap_project_is_the_jax_function(self):
        rng = np.random.default_rng(0)
        beta = rng.dirichlet(np.ones(50), 6)
        id2token = {j: f"wd{n}" for j, n in enumerate(rng.permutation(60)[:50])}
        got = dss.refmap_project(beta, id2token, 60)
        want = jdss.refmap_project(beta, id2token, 60)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    def test_scores_of_the_same_betas_and_thetas_are_the_jax_scores(self):
        corpus = generate_synthetic_corpus(vocab_size=80, n_topics=4, n_docs=30, nwords=(15, 25),
                                           n_nodes=1, frozen_topics=2, seed=2)
        from gfedntm_tpu_torch.data.preparation import prepare_dataset

        docs = corpus.nodes[0].documents
        _tr, _va, size, id2token, _d, vocab = prepare_dataset(docs[:20])
        rng = np.random.default_rng(1)

        class Fixed:
            betas = rng.dirichlet(np.ones(size), 4).astype(np.float32)
            thetas = rng.dirichlet(np.ones(4), 10).astype(np.float32)

            def get_topic_word_distribution(self):
                return self.betas

            def get_doc_topic_distribution(self, data, *args):
                assert data.X.shape == (10, size)
                return self.thetas

        args = (Fixed(), vocab, id2token, tiny_sim_config(vocab_size=80), docs[20:],
                corpus.topic_vectors, corpus.nodes[0].doc_topics[20:])
        got = dss._score_model(*args)
        want = jdss._score_model(*args[:3], jdss.SimulationConfig(**tiny(vocab_size=80)),
                                 *args[4:])
        assert got == want

    def test_node_corpora_are_the_jax_generators(self):
        from gfedntm_tpu.data.synthetic import generate_synthetic_corpus as j_generate

        cfg = tiny()
        kw = dict(vocab_size=cfg["vocab_size"], n_topics=cfg["n_topics"], beta=cfg["beta"],
                  alpha=cfg["alpha"], n_docs=cfg["n_docs"] + cfg["n_docs_global_inf"],
                  nwords=cfg["nwords"], n_nodes=cfg["n_nodes"],
                  frozen_topics=cfg["frozen_topics"], seed=0)
        got, want = generate_synthetic_corpus(**kw), j_generate(**kw)
        np.testing.assert_array_equal(got.topic_vectors, want.topic_vectors)
        for a, b in zip(got.nodes, want.nodes):
            assert a.documents == b.documents
            np.testing.assert_array_equal(a.doc_topics, b.doc_topics)

    def test_iter_simulation_refmap_leq_correct_map(self, trained):
        res, _ = trained
        for arm in ("centralized", "non_colab"):
            assert res[arm]["betas_refmap"] <= res[arm]["betas"] + 1e-9
        assert res["baseline"]["betas_refmap"] == res["baseline"]["betas"]

    def test_eta_sweep_uses_reference_frozen_override(self, tmp_path, monkeypatch):
        _untrained(dss, monkeypatch)
        cfg = tiny_sim_config(frozen_topics_list=(1, 3), frozen_topics=1, iters=1)
        out = run_simulation(cfg, results_dir=tmp_path, device="cpu")
        assert out["meta"]["regime"]["frozen_topics"] == 3
        stamp_dirs = list((tmp_path / "iters").iterdir())
        assert len(stamp_dirs) == 1
        stamp = json.loads((stamp_dirs[0] / "config_stamp.json").read_text())
        assert stamp["frozen_topics"] == "3"

    def test_run_simulation_sweep_schema_and_artifacts(self, tmp_path):
        cfg = tiny_sim_config(eta_list=(0.05, 0.1), num_epochs=1)
        out = run_simulation(cfg, results_dir=tmp_path, device="cpu")
        assert out["index"] == [0.05, 0.1]
        assert out["index_name"] == "Eta"
        for arm in ("centralized", "non_colab", "baseline"):
            for stat in ("betas", "thetas"):
                assert len(out["columns"][f"{arm}_{stat}_mean"]) == 2
                assert len(out["columns"][f"{arm}_{stat}_std"]) == 2
        saved = json.loads((tmp_path / "results.json").read_text())
        assert saved["columns"].keys() == out["columns"].keys()
        assert out["meta"]["backend"] == "cpu" and out["meta"]["iter_backends"] == ["cpu"] * 2

    def test_artifact_keys_are_the_jax_artifacts(self, tmp_path, monkeypatch):
        _untrained(dss, monkeypatch)
        _untrained(jdss, monkeypatch)
        cfg = tiny(eta_list=(0.05, 0.1), iters=2)
        out = run_simulation(SimulationConfig(**cfg), results_dir=tmp_path / "port",
                             device="cpu")
        jout = jdss.run_simulation(jdss.SimulationConfig(**cfg), results_dir=tmp_path / "jax")
        assert out.keys() == jout.keys()
        assert out["columns"].keys() == jout["columns"].keys()
        assert out["meta"].keys() == jout["meta"].keys()
        assert out["meta"]["regime"] == jout["meta"]["regime"]
        assert out["meta"]["stat_counts"] == jout["meta"]["stat_counts"]
        assert out["columns"] == jout["columns"]  # the baseline arm and the fixed scores
        for name in ("port", "jax"):
            assert (tmp_path / name / "results.json").exists()
        saved = json.loads((tmp_path / "port" / "results.json").read_text())
        jsaved = json.loads((tmp_path / "jax" / "results.json").read_text())
        assert saved.keys() == jsaved.keys() and saved["meta"].keys() == jsaved["meta"].keys()
        assert sorted(p.name for p in (tmp_path / "port" / "iters").iterdir()) == sorted(
            p.name for p in (tmp_path / "jax" / "iters").iterdir())

    def test_run_simulation_resumes_from_iteration_checkpoints(self, tmp_path, monkeypatch):
        _untrained(dss, monkeypatch)
        cfg = tiny_sim_config(iters=2)
        out1 = run_simulation(cfg, results_dir=tmp_path, device="cpu")
        ckpts = sorted((tmp_path / "iters").glob("*/point*.json"))
        assert len(ckpts) == 2

        def boom(*a, **k):
            raise AssertionError("iteration re-ran despite checkpoint")

        monkeypatch.setattr(dss, "run_iter_simulation", boom)
        out2 = run_simulation(cfg, results_dir=tmp_path, device="cpu")
        assert out2["columns"] == out1["columns"]
        with pytest.raises(AssertionError, match="re-ran"):
            run_simulation(tiny_sim_config(iters=2, seed=7), results_dir=tmp_path, device="cpu")

    def test_frozen_topics_sweep_uses_frozen_list(self, monkeypatch):
        _untrained(dss, monkeypatch)
        out = run_simulation(tiny_sim_config(experiment=0, frozen_topics_list=(0, 2)),
                             device="cpu")
        assert out["index"] == [0, 2]
        assert out["index_name"] == "Nr frozen topics"

    def test_config_from_json_is_the_jax_config(self, tmp_path):
        payload = {
            "vocab_size": 500, "n_topics": 10, "beta": 0.01, "alpha": 0.1,
            "n_docs": 100, "n_docs_global_inf": 10, "n_nodes": 3,
            "frozen_topics": 5, "experiment": 0, "iters": 2,
            "frozen_topics_list": "1 2 3", "eta_list": "0.01 0.1",
            "nwords": {"min": 10, "max": 20},
        }
        p = tmp_path / "config.json"
        p.write_text(json.dumps(payload))
        cfg = SimulationConfig.from_json(p)
        assert cfg.frozen_topics_list == (1, 2, 3)
        assert cfg.eta_list == (0.01, 0.1)
        assert cfg.nwords == (10, 20)
        assert cfg.n_nodes == 3
        assert cfg.__dict__ == jdss.SimulationConfig.from_json(p).__dict__
        assert SimulationConfig().__dict__ == jdss.SimulationConfig().__dict__


class TestTMWrapper:
    KW = dict(hidden_sizes=(16, 16), num_epochs=2, batch_size=8)

    def test_train_and_evaluate_avitm(self, tmp_path):
        docs = synthetic_docs()
        wrapper = TMWrapper(tmp_path, device="cpu")
        model, model_dir = wrapper.train_model("base", docs, model_type="avitm", n_topics=3,
                                               model_kwargs=self.KW)
        assert (model_dir / "trainconfig.json").exists()
        cfgd = json.loads((model_dir / "trainconfig.json").read_text())
        assert cfgd["model_type"] == "avitm" and cfgd["n_docs"] == len(docs)
        assert sorted(p.suffix for p in model_dir.glob("epoch_*")) == [".json", ".npz"]
        metrics = wrapper.evaluate_model(model, reference_corpus=docs)
        assert 0.0 <= metrics["topic_diversity"] <= 1.0
        assert -1.0 <= metrics["npmi"] <= 1.0
        assert 0.0 <= metrics["inverted_rbo"] <= 1.0
        assert str(model.device) == "cpu"

    def test_existing_model_dir_backed_up(self, tmp_path):
        docs = synthetic_docs(n_docs=20)
        wrapper = TMWrapper(tmp_path, device="cpu")
        kwargs = dict(hidden_sizes=(8, 8), num_epochs=1, batch_size=8)
        wrapper.train_model("m", docs, n_topics=2, model_kwargs=kwargs)
        wrapper.train_model("m", docs, n_topics=2, model_kwargs=kwargs)
        assert (tmp_path / "m").exists()
        assert (tmp_path / "m_old").exists()

    def test_ctm_requires_embeddings(self, tmp_path):
        wrapper = TMWrapper(tmp_path, device="cpu")
        with pytest.raises(ValueError, match="embeddings"):
            wrapper.train_model("ctm", ["a b c"] * 8, model_type="zeroshot")

    @pytest.mark.parametrize("version", ["HTM-WS", "HTM-DS"])
    def test_train_htm_submodel(self, tmp_path, version):
        docs = synthetic_docs(n_docs=40)
        wrapper = TMWrapper(tmp_path, device="cpu")
        father, father_dir = wrapper.train_model("father", docs, model_type="avitm",
                                                 n_topics=3, model_kwargs=self.KW)
        child, child_dir, child_corpus = wrapper.train_htm_submodel(
            version=version, father_model=father, father_dir=father_dir, corpus=docs,
            name="child0", expansion_topic=0, thr=0.05 if version == "HTM-DS" else None,
            model_type="avitm", n_topics=2, model_kwargs=self.KW)
        assert child_dir == father_dir / "child0"
        cfgd = json.loads((child_dir / "config.json").read_text())
        assert cfgd["hierarchy_level"] == 1
        assert cfgd["htm_version"] == version
        assert cfgd["expansion_tpc"] == 0
        assert cfgd["n_child_docs"] == len(child_corpus)
        assert 0 < len(child_corpus) <= len(docs)
        if version == "HTM-WS":
            assert sum(len(d.split()) for d in child_corpus) < sum(len(d.split()) for d in docs)
        assert len(child.get_topics(5)) == 2
        assert str(child.device) == "cpu"

    def test_htm_submodel_rejects_bad_version(self, tmp_path):
        wrapper = TMWrapper(tmp_path, device="cpu")
        with pytest.raises(ValueError, match="HTM-WS"):
            wrapper.train_htm_submodel(version="HTM-XX", father_model=None, father_dir=tmp_path,
                                       corpus=["a b"] * 8, name="c", expansion_topic=0)

    @pytest.mark.parametrize("model_type", ["zeroshot", "combined"])
    def test_train_ctm_on_hashing_embeddings(self, tmp_path, model_type):
        """The CTM arm on the port's ``hashing_embedder`` (the JAX presets'
        stand-in for SBERT)."""
        docs = synthetic_docs(n_docs=24)
        emb = hashing_embedder(16)(docs)
        wrapper = TMWrapper(tmp_path, device="cpu")
        model, _ = wrapper.train_model("ctm", docs, model_type=model_type, n_topics=3,
                                       embeddings=emb,
                                       model_kwargs=dict(hidden_sizes=(8, 8), num_epochs=1,
                                                         batch_size=8))
        assert len(model.get_topics(5)) == 3
        assert model.inference_type == model_type
        metrics = wrapper.evaluate_model(model, reference_corpus=docs)
        assert all(np.isfinite(v) for v in metrics.values())


class TestCollabExperiment:
    def test_runs_both_arms_and_saves(self, tmp_path):
        partitions = {
            "cat_a": synthetic_docs(n_docs=16, seed=0),
            "cat_b": synthetic_docs(n_docs=16, seed=1),
        }
        cfg = CollabExperimentConfig(
            n_topics_grid=(2,), compute_npmi=True,
            model_kwargs=dict(hidden_sizes=(8, 8), num_epochs=1, batch_size=8),
        )
        out = run_collab_experiment(partitions, tmp_path / "models", cfg,
                                    results_path=tmp_path / "results.json", device="cpu")
        assert set(out["non_collab"]) == {"cat_a", "cat_b"}
        assert 2 in out["centralized"]
        saved = json.loads((tmp_path / "results.json").read_text())
        assert "topic_diversity" in saved["centralized"]["2"]
        assert "npmi" in saved["non_collab"]["cat_a"]["2"]

    def test_config_defaults_are_the_jax_configs(self):
        from gfedntm_tpu.experiments import CollabExperimentConfig as JConfig

        assert CollabExperimentConfig().__dict__ == JConfig().__dict__


class TestWMD:
    def embeddings(self):
        rng = np.random.default_rng(0)
        return {f"w{i}": rng.normal(size=8) for i in range(20)}

    def test_identical_topics_zero_distance(self):
        emb = self.embeddings()
        topic = ["w0", "w1", "w2"]
        assert relaxed_wmd(topic, topic, emb) == pytest.approx(0.0)

    def test_oov_topic_is_inf(self):
        emb = self.embeddings()
        assert np.isinf(relaxed_wmd(["zzz"], ["w0"], emb))

    def test_matrix_shape_and_summary(self):
        emb = self.embeddings()
        central = [["w0", "w1"], ["w2", "w3"]]
        nodes = {"n1": [["w0", "w1"], ["w4", "w5"]]}
        mat = topic_set_wmd_matrix(nodes["n1"], central, emb)
        assert mat.shape == (2, 2)
        summary = wmd_centralized_vs_nodes(central, nodes, emb)
        assert summary["n1"] >= 0.0
        assert mat[0].min() == pytest.approx(0.0)

    def test_wmd_functions_are_the_jax_functions(self):
        emb = self.embeddings()
        rng = np.random.default_rng(3)
        words = [f"w{i}" for i in range(22)]  # two out of vocabulary
        central = [list(rng.choice(words, 4)) for _ in range(3)]
        nodes = {f"n{i}": [list(rng.choice(words, 4)) for _ in range(2)] for i in range(3)}
        for a in central:
            for b in nodes["n0"]:
                assert relaxed_wmd(a, b, emb) == jwmd.relaxed_wmd(a, b, emb)
        np.testing.assert_array_equal(topic_set_wmd_matrix(central, nodes["n1"], emb),
                                      jwmd.topic_set_wmd_matrix(central, nodes["n1"], emb))
        assert (wmd_centralized_vs_nodes(central, nodes, emb)
                == jwmd.wmd_centralized_vs_nodes(central, nodes, emb))

    def test_gensim_loading_stays_gated(self):
        import importlib.util

        from gfedntm_tpu_torch.experiments.wmd import load_gensim_embeddings

        if importlib.util.find_spec("gensim") is None:
            with pytest.raises(ImportError, match="gensim"):
                load_gensim_embeddings()


def test_exports_are_the_jax_packages():
    import gfedntm_tpu.experiments as jexp
    import gfedntm_tpu_torch.experiments as exp

    names = {n for n in dir(jexp) if not n.startswith("_")}
    assert names <= {n for n in dir(exp) if not n.startswith("_")}
