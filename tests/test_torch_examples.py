"""The five walkthroughs of ``gfedntm_tpu_torch.examples`` on the CPU at
reduced sizes, each against the JAX flow its script runs, composed here
from the ``gfedntm_tpu`` functions that script calls (the scripts under
``examples/`` are neither edited nor run).

- ``bow_dataset_example``: its values and its printed lines equal the JAX
  flow's (shapes, vocabulary, the first 10 terms, doc 0's active terms).
- ``federated_simulation``: the consensus vocabulary is bitwise the JAX
  one, the global step count is equal, and the shared beta is bitwise equal
  across the port's clients (``FederatedResult.client_params``, one state a
  client, where the JAX result stacks them).
- ``centralized_training``, ``federated_simulation`` and
  ``realtext_federation``: TSS, final loss and topic diversity within an
  envelope of the JAX run on the same corpus (the two packages draw from
  different generators, as ``tests/test_torch_experiments.py`` holds its
  arms). Each bound is written beside its measured spread below.
- ``hierarchical_training``: the step from a father model to a child corpus
  is deterministic given the father's doc-topic mixtures theta, but theta
  is a Monte Carlo mean over 20 reparameterization draws, which the two
  packages take from different generators. So the JAX father's state is
  bridged into the port (``interop.py``) and, with the JAX father's theta
  given to both, the port's HTM-WS and HTM-DS child corpora equal the JAX
  ones; with each package's own draws the child corpora's sizes are held
  by envelope.
- ``realtext_federation``: ``vocab_size`` and ``n_clients`` (and the corpus
  counts) equal the JAX preset's on the same installed packages, here a
  synthetic ``site-packages`` tree that both packages read.
- Every module's ``main(["--device", "cpu"])`` exits 0 in a subprocess
  where ``jax`` and ``gfedntm_tpu`` raise on import; ``run()`` with
  ``device=None`` raises without CUDA; a ``main`` in a process that
  launched kernels before reports its own run's launches.
"""

import os
import subprocess
import sys
import sysconfig
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gfedntm_tpu_torch import interop
from gfedntm_tpu_torch.data.local_corpus import DEFAULT_CLIENT_GROUPS
from gfedntm_tpu_torch.examples import (
    NAMES,
    bow_dataset_example,
    centralized_training,
    federated_simulation,
    hierarchical_training,
    realtext_federation,
)
from gfedntm_tpu_torch.ops import fused_decoder as fd

REPO = Path(__file__).resolve().parents[1]
CPU = dict(device="cpu")

#: Reduced sizes of the trained walkthroughs (the scripts' widths, fewer
#: documents and epochs).
CENTRAL = dict(n_docs=200, num_epochs=6)
FEDERATED = dict(n_docs=60, num_epochs=3)
HIERARCHICAL = dict(n_docs=120, father_kwargs=dict(hidden_sizes=(32, 32), num_epochs=3,
                                                   batch_size=16),
                    child_kwargs=dict(hidden_sizes=(16, 16), num_epochs=1, batch_size=8))
REALTEXT = dict(scale=0.1, n_components=5, local_steps=4)

#: Envelopes of the port's run against the JAX run on the same corpus, each
#: about twice the largest |port - JAX| measured at these sizes over corpus
#: (or preset) seeds 0-4 on the CPU.
#: TSS of ``centralized_training`` (of at most K=8): measured 0.025.
TSS_ENVELOPE = 0.05
#: Final losses, relative: measured centralized 2.9%, federated 3.3%,
#: realtext 0.4%.
LOSS_ENVELOPE = 0.07
#: Topic diversity: measured federated 0.0625 (top 25 words of 6 topics),
#: realtext 0.20 (top 10 words of 5 topics, a step of 0.02 a word).
DIVERSITY_ENVELOPE = {"federated": 0.13, "realtext": 0.40}
#: HTM child corpus sizes with each package's own theta draws, on the
#: bridged father, relative to the size from the JAX father's theta:
#: measured 22% (seeds 0-4, three port seeds each; two JAX draws differ as
#: much).
CHILD_ENVELOPE = 0.45


# ---- the JAX flows, as each script composes them -----------------------------------

def jax_bow(vocab_size=300, n_topics=5, n_docs=100, nwords=(20, 40), frozen_topics=2, seed=0):
    from gfedntm_tpu.data.preparation import prepare_dataset
    from gfedntm_tpu.data.synthetic import generate_synthetic_corpus

    corpus = generate_synthetic_corpus(vocab_size=vocab_size, n_topics=n_topics, n_docs=n_docs,
                                       nwords=nwords, n_nodes=1, frozen_topics=frozen_topics,
                                       seed=seed)
    docs = corpus.nodes[0].documents
    train_data, val_data, input_size, id2token, docs_train, vocab = prepare_dataset(docs)
    lines = [
        f"{len(docs)} documents; first doc: {docs[0][:70]}...",
        f"vocabulary: {input_size} terms (25% validation split, seed 42)",
        f"train matrix: {train_data.X.shape}, val matrix: {val_data.X.shape}",
        f"first 10 terms: {[id2token[i] for i in range(10)]}",
        f"doc 0 active terms: {int((train_data.X[0] > 0).sum())}",
    ]
    return dict(n_documents=len(docs), first_doc=docs[0], vocab_size=input_size,
                train_shape=tuple(train_data.X.shape), val_shape=tuple(val_data.X.shape),
                first_terms=[id2token[i] for i in range(10)],
                doc0_active_terms=int((train_data.X[0] > 0).sum())), lines


def jax_centralized(n_docs=400, num_epochs=15, seed=0, V=500, K=8):
    from gfedntm_tpu.data.preparation import prepare_dataset
    from gfedntm_tpu.data.synthetic import generate_synthetic_corpus
    from gfedntm_tpu.eval.metrics import (
        convert_topic_word_to_init_size,
        random_baseline_tss,
        topic_similarity_score,
    )
    from gfedntm_tpu.models import AVITM

    corpus = generate_synthetic_corpus(vocab_size=V, n_topics=K, n_docs=n_docs,
                                       nwords=(30, 60), n_nodes=1, frozen_topics=3, seed=seed)
    train_data, val_data, input_size, id2token, _d, _v = prepare_dataset(
        corpus.nodes[0].documents)
    model = AVITM(input_size=input_size, n_components=K, hidden_sizes=(64, 64), batch_size=32,
                  num_epochs=num_epochs)
    model.fit(train_data, val_data)
    betas = convert_topic_word_to_init_size(V, model.get_topic_word_distribution(), id2token)
    return dict(vocab_size=input_size, train_shape=tuple(train_data.X.shape),
                val_shape=tuple(val_data.X.shape),
                tss=topic_similarity_score(betas, corpus.topic_vectors),
                random_baseline_tss=random_baseline_tss(corpus.topic_vectors),
                final_loss=model.epoch_losses[-1])


def jax_federated(n_docs=150, num_epochs=10, seed=0):
    from gfedntm_tpu.data.loaders import RawCorpus
    from gfedntm_tpu.data.synthetic import generate_synthetic_corpus
    from gfedntm_tpu.eval.metrics import topic_diversity
    from gfedntm_tpu.federated import run_vocab_consensus
    from gfedntm_tpu.federated.trainer import FederatedTrainer
    from gfedntm_tpu.models import AVITM

    corpus = generate_synthetic_corpus(vocab_size=400, n_topics=6, n_docs=n_docs,
                                       nwords=(25, 45), n_nodes=3, frozen_topics=2, seed=seed)
    consensus = run_vocab_consensus([RawCorpus(documents=list(n.documents))
                                     for n in corpus.nodes])
    template = AVITM(input_size=len(consensus.global_vocab), n_components=6,
                     hidden_sizes=(32, 32), batch_size=16, num_epochs=num_epochs)
    trainer = FederatedTrainer(template, n_clients=3)
    result = trainer.fit(consensus.datasets)
    global_model = trainer.make_global_model(result)
    global_model.train_data = consensus.datasets[0]
    topics = global_model.get_topics(8)
    return dict(global_vocab=list(consensus.global_vocab.tokens),
                vocab_size=len(consensus.global_vocab), global_steps=int(result.losses.shape[0]),
                final_mean_loss=float(result.losses[-1].mean()),
                topic_diversity=topic_diversity(topics))


def fake_site_packages(root: Path) -> None:
    """Five package families of 30 modules each (``DEFAULT_CLIENT_GROUPS``'
    first package of each), every docstring 60 words drawn from its
    family's own 40 consonant-only words: no stop word, each word in at most
    a fifth of the documents."""
    rng = np.random.default_rng(0)
    letters = list("bcdfghjklmnpqrstvwxz")
    for pkgs in DEFAULT_CLIENT_GROUPS.values():
        words = ["".join(rng.choice(letters, 7)) for _ in range(40)]
        pkg = root / pkgs[0]
        pkg.mkdir(parents=True)
        for i in range(30):
            (pkg / f"m{i}.py").write_text(f'"""{" ".join(rng.choice(words, 60))}"""\n')


def read_site_packages(monkeypatch, root: Path) -> None:
    """Point ``sysconfig``'s ``purelib`` (the installed packages both
    presets read) at ``root``."""
    paths = sysconfig.get_paths
    monkeypatch.setattr(sysconfig, "get_paths",
                        lambda *a, **k: {**paths(*a, **k), "purelib": str(root)})


# ---- bow_dataset_example -------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(vocab_size=200, n_topics=4, n_docs=60, seed=3)])
def test_bow_values_are_the_jax_flows(kw):
    got = bow_dataset_example.run(**kw, **CPU)
    want, _ = jax_bow(**kw)
    for key, value in want.items():
        assert got[key] == value, key


def test_bow_printed_text_is_the_jax_scripts(capsys):
    assert bow_dataset_example.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    _, want = jax_bow()
    assert out[:len(want)] == want
    assert out[len(want):] == ["device: cpu; K1-K3 launches: stats 0, loss 0, grads 0"]


# ---- centralized_training ------------------------------------------------------------

@pytest.fixture(scope="module")
def centralized():
    return (centralized_training.run(**CENTRAL, **CPU),
            jax_centralized(**CENTRAL))


def test_centralized_prepares_the_jax_data(centralized):
    got, want = centralized
    for key in ("vocab_size", "train_shape", "val_shape", "random_baseline_tss"):
        assert got[key] == want[key], key


def test_centralized_scores_within_the_envelope_of_the_jax_run(centralized):
    got, want = centralized
    assert abs(got["tss"] - want["tss"]) <= TSS_ENVELOPE, (got["tss"], want["tss"])
    assert got["tss"] > got["random_baseline_tss"]
    assert abs(got["final_loss"] - want["final_loss"]) <= LOSS_ENVELOPE * abs(want["final_loss"])
    assert got["epochs"] <= CENTRAL["num_epochs"]
    n_train = got["train_shape"][0]
    assert got["steps"] == got["epochs"] * -(-n_train // 32)
    assert len(got["topics"]) == 3 and all(len(t) == 8 for t in got["topics"])
    assert got["models"]["centralized"].device.type == "cpu"


# ---- federated_simulation ------------------------------------------------------------

@pytest.fixture(scope="module")
def federated():
    return federated_simulation.run(**FEDERATED, **CPU), jax_federated(**FEDERATED)


def test_federated_consensus_and_steps_are_the_jax_ones(federated):
    got, want = federated
    assert got["global_vocab"] == want["global_vocab"]
    assert got["vocab_size"] == want["vocab_size"]
    assert got["global_steps"] == want["global_steps"]
    assert got["client_steps"] == 3 * got["global_steps"]


def test_federated_shared_beta_is_bitwise_equal_across_clients(federated):
    got, _ = federated
    assert got["beta_bitwise_equal"] is True
    model = got["models"]["global"]
    assert model.train_data is not None and model.device.type == "cpu"


def test_federated_within_the_envelope_of_the_jax_run(federated):
    got, want = federated
    assert abs(got["final_mean_loss"] - want["final_mean_loss"]) <= (
        LOSS_ENVELOPE * abs(want["final_mean_loss"]))
    assert abs(got["topic_diversity"] - want["topic_diversity"]) <= (
        DIVERSITY_ENVELOPE["federated"])


# ---- hierarchical_training -----------------------------------------------------------

@pytest.fixture(scope="module")
def hierarchy(tmp_path_factory):
    """The JAX father (``TMWrapper.train_model``) on the walkthrough's
    corpus, its state bridged into a port ``AVITM``, and its theta."""
    from gfedntm_tpu.data.synthetic import generate_synthetic_corpus
    from gfedntm_tpu.experiments.tm_wrapper import TMWrapper as JTMWrapper
    from gfedntm_tpu_torch.data.preparation import prepare_dataset
    from gfedntm_tpu_torch.data.datasets import BowDataset
    from gfedntm_tpu_torch.data.vocab import vectorize
    from gfedntm_tpu_torch.models.avitm import AVITM

    docs = generate_synthetic_corpus(vocab_size=400, n_topics=6, n_docs=HIERARCHICAL["n_docs"],
                                     nwords=(25, 45), n_nodes=1, frozen_topics=2,
                                     seed=0).nodes[0].documents
    root = tmp_path_factory.mktemp("jax_htm")
    jfather, jdir = JTMWrapper(root).train_model(
        "father", docs, model_type="avitm", n_topics=6,
        model_kwargs=HIERARCHICAL["father_kwargs"])
    port = AVITM(input_size=jfather.input_size, n_components=6, **CPU,
                 **HIERARCHICAL["father_kwargs"])
    port.model.load_state_dict(interop.state_dict_from_flax(
        jax.tree.map(np.asarray, jfather.params), jax.tree.map(np.asarray, jfather.batch_stats)))
    port.best_components = np.asarray(jfather.best_components)
    _tr, _va, _n, id2token, _d, vocab = prepare_dataset(docs)
    data = BowDataset(X=vectorize(docs, vocab), idx2token=id2token)
    port.train_data = data
    return dict(docs=docs, jfather=jfather, jdir=jdir, port=port,
                theta=np.asarray(jfather.get_doc_topic_distribution(data)))


def child_corpora(wrapper_cls, father, father_dir, docs, root, monkeypatch, theta=None):
    """Each HTM version's child corpus from ``wrapper_cls``'s
    ``train_htm_submodel`` on ``father`` (with ``theta`` its mixtures, if
    given); the child's training is skipped."""
    corpora = {}

    def train_model(self, name, corpus, **kw):
        corpora[name] = list(corpus)
        (self.models_root / name).mkdir(parents=True, exist_ok=True)
        return None, self.models_root / name

    monkeypatch.setattr(wrapper_cls, "train_model", train_model)
    if theta is not None:
        monkeypatch.setattr(father, "get_doc_topic_distribution",
                            lambda data, n_samples=20: theta)
    wrapper = wrapper_cls(root)
    for version in hierarchical_training.VERSIONS:
        wrapper.train_htm_submodel(version=version, father_model=father, father_dir=father_dir,
                                   corpus=docs, name=version, expansion_topic=0,
                                   model_type="avitm", n_topics=3)
    monkeypatch.undo()
    return corpora


def test_htm_child_corpora_are_the_jax_ones_from_a_bridged_father(hierarchy, tmp_path,
                                                                   monkeypatch):
    from gfedntm_tpu.experiments.tm_wrapper import TMWrapper as JTMWrapper
    from gfedntm_tpu_torch.experiments.tm_wrapper import TMWrapper

    h = hierarchy
    np.testing.assert_array_equal(h["port"].get_topic_word_distribution(),
                                  h["jfather"].get_topic_word_distribution())
    want = child_corpora(JTMWrapper, h["jfather"], h["jdir"], h["docs"], tmp_path / "j",
                         monkeypatch, h["theta"])
    got = child_corpora(TMWrapper, h["port"], tmp_path / "p", h["docs"], tmp_path / "p",
                        monkeypatch, h["theta"])
    assert sorted(got) == sorted(want) == sorted(hierarchical_training.VERSIONS)
    for version in want:
        assert len(want[version]) >= 8
        assert got[version] == want[version], version


def test_htm_child_corpora_with_own_draws_within_the_envelope(hierarchy, tmp_path, monkeypatch):
    from gfedntm_tpu.experiments.tm_wrapper import TMWrapper as JTMWrapper
    from gfedntm_tpu_torch.experiments.tm_wrapper import TMWrapper

    h = hierarchy
    want = child_corpora(JTMWrapper, h["jfather"], h["jdir"], h["docs"], tmp_path / "j",
                         monkeypatch, h["theta"])
    got = child_corpora(TMWrapper, h["port"], tmp_path / "p", h["docs"], tmp_path / "p",
                        monkeypatch)
    for version in want:
        n, m = len(got[version]), len(want[version])
        assert abs(n - m) <= CHILD_ENVELOPE * m, (version, n, m)


def test_htm_walkthrough_trains_father_and_children(tmp_path):
    out = hierarchical_training.run(**HIERARCHICAL, models_root=tmp_path, **CPU)
    assert set(out["children"]) == set(hierarchical_training.VERSIONS)
    for version, child in out["children"].items():
        assert child["n_docs"] >= 8
        assert Path(child["dir"]).is_dir() and Path(child["dir"]).parent == tmp_path / "father"
        assert np.isfinite(child["final_loss"]) and len(child["topics"]) == 3
    assert out["steps"] == out["father_steps"] + sum(c["steps"]
                                                     for c in out["children"].values())
    assert len(out["father_topics"]) == 6 and np.isfinite(out["father_final_loss"])
    assert hierarchical_training.lines(out)[0] == "father topics:"


# ---- realtext_federation -------------------------------------------------------------

@pytest.fixture(scope="module")
def realtext(tmp_path_factory):
    from gfedntm_tpu.presets import realtext_docstrings_5client as jpreset

    root = tmp_path_factory.mktemp("site_packages")
    fake_site_packages(root)
    with pytest.MonkeyPatch.context() as mp:
        read_site_packages(mp, root)
        return realtext_federation.run(**REALTEXT, **CPU), jpreset(**REALTEXT).summary


def test_realtext_counts_are_the_jax_presets(realtext):
    got, want = realtext
    assert got["n_clients"] == want["n_clients"] == 5
    assert got["vocab_size"] == want["vocab_size"] > 0
    assert got["global_steps"] == want["global_steps"]
    assert got["corpus_info"] == want["corpus_info"]


def test_realtext_within_the_envelope_of_the_jax_run(realtext):
    got, want = realtext
    assert abs(got["final_mean_loss"] - want["final_mean_loss"]) <= (
        LOSS_ENVELOPE * abs(want["final_mean_loss"]))
    assert abs(got["metrics"]["topic_diversity"] - want["metrics"]["topic_diversity"]) <= (
        DIVERSITY_ENVELOPE["realtext"])
    assert -1.0 <= got["metrics"]["npmi"] <= 1.0
    assert len(got["topics"]) == 5 and got["client_steps"] == 5 * got["global_steps"]
    assert realtext_federation.lines(got)[-1] == realtext_federation.NOTE


# ---- every module --------------------------------------------------------------------

@pytest.fixture(scope="module")
def mains(tmp_path_factory):
    """Every module's ``main(["--device", "cpu"])`` (the JAX script's sizes)
    in a subprocess of its own, all at once, where ``jax`` and
    ``gfedntm_tpu`` raise on import; ``realtext_federation`` reads a
    synthetic ``site-packages`` tree."""
    root = tmp_path_factory.mktemp("mains")
    for name in ("jax", "gfedntm_tpu"):
        (root / name).mkdir()
        (root / name / "__init__.py").write_text(
            f"raise ImportError('{name} must not be imported')\n")
    site = root / "site_packages"
    fake_site_packages(site)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # One thread each: five small eager trainings at once on the CPU.
    env.update(PYTHONPATH=os.pathsep.join([str(root), str(REPO)]), TMPDIR=str(root),
               OMP_NUM_THREADS="1")
    procs = {}
    for name in NAMES:
        code = ("import sys, sysconfig\n"
                "paths = sysconfig.get_paths\n"
                f"sysconfig.get_paths = lambda *a, **k: {{**paths(*a, **k), "
                f"'purelib': {str(site)!r}}}\n"
                f"from gfedntm_tpu_torch.examples.{name} import main\n"
                "rc = main(['--device', 'cpu'])\n"
                "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'gfedntm_tpu')]\n"
                "sys.exit(rc or (3 if bad else 0))\n")
        procs[name] = subprocess.Popen([sys.executable, "-c", code], cwd=root, env=env,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
    return {name: (proc.wait(timeout=300), *proc.communicate()) for name, proc in procs.items()}


@pytest.mark.parametrize("name", NAMES)
def test_main_runs_on_the_cpu_without_jax(mains, name):
    rc, out, err = mains[name]
    assert rc == 0, out[-2000:] + err[-4000:]
    assert out.splitlines()[-1] == "device: cpu; K1-K3 launches: stats 0, loss 0, grads 0"


@pytest.mark.parametrize("name", NAMES)
def test_run_without_a_device_needs_cuda(monkeypatch, name):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"gfedntm_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.run()


def test_launch_line_reads_the_kernel_counters(monkeypatch):
    from gfedntm_tpu_torch.examples import launch_line

    monkeypatch.setitem(fd.LAUNCHES, "stats", 7)
    monkeypatch.setitem(fd.LAUNCHES, "loss", 7)
    monkeypatch.setitem(fd.LAUNCHES, "grads", 6)
    zero = dict(stats=0, loss=0, grads=0)
    assert launch_line("cuda:0", zero) == (
        "device: cuda:0; K1-K3 launches: stats 7, loss 7, grads 6")


@pytest.mark.parametrize("name,kw,launched", [
    ("bow_dataset_example", {}, False),
    ("centralized_training", dict(n_docs=80, num_epochs=1), False),
    ("centralized_training", dict(n_docs=80, num_epochs=1), True),
])
def test_main_reports_the_launches_of_its_own_run(monkeypatch, capsys, name, kw, launched):
    """With K1-K3 counted before (an earlier run in the process), ``main``'s
    last line holds the launches of its own run: 0 on the CPU, or one of
    each kernel per training step where the run counts them as the card's
    wrappers do."""
    import importlib

    module = importlib.import_module(f"gfedntm_tpu_torch.examples.{name}")
    for kernel in ("stats", "loss", "grads"):
        monkeypatch.setitem(fd.LAUNCHES, kernel, 10)
    steps = []

    def run(original=module.run, **given):
        out = original(**{**kw, **given})
        steps.append(out["steps"] if launched else 0)
        for kernel in ("stats", "loss", "grads"):
            monkeypatch.setitem(fd.LAUNCHES, kernel, fd.LAUNCHES[kernel] + steps[-1])
        return out

    monkeypatch.setattr(module, "run", run)
    assert module.main(["--device", "cpu"]) == 0
    n = steps[0]
    assert n > 0 if launched else n == 0
    assert capsys.readouterr().out.splitlines()[-1] == (
        f"device: cpu; K1-K3 launches: stats {n}, loss {n}, grads {n}")
