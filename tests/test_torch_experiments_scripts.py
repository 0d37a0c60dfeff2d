"""The experiment scripts of the port (``gfedntm_tpu_torch.experiments_scripts``)
on the CPU, against the JAX scripts of ``experiments_scripts/`` (loaded by
path, neither edited nor run at their full sizes) and their committed
artifacts.

- ``time_to_quality``'s ladder, ``time_to``, headline and shipped-stack
  floor, run on the curves of the committed
  ``results/time_to_quality/metrics.json``, give its targets, its
  ``headline_speedup_at_95pct`` (amortized and cold) and its
  ``reference_shipped_stack_floor_s_at_95pct`` exactly.
- ``torch_baseline._LocalTorchAVITM`` against the JAX script's class from
  the same state dict at dropout 0, the noise from equally seeded
  generators: losses and beta within 1e-6 over 3 steps.
- ``aggregate_banked_envelope`` on a copy of ``results/dss_tss_eta001``:
  its columns and meta equal the JAX tool's on another copy, and the
  columns the committed ``results.json``'s; both refuse a wrong-regime
  digest.
- The port's time-to-quality arm at V=300, K=5, 2 nodes, 2 epochs against
  the JAX ``FederatedTrainer`` on the same corpus from bridged weights
  (``interop.py``): TSS per epoch within :data:`TTQ_ENVELOPE`. The two
  packages' noise and dropout come from different generators.
- ``time_to_quality.run``'s artifact has the committed artifact's keys (and
  those of its nested sections), plus the port's fields.
- ``run_full_v100k.run_case`` and ``run_presets_24`` at a tiny V against
  the JAX functions: the JAX keys (``resolved_tile_v`` replaced by the
  launches and the route) and TSS within an envelope.
- ``run_dss_tss_envelope`` and ``run_realtext_federated`` at tiny sizes:
  their artifacts' keys; ``analyze_trace`` on a synthetic and a real trace.
- Every training script's ``main`` raises without CUDA unless ``--device
  cpu`` is given; one ``main`` runs in a process where ``jax``,
  ``gfedntm_tpu`` and the repository's ``experiments_scripts`` raise on
  import.

Envelopes, each about twice the largest |port - JAX| measured over seeds
0-4 (presets 0-3) on the CPU, are stated beside their constants.
"""

import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gfedntm_tpu_torch import interop
from gfedntm_tpu_torch.data.datasets import BowDataset
from gfedntm_tpu_torch.experiments_scripts import (
    aggregate_banked_envelope,
    analyze_trace,
    headline_speedup,
    ladder,
    run_dss_tss_envelope,
    run_full_v100k,
    run_presets_24,
    run_realtext_federated,
    shipped_floor_s,
    time_to,
    time_to_quality,
    torch_baseline,
    tss_of,
)

REPO = Path(__file__).resolve().parents[1]
TTQ_ARTIFACT = REPO / "results" / "time_to_quality" / "metrics.json"
ENVELOPE_DIR = REPO / "results" / "dss_tss_eta001"
#: The digest under ``results/dss_tss_eta001/iters`` whose checkpoints
#: aggregate to the committed columns; the other one is a frozen=5 regime.
DIGEST, WRONG_DIGEST = "02fff7f8622d", "c64144fc5c6f"

#: TSS (of at most K=5) per epoch, port arm vs the JAX trainer from bridged
#: weights at V=300, 2 nodes, 2 epochs: measured 6e-4.
TTQ_ENVELOPE = 0.002
#: ``run_case`` at V=300, 64 docs/node, 2 epochs: TSS (of at most 50)
#: measured 0.015; the final mean loss, relative, 1.6%.
CASE_TSS_ENVELOPE, CASE_LOSS_ENVELOPE = 0.03, 0.04
#: Presets 2 and 4 at scale 0.05: TSS (of at most 10) measured 0.033,
#: top-10 diversity 0.08.
PRESET_TSS_ENVELOPE, PRESET_DIVERSITY_ENVELOPE = 0.07, 0.16
#: The port artifact's fields beyond the JAX artifact's.
PORT_TTQ_KEYS = {"device", "torch_impl", "ms_per_global_step", "global_steps",
                 "client_steps", "k1_k3_launches", "warm_fit"}
TRAINING_SCRIPTS = ("torch_baseline", "time_to_quality", "run_dss_tss_envelope",
                    "run_full_v100k", "run_presets_24", "run_realtext_federated")


def load_jax_script(name: str):
    """A script of the repository's ``experiments_scripts/``, by path."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  REPO / "experiments_scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---- time_to_quality: the ladder on the committed curves -----------------------------

def test_ladder_reproduces_the_committed_targets_and_headline():
    art = json.loads(TTQ_ARTIFACT.read_text())
    curves = {
        "torch_federated_s": art["torch_federated_curve"],
        "torch_centralized_s": art["torch_curve"],
        "gfedntm_tpu_s": art["gfedntm_curve"],
        **{f"gfedntm_tpu_local_steps_{k}_s": c
           for k, c in art["gfedntm_local_steps_curves"].items()},
    }
    plateau = min(art["torch_federated_curve"][-1]["tss"], art["gfedntm_curve"][-1]["tss"])
    assert plateau == art["joint_plateau_tss"]
    targets = ladder(art["baseline_tss_random"], plateau, curves)
    assert targets == art["targets"]
    assert headline_speedup(targets) == art["headline_speedup_at_95pct"]
    cold = art["cold_start"]
    assert headline_speedup(targets, port_s=cold["gfedntm_cold_s_at_95pct"]) == \
        cold["headline_speedup_at_95pct_cold"]
    regime = art["regime"]
    total_steps = regime["epochs"] * -(-regime["docs_per_node"] // 64)
    assert shipped_floor_s(targets["95pct"]["torch_federated_s"], art["torch_federated_curve"],
                           total_steps, regime["n_nodes"]) == \
        art["reference_shipped_stack_floor_s_at_95pct"]
    assert time_to(art["gfedntm_curve"], 1e9) is None
    assert time_to(art["gfedntm_curve"], 0.0) == art["gfedntm_curve"][0]["wall_s"]


# ---- torch_baseline: the plain PyTorch model -----------------------------------------

def jax_scripts_state(model) -> dict:
    """The JAX script's ``_LocalTorchAVITM`` as one state dict, keyed as the
    port's ``model`` keys it."""
    state = {}
    for name in ("encoder", "f_mu", "f_mu_bn", "f_sigma", "f_sigma_bn", "beta_bn"):
        state.update({f"{name}.{k}": v for k, v in getattr(model, name).state_dict().items()})
    for name in ("beta", "prior_mean", "prior_var"):
        state[name] = getattr(model, name).detach()
    return state


def test_local_avitm_steps_as_the_jax_scripts_class():
    """From the same state at dropout 0, with the JAX class's global draws
    and the port's generator seeded alike, three Adam steps give the same
    losses and beta (within 1e-6)."""
    before = set(sys.modules)
    script = load_jax_script("torch_baseline")
    assert not {m for m in set(sys.modules) - before if m.split(".")[0] in ("jax", "gfedntm_tpu")}
    torch.manual_seed(11)
    theirs = script._LocalTorchAVITM(60, 5, hidden_sizes=(16, 16), dropout=0.0)
    ours = torch_baseline._LocalTorchAVITM(60, 5, hidden_sizes=(16, 16), dropout=0.0,
                                           device="cpu", seed=3)
    ours.model.load_state_dict(jax_scripts_state(theirs))
    x = torch.as_tensor(np.random.default_rng(0).poisson(0.5, (3, 32, 60)), dtype=torch.float32)
    torch.manual_seed(5)
    ours.generator.manual_seed(5)
    for step in range(3):
        theirs.optimizer.zero_grad()
        want = theirs._loss(x[step])
        want.backward()
        theirs.optimizer.step()
        got = ours.step(x[step])
        want = float(want.detach())
        assert abs(float(got) - want) <= 1e-6 * max(1.0, abs(want)), step
    assert torch.allclose(ours.beta, theirs.beta, rtol=0, atol=1e-6)
    # The port's epoch loop over device-side shuffled batches.
    loader = torch_baseline.Batches(x.reshape(-1, 60), 32, ours.generator)
    first, second = (torch.cat(list(loader)) for _ in range(2))
    assert [len(b) for b in loader] == [32, 32, 32] and not torch.equal(first, second)
    assert torch.equal(first.sum(0), x.reshape(-1, 60).sum(0))
    assert np.isfinite(ours._train_epoch(loader)[1])


# ---- aggregate_banked_envelope -----------------------------------------------------

def envelope_copy(tmp_path, name: str, newest: str) -> Path:
    """A copy of ``results/dss_tss_eta001`` whose digest ``newest`` is the
    most recently modified."""
    dst = tmp_path / name
    shutil.copytree(ENVELOPE_DIR, dst)
    for i, digest in enumerate(sorted(p.name for p in (dst / "iters").iterdir())):
        os.utime(dst / "iters" / digest, (1e9 + i, 1e9 + i))
    os.utime(dst / "iters" / newest, (2e9, 2e9))
    return dst


def test_aggregate_reproduces_the_committed_columns_and_the_jax_tool(tmp_path):
    committed = json.loads((ENVELOPE_DIR / "results.json").read_text())
    ours = aggregate_banked_envelope.aggregate(str(envelope_copy(tmp_path, "port", DIGEST)))
    theirs = load_jax_script("aggregate_banked_envelope").aggregate(
        str(envelope_copy(tmp_path, "jax", DIGEST)))
    assert ours["columns"] == committed["columns"] == theirs["columns"]
    assert ours["meta"] == theirs["meta"] and ours["index"] == committed["index"]
    assert json.loads((tmp_path / "port" / "results.json").read_text()) == ours
    # The other digest holds another regime: both tools refuse it.
    for tool, name in ((aggregate_banked_envelope, "port2"),
                       (load_jax_script("aggregate_banked_envelope"), "jax2")):
        with pytest.raises(SystemExit, match="regime mismatch on frozen_topics"):
            tool.aggregate(str(envelope_copy(tmp_path, name, WRONG_DIGEST)))
    assert aggregate_banked_envelope.main([str(envelope_copy(tmp_path, "main", DIGEST))]) == 0


# ---- time_to_quality: the port's arm and the artifact ------------------------------

def test_port_arm_tracks_the_jax_trainer_from_bridged_weights():
    from gfedntm_tpu.data.datasets import BowDataset as JaxBowDataset
    from gfedntm_tpu.federated.trainer import FederatedTrainer as JaxTrainer
    from gfedntm_tpu.models.avitm import AVITM as JaxAVITM

    V, K, nodes, docs, epochs = 300, 5, 2, 100, 2
    corpus = time_to_quality.make_corpus(V, K, docs, nodes, frozen=2, seed=0)
    i2t = {i: f"wd{i}" for i in range(V)}
    template = JaxAVITM(input_size=V, n_components=K, hidden_sizes=time_to_quality.HIDDEN,
                        batch_size=64, num_epochs=epochs, lr=2e-3, momentum=0.99, seed=0)
    init = interop.state_dict_from_flax(jax.tree.map(np.asarray, template.params),
                                        jax.tree.map(np.asarray, template.batch_stats))
    snaps = []
    JaxTrainer(template, n_clients=nodes).fit(
        [JaxBowDataset(X=n.bow, idx2token=i2t) for n in corpus.nodes],
        checkpoint_every=-(-docs // 64),
        segment_callback=lambda step, p, b: snaps.append(np.asarray(p["beta"][0])))
    arm = time_to_quality.port_arm([BowDataset(X=n.bow, idx2token=i2t) for n in corpus.nodes],
                                   K, epochs, 0, torch.device("cpu"), init_state=init)
    theirs = [tss_of(b, corpus.topic_vectors, i2t) for b in snaps]
    ours = [tss_of(b, corpus.topic_vectors, i2t) for _, b in arm["snaps"]]
    assert len(ours) == len(theirs) == epochs
    assert np.abs(np.array(ours) - np.array(theirs)).max() <= TTQ_ENVELOPE
    assert arm["steps"] == epochs * -(-docs // 64) and arm["client_steps"] == nodes * arm["steps"]
    assert arm["warm_client_steps"] == nodes * -(-docs // 64)
    assert np.isfinite(arm["losses"]).all()


def nested_keys(a: dict, b: dict, path: str = "") -> list:
    """Paths where the nested dicts ``a`` and ``b`` have other keys."""
    out = [] if set(a) == set(b) else [f"{path}: {sorted(set(a) ^ set(b))}"]
    for key in set(a) & set(b):
        if isinstance(a[key], dict) and isinstance(b[key], dict):
            out += nested_keys(a[key], b[key], f"{path}/{key}")
    return out


def test_time_to_quality_artifact_has_the_committed_keys(tmp_path):
    committed = json.loads(TTQ_ARTIFACT.read_text())
    path = tmp_path / "ttq.json"
    out = time_to_quality.run(out_path=str(path), epochs=2, vocab=300, k=5, docs_per_node=100,
                              n_nodes=2, frozen=2, coldproc=True, device="cpu")
    assert json.loads(path.read_text()) == out
    assert set(out) == set(committed) | PORT_TTQ_KEYS
    assert nested_keys({k: v for k, v in out.items() if k not in PORT_TTQ_KEYS},
                       committed) == []
    assert out["backend"] == "cpu" and out["device"] == {"name": "cpu", "power_limit": None}
    arms = ["torch_centralized", "torch_federated", "gfedntm_tpu_federated",
            "gfedntm_tpu_local_steps_E_1epoch", "gfedntm_tpu_local_steps_E_5epoch"]
    assert list(out["ms_per_global_step"]) == arms and list(out["k1_k3_launches"]) == arms
    assert out["torch_impl"]["matmul_allow_tf32"] is False
    # On the CPU the wrappers take the plain versions: no launch anywhere.
    assert all(not any(n.values()) for n in out["k1_k3_launches"].values())
    assert out["client_steps"]["gfedntm_tpu_federated"] == 2 * 2 * 2
    assert out["local_steps_fix"]["arms"] == {
        "E_1epoch": {"E": 2, "final_tss": out["gfedntm_local_steps_curves"]["E_1epoch"][-1]["tss"]},
        "E_5epoch": {"E": 10, "final_tss": out["gfedntm_local_steps_curves"]["E_5epoch"][-1]["tss"]},
    }
    assert out["cold_start"]["cold_process_warm_cache"]["backend"] == "cpu"
    assert all(len(c) == 2 for c in (out["torch_curve"], out["torch_federated_curve"],
                                     out["gfedntm_curve"]))


# ---- run_full_v100k and run_presets_24 against the JAX functions --------------------

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_run_case_keys_and_tss_against_the_jax_case(monkeypatch, compute_dtype):
    script = load_jax_script("run_full_v100k")
    monkeypatch.setattr(script, "EPOCHS", 2)
    theirs = script.run_case(300, 64, compute_dtype)
    ours = run_full_v100k.run_case(300, 64, compute_dtype, epochs=2, device="cpu")
    assert set(ours) == (set(theirs) - {"resolved_tile_v"}) | {
        "launches", "warm_launches", "client_steps", "kernel_route"}
    for key in ("vocab", "docs_per_node", "compute_dtype", "global_steps", "tss_max",
                "tss_random_floor", "staged_corpus_gb"):
        assert ours[key] == theirs[key], key
    assert abs(ours["tss_vs_ground_truth"] - theirs["tss_vs_ground_truth"]) <= CASE_TSS_ENVELOPE
    assert abs(ours["final_mean_loss"] / theirs["final_mean_loss"] - 1) <= CASE_LOSS_ENVELOPE
    assert ours["client_steps"] == 5 * ours["global_steps"]
    assert set(ours["launches"]) == set(run_full_v100k.storage_kernels(compute_dtype))
    assert ours["kernel_route"] == dict.fromkeys(("stats", "loss", "grads"),
                                                 "plain PyTorch (CPU tensors)")


def test_presets_24_keys_and_quality_against_the_jax_presets(monkeypatch, tmp_path):
    import gfedntm_tpu.presets as jax_presets

    scale = 0.05
    for name in ("neurallda_2client_iid", "combinedtm_5client"):
        original = getattr(jax_presets, name)
        monkeypatch.setattr(jax_presets, name,
                            lambda scale, _f=original: _f(scale=0.05))
    theirs = load_jax_script("run_presets_24").main(str(tmp_path / "jax.json"))
    ours = run_presets_24.run(str(tmp_path / "port.json"), scale=scale, device="cpu")
    assert set(ours["configs"]) == set(theirs["configs"])
    for name, want in theirs["configs"].items():
        got = ours["configs"][name]
        assert set(got) == set(want) | {"launches", "client_steps"}, name
        assert got["summary"] == {**want["summary"], "final_mean_loss":
                                  got["summary"]["final_mean_loss"]}, name
        assert abs(got["tss_vs_ground_truth"] - want["tss_vs_ground_truth"]) \
            <= PRESET_TSS_ENVELOPE, name
        assert abs(got["topic_diversity"] - want["topic_diversity"]) \
            <= PRESET_DIVERSITY_ENVELOPE, name
        assert got["tss_random_floor"] == want["tss_random_floor"]
    assert set(ours) == set(theirs) | {"device", "scale"} and ours["backend"] == "cpu"


# ---- the other scripts ---------------------------------------------------------------

def test_dss_tss_envelope_writes_both_sweeps(tmp_path):
    committed = json.loads((ENVELOPE_DIR / "results.json").read_text())
    out = run_dss_tss_envelope.run(
        1, 1, str(tmp_path / "eta"), str(tmp_path / "frozen"), device="cpu",
        vocab_size=120, n_topics=4, n_docs=40, n_docs_global_inf=8, n_nodes=2,
        frozen_topics=2, nwords=(20, 30), frozen_topics_list=(2, 1), eta_list=(0.05,),
        hidden_sizes=(16, 16), num_epochs=2, batch_size=8)
    for sweep, index in (("eta", [0.05]), ("frozen", [2, 1])):
        saved = json.loads((tmp_path / sweep / "results.json").read_text())
        assert saved["index"] == index and out[sweep]["index"] == index
        assert set(saved) == set(committed)
        assert set(saved["columns"]) == set(committed["columns"])
        assert saved["meta"]["backend"] == "cpu"


def test_realtext_script_on_a_small_site_tree(tmp_path, monkeypatch):
    import sysconfig

    from gfedntm_tpu_torch.data.local_corpus import DEFAULT_CLIENT_GROUPS

    rng = np.random.default_rng(0)
    for pkgs in DEFAULT_CLIENT_GROUPS.values():
        words = ["".join(rng.choice(list("bcdfghjklmnpqrstvwxz"), 7)) for _ in range(40)]
        (tmp_path / "site" / pkgs[0]).mkdir(parents=True)
        for i in range(210):
            (tmp_path / "site" / pkgs[0] / f"m{i}.py").write_text(
                f'"""{" ".join(rng.choice(words, 60))}"""\n')
    paths = sysconfig.get_paths
    monkeypatch.setattr(sysconfig, "get_paths",
                        lambda *a, **k: {**paths(*a, **k), "purelib": str(tmp_path / "site")})
    out = run_realtext_federated.run(str(tmp_path / "rt.json"), scale=0.01, epochs=1,
                                     arms="1,4", device="cpu")
    assert set(out["arms"]) == {"federated_parity", "federated_local_steps_E4", "centralized"}
    assert len(out["corpus"]["clients"]) == 5 and out["corpus"]["consensus_vocab"] > 0
    assert out["corpus"]["extraction_totals"]["site_packages"] == str(tmp_path / "site")
    for arm in out["arms"].values():
        assert all(np.isfinite(arm[k]) for k in ("npmi", "topic_diversity", "inverted_rbo"))
        assert not any(arm["launches"].values())
    assert json.loads((tmp_path / "rt.json").read_text()) == out


def test_analyze_trace_splits_device_streams_from_host_threads(tmp_path):
    events = [
        {"ph": "M", "name": "process_name", "pid": 7, "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 7, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 7, "ts": 10,
         "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "stats_kernel", "pid": 0, "ts": 20, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "loss_kernel", "pid": 0, "ts": 40, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0, "ts": 150, "dur": 50},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "step", "pid": 0, "ts": 20, "dur": 40},
    ]
    path = tmp_path / "run" / "trace.1.pt.trace.json"
    path.parent.mkdir()
    path.write_text(json.dumps({"traceEvents": events}))
    out = analyze_trace.summarize(str(tmp_path), top_n=2)
    assert out["wall_span_ms"] == 0.2 and out["device_busy_ms"] == 0.09
    assert out["device_busy_share"] == 0.45
    assert out["device"]["total_ms"] == 0.1 and out["host"]["total_ms"] == 0.105
    assert [t["name"] for t in out["device"]["top"]] == ["Memcpy HtoD", "stats_kernel"]
    assert out["processes"] == ["GPU 0", "python"]
    # A real (CPU-only) profiler trace, through the port's trace() block.
    from gfedntm_tpu_torch.utils.observability import trace

    with trace(str(tmp_path / "real"), torch.device("cpu")):
        (torch.randn(64, 64) @ torch.randn(64, 64)).sum()
    real = analyze_trace.summarize(str(tmp_path / "real"))
    assert real["host"]["total_ms"] > 0 and real["device_busy_ms"] == 0.0
    assert analyze_trace.main([]) == 2


# ---- the mains ------------------------------------------------------------------------

@pytest.mark.parametrize("name", TRAINING_SCRIPTS)
def test_main_refuses_a_missing_card_unless_told_the_cpu(name, monkeypatch):
    module = importlib.import_module(f"gfedntm_tpu_torch.experiments_scripts.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main([])
    calls = []
    monkeypatch.setattr(module, "run", lambda *a, **k: calls.append(k.get("device")) or {})
    assert module.main(["--device", "cpu"]) == 0 and calls == ["cpu"]


@pytest.mark.parametrize("line,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W",
     {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}),
    ("nvidia-smi failed: no devices", {"name": "torch's name", "power_limit": "not read"}),
])
def test_card_splits_the_card_line(monkeypatch, line, want):
    """``card`` reads the line of the card it runs on, and falls back on
    torch's name where nvidia-smi gave none; the CPU asks nothing."""
    from gfedntm_tpu_torch import device
    from gfedntm_tpu_torch.experiments_scripts import card

    asked = []
    monkeypatch.setattr(device, "card_line", lambda index=None: asked.append(index) or line)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda index=None: "torch's name")
    assert card("cuda:1") == want and asked == [1]
    assert card("cpu") == {"name": "cpu", "power_limit": None} and asked == [1]


def test_card_line_asks_nvidia_smi(monkeypatch):
    from gfedntm_tpu_torch import device

    seen = []

    def run(cmd, **kw):
        seen.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n",
                                           stderr="")

    monkeypatch.setattr(device.subprocess, "run", run)
    assert device.card_line(2) == device.card_line() == "NVIDIA H100 80GB HBM3, 700.00 W"
    query = ["--query-gpu=name,power.limit", "--format=csv,noheader"]
    assert seen == [["nvidia-smi", "--id=2", *query], ["nvidia-smi", *query]]

    def missing(cmd, **kw):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(device.subprocess, "run", missing)
    assert device.card_line() == "nvidia-smi failed: nvidia-smi"


def test_a_main_runs_where_jax_and_the_jax_scripts_cannot_be_imported(tmp_path):
    """In a process where ``jax``, ``gfedntm_tpu`` and the repository's
    ``experiments_scripts`` raise on import: every module imports, and
    ``time_to_quality``'s cold-process ``main`` runs a fit on the CPU."""
    for name in ("jax", "gfedntm_tpu", "experiments_scripts"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('{name} must not be imported')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), str(REPO)])
    regime = json.dumps(dict(vocab=200, k=4, docs_per_node=64, n_nodes=2, frozen=2, seed=0))
    code = ("import importlib, pkgutil, sys\n"
            "import gfedntm_tpu_torch.experiments_scripts as p\n"
            "for m in pkgutil.iter_modules(p.__path__):\n"
            "    importlib.import_module(f'{p.__name__}.{m.name}')\n"
            "from gfedntm_tpu_torch.experiments_scripts import time_to_quality\n"
            "assert time_to_quality.main(['--device', 'cpu', '--coldproc-measure',\n"
            f"                              '--regime', {regime!r}]) == 0\n"
            "sys.exit(1 if any(m.split('.')[0] in ('jax', 'gfedntm_tpu', 'experiments_scripts')"
            " for m in sys.modules) else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("COLDPROC "))
    assert json.loads(line[len("COLDPROC "):])["backend"] == "cpu"
