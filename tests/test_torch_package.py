"""The PyTorch port stands alone: no JAX at import, no JAX package imports,
no silent CPU fallback, and a kernel build that fails loudly."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import gfedntm_tpu_torch
from gfedntm_tpu_torch import AVITM, FederatedTrainer
from gfedntm_tpu_torch.ops import _build
from gfedntm_tpu_torch.ops import fused_decoder as fd

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "gfedntm_tpu_torch"
#: The repository's JAX experiment scripts (``experiments_scripts/``) count
#: as the JAX package: the port has its own twins of them.
FORBIDDEN = {"jax", "flax", "optax", "orbax", "gfedntm_tpu", "experiments_scripts"}
#: Packages the port may import only inside the function that needs them:
#: the card's machine has neither scikit-learn nor NLTK's data.
LAZY = {"sklearn", "nltk", "pandas"}


def port_modules():
    """Every module of the port, packages (``__init__.py``) included."""
    return sorted(
        ".".join(("gfedntm_tpu_torch",) + p.relative_to(PORT).with_suffix("").parts
                 [:-1 if p.name == "__init__.py" else None])
        for p in PORT.rglob("*.py")
    )


def test_import_leaves_jax_out():
    """Importing every port module loads nothing of JAX, nor scikit-learn,
    NLTK or pandas."""
    code = (
        "import importlib, sys\n"
        f"for name in {port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN | LAZY)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"],
)
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse((REPO / path).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & FORBIDDEN, f"{path} imports {sorted(roots & FORBIDDEN)}"


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"],
)
def test_source_imports_no_optional_package_at_module_level(path):
    """scikit-learn, NLTK and pandas are imported, if at all, inside the
    function that needs them (``load_20newsgroups``, the parquet loaders,
    NLTK's stop words), never when a module is imported."""
    tree = ast.parse((REPO / path).read_text())
    functions = [n for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    inside = {id(n) for f in functions for n in ast.walk(f)}
    roots = set()
    for node in ast.walk(tree):
        if id(node) in inside:
            continue
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & LAZY, f"{path} imports {sorted(roots & LAZY)} at module level"


def test_port_modules_include_the_packages():
    names = port_modules()
    for name in ("gfedntm_tpu_torch", "gfedntm_tpu_torch.native",
                 "gfedntm_tpu_torch.data.vocab", "gfedntm_tpu_torch.federated.consensus",
                 "gfedntm_tpu_torch.eval.metrics", "gfedntm_tpu_torch.models.ctm",
                 "gfedntm_tpu_torch.federated.stepper", "gfedntm_tpu_torch.federated.aggregation",
                 "gfedntm_tpu_torch.data.embeddings", "gfedntm_tpu_torch.federation",
                 "gfedntm_tpu_torch.federation.client", "gfedntm_tpu_torch.federation.server",
                 "gfedntm_tpu_torch.federation.codec", "gfedntm_tpu_torch.federation.pacing",
                 "gfedntm_tpu_torch.federation.protos.federated_pb2",
                 "gfedntm_tpu_torch.utils.flightrec", "gfedntm_tpu_torch.utils.flops",
                 "gfedntm_tpu_torch.federation.sanitize",
                 "gfedntm_tpu_torch.federation.device_agg",
                 "gfedntm_tpu_torch.federation.simfleet",
                 "gfedntm_tpu_torch.federation.relay",
                 "gfedntm_tpu_torch.train.guardian",
                 "gfedntm_tpu_torch.cli", "gfedntm_tpu_torch.config",
                 "gfedntm_tpu_torch.presets", "gfedntm_tpu_torch.data.local_corpus",
                 "gfedntm_tpu_torch.__main__", "gfedntm_tpu_torch.scenarios",
                 "gfedntm_tpu_torch.scenarios.personas", "gfedntm_tpu_torch.scenarios.contracts",
                 "gfedntm_tpu_torch.scenarios.runner", "gfedntm_tpu_torch.experiments",
                 "gfedntm_tpu_torch.experiments.wmd", "gfedntm_tpu_torch.experiments.tm_wrapper",
                 "gfedntm_tpu_torch.experiments.collab", "gfedntm_tpu_torch.experiments.dss_tss",
                 "gfedntm_tpu_torch.federation.mesh_client", "gfedntm_tpu_torch.examples",
                 "gfedntm_tpu_torch.examples.bow_dataset_example",
                 "gfedntm_tpu_torch.examples.centralized_training",
                 "gfedntm_tpu_torch.examples.federated_simulation",
                 "gfedntm_tpu_torch.examples.hierarchical_training",
                 "gfedntm_tpu_torch.examples.realtext_federation",
                 "gfedntm_tpu_torch.experiments_scripts",
                 "gfedntm_tpu_torch.experiments_scripts.torch_baseline",
                 "gfedntm_tpu_torch.experiments_scripts.time_to_quality",
                 "gfedntm_tpu_torch.experiments_scripts.aggregate_banked_envelope",
                 "gfedntm_tpu_torch.experiments_scripts.run_dss_tss_envelope",
                 "gfedntm_tpu_torch.experiments_scripts.run_full_v100k",
                 "gfedntm_tpu_torch.experiments_scripts.run_presets_24",
                 "gfedntm_tpu_torch.experiments_scripts.run_realtext_federated",
                 "gfedntm_tpu_torch.experiments_scripts.analyze_trace"):
        assert name in names, name


def test_main_module_runs_where_jax_cannot_be_imported(tmp_path):
    """``python -m gfedntm_tpu_torch --help`` in a process where ``jax`` and
    ``gfedntm_tpu`` raise on import: the command line needs neither."""
    for name in ("jax", "gfedntm_tpu"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('{name} must not be imported')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), str(REPO)])
    proc = subprocess.run([sys.executable, "-m", "gfedntm_tpu_torch", "--help"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "usage: gfedntm-tpu-torch" in proc.stdout
    code = ("import sys, gfedntm_tpu_torch.cli, gfedntm_tpu_torch.presets, "
            "gfedntm_tpu_torch.data.local_corpus, gfedntm_tpu_torch.config\n"
            "sys.exit(1 if any(m.split('.')[0] in ('jax', 'gfedntm_tpu') for m in sys.modules)"
            " else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_lazy_package_exports():
    assert gfedntm_tpu_torch.AVITM is AVITM
    from gfedntm_tpu_torch.data.loaders import RawCorpus
    from gfedntm_tpu_torch.eval.metrics import npmi_coherence, topic_diversity
    from gfedntm_tpu_torch.federated.consensus import run_vocab_consensus
    assert gfedntm_tpu_torch.RawCorpus is RawCorpus
    assert gfedntm_tpu_torch.run_vocab_consensus is run_vocab_consensus
    assert gfedntm_tpu_torch.npmi_coherence is npmi_coherence
    assert gfedntm_tpu_torch.topic_diversity is topic_diversity
    from gfedntm_tpu_torch.data.embeddings import hashing_embedder
    from gfedntm_tpu_torch.federated.stepper import FederatedCTM
    from gfedntm_tpu_torch.models.ctm import CombinedTM, ZeroShotTM
    assert gfedntm_tpu_torch.CombinedTM is CombinedTM
    assert gfedntm_tpu_torch.ZeroShotTM is ZeroShotTM
    assert gfedntm_tpu_torch.FederatedCTM is FederatedCTM
    assert gfedntm_tpu_torch.hashing_embedder is hashing_embedder
    with pytest.raises(AttributeError):
        gfedntm_tpu_torch.no_such_name  # noqa: B018


def test_entry_points_refuse_cpu_without_being_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AVITM(input_size=20, n_components=3)
    template = AVITM(input_size=20, n_components=3, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FederatedTrainer(template, n_clients=2)
    FederatedTrainer(template, n_clients=2, device="cpu")
    from gfedntm_tpu_torch.federation.simfleet import make_sim_fleet
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_sim_fleet(2, pacing_policy="push:2")


def test_resolve_device_pins_full_float32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert gfedntm_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(ValueError):
        gfedntm_tpu_torch.resolve_device("meta")


def test_constructor_validation():
    with pytest.raises(ValueError, match="model must be"):
        AVITM(input_size=20, model_type="NMF", device="cpu")
    model = AVITM(input_size=20, compute_dtype="bfloat16", device="cpu")
    assert model.model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.model.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        AVITM(input_size=20, compute_dtype="float16", device="cpu")


def test_wrappers_refuse_other_devices():
    theta = torch.empty(4, 3, device="meta")
    beta = torch.empty(3, 10, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fd.stats(theta, beta, torch.empty(4, device="meta"),
                 torch.empty(10, device="meta"), torch.empty(10, device="meta"), True)


def test_bf16_storage_raises():
    """bf16 storage is accepted (the plain versions on the rounded beta and
    x); an unknown storage name raises, as ``_storage_jnp`` does."""
    theta = torch.softmax(torch.randn(4, 3), 1)
    beta = torch.randn(3, 10)
    rl, _, _ = fd.prodlda_recon_loss(theta, beta, torch.ones(4, 10), torch.zeros(10),
                                     torch.ones(10), storage_dtype="bfloat16")
    want, _, _ = fd.prodlda_recon_loss(theta, beta.to(torch.bfloat16).float(),
                                       torch.ones(4, 10), torch.zeros(10), torch.ones(10))
    assert torch.equal(rl, want)
    with pytest.raises(ValueError, match="storage_dtype"):
        fd.prodlda_recon_loss(theta, beta, torch.ones(4, 10), torch.zeros(10),
                              torch.ones(10), storage_dtype="float16")


def _fake_nvcc(tmp_path, body):
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\n" + body)
    script.chmod(0o755)
    return str(script)


def test_build_raises_with_nvcc_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "LIBRARY", tmp_path / "build" / "lib.so")
    fake = _fake_nvcc(tmp_path, "echo 'error: no sm_90a here' >&2\nexit 3\n")
    monkeypatch.setattr(_build, "nvcc", lambda: fake)
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build()
    assert not _build.LIBRARY.exists()
    assert list((tmp_path / "build").iterdir()) == []


def test_build_compiles_when_stale_and_skips_when_fresh(tmp_path, monkeypatch):
    lib = tmp_path / "build" / "lib.so"
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "LIBRARY", lib)
    # The fake compiler writes its -o target and logs each call.
    calls = tmp_path / "calls"
    fake = _fake_nvcc(
        tmp_path,
        f'echo call >> {calls}\nwhile [ "$1" != "-o" ]; do shift; done\n'
        'echo built > "$2"\necho "ptxas info: Used 1 registers"\n',
    )
    monkeypatch.setattr(_build, "nvcc", lambda: fake)
    assert _build.build() == lib
    assert lib.read_text() == "built\n" and "registers" in _build.build_log
    _build.build()
    assert calls.read_text().count("call") == 1
    os.utime(lib, (0, 0))  # older than the source: rebuild
    _build.build()
    assert calls.read_text().count("call") == 2


def test_nvcc_lookup_fails_clearly(tmp_path, monkeypatch):
    monkeypatch.setattr("shutil.which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
