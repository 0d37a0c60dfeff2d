"""The port's configuration layer and command line on the CPU, against the
JAX package's.

- ``config.py``: the default config and ``from_ini`` on INI files of the
  reference's ``dft_params.cf`` layout give equal dataclasses in both
  packages; ``_coerce`` agrees on every case; the source is the original's
  but for its docstring; the share lists are ``models/params``'.
- The parser: for ``[]`` and every argv the JAX tests pass to
  ``build_parser``, the port's namespace is the JAX one plus ``device``;
  every JAX flag has the same name, choices and default; ``load_config``
  and ``model_kwargs_from_config`` give equal results.
- The readers (``summarize``, ``report``, ``trace``, ``slo``, ``privacy``,
  ``incident``) print byte for byte what the JAX CLI's print, write the
  same ``--json`` / ``-o`` / ``--trace_out`` bytes and return the same exit
  codes, on the streams and bundles of a port federation run from the
  command line and on those the JAX tests build; their sources, and the
  observability functions they call, are the originals' but for imports.
- ``simulate`` on ``tests/test_cli.py``'s tiny archive: exit 0, the JAX
  CLI's ``n_clients`` and ``vocab_size``, ``tss`` in (0, K], and a
  ``global_model.npz`` whose betas are bitwise those of an in-process
  ``FederatedTrainer.fit`` built with the same kwargs.
- Processes: a port-only federation of three ``python -m
  gfedntm_tpu_torch`` processes (each limited to 120 s) exits 0, writes
  ``server_model.npz`` and leaves the clients' shared state bitwise equal;
  a port client joins a JAX ``python main.py --id 0`` server.
- Refusals: without CUDA and without ``--device cpu`` every role exits
  nonzero with a message, ``scenarios`` too. (``--mesh_devices`` above 1
  runs: ``tests/test_torch_client_mesh.py``.)

No tolerance is involved: every comparison here is equality.
"""

import ast
import contextlib
import dataclasses
import functools
import io
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gfedntm_tpu import cli as jcli
from gfedntm_tpu import config as jconfig
from gfedntm_tpu.data.synthetic import generate_synthetic_corpus
from gfedntm_tpu.utils.observability import validate_record
from gfedntm_tpu_torch import cli, config
from gfedntm_tpu_torch.models import params
from gfedntm_tpu_torch.utils import observability as tobs

import test_forensics as jforensics
import test_observability as jobservability
import test_privacy as jprivacy
import test_quality_plane as jquality
import test_slo as jslo
import test_trace_plane as jtrace

REPO = Path(__file__).resolve().parents[1]
PROCESS_LIMIT_S = 120


def _strip(tree):
    """Docstrings out of every module, class and function."""
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return tree


@functools.cache
def _defs(path: str, package: str) -> dict:
    text = (REPO / path).read_text().replace(f"{package}.", "gfedntm_tpu.")
    return {getattr(n, "name", None): ast.dump(n) for n in _strip(ast.parse(text)).body}


# ---- config -------------------------------------------------------------------------

def test_config_copy_is_the_original():
    got = ast.dump(_strip(ast.parse((REPO / "gfedntm_tpu_torch/config.py").read_text())))
    want = ast.dump(_strip(ast.parse((REPO / "gfedntm_tpu/config.py").read_text())))
    assert got == want


def test_default_config_is_the_jax_config():
    assert dataclasses.asdict(config.GfedConfig()) == dataclasses.asdict(jconfig.GfedConfig())
    assert config.SHARE_ALL == params.SHARE_ALL == jconfig.SHARE_ALL
    assert config.SHARE_MINIMAL == params.SHARE_MINIMAL == jconfig.SHARE_MINIMAL


#: The reference's 22-key ``grads_to_share`` (``dft_params.cf:50``): the whole
#: CombinedTM state dict.
GRADS_22 = ", ".join([
    "prior_mean", "prior_variance", "beta",
    "inf_net.input_layer.weight", "inf_net.input_layer.bias",
    "inf_net.hiddens.l_0.0.weight", "inf_net.hiddens.l_0.0.bias",
    "inf_net.f_mu.weight", "inf_net.f_mu.bias",
    "inf_net.f_mu_batchnorm.running_mean", "inf_net.f_mu_batchnorm.running_var",
    "inf_net.f_mu_batchnorm.num_batches_tracked",
    "inf_net.f_sigma.weight", "inf_net.f_sigma.bias",
    "inf_net.f_sigma_batchnorm.running_mean", "inf_net.f_sigma_batchnorm.running_var",
    "inf_net.f_sigma_batchnorm.num_batches_tracked",
    "beta_batchnorm.running_mean", "beta_batchnorm.running_var",
    "beta_batchnorm.num_batches_tracked",
    "inf_net.adapt_bert.weight", "inf_net.adapt_bert.bias",
])

#: The layout of the reference's ``config/dft_params.cf`` (sections
#: ``[addresses]``, ``[ntms]``, ``[grpc]``, ``[federation]``, ``[save_dir]``),
#: with its defaults; the file itself is not in this repository.
DFT_PARAMS = f"""\
[addresses]
server_address = localhost
base_port = 50051

[ntms]
n_components = 50
model_type = prodLDA
ctm_model_type = CombinedTM
hidden_sizes = (50,50)
activation = softplus
dropout = 0.2
learn_priors = True
batch_size = 64
lr = 2e-3
momentum = 0.99
solver = adam
num_epochs = 100
reduce_on_plateau = False
topic_prior_mean = 0.0
topic_prior_variance =
num_samples = 20
num_data_loader_workers = 0
label_size = 0
loss_weights =
contextual_size = 768
thetas_thr = 3e-3
max_features = 2000

[grpc]
max_send_message_length = 250
max_receive_message_length = 250
keepalive_time_ms = 10000
keepalive_permit_without_calls = True

[federation]
time_termination = 604800
client_sleep_time = 604800
grads_to_share = {GRADS_22}

[save_dir]
save_dir = output
"""

INI_CASES = {
    "dft_params": DFT_PARAMS,
    "overrides": """\
[ntms]
n_components = 7
hidden_sizes = (100, 100)
batch_size = 256
num_epochs = 2
dropout = 0.0
topic_prior_variance = 0.5
solver = rmsprop
seed = 3
compute_dtype = bfloat16

[data]
max_features = 100000
stop_words = english
val_fraction = 0.1

[federation]
grads_to_share = prior_mean, prior_variance, beta
max_iters = 8
n_clients = 2
""",
    "empty": "[ntms]\n",
}


@pytest.mark.parametrize("name", sorted(INI_CASES))
def test_from_ini_is_the_jax_from_ini(tmp_path, name):
    path = tmp_path / f"{name}.cf"
    path.write_text(INI_CASES[name])
    got, want = config.from_ini(str(path)), jconfig.from_ini(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if name == "dft_params":
        assert len(got.federation.grads_to_share) == 22
        assert got.model.hidden_sizes == (50, 50) and got.model.topic_prior_variance is None


@pytest.mark.parametrize("value", [
    "", "   ", "3", " -12 ", "2e-3", "0.99", "1e5", "True", "false", "TRUE", "(50,50)",
    "(100, 100)", "(7,)", "()", "None", "prodLDA", "a, b", "1.5.2", "inf", "nan",
])
def test_coerce_is_the_jax_coerce(value):
    got, want = config._coerce(value), jconfig._coerce(value)
    assert type(got) is type(want)
    assert got == want or (got != got and want != want)


def test_coerce_raises_as_the_jax_one():
    for value in ("(a, b)", "(1.5, 2)"):
        with pytest.raises(ValueError):
            jconfig._coerce(value)
        with pytest.raises(ValueError):
            config._coerce(value)


# ---- the parser ----------------------------------------------------------------------

#: ``[]`` and every argv the JAX tests pass to ``build_parser``.
ARGVS = [
    [],
    ["--id", "0"],
    ["--id", "3", "--source", "x.parquet", "--data_type", "real", "--fos", "cs"],
    ["--num_epochs", "3", "--n_components", "7", "--batch_size", "16"],
    ["--num_epochs", "1", "--n_components", "3", "--batch_size", "8"],
    ["--reconnect_window", "0", "--journal_every", "5", "--no_autorecover", "--chaos", "[]"],
    ["--robust_aggregator", "trimmed_mean:0.25", "--max_update_norm", "50",
     "--outlier_mad_k", "0", "--divergence_patience", "2"],
    ["--resume", "--checkpoint_every", "5", "--quorum_fraction", "0.8",
     "--probation_rounds", "2", "--liveness_timeout", "60"],
    ["--dp", "server", "--dp_clip", "0.5", "--dp_sigma", "2.0", "--dp_budget", "3.0",
     "--dp_seed", "4"],
    ["--quality_every", "5", "--quality_ref", "ref.txt", "--quality_topn", "8",
     "--quality_guard"],
    ["--serve_max_queue", "256"],
    ["--role", "serve", "--save_dir", "out", "--serve_max_batch", "32", "--serve_poll", "0.5",
     "--serve_duration", "3", "--no_quality_gate"],
    ["--role", "serve"],
    ["--id", "0", "--save_dir", "out", "--chaos", '[{"method": "TranStep", "kind": "drop"}]'],
    ["--role", "client", "--id", "1", "--mesh_devices", "8"],
    ["--role", "server", "--id", "0"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a)[:48] or "[]")
def test_namespace_is_the_jax_namespace_plus_device(argv):
    got = vars(cli.build_parser().parse_args(argv))
    want = vars(jcli.build_parser().parse_args(argv))
    assert got.pop("device") is None
    assert got == want
    got_dev = vars(cli.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert got_dev.pop("device") == "cpu" and got_dev == want


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.nargs,
                     a.const, type(a).__name__)
            for a in parser._actions}


def test_every_jax_flag_is_the_ports():
    got, want = _options(cli.build_parser()), _options(jcli.build_parser())
    assert len(want) == 71 and set(got) == set(want) | {"device"}
    for dest, spec in want.items():
        assert got[dest] == spec, dest
    assert got["device"][:2] == (("--device",), None)


@pytest.mark.parametrize("argv", ARGVS[:5])
@pytest.mark.parametrize("ini", [None, "dft_params", "overrides"])
@pytest.mark.parametrize("family", ["avitm", "ctm"])
def test_load_config_and_model_kwargs_are_the_jax_ones(tmp_path, argv, ini, family):
    if ini is not None:
        path = tmp_path / "cfg.cf"
        path.write_text(INI_CASES[ini])
        argv = argv + ["--config", str(path)]
    got = cli.load_config(cli.build_parser().parse_args(argv))
    want = jcli.load_config(jcli.build_parser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert cli.model_kwargs_from_config(got, family) == jcli.model_kwargs_from_config(want, family)


CLI_COPIES = ("load_config", "model_kwargs_from_config", "_load_corpora", "_slo_specs_from_args",
              "_read_node_records", "run_summarize", "run_report", "_node_name_for",
              "run_trace", "run_slo", "run_privacy", "_collect_bundle_paths",
              "_implicated_clients", "_format_ring_record", "run_incident")
OBSERVABILITY_COPIES = ("_agg", "collect_wire_tiers", "format_wire_tiers", "summarize_metrics",
                        "_fmt_s", "_fmt_bytes", "format_report", "check_monotone_coherence",
                        "_fmt_opt", "format_quality_report", "format_privacy_line",
                        "_serve_offset_samples", "estimate_clock_offset",
                        "merge_chrome_trace")


@pytest.mark.parametrize("name", CLI_COPIES)
def test_cli_readers_are_the_originals(name):
    got = _defs("gfedntm_tpu_torch/cli.py", "gfedntm_tpu_torch")
    want = _defs("gfedntm_tpu/cli.py", "gfedntm_tpu")
    assert got[name] == want[name]


@pytest.mark.parametrize("name", OBSERVABILITY_COPIES)
def test_observability_readers_are_the_originals(name):
    got = _defs("gfedntm_tpu_torch/utils/observability.py", "gfedntm_tpu_torch")
    want = _defs("gfedntm_tpu/utils/observability.py", "gfedntm_tpu")
    assert got[name] == want[name]


# ---- refusals --------------------------------------------------------------------------

ROLE_ARGVS = {
    "server": ["--id", "0"],
    "client": ["--id", "1", "--source", "x.npz"],
    "relay": ["--role", "relay", "--id", "1"],
    "serve": ["--role", "serve"],
    "simulate": ["--source", "x.npz"],
}


@pytest.mark.parametrize("role", sorted(ROLE_ARGVS))
def test_every_role_refuses_the_cpu_without_being_asked(tmp_path, monkeypatch, role):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as err:
        cli.main(ROLE_ARGVS[role] + ["--save_dir", str(tmp_path)])
    assert isinstance(err.value.code, str) and "CUDA is not available" in err.value.code


def test_a_role_process_exits_nonzero_without_cuda(tmp_path):
    env = {**_env(), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "gfedntm_tpu_torch", "--id", "0",
                           "--save_dir", str(tmp_path)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=PROCESS_LIMIT_S)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_scenarios_is_refused_with_code_2(capsys, monkeypatch):
    """The ported subcommand refuses a flag it does not know with code 2,
    as argparse does, and a host without CUDA without ``--device cpu``
    with the message every role prints."""
    with pytest.raises(SystemExit) as err:
        cli.main(["scenarios", "--fast", "--no-such-flag"])
    assert err.value.code == 2
    assert "--no-such-flag" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli.main(["scenarios", "--fast", "--cells", "iid-sync-fedavg"])


def test_a_bad_chaos_spec_is_a_usage_error(tmp_path):
    """``tests/test_scenarios.py``'s case: a typo'd ``--chaos`` exits at
    start-up naming the flag."""
    args = cli.build_parser().parse_args([
        "--id", "0", "--save_dir", str(tmp_path), "--device", "cpu",
        "--chaos", '[{"method": "TranStep", "kind": "drop"}]'])
    with pytest.raises(SystemExit, match="--chaos"):
        cli.run_server(args, config.GfedConfig())


def test_server_lr_needs_a_server_optimizer(tmp_path):
    args = cli.build_parser().parse_args(["--id", "0", "--save_dir", str(tmp_path),
                                          "--device", "cpu", "--server_lr", "0.1"])
    with pytest.raises(SystemExit, match="--server_lr"):
        cli.run_server(args, config.GfedConfig())


# ---- simulate -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_archive(tmp_path_factory):
    """``tests/test_cli.py``'s tiny archive: two nodes, V=60, K=4."""
    path = tmp_path_factory.mktemp("data") / "synthetic.npz"
    corpus = generate_synthetic_corpus(
        vocab_size=60, n_topics=4, n_docs=12, nwords=(15, 25), n_nodes=2,
        frozen_topics=2, seed=0,
    )
    from gfedntm_tpu_torch.data.synthetic import save_reference_npz

    save_reference_npz(corpus, str(path))
    return str(path)


SIM_ARGS = ["--num_epochs", "2", "--n_components", "4", "--batch_size", "8"]


def _run_main(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as exc:
            rc = ("SystemExit", exc.code)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def simulated(tiny_archive, tmp_path_factory):
    root = tmp_path_factory.mktemp("simulate")
    port = _run_main(cli.main, ["--source", tiny_archive, "--save_dir", str(root / "port"),
                                "--device", "cpu", "--profile_dir", str(root / "prof")]
                     + SIM_ARGS)
    jax_ = _run_main(jcli.main, ["--source", tiny_archive, "--save_dir", str(root / "jax")]
                     + SIM_ARGS)
    return root, port, jax_


def test_simulate_summary_is_the_jax_clis(simulated):
    _root, (rc, out, _), (jrc, jout, _) = simulated
    assert rc == jrc == 0
    got, want = json.loads(out.splitlines()[-1]), json.loads(jout.splitlines()[-1])
    assert set(got) == set(want)
    assert got["n_clients"] == want["n_clients"] == 2
    assert got["vocab_size"] == want["vocab_size"] == 60
    assert got["global_steps"] == want["global_steps"]
    assert np.isfinite(got["final_mean_loss"])
    assert 0 < got["tss"] <= 4.0


def test_simulate_writes_the_jax_clis_files(simulated):
    root, _, _ = simulated
    for name in ("global_model.npz", "client1/model.npz", "client2/model.npz"):
        with np.load(root / "port" / name) as got, np.load(root / "jax" / name) as want:
            assert sorted(got.files) == sorted(want.files)
            for key in got.files:
                assert got[key].shape == want[key].shape, key
                # the topics' JSON string is as wide as its words
                assert got[key].dtype.kind == want[key].dtype.kind, key
                if key != "topics":
                    assert got[key].dtype == want[key].dtype, key
    records = [json.loads(line) for line in (root / "port" / "metrics.jsonl").open()]
    for r in records:
        validate_record(r)
    events = [r["event"] for r in records]
    assert "summary" in events and events[-1] == "metrics_snapshot"
    phases = {r["phase"]: r for r in records if r["event"] == "phase"}
    assert {"consensus", "federated_fit"} <= set(phases)
    assert phases["federated_fit"]["n_clients"] == 2
    traces = list((root / "prof").glob("trace.*.pt.trace.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]


def test_simulate_global_betas_are_the_in_process_fit(simulated, tiny_archive):
    from gfedntm_tpu_torch import AVITM, BowDataset, FederatedTrainer
    from gfedntm_tpu_torch.data.synthetic import load_reference_npz

    root, _, _ = simulated
    args = cli.build_parser().parse_args(["--source", tiny_archive] + SIM_ARGS)
    cfg = cli.load_config(args)
    archive = load_reference_npz(tiny_archive)
    idx2token = dict(enumerate(archive.vocab_tokens))
    datasets = [BowDataset(X=n.bow, idx2token=idx2token) for n in archive.nodes]
    template = AVITM(**cli.model_kwargs_from_config(cfg, "avitm"),
                     input_size=len(archive.vocab_tokens), device="cpu")
    trainer = FederatedTrainer(template, n_clients=2,
                               grads_to_share=cfg.federation.grads_to_share,
                               max_iters=cfg.federation.max_iters, seed=cfg.train.seed,
                               device="cpu")
    result = trainer.fit(datasets)
    want = trainer.make_global_model(result).get_topic_word_distribution()
    with np.load(root / "port" / "global_model.npz") as got:
        assert got["betas"].dtype == want.dtype and np.array_equal(got["betas"], want)


# ---- processes ------------------------------------------------------------------------

def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_for_port(port: int, proc, timeout: float = PROCESS_LIMIT_S) -> None:
    """Start clients only once the server listens (as ``tests/chaos/harness.py``
    does): a client's first call to a closed port fails its join."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, "the server exited before listening"
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1.0):
                return
        except OSError:
            time.sleep(0.2)
    raise TimeoutError(f"nothing listens on {port}")


def _spawn(argv, log: Path, cwd: Path):
    fh = log.open("w")
    proc = subprocess.Popen(argv, cwd=cwd, env=_env(), stdout=fh, stderr=subprocess.STDOUT)
    proc.started = time.monotonic()  # its own limit starts here
    proc.log = log
    return proc


def _finish(procs) -> list:
    """Each process's exit code within its own limit; a process past it is
    killed and counted as 124."""
    codes = []
    for proc in procs:
        try:
            codes.append(proc.wait(max(1.0, PROCESS_LIMIT_S - (time.monotonic() - proc.started))))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            codes.append(124)
    return codes


PORT_CLI = [sys.executable, "-m", "gfedntm_tpu_torch"]
SLO = json.dumps([{"name": "no-rpc-errors", "metric": "rpc_errors", "agg": "value",
                   "op": "<=", "threshold": 0.0}])


@pytest.fixture(scope="module")
def port_federation(tiny_archive, tmp_path_factory):
    """A server and two clients, each a ``python -m gfedntm_tpu_torch``
    process on the CPU, with server-mode DP, the quality plane, an SLO and
    incident dumps on, so the streams carry what every reader reads."""
    root = tmp_path_factory.mktemp("federation")
    out, port = root / "out", _free_port()
    server = _spawn(PORT_CLI + [
        "--id", "0", "--min_clients_federation", "2", "--max_iters", "4",
        "--listen_port", str(port), "--save_dir", str(out), "--device", "cpu",
        "--dp", "server", "--dp_sigma", "0.5", "--dp_clip", "1.0", "--dp_budget", "1.0",
        "--quality_every", "1", "--quality_ref", tiny_archive, "--slo", SLO,
        "--dump_dir", str(out / "incidents"),
    ] + SIM_ARGS, root / "server.log", root)
    _wait_for_port(port, server)
    clients = [_spawn(PORT_CLI + [
        "--id", str(i), "--source", tiny_archive, "--server_address", f"localhost:{port}",
        "--listen_port", str(_free_port()), "--save_dir", str(out), "--device", "cpu",
        "--dump_dir", str(out / "incidents"),
    ], root / f"client{i}.log", root) for i in (1, 2)]
    codes = _finish([server] + clients)
    logs = {p.log.name: p.log.read_text()[-3000:] for p in [server] + clients}
    return out, codes, logs


def test_three_process_federation(port_federation):
    out, codes, logs = port_federation
    assert codes == [0, 0, 0], logs
    with np.load(out / "server_model.npz") as z:
        assert np.isfinite(z["betas"]).all()
    with np.load(out / "client1" / "model.npz") as a, np.load(out / "client2" / "model.npz") as b:
        assert a["betas"].shape == b["betas"].shape
        assert np.array_equal(a["betas"], b["betas"])
    server = [json.loads(line) for line in (out / "metrics.jsonl").open()]
    events = {r["event"] for r in server}
    assert {"privacy_budget", "quality_computed", "trace_started"} <= events
    assert sum(r["event"] == "span" and r["name"] == "round" for r in server) == 4


def test_a_port_client_joins_a_jax_server(tiny_archive, tmp_path):
    out, port = tmp_path / "out", _free_port()
    server = _spawn([sys.executable, str(REPO / "main.py"), "--id", "0",
                     "--min_clients_federation", "1", "--max_iters", "3",
                     "--listen_port", str(port), "--save_dir", str(out)] + SIM_ARGS,
                    tmp_path / "server.log", tmp_path)
    _wait_for_port(port, server)
    client = _spawn(PORT_CLI + ["--id", "1", "--source", tiny_archive, "--server_address",
                                f"localhost:{port}", "--listen_port", str(_free_port()),
                                "--save_dir", str(out), "--device", "cpu"],
                    tmp_path / "client.log", tmp_path)
    codes = _finish([server, client])
    assert codes == [0, 0], (server.log.read_text()[-3000:], client.log.read_text()[-3000:])
    with np.load(out / "server_model.npz") as z:
        assert np.isfinite(z["betas"]).all()
    assert (out / "client1" / "model.npz").exists()


# ---- the readers, byte for byte ---------------------------------------------------------

def _both(argv, outputs=()):
    """Each CLI's (exit code, stdout, stderr, the files it wrote) for
    ``argv``, the JAX one first; ``outputs`` are removed before each run."""
    results = []
    for main in (jcli.main, cli.main):
        for path in outputs:
            if os.path.exists(path):
                os.remove(path)
        rc, out, err = _run_main(main, argv)
        files = {p: Path(p).read_bytes() for p in outputs if os.path.exists(p)}
        results.append((rc, out, err, files))
    return results


def _assert_same(argv, outputs=()):
    want, got = _both(argv, outputs)
    assert got == want
    return got


def _streams(out: Path) -> list:
    return [str(out / "metrics.jsonl"), str(out / "client1" / "metrics.jsonl"),
            str(out / "client2" / "metrics.jsonl")]


def _write(path: Path, records) -> str:
    with path.open("w") as fh:
        for r in records:
            fh.write(json.dumps(r) + "\n")
    return str(path)


@pytest.mark.parametrize("which", ["server", "all", "clients_first"])
def test_summarize_the_port_federation(port_federation, tmp_path, which):
    out = port_federation[0]
    paths = {"server": _streams(out)[:1], "all": _streams(out),
             "clients_first": _streams(out)[::-1]}[which]
    rc, text, _, files = _assert_same(["summarize", *paths, "--json",
                                       str(tmp_path / "s.json")], [str(tmp_path / "s.json")])
    assert rc == 0 and "phase breakdown" in text and "wire accounting per tier" in text
    assert files


def test_summarize_golden_and_missing(tmp_path):
    path = _write(tmp_path / "m.jsonl", jobservability._golden_records())
    rc, text, _, _ = _assert_same(["summarize", path, "--json", str(tmp_path / "s.json")],
                                  [str(tmp_path / "s.json")])
    assert rc == 0 and "slowest client: 2" in text
    rc, _, _, _ = _assert_same(["summarize", "/nonexistent/metrics.jsonl"])
    assert rc == ("SystemExit", "no such metrics file: /nonexistent/metrics.jsonl")


@pytest.mark.parametrize("extra", [[], ["--assert-monotone-coherence", "0.0"],
                                   ["--assert-monotone-coherence", "10"]])
def test_report_the_port_federation(port_federation, tmp_path, extra):
    out = port_federation[0]
    rc, text, _, _ = _assert_same(["report", *_streams(out), "--json",
                                   str(tmp_path / "q.json")] + extra,
                                  [str(tmp_path / "q.json")])
    assert "model-quality report: 4 quality rounds" in text
    if extra[1:] == ["10"]:
        assert rc == 0


@pytest.mark.parametrize("extra", [[], ["--assert-monotone-coherence", "0.6"],
                                   ["--assert-monotone-coherence", "0.3"]])
def test_report_quality_records(tmp_path, extra):
    path = _write(tmp_path / "m.jsonl", jquality._quality_records())
    rc, _, _, _ = _assert_same(["report", path, "--json", str(tmp_path / "q.json")] + extra,
                               [str(tmp_path / "q.json")])
    assert rc == (1 if extra[1:] == ["0.3"] else 0)


def test_report_without_quality_events(tmp_path):
    path = _write(tmp_path / "m.jsonl", jobservability._golden_records())
    rc, _, err, _ = _assert_same(["report", path, "--assert-monotone-coherence", "0.1"])
    assert rc == 1 and "no quality_computed events" in err


@pytest.mark.parametrize("reference", [None, "client2"])
def test_trace_the_port_federation(port_federation, tmp_path, reference):
    out, target = port_federation[0], str(tmp_path / "trace.json")
    argv = ["trace", *_streams(out), "-o", target]
    if reference:
        argv += ["--reference", reference]
    rc, text, _, files = _assert_same(argv, [target])
    assert rc == 0 and "from 3 nodes" in text
    names = {e["args"]["name"] for e in json.loads(files[target])["traceEvents"]
             if e["ph"] == "M"}
    assert names == {"server", "client1", "client2"}


def test_trace_golden_nodes_and_bad_reference(tmp_path):
    paths = []
    for node, records in jtrace._golden_nodes().items():
        (tmp_path / node).mkdir()
        paths.append(_write(tmp_path / node / "metrics.jsonl", records))
    target = str(tmp_path / "t.json")
    rc, text, _, _ = _assert_same(["trace", *paths, "-o", target], [target])
    assert rc == 0 and "client1+5.000s" in text
    rc, _, _, _ = _assert_same(["trace", *paths, "-o", target, "--reference", "nobody"],
                               [target])
    assert rc[0] == "SystemExit" and "nobody" in rc[1]


@pytest.mark.parametrize("spec", [
    [{"name": "no-rpc-errors", "metric": "rpc_errors", "agg": "value", "op": "<=",
      "threshold": 0.0}],
    [{"name": "no-rpc", "metric": "rpc_calls", "agg": "value", "op": "<=", "threshold": 0.0},
     {"name": "polls", "metric": "client_poll_s", "agg": "p99", "op": "<=",
      "threshold": 600.0}],
])
def test_slo_the_port_federation(port_federation, tmp_path, spec):
    out = port_federation[0]
    rc, _, _, _ = _assert_same(["slo", "--slo", json.dumps(spec), *_streams(out), "--json",
                                str(tmp_path / "a.json")], [str(tmp_path / "a.json")])
    assert rc == (1 if spec[0]["name"] == "no-rpc" else 0)


def test_slo_jax_test_streams(tmp_path):
    spec_path = tmp_path / "slo.json"
    spec_path.write_text(json.dumps([jslo._spec()]))
    cases = jslo.TestSloCli()
    cases._write_stream(tmp_path / "good.jsonl", [0, 0, 0])
    cases._write_stream(tmp_path / "bad.jsonl", [0, 4, 9])
    rc, _, _, _ = _assert_same(["slo", "--slo", str(spec_path), str(tmp_path / "good.jsonl")])
    assert rc == 0
    rc, _, _, _ = _assert_same(["slo", "--slo", str(spec_path), "--json",
                                str(tmp_path / "a.json"), str(tmp_path / "bad.jsonl")],
                               [str(tmp_path / "a.json")])
    assert rc == 1
    for bad in ("[{broken", "[]"):
        rc, _, _, _ = _assert_same(["slo", "--slo", bad, str(tmp_path / "good.jsonl")])
        assert rc[0] == "SystemExit"


@pytest.mark.parametrize("budget", [None, "0.01", "1000"])
def test_privacy_the_port_federation(port_federation, tmp_path, budget):
    out = port_federation[0]
    argv = ["privacy", *_streams(out), "--json", str(tmp_path / "p.json")]
    if budget:
        argv += ["--budget", budget]
    rc, text, _, _ = _assert_same(argv, [str(tmp_path / "p.json")])
    assert "privacy ledger: 4 round(s), mode server" in text
    if budget is not None:
        assert rc == (1 if budget == "0.01" else 0)


LEDGERS = {
    "clean": ([{"eps": 0.5}, {"eps": 1.0}, {"eps": 1.4}], []),
    "over": ([{"eps": 0.5}, {"eps": 1.4}], ["--budget", "1.0"]),
    "under": ([{"eps": 0.5}, {"eps": 1.4}], ["--budget", "2.0"]),
    "declared": ([{"eps": 0.5, "budget": 1.0}, {"eps": 1.4, "budget": 1.0}], []),
    "non_monotone": ([{"eps": 0.5}, {"eps": 1.4}, {"eps": 0.9}], []),
}


@pytest.mark.parametrize("name", sorted(LEDGERS))
def test_privacy_jax_test_ledgers(tmp_path, name):
    rows, extra = LEDGERS[name]
    path = jprivacy._write_ledger(tmp_path / "m.jsonl", rows)
    _assert_same(["privacy", path, "--json", str(tmp_path / "s.json")] + extra,
                 [str(tmp_path / "s.json")])


def test_privacy_without_a_ledger(tmp_path):
    path = _write(tmp_path / "m.jsonl", [{"event": "round_averaged", "time": 0.0,
                                          "node": "server"}])
    assert _assert_same(["privacy", path])[0] == 0
    assert _assert_same(["privacy", path, "--budget", "1.0"])[0] == 1


def test_incident_the_port_federation(port_federation, tmp_path):
    out = port_federation[0]
    dump = str(out / "incidents")
    os.makedirs(dump, exist_ok=True)
    _assert_same(["incident", dump, "--json", str(tmp_path / "r.json"), "--trace_out",
                  str(tmp_path / "t.json")], [str(tmp_path / "r.json"), str(tmp_path / "t.json")])
    _assert_same(["incident", dump, "--assert-no-incidents"])


@pytest.mark.parametrize("extra", [[], ["--limit", "3"], ["--assert-no-incidents"]])
def test_incident_jax_test_bundles(tmp_path, extra):
    dump = str(tmp_path / "inc")
    jforensics.TestIncidentCLI()._seed_incident(dump)
    outputs = [str(tmp_path / "r.json"), str(tmp_path / "t.json")]
    rc, text, _, _ = _assert_same(["incident", dump, "--json", outputs[0], "--trace_out",
                                   outputs[1]] + extra, outputs)
    assert rc == (1 if extra == ["--assert-no-incidents"] else 0)


def test_incident_edges(tmp_path):
    clean = tmp_path / "clean"
    clean.mkdir()
    assert _assert_same(["incident", str(clean)])[0] == 0
    assert _assert_same(["incident", str(clean), "--assert-no-incidents"])[0] == 0
    rc, _, _, _ = _assert_same(["incident", str(tmp_path / "nope")])
    assert rc[0] == "SystemExit"
    dump = tmp_path / "odd"
    dump.mkdir()
    jforensics._write_bundle(str(dump), "zz", "server", "alert", 5.0, schema=99)
    _assert_same(["incident", str(dump)])
    (dump / "inc-broken__server.json").write_text("{not json")
    rc, _, _, _ = _assert_same(["incident", str(dump)])
    assert rc[0] == "SystemExit"


def test_trace_context_writes_nothing_without_a_dir(tmp_path):
    with tobs.trace(None):
        pass
    with tobs.trace(str(tmp_path / "t"), "cpu"):
        torch.ones(3).sum()
    (trace,) = (tmp_path / "t").iterdir()
    assert trace.name.startswith("trace.") and json.loads(trace.read_text())["traceEvents"]
