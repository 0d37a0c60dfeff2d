"""How ``chip_smoke.py`` reads what the build made, and how it refuses to
run, on the CPU: kernel names from mangled symbols, the tensor-core
instruction check over every instantiation of K1, K2 and K3, ptxas' spill
report, and the exit codes without a card or with bad arguments; with a
card faked and every phase stubbed, the order of the phases (phase 14 on
phase 9's store, phase 15 on phase 3's fit, phase 16 last; phases 5 to 8 on
phase 4's rank groups) and of the output lines (the script's own seconds before the
``kernels`` line, the ``ok`` line last). The script is imported by path."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

MANGLED = {
    "_ZN12_GLOBAL__N_112stats_kernelILi32ELb1EEEvPKfS2_S2_S2_S2_PfS3_S3_S3_iiiifi":
        "stats_kernel<32, 16B>",
    "_ZN12_GLOBAL__N_111loss_kernelILi16ELb0EEEvPKfS2_S2_S2_S2_S2_S2_PfS3_iiiffi":
        "loss_kernel<16, 4B>",
    "_ZN12_GLOBAL__N_112grads_kernelILi16ELb1EEEvPKfS2_S2_S2_S2_S2_S2_S2_S2_S2_PfS3_iiiifffi":
        "grads_kernel<16, 16B>",
    "_ZN12_GLOBAL__N_117simt_stats_kernelEPKfS1_S1_S1_S1_PfS2_S2_S2_iiiifi": "simt_stats_kernel",
    "_ZN12_GLOBAL__N_116simt_loss_kernelEPKfS1_S1_S1_S1_S1_S1_PfS2_iiiffi": "simt_loss_kernel",
    "_ZN12_GLOBAL__N_120merge_softmax_kernelEPKfS1_iiPfS2_": "merge_softmax_kernel",
    "something_else": "something_else",
    # Storage as the first template argument (float, __nv_bfloat16).
    "_ZN12_GLOBAL__N_112stats_kernelIfLi32ELb1EEEvPKfPKT_S2_S2_S2_PfS6_S6_S6_iiiiifi":
        "stats_kernel<32, 16B>",
    "_ZN12_GLOBAL__N_111loss_kernelI13__nv_bfloat16Li16ELb1EEEvPKfPKT_S7_S2_S2_S2_S2_PfS8_"
    "iiiiffi": "loss_kernel<bf16, 16, 16B>",
    "_ZN12_GLOBAL__N_112grads_kernelIfLi16ELb0EEEvPKfPKT_S5_S2_S2_S2_S2_S2_S2_S2_PfS6_iiiiifffi":
        "grads_kernel<16, 4B>",
    "_ZN12_GLOBAL__N_117simt_stats_kernelIfEEvPKfPKT_S2_S2_S2_PfS6_S6_S6_iiiiifi":
        "simt_stats_kernel",
    "_ZN12_GLOBAL__N_116simt_loss_kernelI13__nv_bfloat16EEvPKfPKT_S7_S2_S2_S2_S2_PfS8_iiiiffi":
        "simt_loss_kernel<bf16>",
}

FULL = {f"{family}<{vt}, {ring}>": 96 for family in ("stats_kernel", "loss_kernel",
                                                       "grads_kernel")
        for vt in (32, 16) for ring in ("16B", "4B")}
FULL.update({f"{family}<bf16, {vt}, 16B>": 12 for family in ("stats_kernel", "loss_kernel",
                                                               "grads_kernel")
             for vt in (32, 16)})


@pytest.fixture(scope="module")
def smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_report_under_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("mangled", sorted(MANGLED))
def test_kernel_names_from_mangled_symbols(smoke, mangled):
    assert smoke._kernel_name(mangled) == MANGLED[mangled]


def test_tensor_core_counts_pass_when_every_instantiation_has_mma(smoke):
    smoke.check_tensor_core_counts(FULL)


@pytest.mark.parametrize("broken", ["zero", "no_stats", "no_loss", "no_grads", "zero_bf16",
                                    "no_bf16_grads", "no_fp32_stats"])
def test_tensor_core_counts_fail_on_a_zero_or_a_missing_family(smoke, broken):
    counts = dict(FULL)
    if broken == "zero":
        counts["loss_kernel<16, 4B>"] = 0
    elif broken == "zero_bf16":
        counts["stats_kernel<bf16, 32, 16B>"] = 0
    elif broken == "no_bf16_grads":
        counts = {n: c for n, c in counts.items() if not n.startswith("grads_kernel<bf16")}
    elif broken == "no_fp32_stats":
        counts = {n: c for n, c in counts.items()
                  if not n.startswith("stats_kernel<") or "bf16" in n}
    else:
        family = broken.removeprefix("no_") + "_kernel"
        counts = {n: c for n, c in counts.items() if not n.startswith(family)}
    with pytest.raises(smoke.SmokeFailure):
        smoke.check_tensor_core_counts(counts)


def test_ptxas_report_sums_spills_per_kernel(smoke):
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_112stats_kernelILi32ELb1EEEvPKfS2_S2_S2_S2_PfS3_S3_S3_iiiifi' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_112stats_kernel",
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 480 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_117simt_stats_kernelEPKfS1_S1_S1_S1_PfS2_S2_S2_iiiifi' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers",
    ])
    lines, spills = smoke.ptxas_report(log)
    assert spills == {"stats_kernel<32, 16B>": 20, "simt_stats_kernel": 0}
    assert lines[0].startswith("ptxas stats_kernel<32, 16B>: ")
    assert lines[-1] == "ptxas simt_stats_kernel: Used 40 registers"


@pytest.mark.parametrize("argv", [["--bogus"], ["--against"], ["--against", "a", "b"],
                                  ["--kernels-only", "--nope"],
                                  ["--data-parallel-only", "--kernels-only"],
                                  ["--data-parallel-only", "--against", "."],
                                  ["--hierarchy-only", "--pacing-only"],
                                  ["--serving-only", "--federation-only"],
                                  ["--serving-only", "--against", "."],
                                  ["--cli-only", "--serving-only"],
                                  ["--cli-only", "--against", "."],
                                  ["--scenarios-only", "--cli-only"],
                                  ["--scenarios-only", "--against", "."]])
def test_bad_arguments_exit_2(smoke, argv, capsys):
    assert smoke.main(argv) == 2
    assert "usage" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [[], ["--kernels-only"], ["--kernels-only", "--against", "."],
                                  ["--data-parallel-only"], ["--hierarchy-only"],
                                  ["--serving-only"], ["--cli-only"], ["--scenarios-only"]])
def test_no_card_exits_2_and_prints_no_result(smoke, argv, capsys):
    assert smoke.main(argv) == 2
    assert capsys.readouterr().out == ""


def test_trace_kernels_counts_kernel_events_by_family(smoke, tmp_path):
    """Phase 13's profiler check reads the Chrome trace's kernel events by
    the three kernels' names; CPU ops of the same names do not count."""
    import json

    events = [{"cat": "kernel", "name": "void stats_kernel<32, (VecWidth)1>(Args)"},
              {"cat": "kernel", "name": "void grads_kernel<32, (VecWidth)1>(Args)"},
              {"cat": "kernel", "name": "void grads_kernel<16, (VecWidth)1>(Args)"},
              {"cat": "cpu_op", "name": "loss_kernel"},
              {"cat": "kernel", "name": "void at::native::elementwise_kernel<128, 2>"}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert smoke.trace_kernels(path) == {"stats_kernel": 1, "loss_kernel": 0, "grads_kernel": 2}


@pytest.mark.parametrize("losses,patience,delta,want", [
    ([3.0, 2.0, 1.0], 5, 0.0, [0, 1, 2]),
    ([3.0, 3.5, 2.0], 5, 0.0, [0, 2]),
    ([3.0, 3.0, 3.0], 5, 0.0, [0, 1, 2]),  # a tie is an improvement (score >= best)
    ([3.0, 2.9, 2.8], 5, 0.5, [0]),
    ([3.0, 4.0, 1.0], 1, 0.0, [0]),  # stopped after epoch 1: epoch 2 never runs
])
def test_saved_epochs_follow_early_stopping(smoke, losses, patience, delta, want):
    assert smoke.saved_epochs(losses, patience, delta) == want


def test_eval_kernel_work_has_no_column_statistics_pass(smoke):
    """Eval K1 at one rank's shard of the sharded validation: the training
    bytes plus the running statistics it reads; the same product. Eval K2
    is the training kernel."""
    work, train = smoke.eval_kernel_work(256, 50, 50_000), smoke.kernel_work(256, 50, 50_000)
    assert work["stats"] == (10_854_272, 1.28e9)
    assert work["stats"][0] - train["stats"][0] == 4 * 2 * 50_000
    assert work["loss"] == train["loss"] == (61_655_296, 1.28e9)
    k1 = smoke.kernel_bound(*work["stats"], "NVIDIA H100 80GB HBM3")
    k2 = smoke.kernel_bound(*work["loss"], "NVIDIA H100 80GB HBM3")
    assert (k1["bound_by"], k2["bound_by"]) == ("operations", "bytes")
    assert k1["bound_ms"] == pytest.approx(3 * 1.28e9 / 495e12 * 1e3)
    assert k2["bound_ms"] == pytest.approx(61_655_296 / 3.35e12 * 1e3)


def metrics_run(checkpoint_every):
    import numpy as np

    from gfedntm_tpu_torch import AVITM, BowDataset, FederatedTrainer
    from gfedntm_tpu_torch.utils.observability import MetricsLogger

    rng = np.random.default_rng(0)
    data = [BowDataset(X=rng.integers(0, 3, size=(16, 24)).astype(np.float32))
            for _ in range(2)]
    template = AVITM(input_size=24, n_components=3, hidden_sizes=(4,), batch_size=8,
                     num_epochs=2, device="cpu")
    logger = MetricsLogger(validate=True)
    FederatedTrainer(template, 2, device="cpu").fit(data, checkpoint_every=checkpoint_every,
                                                    metrics=logger)
    return logger


def test_metrics_report_reads_a_two_segment_run(smoke):
    line = smoke.metrics_report(metrics_run(2))
    assert line.startswith("metrics: 7 records, all valid (federated_segment, "
                           "metrics_snapshot, phase); docs_per_s ")
    assert "trainer_step_s 1 observation" in line and "federated_mesh_devices 1" in line


def test_metrics_report_fails_without_a_steady_segment(smoke):
    with pytest.raises(smoke.SmokeFailure, match="metrics records"):
        smoke.metrics_report(metrics_run(None))


def test_beta_spread_counts_entries_beyond_the_tolerance(smoke):
    beta = np.zeros((2, 4), np.float32)
    other = np.array([[0.0, 0.5, 0.0, 2.0], [0.0, 0.0, -1.5, 0.0]], np.float32)
    assert smoke.beta_spread(other, beta, 1.0) == (2.0, 0.25)
    assert smoke.nonzero({"stats": 1, "grads": 0}) == {"stats": 1}


PHASES = ("kernel_phase", "main_path_phase", "sharded_fit_phase", "persistence_phase",
          "data_parallel_phase", "decodes_and_text_phase", "ctm_phase", "federation_phase",
          "server_planes_phase", "privacy_ops_phase", "pacing_phase", "hierarchy_phase",
          "serving_phase", "cli_phase", "scenario_phase")


@pytest.fixture()
def faked(smoke, monkeypatch):
    """A card as ``main`` sees it, on the CPU, and every phase replaced by a
    recorder: returns the list of ``(phase, args)`` calls."""
    import torch

    from gfedntm_tpu_torch import device
    from gfedntm_tpu_torch.ops import _build

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda index=0: "FAKE H100")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(device, "resolve_device", lambda d=None: torch.device("cpu"))
    monkeypatch.setattr(_build, "build", lambda: Path("fake.so"))
    monkeypatch.setattr(smoke, "build_report", lambda lib, log: ["ptxas fake"])
    monkeypatch.setattr(smoke, "card_line", lambda: "FAKE H100, 700.00 W")
    calls = []
    row = {"name": "stats", "route": "cuda", "source": "s", "replaces": "r", "launches": 16,
           "max_abs_err": 0.0, "ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5,
           "bound_by": "bytes", "library_ms": None}
    results = {"kernel_phase": ({"stats": row}, {"stats": ""}),
               "main_path_phase": ("datasets", "result"),
               "sharded_fit_phase": ("X", "kw", {"validation": "validation"}),
               "decodes_and_text_phase": "raw", "federation_phase": "phase9",
               "pacing_phase": "pacing"}
    for name in PHASES:
        def phase(*args, _name=name):
            calls.append((_name, args))
            return results.get(_name)
        monkeypatch.setattr(smoke, name, phase)
    return calls


def test_the_whole_script_serves_last_and_prints_its_total(smoke, faked, capsys):
    """Phase 14 runs on phase 7(b)'s corpora and phase 9's store, phase 15,
    the command line, on phase 3's fit, and phase 16, the scenario matrix,
    last with the kernels' notes; phases 5 to 8 read phase 4's rank groups;
    the script's own seconds come before the ``kernels`` line, and the
    ``ok`` line is the last."""
    import json

    assert smoke.main([]) == 0
    assert [name for name, _ in faked] == list(PHASES)
    calls = dict(faked)
    assert calls["serving_phase"][2:] == ("raw", "phase9")
    assert calls["cli_phase"][1:] == ("result",)
    assert calls["scenario_phase"] == ("FAKE H100, 700.00 W", {"stats": ""})
    assert calls["persistence_phase"][-3:] == ("X", "kw", "validation")
    groups = {"validation": "validation"}
    assert calls["data_parallel_phase"][-1] == calls["decodes_and_text_phase"][-1] == groups
    assert calls["ctm_phase"][2:] == ("raw", "datasets", groups)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "FAKE H100, 700.00 W"
    assert lines[-3].startswith("chip_smoke took ") and lines[-3].endswith(
        " s (FAKE H100, 700.00 W)")
    assert float(lines[-3].split()[2]) >= 0.0
    assert [k["name"] for k in json.loads(lines[-2])["kernels"]] == ["stats"]
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "FAKE H100", "count": 1}}


def test_serving_only_runs_phase_14_alone(smoke, faked, capsys):
    """``--serving-only`` runs phase 14 with nothing before it, so phase 14
    runs phase 9 itself; it prints no result lines."""
    assert smoke.main(["--serving-only"]) == 0
    assert [name for name, _ in faked] == ["serving_phase"]
    card, notes = faked[0][1]
    assert card == "FAKE H100, 700.00 W" and set(notes) == {"stats", "loss", "grads"}
    out = capsys.readouterr().out
    assert '"ok"' not in out and "kernels" not in out


def test_cli_only_runs_phase_15_alone(smoke, faked, capsys):
    """``--cli-only`` runs phase 15 with nothing before it, so phase 15
    fits phase 3's model itself; it prints no result lines."""
    assert smoke.main(["--cli-only"]) == 0
    assert [name for name, _ in faked] == ["cli_phase"]
    assert faked[0][1] == ("FAKE H100, 700.00 W",)
    out = capsys.readouterr().out
    assert '"ok"' not in out and "kernels" not in out


def test_scenarios_only_runs_phase_16_alone(smoke, faked, capsys):
    """``--scenarios-only`` runs phase 16 with nothing before it; it prints
    no result lines."""
    assert smoke.main(["--scenarios-only"]) == 0
    assert [name for name, _ in faked] == ["scenario_phase"]
    card, notes = faked[0][1]
    assert card == "FAKE H100, 700.00 W" and set(notes) == {"stats", "loss", "grads"}
    out = capsys.readouterr().out
    assert '"ok"' not in out and "kernels" not in out


def test_cell_local_steps_reads_the_clients_streams(smoke, tmp_path):
    """Phase 16 counts a cell's local steps from its clients' last snapshots:
    ``stepper_step_s`` times every step but a client's first, and a client
    that answered no poll took none."""
    import json

    def stream(name, *snapshots):
        path = tmp_path / name / "metrics.jsonl"
        path.parent.mkdir()
        path.write_text("".join(json.dumps({"event": "metrics_snapshot", "time": float(i),
                                            "metrics": m}) + "\n"
                                for i, m in enumerate(snapshots)))

    polled = {"client_polls": {"type": "counter", "value": 3.0}}
    stream("client1", {**polled, "stepper_step_s": {"type": "histogram", "count": 2}},
           {**polled, "stepper_step_s": {"type": "histogram", "count": 32}})
    stream("client2", polled)
    stream("client3", {"client_polls": {"type": "counter", "value": 0.0}})
    stream("server", {**polled, "stepper_step_s": {"type": "histogram", "count": 99}})
    assert smoke.cell_local_steps(str(tmp_path)) == 33 + 1 + 0
