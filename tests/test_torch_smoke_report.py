"""How ``chip_smoke.py`` reads what the build made, and how it refuses to
run, on the CPU: kernel names from mangled symbols, the tensor-core
instruction check over every instantiation of K1, K2 and K3, ptxas' spill
report, each kernel's SASS, the registers and mma counts beside each other,
the ``--against`` lines of the kernels' SASS and of the bf16 kernels, the bitwise check's failure, bf16 K3's routes
beside another build's, and the exit codes without a card or with bad
arguments; with a
card faked and every phase stubbed, the order of the phases (phase 14 on
phase 9's store, phase 15 on phase 3's fit starting 17(b)'s processes,
phase 16, then phase 17 on its own rank group (started before phase 13)
and phase 3's fit, joining phase 18 in the process that runs phases 18
and 20 (started before phase 9), then phase 20 and phase 21; ``--examples-only``,
``--experiment-scripts-only`` and the lines of phases 20 and 21; phases 5 to 8 on phase 4's rank groups) and of the
output lines (the script's own seconds before the ``kernels`` line, the
``ok`` line last). The script is imported by path."""

import importlib.util
import re
from pathlib import Path
from types import SimpleNamespace

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
                                    "no_bf16_grads", "no_fp32_stats", "bf16_grads_not_fewer"])
def test_tensor_core_counts_fail_on_a_zero_or_a_missing_family(smoke, broken):
    counts = dict(FULL)
    if broken == "bf16_grads_not_fewer":  # a bf16 K3 with three products a k-step
        counts["grads_kernel<bf16, 16, 16B>"] = counts["grads_kernel<16, 16B>"]
    elif broken == "zero":
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
    lines, spills, registers = smoke.ptxas_report(log)
    assert spills == {"stats_kernel<32, 16B>": 20, "simt_stats_kernel": 0}
    assert registers == {"stats_kernel<32, 16B>": 128, "simt_stats_kernel": 40}
    assert lines[0].startswith("ptxas stats_kernel<32, 16B>: ")
    assert lines[-1] == "ptxas simt_stats_kernel: Used 40 registers"


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_112grads_kernelIfLi16ELb1EEEvPKfPKT_S5_S2_PfS6_iiiiifffi
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
        /*0010*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;   /* 0x0000000c0804723c */
        /*0020*/              @P0  EXIT ;                                 /* 0x000000000000094d */
\t\t..........

\t\tFunction : _ZN12_GLOBAL__N_120merge_softmax_kernelEPKfS1_iiPfS2_
        /*0000*/                   MOV R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
"""


def test_sass_of_reads_each_kernels_instructions(smoke, monkeypatch, tmp_path):
    """``cuobjdump -sass``'s listing per kernel name, without addresses,
    encodings or headers."""
    tool = tmp_path / "cuobjdump"
    tool.write_text('#!/bin/sh\ncat "$2"\n')
    tool.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:{smoke.os.environ['PATH']}")
    lib = tmp_path / "lib.so"
    lib.write_text(SASS)
    assert smoke.sass_of(lib) == {
        "grads_kernel<16, 16B>": ["LDC R1, c[0x0][0x28] ;",
                                  "HMMA.1688.F32.TF32 R4, R8, R12, R4 ;", "@P0 EXIT ;"],
        "merge_softmax_kernel": ["MOV R1, c[0x0][0x28] ;"],
    }


def test_build_report_pairs_registers_and_mma_counts(smoke, monkeypatch):
    """ptxas' registers and cuobjdump's tensor-core count per instantiation,
    returned beside the printed line, and bf16 K3's line beside the FP32
    kernel's at each width."""
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_112grads_kernelIfLi16ELb1EEEvPKfPKT_S5_S2_S2_S2_S2_S2_S2_S2_PfS6_"
        "iiiiifffi' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 124 registers, used 1 barriers, 480 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_112grads_kernelI13__nv_bfloat16Li16ELb1EEEvPKfPKT_S7_S2_S2_S2_S2_"
        "S2_S2_S2_PfS8_iiiiifffi' for 'sm_90a'",
        "ptxas info    : Used 110 registers, used 1 barriers, 480 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_117simt_stats_kernelEPKfS1_S1_S1_S1_PfS2_S2_S2_iiiifi' for 'sm_90a'",
        "ptxas info    : Used 40 registers",
    ])
    counts = dict(FULL, **{"grads_kernel<16, 16B>": 84, "grads_kernel<bf16, 16, 16B>": 60,
                           "grads_kernel<bf16, 32, 16B>": 64})
    sass = {name: ["HMMA.1688.F32.TF32 R4, R8, R12, R4 ;"] * n + ["EXIT ;"]
            for name, n in counts.items()}
    monkeypatch.setattr(smoke, "sass_of", lambda lib: dict(sass, simt_stats_kernel=["EXIT ;"]))
    report, got = smoke.build_report(Path("lib.so"), log)
    assert report == ["tensor-core instructions (HMMA/HGMMA in cuobjdump -sass): " + ", ".join(
        f"{name} {n}" for name, n in sorted(counts.items()))]
    assert got["grads_kernel<16, 16B>"] == {"registers": 124, "hmma": 84}
    assert got["grads_kernel<bf16, 16, 16B>"] == {"registers": 110, "hmma": 60}
    assert got["grads_kernel<bf16, 32, 16B>"] == {"hmma": 64}
    assert "simt_stats_kernel" not in got
    assert smoke.resources_line(got, "grads_kernel") == (
        "grads_kernel<bf16, 32, 16B> ? registers, 64 HMMA (FP32 grads_kernel<32, 16B> ? "
        "registers, 96 HMMA); grads_kernel<bf16, 16, 16B> 110 registers, 60 HMMA (FP32 "
        "grads_kernel<16, 16B> 124 registers, 84 HMMA)")
    assert smoke.resources_line({}, "grads_kernel").startswith(
        "grads_kernel<bf16, 32, 16B> ? registers, ? HMMA")


def test_same_sass_line_counts_kernels_and_names_those_that_differ(smoke, monkeypatch):
    """``--against``'s SASS line over the kernels without bf16 storage; bf16
    instantiations are left out."""
    mine = {"stats_kernel<32, 16B>": ["A ;"], "grads_kernel<32, 4B>": ["B ;"],
            "merge_softmax_kernel": ["C ;"], "grads_kernel<bf16, 32, 16B>": ["D ;"]}
    builds = {"mine.so": mine, "same.so": dict(mine, **{"grads_kernel<bf16, 32, 16B>": []}),
              "other.so": dict(mine, **{"grads_kernel<32, 4B>": ["B ;", "B ;"]})}
    monkeypatch.setattr(smoke, "sass_of", lambda lib: builds[str(lib)])
    lib = SimpleNamespace(_name="mine.so")
    assert smoke.same_sass_line(lib, SimpleNamespace(_name="same.so"), Path("/p")) == (
        "kernels: SASS the same as the build of /p's in 3 of 3 kernels without bf16 storage")
    assert smoke.same_sass_line(lib, SimpleNamespace(_name="other.so"), Path("/p")) == (
        "kernels: SASS the same as the build of /p's in 2 of 3 kernels without bf16 storage; "
        "differs in grads_kernel<32, 4B>")


#: ``--against``'s line for the bf16 instantiations, and the failure of a
#: bitwise comparison (``check_same_bits``).
AGAINST_BF16_LINE = re.compile(r"^kernels ok: bf16 K1, K2 and K3 bitwise equal to the build of "
                               r"(\S+) in (\d+) cases \(launches: K1 (\d+), K2 (\d+), K3 "
                               r"(\d+)\)$")
SAME_BITS_FAILURE = re.compile(r"^(.+): (.+) differs bitwise in (\w+(?:, \w+)*)$")
#: ``--against``'s line for the routes bf16 K3 takes.
AGAINST_ROUTES_LINE = re.compile(r"^kernels ok: bf16 K3 routes at (\d+) \(B, K\) beside the build "
                                 r"of (\S+): none lost, (\d+) onto 32-column tiles, (\d+) newly "
                                 r"taken; FP32 K3 routes unchanged$")


def test_against_bf16_line_parses_and_a_mangled_one_does_not(smoke):
    line = smoke.against_bf16_line(Path("/x/build/parent"), 13,
                                   {"stats": 13, "loss": 13, "grads": 9})
    found = AGAINST_BF16_LINE.match(line)
    assert found and found.groups() == ("/x/build/parent", "13", "13", "13", "9")
    for mangled in (line.replace("K3 9", "K3 nine"), line.replace("bitwise ", ""),
                    line + " extra", line.replace(" cases", "")):
        assert not AGAINST_BF16_LINE.match(mangled)


def test_same_bits_passes_equal_outputs_and_names_those_that_differ(smoke):
    """The hard bitwise check: equal outputs pass; one value a unit in the
    last place off fails with a message that names that output alone."""
    import torch

    got = (torch.linspace(-1.0, 1.0, 7), torch.arange(6.0).reshape(2, 3))
    smoke.check_same_bits("bf16 B=8", "bf16 K3", "g_theta,g_beta", got,
                          tuple(t.clone() for t in got))
    off = got[1].clone()
    off[1, 2] = torch.nextafter(off[1, 2], torch.tensor(10.0))
    with pytest.raises(smoke.SmokeFailure) as err:
        smoke.check_same_bits("bf16 B=8 K=4", "bf16 K3 against the FP32 K3", "g_theta,g_beta",
                              got, (got[0], off))
    found = SAME_BITS_FAILURE.match(str(err.value))
    assert found and found.groups() == ("bf16 B=8 K=4", "bf16 K3 against the FP32 K3", "g_beta")
    assert not SAME_BITS_FAILURE.match("bf16 B=8 K=4: bf16 K3 differs in g_beta")


class FakeRoutes:
    """A build's ``fd_route`` by a rule: ``rule(kind, b, k)`` with the bf16
    bit in ``kind``."""

    def __init__(self, rule):
        self.rule = rule

    def fd_route(self, kind, b, k, route):
        route._obj.value = self.rule(kind, b, k)
        return 0


def _fp32_k3_route(b, k):
    return 32 if b <= 256 and k <= 56 else 16 if b <= 1024 and k <= 40 else -1


def test_compare_routes_counts_moves_and_fails_on_a_lost_route(smoke, monkeypatch):
    """bf16 K3's routes beside another build's: shapes moved onto 32-column
    tiles and newly taken are counted in the line; a shape the other build
    takes and this one refuses or puts on narrower tiles, or a changed FP32
    route, fails."""
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    monkeypatch.setattr(smoke, "ROUTE_GRID", [(b, k) for b in (8, 256, 320, 1100)
                                              for k in (8, 50, 60, 64, 72)])
    parent = FakeRoutes(lambda kind, b, k: _fp32_k3_route(b, k))

    def change(kind, b, k):
        if kind & 4 and b <= 256 and k <= 64:
            return 32  # the smaller bf16 layout fits wider
        return _fp32_k3_route(b, k)

    line = smoke.compare_routes(FakeRoutes(change), parent, Path("/p"))
    found = AGAINST_ROUTES_LINE.match(line)
    # (8, 60), (8, 64), (256, 60), (256, 64): 16-wide or refused at the parent.
    assert found and found.groups() == ("20", "/p", "0", "4")
    moved = FakeRoutes(lambda kind, b, k: 32 if kind & 4 and b == 320 and k == 8
                       else _fp32_k3_route(b, k))
    assert AGAINST_ROUTES_LINE.match(smoke.compare_routes(moved, parent, Path("/p"))
                                           ).group(3) == "1"
    for lost_to in (-1, 16):  # refused, or on narrower tiles
        lost = FakeRoutes(lambda kind, b, k: lost_to if kind & 4 and (b, k) == (8, 8)
                          else _fp32_k3_route(b, k))
        with pytest.raises(smoke.SmokeFailure, match="bf16 K3 takes B=8 K=8 on "
                           f"{fd.ROUTE_NAMES[lost_to]}, the build of /p on tensor cores, 32"):
            smoke.compare_routes(lost, parent, Path("/p"))
    fp32 = FakeRoutes(lambda kind, b, k: 16 if not kind & 4 and (b, k) == (8, 8)
                      else _fp32_k3_route(b, k))
    with pytest.raises(smoke.SmokeFailure, match="FP32 K3's route at B=8 K=8"):
        smoke.compare_routes(fp32, parent, Path("/p"))


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
                                  ["--scenarios-only", "--against", "."],
                                  ["--mesh-only", "--experiments-only"],
                                  ["--mesh-only", "--against", "."],
                                  ["--experiments-only", "--cli-only"],
                                  ["--examples-only", "--experiments-only"],
                                  ["--examples-only", "--against", "."],
                                  ["--experiment-scripts-only", "--examples-only"],
                                  ["--experiment-scripts-only", "--against", "."]])
def test_bad_arguments_exit_2(smoke, argv, capsys):
    assert smoke.main(argv) == 2
    assert "usage" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [[], ["--kernels-only"], ["--kernels-only", "--against", "."],
                                  ["--data-parallel-only"], ["--hierarchy-only"],
                                  ["--serving-only"], ["--cli-only"], ["--scenarios-only"],
                                  ["--mesh-only"], ["--experiments-only"],
                                  ["--examples-only"], ["--experiment-scripts-only"]])
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
          "serving_phase", "cli_phase", "scenario_phase", "mesh_phase", "experiments_phase",
          "examples_phase", "experiment_scripts_phase")
#: The order of a run of every phase: the process of phases 18, 20 and 21
#: starts before phase 9 and 17(a)'s rank group before phase 13, phase 17
#: waits for them and for phase 18, and phases 20 and 21 are joined after
#: phase 17.
ORDER = (PHASES[:7] + ("experiments_process",) + PHASES[7:11] + ("mesh_programs",)
         + PHASES[11:])
#: Phase 4's rank groups as the fake returns them, and 17(a)'s group.
GROUPS = {"validation": "validation"}
MESH_GROUPS = {"mesh stepper": "stepper", "mesh trainer": "trainer",
               "layout/2": ("gloo", ["cuda:0", "cuda:0"])}


class FakeFederation:
    """17(b)'s processes as phase 15 starts them."""

    def __init__(self, archive, ini):
        self.paths, self.started = (archive, ini), False

    def start(self):
        self.started = True
        return self

    def stop(self):
        self.started = False


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
    monkeypatch.setattr(smoke, "build_report", lambda lib, log: (["ptxas fake"], {}))
    monkeypatch.setattr(smoke, "card_line", lambda: "FAKE H100, 700.00 W")
    monkeypatch.setattr(smoke, "cli_archive", lambda: ("archive", "ini"))
    calls = []

    class FakeBeside:
        """The process of phases 18, 20 and 21: started before phase 9,
        phase 18 joined in 17, phases 20 and 21 after it."""

        def __init__(self, card):
            calls.append(("experiments_process", (card,)))

        def finish(self, phase, notes):
            calls.append(({"18": "experiments_phase", "20": "examples_phase",
                           "21": "experiment_scripts_phase"}[phase], (notes,)))
            notes["stats"] += f"; phase {phase} (fake)"
            return 1.0

        def stop(self):
            pass

    monkeypatch.setattr(smoke, "BesideProcess", FakeBeside)

    class FakeFuture:
        def __init__(self, datasets):
            calls.append(("mesh_programs", (datasets,)))

        def result(self):
            return dict(MESH_GROUPS)

        def exception(self):
            return None

    monkeypatch.setattr(smoke, "start_mesh_programs", FakeFuture)
    row = {"name": "stats", "route": "cuda", "source": "s", "replaces": "r", "launches": 16,
           "max_abs_err": 0.0, "ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5,
           "bound_by": "bytes", "library_ms": None}
    results = {"kernel_phase": ({"stats": row}, {"stats": ""}),
               "main_path_phase": ("datasets", "result"),
               "sharded_fit_phase": ("X", "kw", dict(GROUPS)),
               "decodes_and_text_phase": "raw", "federation_phase": "phase9",
               "pacing_phase": "pacing"}
    for name in PHASES:
        def phase(*args, _name=name, meanwhile=None, start_mesh=False):
            calls.append((_name, args))
            if meanwhile is not None:
                meanwhile()
            if start_mesh:
                return FakeFederation("archive", "ini").start()
            return results.get(_name)
        monkeypatch.setattr(smoke, name, phase)
    return calls


def test_the_whole_script_serves_last_and_prints_its_total(smoke, faked, capsys):
    """Phase 14 runs on phase 7(b)'s corpora and phase 9's store, phase 15,
    the command line, on phase 3's fit (starting 17(b)'s processes), and
    phase 16, the scenario matrix, with the kernels' notes; then phase 17 on
    17(a)'s rank group, phase 3's fit and corpora and phase 15's processes,
    joining phase 18 of the process of phases 18, 20 and 21 (started before
    phase 9; the rank group before phase 13); then phases 20 and 21 joined;
    the notes of phases 18, 20 and 21 reach the kernels; phases 5 to 8 read phase 4's rank groups; the
    script's own seconds come before the ``kernels`` line, and the ``ok``
    line is the last."""
    import json

    assert smoke.main([]) == 0
    assert [name for name, _ in faked] == list(ORDER)
    calls = dict(faked)
    assert calls["serving_phase"][2:] == ("raw", "phase9")
    assert calls["cli_phase"][1:] == ("result",)  # and start_mesh=True
    # One dict, the notes of phases 18, 20 and 21 merged at the end.
    notes = {"stats": "; phase 18 (fake); phase 20 (fake); phase 21 (fake)"}
    assert calls["scenario_phase"] == ("FAKE H100, 700.00 W", notes)
    assert calls["persistence_phase"][-3:] == ("X", "kw", "validation")
    assert calls["mesh_programs"] == ("datasets",)
    assert calls["mesh_phase"][0:2] == ("FAKE H100, 700.00 W", notes)
    assert calls["mesh_phase"][2].result() == MESH_GROUPS
    assert calls["mesh_phase"][3:5] == ("result", "datasets")
    federation = calls["mesh_phase"][5]
    assert isinstance(federation, FakeFederation) and federation.started
    assert federation.paths == ("archive", "ini")
    assert calls["experiments_process"] == ("FAKE H100, 700.00 W",)
    assert calls["experiments_phase"] == calls["examples_phase"] == \
        calls["experiment_scripts_phase"] == (notes,)
    groups = GROUPS
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


@pytest.mark.parametrize("flag, phase", [("--mesh-only", "mesh_phase"),
                                         ("--experiments-only", "experiments_phase"),
                                         ("--examples-only", "examples_phase")])
def test_mesh_and_experiments_only_run_their_phase_alone(smoke, faked, capsys, flag, phase):
    """``--mesh-only`` runs phase 17 with nothing before it (it runs its own
    rank group and phase 3's fit, and nothing beside it),
    ``--experiments-only`` phase 18 and ``--examples-only`` phase 20 (each
    after phase 1's build); none prints result lines."""
    assert smoke.main([flag]) == 0
    assert [name for name, _ in faked] == [phase]
    card, notes = faked[0][1]
    assert card == "FAKE H100, 700.00 W" and set(notes) == {"stats", "loss", "grads"}
    out = capsys.readouterr().out
    assert '"ok"' not in out and "kernels" not in out


def test_experiment_scripts_only_runs_phase_21_alone(smoke, faked, capsys):
    """``--experiment-scripts-only`` runs phase 21 after phase 1's build,
    with the notes of K1-K3 and their bf16 instantiations; it prints no
    result lines."""
    assert smoke.main(["--experiment-scripts-only"]) == 0
    assert [name for name, _ in faked] == ["experiment_scripts_phase"]
    card, notes = faked[0][1]
    assert card == "FAKE H100, 700.00 W" and set(notes) == set(smoke.BESIDE_NOTES)
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


#: Phase 20's line per walkthrough.
EXAMPLE_LINE = (r"^examples (\w+), FAKE H100, 700\.00 W: (\d+\.\d\d) s on cuda:0; (\d+) training "
                r"steps, launches (\{.*\})$")


def test_phase_20_runs_every_walkthrough_and_its_lines_parse(smoke, monkeypatch, tmp_path,
                                                             capsys):
    """Phase 20 on the CPU, each walkthrough's ``run()`` at a tiny size
    standing in for the card's (its result named ``cuda:0``, no model to
    hold against the kernels, and K1-K3 counted once per training step as
    the card's wrappers count them): one line per walkthrough with its
    seconds, device, training steps and launches, then the JAX script's
    lines, and the phase's seconds; the notes name every walkthrough."""
    import ast
    import re
    import sysconfig

    import torch

    from gfedntm_tpu_torch.data.local_corpus import DEFAULT_CLIENT_GROUPS
    from gfedntm_tpu_torch.examples import NAMES, bow_dataset_example
    from gfedntm_tpu_torch.examples import centralized_training, federated_simulation
    from gfedntm_tpu_torch.examples import hierarchical_training, realtext_federation
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    rng = np.random.default_rng(0)
    for pkgs in DEFAULT_CLIENT_GROUPS.values():
        words = ["".join(rng.choice(list("bcdfghjklmnpqrstvwxz"), 7)) for _ in range(40)]
        (tmp_path / "site" / pkgs[0]).mkdir(parents=True)
        for i in range(20):
            (tmp_path / "site" / pkgs[0] / f"m{i}.py").write_text(
                f'"""{" ".join(rng.choice(words, 60))}"""\n')
    paths = sysconfig.get_paths
    monkeypatch.setattr(sysconfig, "get_paths",
                        lambda *a, **k: {**paths(*a, **k), "purelib": str(tmp_path / "site")})
    tiny = {bow_dataset_example: {},
            centralized_training: dict(n_docs=80, num_epochs=1),
            federated_simulation: dict(n_docs=30, num_epochs=1),
            hierarchical_training: dict(n_docs=100),
            realtext_federation: dict(scale=0.01, n_components=4)}
    for module, kw in tiny.items():
        def run(module=module, original=module.run, kw=kw, **given):
            out = original(**{**kw, **given}, device="cpu")
            steps = smoke.example_steps(module.__name__.rsplit(".", 1)[1], out)
            for name in ("stats", "loss", "grads"):
                monkeypatch.setitem(fd.LAUNCHES, name, fd.LAUNCHES[name] + steps)
            return {**out, "device": "cuda:0", "models": {}}
        monkeypatch.setattr(module, "run", run)
    # The phase resets every counter: each comes back to its value before
    # the test, so no later test in the process sees the fake launches.
    for counts in (fd.LAUNCHES, fd.EVAL_LAUNCHES, fd.ROWS_CALLS):
        for key in list(counts):
            monkeypatch.setitem(counts, key, counts[key])
    monkeypatch.setattr(smoke, "EXAMPLES_DIR", tmp_path / "examples")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    notes = {"stats": "", "loss": "", "grads": ""}
    smoke.examples_phase("FAKE H100, 700.00 W", notes)
    lines = capsys.readouterr().out.splitlines()
    heads = [m for m in map(re.compile(EXAMPLE_LINE).match, lines) if m]
    assert [m.group(1) for m in heads] == list(NAMES)
    for m in heads:
        steps, launches = int(m.group(3)), ast.literal_eval(m.group(4))
        assert launches == ({} if not steps else dict.fromkeys(("stats", "loss", "grads"),
                                                               steps))
        assert (m.group(1) == "bow_dataset_example") == (steps == 0)
        assert f"; phase 20 {m.group(1)}: {steps} launches" in notes["grads"]
    assert any(line.startswith("examples centralized_training: TSS: ") for line in lines)
    assert any(line.startswith("examples realtext_federation: clients: 5 vocab: ")
               for line in lines)
    assert re.match(r"^phase 20 took \d+\.\d s \(FAKE H100, 700\.00 W\)$", lines[-1])
    assert not (tmp_path / "examples").exists()


def test_beside_process_reports_each_phase_and_stops_at_a_failure(smoke, monkeypatch):
    """The process of phases 18 and 20 puts one result a phase, in order,
    and runs nothing after a failure; :meth:`BesideProcess.finish` merges a
    phase's notes and fails the run on its failure or one before it."""
    import queue

    def passes(card, notes):
        notes["stats"] += f"; {card}"

    def fails(card, notes):
        smoke.check(False, "it failed")

    results = queue.Queue()
    monkeypatch.setattr(smoke, "BESIDE_PHASES", {"18": passes, "20": passes})
    smoke._beside_child("card", ("18", "20"), results)
    got = [results.get_nowait() for _ in range(2)]
    assert [g[:2] for g in got] == [("18", "ok"), ("20", "ok")] and results.empty()
    monkeypatch.setattr(smoke, "BESIDE_PHASES", {"18": fails, "20": passes})
    smoke._beside_child("card", ("18", "20"), results)
    assert results.get_nowait() == ("18", "failed", "it failed") and results.empty()

    beside = smoke.BesideProcess.__new__(smoke.BesideProcess)
    beside.results, beside.got, beside.started = queue.Queue(), {}, 0.0
    beside.results.put(("18", "ok", {"stats": "; eighteen"}))
    beside.results.put(("20", "failed", "it failed"))
    notes = {"stats": ""}
    assert beside.finish("18", notes) > 0 and notes == {"stats": "; eighteen"}
    with pytest.raises(smoke.SmokeFailure, match="phase 20 .*it failed"):
        beside.finish("20", notes)


# ---------------------------------------------------------------------------
# bf16 K1 and K2 on 64-column tiles: their routes beside another build's,
# their outputs within tolerance of it, device times, the tile timeline
# ---------------------------------------------------------------------------
#: ``--against``'s route line of bf16 K1 and K2, with the wide tiles.
WIDE_ROUTES_LINE = re.compile(
    r"^kernels ok: bf16 (K1|K2) routes at (\d+) \(B, K\) beside the build of (\S+): none lost, "
    r"(\d+) onto 64-column tiles, (\d+) onto 32-column tiles, (\d+) onto 16-column tiles, "
    r"(\d+) newly taken; FP32 \1 routes unchanged$")


def _fwd_route(kind, b, k):
    """A parent's K1/K2 route by a rule: 32 columns to 256 rows and K 56,
    16 to 1,024 rows and K 40, else the CUDA cores (the bf16 bit ignored)."""
    return 32 if b <= 256 and k <= 56 else 16 if b <= 1024 and k <= 40 else 0


@pytest.mark.parametrize("kind,label", [("stats", "K1"), ("loss", "K2")])
def test_compare_routes_of_k1_and_k2_count_the_wide_tiles(smoke, monkeypatch, kind, label):
    """bf16 K1's and K2's routes beside the parent's: shapes moved onto
    64-column tiles (from 32, 16 or the CUDA cores) are counted apart;
    a 64-column shape the parent took on 32 and now on 16 fails."""
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    monkeypatch.setattr(smoke, "ROUTE_GRID", [(b, k) for b in (8, 256, 320, 1100)
                                              for k in (8, 50, 60, 72, 90)])
    parent = FakeRoutes(lambda kind_bits, b, k: _fwd_route(kind_bits, b, k))

    def change(kind_bits, b, k):
        if kind_bits & 4 and b <= 256 and k <= 72:
            return 64
        return _fwd_route(kind_bits, b, k)

    line = smoke.compare_routes(FakeRoutes(change), parent, Path("/p"), kind)
    found = WIDE_ROUTES_LINE.match(line)
    # b in (8, 256): k in (8, 50) from 32, k in (60, 72) from the CUDA cores.
    assert found and found.groups() == (label, "20", "/p", "8", "0", "0", "0")
    lost = FakeRoutes(lambda kind_bits, b, k: 16 if kind_bits & 4 and (b, k) == (8, 8)
                      else change(kind_bits, b, k))
    with pytest.raises(smoke.SmokeFailure, match=f"bf16 {label} takes B=8 K=8 on tensor cores, "
                       "16-column tiles, the build of /p on tensor cores, 32"):
        smoke.compare_routes(lost, parent, Path("/p"), kind)
    assert fd.ROUTE_NAMES[64] == "tensor cores, 64-column tiles"


AGAINST_ERRORS_LINE = re.compile(
    r"^kernels ok: bf16 K1 and K2 on another route than the build of (\S+), within tolerance of "
    r"it: K1 in (\d+) cases: mean (\S+) \(tol (\S+)\), var (\S+) \(tol (\S+)\), m (\S+) \(tol "
    r"(\S+)\), s (\S+) \(tol (\S+)\); K2 in (\d+) cases: loss (\S+) \(tol (\S+)\), rd (\S+) "
    r"\(tol (\S+)\)$")


def test_against_errors_hold_other_routes_to_the_tolerance(smoke):
    """Outputs of another route: within 1e-5 + 1e-4 max|other| they pass and
    their largest error per output is printed beside the tolerance; past it,
    or with a softmax-max sentinel moved, they fail."""
    import torch

    theirs = (torch.tensor([1.0, -2.0, 4.0]), torch.tensor([-1e30, 3.0]))
    near = (theirs[0] + torch.tensor([0.0, 2e-4, -1e-4]), theirs[1] + torch.tensor([0.0, 3e-4]))
    got = smoke.against_errors("bf16 B=8", "m,s", near, theirs)
    assert got["m"][0] == pytest.approx(2e-4, rel=1e-3)
    assert got["m"][1] == pytest.approx(1e-5 + 1e-4 * 4.0)
    assert got["s"][1] == pytest.approx(1e-5 + 1e-4 * 3.0)
    with pytest.raises(smoke.SmokeFailure, match="m max |this build - the other|"):
        smoke.against_errors("bf16 B=8", "m,s", (theirs[0] + 1e-3, theirs[1]), theirs)
    with pytest.raises(smoke.SmokeFailure, match="s sentinel rows differ"):
        smoke.against_errors("bf16 B=8", "m,s", (theirs[0], torch.tensor([0.0, 3.0])), theirs)
    errors = {"stats": [{"mean": (1e-7, 4e-5), "var": (2e-8, 1e-5), "m": (3e-6, 9e-4),
                         "s": (7e-3, 3.8)},
                        {"mean": (2e-7, 4e-5), "var": (1e-8, 1e-5), "m": (1e-6, 9e-4),
                         "s": (8e-3, 3.9)}],
              "loss": [{"loss": (0.25, 195.0), "rd": (0.03, 15.0)}]}
    line = smoke.against_errors_line(Path("/x/parent"), errors)
    found = AGAINST_ERRORS_LINE.match(line)
    assert found
    values = found.groups()
    assert values[:2] == ("/x/parent", "2") and values[10] == "1"
    assert [float(v) for v in values[2:10]] == [2e-7, 4e-5, 2e-8, 1e-5, 3e-6, 9e-4, 8e-3, 3.9]
    assert [float(v) for v in values[11:]] == [0.25, 195.0, 0.03, 15.0]


def test_resources_line_puts_the_wide_instantiation_first(smoke):
    got = {"stats_kernel<bf16, 64, 16B>": {"registers": 112, "hmma": 16},
           "stats_kernel<bf16, 32, 16B>": {"registers": 88, "hmma": 24},
           "stats_kernel<32, 16B>": {"registers": 89, "hmma": 12}}
    assert smoke.resources_line(got, "stats_kernel").startswith(
        "stats_kernel<bf16, 64, 16B> 112 registers, 16 HMMA; stats_kernel<bf16, 32, 16B> 88 "
        "registers, 24 HMMA (FP32 stats_kernel<32, 16B> 89 registers, 12 HMMA); ")


#: A K1 or K2 row's device-time note (``device_note``).
DEVICE_NOTE = re.compile(r"; device ms (\d+\.\d{4}|not measured \(no device time in the "
                         r"profiler\)) a launch \((\d+) kernels a call: (K1 and its merge|K2 and "
                         r"its fold)\), host (\d+\.\d) us a call")


def test_device_note_prints_the_profilers_time_beside_the_host(smoke):
    note = smoke.device_note((0.05126, 88.04, 2.0), smoke.FOLDS["stats"])
    found = DEVICE_NOTE.fullmatch(note)
    assert found and found.groups() == ("0.0513", "2", "K1 and its merge", "88.0")
    found = DEVICE_NOTE.fullmatch(smoke.device_note((None, 12.0, 0.0), smoke.FOLDS["loss"]))
    assert found and found.group(1).startswith("not measured") and found.group(3) == (
        "K2 and its fold")


@pytest.mark.parametrize("argv", [["--timeline"], ["--timeline", "--against", "."],
                                  ["--serving-only", "--timeline"],
                                  ["--data-parallel-only", "--timeline"]])
def test_timeline_without_kernels_only_exits_2(smoke, argv, capsys):
    assert smoke.main(argv) == 2
    assert "usage" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--kernels-only", "--timeline"],
                                  ["--kernels-only", "--timeline", "--against", "."]])
def test_timeline_without_a_card_exits_2_and_prints_no_result(smoke, argv, capsys):
    assert smoke.main(argv) == 2
    assert capsys.readouterr().out == ""


def test_timeline_runs_after_phase_2_only_when_asked(smoke, faked, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(smoke, "timeline_phase", lambda card: calls.append(card))
    assert smoke.main(["--kernels-only"]) == 0
    assert calls == [] and [name for name, _ in faked] == ["kernel_phase"]
    assert smoke.main(["--kernels-only", "--timeline"]) == 0
    assert calls == ["FAKE H100, 700.00 W"]
    assert [name for name, _ in faked] == ["kernel_phase", "kernel_phase"]
    out = capsys.readouterr().out
    assert re.search(r"^phase 2 \(timeline\) took \d+\.\d s \(FAKE H100, 700\.00 W\)$", out, re.M)


TIMELINE_LAUNCH_LINE = re.compile(
    r"^timeline (.+): the timeline build's launch (\d+\.\d{4}) ms; its blocks' median (\d+) "
    r"cycles over it: (\d+\.\d{3}) GHz \((.+)\)$")


def test_timeline_phase_prints_lines_that_parse(smoke, monkeypatch, capsys):
    """``--timeline``'s lines, with the card's parts faked on the CPU: per
    run a report line that ``timeline.parse_report_line`` reads and the
    timeline build's own launch beside its blocks' cycles."""
    import torch

    from gfedntm_tpu_torch.ops import fused_decoder as fd
    from gfedntm_tpu_torch.ops import timeline as tl

    b, k, v = 16, 4, 40
    stamps = np.zeros((2, 3, 16, 8), dtype=np.int64)
    stamps[:, :2, :, :7] = 1_000 + np.cumsum([0, 50, 400, 100, 100, 300, 10])
    stamps[:, 2, :, :4] = [10, 100, 2_000, 2_050]
    launched = []

    def fake_inputs(*args, **kwargs):
        gen = torch.Generator().manual_seed(0)
        return dict(theta=torch.softmax(torch.randn(b, k, generator=gen), 1),
                    beta=torch.randn(k, v, generator=gen),
                    x=torch.randint(0, 4, (b, v), generator=gen).float(),
                    run_mean=torch.zeros(v), run_var=torch.ones(v), mask=torch.ones(b))

    monkeypatch.setattr(tl, "load", lambda: "timeline lib")
    monkeypatch.setattr(tl, "record", lambda lib, launch: (launch(), stamps)[1])
    monkeypatch.setattr(fd, "_launch_stats", lambda lib, *a: launched.append(("stats", lib)))
    monkeypatch.setattr(fd, "_launch_loss", lambda lib, *a: launched.append(("loss", lib)))
    monkeypatch.setattr(smoke, "make_inputs", fake_inputs)
    monkeypatch.setattr(smoke, "main_path_batch", lambda n: (torch.zeros(b, v), 0.0019))
    monkeypatch.setattr(smoke, "time_ms", lambda fn: 0.05)
    monkeypatch.setattr(smoke, "device_and_host",
                        lambda fns: {label: (None, 10.0, 0.0) for label in fns})
    smoke.timeline_phase("FAKE H100, 700.00 W")
    lines = capsys.readouterr().out.splitlines()
    reports = [tl.parse_report_line(line) for line in lines if tl.parse_report_line(line)]
    assert [(r["label"], r["kernel"]) for r in reports] == [
        ("stats_bf16 B=256 K=50 V=100000 train", "stats"),
        ("loss_bf16 B=256 K=50 V=100000 train", "loss"),
        ("loss_bf16 B=256 K=50 V=100000 train main-path x 0.0019 nonzero", "loss")]
    assert reports[0]["median_cycles"] == 960 and reports[1]["median_cycles"] == 650
    launches = [TIMELINE_LAUNCH_LINE.match(line) for line in lines]
    launches = [m.groups() for m in launches if m]
    assert [g[0] for g in launches] == [r["label"] for r in reports]
    assert all(g[1:] == ("0.0500", "2040", "0.041", "FAKE H100, 700.00 W") for g in launches)
    assert {lib for _, lib in launched} == {"timeline lib"}


AGAINST_TIMES_LINE = re.compile(
    r"^kernels: bf16 device ms a launch, the build of (\S+) / this build in turns \(other, "
    r"this, this, other\): (.+)$")
_TIMES = re.compile(r"(K1|K2|K2 on the main path's batch) ((?:\d+\.\d{4}|not measured)"
                    r"(?:/(?:\d+\.\d{4}|not measured)){3})")


def test_against_times_line_reads_back(smoke):
    times = {"K1": [0.11512, 0.07171, 0.07149, 0.1149],
             "K2": [0.1176, 0.0947, None, 0.11755],
             "K2 on the main path's batch": [0.1181, 0.0851, 0.08498, 0.118]}
    line = smoke.against_times_line(Path("/x/parent"), times)
    found = AGAINST_TIMES_LINE.match(line)
    assert found and found.group(1) == "/x/parent"
    got = {label: four.split("/") for label, four in _TIMES.findall(found.group(2))}
    assert got == {"K1": ["0.1151", "0.0717", "0.0715", "0.1149"],
                   "K2": ["0.1176", "0.0947", "not measured", "0.1176"],
                   "K2 on the main path's batch": ["0.1181", "0.0851", "0.0850", "0.1180"]}


#: Phase 21's line per time-to-quality arm and per run_full_v100k case.
TTQ_ARM_LINE = (r"^experiment scripts time_to_quality, FAKE H100, 700\.00 W: (\w+): "
                r"(\d+\.\d{4}) ms a global step, (\d+) steps, final TSS (\d+\.\d{4}), "
                r"NPMI (-?\d+\.\d{4}), diversity (\d+\.\d{4}), launches (\{.*\})$")
V100K_LINE = (r"^experiment scripts run_full_v100k V(\d+)_(float32|bfloat16), FAKE H100, "
              r"700\.00 W: (\d+\.\d{3}) ms a global step, (\d+\.\d) docs/s, HBM (\S+) of "
              r"3\.35 TB/s \(analytic\), TSS (\S+) \(random (\S+)\), (\d+) steps after a warm "
              r"fit of (\S+) s, route (\{.*\}), launches (\{.*\})$")


def test_phase_21_runs_both_scripts_and_its_lines_parse(smoke, monkeypatch, tmp_path, capsys):
    """Phase 21 on the CPU, each script at a tiny size standing in for the
    card's (its result named ``cuda``, K1-K3 counted once per client step
    of the port arms' fits as the card's wrappers count them, the kernels'
    comparison recorded): one line per time-to-quality arm and per
    V=100,000 case, the ladder and headline lines, the phase's seconds, and
    notes for every counter the phase launched."""
    import ast

    import torch

    from gfedntm_tpu_torch.experiments_scripts import run_full_v100k, time_to_quality
    from gfedntm_tpu_torch.models import avitm
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    tiny = dict(vocab=300, k=5, docs_per_node=100, n_nodes=2, frozen=2)
    kernels = ("stats", "loss", "grads")

    def count(counters, n):
        for name in counters:
            monkeypatch.setitem(fd.LAUNCHES, name, fd.LAUNCHES[name] + n)

    def ttq_run(original=time_to_quality.run, **kw):
        out = original(**{**kw, **tiny, "device": "cpu", "coldproc": False})
        for arm, warm in out["warm_fit"].items():
            steps = out["client_steps"][arm]
            out["k1_k3_launches"][arm].update(dict.fromkeys(kernels, steps))
            warm["launches"].update(dict.fromkeys(kernels, warm["client_steps"]))
            count(kernels, steps + warm["client_steps"])
        out["cold_start"]["cold_process_warm_cache"] = {"backend": "cuda"}
        return {**out, "backend": "cuda"}

    def run_case(V, docs, dtype, original=run_full_v100k.run_case, **kw):
        case = original(V, docs, dtype, **{**kw, "device": "cpu"})
        counters = run_full_v100k.storage_kernels(dtype)
        case["launches"] = case["warm_launches"] = dict.fromkeys(counters, case["client_steps"])
        count(counters, 2 * case["client_steps"])
        return case

    corpus = time_to_quality.make_corpus
    monkeypatch.setattr(time_to_quality, "run", ttq_run)
    monkeypatch.setattr(time_to_quality, "make_corpus",
                        lambda *a: corpus(*a) if a else corpus(**tiny))
    monkeypatch.setattr(run_full_v100k, "run_case", run_case)
    monkeypatch.setattr(run_full_v100k, "CASES", ((300, 64),))
    monkeypatch.setattr(avitm, "resolve_device", lambda device=None: torch.device("cpu"))
    compared = []
    monkeypatch.setattr(smoke, "kernels_against_plain",
                        lambda case, label, net, x, mask, storage_dtype="float32":
                        compared.append((case, net, x.shape, storage_dtype)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for counts in (fd.LAUNCHES, fd.EVAL_LAUNCHES, fd.ROWS_CALLS):
        for key in list(counts):
            monkeypatch.setitem(counts, key, counts[key])
    monkeypatch.setattr(smoke, "SCRIPTS_DIR", tmp_path / "scripts")
    notes = dict.fromkeys(smoke.BESIDE_NOTES, "")
    smoke.experiment_scripts_phase("FAKE H100, 700.00 W", notes)
    lines = capsys.readouterr().out.splitlines()
    arms = [m for m in map(re.compile(TTQ_ARM_LINE).match, lines) if m]
    assert [m.group(1) for m in arms] == ["torch_centralized", "torch_federated",
                                          "gfedntm_tpu_federated",
                                          "gfedntm_tpu_local_steps_E_1epoch",
                                          "gfedntm_tpu_local_steps_E_5epoch"]
    for m in arms:
        launches = ast.literal_eval(m.group(7))
        assert (launches == {}) == m.group(1).startswith("torch_")
    assert sum(line.startswith("experiment scripts time_to_quality: ladder ") for line in lines) == 4
    assert any(line.startswith("experiment scripts time_to_quality: headline at 95% ")
               for line in lines)
    cases = [m for m in map(re.compile(V100K_LINE).match, lines) if m]
    assert [(m.group(1), m.group(2)) for m in cases] == [("300", "float32"), ("300", "bfloat16")]
    assert ast.literal_eval(cases[1].group(11)) == dict.fromkeys(
        ("stats_bf16", "loss_bf16", "grads_bf16"), 2 * 5 * int(cases[1].group(8)))
    assert [(c[0], c[3]) for c in compared] == [
        ("time_to_quality's first batch", "float32"),
        ("run_full_v100k's first batch", "float32"),
        ("run_full_v100k's first batch", "bfloat16")]
    assert [c[2] for c in compared] == [(64, 300)] * 3
    assert compared[1][1].input_size == 300 and compared[0][1].n_components == 50
    for name in smoke.BESIDE_NOTES:
        assert "; phase 21 " in notes[name], name
    assert re.match(r"^phase 21 took \d+\.\d s \(FAKE H100, 700\.00 W\)$", lines[-1])
    assert not (tmp_path / "scripts").exists()


@pytest.mark.parametrize("storage_dtype", ["float32", "bfloat16"])
def test_kernels_against_plain_takes_the_storage(smoke, monkeypatch, capsys, storage_dtype):
    """K1-K3 against their plain versions on one batch of a net (on the CPU
    the wrappers take their plain versions, so both sides agree exactly):
    the wrappers get beta and x as the storage keeps them, each kernel's
    route is asked for that storage, and the line names the case, its
    storage, the routes and three errors."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch.models.avitm import AVITM
    from gfedntm_tpu_torch.ops import _build
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    asked, given = [], []

    def route(lib, kind, b, k, storage="float32"):
        asked.append((kind, b, k, storage))
        return 64 if storage == "bfloat16" and kind != "grads" else 32

    def spy(name):
        wrapper = getattr(fd, name)

        def call(theta, beta, *rest, **kw):
            given.append((beta.dtype, None if name == "stats" else rest[0].dtype,
                          kw["storage_dtype"]))
            return wrapper(theta, beta, *rest, **kw)
        return call

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(_build, "load", lambda: "lib")
    monkeypatch.setattr(fd, "_route", route)
    for name in ("stats", "loss", "grads"):
        monkeypatch.setattr(fd, name, spy(name))
    net = AVITM(input_size=40, n_components=5, hidden_sizes=(8, 8), batch_size=8,
                device="cpu")
    x = np.random.default_rng(0).poisson(1.0, (8, 40)).astype(np.float32)
    smoke.kernels_against_plain("a batch", "test", net, x, np.ones(8, np.float32),
                                storage_dtype)
    line = capsys.readouterr().out.strip()
    bf16 = storage_dtype == "bfloat16"
    want = torch.bfloat16 if bf16 else torch.float32
    assert given == [(want, None, storage_dtype), (want, want, storage_dtype),
                     (want, want, storage_dtype)]
    assert sorted(asked) == [(k, 8, 5, storage_dtype) for k in ("grads", "loss", "stats")]
    routes = ("tensor cores, 32-column tiles; tensor cores, 64-column tiles" if bf16
              else "tensor cores, 32-column tiles")
    assert line == (f"test: K1, K2, K3 on a batch, B=8 K=5 V=40{' bf16' if bf16 else ''} "
                    f"({routes}) within 0.000e+00, 0.000e+00, 0.000e+00 of their plain "
                    "versions")
