"""The tile timeline's reduction (``gfedntm_tpu_torch.ops.timeline``) on canned
stamp buffers, on the CPU: the shape the ``FD_TIMELINE`` build writes
([blocks, tiles + 1, warps, stamps], row ``tiles`` the blocks' prologue and
end), each phase's share and median, unstamped tiles and warps left out, and
the printed line read back."""

import numpy as np
import pytest

from gfedntm_tpu_torch.ops import timeline as tl

BLOCKS, TILES, WARPS, STAMPS = 3, 6, 16, 8


def canned(kernel, phase_cycles, tiles_used=4, start=1_000, prologue=700, end=90):
    """A buffer in which every block stamps ``tiles_used`` tiles, each warp's
    phases taking ``phase_cycles`` (one per phase of ``kernel``) plus its
    warp index on the first phase, and the block row a prologue and end."""
    stamps = np.zeros((BLOCKS, TILES + 1, WARPS, STAMPS), dtype=np.int64)
    n = len(tl.PHASES[kernel])
    assert len(phase_cycles) == n
    for b in range(BLOCKS):
        t0 = start + 100_000 * b
        clock = t0 + prologue
        for t in range(tiles_used):
            for w in range(WARPS):
                steps = [0, phase_cycles[0] + w, *phase_cycles[1:]]
                stamps[b, t, w, : n + 1] = clock + np.cumsum(steps)
            clock += sum(phase_cycles) + WARPS
        stamps[b, TILES, :, :4] = [t0, t0 + prologue, clock, clock + end]
    return stamps


@pytest.mark.parametrize("kernel,phases", [
    ("stats", (250, 2_900, 1_100, 1_050, 2_400, 20)),
    ("loss", (790, 3_600, 3_200, 20)),
])
def test_tile_report_medians_and_shares(kernel, phases):
    rep = tl.tile_report(canned(kernel, phases), kernel)
    names = tl.PHASES[kernel]
    assert rep["kernel"] == kernel
    assert rep["tiles"] == BLOCKS * 4 and rep["records"] == BLOCKS * 4 * WARPS
    # Each warp's first phase is its index longer: the medians sit between.
    assert rep["median_cycles"] == sum(phases) + (WARPS - 1) / 2
    assert rep["phase_median"] == {name: float(c) for name, c in zip(names, phases)} | {
        names[0]: phases[0] + (WARPS - 1) / 2}
    assert sum(rep["shares"].values()) == pytest.approx(1.0)
    total = sum(phases) + (WARPS - 1) / 2
    for name, c in zip(names[1:], phases[1:]):
        assert rep["shares"][name] == pytest.approx(c / total)
    assert rep["prologue_median"] == 700 and rep["end_median"] == 90
    assert rep["block_median"] == 700 + 4 * (sum(phases) + WARPS) + 90


def test_unstamped_warps_tiles_and_blocks_are_left_out():
    """A warp tile missing any stamp (a warp that skipped a phase, a tile
    past the buffer's rows) and blocks that never ran do not count."""
    stamps = canned("loss", (800, 3_600, 3_200, 20))
    stamps[0, 1, 5, 2] = 0  # one warp's product stamp missing
    stamps[2] = 0  # a block that never ran
    rep = tl.tile_report(stamps, "loss")
    assert rep["records"] == 2 * 4 * WARPS - 1
    assert rep["tiles"] == 2 * 4
    assert rep["prologue_median"] == 700


def test_a_buffer_without_tiles_raises():
    with pytest.raises(ValueError, match="no stats tile was stamped"):
        tl.tile_report(np.zeros((BLOCKS, TILES + 1, WARPS, STAMPS), np.int64), "stats")


@pytest.mark.parametrize("kernel", ["stats", "loss"])
def test_report_line_reads_back(kernel):
    phases = (250, 2_900, 1_100, 1_050, 2_400, 20) if kernel == "stats" else (
        790, 3_600, 3_200, 20)
    rep = tl.tile_report(canned(kernel, phases), kernel)
    label = f"{kernel}_bf16 B=256 K=50 V=100000 train main-path x 0.0019 nonzero"
    line = tl.report_line(label, rep)
    got = tl.parse_report_line(line)
    assert got["label"] == label and got["kernel"] == kernel
    assert got["tiles"] == rep["tiles"] and got["records"] == rep["records"]
    assert got["median_cycles"] == round(rep["median_cycles"])
    assert list(got["shares"]) == list(tl.PHASES[kernel])
    for name in tl.PHASES[kernel]:
        assert got["shares"][name] == pytest.approx(rep["shares"][name], abs=5e-4)
        assert got["phase_median"][name] == round(rep["phase_median"][name])
    for key in ("block_median", "prologue_median", "end_median"):
        assert got[key] == round(rep[key])


def test_other_lines_do_not_parse():
    rep = tl.tile_report(canned("stats", (250, 2_900, 1_100, 1_050, 2_400, 20)), "stats")
    line = tl.report_line("stats_bf16 B=256", rep)
    for mangled in (line.replace("stats 12 tiles", "grads 12 tiles"),
                    line.replace("softmax", "soft max"),
                    line.replace(", barrier", ", wait"),
                    line + " extra",
                    line.replace("share (median cycles)", "share")):
        assert tl.parse_report_line(mangled) is None
    # The loss kernel's phases under the stats kernel's name do not parse.
    loss = tl.report_line("x", tl.tile_report(canned("loss", (1, 2, 3, 4)), "loss"))
    assert tl.parse_report_line(loss.replace(": loss ", ": stats ")) is None
