"""The tile timeline of the fused decoder's K1 and K2.

A build of ``csrc/fused_decoder.cu`` with ``-DFD_TIMELINE`` (a library of its
own, :data:`LIBRARY`; the production library never carries it) stamps
``clock64()`` at each phase boundary of ``stats_kernel`` and ``loss_kernel``,
per block, tile and warp, into a device buffer of shape
``[blocks, tiles + 1, warps, stamps]``. Row ``tiles`` of a block holds its
prologue and end: stamp 0 at entry, 1 before its first tile, 2 after its
last, 3 at exit. Row ``t < tiles`` holds tile ``t`` of the block, one stamp
per boundary of :data:`PHASES` (the first as the tile starts), so phase ``i``
of a tile takes ``stamp[i + 1] - stamp[i]`` cycles of the SM's clock.

:func:`load` builds and loads that library, :func:`record` reads the stamps
of one launch, and :func:`tile_report` reduces them to the median cycles a
tile and each phase's share of all tiles' cycles; :func:`report_line` prints
that and :func:`parse_report_line` reads it back. ``chip_smoke.py
--kernels-only --timeline`` runs it on the card; the reduction runs
anywhere.
"""

from __future__ import annotations

import ctypes
import re

import numpy as np

from gfedntm_tpu_torch.ops import _build

#: Each kernel's phases in the order of its stamps within a tile.
PHASES = {
    "stats": ("waiting", "product", "stats pass 0", "stats pass 1", "softmax", "barrier"),
    "loss": ("waiting", "product", "epilogue", "barrier"),
}
DEFINE = "FD_TIMELINE"
LIBRARY = _build.BUILD_DIR / "timeline" / "libfused_decoder.so"


def load(source=None) -> ctypes.CDLL:
    """The timeline build of ``source`` (default: this checkout's), with
    every entry point of the production library and the three of the
    stamp buffer declared."""
    lib = _build.declare(ctypes.CDLL(str(_build.build(source, LIBRARY, (DEFINE,)))))
    lib.fd_timeline_shape.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.fd_timeline_clear.argtypes = [ctypes.c_void_p]
    lib.fd_timeline_read.argtypes = [ctypes.c_void_p]
    for fn in (lib.fd_timeline_shape, lib.fd_timeline_clear, lib.fd_timeline_read):
        fn.restype = ctypes.c_int
    return lib


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"tile timeline {what}: CUDA error {code}")


def record(lib, launch) -> np.ndarray:
    """The stamps of one ``launch()`` of K1 or K2 through ``lib`` (from
    :func:`load`): int64 ``[blocks, tiles + 1, warps, stamps]``, 0 where
    nothing was stamped."""
    import torch

    shape = (ctypes.c_int * 4)()
    _raise_on(lib.fd_timeline_shape(shape), "shape")
    stamps = np.zeros(tuple(shape), dtype=np.int64)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    _raise_on(lib.fd_timeline_clear(stream), "clear")
    launch()
    torch.cuda.synchronize()
    _raise_on(lib.fd_timeline_read(ctypes.c_void_p(stamps.ctypes.data)), "read")
    return stamps


def tile_report(stamps: np.ndarray, kernel: str) -> dict:
    """Medians and shares of one launch's stamps (``kernel`` "stats" or
    "loss"): ``tiles`` (block tiles stamped), ``records`` (warp tiles),
    ``median_cycles`` (a warp's cycles from a tile's first stamp to its
    last), ``shares`` (each phase's cycles over all warp tiles' cycles) and
    ``phase_median`` (each phase's median), and the blocks' median cycles
    from entry to exit (``block_median``), of the prologue before the first
    tile and of the end after the last."""
    names = PHASES[kernel]
    n = len(names)
    tiles = stamps[:, :-1, :, : n + 1]
    done = (tiles != 0).all(axis=-1)
    rec = tiles[done]
    if not len(rec):
        raise ValueError(f"tile timeline: no {kernel} tile was stamped")
    phases = np.diff(rec, axis=1)
    total = rec[:, n] - rec[:, 0]
    ends = stamps[:, -1, :, :4]
    ends = ends[(ends != 0).all(axis=-1)]
    return {
        "kernel": kernel,
        "tiles": int(done.any(axis=-1).sum()),
        "records": int(len(rec)),
        "median_cycles": float(np.median(total)),
        "shares": {name: float(phases[:, i].sum() / total.sum()) for i, name in enumerate(names)},
        "phase_median": {name: float(np.median(phases[:, i])) for i, name in enumerate(names)},
        "block_median": float(np.median(ends[:, 3] - ends[:, 0])),
        "prologue_median": float(np.median(ends[:, 1] - ends[:, 0])),
        "end_median": float(np.median(ends[:, 3] - ends[:, 2])),
    }


def report_line(label: str, rep: dict) -> str:
    """One line of :func:`tile_report`'s numbers under ``label``."""
    phases = ", ".join(f"{name} {rep['shares'][name]:.3f} ({rep['phase_median'][name]:.0f})"
                       for name in PHASES[rep["kernel"]])
    return (f"timeline {label}: {rep['kernel']} {rep['tiles']} tiles, {rep['records']} warp "
            f"tiles, median {rep['median_cycles']:.0f} cycles a tile; share (median cycles): "
            f"{phases}; block median {rep['block_median']:.0f} cycles, prologue "
            f"{rep['prologue_median']:.0f}, end {rep['end_median']:.0f}")


REPORT_LINE = re.compile(
    r"^timeline (?P<label>.+?): (?P<kernel>stats|loss) (?P<tiles>\d+) tiles, (?P<records>\d+) "
    r"warp tiles, median (?P<median>\d+) cycles a tile; share \(median cycles\): "
    r"(?P<phases>[a-z0-9 ]+ \d\.\d{3} \(-?\d+\)(?:, [a-z0-9 ]+ \d\.\d{3} \(-?\d+\))*); "
    r"block median (?P<block>\d+) cycles, prologue (?P<prologue>\d+), end (?P<end>\d+)$")
_PHASE = re.compile(r"([a-z0-9 ]+) (\d\.\d{3}) \((-?\d+)\)")


def parse_report_line(line: str) -> dict | None:
    """:func:`report_line`'s numbers back (rounded as printed), or None for
    any other line."""
    found = REPORT_LINE.match(line)
    if not found:
        return None
    phases = [(name.strip(), float(share), float(med))
              for name, share, med in _PHASE.findall(found["phases"])]
    if tuple(name for name, _, _ in phases) != PHASES[found["kernel"]]:
        return None
    return {
        "label": found["label"], "kernel": found["kernel"], "tiles": int(found["tiles"]),
        "records": int(found["records"]), "median_cycles": float(found["median"]),
        "shares": {name: share for name, share, _ in phases},
        "phase_median": {name: med for name, _, med in phases},
        "block_median": float(found["block"]), "prologue_median": float(found["prologue"]),
        "end_median": float(found["end"]),
    }
