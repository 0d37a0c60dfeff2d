"""Build and load the fused decoder's CUDA library.

``csrc/fused_decoder.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
plain-C shared library under ``build/gfedntm_tpu_torch/`` at the repository
root (listed in ``.gitignore``), and loaded with ``ctypes``. The build runs at
first use, and again whenever the library is missing or older than the
source; nothing is built when the package is imported. A failed build raises
with nvcc's output.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_decoder.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gfedntm_tpu_torch"
LIBRARY = BUILD_DIR / "libfused_decoder.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: nvcc's output of the last build in this process (ptxas register and
#: shared-memory report), or "" when the library was up to date.
build_log = ""


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin: "
        "the fused decoder's CUDA kernels cannot be built"
    )


def build(source: Path | None = None, library: Path | None = None,
          defines: tuple[str, ...] = ()) -> Path:
    """Compile ``source`` (default :data:`SOURCE`) into ``library`` (default
    :data:`LIBRARY`) if that is missing or older than the source. Another
    checkout's source, to compare two builds on one card, goes to a library
    of its own, and so does a build with extra preprocessor ``defines``
    (``-D`` each; the tile timeline's ``FD_TIMELINE``)."""
    global build_log
    source, library = source or SOURCE, library or LIBRARY
    if library.exists() and library.stat().st_mtime >= source.stat().st_mtime:
        return library
    library.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=library.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", tmp, str(source)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}) building {source}:\n"
                f"{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp, library)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_log = proc.stderr + proc.stdout
    return library


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every entry point's C signature on a loaded library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fd_plan.argtypes = [
        i, i, i, i, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.fd_stats.argtypes = [p] * 11 + [i, i, i, i, f, i, p]
    lib.fd_loss.argtypes = [p] * 11 + [i, i, i, f, f, i, p]
    lib.fd_grads.argtypes = [p] * 13 + [i, i, i, i, f, f, i, p]
    entries = [lib.fd_plan, lib.fd_stats, lib.fd_loss, lib.fd_grads]
    if hasattr(lib, "fd_route"):  # not in builds that had one route per kernel
        lib.fd_route.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
        entries.append(lib.fd_route)
    if hasattr(lib, "fd_stats_bf16"):  # not in builds before bf16 storage
        lib.fd_stats_bf16.argtypes = [p] * 11 + [i, i, i, i, i, f, i, p]
        lib.fd_loss_bf16.argtypes = [p] * 11 + [i, i, i, i, f, f, i, p]
        lib.fd_grads_bf16.argtypes = [p] * 13 + [i, i, i, i, i, f, f, i, p]
        entries += [lib.fd_stats_bf16, lib.fd_loss_bf16, lib.fd_grads_bf16]
    for fn in entries:
        fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The loaded library with every entry point's C signature declared."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = declare(ctypes.CDLL(str(build())))
        return _lib
